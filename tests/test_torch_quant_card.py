"""The port's INT8 quantization on a CUDA card against the same code on the
host: ``quantize_params_for_serving`` (one scale per filter) and
``_compress_2d`` (one scale per matrix, block pruning, FTA) give the same
bytes on both devices. No JAX import, so it runs on a card where JAX is
not installed; it skips without a card.

    PYTHONPATH=src python -m pytest -q -m port tests/test_torch_quant_card.py
"""

import pytest
import torch

from repro_torch.sparsity import quantize_params_for_serving

pytestmark = pytest.mark.port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantization_on_the_card_is_the_hosts(dtype):
    """The serving INT8 format and ``_compress_2d`` computed on the card
    are byte for byte the host's on the same matrices: q as int8, the
    scales through their 32-bit view. (A scale divided by a Python number
    on the card is a reciprocal product, an ulp off the host's quotient
    for some filters.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the card with the host")
    from repro_torch.sparsity.sparse_linear import _compress_2d
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((3, 512, 768), generator=gen).to(getattr(torch, dtype))
    host = quantize_params_for_serving({"blocks": {"mlp": {"w_up": w}}})
    card = quantize_params_for_serving(
        {"blocks": {"mlp": {"w_up": w.cuda()}}})
    h, c = host["blocks"]["mlp"]["w_up"], card["blocks"]["mlp"]["w_up"]
    assert torch.equal(c["q"].cpu(), h["q"])
    assert torch.equal(c["scale"].cpu().view(torch.int32),
                       h["scale"].view(torch.int32))
    for l in range(w.shape[0]):
        hq, hs, hm, hp, _ = _compress_2d(w[l].float(), 0.6, 8)
        cq, cs, cm, cp, _ = _compress_2d(w[l].float().cuda(), 0.6, 8)
        assert torch.equal(cq.cpu(), hq) and torch.equal(cm.cpu(), hm)
        assert torch.equal(cp.cpu(), hp) and cs == hs, l
