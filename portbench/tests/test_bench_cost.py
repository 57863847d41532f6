"""The frozen cost functions against hand counts."""

import pytest

from portbench.harness import peaks
from portbench.harness.cost import Costs, Proj, capacity


def test_joint_launch_hand_count():
    # mixtral's expert up projection: K 4096 (32 tiles, keep 13), N 14336
    p = Proj.of(4096, 14336, 0.6)
    assert p.k_stored == 13 * 128 and p.n_pad == 14336
    nbytes, ops = p.launch(rows=64, valid=16)
    pack = 112 * 13 * 128 * 128 + 112 * 13 * 4 + 14336 * 4
    assert nbytes == pack + 64 * 4096 * 2 + 64 * 14336 * 2
    assert ops == 2 * 16 * 13 * 128 * 14336


def test_joint_call_dense_and_moe():
    dense = {"n_layers": 2, "d_model": 256, "n_heads": 4, "n_kv_heads": 4,
             "d_ff": 512, "vocab_size": 1000,
             "dbpim_value_sparsity": 0.5}
    c = Costs(dense, slots=4)
    t = 0.0
    for K, N in ((256, 256),) * 4 + ((256, 512), (256, 512), (512, 256)):
        p = Proj.of(K, N, 0.5)
        t += max((p.pack_bytes + 4 * (K + N) * 2) / peaks.HBM_BYTES_PER_S,
                 2 * 3 * p.k_stored * p.n_pad / peaks.BF16_FLOPS)
    assert c.joint_call(4, 3) == pytest.approx(2 * t)
    moe = dict(dense, n_experts=4, top_k=2, capacity_factor=2.0)
    assert capacity(moe, 4) == 8
    c = Costs(moe, slots=4)
    t = 0.0
    for K, N in ((256, 256),) * 4:
        p = Proj.of(K, N, 0.5)
        t += max((p.pack_bytes + 4 * (K + N) * 2) / peaks.HBM_BYTES_PER_S,
                 2 * 3 * p.k_stored * p.n_pad / peaks.BF16_FLOPS)
    for K, N in ((256, 512), (256, 512), (512, 256)):
        # four experts, 8 rows each, 3 tokens x 2 choices spread over them
        p = Proj.of(K, N, 0.5)
        t += 4 * max((p.pack_bytes + 8 * (K + N) * 2)
                     / peaks.HBM_BYTES_PER_S,
                     2 * 1.5 * p.k_stored * p.n_pad / peaks.BF16_FLOPS)
    assert c.joint_call(4, 3) == pytest.approx(2 * t)


def test_attention_hand_count():
    spec = {"n_layers": 3, "d_model": 2048, "n_heads": 32,
            "n_kv_heads": 32, "d_ff": 5632, "vocab_size": 100352,
            "dbpim_value_sparsity": 0.6}
    c = Costs(spec, slots=2)
    # one slot decoding at position 99 (100 keys), one chunk of 4
    # queries at positions 10..13 (14 keys read, 11 + 12 + 13 + 14 live)
    nbytes = (100 * 32 * 64 * 4 + 32 * 64 * 4) + \
        (14 * 32 * 64 * 4 + 4 * 32 * 64 * 4)
    ops = 4.0 * 64 * 32 * (100 + 11 + 12 + 13 + 14)
    want = 3 * max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.BF16_FLOPS)
    assert c.attention_call([(99, 1), (10, 4)]) == pytest.approx(want)
    windowed = dict(spec, window=8)
    cw = Costs(windowed, slots=2)
    assert cw._key_sum(10, 4) == 4 * 8


def test_model_ops_per_token():
    spec = {"n_layers": 1, "d_model": 128, "n_heads": 2, "n_kv_heads": 2,
            "d_ff": 256, "vocab_size": 10, "dbpim_value_sparsity": 0.0}
    c = Costs(spec, slots=1)
    proj = 2 * (4 * 128 * 128 + 2 * 128 * 256 + 256 * 128)
    assert c.span_ops(4, 1) == proj + 4 * 5 * 64 * 2
    assert c.unembed_ops() == 2 * 128 * 10
