"""The port's row-stable attention and norm kernels: their plain versions
against the JAX package's attention and norms on the same numpy inputs,
and, on a CUDA card, each hand-written kernel against its plain version,
with a query's (a row's) output bitwise the same however many queries
(rows) share the call.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_row_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import row_attention as rak
from repro_torch.kernels import row_norm as rnk

pytestmark = pytest.mark.port

#: fp32 on both sides, sums in another order: relative to the peak
F32_RTOL = 1e-5
#: bf16 attention: a logit whose fp32 sum lands on the other side of a
#: bf16 rounding boundary moves by one bf16 ulp of the logit, and its
#: probability with it; 2^-6 of the output's peak is a few bf16 ulps
ATTN_BF16_RTOL = 2.0 ** -6


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_ulp(peak: float) -> float:
    return 2.0 ** (np.floor(np.log2(peak)) - 7) if peak > 0 else 0.0


def _attn_inputs(seed, B=2, Sq=5, Hq=8, Hkv=2, hd=16, A=24):
    """Queries at per-slot positions (one slot past the cache's end, as a
    decode at max-len clamps it) and a cache of random rows."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, Sq, Hq, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, A, Hkv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, A, Hkv, hd)).astype(np.float32)
    start = np.array([0, A - Sq + 1])[:B]
    qpos = (start[:, None] + np.arange(Sq)[None]).astype(np.int32)
    return q, k, v, qpos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Hkv", [(1, 2), (5, 2), (5, 8)])
def test_row_attention_plain_matches_jax(dtype, Sq, Hkv):
    """The reference's ``_sdpa`` on KV heads repeated as its callers
    repeat them, the same mask: decode (one query) and chunk shapes, GQA
    and plain multi-head."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.attention import _repeat_kv, _sdpa
    q, k, v, qpos = _attn_inputs(Sq + Hkv, Sq=Sq, Hkv=Hkv)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    A, rep = k.shape[1], q.shape[2] // Hkv
    mask = (np.arange(A)[None, None, :] <= qpos[:, :, None])[:, None]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = np.asarray(_sdpa(jq, _repeat_kv(jk, rep), _repeat_kv(jv, rep),
                            mask, jdt), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = rak.LAUNCHES
    got = rak.row_attention(tq, tk, tv, torch.from_numpy(qpos))
    assert rak.LAUNCHES == before             # CPU tensors never launch
    assert got.dtype == tdt and got.shape == q.shape
    peak = float(np.abs(want).max())
    tol = (ATTN_BF16_RTOL if dtype == "bfloat16" else F32_RTOL) * peak
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


_NORMS = {"rms": dict(layernorm=False, plus_one=False),
          "rms_plus_one": dict(layernorm=False, plus_one=True),
          "layernorm": dict(layernorm=True, plus_one=False)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(_NORMS))
def test_row_norm_plain_matches_jax(dtype, kind):
    """``apply_norm`` of the reference in each of its forms, on rows of a
    (B, S, D) activation."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.layers import apply_norm

    class Cfg:
        norm_type = "layernorm" if _NORMS[kind]["layernorm"] else "rmsnorm"
        norm_plus_one = _NORMS[kind]["plus_one"]

    rng = np.random.default_rng(len(kind))
    x = rng.normal(0, 2, (2, 3, 96)).astype(np.float32)
    scale = rng.normal(0, 1, (96,)).astype(np.float32)
    bias = rng.normal(0, 1, (96,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p = {"scale": jnp.asarray(scale)}
    if Cfg.norm_type == "layernorm":
        p["bias"] = jnp.asarray(bias)
    want = np.asarray(apply_norm(p, jnp.asarray(x, jdt), Cfg), np.float32)
    before = rnk.LAUNCHES
    got = rnk.row_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                       torch.from_numpy(bias) if "bias" in p else None,
                       plus_one=Cfg.norm_plus_one)
    assert rnk.LAUNCHES == before
    assert got.dtype == tdt and got.shape == x.shape
    peak = float(np.abs(want).max())
    tol = _bf16_ulp(peak) if dtype == "bfloat16" else F32_RTOL * peak
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_rms_head_norm_matches_jax():
    """The per-head qk-norm goes through the same kernel, over head_dim."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.layers import rms_head_norm as jax_head_norm
    from repro_torch.models.layers import rms_head_norm
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 3, 4, 32)).astype(np.float32)
    scale = rng.normal(0, 1, (32,)).astype(np.float32)
    want = np.asarray(jax_head_norm(jnp.asarray(scale), jnp.asarray(x)))
    got = rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_RTOL * float(np.abs(want).max()))


# ------------------------------------------------------------ on the card --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_attention_kernel_matches_plain_and_is_row_stable(cuda, dtype):
    """Kernel vs plain at tinyllama's head layout; every query of a chunk
    call bitwise equal to the same query in a call of its own."""
    tdt = getattr(torch, dtype)
    q, k, v, qpos = _attn_inputs(0, B=2, Sq=16, Hq=32, Hkv=4, hd=64, A=128)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).to(cuda) for a in (q, k, v))
    tpos = torch.from_numpy(qpos).to(cuda)
    before = rak.LAUNCHES
    got = rak.row_attention(tq, tk, tv, tpos)
    torch.cuda.synchronize()
    assert rak.LAUNCHES == before + 1
    want = rak.row_attention_plain(tq, tk, tv, tpos)
    peak = want.float().abs().max().item()
    tol = (ATTN_BF16_RTOL if dtype == "bfloat16" else F32_RTOL) * peak
    assert (got.float() - want.float()).abs().max().item() <= tol
    for t in (0, 7, 15):
        one = rak.row_attention(tq[:, t:t + 1].contiguous(), tk, tv,
                                tpos[:, t:t + 1].contiguous())
        assert torch.equal(one, got[:, t:t + 1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layernorm", [False, True])
def test_row_norm_kernel_matches_plain_and_is_row_stable(cuda, dtype,
                                                         layernorm):
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((256, 2048), generator=gen).to(tdt).to(cuda)
    scale = torch.randn((2048,), generator=gen).to(cuda)
    bias = torch.randn((2048,), generator=gen).to(cuda) if layernorm else None
    got = rnk.row_norm(x, scale, bias)
    want = rnk.row_norm_plain(x, scale, bias)
    peak = want.float().abs().max().item()
    tol = _bf16_ulp(peak) if dtype == "bfloat16" else F32_RTOL * peak
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(rnk.row_norm(x[:4], scale, bias), got[:4])
