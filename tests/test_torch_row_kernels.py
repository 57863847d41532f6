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
@pytest.mark.parametrize("Sq,Hkv,Hq,hd", [
    pytest.param(1, 2, 8, 16, id="1-2"),
    pytest.param(5, 2, 8, 16, id="5-2"),
    pytest.param(5, 8, 8, 16, id="5-8"),
    pytest.param(1, 2, 16, 64, id="1-2-hd64"),
    pytest.param(5, 1, 8, 64, id="5-1-hd64"),
    pytest.param(5, 2, 4, 128, id="5-2-hd128"),
    pytest.param(1, 2, 14, 32, id="1-2-group7"),
    pytest.param(5, 1, 7, 64, id="5-1-group7")])
def test_row_attention_plain_matches_jax(dtype, Sq, Hkv, Hq, hd):
    """The reference's ``_sdpa`` on KV heads repeated as its callers
    repeat them, the same mask: decode (one query) and chunk shapes, GQA
    (groups of 2 to 8, and arctic's 7) and plain multi-head, at the head
    dims of the configs."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.attention import _repeat_kv, _sdpa
    seed = Sq + Hkv if hd == 16 else Sq + Hkv + Hq + hd
    q, k, v, qpos = _attn_inputs(seed, Sq=Sq, Hq=Hq, Hkv=Hkv, hd=hd)
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


def test_row_attention_rejects_shapes_the_kernel_does_not_take():
    """A shape past the kernel's limits raises before any launch: a head dim
    over 256, a batch over a grid's 65,535 rows. A cache whose logits do
    not fit a block's shared memory is taken (the streaming path)."""
    q = torch.zeros((1, 1, 2, 512), device="meta")
    k = torch.zeros((1, 8, 2, 512), device="meta")
    pos = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        rak._check(q, k, k, pos)
    q = torch.zeros((65536, 1, 2, 64), dtype=torch.bfloat16, device="meta")
    k = torch.zeros((65536, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="batch"):
        rak._check(q, k, k, torch.zeros((65536, 1), dtype=torch.int32,
                                        device="meta"))
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((1, 1, 2, 64), dtype=dtype, device="meta")
        k = torch.zeros((1, 65536, 2, 64), dtype=dtype, device="meta")
        rak._check(q, k, k, pos)


@pytest.mark.parametrize("A,hd,dtype,streams", [
    (512, 64, "bfloat16", False), (2048, 64, "bfloat16", False),
    (2048, 256, "bfloat16", False), (4096, 128, "bfloat16", False),
    (25600, 64, "bfloat16", False), (25601, 64, "bfloat16", True),
    (23040, 128, "bfloat16", False), (23041, 128, "bfloat16", True),
    (17920, 256, "bfloat16", False), (17921, 256, "bfloat16", True),
    (32768, 64, "bfloat16", True), (32768, 128, "bfloat16", True),
    (65536, 64, "bfloat16", True), (2 ** 20, 256, "bfloat16", True),
    (2048, 64, "float32", False), (57852, 64, "float32", False),
    (57853, 64, "float32", True), (65536, 64, "float32", True),
    (65536, 256, "float32", True)])
def test_row_attention_smem_plan(A, hd, dtype, streams):
    """The kernel's shared memory per block fits the H100's 227 KB at every
    cache length: caches up to the old limits (bf16 25,600 rows at hd 64,
    23,040 at 128, 17,920 at 256; f32 57,852 at hd 64) keep their logits
    resident, longer ones stream them."""
    tdt = getattr(torch, dtype)
    assert rak.streams(A, hd, tdt) == streams
    assert rak.smem_bytes(A, hd, tdt) <= rak._SMEM_MAX


def test_row_norm_rejects_rows_past_its_limit():
    x = torch.zeros((1, rnk.MAX_D + 8), device="meta")
    with pytest.raises(ValueError, match="row length"):
        rnk._check(x, rnk.MAX_D + 8)


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


def _long_attn_inputs(hd, group, A, dtype, device, B=2, Hkv=2, Sq=256):
    """A 256-query chunk per slot against a cache slice whose batch stride
    is not A rows (the cache is cut from a longer one): slot 0 from
    position 0, with its first three queries fully masked (qpos < 0);
    slot 1 from A - 200, so its last queries sit at qpos >= A."""
    gen = torch.Generator().manual_seed(hd + group + A)
    Hq = group * Hkv
    q = torch.randn((B, Sq, Hq, hd), generator=gen).to(dtype).to(device)
    big_k = torch.randn((B, A + 5, Hkv, hd), generator=gen).to(dtype)
    big_v = torch.randn((B, A + 5, Hkv, hd), generator=gen).to(dtype)
    k, v = big_k.to(device)[:, :A], big_v.to(device)[:, :A]
    start = torch.tensor([0, A - 200], dtype=torch.int32)[:B]
    qpos = start[:, None] + torch.arange(Sq, dtype=torch.int32)[None]
    qpos[0, :3] = torch.tensor([-1, -7, -1], dtype=torch.int32)
    return q, k, v, qpos.to(device)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("A", [100, 2048])
@pytest.mark.parametrize("group", [1, 7, 8])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
def test_row_attention_kernel_shapes_and_row_stability(cuda, hd, group, A,
                                                       dtype):
    """Every head dim and group size of the configs, a cache length that is
    not a multiple of the key tile and the long-context one, fully masked
    queries and queries past the cache's end: within tolerance of the plain
    version, and every query of the 256-query call bitwise equal to the
    same query in calls of 1, 7 and 64 queries."""
    tdt = getattr(torch, dtype)
    q, k, v, qpos = _long_attn_inputs(hd, group, A, tdt, cuda)
    assert not k.is_contiguous()
    got = rak.row_attention(q, k, v, qpos)
    torch.cuda.synchronize()
    want = rak.row_attention_plain(q, k, v, qpos)
    peak = want.float().abs().max().item()
    tol = (ATTN_BF16_RTOL if dtype == "bfloat16" else F32_RTOL) * peak
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    Sq = q.shape[1]
    for t in range(Sq):
        one = rak.row_attention(q[:, t:t + 1].contiguous(), k, v,
                                qpos[:, t:t + 1].contiguous())
        assert torch.equal(one, got[:, t:t + 1]), t
    for n in (7, 64):
        for s0 in (0, 5, Sq - n):
            part = rak.row_attention(q[:, s0:s0 + n].contiguous(), k, v,
                                     qpos[:, s0:s0 + n].contiguous())
            assert torch.equal(part, got[:, s0:s0 + n]), (n, s0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("A,window", [(100, 1), (100, 17), (2048, 64),
                                      (2048, 700), (2048, 2048),
                                      (32768, 4096), (65536, 4096)])
def test_row_attention_window_bound_on_card(cuda, A, window, dtype):
    """The lower key bound (keys at or below qpos - window are dead, the
    reference's sliding-window mask) at hd 128, group 4: within tolerance
    of the plain version at the same window, with fully masked queries and
    queries past the cache's end (all of whose keys the window then
    masks); window 0 bitwise equal to the call without one; every query
    bitwise equal alone and in 7- and 64-query calls. 32,768 keys take
    the bf16 streaming path, 65,536 both streaming paths."""
    tdt = getattr(torch, dtype)
    q, k, v, qpos = _long_attn_inputs(128, 4, A, tdt, cuda, Sq=64)
    before = rak.LAUNCHES
    got = rak.row_attention(q, k, v, qpos, window)
    torch.cuda.synchronize()
    assert rak.LAUNCHES == before + 1
    want = rak.row_attention_plain(q, k, v, qpos, window)
    peak = want.float().abs().max().item()
    tol = (ATTN_BF16_RTOL if dtype == "bfloat16" else F32_RTOL) * peak
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(rak.row_attention(q, k, v, qpos, 0),
                       rak.row_attention(q, k, v, qpos))
    for t in range(q.shape[1]):
        one = rak.row_attention(q[:, t:t + 1].contiguous(), k, v,
                                qpos[:, t:t + 1].contiguous(), window)
        assert torch.equal(one, got[:, t:t + 1]), t
    for n in (7, 64):
        part = rak.row_attention(q[:, :n].contiguous(), k, v,
                                 qpos[:, :n].contiguous(), window)
        assert torch.equal(part, got[:, :n]), n


@pytest.mark.parametrize("dtype,hd,A", [("bfloat16", 64, 32768),
                                        ("bfloat16", 128, 32768),
                                        ("float32", 64, 65536)])
def test_row_attention_streams_caches_past_the_old_limit(cuda, dtype, hd, A):
    """Caches whose logits do not fit a block's shared memory (bf16 past
    25,600 rows at hd 64 and 23,040 at hd 128, f32 past 57,852) take the
    streaming path: within tolerance of the plain version, with queries
    spread over the whole cache, and every query of the call bitwise equal
    to the same query alone and in a 7-query call."""
    tdt = getattr(torch, dtype)
    assert rak.streams(A, hd, tdt)
    q, k, v, qpos = _long_attn_inputs(hd, 4, A, tdt, cuda, Sq=16)
    qpos[1] = torch.arange(A - 16 * 997, A, 997, dtype=torch.int32,
                           device=cuda)           # keys 0 .. A - 1 live
    before = rak.LAUNCHES
    got = rak.row_attention(q, k, v, qpos)
    torch.cuda.synchronize()
    assert rak.LAUNCHES == before + 1
    want = rak.row_attention_plain(q, k, v, qpos)
    peak = want.float().abs().max().item()
    tol = (ATTN_BF16_RTOL if dtype == "bfloat16" else F32_RTOL) * peak
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    for t in range(q.shape[1]):
        one = rak.row_attention(q[:, t:t + 1].contiguous(), k, v,
                                qpos[:, t:t + 1].contiguous())
        assert torch.equal(one, got[:, t:t + 1]), t
    part = rak.row_attention(q[:, 5:12].contiguous(), k, v,
                             qpos[:, 5:12].contiguous())
    assert torch.equal(part, got[:, 5:12])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(_NORMS))
@pytest.mark.parametrize("D", [128, 2048, 2050, 4096, 5632])
def test_row_norm_kernel_shapes_and_row_stability(cuda, D, kind, dtype):
    """Row lengths of the configs (a head norm, tinyllama's d_model, one not
    a multiple of 8, mamba2's gated-norm d_in, tinyllama's d_ff) at 4,096
    rows within tolerance of the plain
    version; the first rows of calls of 1, 4 and 256 rows, and of an x
    that starts at an odd element offset, bitwise equal to the same rows
    of the 4,096-row call."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(D + len(kind))
    R = 4096
    flat = torch.randn((R * D + 1,), generator=gen).to(tdt).to(cuda)
    x = flat[:R * D].view(R, D)
    odd = flat[1:].view(R, D)
    odd_ref = odd.clone()                 # the same values, aligned
    scale = torch.randn((D,), generator=gen).to(cuda)
    bias = torch.randn((D,), generator=gen).to(cuda)
    b = bias if _NORMS[kind]["layernorm"] else None
    plus_one = _NORMS[kind]["plus_one"]
    got = rnk.row_norm(x, scale, b, plus_one=plus_one)
    torch.cuda.synchronize()
    want = rnk.row_norm_plain(x, scale, b, plus_one=plus_one)
    peak = want.float().abs().max().item()
    tol = _bf16_ulp(peak) if dtype == "bfloat16" else F32_RTOL * peak
    assert (got.float() - want.float()).abs().max().item() <= tol
    for n in (1, 4, 256):
        assert torch.equal(rnk.row_norm(x[:n], scale, b, plus_one=plus_one),
                           got[:n]), n
    assert odd.data_ptr() % 16 != 0
    assert torch.equal(rnk.row_norm(odd, scale, b, plus_one=plus_one),
                       rnk.row_norm(odd_ref, scale, b, plus_one=plus_one))
