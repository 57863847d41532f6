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


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_attention_plain_row_bound(dtype, window):
    """The plain version with a row bound nq: the queries below it are the
    unbounded call's bitwise, those at or past it zeros (nq = 0: a whole
    batch row; nq >= Sq: none); the wrapper's CPU branch is the plain
    version."""
    tdt = getattr(torch, dtype)
    q, k, v, qpos = (torch.from_numpy(a) for a in _attn_inputs(7))
    q, k, v = (t.to(tdt) for t in (q, k, v))
    full = rak.row_attention_plain(q, k, v, qpos, window)
    for bound in ([0, 3], [5, 9], [2, 0]):
        nq = torch.tensor(bound, dtype=torch.int32)
        got = rak.row_attention_plain(q, k, v, qpos, window, nq)
        assert torch.equal(rak.row_attention(q, k, v, qpos, window, nq), got)
        for b, n in enumerate(bound):
            assert torch.equal(got[b, :n], full[b, :n]), (bound, b)
            assert not got[b, n:].any(), (bound, b)


def test_row_attention_rejects_a_bound_it_cannot_read():
    """A row bound must be (B,) int32 on q's device: another shape, dtype
    or device raises before any launch, and on the CPU path too."""
    q = torch.zeros((2, 3, 4, 64), dtype=torch.bfloat16, device="meta")
    k = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    pos = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    rak._check(q, k, k, pos, nq=torch.zeros((2,), dtype=torch.int32,
                                            device="meta"))
    for nq, what in (((3,), torch.int32, "meta"), "must be"), \
            (((2, 1), torch.int32, "meta"), "must be"), \
            (((2,), torch.int64, "meta"), "must be"), \
            (((2,), torch.int32, "cpu"), "nq is on"):
        shape, dtype, device = nq
        with pytest.raises(ValueError, match=what):
            rak._check(q, k, k, pos, nq=torch.zeros(shape, dtype=dtype,
                                                    device=device))
    q, k, v, qpos = (torch.from_numpy(a) for a in _attn_inputs(0))
    with pytest.raises(ValueError, match="must be"):
        rak.row_attention(q, k, v, qpos, nq=torch.zeros((2,),
                                                        dtype=torch.int64))


@pytest.mark.parametrize("hd", [16, 24, 32, 64, 100, 128, 136, 256])
def test_row_attention_backward_plan(hd):
    """The bf16 backward kernels' launch shape comes from hd alone: each
    block's shared memory fits the H100's 227 KB, and at hd 256 kernel (b)
    splits the head dims in halves, so that a warp's dK and dV accumulators
    stay 2 x 16 x 128 fp32 (the register trap of a whole 256-wide row)."""
    p = rak.bwd_plan(hd)
    assert p["hdp"] >= hd and p["hdp"] in (16, 32, 64, 128, 256)
    assert max(p["dq_smem"], p["dkv_smem"]) <= rak._SMEM_MAX
    assert p["halves"] == (2 if hd > 128 else 1)
    assert 2 * p["dkv_keys"] * p["hdp"] // p["halves"] <= 2 * 16 * 128
    assert (p["rows"], p["dq_keys"], p["dkv_keys"]) == (16, 64, 16)
    assert p["dkv_warps"] == (8 if hd <= 128 else 4)


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


@pytest.mark.parametrize("D", [1, 7, 128, 256, 1000, 2048, 2050, 3000,
                               4096, 5632, 8192])
@pytest.mark.parametrize("R", [1, 4, 1000, 1024, 4096, 100000])
def test_row_norm_backward_plan(R, D):
    """The norm backward's launch shape: threads a row and chunks a thread
    from D alone (a power of two holding the row at most 4 chunks of 8 a
    thread, 64 threads at tinyllama's 2,048), whole row groups a block,
    the block's shared memory (the scale, then the row groups' sums) at
    most 32 KB, under the 48 KB default, and the blocks (the partial rows)
    capped at 264 and, below the cap, every row in flight at once."""
    p = rnk.bwd_plan(R, D)
    tpr = p["tpr"]
    assert tpr & (tpr - 1) == 0 and 1 <= p["cpt"] <= rnk.BWD_CPT
    assert tpr * p["cpt"] * 8 >= D > (tpr // 2) * rnk.BWD_CPT * 8 or \
        tpr == 1
    assert p["rpb"] * tpr == rnk.BWD_BLOCK
    assert 4 * D <= p["smem"] <= 32 * 1024
    assert p["blocks"] == min(-(-R // p["rpb"]), rnk.BWD_MAX_BLOCKS)
    assert {k: rnk.bwd_plan(7, D)[k] for k in ("tpr", "cpt", "rpb")} == \
        {k: p[k] for k in ("tpr", "cpt", "rpb")}
    if D == 2048:
        assert (tpr, p["cpt"], p["blocks"]) == (64, 4, min(-(-R // 4), 264))
    assert rnk.bwd_plan(R, rnk.BWD_MAX_D + 1) is None


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


def _bits(t):
    """t's bits as integers, so that a NaN equals the same NaN."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


#: the row bound on the card: bf16 at hd 64 and 128, groups 1, 4 and 8,
#: caches of 512, 2,048 and 4,096 keys (one, four and eight cluster
#: ranks), one that streams; f32 resident and streaming
_BOUND_CASES = ([("bfloat16", hd, G, A) for hd in (64, 128) for G in (1, 4, 8)
                 for A in (512, 2048, 4096)]
                + [("bfloat16", 64, 4, 32768), ("float32", 64, 4, 2048),
                   ("float32", 64, 1, 65536)])


@pytest.mark.parametrize("dtype,hd,G,A", _BOUND_CASES)
def test_row_attention_row_bound_on_card(cuda, dtype, hd, G, A):
    """The row bound nq = (0, 5, 32, Sq + 3) over 64-query calls: in each
    batch row the queries below the bound are bitwise the unbounded
    call's, those at or past it exact zeros (a whole row at nq = 0; a
    bound inside a 16-row tile and on a tile's edge); nq >= Sq is the call
    without a bound. A NaN and an Inf in V rows dead for every query still
    make their columns NaN in the rows below the bound, bitwise as
    without it, and the rows past it stay zeros."""
    tdt = getattr(torch, dtype)
    assert rak.streams(A, hd, tdt) == (A > 4096)
    B, Sq, Hkv = 4, 64, 2
    gen = torch.Generator().manual_seed(hd + G + A)
    q = torch.randn((B, Sq, G * Hkv, hd), generator=gen).to(tdt).to(cuda)
    k, v = (torch.randn((B, A, Hkv, hd), generator=gen).to(tdt).to(cuda)
            for _ in range(2))
    start = torch.tensor([0, A // 2, A - Sq - 10, 7], dtype=torch.int32)
    qpos = (start[:, None]
            + torch.arange(Sq, dtype=torch.int32)[None]).to(cuda)
    nq = torch.tensor([0, 5, 32, Sq + 3], dtype=torch.int32, device=cuda)
    vp = v.clone()
    vp[:, A - 1, 0, 3] = float("nan")
    vp[:, A - 2, 1, 5] = float("inf")
    for vv in (v, vp):
        before = rak.LAUNCHES
        full = rak.row_attention(q, k, vv, qpos)
        got = rak.row_attention(q, k, vv, qpos, nq=nq)
        torch.cuda.synchronize()
        assert rak.LAUNCHES == before + 2
        for b, n in enumerate(nq.tolist()):
            n = min(n, Sq)
            assert torch.equal(_bits(got[b, :n]), _bits(full[b, :n])), b
            assert not _bits(got[b, n:]).any(), b
        assert torch.equal(_bits(rak.row_attention(
            q, k, vv, qpos, nq=torch.full_like(nq, Sq))), _bits(full))
    assert torch.isfinite(rak.row_attention(q, k, v, qpos, nq=nq)).all()
    assert got[1:3, :5, :G, 3].isnan().all()
    assert got[1:3, :5, G:, 5].isnan().all()
    assert torch.isfinite(got[1:3, :5, :, 6:]).all()


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


# ------------------------------------------------------------- backward --

@pytest.mark.parametrize("kind", sorted(_NORMS))
def test_row_norm_plain_gradient_matches_jax(kind):
    """The backward kernels' plain version (autograd of row_norm_plain)
    against jax.grad of the reference's ``apply_norm``: dx, dscale and
    dbias in float32."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.layers import apply_norm

    class Cfg:
        norm_type = "layernorm" if _NORMS[kind]["layernorm"] else "rmsnorm"
        norm_plus_one = _NORMS[kind]["plus_one"]

    rng = np.random.default_rng(10 + len(kind))
    x = rng.normal(0, 2, (3, 5, 96)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    p = {"scale": rng.normal(0, 1, (96,)).astype(np.float32)}
    if Cfg.norm_type == "layernorm":
        p["bias"] = rng.normal(0, 1, (96,)).astype(np.float32)
    want = jax.grad(lambda p, x: jnp.sum(apply_norm(p, x, Cfg) * g),
                    argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    dx, dscale, dbias = rnk.row_norm_backward_plain(
        torch.from_numpy(g), torch.from_numpy(x), t["scale"], t.get("bias"),
        plus_one=Cfg.norm_plus_one)
    pairs = [(dx, want[1]), (dscale, want[0]["scale"])]
    if "bias" in p:
        pairs.append((dbias, want[0]["bias"]))
    else:
        assert dbias is None
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=F32_RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("window", [0, 3])
def test_row_attention_plain_gradient_matches_jax(window):
    """Autograd of row_attention_plain against jax.grad of the reference's
    ``_sdpa`` with its causal (and window) mask, GQA group 4, f32: dq, dk
    and dv."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.attention import _repeat_kv, _sdpa
    q, k, v, qpos = _attn_inputs(20 + window, Sq=6, Hq=8, Hkv=2, hd=16)
    g = np.random.default_rng(window).normal(0, 1, q.shape).astype(np.float32)
    A, rep = k.shape[1], 4
    kpos = np.arange(A)[None, None, :]
    live = kpos <= qpos[:, :, None]
    if window:
        live &= kpos > qpos[:, :, None] - window
    mask = jnp.asarray(live[:, None])

    def jloss(q, k, v):
        out = _sdpa(q, _repeat_kv(k, rep), _repeat_kv(v, rep), mask,
                    jnp.float32)
        return jnp.sum(out * g)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (q, k, v)))
    got = rak.row_attention_backward_plain(
        torch.from_numpy(g), *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(qpos), window)
    for t, ref in zip(got, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.numpy(), ref, rtol=0,
                                   atol=F32_RTOL * float(np.abs(ref).max()))


def test_cpu_tensors_differentiate_the_plain_versions():
    """On the CPU the wrappers return the plain versions' tensors, which
    autograd differentiates (no Function, no launch); the backward kernels'
    wrappers refuse CPU tensors."""
    launches = (rak.LAUNCHES, rak.DQ_LAUNCHES, rak.DKV_LAUNCHES,
                rnk.LAUNCHES, rnk.BWD_LAUNCHES)
    q, k, v, qpos = (torch.from_numpy(a) for a in _attn_inputs(3))
    q.requires_grad_()
    out = rak.row_attention(q, k, v, qpos)
    out.sum().backward()
    assert q.grad is not None
    x = torch.randn(4, 32, requires_grad=True)
    scale = torch.ones(32, requires_grad=True)
    rnk.row_norm(x, scale).sum().backward()
    assert scale.grad is not None
    assert (rak.LAUNCHES, rak.DQ_LAUNCHES, rak.DKV_LAUNCHES, rnk.LAUNCHES,
            rnk.BWD_LAUNCHES) == launches
    with pytest.raises(ValueError):
        rnk.row_norm_backward(x.detach(), x.detach(), scale.detach())
    with pytest.raises(ValueError):
        rak.row_attention_backward(out.detach(), q.detach(), k, v, qpos,
                                   out.detach())


def _dt_tol(ref, dtype, bf16_rtol):
    peak = ref.float().abs().max().item()
    return (bf16_rtol(peak) if dtype == "bfloat16" else F32_RTOL * peak)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(_NORMS))
@pytest.mark.parametrize("D", [128, 2048, 2050, 3000, 4096, 8192])
@pytest.mark.parametrize("R", [1, 1000, 1024])
def test_row_norm_backward_kernel_matches_plain(cuda, R, D, kind, dtype):
    """dx within 1e-5 of the peak (f32) or one bf16 ulp, dscale and dbias
    (float32 sums over R rows) within 1e-5 of their peaks, at rows that
    fill the grid's blocks or not (1 and 1,000 rows) and widths up to the
    limit; two launches give the same bits; through autograd the Function
    launches it once."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(D + len(kind) + R)
    x = torch.randn((R, D), generator=gen).to(tdt).to(cuda)
    dy = torch.randn((R, D), generator=gen).to(tdt).to(cuda)
    scale = torch.randn((D,), generator=gen).to(cuda)
    bias = (torch.randn((D,), generator=gen).to(cuda)
            if _NORMS[kind]["layernorm"] else None)
    plus_one = _NORMS[kind]["plus_one"]
    before = rnk.BWD_LAUNCHES
    got = rnk.row_norm_backward(dy, x, scale, bias, plus_one=plus_one)
    again = rnk.row_norm_backward(dy, x, scale, bias, plus_one=plus_one)
    torch.cuda.synchronize()
    assert rnk.BWD_LAUNCHES == before + 2
    want = rnk.row_norm_backward_plain(dy, x, scale, bias, plus_one=plus_one)
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        if w is None:
            assert g is None and a is None
            continue
        assert torch.equal(g, a) and g.dtype == w.dtype
        tol = (_dt_tol(w, dtype, _bf16_ulp) if i == 0
               else F32_RTOL * w.abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol, i
    xs = x.clone().requires_grad_()
    ss = scale.clone().requires_grad_()
    rnk.row_norm(xs, ss, bias, plus_one=plus_one).backward(dy)
    assert rnk.BWD_LAUNCHES == before + 3
    assert torch.equal(xs.grad, got[0]) and torch.equal(ss.grad, got[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(_NORMS))
@pytest.mark.parametrize("D", [128, 2048, 3000, 8192])
def test_row_norm_backward_dx_bitwise_independent_of_rows(cuda, D, kind,
                                                          dtype):
    """A row's dx is the same bits in a 4-row call and a 1,024-row call
    (the row sums' order comes from D alone), while the parameter sums of
    the two calls differ only as their rows do."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3 * D + len(kind))
    x = torch.randn((1024, D), generator=gen).to(tdt).to(cuda)
    dy = torch.randn((1024, D), generator=gen).to(tdt).to(cuda)
    scale = torch.randn((D,), generator=gen).to(cuda)
    bias = (torch.randn((D,), generator=gen).to(cuda)
            if _NORMS[kind]["layernorm"] else None)
    plus_one = _NORMS[kind]["plus_one"]
    full = rnk.row_norm_backward(dy, x, scale, bias, plus_one=plus_one)
    four = rnk.row_norm_backward(dy[:4], x[:4], scale, bias,
                                 plus_one=plus_one)
    torch.cuda.synchronize()
    assert torch.equal(four[0], full[0][:4])
    want = rnk.row_norm_backward_plain(dy[:4], x[:4], scale, bias,
                                       plus_one=plus_one)
    for g, w in zip(four[1:], want[1:]):
        if w is not None:
            tol = F32_RTOL * w.abs().max().item()
            assert (g - w).abs().max().item() <= tol


def test_row_norm_backward_slots_follow_the_plan(cuda):
    """The C library's partial rows (``row_norm_bwd_slots``) are the
    blocks of ``bwd_plan``, and 0 past the backward's limit."""
    lib = rnk._library()
    for D in (1, 8, 128, 2048, 2050, 3000, 4096, 5632, 8192):
        for R in (1, 3, 64, 1000, 1024, 4096, 100000):
            assert lib.row_norm_bwd_slots(R, D) == \
                rnk.bwd_plan(R, D)["blocks"], (R, D)
    assert lib.row_norm_bwd_slots(1024, rnk.BWD_MAX_D + 1) == 0


_BWD_CASES = {
    # tinyllama's training layout: causal over the sequence's own keys
    "causal-gqa8": dict(B=2, S=96, Hq=32, Hkv=4, hd=64, window=0),
    "window": dict(B=2, S=96, Hq=8, Hkv=2, hd=128, window=17),
    "mha-hd256": dict(B=1, S=40, Hq=4, Hkv=4, hd=256, window=0),
    "hd16-group7": dict(B=1, S=33, Hq=14, Hkv=2, hd=16, window=0),
    # S a multiple of no key or row tile, a window crossing tile edges
    "ragged-window": dict(B=2, S=200, Hq=8, Hkv=2, hd=64, window=37),
    "g1-hd128": dict(B=1, S=72, Hq=4, Hkv=4, hd=128, window=0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_row_attention_backward_kernels_match_plain(cuda, case, dtype):
    """dq, dk, dv of the two backward kernels against the plain version's
    autograd gradients (f32 within 1e-5 of each peak, bf16 within
    2^-6 of it: the plain version rounds its logits, probabilities and
    their gradients to bf16), on causal self-attention (query i at
    position i over the same keys) and with a window; the same bits from
    two launches; through autograd the Function launches each once."""
    c = _BWD_CASES[case]
    tdt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(len(case))
    B, S = c["B"], c["S"]
    q, k, v, dout = (torch.randn((B, S, h, c["hd"]), generator=gen).to(tdt)
                     .to(cuda) for h in (c["Hq"], c["Hkv"], c["Hkv"],
                                         c["Hq"]))
    qpos = torch.arange(S, dtype=torch.int32, device=cuda).expand(B, S)
    out = rak.row_attention(q, k, v, qpos, c["window"])
    before = (rak.DQ_LAUNCHES, rak.DKV_LAUNCHES)
    got = rak.row_attention_backward(dout, q, k, v, qpos, out, c["window"])
    again = rak.row_attention_backward(dout, q, k, v, qpos, out, c["window"])
    torch.cuda.synchronize()
    assert (rak.DQ_LAUNCHES, rak.DKV_LAUNCHES) == (before[0] + 2,
                                                  before[1] + 2)
    want = rak.row_attention_backward_plain(dout, q, k, v, qpos, c["window"])
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), name
        assert g.shape == w.shape and g.dtype == w.dtype, name
        tol = _dt_tol(w, dtype, lambda p: ATTN_BF16_RTOL * p)
        assert (g.float() - w.float()).abs().max().item() <= tol, name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    rak.row_attention(*leaves, qpos, c["window"]).backward(dout)
    assert (rak.DQ_LAUNCHES, rak.DKV_LAUNCHES) == (before[0] + 3,
                                                  before[1] + 3)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_row_attention_backward_dead_rows_and_decode_positions(cuda):
    """Queries at arbitrary positions against a longer cache, three of
    them with no live key (qpos < 0: the even softmax, no gradient to q):
    the kernels against the plain version's gradients in f32."""
    q, k, v, qpos = _long_attn_inputs(64, 4, 300, torch.float32, cuda, Sq=40)
    dout = torch.randn_like(q)
    out = rak.row_attention(q, k, v, qpos)
    got = rak.row_attention_backward(dout, q, k, v, qpos, out)
    want = rak.row_attention_backward_plain(dout, q, k, v, qpos)
    for g, w in zip(got, want):
        tol = F32_RTOL * w.abs().max().item()
        assert (g - w).abs().max().item() <= tol
    assert torch.equal(got[0][0, :2], torch.zeros_like(got[0][0, :2]))


def test_row_attention_backward_dead_rows_and_decode_positions_bf16(cuda):
    """The bf16 twin: queries at arbitrary positions against a longer cache,
    three with no live key, whose even softmax kernel (b) adds to every dV
    row on the tensor cores: within 2^-6 of each peak of the plain
    version's gradients, bitwise repeatable, dQ of those rows exactly 0."""
    q, k, v, qpos = _long_attn_inputs(64, 4, 300, torch.bfloat16, cuda,
                                      Sq=40)
    dout = torch.randn_like(q)
    out = rak.row_attention(q, k, v, qpos)
    got = rak.row_attention_backward(dout, q, k, v, qpos, out)
    again = rak.row_attention_backward(dout, q, k, v, qpos, out)
    want = rak.row_attention_backward_plain(dout, q, k, v, qpos)
    torch.cuda.synchronize()
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), name
        tol = ATTN_BF16_RTOL * w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol, name
    assert torch.equal(got[0][0, :2], torch.zeros_like(got[0][0, :2]))


def test_row_attention_backward_dead_key_nonfinite_bf16(cuda):
    """What the source header promises of non-finite values in dead keys on
    the bf16 path: an Inf in a dead K row makes its column of dQ NaN in
    exactly the rows of the 16-row blocks of kernel (a) whose 64-key tiles
    hold that key; a NaN in a dead V row reaches nothing; dK and dV of keys
    dead for every row are exact zeros; every other value is bitwise the
    clean call's. Causal queries 0..199 with a window of 37 against 300
    keys, so keys 200.. are dead for every row."""
    B, Sq, Hq, Hkv, hd, A, window = 2, 200, 8, 2, 64, 300, 37
    G, plan = Hq // Hkv, rak.bwd_plan(hd)
    gen = torch.Generator().manual_seed(5)
    q, dout = (torch.randn((B, Sq, Hq, hd), generator=gen)
               .to(torch.bfloat16).to(cuda) for _ in range(2))
    k, v = (torch.randn((B, A, Hkv, hd), generator=gen).to(torch.bfloat16)
            .to(cuda) for _ in range(2))
    qpos = torch.arange(Sq, dtype=torch.int32, device=cuda).expand(B, Sq)
    out = rak.row_attention(q, k, v, qpos, window)
    clean = rak.row_attention_backward(dout, q, k, v, qpos, out, window)
    b, hk, kd, vd = 1, 0, 7, 3
    # 203 in a tile blocks multiply, 280 in one none does
    kp, vp = k.clone(), v.clone()
    for j in (203, 280):
        kp[b, j, hk, kd] = float("inf")
        vp[b, j, hk, vd] = float("nan")
    vp[b, 205, hk, vd + 1] = float("nan")
    got = rak.row_attention_backward(dout, q, kp, vp, qpos, out, window)
    torch.cuda.synchronize()
    nan_rows = torch.zeros((B, Sq, Hq), dtype=torch.bool)
    R, T = plan["rows"], plan["dq_keys"]
    for rb in range(-(-Sq * G // R)):
        qs = sorted({f // G for f in range(rb * R, rb * R + R)
                     if f // G < Sq})
        lo = min(max(0, s - window + 1) for s in qs)
        hi = max(min(s, A - 1) for s in qs)
        if lo // T <= 203 // T <= hi // T:
            for f in range(rb * R, rb * R + R):
                if f // G < Sq:
                    nan_rows[b, f // G, hk * G + f % G] = True
    assert nan_rows.any() and not nan_rows.all()
    want_nan = torch.zeros((B, Sq, Hq, hd), dtype=torch.bool)
    want_nan[..., kd] = nan_rows
    dq = got[0].cpu()
    assert torch.equal(dq.isnan(), want_nan)
    assert torch.equal(dq[~want_nan], clean[0].cpu()[~want_nan])
    for g, c in zip(got[1:], clean[1:]):
        assert torch.equal(g, c)
        for j in (203, 205, 280):
            assert not g[b, j].any()
