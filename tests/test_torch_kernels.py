"""The port's block-sparse, FTA/INT8 and DBMU kernels' plain versions
against the JAX package's Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) on the same numpy inputs; the packs byte
for byte; and, on a CUDA card, each hand-written kernel against its plain
version.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import dyadic, fta
from repro_torch.kernels import block_sparse_matmul as bsk
from repro_torch.kernels import dbmu_sim
from repro_torch.kernels import fta_int8_matmul as ftk
from repro_torch.kernels import joint_sparse_matmul as jsm
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.port

#: fp32 on both sides, sums in another order (Pallas' per-block dots vs
#: one torch matmul): relative to the output's peak
F32_RTOL = 1e-5

SHAPES = [(128, 256, 128), (256, 512, 256), (128, 128, 384)]


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def jax_kernels():
    """The JAX package's kernels and ops, imported when a test uses them."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.block_sparse_matmul import block_sparse_matmul
    from repro.kernels.fta_int8_matmul import fta_int8_matmul
    return dict(jnp=jnp, ops=jops, ref=jref, bs=block_sparse_matmul,
                fta=fta_int8_matmul)


def _bf16_ulp(peak: float) -> float:
    return 2.0 ** (np.floor(np.log2(peak)) - 7) if peak > 0 else 0.0


def _assert_close(got, want, bf16: bool):
    """f32: within 1e-5 of the peak; bf16: within one bf16 ulp of the
    peak (the fp32 sums differ in the last bits, so the casts may differ
    by one ulp)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    peak = float(np.abs(want).max())
    tol = _bf16_ulp(peak) if bf16 else F32_RTOL * peak
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _tile_masked(rng, K, N, sparsity):
    w = rng.normal(0, 1, (K, N)).astype(np.float32)
    alive = rng.random((K // 128, N // 128)) > sparsity
    alive[0, 0] = True                           # at least one tile
    return w * np.repeat(np.repeat(alive, 128, 0), 128, 1)


# ------------------------------------------------------ block-sparse -------

@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("sparsity", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_plain_matches_jax(jax_kernels, M, K, N, sparsity,
                                        dtype):
    jnp, jops = jax_kernels["jnp"], jax_kernels["ops"]
    rng = np.random.default_rng(M + K + N)
    w = _tile_masked(rng, K, N, sparsity)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jw, jidx = jops.pack_block_sparse(w, np.ones_like(w, np.int32))
    want = jax_kernels["bs"](jnp.asarray(x, jdt), jw.astype(jdt), jidx,
                             interpret=True)
    w_blocks, idx = ops.pack_block_sparse(torch.from_numpy(w),
                                          torch.ones((K, N), dtype=torch.int32))
    np.testing.assert_array_equal(w_blocks.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    xt = _to_torch(np.asarray(jnp.asarray(x, jdt), np.float32), tdt)
    before = bsk.LAUNCHES
    got = bsk.block_sparse_matmul(xt, w_blocks.to(tdt), idx)
    assert bsk.LAUNCHES == before             # CPU tensors never launch
    assert got.dtype == tdt and got.shape == (M, N)
    _assert_close(got, want, dtype == "bfloat16")
    # the public op on 3D activations, and the dense oracle
    got3 = ops.sparse_dense(xt.reshape(2, M // 2, K), w_blocks.to(tdt), idx)
    assert torch.equal(got3.reshape(M, N), got)
    if dtype == "float32":
        oracle = ref.block_sparse_matmul_ref(xt, torch.from_numpy(w),
                                             torch.ones((K, N)))
        _assert_close(got, oracle.numpy(), False)


def test_pack_block_sparse_stores_only_alive_blocks(jax_kernels):
    jops = jax_kernels["ops"]
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1, (512, 256)).astype(np.float32)
    alive = np.zeros((4, 2), bool)
    alive[0, :] = True
    alive[2, 1] = True                           # ragged survivors: padding
    mask = np.repeat(np.repeat(alive, 128, 0), 128, 1).astype(np.int32)
    w_blocks, idx = ops.pack_block_sparse(torch.from_numpy(w),
                                          torch.from_numpy(mask))
    jw, jidx = jops.pack_block_sparse(w, mask)
    assert w_blocks.shape == (2, 2, 128, 128) and w_blocks.dtype == \
        torch.float32
    np.testing.assert_array_equal(w_blocks.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert not w_blocks[0, 1].any()              # the padded slot is zero
    with pytest.raises(ValueError):
        ops.pack_block_sparse(torch.zeros(100, 128), torch.ones(100, 128))


@pytest.mark.parametrize("K,N,sparsity", [(300, 200, 0.5), (128, 128, 1.0),
                                          (1000, 64, 0.0)])
def test_random_tile_mask_is_tile_granular(K, N, sparsity):
    """Whole tiles survive or die (ceil + crop), at least one survives, and
    the draw is the generator's alone."""
    masks = [ops.random_tile_mask(torch.Generator().manual_seed(9), K, N,
                                  sparsity, tile=64) for _ in range(2)]
    assert torch.equal(masks[0], masks[1])
    m = masks[0]
    assert m.dtype == torch.int32 and m.shape == (K, N) and m.any()
    pad = (0, (-N) % 64, 0, (-K) % 64)
    shape = (-(-K // 64), 64, -(-N // 64), 64)
    kept = F.pad(m, pad).reshape(shape).sum(dim=(1, 3))
    cells = F.pad(torch.ones_like(m), pad).reshape(shape).sum(dim=(1, 3))
    assert ((kept == 0) | (kept == cells)).all()
    if sparsity == 0.0:
        assert m.all()


# ---------------------------------------------------------- int8 FTA -------

@pytest.mark.parametrize("M,K,N", [(128, 512, 128), (256, 1024, 256)])
@pytest.mark.parametrize("sparsity", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
def test_fta_int8_plain_matches_jax(jax_kernels, M, K, N, sparsity, dtype,
                                    out):
    """x is rounded to bf16 inside, whatever its dtype; f32 outputs agree
    to 1e-5 of the peak, bf16 outputs to one bf16 ulp of it."""
    jnp = jax_kernels["jnp"]
    rng = np.random.default_rng(M + N)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    w_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    w_q = (w_q * (rng.random((K, N)) >= sparsity)).astype(np.int8)
    scales = rng.uniform(0.005, 0.02, (1, N)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jod, tod = getattr(jnp, out), getattr(torch, out)
    want = jax_kernels["fta"](jnp.asarray(x, jdt), jnp.asarray(w_q),
                              jnp.asarray(scales), out_dtype=jod,
                              interpret=True)
    xt = _to_torch(np.asarray(jnp.asarray(x, jdt), np.float32), tdt)
    before = ftk.LAUNCHES
    got = ftk.fta_int8_matmul(xt, torch.from_numpy(w_q),
                              torch.from_numpy(scales), out_dtype=tod)
    assert ftk.LAUNCHES == before
    assert got.dtype == tod and got.shape == (M, N)
    _assert_close(got, want, out == "bfloat16")
    # the public op (default bf16 out) and the reference oracle
    got3 = ops.fta_dense(xt.reshape(2, M // 2, K), torch.from_numpy(w_q),
                         torch.from_numpy(scales))
    assert got3.dtype == torch.bfloat16
    oracle = ref.fta_int8_matmul_ref(xt.to(torch.bfloat16),
                                     torch.from_numpy(w_q),
                                     torch.from_numpy(scales))
    _assert_close(got3.reshape(M, N), oracle.float().numpy(), True)


def test_fta_matmul_exact_on_fta_grid():
    """FTA weights are exact on the INT8 x scale grid: the kernel's math
    equals the float math on the dequantized weights to bf16 rounding."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(0, 0.05, (512, 128)).astype(np.float32))
    q, scale, _, _ = ops.fta_pack(w, torch.ones((512, 128),
                                                dtype=torch.int32))
    x = torch.from_numpy(rng.normal(0, 1, (128, 512)).astype(np.float32))
    got = ops.fta_dense(x, q, torch.full((1, 128), float(scale)))
    want = x.to(torch.bfloat16).float() @ (q.float() * scale)
    _assert_close(got, want.to(torch.bfloat16).float().numpy(), True)


# ------------------------------------------------------------- DBMU --------

def _fta_packed(rng, K, N):
    q = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int32))
    q_fta, _ = fta.fta_quantize(q, torch.ones_like(q))
    return q_fta, dyadic.pack_terms(q_fta)


@pytest.mark.parametrize("M,K,N", [(16, 64, 128), (8, 8, 128), (5, 37, 19),
                                   (64, 256, 256)])
def test_dbmu_plain_exact_against_jax(jax_kernels, M, K, N):
    """Bit-serial AND + CSD adder tree == integer matmul, exactly, and ==
    the JAX kernel wherever its tiles fit."""
    jops, jref = jax_kernels["ops"], jax_kernels["ref"]
    rng = np.random.default_rng(M * K + N)
    q_fta, packed = _fta_packed(rng, K, N)
    x = rng.integers(-128, 128, (M, K), dtype=np.int32)
    before = dbmu_sim.LAUNCHES
    got = ops.dbmu_reference_check(torch.from_numpy(x), packed)
    assert dbmu_sim.LAUNCHES == before
    assert got.dtype == torch.int32 and got.shape == (M, N)
    want = jref.dbmu_matmul_ref(x, packed.numpy())
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(
        ref.dbmu_matmul_ref(torch.from_numpy(x), packed).numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int64) @ q_fta.numpy().astype(np.int64))
    if M % 8 == 0 and N % 128 == 0:
        jgot = np.asarray(jops.dbmu_reference_check(x, packed.numpy(),
                                                    interpret=True))
        np.testing.assert_array_equal(got.numpy(), jgot)


@pytest.mark.parametrize("seed", range(10))
def test_dbmu_plain_exact_random_sweep(seed):
    """Seeded random shapes, weights and inputs over the full int8 range
    (including -128): the plain datapath equals the integer matmul."""
    rng = np.random.default_rng(seed)
    M, K, N = (int(v) for v in rng.integers(1, 97, 3))
    q_fta, packed = _fta_packed(rng, K, N)
    x = rng.integers(-128, 128, (M, K), dtype=np.int32)
    got = dbmu_sim.dbmu_matmul(torch.from_numpy(x), packed)
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int64) @ q_fta.numpy().astype(np.int64))


def _all_pair_packs(rng, n_cols):
    """(1024, n_cols, 2) uint8: every column holds each of the 32 x 32 pairs
    of low five bits once, in its own order, with random bits 5-7 (which
    carry nothing)."""
    pairs = np.stack(np.meshgrid(np.arange(32), np.arange(32),
                                 indexing="ij"), -1).reshape(1024, 2)
    cols = [pairs[rng.permutation(1024)] for _ in range(n_cols)]
    low = np.stack(cols, axis=1)                                 # (1024, N, 2)
    return (low | (rng.integers(0, 8, low.shape) << 5)).astype(np.uint8)


def test_dbmu_block_operands_over_all_term_pairs(jax_kernels):
    """The kernel's exact evaluation, sum_b (x @ S_b) << 2b with the
    pair-table operands S_b in [-4, 4], equals the plain datapath and the
    JAX kernel (interpret mode) over all 32 x 32 pairs of term bytes and
    every x in [-128, 127]."""
    jops = jax_kernels["ops"]
    rng = np.random.default_rng(13)
    packed = torch.from_numpy(_all_pair_packs(rng, 128))
    x = np.stack([rng.permutation(np.arange(-128, 128))
                  for _ in range(1024)], axis=1).astype(np.int32)  # (256, 1024)
    table = dbmu_sim.pair_table()
    assert table.shape == (1024, 4) and table.dtype == torch.int8
    assert int(table.min()) == -4 and int(table.max()) == 4
    s = dbmu_sim.block_operands(packed)
    assert s.shape == (4, 1024, 128) and s.dtype == torch.int8
    weights = sum(s[b].to(torch.int32) << (2 * b) for b in range(4))
    assert torch.equal(weights, dyadic.unpack_terms(packed))
    xt = torch.from_numpy(x)
    got = dbmu_sim.dbmu_matmul_blocks(xt, packed)
    assert torch.equal(got, dbmu_sim.dbmu_matmul_plain(xt, packed))
    jgot = np.asarray(jops.dbmu_reference_check(x, packed.numpy(),
                                                interpret=True))
    np.testing.assert_array_equal(got.numpy(), jgot)


def test_dbmu_term_table_sums_carry_free():
    """The kernel's decode: two per-term words add bytewise without
    carries (every byte in [4, 12]) and the bias step gives each S_b as
    the direct formula does, for all 32 x 32 pairs of low five bits."""
    tw = dbmu_sim.term_table()
    assert tw.shape == (32,)
    byte = (tw[:, None] >> (8 * torch.arange(4))[None]) & 0xFF
    assert int(byte.min()) >= 2 and int(byte.max()) <= 6
    sums = tw[None, :] + tw[:, None]
    sum_bytes = (sums[..., None] >> (8 * torch.arange(4))) & 0xFF
    assert int(sum_bytes.min()) >= 4 and int(sum_bytes.max()) <= 12
    assert int(sums.max()) < 2 ** 32
    t = np.arange(32)
    value = ((t >> 4) & 1) * (1 - 2 * (t & 1)) * (1 << ((t >> 1) & 1))
    direct = np.zeros((32, 32, 4), np.int64)              # [t1, t0, b]
    for b in range(4):
        term = np.where(((t >> 2) & 3) == b, value, 0)
        direct[..., b] = term[None, :] + term[:, None]
    np.testing.assert_array_equal(dbmu_sim.pair_table().numpy(),
                                  direct.reshape(1024, 4))


def test_dbmu_block_operands_of_csd_packs_lie_in_two():
    """pack_terms puts a weight's two CSD digits in different blocks, so
    its operands S_b lie in [-2, 2] and rebuild every int8 value."""
    q = torch.arange(-128, 128, dtype=torch.int32)[:, None]
    s = dbmu_sim.block_operands(dyadic.pack_terms(q))
    assert int(s.abs().max()) == 2
    rebuilt = sum(s[b].to(torch.int32) << (2 * b) for b in range(4))
    assert torch.equal(rebuilt, dyadic.unpack_terms(dyadic.pack_terms(q)))


@pytest.mark.parametrize("seed", range(6))
def test_dbmu_blocks_exact_on_random_bytes(seed):
    """Random shapes, any term bytes, x over the full int8 range: the block
    evaluation equals the plain datapath and the integer matmul."""
    rng = np.random.default_rng(100 + seed)
    M, K, N = (int(v) for v in rng.integers(1, 130, 3))
    packed = torch.from_numpy(rng.integers(0, 256, (K, N, 2), dtype=np.uint8))
    x = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int32))
    x[0, 0], x[-1, -1] = -128, 127
    got = dbmu_sim.dbmu_matmul_blocks(x, packed)
    assert torch.equal(got, dbmu_sim.dbmu_matmul_plain(x, packed))
    w = dyadic.unpack_terms(packed).to(torch.int64)
    assert torch.equal(got.to(torch.int64), x.to(torch.int64) @ w)


def _wide_x(rng, M, K, extremes=(200, -200, 255, -255)):
    """x (M, K) int32 over [-255, 255], every value of ``extremes`` in row
    0 and in the last column, and a few values past 255 (300, -1000,
    2^31 - 1, -2^31) that the datapath cuts to their low magnitude byte."""
    x = torch.from_numpy(rng.integers(-255, 256, (M, K), dtype=np.int32))
    for i, e in enumerate(extremes):
        x[0, i % K] = e
        x[i % M, -1] = e
    if M * K >= 8:
        x.view(-1)[-4:] = torch.tensor([300, -1000, 2 ** 31 - 1, -2 ** 31],
                                       dtype=torch.int32)
    return x


@pytest.mark.parametrize("seed", range(4))
def test_dbmu_blocks_exact_for_x_past_int8(seed):
    """x at +-200 and +-255 and past 255: the kernel's arithmetic (the block
    evaluation of x' = sign(x) * (|x| mod 256)) equals the plain datapath,
    and x' @ W equals the integer matmul for every |x| <= 255."""
    rng = np.random.default_rng(300 + seed)
    M, K, N = (int(v) for v in rng.integers(2, 130, 3))
    packed = torch.from_numpy(rng.integers(0, 256, (K, N, 2), dtype=np.uint8))
    x = _wide_x(rng, M, K)
    got = dbmu_sim.dbmu_matmul_blocks(x, packed)
    assert torch.equal(got, dbmu_sim.dbmu_matmul_plain(x, packed))
    w = dyadic.unpack_terms(packed).to(torch.int64)
    xs = x.to(torch.int64)
    small = xs.abs().le(255).all(dim=1)
    assert torch.equal(got[small].to(torch.int64) % 2 ** 32,
                       (xs[small] @ w) % 2 ** 32)


# -------------------------------------------------------- on the card ------

@pytest.mark.parametrize("M", [4, 37, 256])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_block_sparse_kernel_matches_plain_on_card(cuda, M, xdt):
    rng = np.random.default_rng(M)
    w = torch.from_numpy(_tile_masked(rng, 512, 384, 0.5))
    w_blocks, idx = ops.pack_block_sparse(w.to(cuda),
                                          torch.ones_like(w).to(cuda))
    x = torch.from_numpy(rng.normal(0, 1, (M, 512)).astype(np.float32))
    x = x.to(xdt).to(cuda)
    before = bsk.LAUNCHES
    got = bsk.block_sparse_matmul(x, w_blocks.to(xdt), idx)
    torch.cuda.synchronize()
    assert bsk.LAUNCHES == before + 1
    want = bsk.block_sparse_matmul_plain(x, w_blocks.to(xdt), idx)
    _assert_close(got.cpu(), want.float().cpu().numpy(), xdt == torch.bfloat16)
    head = bsk.block_sparse_matmul(x[:4].contiguous(), w_blocks.to(xdt), idx)
    assert torch.equal(head, got[:4])          # rows stable across M


@pytest.mark.parametrize("M", [4, 37, 256])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_fta_int8_kernel_matches_plain_on_card(cuda, M, xdt, out):
    rng = np.random.default_rng(M)
    K, N = 1000, 200                     # no TPU tile divides these
    x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32))
    x = x.to(xdt).to(cuda)
    w_q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.005, 0.02, (1, N)).astype(np.float32))
    w_q, sc = w_q.to(cuda), sc.to(cuda)
    before = ftk.LAUNCHES
    got = ftk.fta_int8_matmul(x, w_q, sc, out_dtype=out)
    torch.cuda.synchronize()
    assert ftk.LAUNCHES == before + 1
    want = ftk.fta_int8_matmul_plain(x, w_q, sc, out_dtype=out)
    _assert_close(got.cpu(), want.float().cpu().numpy(), out == torch.bfloat16)


@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (37, 300, 129),
                                   (256, 512, 384)])
def test_dbmu_kernel_exact_on_card(cuda, M, K, N):
    rng = np.random.default_rng(K)
    _, packed = _fta_packed(rng, K, N)
    x = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int32))
    x, packed = x.to(cuda), packed.to(cuda)
    before = dbmu_sim.LAUNCHES
    got = dbmu_sim.dbmu_matmul(x, packed)
    torch.cuda.synchronize()
    assert dbmu_sim.LAUNCHES == before + 1
    assert torch.equal(got, dbmu_sim.dbmu_matmul_plain(x, packed))
    assert torch.equal(got.long(), ref.dbmu_matmul_ref(x, packed))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 256), device=cuda)
    wb = torch.zeros((2, 1, 128, 128), device=cuda, dtype=torch.bfloat16)
    idx = torch.zeros((2, 1), device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):           # payload dtype != x dtype
        bsk.block_sparse_matmul(x, wb, idx)
    with pytest.raises(TypeError):           # weights must be int8
        ftk.fta_int8_matmul(x, torch.zeros((256, 8), device=cuda),
                            torch.ones((1, 8), device=cuda))
    with pytest.raises(TypeError):           # x must be int32
        dbmu_sim.dbmu_matmul(x, torch.zeros((256, 8, 2), device=cuda,
                                            dtype=torch.uint8))


#: ragged shapes around the kernels' 64 x 64 x 64 tiles, with rows whose
#: bytes are not 16-byte aligned (the element-wise load path)
RAGGED = [(1, 1, 1), (63, 65, 65), (65, 127, 63), (130, 64, 17),
          (64, 192, 200), (4, 2048, 256)]


@pytest.mark.parametrize("M,K,N", RAGGED)
def test_dbmu_kernel_ragged_any_bytes_on_card(cuda, M, K, N):
    """Any term bytes (not only pack_terms'), x at -128 and 127: bitwise
    equal to the plain datapath and to the block evaluation."""
    rng = np.random.default_rng(M * 7 + K + N)
    packed = torch.from_numpy(rng.integers(0, 256, (K, N, 2), dtype=np.uint8))
    x = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int32))
    x[0, 0], x[-1, -1] = -128, 127
    x, packed = x.to(cuda), packed.to(cuda)
    got = dbmu_sim.dbmu_matmul(x, packed)
    torch.cuda.synchronize()
    assert torch.equal(got, dbmu_sim.dbmu_matmul_plain(x, packed))
    assert torch.equal(got, dbmu_sim.dbmu_matmul_blocks(x, packed))


@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (37, 300, 129),
                                   (256, 512, 384), (65, 127, 63)])
def test_dbmu_kernel_exact_for_x_past_int8_on_card(cuda, M, K, N):
    """x at +-200 and +-255 (and past 255) in some K tiles and not in
    others, any term bytes: bitwise equal to the plain datapath and to the
    block evaluation, one launch."""
    rng = np.random.default_rng(M + K + N)
    packed = torch.from_numpy(rng.integers(0, 256, (K, N, 2), dtype=np.uint8))
    x = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int32))
    wide = _wide_x(rng, M, min(K, 64))
    x[:, :wide.shape[1]] = wide           # the first K tile only
    x, packed = x.to(cuda), packed.to(cuda)
    before = dbmu_sim.LAUNCHES
    got = dbmu_sim.dbmu_matmul(x, packed)
    torch.cuda.synchronize()
    assert dbmu_sim.LAUNCHES == before + 1
    assert torch.equal(got, dbmu_sim.dbmu_matmul_plain(x, packed))
    assert torch.equal(got, dbmu_sim.dbmu_matmul_blocks(x, packed))
    every = _wide_x(rng, M, K).to(cuda)   # every K tile split
    assert torch.equal(dbmu_sim.dbmu_matmul(every, packed),
                       dbmu_sim.dbmu_matmul_plain(every, packed))


def test_dbmu_kernel_rows_stable_on_card(cuda):
    rng = np.random.default_rng(21)
    _, packed = _fta_packed(rng, 2048, 320)
    x = torch.from_numpy(rng.integers(-128, 128, (256, 2048), dtype=np.int32))
    x[:, :8] = torch.tensor([-128, 127] * 4, dtype=torch.int32)
    x, packed = x.to(cuda), packed.to(cuda)
    full = dbmu_sim.dbmu_matmul(x, packed)
    head = dbmu_sim.dbmu_matmul(x[:4].contiguous(), packed)
    torch.cuda.synchronize()
    assert torch.equal(head, full[:4])
    assert torch.equal(full, dbmu_sim.dbmu_matmul_plain(x, packed))


@pytest.mark.parametrize("M,K,N", RAGGED)
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_fta_int8_kernel_ragged_on_card(cuda, M, K, N, xdt):
    rng = np.random.default_rng(M * 5 + K + N)
    x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32))
    x = x.to(xdt).to(cuda)
    w_q = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.005, 0.02, (1, N)).astype(np.float32))
    w_q, sc = w_q.to(cuda), sc.to(cuda)
    for out in (torch.float32, torch.bfloat16):
        got = ftk.fta_int8_matmul(x, w_q, sc, out_dtype=out)
        torch.cuda.synchronize()
        want = ftk.fta_int8_matmul_plain(x, w_q, sc, out_dtype=out)
        _assert_close(got.cpu(), want.float().cpu().numpy(),
                      out == torch.bfloat16)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_fta_int8_kernel_rows_stable_on_card(cuda, xdt):
    """Rows 0-3 of an M = 256 call bitwise equal an M = 4 call of the same
    rows: the K order of each output is fixed by K and the tiling alone."""
    rng = np.random.default_rng(22)
    K, N = 2048, 5632
    x = torch.from_numpy(rng.normal(0, 1, (256, K)).astype(np.float32))
    x = x.to(xdt).to(cuda)
    w_q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(0.005, 0.02, (1, N)).astype(np.float32))
    w_q, sc = w_q.to(cuda), sc.to(cuda)
    for out in (torch.float32, torch.bfloat16):
        full = ftk.fta_int8_matmul(x, w_q, sc, out_dtype=out)
        head = ftk.fta_int8_matmul(x[:4].contiguous(), w_q, sc, out_dtype=out)
        torch.cuda.synchronize()
        assert torch.equal(head, full[:4])


# ---------------------------------- gathered-K kernels on the card ------

#: packed layouts of the gathered-K kernels (joint and block-sparse): (K, bk,
#: bn, survivors per N tile). MAXB is the most survivors; shorter tiles pad
#: with zero-payload slots at block 0.
#:   split:   tinyllama's tiles (bk = bn = 128), 4 column tiles x 14 K tiles,
#:            which the split rule runs as 4 splits of a cluster
#:   partial: bk = 64, bn = 96 (a second 64-column chunk half full), a tile
#:            with no survivor at all, 2 splits
#:   reduced: bk = bn = 40 (a reduced config's tile: neither a multiple of
#:            16 nor, for an int8 payload, 16-byte aligned rows), 2 splits
#:   wide:    72 column tiles, no split: blocks of 2 row tiles at M = 65 and
#:            of 4 at M = 256 (one row tile below)
GATHER_LAYOUTS = {"split": (2048, 128, 128, [7, 5]),
                  "partial": (512, 64, 96, [6, 3, 0]),
                  "reduced": (400, 40, 40, [6, 2, 4]),
                  "wide": (256, 64, 64, [4, 3, 2, 1] * 18)}
GATHER_M = [1, 4, 63, 64, 65, 256]


def _gathered_pack(layout, payload, rng):
    """(w_blocks, idx, scales) of a random packed weight: each N tile's
    survivors at distinct ascending K-blocks, padded slots zero at block 0."""
    K, bk, bn, counts = GATHER_LAYOUTS[layout]
    nt, maxb = len(counts), max(counts)
    idx = np.zeros((nt, maxb), np.int32)
    if payload == "int8":
        w = rng.integers(-127, 128, (nt, maxb, bk, bn)).astype(np.int8)
    else:
        w = rng.normal(0, 1, (nt, maxb, bk, bn)).astype(np.float32)
    for n, c in enumerate(counts):
        idx[n, :c] = np.sort(rng.choice(K // bk, c, replace=False))
        w[n, c:] = 0
    w = torch.from_numpy(w)
    if payload != "int8":
        w = w.to(torch.bfloat16 if payload == "bf16" else torch.float32)
    sc = rng.uniform(0.005, 0.02, (1, nt * bn)).astype(np.float32)
    return w, torch.from_numpy(idx), torch.from_numpy(sc)


@pytest.mark.parametrize("layout", list(GATHER_LAYOUTS))
@pytest.mark.parametrize("payload", ["int8", "bf16"])
def test_joint_plain_matches_jax_on_gathered_layouts(jax_kernels, payload,
                                                     layout):
    """The joint kernel's plain version against the JAX kernel (interpret
    mode) on the packs the card tests use: padded slots, a tile with no
    survivor, bk = bn = 40; f32 x, within 1e-5 of the peak."""
    from repro.kernels.joint_sparse_matmul import joint_sparse_matmul
    rng = np.random.default_rng([len(layout), len(payload)])
    w, idx, sc = _gathered_pack(layout, payload, rng)
    K = GATHER_LAYOUTS[layout][0]
    x = rng.normal(0, 1, (16, K)).astype(np.float32)
    jnp = jax_kernels["jnp"]
    wj = (jnp.asarray(w.numpy()) if payload == "int8" else
          jnp.asarray(w.float().numpy()).astype(jnp.bfloat16))
    want = joint_sparse_matmul(jnp.asarray(x), wj, jnp.asarray(idx.numpy()),
                               jnp.asarray(sc.numpy()), bm=8,
                               interpret=True)
    got = jsm.joint_sparse_matmul_plain(torch.from_numpy(x), w, idx, sc)
    _assert_close(got, np.asarray(want), False)


def test_block_sparse_plain_matches_jax_with_padded_slots(jax_kernels):
    """The block-sparse plain version against the JAX kernel (interpret
    mode) on the card tests' 128-tile pack, padded slots included."""
    rng = np.random.default_rng(14)
    w, idx, _ = _gathered_pack("split", "f32", rng)
    x = rng.normal(0, 1, (128, GATHER_LAYOUTS["split"][0])).astype(np.float32)
    jnp = jax_kernels["jnp"]
    want = jax_kernels["bs"](jnp.asarray(x), jnp.asarray(w.numpy()),
                             jnp.asarray(idx.numpy()), interpret=True)
    got = bsk.block_sparse_matmul_plain(torch.from_numpy(x), w, idx)
    _assert_close(got, np.asarray(want), False)


@pytest.mark.parametrize("M", GATHER_M)
@pytest.mark.parametrize("layout", list(GATHER_LAYOUTS))
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("payload", ["int8", "bf16"])
def test_joint_kernel_layouts_on_card(cuda, payload, xdt, layout, M):
    """The joint kernel (int8 payload, and the value-only bf16 payload)
    against its plain version at ragged M, tinyllama's, partial and reduced
    tiles, padded slots and split K: out in x's dtype within 1e-5 * max|ref|
    (f32) or one bf16 ulp (bf16), the fp32 accumulators within 1e-5 *
    max|ref|; rows bitwise equal to the same rows of an M = 256 call."""
    rng = np.random.default_rng([M, len(layout), xdt.itemsize])
    w, idx, sc = (t.to(cuda) for t in _gathered_pack(layout, payload, rng))
    K = GATHER_LAYOUTS[layout][0]
    x256 = torch.from_numpy(rng.normal(0, 1, (256, K)).astype(np.float32))
    x256 = x256.to(xdt).to(cuda)
    x = x256[:M].contiguous()
    before = jsm.LAUNCHES
    got = jsm.joint_sparse_matmul(x, w, idx, sc)
    acc = jsm.joint_sparse_matmul(x, w, idx, sc, out_dtype=torch.float32)
    full = jsm.joint_sparse_matmul(x256, w, idx, sc)
    full_acc = jsm.joint_sparse_matmul(x256, w, idx, sc,
                                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert jsm.LAUNCHES == before + 4
    want = jsm.joint_sparse_matmul_plain(x, w, idx, sc)
    want_acc = jsm.joint_sparse_matmul_plain(x, w, idx, sc, torch.float32)
    _assert_close(got.cpu(), want.float().cpu().numpy(), xdt == torch.bfloat16)
    _assert_close(acc.cpu(), want_acc.cpu().numpy(), False)
    assert torch.equal(got, full[:M]) and torch.equal(acc, full_acc[:M])


@pytest.mark.parametrize("M", GATHER_M)
@pytest.mark.parametrize("layout", list(GATHER_LAYOUTS))
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_block_sparse_kernel_layouts_on_card(cuda, xdt, layout, M):
    """The block-sparse kernel against its plain version on the same
    layouts: within 1e-5 * max|ref| (f32) or one bf16 ulp (bf16); rows
    bitwise equal to the same rows of an M = 256 call."""
    rng = np.random.default_rng([M, len(layout), 7])
    payload = "bf16" if xdt == torch.bfloat16 else "f32"
    w, idx, _ = (t.to(cuda) for t in _gathered_pack(layout, payload, rng))
    K = GATHER_LAYOUTS[layout][0]
    x256 = torch.from_numpy(rng.normal(0, 1, (256, K)).astype(np.float32))
    x256 = x256.to(xdt).to(cuda)
    x = x256[:M].contiguous()
    before = bsk.LAUNCHES
    got = bsk.block_sparse_matmul(x, w, idx)
    full = bsk.block_sparse_matmul(x256, w, idx)
    torch.cuda.synchronize()
    assert bsk.LAUNCHES == before + 2
    want = bsk.block_sparse_matmul_plain(x, w, idx)
    _assert_close(got.cpu(), want.float().cpu().numpy(), xdt == torch.bfloat16)
    assert torch.equal(got, full[:M])


@pytest.mark.parametrize("M", [4, 256])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_joint_kernel_mamba2_in_proj_on_card(cuda, xdt, M):
    """The joint kernel at mamba2-1.3b's in_proj, 2048 x 8512 packed at the
    serving tiles (128 x 128, vs = 0.6): 8512 is not a multiple of 128, so
    the last of the 67 N tiles holds 64 real columns. Against its plain
    version as in test_joint_kernel_layouts_on_card; the 64 padded columns
    come out zero, so ``ops.joint_dense``'s slice back to 8512 drops
    nothing of dt (the last 64 real columns); rows bitwise equal to the
    same rows of an M = 256 call."""
    gen = torch.Generator().manual_seed(17)
    w = torch.randn((1, 2048, 8512), generator=gen) * 2048 ** -0.5
    packed = ops.pack_joint_sparse_stacked(w.to(torch.bfloat16).to(cuda),
                                           value_sparsity=0.6, bk=128,
                                           bn=128)
    p = ops.slice_joint_stacked(packed, 0)
    assert p.w_blocks.shape[0] == 67 and (p.k, p.n) == (2048, 8512)
    x256 = torch.randn((256, 2048), generator=gen).to(xdt).to(cuda)
    x = x256[:M].contiguous()
    got = jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales)
    acc = jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales,
                                  out_dtype=torch.float32)
    full = jsm.joint_sparse_matmul(x256, p.w_blocks, p.idx, p.scales)
    torch.cuda.synchronize()
    want = jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx, p.scales)
    want_acc = jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx, p.scales,
                                             torch.float32)
    _assert_close(got.cpu(), want.float().cpu().numpy(), xdt == torch.bfloat16)
    _assert_close(acc.cpu(), want_acc.cpu().numpy(), False)
    assert got.shape == (M, 67 * 128)
    assert not got[:, 8512:].any() and not acc[:, 8512:].any()
    assert torch.equal(got, full[:M])
    y = ops.joint_dense(x, p)
    assert y.shape == (M, 8512) and torch.equal(y, got[:, :8512])
