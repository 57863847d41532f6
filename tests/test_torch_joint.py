"""The port's ``joint_dense`` against the JAX ``ops.joint_dense`` (Pallas
kernel in interpret mode) on the same numpy inputs, and, on a CUDA card,
the hand-written kernel against its plain version.

The JAX package is imported inside the tests that use it, so the card
tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m port tests/test_torch_joint.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import joint_sparse_matmul as jsm
from repro_torch.kernels import ops

pytestmark = pytest.mark.port

#: fp32 on both sides; the sums run in another order (Pallas' per-block dot
#: vs one torch bmm over the gathered K), so equality holds to rounding
RTOL = ATOL = 1e-5


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def jax_ops():
    """The JAX package's ops (with jax.numpy), imported when a test uses
    them."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    return jops, jnp


def _weights(K, N, seed):
    return np.random.default_rng(seed).laplace(0, 0.05, (K, N)).astype(
        np.float32)


def _pack(K, N, vs, seed=0, bk=32, bn=32):
    return ops.pack_joint_sparse(torch.from_numpy(_weights(K, N, seed)),
                                 bk=bk, bn=bn, value_sparsity=vs)


def _jax_pack(jops, K, N, vs, seed=0, bk=32, bn=32):
    return jops.pack_joint_sparse(_weights(K, N, seed), bk=bk, bn=bn,
                                  value_sparsity=vs)


@pytest.mark.parametrize("M", [4, 8, 100, 128])
@pytest.mark.parametrize("K,N", [(200, 100), (256, 96)])
def test_plain_joint_dense_matches_jax(jax_ops, M, K, N):
    jops, jnp = jax_ops
    j, p = _jax_pack(jops, K, N, 0.5, seed=M), _pack(K, N, 0.5, seed=M)
    x = np.random.default_rng(M + 1).normal(0, 1, (M, K)).astype(np.float32)
    ref = np.asarray(jops.joint_dense(jnp.asarray(x), j, interpret=True))
    before = jsm.LAUNCHES
    got = ops.joint_dense(torch.from_numpy(x), p)
    assert jsm.LAUNCHES == before          # CPU tensors never launch
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_plain_joint_dense_3d_and_bf16(jax_ops):
    jops, jnp = jax_ops
    j, p = _jax_pack(jops, 128, 64, 0.5), _pack(128, 64, 0.5)
    x = np.random.default_rng(3).normal(0, 1, (2, 5, 128)).astype(np.float32)
    ref = np.asarray(jops.joint_dense(jnp.asarray(x), j, interpret=True))
    got = ops.joint_dense(torch.from_numpy(x), p)
    assert got.shape == (2, 5, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # bf16 activations: same bf16 inputs, fp32 accumulation, one bf16 cast
    xb = jnp.asarray(x, jnp.bfloat16)
    refb = np.asarray(jops.joint_dense(xb, j, interpret=True)
                      .astype(jnp.float32))
    gotb = ops.joint_dense(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                           .to(torch.bfloat16), p)
    assert gotb.dtype == torch.bfloat16
    # the fp32 sums differ in the last bits, so the bf16 casts may differ
    # by one bf16 ulp of the value, at most one ulp of max|ref|
    ulp = 2.0 ** (np.floor(np.log2(np.abs(refb).max())) - 7)
    np.testing.assert_allclose(gotb.float().numpy(), refb, rtol=0, atol=ulp)


def test_plain_version_matches_packed_oracle():
    from repro_torch.kernels.ref import joint_packed_ref
    p = _pack(200, 100, 0.5)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (7, 200)).astype(np.float32))
    np.testing.assert_allclose(ops.joint_dense(x, p).numpy(),
                               joint_packed_ref(x, p).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("payload", ["int8", "bf16"])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [4, 37, 256])
def test_kernel_matches_plain_on_card(cuda, xdt, M, payload):
    """f32 out within 1e-5 * max|ref|; bf16 out within one bf16 ulp of
    max|ref|, and the fp32 accumulators (out_dtype=float32) agree too; for
    the joint (int8) and the value-only (bf16) payload."""
    w = torch.from_numpy(_weights(256, 160, M))[None]
    p = ops.slice_joint_stacked(ops.pack_joint_sparse_stacked(
        w, value_sparsity=0.5, bk=64, bn=32, payload=payload), 0)
    w, idx, sc = (p.w_blocks.to(cuda), p.idx.to(cuda), p.scales.to(cuda))
    x = torch.randn((M, 256), generator=torch.Generator().manual_seed(M))
    x = x.to(xdt).to(cuda)
    before = jsm.LAUNCHES
    got = jsm.joint_sparse_matmul(x, w, idx, sc)
    acc = jsm.joint_sparse_matmul(x, w, idx, sc, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert jsm.LAUNCHES == before + 2
    ref = jsm.joint_sparse_matmul_plain(x, w, idx, sc)
    ref_acc = jsm.joint_sparse_matmul_plain(x, w, idx, sc, torch.float32)
    peak = ref_acc.abs().max().item()
    assert (acc - ref_acc).abs().max().item() <= 1e-5 * peak
    bf16_ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
    tol = 1e-5 * peak if xdt == torch.float32 else bf16_ulp
    assert (got.float() - ref.float()).abs().max().item() <= tol
    # row stability: the first rows alone are bitwise the same rows in M
    head = jsm.joint_sparse_matmul(x[:4].contiguous(), w, idx, sc)
    assert torch.equal(head, got[:4])
