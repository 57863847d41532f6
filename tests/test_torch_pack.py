"""The port's bit-level tables and joint-sparse packs against the JAX
package's: CSD/FTA tables equal, packs byte-identical (w_blocks, idx,
scales, nblocks, k/n/k_pad) on the same numpy weights."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import csd as jcsd
from repro.core import fta as jfta
from repro.kernels import ops as jops
from repro.models import init_params as jax_init_params
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro_torch.configs import get_config
from repro_torch.core import csd, fta
from repro_torch.kernels import ops
from repro_torch.sparsity.sparse_linear import build_stacked_tables
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port


def _np(t):
    """A tensor as numpy, bf16 as its 16-bit pattern."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_pack(p, j):
    for field in ("w_blocks", "idx", "scales", "nblocks"):
        mine, ref = _np(getattr(p, field)), _jnp(getattr(j, field))
        assert mine.dtype == ref.dtype, field
        np.testing.assert_array_equal(mine, ref, err_msg=field)
    assert (p.k, p.n, p.k_pad) == (j.k, j.n, j.k_pad)


def test_csd_and_fta_tables_equal():
    np.testing.assert_array_equal(csd.PHI_TABLE, jcsd.PHI_TABLE)
    np.testing.assert_array_equal(csd.CSD_DIGITS_TABLE, jcsd.CSD_DIGITS_TABLE)
    np.testing.assert_array_equal(fta.PROJECTION_LUT, jfta.PROJECTION_LUT)
    # ties in the projection go toward the larger value: 0 -> +1 at phi 1
    assert fta.PROJECTION_LUT[1, 0 + 128] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fta_quantize_matches(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (64, 48)).astype(np.int32)
    q[:, :3] = 0                                  # all-zero filters -> th 0
    mask = (rng.random((64, 48)) > 0.3).astype(np.int32)
    jq, jth = jfta.fta_quantize(q, mask)
    tq, tth = fta.fta_quantize(torch.from_numpy(q), torch.from_numpy(mask))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tth.numpy(), np.asarray(jth))


@pytest.mark.parametrize("K,N,vs", [(256, 256, 0.5), (200, 100, 0.5),
                                    (128, 96, 0.0), (96, 160, 0.75)])
def test_pack_joint_sparse_byte_identical(K, N, vs):
    rng = np.random.default_rng(K + N)
    w = rng.laplace(0, 0.02, (K, N)).astype(np.float32)
    j = jops.pack_joint_sparse(w, bk=32, bn=32, value_sparsity=vs or None)
    p = ops.pack_joint_sparse(torch.from_numpy(w), bk=32, bn=32,
                              value_sparsity=vs or None)
    _assert_same_pack(p, j)
    np.testing.assert_array_equal(ops.unpack_joint_sparse(p).numpy(),
                                  jops.unpack_joint_sparse(j))
    assert ops.joint_storage_bytes(p) == jops.joint_storage_bytes(j)


@pytest.mark.parametrize("K,N", [(256, 256), (200, 100)])
@pytest.mark.parametrize("payload", ["int8", "bf16"])
def test_pack_stacked_balanced_byte_identical(K, N, payload):
    rng = np.random.default_rng(7)
    ws = rng.laplace(0, 0.02, (3, K, N)).astype(np.float32)
    j = jops.pack_joint_sparse_stacked(ws, value_sparsity=0.5, bk=32, bn=32,
                                       payload=payload)
    p = ops.pack_joint_sparse_stacked(torch.from_numpy(ws),
                                      value_sparsity=0.5, bk=32, bn=32,
                                      payload=payload)
    _assert_same_pack(p, j)
    assert p.maxb == j.maxb
    np.testing.assert_array_equal(ops.unpack_joint_sparse_stacked(p).numpy(),
                                  jops.unpack_joint_sparse_stacked(j))


def test_pack_stacked_ragged_masks_byte_identical():
    """Explicit ragged masks: shared MAXB over the stack, short layers pad
    with zero-payload slots whose idx is 0."""
    rng = np.random.default_rng(0)
    L, K, N, bk = 3, 128, 64, 32
    masks = np.ones((L, K, N), np.int32)
    masks[0, bk:] = 0
    masks[1, 2 * bk:] = 0
    masks[2, :, :5] = 0
    ws = rng.laplace(0, 0.02, (L, K, N)).astype(np.float32)
    j = jops.pack_joint_sparse_stacked(ws, masks, bk=bk, bn=32)
    p = ops.pack_joint_sparse_stacked(torch.from_numpy(ws),
                                      torch.from_numpy(masks), bk=bk, bn=32)
    _assert_same_pack(p, j)


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16, 17, 100, 127, 128, 300])
def test_pick_row_tile_matches(m):
    import jax.numpy as jnp
    assert ops.pick_row_tile(m, torch.float32) == \
        jops.pick_row_tile(m, jnp.float32)
    assert ops.pick_row_tile(m, torch.bfloat16) == \
        jops.pick_row_tile(m, jnp.bfloat16)


@pytest.mark.parametrize("mode,bk", [("joint", 32), ("joint", None),
                                     ("value", 32), ("bit", 32)])
def test_build_stacked_tables_byte_identical(mode, bk):
    """Whole-model stacked tables of reduced tinyllama, from the same JAX
    params crossed to torch through the weight bridge."""
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True,
                          dbpim_mode=mode).scaled(dbpim_value_sparsity=0.5)
    cfg = get_config("tinyllama-1.1b", reduced=True,
                     dbpim_mode=mode).scaled(dbpim_value_sparsity=0.5)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    jt = jax_tables(jparams, jcfg, bk=bk, bn=bk)
    t = build_stacked_tables(params, cfg, bk=bk, bn=bk)
    assert set(t.arrays) == set(jt.arrays)
    assert t.static == jt.static
    for name in jt.arrays:
        for field in ("w_blocks", "idx", "scales", "nblocks"):
            mine, ref = _np(t.arrays[name][field]), \
                _jnp(jt.arrays[name][field])
            assert mine.dtype == ref.dtype, (name, field)
            np.testing.assert_array_equal(mine, ref, err_msg=f"{name}/{field}")


def test_weight_bridge_is_bitwise_for_bf16():
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_numpy(tree, device="cpu")
    wq = params["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(),
                                  tree["blocks"]["attn"]["wq"].view(np.int16))
    assert params["final_norm"]["scale"].dtype == torch.float32
