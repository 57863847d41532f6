"""The port's per-layer kernel-mode hook against the JAX package's:
``build_kernel_tables`` artifacts (kinds and contents) and
``make_matmul`` through ``apply_mlp`` and ``prefill_attention``, for all
four modes, on the same numpy weights and activations. Shapes that divide
the kernels' tiles and shapes that do not; activation batches whose rows
are a multiple of 128 (the value and bit kernels) and ragged ones (the
reference's plain math); float32 and bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models.config import ModelConfig as JaxConfig
from repro.models.layers import apply_mlp as japply_mlp
from repro.models.layers import init_mlp as jinit_mlp
from repro.models.layers import make_matmul as jmake_matmul
from repro.sparsity.sparse_linear import \
    build_kernel_tables as jbuild_kernel_tables
from repro_torch.kernels import block_sparse_matmul as bsk
from repro_torch.kernels import fta_int8_matmul as ftk
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, make_matmul
from repro_torch.sparsity.sparse_linear import (KERNEL_MODES,
                                                build_kernel_tables,
                                                pack_projection)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

#: widths that divide the value (128) and bit (K 512, N 128) kernel tiles,
#: and widths that divide neither
DIMS = {"tiled": dict(d_model=512, n_heads=4, n_kv_heads=2, d_ff=1024),
        "ragged": dict(d_model=96, n_heads=3, n_kv_heads=1, d_ff=160)}
#: (batch, chunk): 128 rows take the value/bit kernels, 37 rows do not
ROWS = {"rows128": (2, 64), "rows37": (1, 37)}
#: float32 outputs: fp32 on both sides, sums in another order
F32_RTOL = 1e-5
#: bfloat16 models, and the bit kernel's outputs (it rounds them to bf16
#: like the reference kernel): the two sides round fp32 sums taken in
#: another order to bf16, so a value may land one bf16 ulp away, and the
#: layer's later matmuls carry that on; 2^-6 of the output's peak is a few
#: bf16 ulps of it
BF16_RTOL = 2.0 ** -6


def _cfgs(dims: str, dtype: str, mode: str):
    kw = dict(name="t", family="dense", n_layers=1, vocab_size=64,
              dtype=dtype, dbpim=True, dbpim_value_sparsity=0.5,
              dbpim_mode=mode, **DIMS[dims])
    return JaxConfig(**kw), ModelConfig(**kw)


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised attention and MLP weights per (dims, dtype), as
    numpy trees."""
    out = {}
    for dims in DIMS:
        for dtype in ("float32", "bfloat16"):
            jcfg, _ = _cfgs(dims, dtype, "joint")
            k1, k2 = jax.random.split(jax.random.PRNGKey(0))
            p = {"attn": jattn.init_attention(jcfg, k1),
                 "mlp": jinit_mlp(jcfg, k2, jcfg.d_model, jcfg.d_ff)}
            out[dims, dtype] = jax.tree_util.tree_map(np.asarray, p)
    return out


def _named(tree):
    """The 2D projections by hook name, as float32 numpy."""
    return {k: np.asarray(v, np.float32) for sub in tree.values()
            for k, v in sub.items() if np.asarray(v).ndim == 2}


def _as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _check_tables(tables, jtables):
    assert set(tables) == set(jtables)
    for name, t in tables.items():
        j = jtables[name]
        assert t["kind"] == j["kind"], name
        if t["kind"] == "joint":
            for f in ("w_blocks", "idx", "scales", "nblocks"):
                np.testing.assert_array_equal(
                    getattr(t["packed"], f).numpy(),
                    np.asarray(getattr(j["packed"], f)), err_msg=name)
            continue
        for key in set(t) - {"kind"}:
            assert t[key].dtype == {
                "w_blocks": torch.float32, "idx": torch.int32,
                "w": torch.float32, "q": torch.int8,
                "scales": torch.float32}[key]
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]),
                                          err_msg=f"{name}/{key}")


def _tolerance(cfg, tables, rows: int) -> float:
    bf16 = cfg.dtype == "bfloat16" or (
        rows % 128 == 0 and any(t["kind"] == "bit" for t in tables.values()))
    return BF16_RTOL if bf16 else F32_RTOL


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("dims", sorted(DIMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", KERNEL_MODES)
def test_kernel_modes_match_jax(weights, mode, dtype, dims, rows):
    jcfg, cfg = _cfgs(dims, dtype, mode)
    tree = weights[dims, dtype]
    named = _named(tree)
    jtables = jbuild_kernel_tables(named, jcfg)
    tables = build_kernel_tables({k: torch.from_numpy(v.copy())
                                  for k, v in named.items()}, cfg)
    _check_tables(tables, jtables)
    params = params_from_numpy(tree, device="cpu")
    B, C = ROWS[rows]
    rng = np.random.default_rng(B * C)
    x = rng.normal(0, 1, (B, C, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jmm = jmake_matmul(jcfg, jtables, interpret=True)
    mm = make_matmul(cfg, tables)
    assert mm is not None and jmm is not None
    tol = _tolerance(cfg, tables, B * C)
    launches = (bsk.LAUNCHES, ftk.LAUNCHES)

    # MLP
    want = japply_mlp(tree["mlp"], jx, jcfg, dense_fn=jmm)
    got = apply_mlp(params["mlp"], tx, cfg, dense_fn=mm)
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    want = _as_np(want)
    np.testing.assert_allclose(_as_np(got), want, rtol=0,
                               atol=tol * np.abs(want).max())

    # chunked attention into an empty cache: the last chunk row is ragged
    A = C + 3
    kv = (B, A, cfg.n_kv_heads, cfg.hd)
    n_valid = np.full((B,), C, np.int32)
    n_valid[-1] = C - 2
    jout = jattn.prefill_attention(
        tree["attn"], jx, jnp.zeros(kv, jx.dtype), jnp.zeros(kv, jx.dtype),
        jnp.zeros((B,), jnp.int32), jnp.asarray(n_valid), jcfg, dense_fn=jmm)
    out = attn.prefill_attention(
        params["attn"], tx, torch.zeros(kv, dtype=tx.dtype),
        torch.zeros(kv, dtype=tx.dtype), torch.zeros((B,), dtype=torch.int32),
        torch.from_numpy(n_valid), cfg, dense_fn=mm)
    for g, w in zip(out, jout):
        w = _as_np(w)
        np.testing.assert_allclose(_as_np(g), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30))
    assert (bsk.LAUNCHES, ftk.LAUNCHES) == launches   # CPU: no launches


def test_artifact_kinds_follow_the_shape():
    """value/bit where the shape divides the kernel's tiles, else the
    reference artifacts; bit needs K % 512 as well."""
    w = torch.randn((512, 256), generator=torch.Generator().manual_seed(0))
    assert pack_projection(w, "value")["kind"] == "value"
    assert pack_projection(w[:, :200], "value")["kind"] == "value_ref"
    assert pack_projection(w, "bit")["kind"] == "bit"
    assert pack_projection(w[:256], "bit")["kind"] == "bit_ref"
    assert pack_projection(w[:100, :100], "joint")["kind"] == "joint"
    assert pack_projection(w, "dense") == {"kind": "dense"}
    with pytest.raises(ValueError):
        pack_projection(w, "nope")


def test_make_matmul_is_none_without_dbpim_or_tables():
    _, cfg = _cfgs("ragged", "float32", "value")
    assert make_matmul(cfg, None) is None
    assert make_matmul(cfg, {}) is None
    from dataclasses import replace
    assert make_matmul(replace(cfg, dbpim=False),
                       {"wq": {"kind": "dense"}}) is None
