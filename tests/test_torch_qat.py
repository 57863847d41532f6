"""The port's FTA-aware QAT and the hybrid-grained pipeline (Fig. 4)
against the JAX package on the CPU: the EMA range observer, fake-quant and
the FTA projection with their straight-through gradients, the final FTA
export, and hybrid's prune_tree / qat_step / export_tree /
sparsity_report over reduced tinyllama's projections. Integer artifacts
(q, phi_th, masks, packed terms) byte for byte; the same numpy inputs on
both sides.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_qat.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import hybrid as jax_hybrid
from repro.core import pruning as jax_pruning
from repro.core import qat as jax_qat
from repro.models import init_params as jax_init_params
from repro_torch.core import hybrid, qat
from repro_torch.core import pruning

pytestmark = pytest.mark.port

#: the reduced tinyllama projections hybrid runs over (layer 0 of each)
PROJECTIONS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
               ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.detach().numpy()


def _weights(seed=0, shape=(64, 48), dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.05, shape) * rng.uniform(0.2, 3.0, shape[-1])
            ).astype(dtype)


def _ema_pair(w_np, steps=3, seed=1):
    """The reference's and the port's EMA states after ``steps`` updates on
    w, w * 1.5, w * 0.7, ..."""
    js, ts = jax_qat.ema_init(), qat.ema_init()
    for k in range(steps):
        x = w_np * (1.0 + 0.5 * np.sin(k + seed))
        js = jax_qat.ema_update(js, jnp.asarray(x))
        ts = qat.ema_update(ts, torch.from_numpy(x))
    return js, ts


def test_ema_update_sequence_matches_jax():
    """First update sets max|x| + 1e-8, later ones blend with decay 0.99;
    every amax and scale bit for bit."""
    w = _weights()
    js, ts = jax_qat.ema_init(), qat.ema_init()
    assert float(ts.amax) == 1.0 and float(ts.initialized) == 0.0
    for k in range(6):
        x = w * (1.0 + 0.5 * np.sin(k))
        js = jax_qat.ema_update(js, jnp.asarray(x))
        ts = qat.ema_update(ts, torch.from_numpy(x))
        assert np.float32(js.amax) == ts.amax.numpy(), k
        assert np.float32(jax_qat.scale_of(js)) == qat.scale_of(ts).numpy()
        assert float(ts.initialized) == 1.0 and ts.decay == js.decay


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fta_fake_quant_values_and_thresholds_match_jax(dtype):
    """w_fq bit for bit (a bf16 weight against the float32 scale computes
    in float32, as jnp promotes), phi_th byte for byte, and w_fq on the
    scale * T(phi_th) grid under the mask."""
    jdt = getattr(jnp, dtype)
    w = np.asarray(jnp.asarray(_weights(2), jdt))
    mask = np.asarray(jax_pruning.block_prune_mask(w.astype(np.float32), 0.5))
    js, ts = _ema_pair(w.astype(np.float32))
    jw, jphi = jax_qat.fta_fake_quant(jnp.asarray(w), jnp.asarray(mask),
                                      jax_qat.scale_of(js))
    tw, tphi = qat.fta_fake_quant(_t(w), _t(mask), qat.scale_of(ts))
    assert tphi.dtype == torch.int32
    np.testing.assert_array_equal(tphi.numpy(), np.asarray(jphi))
    assert str(tw.dtype).split(".")[-1] == str(jw.dtype)
    np.testing.assert_array_equal(_np(tw), np.asarray(jw, np.float32))
    q = np.round(_np(tw) / float(qat.scale_of(ts)))
    assert np.all(q[mask == 0] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fta_fake_quant_gradient_is_the_mask(dtype):
    """The STE keeps the reference's form w*m + (w_fq*m - w*m).detach():
    the gradient of sum(w_fq * g) is g * mask, as jax.grad gives it."""
    jdt = getattr(jnp, dtype)
    w = np.asarray(jnp.asarray(_weights(3), jdt))
    g = np.random.default_rng(4).normal(0, 1, w.shape).astype(np.float32)
    mask = np.asarray(jax_pruning.block_prune_mask(w.astype(np.float32), 0.6))
    scale = np.float32(0.01)

    def jloss(wj):
        wq, _ = jax_qat.fta_fake_quant(wj, jnp.asarray(mask),
                                       jnp.asarray(scale))
        return jnp.sum(wq * g)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(w)), np.float32)
    tw = _t(w).requires_grad_()
    wq, _ = qat.fta_fake_quant(tw, _t(mask), torch.tensor(scale))
    (wq * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(_np(tw.grad), want)
    np.testing.assert_array_equal(
        _np(tw.grad), (torch.from_numpy(g).to(tw.dtype).float()
                       * torch.from_numpy(mask).float()).numpy())


def test_fake_quant_values_and_straight_through_gradient():
    x = np.random.default_rng(5).normal(0, 2, (5, 33)).astype(np.float32)
    scale = np.float32(0.03)
    want = np.asarray(jax_qat.fake_quant(jnp.asarray(x), jnp.asarray(scale)))
    tx = torch.from_numpy(x).requires_grad_()
    got = qat.fake_quant(tx, torch.tensor(scale))
    np.testing.assert_array_equal(_np(got), want)
    got.sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.ones_like(x))
    np.testing.assert_array_equal(
        qat.quantize_int8(torch.from_numpy(x), torch.tensor(scale)).numpy(),
        np.asarray(jax_qat.quantize_int8(jnp.asarray(x), jnp.asarray(scale))))


def test_fta_export_and_dequant_match_jax():
    w = _weights(6, (48, 40))
    mask = np.asarray(jax_pruning.block_prune_mask(w, 0.6))
    js, ts = _ema_pair(w)
    je = jax_qat.fta_export(jnp.asarray(w), jnp.asarray(mask),
                            jax_qat.scale_of(js))
    te = qat.fta_export(torch.from_numpy(w), torch.from_numpy(mask),
                        qat.scale_of(ts))
    for name in ("q", "phi_th", "mask"):
        a, b = getattr(te, name).numpy(), np.asarray(getattr(je, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, name)
    np.testing.assert_array_equal(qat.dequant(te).numpy(),
                                  np.asarray(jax_qat.dequant(je)))


def _projections(dtype="float32"):
    """Layer 0 of each reduced tinyllama projection, (K, N), as numpy."""
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True).scaled(dtype=dtype)
    p = jax_init_params(jcfg, jax.random.PRNGKey(0))["blocks"]
    return {f"{a}/{n}": np.asarray(p[a][n][0]) for a, n in PROJECTIONS}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_pipeline_matches_jax(dtype):
    """Stage 1 masks, three stage-2 QAT steps (EMA states, projected
    weights and thresholds), the stage-3 export (q, scale, phi_th, mask
    and packed terms) and the sparsity report over reduced tinyllama's
    seven projections, one excluded; integers byte for byte, floats bit
    for bit."""
    ws = _projections(dtype)
    cfg_kw = dict(value_sparsity=0.5, exclude=("attn/wk",))
    jcfg, tcfg = (jax_hybrid.HybridConfig(**cfg_kw),
                  hybrid.HybridConfig(**cfg_kw))
    jw = {k: jnp.asarray(v) for k, v in ws.items()}
    tw = {k: _t(v) for k, v in ws.items()}
    jm, tm = jax_hybrid.prune_tree(jw, jcfg), hybrid.prune_tree(tw, tcfg)
    for k in ws:
        assert tm[k].dtype == torch.int32
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), k)
    jst, tst = {}, {}
    for step in range(3):
        jfq, jst, jphi = jax_hybrid.qat_step(jw, jm, jst, jcfg)
        tfq, tst, tphi = hybrid.qat_step(tw, tm, tst, tcfg)
        for k in ws:
            assert np.float32(jst[k].amax) == tst[k].amax.numpy(), (step, k)
            np.testing.assert_array_equal(_np(tfq[k]),
                                          np.asarray(jfq[k], np.float32), k)
            if jphi[k] is None:
                assert tphi[k] is None
            else:
                np.testing.assert_array_equal(tphi[k].numpy(),
                                              np.asarray(jphi[k]), k)
        # the next step trains on weights nudged by the projection
        jw = {k: v * 0.9 + jfq[k].astype(v.dtype) * 0.1 for k, v in jw.items()}
        tw = {k: _t(np.asarray(v)) for k, v in jw.items()}
    jx, tx = (jax_hybrid.export_tree(jw, jm, jst, jcfg),
              hybrid.export_tree(tw, tm, tst, tcfg))
    assert sorted(tx) == sorted(jx) and "attn/wk" not in tx
    for k in jx:
        je, te = jx[k]["export"], tx[k]["export"]
        for name in ("q", "phi_th", "mask"):
            np.testing.assert_array_equal(getattr(te, name).numpy(),
                                          np.asarray(getattr(je, name)), k)
        assert np.float32(je.scale) == te.scale.numpy()
        packed = tx[k]["packed_terms"]
        assert packed.dtype == torch.uint8
        np.testing.assert_array_equal(packed.numpy(),
                                      np.asarray(jx[k]["packed_terms"]), k)
    assert hybrid.sparsity_report(tx) == jax_hybrid.sparsity_report(jx)


def test_prune_tree_leaves_ineligible_tensors_dense():
    """Excluded names, tensors that are not 2-D and N not a multiple of
    alpha get all-ones int32 masks, as in the reference."""
    rng = np.random.default_rng(8)
    ws = {"ok": rng.normal(0, 1, (16, 24)).astype(np.float32),
          "odd": rng.normal(0, 1, (16, 21)).astype(np.float32),
          "vec": rng.normal(0, 1, (24,)).astype(np.float32),
          "skip": rng.normal(0, 1, (16, 24)).astype(np.float32)}
    cfg = hybrid.HybridConfig(value_sparsity=0.5, exclude=("skip",))
    masks = hybrid.prune_tree({k: torch.from_numpy(v) for k, v in ws.items()},
                              cfg)
    want = jax_hybrid.prune_tree({k: jnp.asarray(v) for k, v in ws.items()},
                                 jax_hybrid.HybridConfig(value_sparsity=0.5,
                                                         exclude=("skip",)))
    for k in ws:
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(want[k]))
    assert int(masks["odd"].min()) == 1 and int(masks["ok"].min()) == 0
    assert pruning.value_sparsity(masks["ok"]) == 0.5
