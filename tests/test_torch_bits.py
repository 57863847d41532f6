"""The port's bit-level core against the JAX package's on the same numpy
inputs: the CSD helpers, block pruning, dyadic term packing over the whole
INT8 domain, INT8 quantization and the FTA pack byte for byte, and the
PIM cost model's reports number for number."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csd as jcsd
from repro.core import dyadic as jdyadic
from repro.core import fta as jfta
from repro.core import pim_model as jpim
from repro.core import pruning as jpruning
from repro.core import qat as jqat
from repro.kernels import ops as jops
from repro_torch.core import csd, dyadic, fta, pim_model, pruning, qat
from repro_torch.kernels import ops

pytestmark = pytest.mark.port

DOMAIN = np.arange(-128, 128, dtype=np.int32)


def _fta_weights(rng, K, N, vs=0.0):
    """FTA-projected INT8 weights (int32) under a tile-free random mask."""
    q = rng.integers(-127, 128, (K, N), dtype=np.int32)
    mask = (rng.random((K, N)) >= vs).astype(np.int32)
    q_fta, _ = jfta.fta_quantize(q, mask)
    return np.asarray(q_fta), mask


# ------------------------------------------------------------------ CSD ---

def test_csd_helpers_equal():
    vals = np.random.default_rng(0).integers(-128, 128, (7, 9),
                                             dtype=np.int32)
    for x in (DOMAIN, vals):
        ref = jcsd.csd_nonzero_count(x)
        np.testing.assert_array_equal(csd.csd_nonzero_count(x), ref)
        np.testing.assert_array_equal(csd.phi_lookup(x), jcsd.phi_lookup(x))
        t = torch.from_numpy(x)
        assert csd.phi_lookup(t).dtype == torch.int32
        np.testing.assert_array_equal(csd.phi_lookup(t).numpy(), ref)
        np.testing.assert_array_equal(csd.csd_nonzero_count(t).numpy(), ref)
    assert csd.verify_csd_properties() == jcsd.verify_csd_properties()
    assert csd.verify_csd_properties(vals) == \
        jcsd.verify_csd_properties(vals)
    assert csd.mean_nonzero_reduction() == jcsd.mean_nonzero_reduction()


# -------------------------------------------------------------- pruning ---

@pytest.mark.parametrize("alpha", [4, 8, 16])
@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.6, 0.95])
@pytest.mark.parametrize("K,N", [(256, 128), (96, 48), (7, 32)])
def test_block_prune_mask_byte_identical(K, N, sparsity, alpha):
    w = np.random.default_rng(K + N).laplace(0, 0.02, (K, N)).astype(
        np.float32)
    ref = np.asarray(jpruning.block_prune_mask(w, sparsity, alpha=alpha))
    got = pruning.block_prune_mask(torch.from_numpy(w), sparsity, alpha)
    assert got.dtype == torch.int32 and got.shape == (K, N)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the norms themselves, bit for bit (float32, numpy's pairwise order)
    np.testing.assert_array_equal(
        pruning.block_l2_norms(torch.from_numpy(w), alpha).numpy(),
        np.asarray(jpruning.block_l2_norms(w, alpha)))
    assert pruning.value_sparsity(got) == jpruning.value_sparsity(ref)


def test_block_prune_mask_stacked_and_ties():
    """A leading layer axis prunes each matrix on its own; equal norms are
    broken by position, as numpy's stable argsort breaks them."""
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1, (3, 64, 32)).astype(np.float32)
    w[1] = np.round(w[1])                        # many tied block norms
    ref = np.asarray(jpruning.block_prune_mask(w, 0.5, alpha=8))
    got = pruning.block_prune_mask(torch.from_numpy(w), 0.5, 8).numpy()
    np.testing.assert_array_equal(got, ref)


def test_mask_helpers_equal():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 1, (64, 32)).astype(np.float32)
    mask = np.asarray(jpruning.block_prune_mask(w, 0.5, alpha=8))
    tw, tm = torch.from_numpy(w), torch.from_numpy(mask)
    np.testing.assert_array_equal(pruning.apply_mask(tw, tm).numpy(),
                                  jpruning.apply_mask(w, mask))
    got = pruning.surviving_block_indices(tm, 8)
    ref = jpruning.surviving_block_indices(mask, 8)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), r)


# --------------------------------------------------------------- dyadic ---

@pytest.mark.parametrize("max_terms", [1, 2, 4])
def test_pack_terms_all_int8_values(max_terms):
    ref = jdyadic.pack_terms(DOMAIN, max_terms)
    got = dyadic.pack_terms(torch.from_numpy(DOMAIN), max_terms)
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(dyadic.pack_terms_numpy(DOMAIN, max_terms),
                                  ref)
    np.testing.assert_array_equal(dyadic.unpack_terms(got).numpy(),
                                  jdyadic.unpack_terms(ref))


def test_dyadic_round_trip_on_fta_weights():
    """FTA weights hold at most two Comp patterns: two terms unpack to the
    weights exactly, and the pack of a 2D tensor equals the reference."""
    q, _ = _fta_weights(np.random.default_rng(3), 64, 40)
    packed = dyadic.pack_terms(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), jdyadic.pack_terms(q))
    np.testing.assert_array_equal(dyadic.unpack_terms(packed).numpy(), q)


def test_block_classes_and_stats_equal():
    for x in (DOMAIN, np.random.default_rng(4).integers(-128, 128, (9, 5))):
        blk = dyadic.dyadic_blocks(torch.from_numpy(x))
        np.testing.assert_array_equal(blk.numpy(), jdyadic.dyadic_blocks(x))
        cls, ok = dyadic.classify_blocks(torch.from_numpy(x))
        jcls, jok = jdyadic.classify_blocks(x)
        np.testing.assert_array_equal(cls.numpy(), jcls)
        assert ok is jok is True
        assert dyadic.comp_pattern_stats(torch.from_numpy(x)) == \
            jdyadic.comp_pattern_stats(x)


# ----------------------------------------------------- quantize / pack ---

def test_quantize_int8_rounds_half_to_even():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (50, 40)).astype(np.float32)
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 200.0, -200.0, 0.0],
                        np.float32) * np.float32(0.01)
    for scale in (np.float32(0.01), np.float32(np.abs(x).max() / 127.0)):
        ref = np.asarray(jqat.quantize_int8(jnp.asarray(x),
                                            jnp.asarray(scale)))
        got = qat.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("vs", [0.0, 0.6])
@pytest.mark.parametrize("K,N", [(512, 128), (256, 96)])
def test_fta_pack_byte_identical(K, N, vs):
    rng = np.random.default_rng(K + N)
    w = rng.laplace(0, 0.02, (K, N)).astype(np.float32)
    mask = np.asarray(jpruning.block_prune_mask(w, vs, alpha=8))
    jq, jscale, jpacked, jphi = jops.fta_pack(jnp.asarray(w),
                                              jnp.asarray(mask))
    q, scale, packed, phi = ops.fta_pack(torch.from_numpy(w),
                                         torch.from_numpy(mask))
    assert q.dtype == torch.int8 and packed.dtype == torch.uint8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.dtype == torch.float32 and float(scale) == float(jscale)
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    np.testing.assert_array_equal(phi.numpy(), np.asarray(jphi))
    assert fta.achieved_bit_sparsity(q.to(torch.int32), mask) == \
        jfta.achieved_bit_sparsity(np.asarray(jq), mask)


# ------------------------------------------------------------ PIM model ---

def _layers(mod):
    return [mod.LayerGEMM("conv", M=196, K=576, N=128, kind="std"),
            mod.LayerGEMM("pw", M=49, K=256, N=512, kind="pw"),
            mod.LayerGEMM("dw", M=196, K=9, N=64, kind="dw"),
            mod.LayerGEMM("fc", M=64, K=512, N=200, kind="fc")]


def _report(r):
    return [(l.name, l.cycles, l.energy_pj, l.eff_cells, l.total_cells,
             l.macs) for l in r.layers] + [r.cycles, r.energy_pj, r.u_act,
                                            r.time_ms()]


@pytest.mark.parametrize("vs", [0.0, 0.5, 0.8])
def test_pim_model_reports_equal(vs):
    rng = np.random.default_rng(int(vs * 10))
    sps, jsps = {}, {}
    for layer in _layers(jpim):
        if layer.kind == "dw":
            continue
        q, _ = _fta_weights(rng, layer.K, layer.N)
        mask = np.asarray(jpruning.block_prune_mask(
            rng.normal(0, 1, (layer.K, layer.N)).astype(np.float32), vs,
            alpha=8))
        phi = np.asarray(jfta.compute_thresholds(q, mask))
        zf = jpim.input_zero_col_fraction(
            rng.integers(-127, 128, 1024, dtype=np.int32))
        assert pim_model.input_zero_col_fraction(
            rng.integers(-127, 128, 0, dtype=np.int32)) == 0.0
        jsps[layer.name] = jpim.sparsity_from_export(q * mask, mask, phi, zf)
        sps[layer.name] = pim_model.sparsity_from_export(q * mask, mask,
                                                         phi, zf)
        assert vars(sps[layer.name]) == vars(jsps[layer.name])
    for kw in ({}, dict(use_value=False), dict(use_weight_bit=False),
               dict(use_input_bit=False)):
        assert _report(pim_model.evaluate_model(_layers(pim_model), sps,
                                                **kw)) == \
            _report(jpim.evaluate_model(_layers(jpim), jsps, **kw))
    assert _report(pim_model.evaluate_dense_baseline(_layers(pim_model))) == \
        _report(jpim.evaluate_dense_baseline(_layers(jpim)))
    assert pim_model.PIMConfig() == pim_model.DEFAULT_PIM
    assert vars(pim_model.DEFAULT_PIM) == vars(jpim.DEFAULT_PIM)
