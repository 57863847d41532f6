"""The port's paper side against the JAX package on the CPU: the five
CIFAR-100 CNNs' layer tables, MODE_FLAGS and joint_bench_shapes; the
synthetic INT8 weights and activations; model_metadata (pruning and FTA
on the same numpy draws) and the cost model over it; the joint packs and
the plain joint product at the paper's layer shapes.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_paper.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import paper_cnns as jax_cnns
from repro.core import pim_model as jax_pm
from repro.core import workload_gen as jax_wg
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.configs import paper_cnns
from repro_torch.core import pim_model, workload_gen
from repro_torch.kernels import ops

pytestmark = pytest.mark.port

MODELS = list(jax_cnns.CNN_MODELS)
#: (model, value sparsity) of the metadata comparisons: every CNN at the
#: paper's 0.6, VGG19 also unpruned (Fig. 11's two points)
METADATA_CASES = [(m, 0.6) for m in MODELS] + [("vgg19", 0.0)]
ACCEL = ("std", "pw", "fc")
#: the draws of benchmarks/kernel_bench.py's joint cases
PACK_SEED, PACK_SPARSITY = 7, 0.5


def _fields(obj):
    return dataclasses.astuple(obj)


@pytest.mark.parametrize("model", MODELS)
def test_layer_tables_equal_the_references(model):
    want = jax_cnns.CNN_MODELS[model]()
    got = paper_cnns.CNN_MODELS[model]()
    assert [type(l) for l in got] == [pim_model.LayerGEMM] * len(got)
    assert [_fields(l) for l in got] == [_fields(l) for l in want]


@pytest.mark.parametrize("max_m", [128, 256])
def test_mode_flags_and_bench_shapes_equal_the_references(max_m):
    assert list(paper_cnns.CNN_MODELS) == MODELS
    assert paper_cnns.MODE_FLAGS == jax_cnns.MODE_FLAGS
    assert paper_cnns.joint_bench_shapes(max_m) == \
        jax_cnns.joint_bench_shapes(max_m)
    assert paper_cnns._round_up(129, 128) == jax_cnns._round_up(129, 128)


@pytest.mark.parametrize("model", MODELS)
def test_synthetic_draws_are_byte_identical(model):
    """One generator, the weight then the activation: the same bytes and
    the generator left in the same state."""
    base_q, dead = workload_gen.MODEL_WEIGHT_STATS[model]
    assert (base_q, dead) == jax_wg.MODEL_WEIGHT_STATS[model]
    out = []
    for mod in (jax_wg, workload_gen):
        rng = np.random.default_rng(5)
        q = mod.synth_quantized_weight(300, 88, base_q, rng, dead, 8)
        a = mod.synth_activation(40, 300, rng)
        out.append((q, a, rng.random()))
    (jq, ja, jn), (q, a, n) = out
    assert q.dtype == jq.dtype and q.tobytes() == jq.tobytes()
    assert a.dtype == ja.dtype and a.tobytes() == ja.tobytes()
    assert n == jn


@pytest.fixture(scope="module")
def metadata():
    """{(model, vs): (accelerated layers, JAX metadata, port metadata on
    the CPU)} of METADATA_CASES."""
    out = {}
    for model, vs in METADATA_CASES:
        layers = [l for l in paper_cnns.CNN_MODELS[model]()
                  if l.kind in ACCEL]
        jlayers = [l for l in jax_cnns.CNN_MODELS[model]() if l.kind in ACCEL]
        out[model, vs] = (
            layers, jax_wg.model_metadata(jlayers, vs, model, seed=0),
            workload_gen.model_metadata(layers, vs, model, seed=0,
                                        device="cpu"))
    return out


@pytest.mark.parametrize("model,vs", METADATA_CASES)
def test_model_metadata_equals_the_references(metadata, model, vs):
    _, want, got = metadata[model, vs]
    assert list(got) == list(want)
    for name in want:
        assert type(got[name]) is pim_model.LayerSparsity
        assert _fields(got[name]) == _fields(want[name]), name


@pytest.mark.parametrize("model,vs", METADATA_CASES)
def test_cost_model_over_the_metadata_equals_the_references(metadata,
                                                             model, vs):
    """The dense baseline and every MODE_FLAGS mode, and Fig. 11's joint
    setting without the input bit skip: cycles and energy equal."""
    layers, jmd, md = metadata[model, vs]
    jlayers = [jax_pm.LayerGEMM(*_fields(l)) for l in layers]
    pairs = [(pim_model.evaluate_dense_baseline(layers),
              jax_pm.evaluate_dense_baseline(jlayers))]
    flag_sets = list(paper_cnns.MODE_FLAGS.values()) + [
        dict(paper_cnns.MODE_FLAGS["joint"], use_input_bit=False)]
    for flags in flag_sets:
        pairs.append((pim_model.evaluate_model(layers, md, **flags),
                      jax_pm.evaluate_model(jlayers, jmd, **flags)))
    for got, want in pairs:
        assert got.cycles == want.cycles
        assert got.energy_pj == want.energy_pj
        assert got.u_act == want.u_act


def test_vgg19_lands_in_the_fig11_band(metadata):
    """The band tests/test_pim_model.py holds the reference to."""
    speedups = {}
    for vs in (0.0, 0.6):
        layers, _, md = metadata["vgg19", vs]
        dense = pim_model.evaluate_dense_baseline(layers)
        ours = pim_model.evaluate_model(layers, md, use_input_bit=False)
        speedups[vs] = (dense.cycles / ours.cycles,
                        1 - ours.energy_pj / dense.energy_pj)
    (sp75, es75), (sp90, es90) = speedups[0.0], speedups[0.6]
    assert 4.5 < sp75 < 6.5 and 7.0 < sp90 < 9.5
    assert 0.65 < es75 < 0.80 and 0.80 < es90 < 0.93


def _paper_packs():
    """(name, M, K, N, w, mask, JAX pack, port pack) at each of the six
    joint_bench_shapes(128), w and mask drawn as the kernel benchmark
    draws them."""
    rng = np.random.default_rng(PACK_SEED)
    for name, M, K, N in paper_cnns.joint_bench_shapes(max_m=128):
        w = rng.laplace(0, 0.02, (K, N)).astype(np.float32)
        mask = jax_ops.random_tile_mask(rng, K, N, PACK_SPARSITY)
        yield (name, M, K, N, w, mask, jax_ops.pack_joint_sparse(w, mask),
               ops.pack_joint_sparse(torch.from_numpy(w),
                                     torch.from_numpy(mask)))


def test_joint_packs_at_the_paper_shapes_are_byte_identical():
    names = []
    for name, _, K, N, _, _, want, got in _paper_packs():
        for field in ("w_blocks", "idx", "scales", "nblocks"):
            a, b = getattr(got, field).numpy(), np.asarray(getattr(want,
                                                                   field))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (name, field)
        assert (got.k, got.n, got.k_pad) == (want.k, want.n, want.k_pad)
        assert ops.joint_storage_bytes(got) == \
            jax_ops.joint_storage_bytes(want)
        names.append(name)
    assert len(names) == 6


def test_plain_joint_dense_matches_the_reference_at_a_paper_shape():
    """alexnet.c3 (3456 x 256, M = 128) in float32: the port's plain
    joint_dense against repro.kernels.ref.joint_packed_ref, within 1e-5
    of the output's peak."""
    name, M, K, _, _, _, want, got = next(_paper_packs())
    assert name == "alexnet.c3"
    x = np.random.default_rng(8).normal(0, 1, (M, K)).astype(np.float32)
    y = ops.joint_dense(torch.from_numpy(x), got)
    ref = np.asarray(jax_ref.joint_packed_ref(x, want))
    assert y.dtype == torch.float32 and y.shape == ref.shape
    err = np.abs(y.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err


def test_model_metadata_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    layers = paper_cnns.CNN_MODELS["vgg19"]()[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workload_gen.model_metadata(layers, 0.6, "vgg19")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workload_gen.layer_metadata(layers[0], 0.6, 5.0,
                                    np.random.default_rng(0))
