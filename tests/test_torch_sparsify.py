"""The port's DB-PIM compression leftovers against the JAX package's:
``sparsify_params`` (artifacts and report), ``dequant_tree``,
``pim_speedup_estimate``, the serving INT8 format
(``quantize_params_for_serving`` / ``dequant_params_for_serving``) and
the lock-step "serve" step that reads it, on the same numpy params of
reduced configs: integers and float32 scales equal, bf16 reconstructions
bit for bit through their 16-bit view, the cost model's dict equal.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_sparsify.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import build_step as jax_build_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.sparsity import sparse_linear as jsl
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_step
from repro_torch.models import init_cache
from repro_torch.sparsity import (ELIGIBLE, DBPIMCompressed,
                                  dequant_params_for_serving, dequant_tree,
                                  pim_speedup_estimate,
                                  quantize_params_for_serving,
                                  sparsify_params)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

#: a dense stack, MoE expert stacks (rank 4) and SSM projections
ARCHS = ["tinyllama-1.1b", "mixtral-8x7b", "mamba2-1.3b"]


def _bits(t):
    """A tensor or array as comparable integers: bf16 through its 16-bit
    view, float32 through its 32-bit one."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        if t.dtype == torch.float32:
            return t.view(torch.int32).numpy()
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("bfloat16", "float32")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    arch, dtype = request.param
    jcfg = jax_get_config(arch, reduced=True).scaled(dtype=dtype)
    cfg = get_config(arch, reduced=True).scaled(dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def compressed(case):
    jcfg, cfg, jparams, params = case
    return jsl.sparsify_params(jparams, jcfg), sparsify_params(params, cfg)


def test_eligible_pattern_is_the_references():
    assert ELIGIBLE.pattern == jsl.ELIGIBLE.pattern


def test_sparsify_params_equals_reference(case, compressed):
    theirs, mine = compressed
    assert isinstance(mine, DBPIMCompressed)
    assert list(mine.tensors) == list(theirs.tensors)
    assert mine.tensors
    for key, t in theirs.tensors.items():
        m = mine.tensors[key]
        for part in ("q", "mask"):
            assert m[part].dtype == torch.int8, (key, part)
            np.testing.assert_array_equal(m[part].numpy(), t[part],
                                          err_msg=f"{key}/{part}")
        np.testing.assert_array_equal(_bits(m["scale"]), _bits(t["scale"]),
                                      err_msg=f"{key}/scale")
        assert m["pad"] == t["pad"], key
        assert m["orig_shape"] == tuple(t["orig_shape"]), key
        assert m["dtype"] == t["dtype"], key
    assert mine.report == theirs.report


def test_dequant_tree_is_bitwise_the_references(case, compressed):
    _, _, jparams, params = case
    theirs, mine = compressed
    ref = dict(_leaves(jsl.dequant_tree(jparams, theirs)))
    out = dict(_leaves(dequant_tree(params, mine)))
    orig = dict(_leaves(params))
    assert set(out) == set(ref) == set(orig)
    for key in ref:
        assert out[key].dtype == orig[key].dtype, key
        np.testing.assert_array_equal(_bits(out[key]), _bits(ref[key]),
                                      err_msg=key)


def test_pim_speedup_estimate_equals_reference(case, compressed):
    jcfg, cfg, _, _ = case
    theirs, mine = compressed
    for tokens in (1, 64):
        got = pim_speedup_estimate(mine, cfg, tokens=tokens)
        assert got == jsl.pim_speedup_estimate(theirs, jcfg, tokens=tokens)
        assert got["speedup"] > 1 and got["n_projections"] == \
            len(mine.tensors)


def test_serving_quantization_is_bitwise_the_references(case):
    _, _, jparams, params = case
    jq = jsl.quantize_params_for_serving(jparams)
    q = quantize_params_for_serving(params)
    ref = dict(_leaves(jq))
    out = dict(_leaves(q))
    assert set(out) == set(ref)
    assert any(k.endswith("/q") for k in out)
    for key in ref:
        np.testing.assert_array_equal(_bits(out[key]), _bits(ref[key]),
                                      err_msg=key)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        ref = dict(_leaves(jsl.dequant_params_for_serving(jq, jdtype)))
        out = dict(_leaves(dequant_params_for_serving(q, dtype)))
        assert set(out) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(_bits(out[key]), _bits(ref[key]),
                                          err_msg=f"{key} {dtype}")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b"])
def test_int8_serve_step(arch):
    """Eight lock-step decode steps of the int8 "serve" step: its logits
    are bitwise those of the dense step over the dequantized params, and
    within 1e-5 of the peak of the reference's int8 step's logits
    (float32)."""
    jcfg = jax_get_config(arch, reduced=True).scaled(dtype="float32")
    cfg = get_config(arch, reduced=True).scaled(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    qparams = quantize_params_for_serving(params)
    int8 = build_step(cfg, "serve", int8_weights=True)
    dense = build_step(cfg, "serve")
    deq = dequant_params_for_serving(qparams)
    jstep, _ = jax_build_step(jcfg, make_test_mesh(), "serve",
                              int8_weights=True)
    jstep = jax.jit(jstep)
    jq = jsl.quantize_params_for_serving(jparams)
    B = 3
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, B, 1))
    c_int8 = c_dense = init_cache(cfg, B, 16, device="cpu")
    jcache = jax_init_cache(jcfg, B, 16)
    for t in range(8):
        tok = torch.from_numpy(toks[t].astype(np.int32))
        a, c_int8 = int8(qparams, c_int8, tok)
        b, c_dense = dense(deq, c_dense, tok)
        assert torch.equal(a, b), t
        ja, jcache = jstep(jq, jcache, jnp.asarray(toks[t], jnp.int32))
        ja = np.asarray(ja)
        assert np.abs(a.numpy() - ja).max() <= 1e-5 * np.abs(ja).max(), t
