"""The port's SSM (mamba2) serving path against the JAX package's on
reduced fp32 mamba2: the SSD functions on the same numpy inputs, the
param tree, decode_step and decode_chunk in the exact and the parallel
mode (dense and joint tables; Pallas in interpret mode), the in-place
steps against the functional ones, the engine and the serve CLI, and the
weight bridge's float32 leaves.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_ssm.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_step
from repro_torch.models import (decode_chunk, decode_step, init_cache,
                                init_params, merge_slots, reset_slots)
from repro_torch.models import ssm
from repro_torch.models.transformer import _check_supported
from repro_torch.obs import RecompileSentinel
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                strip_packed_projections)
from repro_torch.weights import FLOAT32_KEYS, params_from_numpy

pytestmark = pytest.mark.port

ARCH = "mamba2-1.3b"
#: the (chunk, prompt length) cases of tests/test_parallel_prefill.py
CHUNK_CASES = [(1, 5), (4, 8), (8, 8), (4, 11)]


def _close(got, ref, what="", atol=None):
    """1e-4 * max(|ref|, 1) unless ``atol`` is given (fp32 on both sides,
    sums in another order)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    tol = atol if atol is not None else \
        1e-4 * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _cfgs(mode="joint", **kw):
    jcfg = jax_get_config(ARCH, reduced=True, dbpim_mode=mode).scaled(
        dtype="float32", dbpim_value_sparsity=0.5, **kw)
    cfg = get_config(ARCH, reduced=True, dbpim_mode=mode).scaled(
        dtype="float32", dbpim_value_sparsity=0.5, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    """JAX params of reduced fp32 mamba2, the same params in the port, and
    both packs of joint tables (32-wide tiles)."""
    jcfg, cfg = _cfgs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return (jcfg, jparams, jax_tables(jparams, jcfg, bk=32, bn=32), cfg,
            params, build_stacked_tables(params, cfg, bk=32, bn=32))


# ------------------------------------------------- the SSD functions ------

def _layer_inputs(cfg, B=3, C=5, seed=0):
    """One layer's params and the inputs of the serving functions, as
    numpy, with every float32 parameter away from its init value."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    d_in, nh, N, P = ssm.ssm_dims(cfg)
    ch = d_in + 2 * N
    f32 = np.float32
    p = {"in_proj": rng.standard_normal((d, 2 * d_in + 2 * N + nh)) * d ** -.5,
         "conv_w": rng.standard_normal((cfg.ssm_conv_width, ch)) * 0.2,
         "conv_b": rng.standard_normal(ch) * 0.1,
         "A_log": rng.standard_normal(nh) * 0.5,
         "D": 1 + 0.1 * rng.standard_normal(nh),
         "dt_bias": rng.standard_normal(nh) * 0.5,
         "norm_scale": 1 + 0.1 * rng.standard_normal(d_in),
         "out_proj": rng.standard_normal((d_in, d)) * d_in ** -.5}
    inputs = {"x": rng.standard_normal((B, C, d)),
              "conv": rng.standard_normal((B, cfg.ssm_conv_width - 1, ch)),
              "state": rng.standard_normal((B, nh, P, N)),
              "n_valid": np.array([C, 2, 0][:B], np.int32)}
    p = {k: v.astype(f32) for k, v in p.items()}
    inputs = {k: v if v.dtype == np.int32 else v.astype(f32)
              for k, v in inputs.items()}
    return p, inputs


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("fn", ["decode", "exact", "parallel"])
def test_serving_functions_match_jax(fn):
    """decode_ssm (one token), prefill_ssm and prefill_ssm_parallel (a
    5-token chunk with n_valid 5, 2 and 0) against the JAX functions:
    output, conv window and state."""
    jcfg, cfg = _cfgs()
    p, inputs = _layer_inputs(cfg)
    jp, tp = _both(p)
    ji, ti = _both(inputs)
    if fn == "decode":
        ref = jax_ssm.decode_ssm(jp, ji["x"][:, :1], ji["conv"], ji["state"],
                                 jcfg)
        got = ssm.decode_ssm(tp, ti["x"][:, :1], ti["conv"], ti["state"], cfg)
    else:
        jf = {"exact": jax_ssm.prefill_ssm,
              "parallel": jax_ssm.prefill_ssm_parallel}[fn]
        tf = {"exact": ssm.prefill_ssm,
              "parallel": ssm.prefill_ssm_parallel}[fn]
        ref = jf(jp, ji["x"], ji["conv"], ji["state"], ji["n_valid"], jcfg)
        got = tf(tp, ti["x"], ti["conv"], ti["state"], ti["n_valid"], cfg)
    for what, g, r in zip(("y", "conv", "state"), got, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32, what
        _close(g, r, f"{fn} {what}")
    if fn != "decode":
        # the idle slot's conv window and state come back exactly
        assert torch.equal(got[1][2], ti["conv"][2])
        assert torch.equal(got[2][2], ti["state"][2])


def test_ssd_chunk_matches_jax():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(4)
    B, Q, H, P, N = 2, 6, 3, 4, 5
    arrs = {"state": rng.standard_normal((B, H, P, N)),
            "xq": rng.standard_normal((B, Q, H, P)),
            "bq": rng.standard_normal((B, Q, N)),
            "cq": rng.standard_normal((B, Q, N)),
            "dtq": np.log1p(np.exp(rng.standard_normal((B, Q, H)))),
            "A": -np.exp(rng.standard_normal(H) * 0.5)}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    arrs["dtq"][1, 4:] = 0.0                # masked tokens: dt = 0
    j, t = _both(arrs)
    ref = jax_ssm._ssd_chunk(j["state"], j["xq"], j["bq"], j["cq"],
                             j["dtq"], j["A"])
    got = ssm._ssd_chunk(t["state"], t["xq"], t["bq"], t["cq"], t["dtq"],
                         t["A"])
    for what, g, r in zip(("state", "y"), got, ref):
        _close(g, r, what)


def test_gated_norm_is_rms_head_norm_of_the_gated_product():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(5)
    y, z = (rng.standard_normal((2, 3, 128)).astype(np.float32)
            for _ in range(2))
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    ref = jax_ssm._gated_norm(jnp.asarray(y), jnp.asarray(z),
                              jnp.asarray(scale))
    got = ssm._gated_norm(torch.from_numpy(y), torch.from_numpy(z),
                          torch.from_numpy(scale))
    _close(got, ref, "gated norm")
    assert ssm.PARALLEL_PREFILL_ATOL == jax_ssm.PARALLEL_PREFILL_ATOL


# ---------------------------------------------------------- the params ---

def _tree_spec(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict of arrays/tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_spec(v, f"{path}/{k}"))
        return out
    name = str(tree.dtype).replace("torch.", "")
    return {path: (tuple(tree.shape), name)}


def test_init_params_tree_matches_jax_reduced():
    """Tree, shapes and dtypes (bf16 config) against JAX init_params; A_log
    zeros, D ones, dt_bias zeros, norm_scale ones, conv_b zeros."""
    jcfg = jax_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    p = init_params(cfg, seed=0, device="cpu")
    assert _tree_spec(p) == _tree_spec(jp)
    s = p["blocks"]["ssm"]
    assert not s["A_log"].any() and not s["dt_bias"].any()
    assert not s["conv_b"].any()
    assert (s["D"] == 1).all() and (s["norm_scale"] == 1).all()
    # the scales: in_proj d^-1/2, conv_w 0.2, out_proj d_in^-1/2
    for name, scale in (("in_proj", cfg.d_model ** -0.5), ("conv_w", 0.2),
                        ("out_proj", (2 * cfg.d_model) ** -0.5)):
        std = s[name].float().std().item()
        assert 0.8 * scale < std < 1.2 * scale, (name, std, scale)


def test_init_params_tree_matches_jax_full_width():
    """mamba2-1.3b at full width: jax.eval_shape of JAX init_params against
    the port's init_params on the meta device (nothing allocated)."""
    jcfg = jax_get_config(ARCH, dbpim_mode="joint")
    cfg = get_config(ARCH, dbpim_mode="joint")
    jp = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                        jax.random.PRNGKey(0))
    p = init_params(cfg, device="meta")
    assert p["blocks"]["ssm"]["in_proj"].device.type == "meta"
    assert _tree_spec(p) == _tree_spec(jp)
    assert p["blocks"]["ssm"]["in_proj"].shape == (48, 2048, 8512)
    cache = init_cache(cfg, 4, 512, device="meta")
    jcache = jax.eval_shape(lambda: jax_init_cache(jcfg, 4, 512))
    assert _tree_spec(cache) == _tree_spec(jcache)


@pytest.mark.parametrize("mode,bk", [("joint", 32), ("joint", None),
                                     ("value", 32)])
def test_stacked_tables_byte_identical(mode, bk):
    """The stacked tables of ssm/in_proj (296 columns: a partial last N
    tile) and ssm/out_proj against the JAX pack, byte for byte."""
    jcfg, cfg = _cfgs(mode)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    jt = jax_tables(jparams, jcfg, bk=bk, bn=bk)
    t = build_stacked_tables(params, cfg, bk=bk, bn=bk)
    assert set(t.arrays) == set(jt.arrays) == {"in_proj", "out_proj"}
    assert t.static == jt.static
    for name in jt.arrays:
        for field in ("w_blocks", "idx", "scales", "nblocks"):
            mine = t.arrays[name][field]
            if mine.dtype == torch.bfloat16:
                mine = mine.view(torch.int16)
            ref = np.asarray(jt.arrays[name][field])
            if ref.dtype.name == "bfloat16":
                ref = ref.view(np.int16)
            np.testing.assert_array_equal(mine.numpy(), ref,
                                          err_msg=f"{name}/{field}")


# ------------------------------------------------ decode and the chunk ---

def _ssm_close(cache, jcache, what):
    for key in ("conv", "state"):
        _close(cache["ssm"][key], jcache["ssm"][key], f"{what} {key}")


@pytest.mark.parametrize("tables", ["dense", "joint"])
def test_decode_step_matches_jax(model, tables):
    """Three steps from a fresh cache (scalar pos), then a step at per-slot
    positions: logits, conv windows and states at tolerance every step."""
    jcfg, jparams, jt, cfg, params, t = model
    if tables == "dense":
        jt = t = None
    B = 3
    rng = np.random.default_rng(0)
    jcache = jax_init_cache(jcfg, B, 16)
    cache = init_cache(cfg, B, 16, device="cpu")
    for step in range(4):
        if step == 3:
            pos = np.array([3, 7, 5], np.int32)
            jcache["pos"] = jnp.asarray(pos)
            cache["pos"] = torch.from_numpy(pos)
        tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jax_decode_step(jparams, jcache, jnp.asarray(tok), jcfg,
                                     tables=jt)
        lg, cache = decode_step(params, cache, torch.from_numpy(tok), cfg,
                                tables=t)
        _close(lg, jl, f"logits step {step}")
        _ssm_close(cache, jcache, f"step {step}")
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


def _prompts(cfg, plen, B=3, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, plen)).astype(np.int32)


def _port_stepwise(cfg, params, t, prompts, max_len=16):
    B = prompts.shape[0]
    cache = init_cache(cfg, B, max_len, device="cpu")
    cache["pos"] = torch.zeros((B,), dtype=torch.int32)
    for i in range(prompts.shape[1]):
        lg, cache = decode_step(params, cache,
                                torch.from_numpy(prompts[:, i:i + 1]), cfg,
                                tables=t)
    return lg, cache


def _port_chunked(cfg, params, t, prompts, chunk, max_len=16):
    B, P = prompts.shape
    cache = init_cache(cfg, B, max_len, device="cpu")
    cache["pos"] = torch.zeros((B,), dtype=torch.int32)
    for s in range(0, P, chunk):
        n = min(chunk, P - s)
        toks = np.zeros((B, chunk), np.int32)
        toks[:, :n] = prompts[:, s:s + n]
        lg, cache = decode_chunk(params, cache, torch.from_numpy(toks),
                                 torch.full((B,), n, dtype=torch.int32), cfg,
                                 tables=t)
    return lg, cache


def _jax_chunked(jcfg, jparams, jt, prompts, chunk, max_len=16):
    from conftest import chunked_prefill
    return chunked_prefill(jparams, jcfg, prompts, max_len, chunk, tables=jt)


@pytest.mark.parametrize("exact", [False, True], ids=["parallel", "exact"])
@pytest.mark.parametrize("chunk,plen", CHUNK_CASES)
def test_chunk_matches_jax_and_port_stepwise(model, chunk, plen, exact):
    """decode_chunk (joint tables) against JAX decode_chunk in the same
    mode at tolerance, prompts ragged over the chunks. Inside the port:
    the parallel chunk within PARALLEL_PREFILL_ATOL["float32"] of stepwise
    decode (logits, conv windows, states); the exact chunk bitwise equal
    to it, since each token's projections run at the decode step's row
    count and every other op is per row."""
    jcfg, jparams, jt, cfg, params, t = model
    jcfg = jcfg.scaled(prefill_exact=exact)
    cfg = cfg.scaled(prefill_exact=exact)
    prompts = _prompts(cfg, plen)
    jl, jcache = _jax_chunked(jcfg, jparams, jt, prompts, chunk)
    cl, ccache = _port_chunked(cfg, params, t, prompts, chunk)
    _close(cl, jl, "port chunk vs JAX chunk")
    _ssm_close(ccache, jcache, "port chunk vs JAX chunk")
    np.testing.assert_array_equal(ccache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    sl, scache = _port_stepwise(cfg, params, t, prompts)
    if exact:
        assert torch.equal(cl, sl)
        for key in ("conv", "state"):
            assert torch.equal(ccache["ssm"][key], scache["ssm"][key]), key
    else:
        atol = ssm.PARALLEL_PREFILL_ATOL["float32"]
        _close(cl, sl.numpy(), "parallel vs stepwise", atol=atol)
        for key in ("conv", "state"):
            _close(ccache["ssm"][key], scache["ssm"][key].numpy(), key,
                   atol=atol)
    assert torch.equal(ccache["pos"], scache["pos"])


@pytest.mark.parametrize("exact", [False, True], ids=["parallel", "exact"])
def test_zero_valid_slot_exactly_untouched(model, exact):
    """A slot with n_valid = 0 keeps its conv window and state bit for bit
    (the parallel form zeroes dt: state * exp(0) + 0; the conv gather at
    cursor 0 returns the carried window)."""
    _, _, _, cfg, params, t = model
    cfg = cfg.scaled(prefill_exact=exact)
    prompts = _prompts(cfg, 4, B=2, seed=3)
    _, cache = _port_stepwise(cfg, params, t, prompts)
    toks = torch.zeros((2, 4), dtype=torch.int32)
    toks[0] = torch.from_numpy(prompts[0])
    _, new = decode_chunk(params, cache, toks,
                          torch.tensor([4, 0], dtype=torch.int32), cfg,
                          tables=t)
    assert new["pos"].tolist() == [8, 4]
    for key in ("conv", "state"):
        assert torch.equal(new["ssm"][key][:, 1], cache["ssm"][key][:, 1])
        assert not torch.equal(new["ssm"][key][:, 0], cache["ssm"][key][:, 0])


@pytest.mark.parametrize("exact", [False, True], ids=["parallel", "exact"])
def test_mixed_ragged_slots(model, exact):
    """Slots at different cursors in one chunk (the engine's steady state):
    slot 0 advances 4 then 2 tokens, slot 1 advances 3 then idles; each
    slot's state and logits match its own sequential decode at batch 1.
    The exact chunk is held to 1e-6 * max(|ref|, 1), not bitwise: PyTorch's
    CPU matmuls block their K-sums by the row count, so a row of the
    chunk's 2-row projections differs from the same row of a 1-row
    projection in the last bits (at equal batch the exact chunk is bitwise
    stepwise decode: test_chunk_matches_jax_and_port_stepwise)."""
    _, _, _, cfg, params, t = model
    cfg = cfg.scaled(prefill_exact=exact)
    rng = np.random.default_rng(4)
    p0 = rng.integers(1, cfg.vocab_size, (1, 6)).astype(np.int32)
    p1 = rng.integers(1, cfg.vocab_size, (1, 3)).astype(np.int32)
    cache = init_cache(cfg, 2, 16, device="cpu")
    cache["pos"] = torch.zeros((2,), dtype=torch.int32)
    toks = np.zeros((2, 4), np.int32)
    toks[0], toks[1, :3] = p0[0, :4], p1[0]
    lg1, cache = decode_chunk(params, cache, torch.from_numpy(toks),
                              torch.tensor([4, 3], dtype=torch.int32), cfg,
                              tables=t)
    toks = np.zeros((2, 4), np.int32)
    toks[0, :2] = p0[0, 4:]
    lg2, cache = decode_chunk(params, cache, torch.from_numpy(toks),
                              torch.tensor([2, 0], dtype=torch.int32), cfg,
                              tables=t)
    assert cache["pos"].tolist() == [6, 3]
    for slot, prompt, lg in ((0, p0, lg2), (1, p1, lg1)):
        sl, sc = _port_stepwise(cfg, params, t, prompt)
        refs = [sl[0]] + [sc["ssm"][key][:, 0] for key in ("conv", "state")]
        gots = [lg[slot]] + [cache["ssm"][key][:, slot]
                             for key in ("conv", "state")]
        for what, g, r in zip(("logits", "conv", "state"), gots, refs):
            atol = (1e-6 * max(r.abs().max().item(), 1.0) if exact
                    else ssm.PARALLEL_PREFILL_ATOL["float32"])
            _close(g, r.numpy(), f"slot {slot} {what}", atol=atol)


def test_merge_and_reset_slots_on_the_ssm_cache():
    """merge_slots / reset_slots select slots on axis 1 of the 4-D conv
    and the 5-D state leaves."""
    cfg = get_config(ARCH, reduced=True)
    old = init_cache(cfg, 3, 8, device="cpu")
    new = {"pos": torch.tensor(5, dtype=torch.int32),
           "ssm": {k: torch.ones_like(v) for k, v in old["ssm"].items()}}
    assert new["ssm"]["state"].ndim == 5
    keep = torch.tensor([True, False, True])
    m = merge_slots(new, old, keep, cfg)
    assert m["pos"].tolist() == [5, 0, 5]
    for key in ("conv", "state"):
        assert m["ssm"][key][:, 1].abs().sum() == 0
        assert (m["ssm"][key][:, 0] == 1).all()
        assert (m["ssm"][key][:, 2] == 1).all()
    r = reset_slots(m, torch.tensor([True, False, False]), cfg)
    assert r["pos"].tolist() == [0, 0, 5]
    for key in ("conv", "state"):
        assert r["ssm"][key][:, 0].abs().sum() == 0
        assert (r["ssm"][key][:, 2] == 1).all()


# ------------------------------------------------------ in-place steps ---

B, C = 4, 4
FILL = [[4, 2, 4, 0], [3, 4, 4, 1], [0, 1, 4, 2]]
ACTIVE = [[True, False, True, True], [False, True, False, True],
          [True, True, True, True], [False, False, True, False]]
N_VALID = [[4, 0, 2, 1], [1, 3, 0, 4], [0, 0, 0, 2]]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _assert_trees_equal(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{what}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), what


def _ssm_model(dtype, exact=False, device="cpu", reduced=True):
    """Port-initialised mamba2 in joint mode, stripped, with its tables."""
    cfg = get_config(ARCH, reduced=reduced, dbpim_mode="joint").scaled(
        dtype=dtype, dbpim_value_sparsity=0.5, prefill_exact=exact)
    params = init_params(cfg, seed=0, device=device)
    tables = build_stacked_tables(params, cfg, bk=32, bn=32)
    return cfg, strip_packed_projections(params, cfg), tables


def _filled(cfg, params, tables, device="cpu", seed=0, max_len=16):
    cache = init_cache(cfg, B, max_len, device=device)
    cache["pos"] = torch.zeros((B,), dtype=torch.int32, device=device)
    gen = torch.Generator().manual_seed(seed)
    for n in FILL:
        toks = torch.randint(1, cfg.vocab_size, (B, C), generator=gen,
                             dtype=torch.int32).to(device)
        _, cache = decode_chunk(params, cache, toks,
                                torch.tensor(n, dtype=torch.int32,
                                             device=device), cfg,
                                tables=tables)
    return cache


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def ssm_tiny(request):
    cfg, params, tables = _ssm_model(request.param)
    return cfg, params, tables, _filled(cfg, params, tables)


def test_inplace_decode_equals_functional(ssm_tiny):
    """decode_step + merge_slots against the engine's decode step (in
    place) over steps with mixed active slots: the active slots' logits
    and the whole cache (conv windows, states, positions) bitwise."""
    cfg, params, tables, filled = ssm_tiny
    step = build_step(cfg, "decode", stacked_tables=tables)
    cache_f, cache_i = _clone(filled), _clone(filled)
    gen = torch.Generator().manual_seed(1)
    for i, act in enumerate(ACTIVE):
        tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                            dtype=torch.int32)
        active = torch.tensor(act)
        lg_f, new = decode_step(params, cache_f, tok, cfg, tables=tables)
        cache_f = merge_slots(new, cache_f, active, cfg)
        lg_i, out = step(params, cache_i, tok, active)
        assert out is cache_i
        assert torch.equal(lg_i[active], lg_f[active]), i
        _assert_trees_equal(cache_i, cache_f, f"decode step {i}")


@pytest.mark.parametrize("exact", [False, True], ids=["parallel", "exact"])
def test_inplace_chunk_equals_functional(ssm_tiny, exact):
    """decode_chunk against the engine's prefill-chunk step (in place),
    ragged n_valid with 0 included: logits and cache bitwise."""
    cfg, params, tables, filled = ssm_tiny
    cfg = cfg.scaled(prefill_exact=exact)
    step = build_step(cfg, "prefill_chunk", stacked_tables=tables)
    cache_f, cache_i = _clone(filled), _clone(filled)
    gen = torch.Generator().manual_seed(2)
    for i, n in enumerate(N_VALID):
        toks = torch.randint(1, cfg.vocab_size, (B, C), generator=gen,
                             dtype=torch.int32)
        n_valid = torch.tensor(n, dtype=torch.int32)
        lg_f, cache_f = decode_chunk(params, cache_f, toks, n_valid, cfg,
                                     tables=tables)
        lg_i, out = step(params, cache_i, toks, n_valid)
        assert out is cache_i
        assert torch.equal(lg_i, lg_f), i
        _assert_trees_equal(cache_i, cache_f, f"chunk call {i}")


def test_inplace_reset_equals_functional(ssm_tiny):
    cfg, params, tables, filled = ssm_tiny
    step = build_step(cfg, "reset")
    for mask in ([True, False, True, False], [False] * B, [True] * B):
        cache_i = _clone(filled)
        m = torch.tensor(mask)
        want = reset_slots(_clone(filled), m, cfg)
        assert step(cache_i, m) is cache_i
        _assert_trees_equal(cache_i, want, f"reset {mask}")


@pytest.mark.parametrize("arch,exact,kind", [
    (ARCH, False, "prefill_parallel"), (ARCH, True, "prefill_chunk_exact"),
    ("tinyllama-1.1b", False, "prefill_chunk_exact")])
def test_prefill_step_tag_follows_the_mode(arch, exact, kind):
    cfg = get_config(arch, reduced=True, prefill_exact=exact)
    assert build_step(cfg, "prefill_chunk").call_kind == kind
    assert build_step(cfg, "decode").call_kind == "decode"


# ---------------------------------------------------------- the engine ---

def _jax_stepwise_serve(jcfg, jparams, jt, trace, max_len):
    """Every request through JAX stepwise decode, one batch row each: the
    greedy streams and the logits row of each request's first token."""
    step = jax.jit(lambda p, c, tok: jax_decode_step(p, c, tok, jcfg,
                                                     tables=jt))
    n = len(trace)
    cache = jax_init_cache(jcfg, n, max_len)
    cache["pos"] = jnp.zeros((n,), jnp.int32)
    streams, first = [[] for _ in trace], {}
    for t in range(max(r.prompt_len + r.gen_len - 1 for r in trace)):
        tok = np.zeros((n, 1), np.int32)
        for i, r in enumerate(trace):
            tok[i, 0] = (r.prompt[t] if t < r.prompt_len
                         else streams[i][-1] if streams[i] else 0)
        lg, cache = step(jparams, cache, jnp.asarray(tok))
        lg = np.asarray(lg[:, 0, :], np.float32)
        for i, r in enumerate(trace):
            if t == r.prompt_len - 1:
                first[r.rid] = lg[i]
            if r.prompt_len - 1 <= t and len(streams[i]) < r.gen_len:
                streams[i].append(int(lg[i].argmax()))
    return {r.rid: streams[i] for i, r in enumerate(trace)}, first


@pytest.fixture(scope="module")
def served(model):
    jcfg, jparams, jt, cfg, params, t = model
    trace = make_trace(WorkloadSpec(n_requests=5, arrival_rate=1.0,
                                    prompt_len=(2, 11), gen_len=(2, 5),
                                    seed=11), cfg.vocab_size)
    ref = _jax_stepwise_serve(jcfg, jparams, jt, trace, 20)
    engines = {}
    for exact in (True, False):
        engine = ServeEngine(cfg.scaled(prefill_exact=exact),
                             strip_packed_projections(params, cfg),
                             n_slots=2, max_len=20, prefill_chunk=4,
                             stacked_tables=t, device="cpu")
        engines[exact] = (engine, engine.run(trace))
    return trace, ref, engines


def test_exact_engine_streams_equal_jax_stepwise(served):
    """The CPU engine with prefill_exact: every greedy stream equals JAX
    stepwise decode's, one compiled signature per step."""
    trace, (streams, first), engines = served
    engine, outputs = engines[True]
    assert outputs == streams
    assert engine.prefill_kind == "prefill_chunk_exact"
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(kind, engine.cfg.name): 1
        for kind in ("decode", "prefill_chunk_exact", "reset")}
    for r in trace:
        _close(engine.first_logits[r.rid][0], first[r.rid], f"rid {r.rid}")


def test_parallel_engine_first_logits_match_jax_stepwise(served):
    """The default (parallel SSD) engine: first-token logits within
    PARALLEL_PREFILL_ATOL["float32"] of JAX stepwise decode, every request
    served to its length, the sentinel keyed by the step's tag."""
    trace, (streams, first), engines = served
    engine, outputs = engines[False]
    assert engine.prefill_kind == "prefill_parallel"
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(kind, engine.cfg.name): 1
        for kind in ("decode", "prefill_parallel", "reset")}
    s = engine.metrics.summary()
    assert s["n_completed"] == len(trace)
    assert set(s["calls_by_kind"]) == {"decode", "prefill_parallel"}
    for r in trace:
        assert len(outputs[r.rid]) == r.gen_len
        _close(engine.first_logits[r.rid][0], first[r.rid], f"rid {r.rid}",
               atol=ssm.PARALLEL_PREFILL_ATOL["float32"])
        assert outputs[r.rid][0] == streams[r.rid][0]


@pytest.mark.parametrize("exact", [False, True], ids=["parallel", "exact"])
def test_serve_cli_runs_mamba2_on_cpu(capsys, exact):
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--reduced", "--dbpim-mode", "joint",
            "--device", "cpu", "--requests", "3", "--max-len", "24",
            "--gen-len", "3", "--prompt-len", "2", "9",
            "--prefill-chunk", "4"]
    out = serve.main(argv + (["--prefill-exact"] if exact else []))
    assert len(out) == 3 and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    kind = "prefill_chunk_exact" if exact else "prefill_parallel"
    assert "3/3 requests" in text
    assert f"latency {kind}:" in text and f"{kind}@mamba2-smoke=1" in text


# --------------------------------------------------- what is refused ------

@pytest.mark.parametrize("arch,kw", [
    ("mixtral-8x7b", {"frontend": "vision_stub"}),
    ("jamba-v0.1-52b", {"frontend": "vision_stub"}),
    ("whisper-base", {"frontend": "vision_stub"}),
    ("tinyllama-1.1b", {"frontend": "vision_stub", "mlp_type": "gelu"})])
def test_check_supported_still_refuses(arch, kw):
    """The vision frontend (pixtral's stub) is served on any stack under it
    since the full-sequence forward's slice (hybrid stacks, enc-dec and
    plain gelu MLPs since the hybrid and enc-dec slice); what is still
    refused is a frontend no config has."""
    cfg = get_config(arch, reduced=True).scaled(**kw)
    assert _check_supported(cfg) == cfg.serving_capabilities().segments
    with pytest.raises(ValueError, match="frontend"):
        _check_supported(cfg.scaled(frontend="video_stub"))


# ---------------------------------------------------- the weight bridge ---

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", ARCH, "qwen3-8b",
                                  "stablelm-1.6b", "mixtral-8x7b"])
def test_weight_bridge_keeps_float32_leaves(arch):
    """A float32-config JAX tree through params_from_numpy(dtype=bf16):
    every leaf takes the dtype the JAX init gives it under a bf16 config
    (norm scales and biases, stacked (L, d) ones included, qk-norms, the
    router, A_log, D, dt_bias and norm_scale stay float32, bit for bit;
    the rest is recast), and a bf16-config tree keeps every dtype."""
    jcfg = jax_get_config(arch, reduced=True)
    j32 = jax_init_params(jcfg.scaled(dtype="float32"), jax.random.PRNGKey(0))
    j16 = jax.eval_shape(lambda k: jax_init_params(jcfg, k),
                         jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, j32)
    got = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert _tree_spec(got) == _tree_spec(j16)
    kept = 0

    def walk(t, src, key=None):
        nonlocal kept
        if isinstance(t, dict):
            for k in t:
                walk(t[k], src[k], k)
            return
        if key in FLOAT32_KEYS:
            kept += 1
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), src)
        else:
            assert t.dtype == torch.bfloat16, key
            assert torch.equal(t, torch.from_numpy(np.array(src))
                               .to(torch.bfloat16))

    walk(got, tree)
    assert kept >= 2 * (1 + (arch == ARCH))
    bf = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0))),
        device="cpu", dtype=torch.bfloat16)
    assert _tree_spec(bf) == _tree_spec(j16)
