"""The port's hybrid family (jamba: interleaved SSM, attention, MLP and MoE
segments) against the JAX package on reduced fp32 jamba: the layout and
launch counts, the param tree, the per-segment stacked tables (16-expert
groups and partial last N tiles) and what strip_packed_projections
strips, apply_moe at 16 experts, the SSM functions at jamba's dims,
decode_step and decode_chunk (exact and parallel) with every cache leaf,
the in-place steps, the engine (refilled slots against fresh slots, and
its streams against JAX stepwise decode) and the serve CLI. Card tests
hold the kernels at jamba's full-width shapes against their plain
versions and skip without a card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_hybrid.py
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
from repro.models import moe as jax_moe
from repro.models import ssm as jax_ssm
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro.sparsity.sparse_linear import \
    strip_packed_projections as jax_strip
from repro_torch.configs import get_config
from repro_torch.models import (decode_chunk, decode_chunk_, decode_step,
                                decode_step_, init_cache, init_params,
                                merge_slots, reset_slots, reset_slots_)
from repro_torch.models import moe, ssm
from repro_torch.models.segments import decoder_layout
from repro_torch.models.transformer import layer_slice
from repro_torch.obs import RecompileSentinel, per_call
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                init_stacked_serving,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

ARCH = "jamba-v0.1-52b"
FIELDS = ("w_blocks", "idx", "scales", "nblocks")
#: (chunk, prompt length): one-token chunks, whole chunks, ragged tails
CHUNK_CASES = [(1, 3), (4, 8), (4, 11)]


def _close(got, ref, what="", atol=None):
    """1e-4 * max(|ref|, 1) unless ``atol`` is given: fp32 on both sides,
    sums in another order."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    tol = atol if atol is not None else \
        1e-4 * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _ints(a):
    """A tensor or array as numpy, bf16 as its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _flat(tree, path=""):
    """{'/'-joined path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _spec(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items()}


def _cache_close(cache, jcache, what="", atol=None):
    """Every leaf of the port's cache against the JAX cache's, same paths."""
    mine, ref = _flat(cache), _flat(jcache)
    assert set(mine) == set(ref), (set(mine) ^ set(ref))
    for path, leaf in ref.items():
        if path.endswith("pos"):
            np.testing.assert_array_equal(mine[path].numpy(),
                                          np.asarray(leaf))
        else:
            _close(mine[path], leaf, f"{what} {path}", atol)


def _cfgs(mode="joint", **kw):
    jcfg = jax_get_config(ARCH, reduced=True, dbpim_mode=mode).scaled(
        dtype="float32", dbpim_value_sparsity=0.5, **kw)
    cfg = get_config(ARCH, reduced=True, dbpim_mode=mode).scaled(
        dtype="float32", dbpim_value_sparsity=0.5, **kw)
    return jcfg, cfg


def _to_port(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def model():
    """JAX params of reduced fp32 jamba, the same params in the port, and
    both packs of joint tables (32-wide tiles)."""
    jcfg, cfg = _cfgs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = _to_port(jparams)
    return (jcfg, jparams, jax_tables(jparams, jcfg, bk=32, bn=32), cfg,
            params, build_stacked_tables(params, cfg, bk=32, bn=32))


# ------------------------------------------------ layout and launches ---

def test_layout_and_launches_per_call():
    """Full-width jamba: 32 segments of one layer, seg00..seg31, one
    attention layer per 8-layer period (index 4) and MoE on every odd
    layer; a decode call launches 888 joint (16 x 16 x 3 experts, 16 x 3
    dense MLP, 28 x 2 SSM, 4 x 4 attention), 4 row_attention and 93
    row_norm kernels; an exact chunk of 16 tokens walks its SSM
    projections and gated norms once per token."""
    cfg = get_config(ARCH)
    segs = decoder_layout(cfg)
    assert [s.name for s in segs] == [f"seg{i:02d}" for i in range(32)]
    assert all(s.length == 1 and s.cache == s.name for s in segs)
    assert [i for i, s in enumerate(segs) if s.mixer == "attn"] == \
        [4, 12, 20, 28]
    assert [i for i, s in enumerate(segs) if s.ffn == "moe"] == \
        list(range(1, 32, 2))
    assert per_call(cfg) == {"joint_sparse_matmul": 888,
                             "row_attention": 4, "row_norm": 93}
    assert per_call(cfg, token_steps=16) == {
        "joint_sparse_matmul": 888 + 28 * 2 * 15, "row_attention": 4,
        "row_norm": 93 + 28 * 15}
    caps = cfg.serving_capabilities()
    assert caps.chunked_prefill and caps.parallel_prefill


def test_param_tree_matches_jax():
    """The port's jamba tree equals JAX init_params' in paths, shapes and
    dtypes: reduced (bf16 config, on the CPU) and at full width (the meta
    device against eval_shape)."""
    jcfg, cfg = jax_get_config(ARCH, reduced=True), get_config(ARCH,
                                                               reduced=True)
    assert _spec(init_params(cfg, device="cpu")) == \
        _spec(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    full = jax.eval_shape(lambda k: jax_init_params(jax_get_config(ARCH), k),
                          jax.random.PRNGKey(0))
    assert _spec(init_params(get_config(ARCH), device="meta")) == \
        _spec(full)


# ---------------------------------------------------------- the packs ---

@pytest.mark.parametrize("bk", [None, 32], ids=["default_tiles", "tiles32"])
@pytest.mark.parametrize("n_experts", [4, 16])
def test_stacked_tables_byte_identical_and_strip(n_experts, bk):
    """Every segment's tables against the JAX package's byte for byte:
    the grouped expert packs (4 and 16 experts), the dense MLP, the
    attention and the SSM projections, whose in_proj (64 x 296) ends in a
    partial N tile; strip_packed_projections strips exactly the paths the
    JAX function strips."""
    jcfg, cfg = _cfgs(n_experts=n_experts)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = _to_port(jparams)
    jt = jax_tables(jparams, jcfg, bk=bk, bn=bk)
    t = build_stacked_tables(params, cfg, bk=bk, bn=bk)
    assert set(t.segments) == set(jt.segments) == {
        s.name for s in decoder_layout(cfg)}
    assert t.static == jt.static
    k, n, _ = t.static["seg00/in_proj"]
    bn = t.arrays["seg00/in_proj"]["w_blocks"].shape[-1]
    assert (k, n) == (64, 296) and n % bn, (n, bn)
    assert t.arrays["seg01/moe/w_gate"]["w_blocks"].shape[1] == n_experts
    for name, ref in jt.arrays.items():
        for field in FIELDS:
            np.testing.assert_array_equal(_ints(t.arrays[name][field]),
                                          _ints(ref[field]),
                                          err_msg=f"{name} {field}")
    mine = _spec(strip_packed_projections(params, cfg))
    assert mine == _spec(jax_strip(jparams, jcfg))
    assert mine["/seg01/moe/w_up"] == ((1, 1, 1), "float32")
    assert mine["/seg01/moe/router"] == ((1, 64, n_experts), "float32")


@pytest.mark.parametrize("mode", ["joint", "dense"])
def test_slice_by_slice_build_equals_whole_stack_build(mode):
    """init_stacked_serving over reduced jamba's segments (expert slices
    packed as drawn) equals strip_packed_projections / build_stacked_tables
    of the whole init_params tree, byte for byte ("dense": the tree
    itself, no tables)."""
    cfg = get_config(ARCH, reduced=True, dbpim_mode=mode)
    params = init_params(cfg, seed=3, device="cpu")
    tables = build_stacked_tables(params, cfg)
    stripped = (params if tables is None
                else strip_packed_projections(params, cfg))
    sliced, sliced_tables = init_stacked_serving(cfg, seed=3, device="cpu")
    a, b = _flat(stripped), _flat(sliced)
    assert set(a) == set(b)
    for path in a:
        assert a[path].dtype == b[path].dtype and \
            torch.equal(a[path], b[path]), path
    if mode == "dense":
        assert tables is None and sliced_tables is None
        return
    assert tables.static == sliced_tables.static
    for name, arr in tables.arrays.items():
        for field in FIELDS:
            assert torch.equal(arr[field], sliced_tables.arrays[name][field]), \
                (name, field)


# ------------------------------------------------ MoE and SSM layers ---

#: (per_position, B, S): the three groupings of apply_moe
GROUPINGS = {"per_position": (True, 4, 5), "per_sequence": (False, 2, 64),
             "flat": (False, 4, 1)}


@pytest.mark.parametrize("hook", [False, True], ids=["plain", "expert_hook"])
@pytest.mark.parametrize("grouping", list(GROUPINGS))
def test_apply_moe_at_16_experts_matches_jax(grouping, hook):
    """jamba's MoE widened to its full 16 experts (top-2, no dense
    residual) against the JAX function in all three groupings, plain and
    through the expert hook: the output and aux within 1e-4 * max(|ref|,
    1); capacity at batch 4 is 8 (every expert runs every step)."""
    jcfg, cfg = _cfgs(n_experts=16)
    assert moe.capacity(get_config(ARCH), 4) == 8 == \
        jax_moe.capacity(jax_get_config(ARCH), 4)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(2))
    params = _to_port(jparams)
    per_position, B, S = GROUPINGS[grouping]
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["seg01"]["moe"])
    p = layer_slice(params["seg01"]["moe"], 0)
    jfn = fn = None
    if hook:
        jt = jax_tables(jparams, jcfg, bk=32, bn=32).segments["seg01"]
        t = build_stacked_tables(params, cfg, bk=32,
                                 bn=32).segments["seg01"]
        jfn = jt.dense_fn(jax.tree_util.tree_map(lambda a: a[0], jt.arrays))
        fn = t.dense_fn(layer_slice(t.arrays, 0))
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((B, S, cfg.d_model))
         + 2 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    ref, jaux = jax_moe.apply_moe_block(jp, jnp.asarray(x), jcfg,
                                        dense_fn=jfn,
                                        per_position=per_position)
    got, aux = moe.apply_moe_block(p, torch.from_numpy(x), cfg, dense_fn=fn,
                                   per_position=per_position)
    _close(got, ref, "moe output")
    for key in ("load_balance", "dropped_frac"):
        _close(aux[key], jaux[key], key)


@pytest.mark.parametrize("fn", ["decode", "exact", "parallel"])
def test_ssm_functions_match_jax_at_jamba_dims(fn):
    """decode_ssm, prefill_ssm and prefill_ssm_parallel against the JAX
    functions at jamba's SSM shape (N = 16, P = 64, expand 2; 8 heads at
    d = 256): y, conv window and state within 1e-4 * max(|ref|, 1)."""
    jcfg = jax_get_config(ARCH).scaled(d_model=256, dtype="float32")
    cfg = get_config(ARCH).scaled(d_model=256, dtype="float32")
    d_in, nh, N, P = ssm.ssm_dims(cfg)
    assert (N, P, nh) == (16, 64, 8)
    rng = np.random.default_rng(5)
    B, C, d, ch = 3, 5, cfg.d_model, d_in + 2 * N
    p = {"in_proj": rng.standard_normal((d, 2 * d_in + 2 * N + nh)) * d ** -.5,
         "conv_w": rng.standard_normal((cfg.ssm_conv_width, ch)) * 0.2,
         "conv_b": rng.standard_normal(ch) * 0.1,
         "A_log": rng.standard_normal(nh) * 0.5,
         "D": 1 + 0.1 * rng.standard_normal(nh),
         "dt_bias": rng.standard_normal(nh) * 0.5,
         "norm_scale": 1 + 0.1 * rng.standard_normal(d_in),
         "out_proj": rng.standard_normal((d_in, d)) * d_in ** -.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    conv = rng.standard_normal((B, cfg.ssm_conv_width - 1, ch)).astype(
        np.float32)
    state = rng.standard_normal((B, nh, P, N)).astype(np.float32)
    n_valid = np.array([C, 2, 0], np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if fn == "decode":
        x = rng.standard_normal((B, 1, d)).astype(np.float32)
        ref = jax_ssm.decode_ssm(jp, jnp.asarray(x), jnp.asarray(conv),
                                 jnp.asarray(state), jcfg)
        got = ssm.decode_ssm(tp, torch.from_numpy(x), torch.from_numpy(conv),
                             torch.from_numpy(state), cfg)
    else:
        x = rng.standard_normal((B, C, d)).astype(np.float32)
        jf, tf = ((jax_ssm.prefill_ssm, ssm.prefill_ssm) if fn == "exact"
                  else (jax_ssm.prefill_ssm_parallel,
                        ssm.prefill_ssm_parallel))
        ref = jf(jp, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(state),
                 jnp.asarray(n_valid), jcfg)
        got = tf(tp, torch.from_numpy(x), torch.from_numpy(conv),
                 torch.from_numpy(state), torch.from_numpy(n_valid), cfg)
    for what, g, r in zip(("y", "conv", "state"), got, ref):
        _close(g, r, what)


# ------------------------------------------------------ decode, chunks ---

@pytest.mark.parametrize("tables", ["dense", "joint"])
def test_decode_step_matches_jax(model, tables):
    """Three steps from a fresh cache (scalar pos), then a step at per-slot
    positions: the logits and every leaf of the seg00..seg03 caches (k/v
    rows, conv windows, states) and "pos" at tolerance every step."""
    jcfg, jparams, jt, cfg, params, t = model
    if tables == "dense":
        jt = t = None
    B = 3
    rng = np.random.default_rng(0)
    jcache = jax_init_cache(jcfg, B, 16)
    cache = init_cache(cfg, B, 16, device="cpu")
    assert set(cache) == set(jcache) == {"pos", "seg00", "seg01", "seg02",
                                         "seg03"}
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
        _cache_close(cache, jcache, f"step {step}")


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


@pytest.mark.parametrize("exact", [False, True], ids=["parallel", "exact"])
@pytest.mark.parametrize("chunk,plen", CHUNK_CASES)
def test_chunk_matches_jax_and_port_stepwise(model, chunk, plen, exact):
    """decode_chunk (joint tables) through all four segments against JAX
    decode_chunk in the same mode: logits and every cache leaf within
    1e-4 * max(|ref|, 1). The exact chunk is the port's own stepwise
    decode within 1e-6 * max(|ref|, 1) on the CPU (bitwise for one-token
    chunks); the parallel chunk lands within the reference's
    PARALLEL_PREFILL_ATOL["float32"] of the JAX parallel chunk."""
    from conftest import chunked_prefill
    jcfg, jparams, jt, cfg, params, t = model
    jcfg = jcfg.scaled(prefill_exact=exact)
    cfg = cfg.scaled(prefill_exact=exact)
    prompts = _prompts(cfg, plen)
    jl, jcache = chunked_prefill(jparams, jcfg, prompts, 16, chunk,
                                 tables=jt)
    cl, ccache = _port_chunked(cfg, params, t, prompts, chunk)
    _close(cl, jl, "port chunk vs JAX chunk")
    _cache_close(ccache, jcache, "port chunk vs JAX chunk")
    if exact:
        # PyTorch's CPU matmuls block their K-sums by the row count, so the
        # chunk's attention and MLP projections (B x C rows) part from the
        # steps' (B rows) in the last bits (ROADMAP Queue 3 item 4); one-
        # token chunks are bitwise, and the card holds every chunk so
        sl, scache = _port_stepwise(cfg, params, t, prompts)
        if chunk == 1:
            assert torch.equal(cl, sl)
        _close(cl, sl.numpy(), "exact chunk vs stepwise",
               atol=1e-6 * max(sl.abs().max().item(), 1.0))
        for path, leaf in _flat(scache).items():
            got = _flat(ccache)[path]
            if chunk == 1 or path.endswith("pos"):
                assert torch.equal(got, leaf), path
            else:
                _close(got, leaf.numpy(), path,
                       atol=1e-6 * max(leaf.abs().max().item(), 1.0))
    else:
        atol = ssm.PARALLEL_PREFILL_ATOL["float32"]
        assert atol == jax_ssm.PARALLEL_PREFILL_ATOL["float32"]
        _close(cl, jl, "parallel chunk vs JAX parallel chunk", atol=atol)


@pytest.mark.parametrize("exact", [False, True], ids=["parallel", "exact"])
def test_inplace_steps_equal_functional(model, exact):
    """decode_step_, decode_chunk_ and reset_slots_ on the hybrid cache
    (per-segment seg00..seg03 leaves, one global pos) leave it bitwise as
    decode_step + merge_slots, decode_chunk and reset_slots leave it; the
    active slots' logits are equal."""
    _, _, _, cfg, params, t = model
    cfg = cfg.scaled(prefill_exact=exact)
    B = 3
    prompts = _prompts(cfg, 6, B=B, seed=7)
    _, cache = _port_stepwise(cfg, params, t, prompts)

    def clone(c):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in c.items()}

    def same(a, b):
        fa, fb = _flat(a), _flat(b)
        assert set(fa) == set(fb)
        for path in fa:
            assert torch.equal(fa[path], fb[path]), path

    tok = torch.from_numpy(_prompts(cfg, 1, B=B, seed=8))
    active = torch.tensor([True, False, True])
    lf, new = decode_step(params, clone(cache), tok, cfg, tables=t)
    ref = merge_slots(new, cache, active, cfg)
    li, got = decode_step_(params, clone(cache), tok, active, cfg, tables=t)
    same(got, ref)
    assert torch.equal(lf[active], li[active])
    toks = torch.from_numpy(_prompts(cfg, 4, B=B, seed=9))
    n_valid = torch.tensor([4, 0, 2], dtype=torch.int32)
    lf, ref = decode_chunk(params, clone(cache), toks, n_valid, cfg,
                           tables=t)
    li, got = decode_chunk_(params, clone(cache), toks, n_valid, cfg,
                            tables=t)
    same(got, ref)
    assert torch.equal(lf, li)
    mask = torch.tensor([False, True, False])
    same(reset_slots_(clone(cache), mask, cfg),
         reset_slots(cache, mask, cfg))


# --------------------------------------------------------- the engine ---

def test_hybrid_engine_refill_slots_match_fresh_slots():
    """The port's counterpart of the reference's refill regression on the
    hybrid cache layout: an engine whose 2 slots are reset and refilled
    mid-trace (4 requests) generates exactly what a 4-slot engine, every
    request on a fresh slot, generates (exact chunks, fp32)."""
    cfg = get_config(ARCH, reduced=True, prefill_exact=True).scaled(
        dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    spec = WorkloadSpec(n_requests=4, arrival_rate=10.0, prompt_len=(3, 9),
                        gen_len=(3, 5), dist="uniform", seed=11)
    trace = make_trace(spec, cfg.vocab_size)
    outs = {}
    for n_slots in (2, 4):
        engine = ServeEngine(cfg, params, n_slots=n_slots, max_len=24,
                             prefill_chunk=4, device="cpu")
        outs[n_slots] = engine.run(trace)
        assert engine.prefill_kind == "prefill_chunk_exact"
    assert outs[2] == outs[4]
    assert all(len(outs[2][r.rid]) == r.gen_len for r in trace)


def test_engine_streams_equal_jax_stepwise():
    """The engine on reduced fp32 joint tables with exact chunks: every
    greedy stream equals JAX stepwise decode's; the sentinel counts one
    signature for decode, prefill_chunk_exact and reset."""
    from test_torch_engine import _jax_greedy_streams
    jcfg, cfg = _cfgs(prefill_exact=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = _to_port(jparams)
    jt = jax_tables(jparams, jcfg, bk=32, bn=32)
    t = build_stacked_tables(params, cfg, bk=32, bn=32)
    spec = WorkloadSpec(n_requests=4, arrival_rate=0.7, prompt_len=(3, 12),
                        gen_len=(4, 8), seed=3)
    trace = make_trace(spec, cfg.vocab_size)
    engine = ServeEngine(cfg, strip_packed_projections(params, cfg),
                         n_slots=3, max_len=24, prefill_chunk=4,
                         stacked_tables=t, device="cpu")
    outputs = engine.run(trace)
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(k, cfg.name): 1
        for k in ("decode", "prefill_chunk_exact", "reset")}
    ref = _jax_greedy_streams(jcfg, jparams, jt, trace, 24)
    for r in trace:
        assert outputs[r.rid] == ref[r.rid], r.rid


@pytest.mark.parametrize("exact", [False, True], ids=["parallel", "exact"])
def test_serve_cli_on_the_cpu(capsys, exact):
    """The serve CLI serves reduced jamba on the CPU (parallel SSD chunks
    by default, exact chunks with --prefill-exact); without --device cpu
    and with no card it raises."""
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--reduced", "--dbpim-mode", "joint",
            "--device", "cpu", "--requests", "3", "--max-len", "24",
            "--gen-len", "3", "--prompt-len", "2", "9",
            "--prefill-chunk", "4"]
    out = serve.main(argv + (["--prefill-exact"] if exact else []))
    assert len(out) == 3 and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    kind = "prefill_chunk_exact" if exact else "prefill_parallel"
    assert "3/3 requests" in text and f"{kind}@jamba-smoke=1" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv[:5])


# ------------------------------------------------------- on the card -----

@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


#: jamba's full-width projections: the SSM in_proj (130 N tiles, the last
#: holding 32 real columns) and out_proj, the attention's wk, an expert's
#: (and the dense MLP's) w_up and w_down
JAMBA_SHAPES = [("in_proj", 4096, 16544), ("out_proj", 8192, 4096),
                ("wk", 4096, 1024), ("w_up", 4096, 14336),
                ("w_down", 14336, 4096)]


@pytest.mark.parametrize("name,K,N", JAMBA_SHAPES,
                         ids=[s[0] for s in JAMBA_SHAPES])
def test_joint_kernel_at_jamba_shapes_on_card(cuda, name, K, N):
    """The joint kernel at jamba's full-width shapes, M in {4, 8, 64,
    256}: bf16 within one bf16 ulp of max|ref| of the plain version, and
    the rows of M = 4 bitwise equal to the same rows of the others."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((1, K, N), generator=gen) * K ** -0.5).to(cuda)
    p = ops.slice_joint_stacked(ops.pack_joint_sparse_stacked(
        w, value_sparsity=0.6, bk=128, bn=128), 0)
    x = torch.randn((256, K), generator=gen).to(torch.bfloat16).to(cuda)
    head = None
    for M in (4, 8, 64, 256):
        y = jsm.joint_sparse_matmul(x[:M].contiguous(), p.w_blocks, p.idx,
                                    p.scales)
        ref = jsm.joint_sparse_matmul_plain(x[:M], p.w_blocks, p.idx,
                                            p.scales)
        peak = ref.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert (y.float() - ref.float()).abs().max().item() <= ulp, M
        head = y[:4] if head is None else head
        assert torch.equal(head, y[:4]), M


@pytest.mark.parametrize("what", ["gated_norm", "attention"])
def test_row_kernels_at_jamba_shapes_on_card(cuda, what):
    """row_norm at the gated norm's d = 8192 (4 and 256 rows, rows of 4
    bitwise equal to the same rows of 256) within one bf16 ulp of
    max|ref|; row_attention at jamba's hd 128, 32 / 8 heads, a 512-slot
    cache, a decode call and a 64-query chunk within 2^-6 max|ref|, a
    query alone bitwise equal to the same query in the chunk."""
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    gen = torch.Generator().manual_seed(1)
    bf16 = torch.bfloat16
    if what == "gated_norm":
        x = torch.randn((256, 8192), generator=gen).to(bf16).to(cuda)
        scale = (1 + 0.1 * torch.randn((8192,), generator=gen)).to(cuda)
        y = rnk.row_norm(x, scale)
        ref = rnk.row_norm_plain(x, scale)
        peak = ref.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert (y.float() - ref.float()).abs().max().item() <= ulp
        assert torch.equal(rnk.row_norm(x[:4].contiguous(), scale), y[:4])
        return
    B, A, C = 4, 512, 64
    k = torch.randn((B, A, 8, 128), generator=gen).to(bf16).to(cuda)
    v = torch.randn((B, A, 8, 128), generator=gen).to(bf16).to(cuda)
    q = torch.randn((B, C, 32, 128), generator=gen).to(bf16).to(cuda)
    qpos = (torch.arange(C)[None] + torch.tensor([0, 100, 300, 448])[:, None]
            ).to(torch.int32).to(cuda)
    y = rak.row_attention(q, k, v, qpos)
    ref = rak.row_attention_plain(q, k, v, qpos)
    peak = ref.float().abs().max().item()
    assert (y.float() - ref.float()).abs().max().item() <= 2 ** -6 * peak
    one = rak.row_attention(q[:, 5:6].contiguous(), k, v,
                            qpos[:, 5:6].contiguous())
    assert torch.equal(one, y[:, 5:6])
