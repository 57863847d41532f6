"""The engine's compiled serving steps: the in-place steps against the
functional ones bitwise (decode with mixed ``active``, a prefill chunk
with ragged ``n_valid`` including 0, the slot reset), the CPU engine's
greedy streams against JAX stepwise decode with one compiled signature
per step, and, on a CUDA card, each captured CUDA graph's replays
against the eager in-place step, with the kernel launches inside the
replays read from the device's own records: for tinyllama and for a
reduced mamba2 (parallel and exact chunks).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_steps.py
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro_torch.configs import get_config
from repro_torch.kernels import (block_sparse_matmul, dbmu_sim,
                                 fta_int8_matmul, joint_sparse_matmul,
                                 row_attention, row_norm)
from repro_torch.launch.steps import build_step, compile_step
from repro_torch.models import (decode_chunk, decode_chunk_, decode_step,
                                init_cache, init_params, merge_slots,
                                reset_slots)
from repro_torch.obs import RecompileSentinel, device_launches, per_call
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

B, A, C = 4, 16, 4
#: prefill chunks (n_valid per slot) that fill the cache before a test:
#: positions end at (9, 7, 14, 6)
FILL = [[4, 2, 4, 0], [3, 4, 4, 1], [0, 1, 4, 2], [2, 0, 2, 3]]
ACTIVE = [[True, False, True, True], [False, True, False, True],
          [True, True, True, True], [False, False, True, False]]
#: ragged chunks: an idle slot (0), a slot whose chunk runs past the
#: cache's end with only its valid tokens inside it (pos 14, 2 valid)
N_VALID = [[4, 0, 2, 1], [1, 3, 0, 4], [0, 0, 0, 2]]


def _model(dtype="float32", device="cpu", reduced=True, n_layers=None,
           arch="tinyllama-1.1b", exact=False):
    cfg = get_config(arch, reduced=reduced,
                     dbpim_mode="joint").scaled(dtype=dtype,
                                                dbpim_value_sparsity=0.5,
                                                prefill_exact=exact)
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    params = init_params(cfg, seed=0, device=device)
    tiles = dict(bk=32, bn=32) if reduced else {}
    tables = build_stacked_tables(params, cfg, **tiles)
    return cfg, strip_packed_projections(params, cfg), tables


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


def _filled_cache(cfg, params, tables, device, seed=0, max_len=A):
    """A slot cache with per-slot (B,) positions, filled by functional
    prefill chunks of random tokens (FILL)."""
    cache = init_cache(cfg, B, max_len, device=device)
    cache["pos"] = torch.zeros((B,), dtype=torch.int32, device=device)
    if "attn" in cache:
        cache["attn"]["pos"] = torch.zeros((B,), dtype=torch.int32,
                                           device=device)
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
def tiny(request):
    cfg, params, tables = _model(request.param)
    return cfg, params, tables, _filled_cache(cfg, params, tables, "cpu")


def test_inplace_decode_equals_functional_decode(tiny):
    """decode_step + merge_slots against the engine's decode step (in
    place) over steps with mixed active slots: the active slots' logits
    and the whole cache bitwise."""
    cfg, params, tables, filled = tiny
    inp = build_step(cfg, "decode", stacked_tables=tables)
    cache_f, cache_i = _clone(filled), _clone(filled)
    gen = torch.Generator().manual_seed(1)
    for step, act in enumerate(ACTIVE):
        tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                            dtype=torch.int32)
        active = torch.tensor(act)
        lg_f, new = decode_step(params, cache_f, tok, cfg, tables=tables)
        cache_f = merge_slots(new, cache_f, active, cfg)
        lg_i, out = inp(params, cache_i, tok, active)
        assert out is cache_i
        assert torch.equal(lg_i[active], lg_f[active]), step
        _assert_trees_equal(cache_i, cache_f, f"decode step {step}")
    assert cache_i["pos"].tolist() == [11, 9, 17, 9]


def test_inplace_chunk_equals_functional_chunk(tiny):
    """decode_chunk against decode_chunk_ with ragged n_valid (0 included,
    and a chunk running past the cache's end): logits and cache bitwise."""
    cfg, params, tables, filled = tiny
    cache_f, cache_i = _clone(filled), _clone(filled)
    gen = torch.Generator().manual_seed(2)
    for call, n in enumerate(N_VALID):
        toks = torch.randint(1, cfg.vocab_size, (B, C), generator=gen,
                             dtype=torch.int32)
        n_valid = torch.tensor(n, dtype=torch.int32)
        lg_f, cache_f = decode_chunk(params, cache_f, toks, n_valid, cfg,
                                     tables=tables)
        lg_i, out = decode_chunk_(params, cache_i, toks, n_valid, cfg,
                                  tables=tables)
        assert out is cache_i
        assert torch.equal(lg_i, lg_f), call
        _assert_trees_equal(cache_i, cache_f, f"chunk call {call}")
    assert cache_i["pos"].tolist() == [14, 10, 16, 13]


def test_inplace_reset_equals_functional_reset(tiny):
    """reset_slots against the engine's reset step (in place), bitwise."""
    cfg, params, tables, filled = tiny
    inp = build_step(cfg, "reset")
    for mask in ([True, False, True, False], [False] * B, [True] * B):
        cache_i = _clone(filled)
        m = torch.tensor(mask)
        want = reset_slots(_clone(filled), m, cfg)
        assert inp(cache_i, m) is cache_i
        _assert_trees_equal(cache_i, want, f"reset {mask}")


def test_inplace_steps_refuse_what_they_cannot_write(tiny):
    """A scalar position has no slot to advance in place, and a chunk
    longer than the cache has no row of its own for each token."""
    cfg, params, tables, _ = tiny
    cache = init_cache(cfg, B, A, device="cpu")
    toks = torch.ones((B, C), dtype=torch.int32)
    n_valid = torch.full((B,), C, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-slot positions"):
        decode_chunk_(params, cache, toks, n_valid, cfg, tables=tables)
    short = _filled_cache(cfg, params, tables, "cpu", max_len=C)
    long_toks = torch.ones((B, C + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="longer than the cache"):
        decode_chunk_(params, short, long_toks, n_valid * 0, cfg,
                      tables=tables)


# ----------------------------------------------------------- the engine --

def test_engine_streams_equal_jax_stepwise_one_compile_per_step():
    """The CPU engine over its compiled in-place steps: every request's
    greedy stream equals JAX stepwise decode's on the same params, and the
    sentinel counts exactly one signature for each of its three steps."""
    from test_torch_engine import _jax_greedy_streams
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True,
                          dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    cfg = get_config("tinyllama-1.1b", reduced=True,
                     dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    jt = jax_tables(jparams, jcfg, bk=32, bn=32)
    tables = build_stacked_tables(params, cfg, bk=32, bn=32)
    trace = make_trace(WorkloadSpec(n_requests=5, arrival_rate=1.0,
                                    prompt_len=(2, 9), gen_len=(2, 5),
                                    seed=11), cfg.vocab_size)
    engine = ServeEngine(cfg, strip_packed_projections(params, cfg),
                         n_slots=2, max_len=16, prefill_chunk=3,
                         stacked_tables=tables, device="cpu")
    outputs = engine.run(trace)
    assert outputs == _jax_greedy_streams(jcfg, jparams, jt, trace, 16)
    assert engine.sentinel.available
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(kind, cfg.name): 1
        for kind in ("decode", "prefill_chunk_exact", "reset")}


@pytest.mark.parametrize("arch,token_steps,want", [
    ("tinyllama-1.1b", 1, (154, 22, 45)),
    ("mamba2-1.3b", 1, (96, 0, 97)),
    ("mamba2-1.3b", 8, (768, 0, 433))])
def test_per_call_counts_the_full_width_paths(arch, token_steps, want):
    """Launches per step call at full width: tinyllama's 22 layers x 7
    projections, an attention and two norms each, and the final norm;
    mamba2's 48 layers x 2 projections and two norms, no attention; an
    exact chunk of 8 tokens projects and gates once per token step."""
    cfg = get_config(arch, dbpim_mode="joint")
    got = per_call(cfg, token_steps)
    assert got == dict(zip(("joint_sparse_matmul", "row_attention",
                            "row_norm"), want))


# --------------------------------------------------------- on the card --

#: the card models: two full-width tinyllama-1.1b layers, and reduced
#: mamba2 with parallel and with exact chunks
CARD_MODELS = {"tinyllama": dict(reduced=False, n_layers=2),
               "mamba2-parallel": dict(arch="mamba2-1.3b"),
               "mamba2-exact": dict(arch="mamba2-1.3b", exact=True)}


@pytest.fixture(scope="module", params=list(CARD_MODELS))
def card_model(request):
    """A bf16 model of CARD_MODELS with joint tables on the card; skips
    without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have "
                    "no CPU mode")
    dev = torch.device("cuda")
    cfg, params, tables = _model("bfloat16", dev,
                                 **CARD_MODELS[request.param])
    return cfg, params, tables, _filled_cache(cfg, params, tables, dev,
                                              max_len=64)


#: the wrappers whose launches are read from the device's records (the
#: block-sparse matmul shares the joint kernel's symbols: its host count
#: stands for it)
DEVICE_MODULES = {"joint_sparse_matmul": joint_sparse_matmul,
                  "row_attention": row_attention, "row_norm": row_norm,
                  "fta_int8_matmul": fta_int8_matmul, "dbmu_sim": dbmu_sim}
HOST_MODULES = {**DEVICE_MODULES, "block_sparse_matmul": block_sparse_matmul}


def _launches():
    return {name: m.LAUNCHES for name, m in HOST_MODULES.items()}


def _delta(before):
    return {k: n - before[k] for k, n in _launches().items() if n != before[k]}


def _per_call(cfg, steps=1):
    """The path's launches per step call (``obs.per_call``), the kernels it
    does not launch left out."""
    return {name: n for name, n in per_call(cfg, steps).items() if n}


def _graph_run(make, filled, invoke, n_calls, want, attempts=3):
    """Fresh compiled steps (``make()``) on a copy of ``filled`` over
    ``n_calls`` calls (``invoke(steps, cache, i)``, returning the
    logits), inside one torch.profiler window. Returns (the steps, each
    call's logits and cache, copied; the host LAUNCHES each call added).
    The device launches the window recorded per wrapper must equal
    ``want``; the profiler now and then loses records, so a window short
    of them is taken again with fresh steps, up to ``attempts`` in all."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        steps, cache = make(), _clone(filled)
        outs, host = [], []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n_calls):
                before = _launches()
                out = invoke(steps, cache, i)
                torch.cuda.synchronize()
                host.append(_delta(before))
                outs.append((_clone(out), _clone(cache)))
        device = device_launches(prof, DEVICE_MODULES)
        if device == want:
            return steps, outs, host
    pytest.fail(f"device launches {device} != {want} in {attempts} windows")


def _expected_launches(cfg, n_calls, steps=1):
    """Device launches of ``n_calls`` step calls: the path's kernels
    ``_per_call`` times per call (the first call's eager warm-up, then one
    replay each), the others none."""
    per = _per_call(cfg, steps)
    return {name: n_calls * per.get(name, 0) for name in DEVICE_MODULES}


def test_graph_replays_equal_eager_decode_on_card(card_model):
    """The compiled decode step (first call eager, then replays of its
    graph) against the eager in-place step, over calls with changing
    active slots: all logits and the whole cache bitwise. The device
    records the path's launches per call (tinyllama: 14 joint, 2 attention
    and 5 norm; mamba2: 4 joint and 5 norm), replays included, and no
    other kernel; the host counts the first call's eager launches and
    nothing at the capture or the replays."""
    cfg, params, tables, filled = card_model
    step = build_step(cfg, "decode", stacked_tables=tables)
    gen = torch.Generator().manual_seed(3)
    calls = [(torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                            dtype=torch.int32).cuda(),
              torch.tensor(act).cuda()) for act in ACTIVE * 2]
    cache_e, want = _clone(filled), []
    for tok, active in calls:
        lg_e, _ = step(params, cache_e, tok, active)
        want.append((lg_e.clone(), _clone(cache_e)))
    graph, outs, host = _graph_run(
        lambda: compile_step(step, buffer_argnums=(0, 1)), filled,
        lambda g, cache, i: g(params, cache, *calls[i])[0], len(calls),
        _expected_launches(cfg, len(calls)))
    for call, (lg_g, cache_g) in enumerate(outs):
        assert torch.equal(lg_g, want[call][0]), call
        _assert_trees_equal(cache_g, want[call][1], f"decode call {call}")
    assert host == [_per_call(cfg)] + [{}] * (len(calls) - 1)
    assert graph._cache_size() == 1


def test_graph_replays_equal_eager_chunk_and_reset_on_card(card_model):
    """The compiled prefill-chunk and reset steps against their eager
    in-place forms over calls with changing n_valid and masks, with the
    launches of the replays from the device's records (an exact SSM chunk
    walks its C tokens)."""
    cfg, params, tables, filled = card_model
    steps = C if cfg.prefill_exact else 1
    chunk = build_step(cfg, "prefill_chunk", stacked_tables=tables)
    reset = build_step(cfg, "reset")
    gen = torch.Generator().manual_seed(4)
    calls = [(torch.randint(1, cfg.vocab_size, (B, C), generator=gen,
                            dtype=torch.int32).cuda(),
              torch.tensor(n, dtype=torch.int32).cuda(),
              torch.tensor([i % 2 == 0, False, i % 3 == 0, True]).cuda())
             for i, n in enumerate(N_VALID * 2)]
    cache_e, want = _clone(filled), []
    for toks, n_valid, mask in calls:
        lg_e, _ = chunk(params, cache_e, toks, n_valid)
        want.append(lg_e.clone())
        reset(cache_e, mask)
        want[-1] = (want[-1], _clone(cache_e))

    def invoke(steps, cache, i):
        g_chunk, g_reset = steps
        toks, n_valid, mask = calls[i]
        lg, _ = g_chunk(params, cache, toks, n_valid)
        g_reset(cache, mask)
        return lg

    (g_chunk, g_reset), outs, host = _graph_run(
        lambda: (compile_step(chunk, buffer_argnums=(0, 1)),
                 compile_step(reset, buffer_argnums=(0,))),
        filled, invoke, len(calls),
        _expected_launches(cfg, len(calls), steps))
    for call, (lg_g, cache_g) in enumerate(outs):
        assert torch.equal(lg_g, want[call][0]), call
        _assert_trees_equal(cache_g, want[call][1], f"chunk call {call}")
    assert host == [_per_call(cfg, steps)] + [{}] * (len(calls) - 1)
    assert g_chunk._cache_size() == g_reset._cache_size() == 1


def test_failed_capture_raises_on_card(card_model):
    """A step that syncs with the host cannot be captured: the compiled
    step raises instead of running eagerly."""
    def step(buf, x):
        return x * float(x.sum().item()), buf

    step.call_kind, step.arch = "decode", "toy"
    compiled = compile_step(step, buffer_argnums=(0,))
    buf = torch.zeros((2,), device="cuda")
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        compiled(buf, torch.ones((3,), device="cuda"))
