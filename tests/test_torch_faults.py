"""The port's fault injection and containment, held against the JAX
package: ``FaultPlan.generate`` samples the reference's schedule event for
event, ``FaultEvent`` validates and the plan's queries answer as the
reference's do, ``StragglerMonitor`` flags the same ticks, and
``corrupt_cache`` poisons the reference's NaN mask, in place. Then the
engine cases of the reference's fault tests on reduced fp32 tinyllama in
joint mode (the trace and geometry of tests/test_torch_engine.py, whose
fault-free streams that file holds to JAX stepwise decode): every faulted
run gives the fault-free streams.

The JAX package is imported inside the tests that use it, so the card
test also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m port tests/test_torch_faults.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.row_attention import row_attention_plain
from repro_torch.models import init_params
from repro_torch.obs import Tracer
from repro_torch.runtime import StragglerMonitor
from repro_torch.serving import (FAULT_KINDS, FaultEvent, FaultPlan,
                                 InjectedFault, ServeEngine, WorkloadSpec,
                                 make_trace)
from repro_torch.serving.faults import corrupt_cache, corrupt_logits

pytestmark = pytest.mark.port

#: tests/test_torch_engine.py's trace and geometry
SPEC = dict(n_requests=6, arrival_rate=0.7, prompt_len=(3, 11),
            gen_len=(3, 6), seed=3)
N_SLOTS, MAX_LEN, CHUNK = 3, 24, 4


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ref_faults():
    pytest.importorskip("jax")
    from repro.serving import faults
    return faults


def _events(plan):
    return [(e.tick, e.kind, e.call, e.slot, e.repeat) for e in plan.events]


# ------------------------------------------------ the injection harness --

@pytest.mark.parametrize("n_slots", [1, 4])
@pytest.mark.parametrize("rate", [0.1, 0.25, 0.6])
@pytest.mark.parametrize("seed", [0, 5, 17])
def test_generate_samples_the_reference_plan(ref_faults, seed, rate,
                                             n_slots):
    kw = dict(seed=seed, n_ticks=300, rate=rate, n_slots=n_slots)
    mine = FaultPlan.generate(**kw)
    assert _events(mine) == _events(ref_faults.FaultPlan.generate(**kw))
    assert mine == FaultPlan.generate(**kw) and mine.events
    assert all(e.kind in FAULT_KINDS and 0 <= e.slot < n_slots
               for e in mine.events)


@pytest.mark.parametrize("kw", [dict(kind="nan_logits"),
                                dict(kind="engine_crash", call="decode"),
                                dict(kind="meteor_strike"),
                                dict(kind="nan_logits", call="embed"),
                                dict(kind="step_exception", call="any",
                                     repeat=3)])
def test_fault_event_validates_as_the_reference(ref_faults, kw):
    def outcome(cls):
        try:
            return ("ok", cls(tick=0, **kw))
        except ValueError:
            return ("ValueError", None)
    mine, ref = outcome(FaultEvent), outcome(ref_faults.FaultEvent)
    assert mine[0] == ref[0]


def test_plan_queries_answer_as_the_reference(ref_faults):
    rng = np.random.default_rng(2)
    raw = [dict(tick=int(rng.integers(6)),
                kind=str(rng.choice(FAULT_KINDS)),
                call=str(rng.choice(("decode", "prefill", "any"))),
                slot=int(rng.integers(4)), repeat=int(rng.integers(1, 4)))
           for _ in range(40)]
    mine = FaultPlan(events=tuple(FaultEvent(**e) for e in raw))
    ref = ref_faults.FaultPlan(events=tuple(ref_faults.FaultEvent(**e)
                                            for e in raw))

    def raised(plan, err, *args):
        try:
            plan.check_step(*args)
            return False
        except err:
            return True
    for tick in range(7):
        for call in ("decode", "prefill"):
            assert mine.logit_slots(tick, call) == \
                ref.logit_slots(tick, call)
            for attempt in range(4):
                assert raised(mine, InjectedFault, tick, call, attempt) == \
                    raised(ref, ref_faults.InjectedFault, tick, call,
                           attempt)
        assert mine.cache_slots(tick) == ref.cache_slots(tick)
        assert mine.crash_at(tick) == ref.crash_at(tick)
    lg = rng.normal(size=(4, 7)).astype(np.float32)
    np.testing.assert_array_equal(corrupt_logits(lg, [1, 3]),
                                  ref_faults.corrupt_logits(lg, [1, 3]))
    assert FaultPlan.none().events == ()


def test_check_step_honours_repeat_and_call_scope():
    plan = FaultPlan(events=(
        FaultEvent(tick=3, kind="step_exception", call="decode", repeat=2),))
    for attempt in (0, 1):
        with pytest.raises(InjectedFault):
            plan.check_step(3, "decode", attempt)
    plan.check_step(3, "decode", 2)
    plan.check_step(3, "prefill", 0)
    plan.check_step(2, "decode", 0)


@pytest.mark.parametrize("window,threshold,warmup", [(50, 2.0, 10),
                                                     (10, 1.5, 5),
                                                     (5, 3.0, 1)])
def test_straggler_monitor_flags_as_the_reference(window, threshold,
                                                  warmup):
    pytest.importorskip("jax")
    from repro.runtime.fault import StragglerMonitor as RefMonitor
    rng = np.random.default_rng(window)
    dts = rng.lognormal(-5, 0.3, 300)
    dts[rng.integers(0, 300, 20)] *= 10
    mine = StragglerMonitor(window=window, threshold=threshold,
                            warmup=warmup)
    ref = RefMonitor(window=window, threshold=threshold, warmup=warmup)
    assert [mine.record(float(d)) for d in dts] == \
        [ref.record(float(d)) for d in dts]
    assert mine.flagged == ref.flagged > 0
    assert mine.times == ref.times and mine.p50 == ref.p50


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "jamba-v0.1-52b", "whisper-base"])
def test_corrupt_cache_poisons_the_reference_mask_in_place(ref_faults,
                                                           arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import init_cache as jax_init_cache
    from repro_torch.models import init_cache
    jcfg = jax_get_config(arch, reduced=True).scaled(dtype="float32")
    cfg = get_config(arch, reduced=True).scaled(dtype="float32")
    B, A, slots = 4, 16, [1, 3]
    enc = None
    if cfg.is_encdec:
        enc = np.random.default_rng(1).normal(
            size=(B, 6, cfg.d_model)).astype(np.float32)
    jcache = jax_init_cache(jcfg, B, A,
                            enc_out=None if enc is None else jnp.asarray(enc))
    cache = init_cache(cfg, B, A, device="cpu",
                       enc_out=None if enc is None else torch.from_numpy(enc))
    rng = np.random.default_rng(0)
    leaves = {}

    def fill(path, leaf):
        key = jax.tree_util.keystr(path)
        if "pos" in key:
            a = rng.integers(0, A, (B,)).astype(np.int32)
        else:
            a = np.asarray(leaf).copy()
            if "enc_out" not in key:
                a = rng.normal(size=a.shape).astype(a.dtype)
        leaves[key] = a
        return jnp.asarray(a)
    jcache = jax.tree_util.tree_map_with_path(fill, jcache)

    def put(tree, prefix=""):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                put(v, key)
            else:
                tree[k] = torch.from_numpy(leaves[key].copy())
    put(cache)
    ptrs = {k: v.data_ptr() for k, v in _flat(cache).items()}
    want = jax.tree_util.tree_map(
        np.asarray, ref_faults.corrupt_cache(jcache, slots, B, jcfg))
    assert corrupt_cache(cache, slots, B) is cache
    got = _flat(cache)
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(got) == set(want)
    poisoned = 0
    for key, t in got.items():
        assert t.data_ptr() == ptrs[key], key
        np.testing.assert_array_equal(np.isnan(t.numpy()),
                                      np.isnan(want[key]), err_msg=key)
        np.testing.assert_array_equal(t.numpy(), want[key], err_msg=key)
        poisoned += int(np.isnan(want[key]).any())
    assert poisoned >= 2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


# --------------------------------------------------- engine containment --

@pytest.fixture(scope="module")
def served():
    """Reduced fp32 tinyllama in joint mode (the JAX package's params,
    bk = bn = 32), as tests/test_torch_engine.py serves it."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                    strip_packed_projections)
    from repro_torch.weights import params_from_numpy
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True,
                          dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    cfg = get_config("tinyllama-1.1b", reduced=True,
                     dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0))),
        device="cpu")
    tables = build_stacked_tables(params, cfg, bk=32, bn=32)
    trace = make_trace(WorkloadSpec(**SPEC), cfg.vocab_size)
    return cfg, strip_packed_projections(params, cfg), tables, trace


def _run(served, plan, **kw):
    cfg, params, tables, trace = served
    engine = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, stacked_tables=tables,
                         fault_plan=plan, device="cpu", **kw)
    return engine, engine.run(trace)


@pytest.fixture(scope="module")
def fault_free(served):
    engine, out = _run(served, None)
    return engine.metrics.summary(), out


def _quarantines(tracer):
    return [(r["tick"], r["attrs"]["slot"], r["attrs"]["kind"])
            for r in tracer.records if r.get("name") == "quarantine"]


def test_zero_fault_plan_is_free(served, fault_free):
    ref_s, ref_out = fault_free
    engine, out = _run(served, FaultPlan.none())
    s = engine.metrics.summary()
    assert out == ref_out
    for key in ("device_calls", "calls_by_kind", "engine_ticks"):
        assert s[key] == ref_s[key], key
    assert s["n_faults"] == s["replays"] == s["retries"] == 0


def test_nan_logits_contained_to_one_slot_and_replayed(served, fault_free):
    """Tick 7: slot 0 decodes request 3 (two tokens out); only it is
    quarantined, and it replays prompt + both tokens to the same stream."""
    ref_s, ref_out = fault_free
    engine, out = _run(served, FaultPlan(events=(
        FaultEvent(tick=7, kind="nan_logits", call="any", slot=0),)),
        tracer=Tracer())
    assert out == ref_out
    s = engine.metrics.summary()
    assert s["faults"] == {"nonfinite_logits": 1}
    assert s["replays"] == 1 and s["goodput"] == 1.0
    hit = [r for r in engine.metrics.requests.values() if r.faults]
    assert [(r.rid, r.replays) for r in hit] == [(3, 1)]
    assert s["calls_by_kind"]["prefill_chunk_exact+replay"] >= 1
    # the replay records no second first token: TTFT stays the fault-free
    # run's (request 3's first token at tick 6)
    assert engine.metrics.requests[3].first_token_tick == 6
    assert _quarantines(engine.tracer) == [(7, 0, "nonfinite_logits")]


def test_transient_step_exception_absorbed_by_retry(served, fault_free):
    ref_s, ref_out = fault_free
    engine, out = _run(served, FaultPlan(events=(
        FaultEvent(tick=2, kind="step_exception", call="any", repeat=1),)))
    assert out == ref_out
    s = engine.metrics.summary()
    assert s["retries"] == 2 and s["replays"] == 0   # both calls of tick 2
    assert s["retries_by_kind"] == {"prefill_chunk_exact": 1, "decode": 1}
    assert s["device_calls"] == ref_s["device_calls"]


def test_persistent_step_exception_quarantines_participants(served,
                                                            fault_free):
    ref_s, ref_out = fault_free
    engine, out = _run(served, FaultPlan(events=(
        FaultEvent(tick=2, kind="step_exception", call="any", repeat=99),)),
        max_step_retries=2)
    assert out == ref_out
    s = engine.metrics.summary()
    # 3 failed attempts of each of the tick's two calls, and one fault a
    # quarantined participant: the prefill call held requests 1 and 2,
    # the decode call request 0
    assert s["faults"] == {"step_exception": 6 + 3}
    assert s["retries"] == 4 and s["replays"] == 3 and s["goodput"] == 1.0


def test_cache_corruption_detected_by_propagation(served, fault_free):
    ref_s, ref_out = fault_free
    engine, out = _run(served, FaultPlan(events=(
        FaultEvent(tick=7, kind="cache_corruption", slot=0),)),
        tracer=Tracer())
    assert out == ref_out
    s = engine.metrics.summary()
    assert s["faults"] == {"cache_corruption": 1, "nonfinite_logits": 1}
    assert s["replays"] == 1 and s["goodput"] == 1.0
    assert _quarantines(engine.tracer) == [(7, 0, "nonfinite_logits")]


def test_fault_budget_sheds_instead_of_livelocking(served, fault_free):
    ref_s, ref_out = fault_free
    engine, out = _run(served, FaultPlan(events=(
        FaultEvent(tick=7, kind="nan_logits", call="any", slot=0),)),
        max_replays=0)
    s = engine.metrics.summary()
    assert s["n_shed"] == 1 and s["replays"] == 0
    shed = [r for r in engine.metrics.requests.values()
            if r.outcome == "shed"]
    assert [(r.rid, r.reason) for r in shed] == [(3, "fault_budget")]
    assert s["n_completed"] == SPEC["n_requests"] - 1
    for rid, toks in out.items():
        assert toks == ref_out[rid][:len(toks)]
        if rid != 3:
            assert toks == ref_out[rid]


#: a quarantine at tick 7 zeroes slot 0 (position 0); the corruption of
#: tick 8 lands on it before its replay's first chunk
DEAD_KEY_PLAN = FaultPlan(events=(
    FaultEvent(tick=7, kind="nan_logits", call="decode", slot=0),
    FaultEvent(tick=8, kind="cache_corruption", slot=0)))


def test_corruption_of_a_reset_slot_is_detected_as_the_reference(
        served, fault_free):
    """The reference's attention multiplies every dead key's V row by its
    zero probability, and 0 * NaN = NaN: a corruption of a slot at
    position 0 reaches the next call's logits. The port's plain version
    (the CPU path) does the same, so the replay's first chunk is
    quarantined at tick 8, as the reference's would be."""
    ref_s, ref_out = fault_free
    engine, out = _run(served, DEAD_KEY_PLAN, tracer=Tracer())
    assert out == ref_out
    s = engine.metrics.summary()
    assert s["faults"] == {"nonfinite_logits": 2, "cache_corruption": 1}
    assert s["replays"] == 2
    assert _quarantines(engine.tracer) == [(7, 0, "nonfinite_logits"),
                                           (8, 0, "nonfinite_logits")]


def test_dead_key_nan_reaches_the_output_as_in_the_reference():
    """The mechanism on one call: NaN in the V rows past every query's
    position, zero probabilities, NaN out of both attentions."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.attention import _sdpa
    rng = np.random.default_rng(0)
    B, Sq, A, H, hd = 1, 4, 16, 2, 8
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, A, H, hd)).astype(np.float32)
    v = rng.normal(size=(B, A, H, hd)).astype(np.float32)
    v[:, Sq:] = np.nan
    qpos = np.arange(Sq, dtype=np.int32)[None]
    mine = row_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(qpos))
    mask = (np.arange(A)[None, :] <= qpos[0][:, None])[None, None]
    ref = np.asarray(_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mask), jnp.float32))
    assert np.isnan(ref).all() and torch.isnan(mine).all()


def test_corruption_of_a_reset_slot_is_detected_on_the_card(cuda):
    """The same plan with the kernels on the card quarantines where the
    CPU path does: row_attention skips the keys past a row's live range,
    but reads their V rows for non-finite values and writes NaN where the
    reference's 0 * v gives it, so the poisoned rows of a slot at
    position 0 are read at the replay's first chunk, as on the CPU."""
    cfg = get_config("tinyllama-1.1b", reduced=True).scaled(dtype="float32")
    trace = make_trace(WorkloadSpec(**SPEC), cfg.vocab_size)
    params = init_params(cfg, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        tracer = Tracer()
        engine = ServeEngine(
            cfg, {k: _to(v, dev) for k, v in params.items()},
            n_slots=N_SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
            fault_plan=DEAD_KEY_PLAN, tracer=tracer, device=dev)
        runs[str(dev)] = (engine.run(trace), engine.metrics.summary(),
                          _quarantines(tracer))
    (out_cpu, s_cpu, q_cpu), (out_card, s_card, q_card) = runs.values()
    assert out_card == out_cpu
    assert q_card == q_cpu
    assert (s_card["faults"], s_card["replays"]) == \
        (s_cpu["faults"], s_cpu["replays"])


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.fixture(scope="module")
def fault_audit():
    """chip_smoke.py's audit of a traced chaos run (phase 4g), loaded from
    the script."""
    import runpy
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    return runpy.run_path(str(path), run_name="fault_audit")["_fault_audit"]


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_fault_audit_explains_every_fault_of_a_chaos_run(served, fault_free,
                                                         fault_audit, seed):
    """The faults a seeded chaos run counts by kind are the plan's events
    that landed, read from its trace; a plan without one of the NaN-logits
    events that landed leaves that quarantine unexplained."""
    plan = FaultPlan.generate(seed=seed, n_ticks=14, rate=0.5,
                              n_slots=N_SLOTS)
    engine, out = _run(served, plan, tracer=Tracer())
    s = engine.metrics.summary()
    audit = fault_audit(plan, engine.tracer.records, 2)
    assert not audit["unexplained"], audit
    assert s["faults"] == {k: n for k, n in audit["counts"].items() if n}
    assert s["n_faults"] > 0
    for rid, toks in out.items():
        assert toks == fault_free[1][rid][:len(toks)]
    nan = [e for e in plan.events if e.kind == "nan_logits"]
    if audit["landed_nan"]:
        for e in nan:
            rest = FaultPlan(events=tuple(x for x in plan.events if x != e))
            if fault_audit(rest, engine.tracer.records, 2)["unexplained"]:
                break
        else:
            raise AssertionError("no landed NaN event was missed")
