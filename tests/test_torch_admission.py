"""The port's admission control and SLO shedding, held against the JAX
package: ``_pop_next`` (FIFO and SPF with its skip bound),
``_min_ticks_to_done`` and ``_shed_hopeless_queue`` decide as the
reference's own methods do, called unbound on stub objects over the same
seeded traces; and the port's engine, on reduced fp32 tinyllama in joint
mode, serves SPF and FIFO with equal streams, records rejections and
sheds instead of raising them, and carries its post-mortem in
``EngineStuckError``."""

import types
from collections import deque

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.obs import Tracer, load, validate
from repro_torch.serving import (EngineStuckError, FaultEvent, FaultPlan,
                                 Request, ServeEngine, WorkloadSpec,
                                 make_trace)
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

N_SLOTS, MAX_LEN, CHUNK = 3, 24, 4


@pytest.fixture(scope="module")
def served():
    """Reduced fp32 tinyllama in joint mode (the JAX package's params,
    bk = bn = 32), as tests/test_torch_engine.py serves it."""
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True,
                          dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    cfg = get_config("tinyllama-1.1b", reduced=True,
                     dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    tables = build_stacked_tables(params, cfg, bk=32, bn=32)
    return cfg, strip_packed_projections(params, cfg), tables


def _engine(served, **kw):
    cfg, params, tables = served
    kw.setdefault("n_slots", N_SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    return ServeEngine(cfg, params, prefill_chunk=CHUNK,
                       stacked_tables=tables, device="cpu", **kw)


# ------------------------------------- decisions against the reference --

def _trace(seed, n, poisson):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for rid in range(n):
        if poisson:
            t += float(rng.exponential(1.0 / 1.5))
        plen = int(rng.integers(1, 40))
        out.append(Request(rid=rid, prompt=tuple(range(1, plen + 1)),
                           gen_len=int(rng.integers(1, 9)), arrival=t,
                           deadline=t + float(rng.integers(1, 30))))
    return out


def _stub(queue, schedule, cap, **kw):
    return types.SimpleNamespace(queue=deque(queue),
                                 skips={r.rid: 0 for r in queue},
                                 schedule=schedule, spf_age_cap=cap, **kw)


@pytest.mark.parametrize("poisson", [False, True], ids=["at0", "poisson"])
@pytest.mark.parametrize("cap", [0, 1, 2, 8])
@pytest.mark.parametrize("schedule", ["fifo", "spf"])
def test_pop_next_decides_as_the_reference(schedule, cap, poisson):
    """The same queue popped tick by tick, a seeded number of free slots
    a tick: the port's and the reference's picks, and the skip counts
    they leave, are equal; skips never pass the cap."""
    trace = _trace(seed=cap + 10 * poisson, n=24, poisson=poisson)
    mine, ref = _stub(trace, schedule, cap), _stub(trace, schedule, cap)
    rng = np.random.default_rng(cap)
    picked, tick = [], 0
    while mine.queue:
        for _ in range(int(rng.integers(0, 3))):
            a = ServeEngine._pop_next(mine, tick)
            b = JaxEngine._pop_next(ref, tick)
            assert a is b
            if a is None:
                break
            picked.append((a.rid, mine.skips.pop(a.rid)))
            ref.skips.pop(b.rid)
        assert mine.skips == ref.skips
        assert list(mine.queue) == list(ref.queue)
        tick += 1
    assert sorted(r for r, _ in picked) == list(range(len(trace)))
    assert max(s for _, s in picked) <= (cap if schedule == "spf" else 0)
    if schedule == "fifo":
        assert [r for r, _ in picked] == list(range(len(trace)))


class _Sheds:
    def __init__(self):
        self.shed = []

    def on_shed(self, rid, tick, reason):
        self.shed.append((rid, tick, reason))


@pytest.mark.parametrize("prefill_mode,chunk", [("chunked", 1),
                                                ("chunked", 4),
                                                ("chunked", 16),
                                                ("full", 4)])
def test_min_ticks_and_queue_shedding_decide_as_the_reference(
        prefill_mode, chunk):
    mine = _stub([], "fifo", 8, prefill_chunk=chunk,
                 prefill_mode=prefill_mode, metrics=_Sheds(), tracer=None,
                 journal=None, paged=False)
    ref = _stub([], "fifo", 8, prefill_chunk=chunk,
                prefill_mode=prefill_mode, metrics=_Sheds(), tracer=None,
                journal=None, paged=False)
    mine._min_ticks_to_done = lambda p, g, queued=False: \
        ServeEngine._min_ticks_to_done(mine, p, g, queued)
    ref._min_ticks_to_done = lambda p, g, queued=False: \
        JaxEngine._min_ticks_to_done(ref, p, g, queued)
    for p in range(0, 40):
        for g in range(0, 10):
            assert mine._min_ticks_to_done(p, g) == \
                ref._min_ticks_to_done(p, g), (p, g)
    for seed, poisson in ((1, False), (2, True), (3, True)):
        trace = _trace(seed, 30, poisson)
        for stub in (mine, ref):
            stub.queue = deque(trace)
            stub.skips = {r.rid: 0 for r in trace}
        for tick in range(40):
            ServeEngine._shed_hopeless_queue(mine, tick)
            JaxEngine._shed_hopeless_queue(ref, tick)
            assert list(mine.queue) == list(ref.queue)
            assert mine.skips == ref.skips
            # admit one arrived request a tick, as a busy engine would
            for stub in (mine, ref):
                if stub.queue and stub.queue[0].arrival <= tick:
                    stub.skips.pop(stub.queue.popleft().rid)
    assert mine.metrics.shed == ref.metrics.shed
    assert mine.metrics.shed


# -------------------------------------------------------- the engine --

BIMODAL = WorkloadSpec(n_requests=8, arrival_rate=0.0, prompt_len=(2, 14),
                       gen_len=(3, 5), dist="bimodal", seed=4)


def _fifo_order(engine):
    return [iv.rid for iv in sorted(engine.slot_log,
                                    key=lambda iv: (iv.admit_tick, iv.slot))]


@pytest.fixture(scope="module")
def fifo_run(served):
    trace = make_trace(BIMODAL, served[0].vocab_size)
    engine = _engine(served)
    return trace, engine, engine.run(trace)


@pytest.mark.parametrize("cap", [0, 1, 2])
def test_spf_and_fifo_give_equal_streams(served, fifo_run, cap):
    trace, fifo, fifo_out = fifo_run
    spf = _engine(served, schedule="spf", spf_age_cap=cap)
    out = spf.run(trace)
    assert out == fifo_out
    for rid, row in spf.first_logits.items():
        np.testing.assert_allclose(row.numpy(),
                                   fifo.first_logits[rid].numpy(),
                                   rtol=0, atol=1e-6)
    assert max(r.skips for r in spf.metrics.requests.values()) <= cap
    assert spf.skips == {}
    if cap:
        assert _fifo_order(spf) != _fifo_order(fifo)


def test_rejections_are_recorded_not_raised(served):
    engine = _engine(served, max_len=8, queue_cap=1)
    big = Request(rid=0, prompt=tuple(range(1, 8)), gen_len=8)
    ok = Request(rid=1, prompt=(1, 2), gen_len=2)
    full = Request(rid=2, prompt=(3, 4), gen_len=2)
    dup = Request(rid=1, prompt=(5,), gen_len=1)
    assert engine.submit(big) is False
    assert engine.submit(ok) is True
    assert engine.submit(full) is False
    assert engine.submit(dup) is False
    assert engine.rejected == {0: "oversized", 2: "queue_full"}
    assert engine.duplicate_rids == [1]
    s = engine.metrics.summary()
    assert s["n_rejected"] == 3 and s["n_requests"] == 3
    # the duplicate left the original's row alone
    assert engine.metrics.requests[1].outcome is None
    assert engine.metrics.requests[1].prompt_len == 2
    out = engine._serve_loop()
    assert set(out) == {1} and len(out[1]) == 2
    assert engine.metrics.requests[1].outcome == "done"


@pytest.mark.parametrize("request_", [
    Request(rid=0, prompt=tuple(range(1, 8)), gen_len=8),
    Request(rid=1, prompt=(1, 2), gen_len=2)], ids=["oversized", "dup"])
def test_strict_admission_raises(served, request_):
    engine = _engine(served, max_len=8, strict=True)
    engine.submit(Request(rid=1, prompt=(1, 2), gen_len=2))
    with pytest.raises(ValueError):
        engine.submit(request_)


def test_hopeless_queued_request_shed_before_taking_a_slot(served):
    engine = _engine(served, n_slots=2)
    doomed = Request(rid=0, prompt=tuple(range(1, 7)), gen_len=4,
                     deadline=1.0)                # needs >= 5 ticks
    fine = Request(rid=1, prompt=(1, 2, 3), gen_len=3, deadline=50.0)
    out = engine.run([doomed, fine])
    assert 0 not in out
    r0 = engine.metrics.requests[0]
    assert (r0.outcome, r0.reason, r0.admitted_tick) == \
        ("shed", "deadline", None)
    assert engine.metrics.requests[1].outcome == "done"


def test_in_flight_request_shed_when_a_fault_breaks_its_deadline(served):
    """Done at tick 3 == the deadline fault-free; the replay of a
    quarantine at tick 1 makes it unreachable, and the slot is freed."""
    plan = FaultPlan(events=(
        FaultEvent(tick=1, kind="nan_logits", call="decode", slot=0),))
    engine = _engine(served, n_slots=1, fault_plan=plan)
    req = Request(rid=0, prompt=(1, 2, 3, 4), gen_len=4, deadline=3.0)
    out = engine.run([req])
    r = engine.metrics.requests[0]
    assert (r.outcome, r.reason) == ("shed", "deadline") and r.faults == 1
    assert len(out[0]) < req.gen_len
    assert engine.slot_log[0].release_tick is not None


def test_slo_outcomes_cover_every_request(served, fifo_run):
    """Deadlines and a bounded queue over the bimodal trace: every request
    ends done, shed or rejected, and a served stream is its FIFO stream."""
    trace, _, fifo_out = fifo_run
    slo = make_trace(WorkloadSpec(**{**BIMODAL.__dict__,
                                     "deadline_slack": 9.0}),
                     served[0].vocab_size)
    engine = _engine(served, queue_cap=6)
    out = engine.run(slo)
    rows = {r.rid: r for r in engine.metrics.requests.values()}
    assert {r.outcome for r in rows.values()} <= {"done", "shed",
                                                  "rejected"}
    assert None not in {r.outcome for r in rows.values()}
    assert any(r.outcome == "shed" for r in rows.values())
    assert any(r.outcome == "rejected" for r in rows.values())
    for rid, toks in out.items():
        assert toks == fifo_out[rid][:len(toks)]
        if rows[rid].outcome == "done":
            assert toks == fifo_out[rid]
            assert rows[rid].done_tick <= slo[rid].deadline


def test_engine_stuck_error_carries_post_mortem(served, fifo_run, tmp_path):
    trace = fifo_run[0]
    path = str(tmp_path / "stuck.jsonl")
    engine = _engine(served, max_ticks=2, tracer=Tracer(path=path))
    with pytest.raises(EngineStuckError) as ei:
        engine.run(trace)
    e = ei.value
    assert e.outputs == engine.outputs and e.outputs
    assert e.slot_log and e.slot_log[0].admit_tick == 0
    assert e.summary["engine_ticks"] == 3
    assert e.trace_path == path
    assert validate(load(path))["spans"] >= 3


def test_engine_refuses_bad_schedule_and_unknown_keywords(served):
    with pytest.raises(ValueError):
        _engine(served, schedule="lifo")
    with pytest.raises(TypeError):
        _engine(served, mesh=object())
    # the reference's defaults of the unported keywords are accepted
    _engine(served, paged=False, journal=None, snapshot_every=0)

