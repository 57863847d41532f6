"""The port's two-clock tracer, its Chrome export, the report CLI and the
metrics recorder, held against the JAX package: a traced chaos run of the
port's engine (reduced fp32 tinyllama in joint mode) validates under both
packages' ``validate`` and renders and converts as the reference's
``render`` and ``to_chrome_trace`` do on the same records; tracing is
passive; the same events recorded into both recorders give equal
summaries and state dicts, and a port state dict loads into the
reference's recorder."""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.launch.report import render as ref_render
from repro.models import init_params as jax_init_params
from repro.obs import to_chrome_trace as ref_to_chrome
from repro.obs import validate as ref_validate
from repro.serving.metrics import MetricsRecorder as RefRecorder
from repro_torch.configs import get_config
from repro_torch.launch.report import main as report_main
from repro_torch.launch.report import render
from repro_torch.obs import (Tracer, engine_waterfall, load,
                             to_chrome_trace, validate)
from repro_torch.obs.trace import TraceError
from repro_torch.serving import (FaultPlan, MetricsRecorder, ServeEngine,
                                 WorkloadSpec, make_trace)
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
SPEC = dict(n_requests=6, arrival_rate=0.7, prompt_len=(3, 11),
            gen_len=(3, 6), seed=3)
N_SLOTS, MAX_LEN, CHUNK = 3, 24, 4


# ------------------------------------------------------- tracer units --

def test_span_nesting_is_lifo_enforced():
    tr = Tracer()
    t = tr.begin("tick", 0)
    c = tr.begin("call", 0)
    with pytest.raises(TraceError):
        tr.end(t)                  # closing the outer span first
    tr.end(c)
    tr.end(t)
    with pytest.raises(TraceError):
        tr.end(t)                  # double close


def test_dump_refuses_open_spans(tmp_path):
    tr = Tracer()
    tr.begin("tick", 0)
    with pytest.raises(TraceError):
        tr.dump(str(tmp_path / "x.jsonl"))


def test_validate_rejects_malformed():
    tr = Tracer()
    s = tr.begin("tick", 0)
    tr.end(s)
    bad = [dict(r) for r in tr.records]
    bad[1]["name"] = "mystery"
    with pytest.raises(TraceError):
        validate(bad)
    with pytest.raises(TraceError):
        validate(tr.records[1:])   # no meta record
    tr2 = Tracer()
    for tick in (5, 4):            # ticks must be monotone
        tr2.end(tr2.begin("tick", tick))
    with pytest.raises(TraceError):
        validate(tr2.records)


# -------------------------------------------------- the traced engine --

@pytest.fixture(scope="module")
def served():
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


def _run(served, **kw):
    cfg, params, tables, trace = served
    engine = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, stacked_tables=tables,
                         device="cpu", **kw)
    return engine, engine.run(trace)


@pytest.fixture(scope="module")
def chaos(served):
    """One seeded chaos run, traced, and the same plan untraced."""
    plan = FaultPlan.generate(seed=3, n_ticks=40, rate=0.3, n_slots=N_SLOTS)
    tracer = Tracer(arch=served[0].name, meta={"case": "test"})
    traced = _run(served, fault_plan=plan, tracer=tracer)
    return traced, _run(served, fault_plan=plan), tracer


def test_traced_chaos_run_validates_under_both_packages(chaos):
    (engine, _), _, tracer = chaos
    s = engine.metrics.summary()
    assert s["n_faults"] and s["replays"] and s["retries"]
    stats = validate(tracer.records)
    assert stats == ref_validate(tracer.records)
    spans = [r for r in tracer.records if r.get("type") == "span"]
    assert sum(r["name"] == "tick" for r in spans) == s["engine_ticks"]
    # one call span a device call, and one a call whose retries ran out;
    # the recorder counts prefill and decode calls, not the slot resets
    ok = [r for r in spans if r["name"] == "call" and r["attrs"]["ok"]
          and r["attrs"]["phase"] in ("prefill", "decode")]
    assert len(ok) == s["device_calls"]
    names = {r["name"] for r in tracer.records if r.get("type") == "event"}
    assert {"admit", "fault", "quarantine", "replay",
            "release"} <= names


def test_tracing_is_passive(chaos, served):
    """Tracer on and off, under the same plan and with no plan: the same
    outputs, ticks and device calls by kind."""
    (traced, out_t), (bare, out_b), _ = chaos
    assert out_t == out_b
    for key in ("engine_ticks", "device_calls", "calls_by_kind", "faults",
                "retries", "replays"):
        assert traced.metrics.summary()[key] == bare.metrics.summary()[key]
    plain, out_p = _run(served)
    quiet, out_q = _run(served, tracer=Tracer())
    assert out_p == out_q
    assert plain.metrics.summary()["calls_by_kind"] == \
        quiet.metrics.summary()["calls_by_kind"]


def test_render_and_chrome_equal_the_reference(chaos, tmp_path):
    tracer = copy.copy(chaos[2])
    tracer.records = list(tracer.records)
    # the engine's waterfalls, as the serve CLI embeds them
    for kind, wf in engine_waterfall(chaos[0][0]).items():
        tracer.waterfall(kind, wf["rows"], wf["total"])
    path = tmp_path / "trace.jsonl"
    tracer.dump(str(path))
    records = load(str(path))
    assert validate(records) == validate(tracer.records)
    assert validate(records)["waterfalls"] == 2
    out = render(records)
    assert out == ref_render(records)
    for section in ("TIMELINE", "SLOTS", "QUEUE DEPTH", "WATERFALL",
                    "FAULTS"):
        assert section in out
    assert to_chrome_trace(records) == ref_to_chrome(records)
    chrome = tmp_path / "chrome.json"
    assert report_main([str(path), "--chrome", str(chrome)]) == 0
    assert any(e.get("ph") == "X"
               for e in json.loads(chrome.read_text())["traceEvents"])


# ------------------------------------------- the tick from inside --

def _spans(tracer, name, phase=None):
    return [r for r in tracer.records if r.get("type") == "span"
            and r["name"] == name
            and (phase is None or r["attrs"].get("phase") == phase)]


def _events(tracer, name):
    return [r for r in tracer.records
            if r.get("type") == "event" and r["name"] == name]


def test_reset_spans_are_the_admission_ticks_and_the_replays(chaos):
    tracer = chaos[2]
    resets = _spans(tracer, "call", "reset")
    admit_ticks = {r["tick"] for r in _events(tracer, "admit")}
    replays = _events(tracer, "replay")
    assert len(resets) == len(admit_ticks) + len(replays)
    assert sorted(r["tick"] for r in resets
                  if r["attrs"]["cause"] == "admit") == sorted(admit_ticks)
    assert sorted((r["tick"], r["attrs"]["participants"]) for r in resets
                  if r["attrs"]["cause"] == "quarantine") == \
        sorted((r["tick"], [r["attrs"]["slot"]]) for r in replays)
    for r in resets:
        assert r["attrs"]["kind"] == "reset" and r["attrs"]["ok"] is True
        assert r["attrs"]["arch"] == tracer.records[0]["arch"]


def test_reset_spans_lie_inside_their_ticks(chaos):
    tracer = chaos[2]
    ticks = {r["tick"]: r for r in _spans(tracer, "tick")}
    resets = _spans(tracer, "call", "reset")
    assert resets
    for r in resets:
        t = ticks[r["tick"]]
        assert t["ts_us"] <= r["ts_us"]
        assert r["ts_us"] + r["dur_us"] <= t["ts_us"] + t["dur_us"]
    # both packages validate the trace that holds them
    only = [tracer.records[0]] + [r for r in tracer.records[1:]
                                  if r.get("type") != "span"
                                  or r["name"] == "tick" or r in resets]
    assert validate(only) == ref_validate(only)


def test_every_call_span_has_its_enqueue_point(chaos):
    calls = _spans(chaos[2], "call")
    assert {r["attrs"]["phase"] for r in calls} == {"reset", "prefill",
                                                    "decode"}
    for r in calls:
        assert 0 <= r["attrs"]["enqueued_us"] <= r["dur_us"]
        # a reset span closes at its enqueue point
        if r["attrs"]["phase"] == "reset":
            assert r["dur_us"] - r["attrs"]["enqueued_us"] < 1e4
        # no CUDA event on the CPU
        assert "device_us" not in r["attrs"]


def test_prefill_rows_valid_are_the_cursor_advances(chaos):
    """rows = slots x chunk; rows_valid = what the chunk call's slots
    advanced their cursors by, read from the "prefill" events (a slot
    quarantined by the call advances none, so such a call reads more)."""
    tracer = chaos[2]
    cursor, advance = {}, {}
    for r in tracer.records:
        if r.get("type") != "event":
            continue
        s = r["attrs"].get("slot")
        if r["name"] in ("admit", "replay"):
            cursor[s] = 0
        elif r["name"] == "prefill":
            advance.setdefault(r["tick"], {})[s] = \
                r["attrs"]["cursor"] - cursor[s]
            cursor[s] = r["attrs"]["cursor"]
    exact = 0
    for r in _spans(tracer, "call", "prefill"):
        a = r["attrs"]
        assert a["rows"] == N_SLOTS * CHUNK
        assert 1 <= a["rows_valid"] <= a["rows"]
        if not a["ok"]:
            continue
        got = advance.get(r["tick"], {})
        if sorted(got) == a["participants"]:
            assert a["rows_valid"] == sum(got.values())
            exact += 1
        else:
            assert a["rows_valid"] > sum(got.values())
    assert exact >= 5


def test_tick_phases_fit_in_the_tick(chaos):
    tracer = chaos[2]
    calls = {}
    for r in _spans(tracer, "call"):
        calls[r["tick"]] = calls.get(r["tick"], 0.0) + r["dur_us"]
    for t in _spans(tracer, "tick"):
        a = t["attrs"]
        phases = [a["admit_us"], a["assemble_us"], a["sample_us"]]
        assert min(phases) >= 0
        assert sum(phases) <= t["dur_us"]
        # outside every call span: with the calls, within the tick
        assert sum(phases) + calls.get(t["tick"], 0.0) <= t["dur_us"] + 1e-6
    assert any(t["attrs"]["assemble_us"] > 0
               for t in _spans(tracer, "tick"))


def _profiled(served, tracer):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine, out = _run(served, tracer=tracer)
    return engine, out, [e.name for e in prof.events()]


def test_profiler_ranges_hold_the_engine_spans(served):
    tracer = Tracer()
    _, out, names = _profiled(served, tracer)
    assert names.count("engine.tick") == len(_spans(tracer, "tick"))
    for phase in ("decode", "prefill", "reset"):
        assert names.count(f"engine.call.{phase}") == \
            len(_spans(tracer, "call", phase)) > 0
    # no tracer under the profiler: no engine range, the same streams
    _, bare, names = _profiled(served, None)
    assert bare == out
    assert not [n for n in names if n.startswith("engine.")]


def test_no_profiler_opens_no_range(served, monkeypatch):
    import torch
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        Counting)
    tracer = Tracer()
    _run(served, tracer=tracer)
    assert _spans(tracer, "tick") and opened == []


def test_annotate_adds_to_a_closed_span_until_dump(tmp_path):
    tr = Tracer()
    t = tr.begin("tick", 0)
    c = tr.begin("call", 0, phase="decode")
    with pytest.raises(TraceError):
        tr.annotate(c, device_us=1.0)       # still open: give it to end
    tr.end(c, enqueued_us=1.0)
    tr.end(t)
    tr.annotate(c, device_us=2.5)
    path = tmp_path / "a.jsonl"
    tr.dump(str(path))
    assert load(str(path))[2]["attrs"]["device_us"] == 2.5
    with pytest.raises(TraceError):
        tr.annotate(c, device_us=3.0)
    assert validate(tr.records) == ref_validate(tr.records)


def test_device_times_read_completed_events_only(monkeypatch):
    """The card's device clock of a call, with fake events: a pair is read
    into ``device_us`` once its end event has completed, a pending one at
    a later read, and read pairs are reused."""
    import torch

    from repro_torch.serving.engine import _DeviceTimes
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at, self.done = None, False
            made.append(self)

        def record(self, stream=None):
            self.at = len(made) + 0.5 * sum(e.at is not None for e in made)

        def query(self):
            return self.done

        def elapsed_time(self, end):
            return end.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    tr = Tracer()
    times = _DeviceTimes(torch.device("cuda"))
    spans = []
    for phase in ("reset", "decode"):
        spans.append(tr.begin("call", 0, phase=phase))
        times.start()
        times.stop(spans[-1])
        tr.end(spans[-1])
    made[1].done = True                   # the reset's end event
    times.read(tr)
    assert spans[0]["attrs"]["device_us"] == 1e3 * (made[1].at - made[0].at)
    assert "device_us" not in spans[1]["attrs"]
    made[3].done = True
    times.read(tr)
    assert "device_us" in spans[1]["attrs"] and not times._pending
    times.start()                         # a pair from the pool
    assert len(made) == 4


def test_paged_preempting_run_validates():
    """A traced tight-pool paged run preempts, and its "preempt" events
    validate."""
    from repro_torch.models import init_params
    cfg = get_config("tinyllama-1.1b", reduced=True).scaled(dtype="float32")
    tracer = Tracer(arch=cfg.name)
    engine = ServeEngine(cfg, init_params(cfg, device="cpu"), n_slots=3,
                         max_len=24, prefill_chunk=4, paged=True,
                         page_size=4, n_pages=8, tracer=tracer,
                         device="cpu")
    engine.run(make_trace(WorkloadSpec(
        n_requests=10, arrival_rate=1.0, prompt_len=(3, 10),
        gen_len=(3, 6), dist="uniform", seed=7), cfg.vocab_size))
    preempts = _events(tracer, "preempt")
    assert preempts and len(preempts) == \
        engine.metrics.summary()["n_preemptions"]
    assert validate(tracer.records)["events"] >= len(preempts)
    assert "preempt" in render(tracer.records)


# -------------------------------------------------------- the recorder --

def _drive(rec, seed):
    """A seeded sequence of every recorder event, the same for any
    recorder."""
    rng = np.random.default_rng(seed)
    rec.start()
    for rid in range(12):
        dl = None if rid % 3 else float(rng.integers(5, 40))
        if rid % 5 == 4:
            rec.on_reject(rid, 9, 4, float(rid), "queue_full", deadline=dl)
            continue
        rec.on_submit(rid, int(rng.integers(1, 30)), 4, float(rid),
                      deadline=dl)
    rec.on_reject(2, 3, 3, 0.0, "duplicate_rid")
    live = [r for r in rec.requests if rec.requests[r].outcome is None]
    for tick in range(30):
        rec.on_tick(tick, queue_depth=int(rng.integers(0, 5)),
                    n_prefilling=int(rng.integers(0, 3)),
                    n_decoding=int(rng.integers(0, 3)), device_calls=2)
        for call, kind in (("prefill", "prefill_chunk_exact"),
                           ("decode", "decode")):
            rec.on_device_call(call, kind=kind, replay=bool(tick % 7 == 3),
                               dur_s=float(rng.lognormal(-6, 1)))
        if tick < len(live):
            rid = live[tick]
            rec.on_admit(rid, tick, skips=int(rng.integers(0, 3)))
            rec.on_prefill_step(rid)
            rec.on_first_token(rid, tick + 1)
            rec.on_token(rid)
            if tick % 4 == 1:
                rec.on_shed(rid, tick + 2, "deadline")
            elif tick % 4 == 2:
                rec.on_fault("nonfinite_logits", rid, tick)
                rec.on_replay(rid)
                rec.on_done(rid, tick + 5)
            else:
                rec.on_done(rid, tick + 3)
        if tick % 6 == 0:
            rec.on_fault("step_exception", None, tick)
            rec.on_retry("decode")
        if tick % 9 == 0:
            rec.on_straggler(tick)
            rec.on_preempt(live[0], tick)
            rec.on_alloc_failure()
    rec.record_slot_log([(0, 0, 5), (1, 2, None), (0, 5, 9)], 2)
    rec.stop()
    return rec


WALL = ("wall_s", "tokens_per_sec", "per_token_latency_ms")


def _no_wall(summary):
    return {k: v for k, v in summary.items() if k not in WALL}


@pytest.mark.parametrize("seed", [0, 1])
def test_recorders_agree_and_state_dicts_cross_load(seed):
    mine, ref = _drive(MetricsRecorder(), seed), _drive(RefRecorder(), seed)
    assert _no_wall(mine.summary()) == _no_wall(ref.summary())
    assert mine.per_request() == ref.per_request()
    sd, ref_sd = mine.state_dict(), ref.state_dict()
    assert {k: v for k, v in sd.items() if k != "wall"} == \
        {k: v for k, v in ref_sd.items() if k != "wall"}
    # a port state dict (through JSON) into the reference recorder and back
    loaded = RefRecorder()
    loaded.load_state_dict(json.loads(json.dumps(sd)))
    assert loaded.summary() == mine.summary()
    back = MetricsRecorder()
    back.load_state_dict(json.loads(json.dumps(ref_sd)))
    assert back.summary() == ref.summary()


# ------------------------------------------------------------- the CLI --

def test_serve_cli_writes_a_trace_the_report_renders(tmp_path, capsys):
    from repro_torch.launch import serve
    path = tmp_path / "serve.jsonl"
    out = serve.main(["--arch", "tinyllama-1.1b", "--reduced",
                      "--dbpim-mode", "joint", "--device", "cpu",
                      "--requests", "6", "--max-len", "32", "--gen-len", "4",
                      "--prompt-len", "2", "12", "--prefill-chunk", "4",
                      "--schedule", "spf", "--spf-age-cap", "2",
                      "--deadline-slack", "14", "--queue-cap", "5",
                      "--gen-dist", "bimodal", "--fault-rate", "0.3",
                      "--fault-seed", "1", "--fault-ticks", "60",
                      "--max-step-retries", "1", "--max-replays", "2",
                      "--trace-out", str(path)])
    said = capsys.readouterr().out
    assert "fault plan:" in said and "goodput" in said
    assert f"-> {path}" in said and out
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                          str(path), "--chrome", str(tmp_path / "c.json")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    for section in ("TIMELINE", "SLOTS", "QUEUE DEPTH",
                    "WEIGHT-TRAFFIC WATERFALL", "FAULTS"):
        assert f"== {section}" in res.stdout
    records = load(str(path))
    assert validate(records)["waterfalls"] == 2
    assert res.stdout.startswith(ref_render(records))
