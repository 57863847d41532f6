"""The readers of the engine's traced readings, on a synthetic run: the
tracer's records of two ticks and a device window whose idle gaps fall
where the hand-worked values below put them."""

import pytest

from portbench.harness import manifest
from portbench.harness.drive import Window
from portbench.harness.profile import DeviceWindow
from portbench.harness.readings import Run

T0 = 100.0          # the tracer's clock zero on the host clock


def _span(name, tick, ts_us, dur_us, **attrs):
    return {"type": "span", "name": name, "tick": tick, "ts_us": ts_us,
            "dur_us": dur_us, "attrs": attrs}


def _records():
    """Tick 0: a reset (device 12 ms), a prefill call waiting on the
    device over [3.0, 7.0] ms and a decode call over [8.0, 9.5] ms; tick
    1: a second reset (device 8 ms) and a prefill call. µs since T0."""
    return [
        {"type": "meta", "version": 1, "arch": "test"},
        _span("tick", 0, 0.0, 9800.0),
        _span("call", 0, 1000.0, 500.0, phase="reset", enqueued_us=490.0,
              device_us=12000.0),
        _span("call", 0, 2000.0, 5000.0, phase="prefill", enqueued_us=1000.0,
              rows=12, rows_valid=3),
        _span("call", 0, 7500.0, 2000.0, phase="decode", enqueued_us=500.0),
        _span("tick", 1, 9800.0, 5000.0),
        _span("call", 1, 9900.0, 100.0, phase="reset", enqueued_us=100.0,
              device_us=8000.0),
        _span("call", 1, 10100.0, 3000.0, phase="prefill", enqueued_us=900.0,
              rows=12, rows_valid=6),
    ]


def _device():
    """10 ms of device window from T0: kernels over [0, 2.5], [4.0, 7.2],
    [7.9, 8.5] and [8.9, 10.0] ms. Idle: [2.5, 4.0] (the prefill call's
    wait), [7.2, 7.9] (the decode call before its enqueue point: the
    host's) and [8.5, 8.9] (the decode call's wait)."""
    d = DeviceWindow()
    d.t0, d.t1 = T0, T0 + 0.010
    d.window_s = 0.010
    d.records = [("k", T0 + a * 1e-3, T0 + b * 1e-3)
                 for a, b in ((0.0, 2.5), (4.0, 7.2), (7.9, 8.5),
                              (8.9, 10.0))]
    d.busy_s = 0.0074
    return d


def _run(records=None, device=True):
    win = Window(T0, T0 + 1.0, [])
    win.device = _device() if device else None
    return Run(win=win, costs=None, slots=3, chunk=4,
               records=_records() if records is None else records,
               trace_t0=T0, joint_symbols=(), attention_symbols=())


def read(name, run):
    return manifest.reader(name)(run)


def test_reset_call_ms_is_the_mean_reset_device_time():
    assert read("reset_call_ms", _run()) == pytest.approx(10.0)


def test_reset_call_ms_without_a_reset_span_is_none():
    records = [r for r in _records()
               if r.get("attrs", {}).get("phase") != "reset"]
    assert read("reset_call_ms", _run(records)) is None
    # reset spans without device_us (the CPU): None as well
    records = _records()
    for r in records[1:]:
        r["attrs"].pop("device_us", None)
    assert read("reset_call_ms", _run(records)) is None


@pytest.mark.parametrize("name", ["idle_host.tput", "idle_host.chat"])
def test_idle_host_counts_the_gaps_outside_the_waits(name):
    run = _run()
    # [7.2, 7.9] ms alone: 0.7 of 10 ms; the two gaps inside a call's
    # wait are the steps' own
    assert read(name, run) == pytest.approx(7.0)
    assert run.idle_pct() == pytest.approx(26.0)
    assert read(name, run) <= read("idle_share.tput", run)


def test_idle_host_gap_in_a_wait_moves_to_the_host_without_it():
    """The same records with the prefill call enqueued at its end: the
    gap over [2.5, 4.0] ms becomes the host's."""
    records = _records()
    records[3]["attrs"]["enqueued_us"] = 5000.0
    assert read("idle_host.tput", _run(records)) == pytest.approx(22.0)


def test_prefill_valid_share_sums_rows():
    assert read("prefill_valid_share", _run()) == pytest.approx(37.5)


def test_parent_program_records_read_none():
    """A tracer with none of the new attrs (a program without them): every
    new reader gives None and raises nothing."""
    records = _records()
    for r in records[1:]:
        for k in ("enqueued_us", "device_us", "rows", "rows_valid"):
            r["attrs"].pop(k, None)
    run = _run(records)
    for name in ("idle_host.tput", "idle_host.chat", "prefill_valid_share",
                 "reset_call_ms"):
        assert read(name, run) is None
    assert read("idle_host.tput", _run(device=False)) is None


def test_spans_outside_the_window_are_not_read():
    records = _records()
    for r in records[1:]:
        r["ts_us"] += 2e6              # two seconds late: past the window
    run = _run(records)
    assert read("reset_call_ms", run) is None
    assert read("prefill_valid_share", run) is None
