"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Builds the cell's configuration from seeded
slices on the card through the port's packing entry points, builds the
port's ``ServeEngine`` (joint mode, bf16, CUDA graphs) at the mix's
geometry, captures every step the window uses (set-up ends there), drives
the engine through ``submit`` and ``tick`` for ``--seconds`` under the
cell's traffic, then checks the served tokens against the plain float32
reference (``portbench/reference``) and prints one JSON line last on
standard output. ``--trace 1`` adds the engine's tracer and
torch.profiler over a stretch of whole ticks and reports the cell's
per-layer metrics (``metrics/<name>.py``) instead of its end-to-end ones.

Exits non-zero without a result when there is no card, or when JAX, flax
or the JAX package (``repro``) is loaded once the window has closed.
Kernels build into the program's ``build/repro_torch/`` in the checkout;
other caches go under ``build/`` there too.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment():
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


_environment()

from portbench.harness import (check, drive, manifest, program,  # noqa: E402
                               readings, stats)
from portbench.harness.cost import Costs  # noqa: E402
from portbench.harness.traffic import Stream  # noqa: E402


def log(msg: str):
    print(f"[{time.perf_counter() - T_START:8.2f}] {msg}", flush=True)


def _card_lines(torch):
    log(f"card: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e})"
    log(f"nvidia-smi: {smi}")


def token_times(req):
    return [t for t, n in req.stamps for _ in range(n)]


def end_to_end(win, setup_s: float) -> dict:
    """The end-to-end metrics of a window."""
    w0, w1 = win.w0, win.w1
    due = [r for r in win.reqs if w0 <= r.due <= w1]
    tokens = sum(n for r in win.reqs for t, n in r.stamps if w0 < t <= w1)
    ttft = [r.first - r.due for r in due if r.first is not None]
    gaps = []
    for r in win.reqs:
        times = token_times(r)
        gaps += [b - a for a, b in zip(times, times[1:]) if w0 < b <= w1]
    ticks = [e - s for _, s, e in win.ticks if w0 < e <= w1]
    log(f"samples: {len(due)} requests due in the window, {len(ttft)} "
        f"first tokens, {len(gaps)} token gaps, {tokens} tokens; drain "
        f"{win.drain_s:.3f} s; {len(ticks)} ticks in the window, ms p50 / "
        f"p95 / p99 / max " + " / ".join(
            f"{1e3 * (stats.percentile(ticks, q) or 0):.2f}"
            for q in (50, 95, 99, 100)))
    p95 = stats.percentile
    return {"tokens_per_s": (tokens / (w1 - w0), "tokens/s"),
            "ttft_p95_ms": (None if not ttft else 1e3 * p95(ttft, 95), "ms"),
            "itl_p95_ms": (None if not gaps else 1e3 * p95(gaps, 95), "ms"),
            "setup_s": (setup_s, "s")}


def _host_label(calls, ticks):
    """label(t): what the host was doing at t, by the engine's call spans
    and the harness's tick stamps."""
    import bisect
    calls = sorted((s, s + d, f"engine.call.{a.get('phase')}")
                   for s, d, a in calls)
    ticks = sorted((s, e, "engine.tick") for _, s, e in ticks)
    starts = ([c[0] for c in calls], [t[0] for t in ticks])

    def label(t):
        for spans, st in zip((calls, ticks), starts):
            i = bisect.bisect_right(st, t) - 1
            if i >= 0 and spans[i][1] >= t:
                return spans[i][2]
        return "harness"
    return label


def build(cell: dict, seed: int, device, trace: bool):
    """The cell's engine, warmed up: (cfg, engine, tracer, set-up s)."""
    import torch

    from repro_torch.obs import Tracer
    from repro_torch.serving import ServeEngine

    spec, geo = cell["config"], cell["traffic"]["engine"]
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    cfg, params, tables = program.build(spec, seed, device)
    if cuda:
        torch.cuda.synchronize()
    log(f"{cfg.name}: built from seed {seed} in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{program.table_bytes(tables) / 1e9:.3f} GB of packs")
    tracer = Tracer(arch=cfg.name) if trace else None
    engine = ServeEngine(cfg, params, n_slots=geo["slots"],
                         max_len=geo["max_len"],
                         prefill_chunk=geo["prefill_chunk"],
                         stacked_tables=tables, tracer=tracer, device=device)
    del params, tables
    t1 = time.perf_counter()
    drive.warm_up(engine, cfg.vocab_size, geo["prefill_chunk"])
    if cuda:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        log(f"warm-up {time.perf_counter() - t1:.2f} s (captures: "
            f"{engine.sentinel.counts()}); resident {resident} B")
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s; prefill {engine.prefill_mode}")
    return cfg, engine, tracer, setup_s


def execute(cell: dict, seed: int, seconds: float, trace: bool, device,
            control: bool = False) -> dict:
    """One run of ``cell`` (``manifest.cell``) on ``device``: the result
    line's keys, ``compared`` last. ``control`` also reads the float8
    control's gap on the same sample (never in a benchmark run)."""
    import torch

    from repro_torch.kernels import joint_sparse_matmul, row_attention

    spec, mix, limits = cell["config"], cell["traffic"], cell["limits"]
    geo = mix["engine"]
    cuda = device.type == "cuda"
    cfg, engine, tracer, setup_s = build(cell, seed, device, trace)
    dev_window = None
    if trace and cuda:
        from portbench.harness.profile import DeviceWindow
        dev_window = DeviceWindow()
        dev_window.prime()
    stream = Stream(mix, seed, cfg.vocab_size, seconds)
    win = drive.run(engine, stream, mix, seconds, trace, cfg.vocab_size,
                    dev_window)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    due = [r for r in win.reqs if win.w0 <= r.due <= win.w1]
    failed = sum(1 for r in due if r.rejected or r.first is None)
    e2e = end_to_end(win, setup_s)
    result = {"correct": False, "attempted": len(due), "failed": failed}
    breakdown = None
    if trace:
        run = readings.Run(
            win=win, costs=Costs(spec, geo["slots"]),
            slots=geo["slots"], chunk=geo["prefill_chunk"],
            records=tracer.records, trace_t0=tracer._wall0,
            joint_symbols=joint_sparse_matmul.SYMBOLS,
            attention_symbols=row_attention.SYMBOLS)
        metrics = {}
        for m in cell["per_layer"]:
            v = manifest.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        d = run.device()
        if d is None and win.device is not None:
            log(f"traced window not read: {win.device.n_pads} spin and "
                f"{win.device.n_recs} other device records")
        if d is not None:
            log(f"traced window: {d.window_s:.6f} s on the device "
                f"({d.t1 - d.t0:.6f} s host), busy {d.busy_s:.6f} s, "
                f"{len(d.records)} records, ticks {win.prof_ticks}; "
                f"profiler start {d.start_s:.3f} s, stop {d.stop_s:.3f} s")
            label = _host_label(run.spans("call"), win.ticks)
            breakdown = {"device_ops": d.top_ops(),
                         "idle_gaps": d.idle_gaps(label)}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]][0],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]
                   if e2e[m["name"]][0] is not None}
    for k, v in e2e.items():
        log(f"{k} {v[0]} {v[1]}")
    picked = check.sample(win.reqs, seed, limits["sample_requests"])
    outputs = {r.index: list(engine.outputs[r.index]) for r in picked}
    del engine, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    got, n, ctl = {}, 0, None
    if picked:
        got, n, ctl = check.token_gaps(spec, seed, picked, outputs, device,
                                       control)
    log(f"reference: {len(picked)} requests from "
        f"{len({r.slot for r in picked})} slots, {n} served tokens compared "
        f"in {time.perf_counter() - t2:.2f} s; gaps {got}, control {ctl}")
    compared = {}
    for k in check.NUMBERS:
        if k in limits:
            v = got.get(k)
            compared[k] = {"value": v if v is not None and math.isfinite(v)
                           else None, "limit": limits[k]}
    result["correct"] = bool(compared) and n >= 1 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values())
    compared["served_tokens"] = {"value": n, "limit": "at least 1"}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace and win.device is not None and win.device.window_s:
        result["device"]["busy_s"] = win.device.busy_s
        result["device"]["window_s"] = win.device.window_s
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control_gap"] = ctl
        result["program_gap"] = got
    result["compared"] = compared
    return result


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()} "
              f"(cuda available: {torch.cuda.is_available()})",
              file=sys.stderr)
        return 2
    _card_lines(torch)
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda"))
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: loaded {leaked} in the measuring process",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
