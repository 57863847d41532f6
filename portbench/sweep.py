"""Find an open-loop cell's knee once, on the chip:

    python3 portbench/sweep.py --workload <cell> --seconds 15 \
        --rates 8 12 16 20 24

builds the cell's engine once and offers its mix at each rate (requests
a second) for ``--seconds``, draining the engine empty between rates.
Per rate it prints the requests due, their first tokens' p50 / p95, the
token gap's p95, and the queue: requests waiting at the window's middle
and at its end. The knee is the highest rate whose queue does not grow;
the cell's mix then states four fifths of it as ``rate_per_s``.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402
from portbench.harness import drive, stats  # noqa: E402
from portbench.harness.traffic import Stream  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep.py needs a CUDA card", file=sys.stderr)
        return 2
    run._card_lines(torch)
    cell = run.manifest.cell(run.manifest.load(), args.workload)
    cfg, engine, _, _ = run.build(cell, args.seed, torch.device("cuda"),
                                  False)
    base = 0
    for i, rate in enumerate(args.rates):
        mix = copy.deepcopy(cell["traffic"])
        mix["rate_per_s"] = rate
        stream = Stream(mix, args.seed + i, cfg.vocab_size, args.seconds)
        orig = stream.request
        stream.request = lambda k, c=-1, o=orig, b=base: _shift(o(k, c), b)
        win = drive.run(engine, stream, mix, args.seconds, False,
                        cfg.vocab_size)
        base += len(win.reqs) + 1
        due = [r for r in win.reqs if win.w0 <= r.due <= win.w1]
        mid = win.w0 + args.seconds / 2
        waiting = [sum(1 for r in due if r.due <= t and
                       (r.first is None or r.first > t))
                   for t in (mid, win.w1)]
        ttft = [r.first - r.due for r in due if r.first is not None]
        gaps = []
        for r in due:
            times = run.token_times(r)
            gaps += [b - a for a, b in zip(times, times[1:])]
        print(f"rate {rate}/s: {len(due)} due, ttft p50 "
              f"{1e3 * stats.percentile(ttft, 50):.1f} p95 "
              f"{1e3 * stats.percentile(ttft, 95):.1f} ms, itl p95 "
              f"{1e3 * (stats.percentile(gaps, 95) or 0):.1f} ms, waiting "
              f"for a first token at mid / end {waiting}, drain "
              f"{win.drain_s:.2f} s", flush=True)
        t0 = time.perf_counter()
        while engine.queue or any(s.rid is not None for s in engine.slots):
            engine.tick()
        print(f"  emptied in {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


def _shift(req, base):
    req.index += base
    return req


if __name__ == "__main__":
    sys.exit(main())
