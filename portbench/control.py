"""Readings for a cell's correctness limit, on the chip, in one process:

    python3 portbench/control.py --workload <cell> --seconds 10 \
        --seeds 1 2 3

For each seed a short run of the cell as the benchmark makes it (the
window at the cell's own load, then the sample), and on the same prompts
and served tokens both the program's widest gap and the float8
control's: at each position the gap of the token the reference computed
in float8 e4m3 puts first. A limit lies above every sound reading and
below the control's. Prints one JSON line a seed; the benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    run._card_lines(torch)
    cell = run.manifest.cell(run.manifest.load(), args.workload)
    for seed in args.seeds:
        r = run.execute(cell, seed, args.seconds, False, torch.device("cuda"),
                        control=True)
        print(json.dumps({"seed": seed,
                          "program_gap": r.get("program_gap"),
                          "control_gap": r.get("control_gap"),
                          "served_tokens": r["compared"]["served_tokens"][
                              "value"], "metrics": r["metrics"]}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
