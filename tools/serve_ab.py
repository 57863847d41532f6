"""Serve the same traces with two trees of this repository on one card, in
turns, through the port's serve CLI's engine.

    python3 tools/serve_ab.py --other build/parent

``--other`` is another checkout (for example the parent commit unpacked
with ``git archive`` into ``build/``, which git ignores). Each cell builds
the engine and trace of ``python -m repro_torch.launch.serve``
(``serve.build_engine_and_trace``: ``--arch``, tinyllama-1.1b by default,
or mamba2-1.3b, at full width, joint mode, random weights from seed 0)
with each tree's own code and serves the trace, in the turns other, this,
this, other, one process per run, each tree's kernels built before its
first run is timed:

  * short: batch 4, max-len 512, 8 requests, prompts U[32, 256], 32
    generated tokens, prefill chunks of 64 (``chip_smoke.py``'s serve
    phase);
  * long: the long-context cell, batch 16, max-len 2048 (the model's
    context), 32 requests, prompts U[256, 1536], 32 generated tokens,
    chunks of 256.

Each run reports the CLI's numbers: tokens/s, the decode and prefill-chunk
call p50 and mean (log-bucketed histograms; the prefill calls under the
engine's ``prefill_kind``, which the run also reports), the recompile
sentinel's
counts where the tree has one; and the peak device memory of the serve
run itself (the peak is reset after the params and packed tables are
built, which the CLI's own figure includes) beside the memory resident
when it starts. A run that fails fails the whole command. The card's
name and power limit are printed first, then a line per run, then the
whole result as one JSON object on the last line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

COMMON = ["--dbpim-mode", "joint", "--gen-len", "32", "--seed", "0"]
CELLS = {
    "short": ["--batch", "4", "--max-len", "512", "--requests", "8",
              "--prompt-len", "32", "256", "--prefill-chunk", "64"],
    "long": ["--batch", "16", "--max-len", "2048", "--requests", "32",
             "--prompt-len", "256", "1536", "--prefill-chunk", "256"],
}
KERNELS = ("joint_sparse_matmul", "block_sparse_matmul", "fta_int8_matmul",
           "dbmu_matmul", "row_attention", "row_norm")
#: one run, in a process of its own with one tree's src on its path
RUN_SCRIPT = r"""
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.launch import serve
build.build_all(%r)
args = serve.build_parser().parse_args(sys.argv[1:])
cfg = get_config(args.arch, reduced=args.reduced, dbpim_mode=args.dbpim_mode,
                 prefill_exact=getattr(args, "prefill_exact", False) or None)
engine, trace, _ = serve.build_engine_and_trace(args, cfg)
kind = getattr(engine, "prefill_kind", "prefill_chunk_exact")
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
resident = torch.cuda.memory_allocated()
engine.run(trace)
torch.cuda.synchronize()
s = engine.metrics.summary()
lat = s["call_latency_ms"]
sentinel = getattr(engine, "sentinel", None)
print(json.dumps({
    "tokens_per_s": s["tokens_per_sec"],
    "decode_p50_ms": lat["decode"]["p50_ms"],
    "decode_mean_ms": lat["decode"]["mean_ms"],
    "prefill_kind": kind,
    "prefill_p50_ms": lat[kind]["p50_ms"],
    "prefill_mean_ms": lat[kind]["mean_ms"],
    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    "resident_gib": resident / 2 ** 30,
    "sentinel": None if sentinel is None else sentinel.counts()}))
""" % (KERNELS,)


def run(root: Path, cell: str, arch: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", RUN_SCRIPT, "--arch", arch,
                           *COMMON, *CELLS[cell]], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"serve run failed in {root} ({arch} {cell}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other tree")
    ap.add_argument("--cells", nargs="+", default=list(CELLS),
                    choices=list(CELLS))
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help="the served model, at full width")
    args = ap.parse_args(argv)
    this = Path(__file__).resolve().parents[1]
    other = args.other.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    result = {"card": smi, "arch": args.arch, "runs": []}
    for cell in args.cells:
        for turn, (tree, root) in enumerate((("other", other),
                                             ("this", this), ("this", this),
                                             ("other", other))):
            r = run(root, cell, args.arch)
            r.update(cell=cell, tree=tree, turn=turn)
            result["runs"].append(r)
            print(f"[serve_ab] {cell} turn {turn} {tree}: "
                  f"{r['tokens_per_s']:.1f} tok/s, decode p50 "
                  f"{r['decode_p50_ms']:.2f} mean {r['decode_mean_ms']:.2f} "
                  f"ms, {r['prefill_kind']} p50 {r['prefill_p50_ms']:.2f} "
                  f"mean {r['prefill_mean_ms']:.2f} ms, serve-run peak "
                  f"{r['peak_gib']:.3f} GiB (resident at start "
                  f"{r['resident_gib']:.3f}); sentinel {r['sentinel']}",
                  flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
