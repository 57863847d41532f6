"""Time two trees' versions of the port's matmul kernels on one card, in turns.

    python3 tools/kernel_ab.py --other build/parent

``--other`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into ``build/``, which git ignores).
For ``dbmu_matmul`` and ``fta_int8_matmul``, both trees'
``src/repro_torch/kernels/csrc/<name>.cu`` are compiled by
nvcc with the port's flags into ``build/kernel_ab/``, all builds at once,
and both versions are called through their C entry points, which have the
same signature in both trees, on the same inputs: the work units of
``chip_smoke.py``'s times phase.

  * dbmu_matmul: the four tinyllama-1.1b projection shapes at M = 256,
    weights through the DB-PIM pipeline (block pruning at 0.6, alpha 8,
    FTA, dyadic terms), x uniform over the int8 range.
  * fta_int8_matmul: one full-width layer's seven projections at M = 256,
    bf16 x, bf16 out, INT8/FTA weights with per-filter scales.

Each version's outputs are first held against the plain version (DBMU bit
for bit; FTA/INT8 within one bf16 ulp of the peak); a version that
disagrees fails the run. Then, in the turns other, this, this, other,
each shape is timed with CUDA events over back-to-back launches and in
device time from torch.profiler's device-side records, with the clocks of
``chip_smoke.py``'s times phase. The card's name and power limit are
printed first, then a line per kernel and turn, then the whole result as
one JSON object on the last line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import _device_ms, _time  # noqa: E402

SHAPES = {"dbmu_matmul": [("wq", 2048, 2048), ("wk", 2048, 256),
                          ("w_gate", 2048, 5632), ("w_down", 5632, 2048)],
          "fta_int8_matmul": [("wq", 2048, 2048), ("wk", 2048, 256),
                              ("wv", 2048, 256), ("wo", 2048, 2048),
                              ("w_gate", 2048, 5632), ("w_up", 2048, 5632),
                              ("w_down", 5632, 2048)]}
M = 256
ORDER = ("other", "this", "this", "other")
ITERS = 20


def _build(trees, names):
    """{(label, name): loaded library}: one nvcc per (tree, kernel), all
    started together."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, tree in trees.items():
        for name in names:
            src = tree / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
            lib = out_dir / f"{label}-{name}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
            procs[(label, name)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def _entry(lib, name):
    fn = getattr(lib, f"{name}_launch")
    n_ptr = 3 if name == "dbmu_matmul" else 4
    n_int = 3 if name == "dbmu_matmul" else 5
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cases(name, dev, gen):
    """Per shape: (label, K, N, inputs, output, the launch arguments after
    the pointers, the plain version's output)."""
    from repro_torch.core import pruning
    from repro_torch.kernels import dbmu_sim, ops
    from repro_torch.kernels import fta_int8_matmul as ftk
    cases = []
    for label, K, N in SHAPES[name]:
        w = torch.randn((K, N), generator=gen) * K ** -0.5
        if name == "dbmu_matmul":
            _, _, packed, _ = ops.fta_pack(
                w, pruning.block_prune_mask(w, 0.6, alpha=8))
            x = torch.randint(-128, 128, (M, K), generator=gen,
                              dtype=torch.int32)
            x, packed = x.to(dev), packed.to(dev)
            y = torch.empty((M, N), dtype=torch.int32, device=dev)
            cases.append(dict(label=label, K=K, N=N, ptrs=(x, packed, y),
                              ints=(M, K, N), y=y,
                              want=dbmu_sim.dbmu_matmul_plain(x, packed)))
        else:
            q, sc = ops.quantize_int8_fta(w, torch.ones((K, N),
                                                        dtype=torch.int32))
            q, sc = q.to(torch.int8).to(dev), sc.to(dev)
            x = torch.randn((M, K), generator=gen).to(torch.bfloat16).to(dev)
            y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
            cases.append(dict(label=label, K=K, N=N, ptrs=(x, q, sc, y),
                              ints=(M, K, N, 1, 1), y=y,
                              want=ftk.fta_int8_matmul_plain(x, q, sc)))
    return cases


def _launcher(fn, case):
    args = [t.data_ptr() for t in case["ptrs"]] + list(case["ints"])

    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return run


def _check(name, version, case, run):
    run()
    torch.cuda.synchronize()
    got, want = case["y"], case["want"]
    if name == "dbmu_matmul":
        ok = torch.equal(got, want)
    else:
        peak = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= 2.0 ** (math.floor(math.log2(peak)) - 7)
    if not ok:
        raise AssertionError(f"{version} {name} {case['label']} disagrees "
                             f"with the plain version")


def _us(ms):
    return "n/a" if ms is None else f"{ms * 1e3:.1f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    trees = {"this": ROOT, "other": args.other.resolve()}
    t0 = time.monotonic()
    libs = _build(trees, list(SHAPES))
    print(f"built {len(libs)} libraries in {time.monotonic() - t0:.2f} s",
          flush=True)
    dev = torch.device("cuda")
    result = {"card": smi, "order": ORDER, "M": M, "kernels": {}}
    for name in SHAPES:
        cases = _cases(name, dev, torch.Generator().manual_seed(11))
        runs = {v: [_launcher(_entry(libs[(v, name)], name), c) for c in cases]
                for v in trees}
        for v in trees:
            for c, run in zip(cases, runs[v]):
                _check(name, v, c, run)
        turns = []
        for v in ORDER:
            rows = [dict(shape=c["label"], K=c["K"], N=c["N"],
                         event_ms=_time(run, iters=ITERS, warmup=3),
                         device_ms=_device_ms(run, iters=ITERS))
                    for c, run in zip(cases, runs[v])]
            dev_tot = None if any(r["device_ms"] is None for r in rows) \
                else sum(r["device_ms"] for r in rows)
            turns.append(dict(version=v, rows=rows,
                              event_ms=sum(r["event_ms"] for r in rows),
                              device_ms=dev_tot))
            cells = ", ".join(
                f"{r['shape']} {_us(r['event_ms'])}/{_us(r['device_ms'])}"
                for r in rows)
            print(f"[ab] {name} {v}: {cells} us (event/device); total event "
                  f"{turns[-1]['event_ms']:.4f} ms, device "
                  f"{'n/a' if dev_tot is None else f'{dev_tot:.4f} ms'}",
                  flush=True)
        result["kernels"][name] = turns
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
