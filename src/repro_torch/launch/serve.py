"""Serving CLI of the port — a thin shell over serving.engine.ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --dbpim-mode joint
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --reduced --dbpim-mode joint --device cpu

Runs on the CUDA card by default (``--device cpu`` runs the plain
versions on the CPU). ``--dbpim-mode joint`` packs every layer's
projections into the uniform-MAXB joint-sparse stacked layout once at
startup, on the device, and serves both decode steps and prefill chunks
through the ``joint_sparse_matmul`` kernel ((1 - value_sparsity) * 0.5 of
dense bf16 weight bytes). ``--dbpim-mode value`` serves the bf16-payload
variant of the same layout. Params are random, from ``--seed``, built
with their tables by ``sparse_linear.init_stacked_serving``: each MoE
expert slice is packed as it is drawn, so mixtral-8x7b's 90 GB of dense
expert stacks never exist at once; every expert projection runs one
joint launch per expert.

``--prefill-mode full`` feeds prompt tokens through the decode step one
at a time; sliding-window archs (mixtral) fall back to it from the
default "chunked", since their ring cache needs stepwise writes.

The engine's decode, prefill-chunk and reset steps are compiled once
each (one CUDA graph per step on the card); the recompile sentinel's
count per step is printed with the latencies, under each step's tag. SSM
stacks (mamba2) prefill in the parallel SSD form by default (tag
"prefill_parallel"); ``--prefill-exact`` runs the exact per-token
recurrence instead (bit-identical to decode, C x the projection traffic;
tag "prefill_chunk_exact", which attention stacks always use).

Hybrid stacks (jamba) serve their interleaved SSM, attention, MLP and
MoE layers through the same steps (parallel SSD chunks by default).
Enc-dec models (whisper) first encode one batch of stub frames, normal(0,
1) from ``--seed`` in bf16, one row per slot: the encoder runs once,
unpacked, before the engine starts, and its time is printed apart from
the decode and prefill calls; each decode step projects the cross-
attention's k/v from its output, as the reference does.

Load is a deterministic trace (serving.workload): Poisson arrivals at
``--arrival-rate`` requests/tick, prompt lengths from ``--prompt-len LO
HI`` under ``--dist``, fixed ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import encode
from repro_torch.models.inputs import stub_frames
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import init_stacked_serving


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dbpim-mode", default=None,
                    choices=["dense", "value", "bit", "joint"],
                    help="serve through the joint-sparse kernel path "
                         "(joint = value x bit sparse)")
    ap.add_argument("--value-sparsity", type=float, default=None,
                    help="tile-granular value sparsity for joint/value "
                         "(default: cfg.dbpim_value_sparsity)")
    ap.add_argument("--batch", type=int, default=4,
                    help="engine slots (static decode batch)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=[4, 24],
                    metavar=("LO", "HI"))
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens per chunked-prefill device call")
    ap.add_argument("--prefill-mode", default="chunked",
                    choices=["chunked", "full"],
                    help="'full' = token-by-token prefill through the decode "
                         "step (sliding-window archs always)")
    ap.add_argument("--prefill-exact", action="store_true",
                    help="SSM chunks: force the exact per-token recurrence "
                         "(bit-identical to decode, C x the projection "
                         "traffic) instead of the default parallel SSD "
                         "form")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="Poisson arrivals per engine tick (0 = all at t0)")
    ap.add_argument("--dist", default="uniform",
                    choices=["uniform", "bimodal", "fixed", "lognormal",
                             "zipf"],
                    help="prompt-length distribution")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    return ap


def encode_frames(params, cfg, batch: int, seed: int, device):
    """The encoder's output for one batch of stub frames (one row per
    engine slot, ``inputs.stub_frames``: the reference serve CLI's frames)
    through ``models.encode``; prints its time."""
    frames = stub_frames(cfg, batch, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.monotonic()
    enc_out = encode(params, frames, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[serve] encoder: {tuple(frames.shape)} frames in "
          f"{1e3 * (time.monotonic() - t0):.2f} ms (once, before the "
          f"engine; unpacked)")
    return enc_out


def build_engine_and_trace(args, cfg):
    """Engine + trace from parsed args (shared by the CLI and
    chip_smoke.py). Returns (engine, trace, stacked_tables)."""
    dev = resolve_device(args.device)
    # the params and their stacked tables, each MoE expert slice packed
    # as it is drawn (a full-width MoE's dense expert stacks outgrow the
    # card); the packed projections' dense copies are stripped
    params, tables = init_stacked_serving(cfg, seed=args.seed, device=dev,
                                          value_sparsity=args.value_sparsity)
    if tables is not None:
        nbytes = sum(a.numel() * a.element_size()
                     for t in tables.arrays.values() for a in t.values())
        print(f"[serve] dbpim_mode={cfg.dbpim_mode}: "
              f"{len(tables.arrays)} projection families packed, "
              f"{nbytes / 1e6:.2f} MB stacked tables (dense copies stripped)")
    enc_out = None
    if cfg.is_encdec:
        enc_out = encode_frames(params, cfg, args.batch, args.seed, dev)
    engine = ServeEngine(cfg, params, n_slots=args.batch,
                         max_len=args.max_len,
                         prefill_chunk=args.prefill_chunk,
                         prefill_mode=args.prefill_mode,
                         stacked_tables=tables, enc_out=enc_out, device=dev)
    spec = WorkloadSpec(n_requests=args.requests,
                        arrival_rate=args.arrival_rate,
                        prompt_len=tuple(args.prompt_len),
                        gen_len=(args.gen_len, args.gen_len),
                        dist=args.dist, seed=args.seed)
    return engine, make_trace(spec, cfg.vocab_size), tables


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced,
                     dbpim_mode=args.dbpim_mode,
                     prefill_exact=args.prefill_exact or None)
    engine, trace, _ = build_engine_and_trace(args, cfg)
    if engine.prefill_mode != args.prefill_mode:
        print(f"[serve] {cfg.name}: chunked prefill unsupported (sliding-"
              f"window ring cache); falling back to stepwise (full) prefill")
    outputs = engine.run(trace)
    s = engine.metrics.summary()
    print(f"[serve] {s['n_completed']}/{s['n_requests']} requests, "
          f"{s['generated_tokens']} tokens in {s['engine_ticks']} ticks / "
          f"{s['device_calls']} device calls "
          f"({s['decode_calls']} decode + {s['prefill_calls']} prefill, "
          f"prefill {engine.prefill_mode}, kind {engine.prefill_kind})")
    if s["ttft_ticks_mean"] is not None:
        print(f"[serve] tokens/step={s['tokens_per_step']:.3f}  ttft_ticks "
              f"mean={s['ttft_ticks_mean']:.1f} p95={s['ttft_ticks_p95']}")
    if s["tokens_per_sec"]:
        print(f"[serve] wall {s['wall_s']:.2f}s  "
              f"{s['tokens_per_sec']:.1f} tok/s  "
              f"{s['per_token_latency_ms']:.2f} ms/token")
    for kind, h in s["call_latency_ms"].items():
        print(f"[serve] latency {kind}: p50={h['p50_ms']:.2f} "
              f"p95={h['p95_ms']:.2f} p99={h['p99_ms']:.2f} ms "
              f"({h['count']} calls)")
    if engine.sentinel is not None:
        print("[serve] recompile sentinel: compiled signatures " + ", ".join(
            f"{k}={n}" for k, n in engine.sentinel.counts().items()))
    if engine.device.type == "cuda":
        print(f"[serve] peak device memory "
              f"{torch.cuda.max_memory_allocated(engine.device) / 2**30:.2f}"
              f" GiB")
    for rid in sorted(outputs):
        print(f"  req{rid}: {outputs[rid][:8]}...")
    return outputs


if __name__ == "__main__":
    main()
