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
HI`` under ``--dist``, generation lengths under ``--gen-dist``, fixed
``--seed``.

Admission and SLOs: ``--schedule spf`` admits the shortest arrived
prompt first (``--spf-age-cap`` bounds how often a request is passed
over); ``--deadline-slack`` gives every request a deadline that many
ticks after its arrival, and the engine sheds what cannot meet it;
``--queue-cap`` bounds the queue; ``--strict-admission`` raises on an
oversized request instead of recording its rejection.

Faults: ``--fault-rate`` installs a seeded fault plan
(serving.faults.FaultPlan.generate over ``--fault-ticks`` ticks from
``--fault-seed``): step exceptions, NaN logits and NaN-poisoned slot
caches, contained by bounded retry (``--max-step-retries``), quarantine
and replay, with ``--max-replays`` replays a request. ``--trace-out``
writes the engine's two-clock trace as JSONL; render it with
``python -m repro_torch.launch.report PATH``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        tinyllama-1.1b --reduced --dbpim-mode joint --device cpu \
        --fault-rate 0.25 --trace-out trace.jsonl

Durability: ``--journal PATH`` writes the write-ahead request journal
(CRC-framed JSONL, fsync'd once a tick) and ``--snapshot-dir DIR
--snapshot-every N`` an atomic engine snapshot every N ticks
(``--snapshot-keep`` of them kept). ``--restore`` brings the engine back
from the latest snapshot in ``--snapshot-dir`` and the ``--journal``
tail and resumes every stream bitwise (nothing is submitted again: the
trace is in the journal); the geometry and policy come from the
snapshot.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        tinyllama-1.1b --reduced --dbpim-mode joint --device cpu \
        --journal /tmp/j.jsonl --snapshot-dir /tmp/snaps --snapshot-every 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        tinyllama-1.1b --reduced --dbpim-mode joint --device cpu \
        --journal /tmp/j.jsonl --snapshot-dir /tmp/snaps --restore

Paging: ``--paged --page-size P --n-pages N`` serves from a shared pool
of N pages of P positions (P must divide ``--max-len``; default N: the
full static capacity). Admission waits for free pages, and a pool
smaller than batch x max-len / P preempts the youngest request under
page pressure, which resumes later bitwise.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import encode
from repro_torch.models.inputs import stub_frames
from repro_torch.obs import Tracer
from repro_torch.serving import (FaultPlan, ServeEngine, WorkloadSpec,
                                 make_trace)
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
    ap.add_argument("--gen-dist", default="uniform",
                    choices=["uniform", "bimodal", "fixed", "lognormal",
                             "zipf"],
                    help="generation-length distribution over --gen-len")
    ap.add_argument("--schedule", default="fifo", choices=["fifo", "spf"],
                    help="admission order: fifo, or shortest-prompt-first "
                         "(spf; starvation bounded by --spf-age-cap)")
    ap.add_argument("--spf-age-cap", type=int, default=8,
                    help="spf: max times a request may be queue-jumped "
                         "before it becomes urgent")
    ap.add_argument("--deadline-slack", type=float, default=None,
                    help="SLO: every request must complete within this "
                         "many ticks of its arrival or be shed (recorded "
                         "in metrics, never raised); default: no SLO")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bounded admission queue: submissions beyond the "
                         "cap are rejected (recorded load shedding)")
    ap.add_argument("--strict-admission", action="store_true",
                    help="raise ValueError on an oversized or duplicate "
                         "request instead of recording a rejection")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="inject a deterministic fault schedule: per-tick "
                         "probability of one fault (step exception, NaN "
                         "logits, or a corrupted slot cache); faulted "
                         "slots quarantine and recover by replay")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the injected fault schedule")
    ap.add_argument("--fault-ticks", type=int, default=1000,
                    help="horizon (ticks) the fault schedule covers")
    ap.add_argument("--max-step-retries", type=int, default=2,
                    help="bounded retry of a failed device call before "
                         "every participating slot quarantines")
    ap.add_argument("--max-replays", type=int, default=3,
                    help="per-request fault budget: past it the request "
                         "is shed instead of replayed again")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="dump the structured two-clock trace (spans, "
                         "events, slot intervals) as JSONL; render with "
                         "python -m repro_torch.launch.report")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: slots borrow fixed-size pages "
                         "from a shared pool (admission gated on free "
                         "pages, decode bitwise the contiguous path)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (must divide --max-len)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="pool size in pages; fewer than batch * max_len / "
                         "page_size oversubscribes (page pressure preempts "
                         "the youngest request, resumed bitwise later); "
                         "default: the full static capacity")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="write-ahead request journal (CRC-framed JSONL, "
                         "fsync'd once a tick); with --restore, the "
                         "journal to fold over the snapshot")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="directory of periodic atomic engine snapshots "
                         "(cache, state machine, queue, metrics)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot cadence in ticks (0 = never); bounds the "
                         "work redone after a crash to this many tokens a "
                         "slot")
    ap.add_argument("--snapshot-keep", type=int, default=2,
                    help="published snapshots kept on disk")
    ap.add_argument("--restore", action="store_true",
                    help="warm restart: rebuild from the latest snapshot in "
                         "--snapshot-dir and the --journal tail, and resume "
                         "every stream bitwise (submits nothing: the trace "
                         "is in the journal)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    return ap


@torch.no_grad()
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
    fault_plan = None
    if args.fault_rate > 0:
        fault_plan = FaultPlan.generate(
            seed=args.fault_seed, n_ticks=args.fault_ticks,
            rate=args.fault_rate, n_slots=args.batch)
        print(f"[serve] fault plan: {len(fault_plan.events)} events over "
              f"{args.fault_ticks} ticks (seed={args.fault_seed}, "
              f"rate={args.fault_rate})")
    tracer = None
    if args.trace_out:
        # path=: EngineStuckError dumps the trace there before it raises
        tracer = Tracer(arch=cfg.name, meta={
            "n_slots": args.batch, "prefill_chunk": args.prefill_chunk,
            "schedule": args.schedule, "seed": args.seed},
            path=args.trace_out)
    if args.restore:
        if not args.snapshot_dir:
            raise SystemExit("--restore requires --snapshot-dir")
        engine = ServeEngine.restore(
            cfg, params, snapshot_dir=args.snapshot_dir,
            journal_path=args.journal, stacked_tables=tables,
            enc_out=enc_out, fault_plan=fault_plan, tracer=tracer,
            device=dev)
        print(f"[serve] restored from snapshot step "
              f"{engine.restore_stats['from_step']}: "
              f"{engine.restore_stats}")
    else:
        engine = ServeEngine(cfg, params, n_slots=args.batch,
                             max_len=args.max_len,
                             prefill_chunk=args.prefill_chunk,
                             prefill_mode=args.prefill_mode,
                             schedule=args.schedule,
                             spf_age_cap=args.spf_age_cap,
                             stacked_tables=tables, enc_out=enc_out,
                             strict=args.strict_admission,
                             queue_cap=args.queue_cap, fault_plan=fault_plan,
                             max_step_retries=args.max_step_retries,
                             max_replays=args.max_replays, tracer=tracer,
                             paged=args.paged, page_size=args.page_size,
                             n_pages=args.n_pages, journal=args.journal,
                             snapshot_dir=args.snapshot_dir,
                             snapshot_every=args.snapshot_every,
                             snapshot_keep=args.snapshot_keep, device=dev)
    return engine, trace_from_args(args, cfg.vocab_size), tables


def trace_from_args(args, vocab_size: int):
    """The request trace the parsed args describe (serving.workload)."""
    spec = WorkloadSpec(n_requests=args.requests,
                        arrival_rate=args.arrival_rate,
                        prompt_len=tuple(args.prompt_len),
                        gen_len=(args.gen_len, args.gen_len),
                        dist=args.dist, gen_dist=args.gen_dist,
                        seed=args.seed, deadline_slack=args.deadline_slack)
    return make_trace(spec, vocab_size)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced,
                     dbpim_mode=args.dbpim_mode,
                     prefill_exact=args.prefill_exact or None)
    engine, trace, _ = build_engine_and_trace(args, cfg)
    if engine.prefill_mode != args.prefill_mode:
        print(f"[serve] {cfg.name}: chunked prefill unsupported (sliding-"
              f"window ring cache); falling back to stepwise (full) prefill")
    outputs = engine.resume() if args.restore else engine.run(trace)
    s = engine.metrics.summary()
    print(f"[serve] {s['n_completed']}/{s['n_requests']} requests, "
          f"{s['generated_tokens']} tokens in {s['engine_ticks']} ticks / "
          f"{s['device_calls']} device calls "
          f"({s['decode_calls']} decode + {s['prefill_calls']} prefill, "
          f"prefill {engine.prefill_mode}, kind {engine.prefill_kind})")
    ttft = (f"mean={s['ttft_ticks_mean']:.1f} p95={s['ttft_ticks_p95']}"
            if s["ttft_ticks_mean"] is not None else "n/a")
    print(f"[serve] tokens/step={s['tokens_per_step']:.3f}  ttft_ticks "
          f"{ttft}  queue_depth mean={s['queue_depth_mean']:.2f} "
          f"max={s['queue_depth_max']}  schedule={engine.schedule}")
    if s["tokens_per_sec"]:
        print(f"[serve] wall {s['wall_s']:.2f}s  "
              f"{s['tokens_per_sec']:.1f} tok/s  "
              f"{s['per_token_latency_ms']:.2f} ms/token")
    if s["n_faults"] or s["n_rejected"] or s["n_shed"]:
        print(f"[serve] goodput {s['goodput']:.2f}  faults {s['faults']}  "
              f"retries {s['retries']}  replays {s['replays']}  "
              f"rejected {s['n_rejected']}  shed {s['n_shed']}  "
              f"straggler_ticks {s['straggler_ticks']}")
    if engine.paged:
        pu = (f"{s['pages_used_mean']:.2f}"
              if s["pages_used_mean"] is not None else "n/a")
        print(f"[serve] page pool: {engine.n_pages} x {engine.page_size}-"
              f"token pages  used mean={pu} max={s['pages_used_max']}  "
              f"preemptions {s['n_preemptions']}  alloc_failures "
              f"{s['page_alloc_failures']}")
    if engine.snapshot_dir is not None:
        print(f"[serve] snapshots: {args.snapshot_dir} (every "
              f"{engine.snapshot_every} ticks); journal: {args.journal}")
    if s["slot_busy_frac"] is not None:
        print(f"[serve] slot_busy_frac {s['slot_busy_frac']:.2f}  per-slot "
              f"{[round(o, 2) for o in s['slot_occupancy']]}")
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
    if engine.tracer is not None:
        from repro_torch.obs import engine_waterfall
        for kind, wf in engine_waterfall(engine).items():
            engine.tracer.waterfall(kind, wf["rows"], wf["total"])
        engine.tracer.dump(args.trace_out)
        print(f"[serve] trace: {len(engine.tracer.records)} records -> "
              f"{args.trace_out} (render: python -m "
              f"repro_torch.launch.report {args.trace_out})")
    for rid in sorted(outputs):
        print(f"  req{rid}: {outputs[rid][:8]}...")
    return outputs


if __name__ == "__main__":
    main()
