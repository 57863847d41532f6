"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero (no phase catches its own failure):

  1. build  — nvcc builds the joint_sparse_matmul kernel from
              src/repro_torch/kernels/csrc on first use; TF32 is switched
              off for float32 matmuls and convolutions.
  2. pack   — for one full-width tinyllama-1.1b projection of each shape,
              the pack made on the card is byte-identical to the CPU pack.
  3. kernel — the kernel against its plain PyTorch version at every
              projection shape of the serving path, M in {4, 256}, bf16 and
              f32 activations: f32 output within 1e-5 * max|ref|, bf16
              output within one bf16 ulp of max|ref|, the fp32 accumulators
              within 1e-5 * max|ref|; rows of an M=4 call bitwise equal to
              the same rows of an M=256 call; the bf16 (value-only)
              payload at the widest shape.
  4. serve  — tinyllama-1.1b at full width in joint mode, bf16, random
              weights from a seed, through repro_torch.launch.serve's
              engine: 8 requests, batch 4, max-len 512, prompts 32..256,
              32 generated tokens, prefill chunks of 64. Every request
              completes, the kernel launches 154 times per device call
              (22 layers x 7 projections), and the first-token logits of
              two requests agree with the same model run through the
              plain versions. Printed, not checked: how far a chunked
              prefill is from stepwise decode at model level.
  5. profile — device busy and idle share over a window of decode calls,
              and the kernels the device time goes to (torch.profiler).
  6. times  — kernel, plain version and torch.matmul on the dense bf16
              weight (the library yardstick, used nowhere in the port) at
              the decode shapes, with CUDA events after warm-up, beside the
              bound: the larger of bytes over 3.35 TB/s and operations over
              989 TFLOP/s (bf16), the H100 SXM data sheet's rates.

The line before the last holds the kernels' JSON record, the one before it
the card's name and power limit; the last line is the device record.
Exits non-zero, printing no result, without a CUDA card or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
F32_TOL = 1e-5                     # f32 outputs and fp32 accumulators
SERVE_ARGS = ["--arch", "tinyllama-1.1b", "--dbpim-mode", "joint",
              "--batch", "4", "--max-len", "512", "--requests", "8",
              "--prompt-len", "32", "256", "--gen-len", "32",
              "--prefill-chunk", "64", "--seed", "0"]
#: first-token logits, kernel path vs plain path: both bf16 models whose
#: projections round to bf16 after fp32 sums taken in another order, over
#: 22 layers; the gap stays a small fraction of the logit range
LOGIT_REL_TOL = 5e-2


def log(msg: str):
    print(msg, flush=True)


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _path_shapes(cfg):
    """(name, K, N) of every projection on the serving path."""
    d, q, kv, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]


def _distinct(shapes):
    seen, out = set(), []
    for name, K, N in shapes:
        if (K, N) not in seen:
            seen.add((K, N))
            out.append((name, K, N))
    return out


def _tiles(K, N):
    """The tile rule of sparse_linear.build_stacked_tables (128 at full
    width, the dims rounded up to a multiple of 8 below that)."""
    return dict(bk=min(128, 8 * -(-K // 8)), bn=min(128, 8 * -(-N // 8)))


def phase_build():
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    build.load("joint_sparse_matmul")
    regs = [ln.strip() for ln in
            build.PTXAS_LOG.get("joint_sparse_matmul", "").splitlines()
            if "registers" in ln]
    log(f"[build] joint_sparse_matmul built in "
        f"{build.BUILD_SECONDS['joint_sparse_matmul']:.2f} s "
        f"(load {time.monotonic() - t0:.2f} s); ptxas: "
        f"{len(regs)} instantiations, e.g. {regs[0] if regs else 'n/a'}")


def phase_pack(cfg, dev):
    """Full-width packs of one layer per projection shape: card vs CPU."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(1)
    packs = {}
    for name, K, N in _distinct(_path_shapes(cfg)):
        w = (torch.randn((1, K, N), generator=gen) * K ** -0.5)
        w = w.to(torch.bfloat16)
        t0 = time.monotonic()
        on_card = ops.pack_joint_sparse_stacked(
            w.to(dev), value_sparsity=cfg.dbpim_value_sparsity, **_tiles(K, N))
        torch.cuda.synchronize()
        t_card = time.monotonic() - t0
        t0 = time.monotonic()
        on_cpu = ops.pack_joint_sparse_stacked(
            w, value_sparsity=cfg.dbpim_value_sparsity, **_tiles(K, N))
        t_cpu = time.monotonic() - t0
        for field in ("w_blocks", "idx", "scales", "nblocks"):
            a, b = getattr(on_card, field).cpu(), getattr(on_cpu, field)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, field)
        assert (on_card.k, on_card.n, on_card.k_pad) == \
            (on_cpu.k, on_cpu.n, on_cpu.k_pad)
        _, nt, maxb, bk, bn = on_card.w_blocks.shape
        log(f"[pack] {name} {K}x{N}: NT={nt} MAXB={maxb} bk={bk} bn={bn} "
            f"card pack == cpu pack byte for byte "
            f"(card {t_card:.2f} s, cpu {t_cpu:.2f} s)")
        packs[(K, N)] = ops.slice_joint_stacked(on_card, 0)
    return packs


def phase_kernel(cfg, packs, dev):
    """Kernel vs plain at every path shape; returns the max abs error of
    the bf16 outputs (the serving dtype)."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    gen = torch.Generator().manual_seed(2)
    worst_bf16 = 0.0
    for name, K, N in _distinct(_path_shapes(cfg)):
        p = packs[(K, N)]
        for dt in (torch.bfloat16, torch.float32):
            x256 = torch.randn((256, K), generator=gen).to(dt).to(dev)
            for M in (4, 256):
                x = x256[:M].contiguous()
                y = jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales)
                acc = jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales,
                                              out_dtype=torch.float32)
                torch.cuda.synchronize()
                ref = jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx,
                                                    p.scales)
                ref_acc = jsm.joint_sparse_matmul_plain(
                    x, p.w_blocks, p.idx, p.scales, torch.float32)
                peak = ref_acc.abs().max().item()
                err_acc = (acc - ref_acc).abs().max().item()
                err = (y.float() - ref.float()).abs().max().item()
                tol = F32_TOL * peak if dt == torch.float32 \
                    else _bf16_ulp(peak)
                assert err_acc <= F32_TOL * peak, (name, dt, M, err_acc)
                assert err <= tol, (name, dt, M, err, tol)
                if dt == torch.bfloat16:
                    worst_bf16 = max(worst_bf16, err)
                if M == 4:
                    head = y
                else:
                    assert torch.equal(head, y[:4]), (name, dt, "rows")
                log(f"[kernel] {name} {K}x{N} {str(dt)[6:]} M={M}: "
                    f"max|d|={err:.3e} (tol {tol:.3e}), acc "
                    f"max|d|={err_acc:.3e} (tol {F32_TOL * peak:.3e})")
            log(f"[kernel] {name} {str(dt)[6:]}: rows of M=4 bitwise equal "
                f"rows of M=256")
    # the value-only layout (bf16 payload, unit scales) through the same
    # kernel, at the widest shape
    from repro_torch.kernels import ops
    name, K, N = _path_shapes(cfg)[4]
    w = (torch.randn((1, K, N), generator=gen) * K ** -0.5).to(dev)
    p = ops.slice_joint_stacked(ops.pack_joint_sparse_stacked(
        w, value_sparsity=cfg.dbpim_value_sparsity, payload="bf16",
        **_tiles(K, N)), 0)
    x = torch.randn((256, K), generator=gen).to(torch.bfloat16).to(dev)
    y = jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales)
    torch.cuda.synchronize()
    ref = jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx, p.scales)
    peak = ref.float().abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    assert p.w_blocks.dtype == torch.bfloat16 and err <= _bf16_ulp(peak)
    log(f"[kernel] {name} {K}x{N} bf16 payload (value mode) M=256: "
        f"max|d|={err:.3e} (tol {_bf16_ulp(peak):.3e})")
    return worst_bf16


@contextlib.contextmanager
def plain_joint_matmuls():
    """The same model with every joint matmul swapped for its plain
    version (for the reference logits of phase 4)."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    saved = ops.joint_sparse_matmul
    ops.joint_sparse_matmul = jsm.joint_sparse_matmul_plain
    try:
        yield
    finally:
        ops.joint_sparse_matmul = saved


def _first_token_logits(engine, tables, prompt, chunk):
    from repro_torch.models import decode_chunk, init_cache
    cfg = engine.cfg
    cache = init_cache(cfg, 1, engine.max_len, device=engine.device)
    cache["pos"] = torch.zeros((1,), dtype=torch.int32, device=engine.device)
    lg = None
    for s in range(0, len(prompt), chunk):
        part = prompt[s:s + chunk]
        toks = torch.zeros((1, chunk), dtype=torch.int32)
        toks[0, :len(part)] = torch.tensor(part, dtype=torch.int32)
        lg, cache = decode_chunk(
            engine.params, cache, toks.to(engine.device),
            torch.tensor([len(part)], dtype=torch.int32,
                         device=engine.device), cfg, tables=tables)
    return lg[0, 0].float().cpu()


def phase_serve(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(SERVE_ARGS)
    cfg = get_config(args.arch, reduced=args.reduced,
                     dbpim_mode=args.dbpim_mode)
    t0 = time.monotonic()
    engine, trace, tables = serve.build_engine_and_trace(args, cfg)
    torch.cuda.synchronize()
    log(f"[serve] params + stacked tables on the card in "
        f"{time.monotonic() - t0:.2f} s ({cfg.name}, {cfg.n_layers} layers, "
        f"d={cfg.d_model}, d_ff={cfg.d_ff}, dtype={cfg.dtype})")
    jsm.LAUNCHES = 0
    outputs = engine.run(trace)
    torch.cuda.synchronize()
    launches = jsm.LAUNCHES
    s = engine.metrics.summary()
    assert s["n_completed"] == len(trace) == 8, s["n_completed"]
    assert all(len(outputs[r.rid]) == r.gen_len for r in trace)
    per_call = cfg.n_layers * len(_path_shapes(cfg))     # 22 x 7 = 154
    assert launches == per_call * s["device_calls"], \
        (launches, s["device_calls"])
    lat = s["call_latency_ms"]
    log(f"[serve] {s['n_completed']}/{s['n_requests']} requests, "
        f"{s['generated_tokens']} tokens, {s['engine_ticks']} ticks, "
        f"{s['decode_calls']} decode + {s['prefill_calls']} prefill calls, "
        f"kernel launches {launches} == {per_call} x "
        f"{s['device_calls']}")
    log(f"[serve] {s['tokens_per_sec']:.1f} tokens/s over {s['wall_s']:.2f} "
        f"s; decode ms/step p50={lat['decode']['p50_ms']:.2f} "
        f"mean={lat['decode']['mean_ms']:.2f}; prefill_chunk_exact "
        f"p50={lat['prefill_chunk_exact']['p50_ms']:.2f} ms")
    for rid in (0, 1):
        prompt = list(trace[rid].prompt)
        with plain_joint_matmuls():
            ref = _first_token_logits(engine, tables, prompt,
                                      engine.prefill_chunk)
        got = torch.from_numpy(engine.first_logits[rid])
        d = (got - ref).abs().max().item()
        peak = ref.abs().max().item()
        assert torch.isfinite(got).all() and got.shape == (cfg.vocab_size,)
        assert d <= LOGIT_REL_TOL * peak, (rid, d, peak)
        log(f"[serve] request {rid} (prompt {len(prompt)}): first-token "
            f"logits kernel vs plain max|d|={d:.3e} (max|ref|={peak:.3f}, "
            f"tol {LOGIT_REL_TOL} x max|ref|); argmax {int(got.argmax())} vs "
            f"{int(ref.argmax())}")
    # informational: the model-level chunk == stepwise invariant on the card
    prompt = list(trace[0].prompt)
    chunked = _first_token_logits(engine, tables, prompt, engine.prefill_chunk)
    stepwise = _stepwise_logits(engine, tables, prompt)
    log(f"[serve] request 0: chunked prefill vs stepwise decode, kernel "
        f"path, batch 1: max|d|={(chunked - stepwise).abs().max().item():.3e}"
        f", bitwise {torch.equal(chunked, stepwise)}")
    return s, launches, engine


def _stepwise_logits(engine, tables, prompt):
    from repro_torch.models import decode_step, init_cache
    cache = init_cache(engine.cfg, 1, engine.max_len, device=engine.device)
    cache["pos"] = torch.zeros((1,), dtype=torch.int32, device=engine.device)
    for tok in prompt:
        lg, cache = decode_step(
            engine.params, cache,
            torch.tensor([[tok]], dtype=torch.int32, device=engine.device),
            engine.cfg, tables=tables)
    return lg[0, 0].float().cpu()


def phase_profile(engine, n_steps=8):
    """Device busy and idle share over a window of decode calls of the
    served engine (all slots active), and where the device time goes.
    Wall time comes from a run without the profiler, busy time from
    torch.profiler's device-side records of a second, identical run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = engine.device
    tok = torch.ones((engine.n_slots, 1), dtype=torch.int32, device=dev)
    active = torch.ones((engine.n_slots,), dtype=torch.bool, device=dev)
    state = {"cache": engine.cache}

    def window():
        for _ in range(n_steps):
            lg, state["cache"] = engine._decode(engine.params, state["cache"],
                                                tok, active)
            lg.float().cpu()                   # the engine's per-tick sync

    window()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    window()
    wall_ms = 1e3 * (time.monotonic() - t0) / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
    # device-side records only (kernels, copies): a CPU op's record also
    # carries the device time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    if busy_ms == 0:
        log("[profile] device busy share: not measured (the profiler "
            "recorded no device time)")
        return
    launches = sum(e.count for e in kernels) / n_steps
    log(f"[profile] decode call (batch {engine.n_slots}, {n_steps} calls): "
        f"{wall_ms:.2f} ms wall, device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}; {launches:.0f} device ops per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        ms = e.self_device_time_total / 1e3 / n_steps
        log(f"[profile]   {ms:.3f} ms/call ({ms / busy_ms:.1%} of busy), "
            f"{e.count / n_steps:.0f}/call: {e.key[:100]}")


def _time(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(cfg, packs, dev, n_slots):
    """Per-launch times at the decode shapes (M = n_slots, bf16), and the
    same summed over one decode step's 154 launches."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(3)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               bytes=0, flops=0)
    rows = []
    for name, K, N in _path_shapes(cfg):
        p = packs[(K, N)]
        x = torch.randn((n_slots, K), generator=gen).to(torch.bfloat16).to(dev)
        w_dense = ops.unpack_joint_sparse(p).to(torch.bfloat16)
        ms = _time(lambda: jsm.joint_sparse_matmul(x, p.w_blocks, p.idx,
                                                   p.scales))
        plain = _time(lambda: jsm.joint_sparse_matmul_plain(
            x, p.w_blocks, p.idx, p.scales))
        lib = _time(lambda: torch.matmul(x, w_dense))
        nt, maxb, bk, bn = p.w_blocks.shape
        stored = nt * maxb * bk * bn
        nbytes = (x.numel() * 2 + stored * p.w_blocks.element_size()
                  + p.idx.numel() * 4 + p.scales.numel() * 4
                  + n_slots * nt * bn * 2)
        flops = 2 * n_slots * stored
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
        by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS \
            else "operations"
        rows.append(dict(name=name, K=K, N=N, NT=nt, MAXB=maxb, ms=ms,
                         plain_ms=plain, library_ms=lib, bound_ms=bound,
                         bound_by=by, bytes=nbytes))
        log(f"[times] {name} {K}x{N} M={n_slots} bf16: kernel {ms * 1e3:.1f} "
            f"us, plain {plain * 1e3:.1f} us, torch.matmul dense "
            f"{lib * 1e3:.1f} us, bound {bound * 1e3:.2f} us ({by}, "
            f"{nbytes / 1e6:.3f} MB)")
        L = cfg.n_layers
        for key, val in (("ms", ms), ("plain_ms", plain),
                         ("library_ms", lib), ("bound_ms", bound)):
            tot[key] += L * val
        tot["bytes"] += L * nbytes
        tot["flops"] += L * flops
    log(f"[times] one decode step (22 x 7 = 154 launches, M={n_slots}): "
        f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
        f"torch.matmul dense {tot['library_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.3f} ms ({tot['bytes'] / 1e6:.1f} MB)")
    return rows, tot


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    phase_build()
    cfg = get_config("tinyllama-1.1b", dbpim_mode="joint")
    packs = phase_pack(cfg, dev)
    worst = phase_kernel(cfg, packs, dev)
    _, launches, engine = phase_serve(dev)
    phase_profile(engine)
    rows, tot = phase_times(cfg, packs, dev, n_slots=4)

    kernels = [{
        "name": "joint_sparse_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/joint_sparse_matmul.cu",
        "replaces": "src/repro/kernels/joint_sparse_matmul.py:129",
        "launches": launches, "max_abs_err": worst,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("bytes" if tot["bytes"] / HBM_BYTES_PER_S
                     >= tot["flops"] / BF16_FLOPS else "operations"),
        "library_ms": tot["library_ms"],
        "work": "one decode step: 22 layers x 7 projections, M=4, bf16",
        "per_shape": rows,
    }]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
