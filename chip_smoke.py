"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero (no phase catches its own failure):

  1. build  — nvcc builds the six kernels (joint_sparse_matmul,
              block_sparse_matmul, fta_int8_matmul, dbmu_matmul, and the
              row-stable row_attention and row_norm) from
              src/repro_torch/kernels/csrc on first use, one nvcc each, all
              started together; ptxas reports no register spills; TF32 is
              switched off for float32 matmuls and convolutions.
  2. pack   — for one full-width tinyllama-1.1b projection of each shape,
              the joint pack made on the card is byte-identical to the CPU
              pack.
  3. kernel — each kernel against its plain PyTorch version at every
              projection shape of the path, M in {4, 256}: f32 output within
              1e-5 * max|ref|, bf16 output within one bf16 ulp of max|ref|,
              DBMU bitwise equal (x with -128 and 127 in it), FTA/INT8
              rows of an M=4 call bitwise equal to the same rows of an
              M=256 call. The joint kernel also in f32 and bf16
              activations with its fp32 accumulators, rows of an M=4 call
              bitwise equal to the same rows of an M=256 call, and the bf16
              (value-only) payload; the block-sparse pack made on the card
              equals the CPU pack byte for byte. row_attention at the serving
              shapes (batch 4, 512-slot cache, a 64-query chunk) within
              1e-5 * max|ref| (f32) or 2^-6 * max|ref| (bf16) of its plain
              version, and at the long-context serve cell's shape (batch 16,
              2048-slot cache, 256-query chunks starting at 256 * (b mod
              6)), and row_norm at 4, 256 and 4096 rows within 1e-5 *
              max|ref| or one bf16 ulp; a query (row) alone bitwise equal
              to the same query (row) in the chunk.
  4. serve  — tinyllama-1.1b at full width in joint mode, bf16, random
              weights from a seed, through repro_torch.launch.serve's
              engine: 8 requests, batch 4, max-len 512, prompts 32..256,
              32 generated tokens, prefill chunks of 64. Every request
              completes; per device call the joint kernel launches 154 times
              (22 layers x 7 projections), row_attention 22 times and
              row_norm 45 times (2 per layer and the final norm), and no
              other kernel launches; the first-token logits ((1, V) rows in
              bf16) of two requests agree with the same model run through
              the plain versions; a chunked prefill equals stepwise decode
              bit for bit at model level (batch 1), and op by op through
              every layer.
  5. modes  — one full-width tinyllama-1.1b decoder layer (norms, chunked
              attention, MLP) with random weights, its projections packed by
              build_kernel_tables in mode "value" (vs = 0.6) and in mode
              "bit" and served through make_matmul at 4 x 64 = 256 rows:
              7 launches of the mode's kernel per layer call (with one of
              row_attention and two of row_norm), the output within
              2^-6 * max|ref| of the same layer through the plain versions; the launches of a 4-row decode call are printed (0
              by the reference's rule: rows % 128 != 0).
  6. dbmu   — the DB-PIM compilation pipeline (block pruning at 0.6, alpha 8
              -> per-tensor INT8 -> FTA -> dyadic term packing) on the card
              for every projection shape: masks and packs byte-identical to
              the CPU's, dbmu_matmul at M=256 exactly equal to the integer
              matmul oracle; then repro_torch.quickstart on the card.
  7. profile — device busy and idle share over a window of decode calls
              and over a window of prefill-chunk calls (batch 4 x 64
              tokens), the joint kernel's share of the busy time, and the
              kernels the device time goes to (torch.profiler).
  8. times  — each kernel, its plain version and one PyTorch call computing
              the same function (the library yardstick, used nowhere in the
              port) with CUDA events after warm-up; the kernel and the
              library call also in device time from torch.profiler's
              device-side records (at these sizes the event time of a lone
              launch is mostly the caller's host time); beside the bound: the
              larger of bytes over 3.35 TB/s and operations over the peak of
              their type (989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s
              fp32 outside the tensor cores), the H100 SXM data sheet's
              rates; and the host µs per call, the time to issue
              back-to-back calls before the device has finished them (the
              fastest of several windows). Work
              units: the joint kernel one decode step (154 launches, M=4),
              and as units of their own one call's 154 launches at M=64 (a
              64-token chunk of one slot) and at M=256 (the serve phase's
              prefill-chunk call, 4 slots x 64 tokens); block-sparse and
              FTA/INT8 one full-width layer at M=256 (7 launches); DBMU the
              four projection shapes at M=256; row_attention and row_norm
              one decode call and one prefill-chunk call (22 and 45
              launches each), and as units of their own one long-context
              prefill call (batch 16 x 256 queries against a 2048-slot
              cache; 4096 rows of norms).

The launch counts of the JSON record come from the main paths: phase 4
for the joint, row_attention and row_norm kernels, phase 5 for block-sparse and FTA/INT8, phase 6 for
DBMU, each counted from zero just before the path runs. The line before
the last holds the kernels' JSON record, the one before it the card's
name and power limit; the last line is the device record. Exits
non-zero, printing no result, without a CUDA card or outside a checkout
of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
FP32_FLOPS = 67e12                 # H100 SXM fp32 peak outside tensor cores
F32_TOL = 1e-5                     # f32 outputs and fp32 accumulators
#: one full-width layer, kernel path vs plain path: bf16 projections whose
#: fp32 sums run in another order may round one bf16 ulp apart, and the
#: layer's later ops carry that on; 2^-6 of the peak is a few bf16 ulps
LAYER_REL_TOL = 2.0 ** -6
#: bf16 attention, kernel vs plain: a logit whose fp32 sum lands on the
#: other side of a bf16 rounding boundary moves by one bf16 ulp of the
#: logit, and its probability with it; 2^-6 of the peak is a few bf16 ulps
ATTN_REL_TOL = 2.0 ** -6
KERNELS = ("joint_sparse_matmul", "block_sparse_matmul", "fta_int8_matmul",
           "dbmu_matmul", "row_attention", "row_norm")
SERVE_ARGS = ["--arch", "tinyllama-1.1b", "--dbpim-mode", "joint",
              "--batch", "4", "--max-len", "512", "--requests", "8",
              "--prompt-len", "32", "256", "--gen-len", "32",
              "--prefill-chunk", "64", "--seed", "0"]
#: first-token logits, kernel path vs plain path: both bf16 models whose
#: projections round to bf16 after fp32 sums taken in another order, over
#: 22 layers; the gap stays a small fraction of the logit range
LOGIT_REL_TOL = 5e-2
#: the joint kernel's prefill work units: rows per launch (a 64-token chunk
#: of one slot; the serve phase's chunk call of 4 slots x 64 tokens)
JOINT_PREFILL_M = (64, 256)
#: symbols of the joint kernel's CUDA kernels in the profiler's records
#: (the gathered-K kernels of gather_matmul.cuh; on the serving path no
#: other kernel uses them)
JOINT_SYMBOLS = ("gathered_tc_kernel", "gathered_fp32_kernel")
#: the times phase's name of the joint kernel's prefill units
JOINT_UNIT = "joint_sparse_matmul prefill"
#: the long-context serve cell: batch 16, max-len 2048, chunks of 256
LONG_B, LONG_A, LONG_C = 16, 2048, 256
#: the times phase's names of row_attention's and row_norm's long-context
#: units (one prefill-chunk call of the long-context cell)
ATTN_LONG_UNIT = "row_attention long context"
NORM_LONG_UNIT = "row_norm long context"


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


def _kernel_modules():
    """name -> the wrapper module holding the kernel's LAUNCHES count."""
    from repro_torch.kernels import (block_sparse_matmul, dbmu_sim,
                                     fta_int8_matmul, joint_sparse_matmul,
                                     row_attention, row_norm)
    return {"joint_sparse_matmul": joint_sparse_matmul,
            "block_sparse_matmul": block_sparse_matmul,
            "fta_int8_matmul": fta_int8_matmul, "dbmu_matmul": dbmu_sim,
            "row_attention": row_attention, "row_norm": row_norm}


def reset_launches():
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches():
    return {name: mod.LAUNCHES for name, mod in _kernel_modules().items()}


def phase_build():
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    build.build_all(KERNELS)
    for name in KERNELS:
        build.load(name)
        ptxas = build.PTXAS_LOG.get(name, "")
        regs = [ln.strip() for ln in ptxas.splitlines()
                if "Used" in ln and "registers" in ln]
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                              ptxas)]
        assert not any(spills), (name, "spills", ptxas)
        log(f"[build] {name} built in {build.BUILD_SECONDS[name]:.2f} s; "
            f"ptxas: {len(regs)} instantiations, no spills, e.g. "
            f"{regs[0] if regs else 'n/a'}")
    log(f"[build] all {len(KERNELS)} kernels built and loaded in "
        f"{time.monotonic() - t0:.2f} s (one nvcc each, in parallel)")


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


def _int8_extremes(x):
    """x (M, K) int32 with the ends of the int8 range in it: columns 0 and
    1 of every row at -128 and 127, and (for M >= 4) rows 2 and 3 all -128
    and all 127, the largest sums the datapath adds."""
    x[:, 0], x[:, 1] = -128, 127
    if x.shape[0] >= 4:
        x[2], x[3] = -128, 127
    return x


def _err_tol(y, ref):
    """(max abs error, tolerance): 1e-5 of the peak for f32 outputs, one
    bf16 ulp of the peak for bf16 outputs."""
    peak = ref.float().abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    tol = F32_TOL * peak if y.dtype == torch.float32 else _bf16_ulp(peak)
    return err, tol


def phase_kernel_value_bit_dbmu(cfg, dev):
    """The block-sparse, FTA/INT8 and DBMU kernels against their plain
    versions at every projection shape, M in {4, 256}, on weights packed as
    the per-layer hook and the pipeline pack them (block-sparse and FTA
    packs made on the card equal the CPU's). Returns the worst abs error
    of the bf16 outputs per kernel (DBMU: 0, or the run fails)."""
    from repro_torch.core import dyadic
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import dbmu_sim
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(5)
    worst = {"block_sparse_matmul": 0.0, "fta_int8_matmul": 0.0,
             "dbmu_matmul": 0.0}
    for name, K, N in _distinct(_path_shapes(cfg)):
        w = torch.randn((K, N), generator=gen) * K ** -0.5
        mask = ops.tile_prune_mask(w, cfg.dbpim_value_sparsity)
        wb_cpu, idx_cpu = ops.pack_block_sparse(w * mask, torch.ones_like(mask))
        wd = w.to(dev)
        md = ops.tile_prune_mask(wd, cfg.dbpim_value_sparsity)
        wb, idx = ops.pack_block_sparse(wd * md, torch.ones_like(md))
        assert torch.equal(md.cpu(), mask) and torch.equal(wb.cpu(), wb_cpu) \
            and torch.equal(idx.cpu(), idx_cpu), (name, "block-sparse pack")
        ones = torch.ones((K, N), dtype=torch.int32)
        q, sc = ops.quantize_int8_fta(wd, ones.to(dev))
        q_cpu, sc_cpu = ops.quantize_int8_fta(w, ones)
        assert torch.equal(q.cpu(), q_cpu) and torch.equal(sc.cpu(), sc_cpu)
        q = q.to(torch.int8)
        packed = dyadic.pack_terms(q)
        errs = {k: [] for k in worst}
        heads = {}
        for dt in (torch.float32, torch.bfloat16):
            x256 = torch.randn((256, K), generator=gen).to(dt).to(dev)
            for M in (4, 256):
                x = x256[:M].contiguous()
                y = bsk.block_sparse_matmul(x, wb.to(dt), idx)
                torch.cuda.synchronize()
                err, tol = _err_tol(y, bsk.block_sparse_matmul_plain(
                    x, wb.to(dt), idx))
                assert err <= tol, (name, "block_sparse", dt, M, err, tol)
                errs["block_sparse_matmul"].append((err, tol, y.dtype))
                for od in (torch.bfloat16, torch.float32):
                    y = ftk.fta_int8_matmul(x, q, sc, od)
                    torch.cuda.synchronize()
                    err, tol = _err_tol(y, ftk.fta_int8_matmul_plain(
                        x, q, sc, od))
                    assert err <= tol, (name, "fta", dt, od, M, err, tol)
                    errs["fta_int8_matmul"].append((err, tol, od))
                    if M == 4:
                        heads[(dt, od)] = y
                    else:
                        assert torch.equal(heads[(dt, od)], y[:4]), \
                            (name, "fta rows", dt, od)
        xi256 = _int8_extremes(torch.randint(-128, 128, (256, K), generator=gen,
                                             dtype=torch.int32)).to(dev)
        for M in (4, 256):
            xi = xi256[:M].contiguous()
            y = dbmu_sim.dbmu_matmul(xi, packed)
            torch.cuda.synchronize()
            assert torch.equal(y, dbmu_sim.dbmu_matmul_plain(xi, packed)), \
                (name, "dbmu", M)
        for kname, rows in errs.items():
            if not rows:
                continue
            bf = [e for e, _, od in rows if od == torch.bfloat16]
            worst[kname] = max(worst[kname], max(bf))
            log(f"[kernel] {kname} {name} {K}x{N} M in (4, 256), f32 and "
                f"bf16 x: max|d|/tol = "
                f"{max(e / t if t else float(e > 0) for e, t, _ in rows):.3f}"
                f" (bf16 out max|d|={max(bf):.3e})")
        log(f"[kernel] fta_int8_matmul {name} {K}x{N}: rows of M=4 bitwise "
            f"equal rows of M=256 (f32 and bf16 x and out)")
        log(f"[kernel] dbmu_matmul {name} {K}x{N} M in (4, 256), x with "
            f"-128 and 127: bitwise equal to its plain version; block-sparse "
            f"pack (NT={wb.shape[0]}, MAXB={wb.shape[1]}) and FTA INT8 "
            f"weights card == cpu byte for byte")
    return worst


def _serve_attention_inputs(cfg, dev, dtype, gen, B=4, A=512, C=64):
    """Queries and a random cache at the serving path's attention shapes:
    a decode call (one query per slot) and a prefill-chunk call (C queries
    per slot), at positions inside the serve phase's range."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    v = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    qd = torch.randn((B, 1, H, hd), generator=gen).to(dtype).to(dev)
    qc = torch.randn((B, C, H, hd), generator=gen).to(dtype).to(dev)
    pos_d = torch.tensor([[40], [120], [200], [280]], dtype=torch.int32)
    pos_c = (torch.tensor([0, 64, 128, 192], dtype=torch.int32)[:, None]
             + torch.arange(C, dtype=torch.int32)[None])
    return dict(k=k, v=v, decode=(qd, pos_d[:B].to(dev)),
                chunk=(qc, pos_c[:B].to(dev)))


def _long_attention_inputs(cfg, dev, dtype, gen, B=LONG_B, A=LONG_A,
                           C=LONG_C):
    """Queries and a random cache at the long-context serve cell's shape:
    a prefill-chunk call of C queries per slot, slot b's chunk starting at
    position C * (b mod 6) (chunks 0 to 5 of prompts up to 1536 tokens)."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    v = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    q = torch.randn((B, C, H, hd), generator=gen).to(dtype).to(dev)
    pos = (C * (torch.arange(B, dtype=torch.int32) % 6)[:, None]
           + torch.arange(C, dtype=torch.int32)[None])
    return dict(k=k, v=v, long=(q, pos.to(dev)))


def phase_kernel_rows(cfg, dev):
    """row_attention and row_norm against their plain versions at the
    serving shapes, and their row stability: a query (row) alone comes out
    bitwise equal to the same query (row) in a chunk call. Returns the
    worst abs error of the bf16 outputs per kernel."""
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    gen = torch.Generator().manual_seed(8)
    worst = {"row_attention": 0.0, "row_norm": 0.0}
    for dt in (torch.bfloat16, torch.float32):
        serve = _serve_attention_inputs(cfg, dev, dt, gen)
        long = _long_attention_inputs(cfg, dev, dt, gen)
        for what, a in (("decode", serve), ("chunk", serve), ("long", long)):
            q, pos = a[what]
            y = rak.row_attention(q, a["k"], a["v"], pos)
            torch.cuda.synchronize()
            ref = rak.row_attention_plain(q, a["k"], a["v"], pos)
            peak = ref.float().abs().max().item()
            err = (y.float() - ref.float()).abs().max().item()
            tol = (F32_TOL if dt == torch.float32 else ATTN_REL_TOL) * peak
            assert torch.isfinite(y).all() and err <= tol, \
                ("row_attention", what, dt, err, tol)
            if dt == torch.bfloat16:
                worst["row_attention"] = max(worst["row_attention"], err)
            log(f"[kernel] row_attention {what} {tuple(q.shape)} x cache "
                f"{tuple(a['k'].shape)} {str(dt)[6:]}: max|d|={err:.3e} "
                f"(tol {tol:.3e})")
            del y, ref
        for what, a, ts in (("chunk", serve, (0, 31, 63)),
                            ("long", long, (0, 127, 255))):
            q, pos = a[what]
            y = rak.row_attention(q, a["k"], a["v"], pos)
            for t in ts:
                one = rak.row_attention(q[:, t:t + 1].contiguous(), a["k"],
                                        a["v"], pos[:, t:t + 1].contiguous())
                assert torch.equal(one, y[:, t:t + 1]), \
                    ("row_attention rows", what, t)
            log(f"[kernel] row_attention {str(dt)[6:]}: queries "
                f"{', '.join(map(str, ts))} of the {what} call bitwise equal "
                f"to one-query calls")
        del long
        D = cfg.d_model
        x4096 = torch.randn((4096, D), generator=gen).to(dt).to(dev)
        scale = (1 + 0.1 * torch.randn((D,), generator=gen)).to(dev)
        bias = (0.1 * torch.randn((D,), generator=gen)).to(dev)
        for b, kind in ((None, "rms"), (bias, "layernorm")):
            for R in (4, 256, 4096):
                x = x4096[:R].contiguous()
                y = rnk.row_norm(x, scale, b)
                torch.cuda.synchronize()
                err, tol = _err_tol(y, rnk.row_norm_plain(x, scale, b))
                assert err <= tol, ("row_norm", kind, dt, R, err, tol)
                if dt == torch.bfloat16:
                    worst["row_norm"] = max(worst["row_norm"], err)
                if R == 4:
                    head = y
                else:
                    assert torch.equal(head, y[:4]), ("row_norm rows", kind)
                log(f"[kernel] row_norm {kind} ({R}, {D}) {str(dt)[6:]}: "
                    f"max|d|={err:.3e} (tol {tol:.3e})")
        log(f"[kernel] row_norm {str(dt)[6:]}: rows of R=4 bitwise equal "
            f"rows of R=256 and R=4096")
    return worst


@contextlib.contextmanager
def plain_versions():
    """The same model with every kernel of the serving path and the
    per-layer hook swapped for its plain version (the references of phases
    4 and 5)."""
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    swaps = [(ops, "joint_sparse_matmul", jsm.joint_sparse_matmul_plain),
             (ops, "block_sparse_matmul", bsk.block_sparse_matmul_plain),
             (ops, "fta_int8_matmul", ftk.fta_int8_matmul_plain),
             (rak, "row_attention", rak.row_attention_plain),
             (rnk, "row_norm", rnk.row_norm_plain)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, plain in swaps:
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for mod, attr, kernel in saved:
            setattr(mod, attr, kernel)


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
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    outputs = engine.run(trace)
    torch.cuda.synchronize()
    counts = read_launches()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    s = engine.metrics.summary()
    assert s["n_completed"] == len(trace) == 8, s["n_completed"]
    assert all(len(outputs[r.rid]) == r.gen_len for r in trace)
    per_call = {"joint_sparse_matmul":                   # 22 x 7 = 154
                cfg.n_layers * len(_path_shapes(cfg)),
                "row_attention": cfg.n_layers,
                "row_norm": 2 * cfg.n_layers + 1}
    launches = {name: counts[name] for name in per_call}
    for name, n in per_call.items():
        assert launches[name] == n * s["device_calls"], \
            (name, launches[name], s["device_calls"])
    assert sum(counts.values()) == sum(launches.values()), counts
    lat = s["call_latency_ms"]
    log(f"[serve] {s['n_completed']}/{s['n_requests']} requests, "
        f"{s['generated_tokens']} tokens, {s['engine_ticks']} ticks, "
        f"{s['decode_calls']} decode + {s['prefill_calls']} prefill calls; "
        f"kernel launches " + ", ".join(
            f"{name} {launches[name]} == {n} x {s['device_calls']}"
            for name, n in per_call.items()) + " (other kernels: 0)")
    log(f"[serve] {s['tokens_per_sec']:.1f} tokens/s over {s['wall_s']:.2f} "
        f"s; decode ms/step p50={lat['decode']['p50_ms']:.2f} "
        f"mean={lat['decode']['mean_ms']:.2f}; prefill_chunk_exact "
        f"p50={lat['prefill_chunk_exact']['p50_ms']:.2f} ms; peak device "
        f"memory {peak_gib:.2f} GiB")
    for rid in (0, 1):
        prompt = list(trace[rid].prompt)
        with plain_versions():
            ref = _first_token_logits(engine, tables, prompt,
                                      engine.prefill_chunk)
        row = engine.first_logits[rid]
        assert row.shape == (1, cfg.vocab_size), row.shape
        assert row.dtype == torch.bfloat16 and row.device.type == "cpu"
        got = row[0].float()
        d = (got - ref).abs().max().item()
        peak = ref.abs().max().item()
        assert torch.isfinite(got).all()
        assert d <= LOGIT_REL_TOL * peak, (rid, d, peak)
        log(f"[serve] request {rid} (prompt {len(prompt)}): first-token "
            f"logits (1, V) bf16 row, kernel vs plain max|d|={d:.3e} "
            f"(max|ref|={peak:.3f}, tol {LOGIT_REL_TOL} x max|ref|); argmax "
            f"{int(got.argmax())} vs {int(ref.argmax())}")
    check_chunk_equals_stepwise(engine, tables, list(trace[0].prompt))
    return launches, engine


class OpTrace:
    """Records the output of every op of the decode path (embedding,
    norms, projections, RoPE, attention, MLP, logits), labelled with its
    layer, one list per decode_step / decode_chunk call."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.calls = []
        self._layer = -1

    def _record(self, name, out):
        self.calls[-1].append((name, out))
        return out

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.models import attention, decode, transformer
        from repro_torch.sparsity import sparse_linear
        patches = []

        def patch(mod, attr, wrapper):
            patches.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrapper(getattr(mod, attr)))

        def at_layer(name):
            def wrapper(fn):
                def f(*a, **kw):
                    return self._record(f"L{self._layer} {name}", fn(*a, **kw))
                return f
            return wrapper

        def embed(fn):
            def f(*a, **kw):
                self.calls.append([])
                self._layer = -1
                return self._record("embed", fn(*a, **kw))
            return f

        def norm1(fn):
            def f(*a, **kw):
                self._layer += 1
                name = ("final_norm" if self._layer == self.n_layers
                        else f"L{self._layer} norm1")
                return self._record(name, fn(*a, **kw))
            return f

        def dense_fn(method):
            def f(tables_self, slices):
                mm = method(tables_self, slices)

                def rec(w, x, name):
                    return self._record(f"L{self._layer} {name}", mm(w, x, name))
                return rec
            return f

        patch(decode, "embed_tokens", embed)
        patch(decode, "apply_norm", norm1)
        patch(decode, "logits_from_hidden", at_layer("logits"))
        patch(transformer, "apply_norm", at_layer("norm2"))
        patch(transformer, "apply_mlp", at_layer("mlp"))
        patch(attention, "apply_rope", at_layer("rope"))
        patch(attention, "_sdpa", at_layer("sdpa"))
        patch(sparse_linear.StackedKernelTables, "dense_fn", dense_fn)
        try:
            yield self
        finally:
            for mod, attr, orig in reversed(patches):
                setattr(mod, attr, orig)


def _first_parting(chunk_call, step_calls):
    """Ops (label, max|d|) where a one-chunk prefill and stepwise decode
    of the same tokens differ, in the order the model runs them. Token t of
    the chunk's output (dim 1) is compared with step t's; the logits, which
    the chunk gives for its last token only, with the last step's."""
    labels = [lab for lab, _ in chunk_call]
    for call in step_calls:
        assert [lab for lab, _ in call] == labels
    parted = []
    for j, (label, tc) in enumerate(chunk_call):
        if label.endswith("logits"):
            pairs = [(tc[:, 0], step_calls[-1][j][1][:, 0])]
        else:
            pairs = [(tc[:, t], step[j][1][:, 0])
                     for t, step in enumerate(step_calls)]
        if not all(torch.equal(a, b) for a, b in pairs):
            d = max((a.float() - b.float()).abs().max().item()
                    for a, b in pairs)
            parted.append((label, d))
    return parted


def check_chunk_equals_stepwise(engine, tables, prompt):
    """Chunked prefill == stepwise decode at model level on the card
    (kernel path, batch 1): op by op through every layer over one
    chunk, then the first-token logits of the whole prompt. Fails naming
    the first op where the two paths part."""
    C = engine.prefill_chunk
    part = prompt[:C]
    trace = OpTrace(engine.cfg.n_layers)
    with trace.recording():
        _first_token_logits(engine, tables, part, C)
        _stepwise_logits(engine, tables, part)
    assert len(trace.calls) == 1 + len(part)
    parted = _first_parting(trace.calls[0], trace.calls[1:])
    n_ops = len(trace.calls[0])
    if parted:
        worst = max(parted, key=lambda p: p[1])
        log(f"[serve] chunked prefill vs stepwise decode ({len(part)} "
            f"tokens, batch 1): {len(parted)} of {n_ops} ops differ; first "
            f"{parted[0][0]} max|d|={parted[0][1]:.3e}; largest {worst[0]} "
            f"max|d|={worst[1]:.3e}")
    assert not parted, parted[:3]
    log(f"[serve] chunked prefill vs stepwise decode ({len(part)} tokens, "
        f"batch 1): all {n_ops} ops bitwise equal, token by token, through "
        f"all {engine.cfg.n_layers} layers")
    chunked = _first_token_logits(engine, tables, prompt, C)
    stepwise = _stepwise_logits(engine, tables, prompt)
    assert torch.equal(chunked, stepwise), \
        (chunked - stepwise).abs().max().item()
    log(f"[serve] request 0 (prompt {len(prompt)}, "
        f"{-(-len(prompt) // C)} chunks): chunked prefill first-token logits "
        f"bitwise equal to stepwise decode's")


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


def _full_width_layer(cfg, dev):
    """One tinyllama-1.1b decoder layer's params at full width, random
    from a seeded generator on the card."""
    from repro_torch.models.attention import init_attention
    from repro_torch.models.layers import init_mlp, init_norm
    gen = torch.Generator(device=dev).manual_seed(4)
    return {"norm1": init_norm(cfg, cfg.d_model, dev),
            "attn": init_attention(cfg, gen, dev),
            "norm2": init_norm(cfg, cfg.d_model, dev),
            "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dev)}


def _run_layer(cfg, p, x, mm):
    """x (B, S, D) through norm -> chunked attention into an empty cache
    -> residual -> norm -> MLP -> residual, the projections through mm."""
    from repro_torch.models.attention import prefill_attention
    from repro_torch.models.layers import apply_mlp, apply_norm
    B, S, _ = x.shape
    kv = torch.zeros((B, S, cfg.n_kv_heads, cfg.hd), dtype=x.dtype,
                     device=x.device)
    y, _, _ = prefill_attention(
        p["attn"], apply_norm(p["norm1"], x, cfg), kv, kv.clone(),
        torch.zeros((B,), dtype=torch.int32, device=x.device),
        torch.full((B,), S, dtype=torch.int32, device=x.device), cfg,
        dense_fn=mm)
    h = x + y
    return h + apply_mlp(p["mlp"], apply_norm(p["norm2"], h, cfg), cfg,
                         dense_fn=mm)


def phase_modes(dev):
    """One full-width layer through the per-layer kernel-mode hook in modes
    value and bit. Returns (launches per kernel over the path, the packed
    named tables per mode)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import make_matmul
    from repro_torch.sparsity.sparse_linear import build_kernel_tables
    kernel_of = {"value": "block_sparse_matmul", "bit": "fta_int8_matmul"}
    base = get_config("tinyllama-1.1b")
    p = _full_width_layer(base, dev)
    named = {**{k: p["attn"][k] for k in ("wq", "wk", "wv", "wo")},
             **p["mlp"]}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((4, 64, base.d_model), generator=gen)
    x = x.to(torch.bfloat16).to(dev)
    x1 = x[:, :1].contiguous()
    counts, tables_by_mode = {}, {}
    for mode, kname in kernel_of.items():
        cfg = base.scaled(dbpim=True, dbpim_mode=mode,
                          dbpim_value_sparsity=0.6)
        tables = build_kernel_tables(named, cfg)
        assert {t["kind"] for t in tables.values()} == {mode}, mode
        tables_by_mode[mode] = tables
        mm = make_matmul(cfg, tables)
        torch.cuda.synchronize()
        reset_launches()
        y = _run_layer(cfg, p, x, mm)
        torch.cuda.synchronize()
        per_call = read_launches()
        assert per_call == {**{k: 0 for k in per_call}, kname: 7,
                            "row_attention": 1, "row_norm": 2}, \
            (mode, per_call)
        counts[kname] = per_call[kname]
        with plain_versions():
            ref = _run_layer(cfg, p, x, mm)
        peak = ref.float().abs().max().item()
        err = (y.float() - ref.float()).abs().max().item()
        assert torch.isfinite(y).all() and err <= LAYER_REL_TOL * peak, \
            (mode, err, peak)
        reset_launches()
        _run_layer(cfg, p, x1, mm)
        torch.cuda.synchronize()
        decode_launches = read_launches()[kname]
        log(f"[modes] {mode}: one full-width layer at 4 x 64 = 256 rows, "
            f"{per_call[kname]} {kname} launches; vs plain versions "
            f"max|d|={err:.3e} (max|ref|={peak:.3f}, tol {LAYER_REL_TOL} x "
            f"max|ref|); a 4-row decode call launches it "
            f"{decode_launches} times (rows % 128 != 0: the reference's "
            f"plain math)")
    return counts, tables_by_mode


def phase_dbmu(cfg, dev):
    """The quickstart pipeline at every projection shape on the card, then
    the quickstart itself. Returns the dbmu_matmul launches of the path."""
    from repro_torch import quickstart
    from repro_torch.core import pruning
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(7)
    data = []
    for name, K, N in _distinct(_path_shapes(cfg)):
        w = torch.randn((K, N), generator=gen) * K ** -0.5
        x = _int8_extremes(torch.randint(-128, 128, (256, K), generator=gen,
                                         dtype=torch.int32))
        data.append((name, K, N, w, x))
    torch.cuda.synchronize()
    reset_launches()
    for name, K, N, w, x in data:
        t0 = time.monotonic()
        mask = pruning.block_prune_mask(w.to(dev), 0.6, alpha=8)
        q, scale, packed, phi = ops.fta_pack(w.to(dev), mask)
        y = ops.dbmu_reference_check(x.to(dev), packed)
        want = ref.dbmu_matmul_ref(x.to(dev), packed)
        torch.cuda.synchronize()
        t_card = time.monotonic() - t0
        assert torch.equal(y.long(), want), (name, "dbmu")
        mask_cpu = pruning.block_prune_mask(w, 0.6, alpha=8)
        q_cpu, scale_cpu, packed_cpu, phi_cpu = ops.fta_pack(w, mask_cpu)
        for a, b, what in ((mask, mask_cpu, "mask"), (q, q_cpu, "q"),
                           (packed, packed_cpu, "packed"),
                           (phi, phi_cpu, "phi")):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), \
                (name, what)
        assert float(scale) == float(scale_cpu)
        log(f"[dbmu] {name} {K}x{N}: value sparsity "
            f"{pruning.value_sparsity(mask):.3f}, phi_th histogram "
            f"{torch.bincount(phi.long(), minlength=3).tolist()}; card "
            f"mask/INT8/terms == cpu byte for byte; dbmu_matmul M=256 == "
            f"integer matmul exactly ({t_card:.2f} s on the card)")
    res = quickstart.run("cuda")
    torch.cuda.synchronize()
    counts = read_launches()
    assert res["pack_exact"] and res["dbmu_exact"] and \
        res["joint_err"] < 1e-5, res
    assert counts["dbmu_matmul"] == len(data) + 1, counts
    log(f"[dbmu] quickstart on the card: pack/unpack exact, DBMU bit-true, "
        f"speedup {res['speedup']:.2f}x, joint kernel max|d| "
        f"{res['joint_err']:.2e}; dbmu_matmul launches on the path "
        f"{counts['dbmu_matmul']}")
    return counts["dbmu_matmul"]


def _profile_window(window, n_calls):
    """(wall ms, busy ms, device ops, joint ms, device-side records) per
    call of ``window``: wall time from a run without the profiler, the rest
    from torch.profiler's device-side records of a second, identical run;
    busy None when the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    window()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.monotonic()
    window()
    wall_ms = 1e3 * (time.monotonic() - t0) / n_calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        window()
    # device-side records only (kernels, copies): a CPU op's record also
    # carries the device time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_calls
    if busy_ms == 0:
        return wall_ms, None, 0, 0.0, []
    joint_ms = sum(e.self_device_time_total for e in kernels
                   if any(sym in e.key for sym in JOINT_SYMBOLS)) / 1e3 / n_calls
    ops = sum(e.count for e in kernels) / n_calls
    return wall_ms, busy_ms, ops, joint_ms, kernels


def phase_profile(engine, n_steps=8, n_chunks=4):
    """Device busy and idle share over a window of decode calls of the
    served engine (all slots active) and over a window of prefill-chunk
    calls (every slot a full chunk, from an empty cache), the joint
    kernel's share of the busy time, and where the device time goes."""
    from repro_torch.models import init_cache
    dev = engine.device
    tok = torch.ones((engine.n_slots, 1), dtype=torch.int32, device=dev)
    active = torch.ones((engine.n_slots,), dtype=torch.bool, device=dev)
    state = {"cache": engine.cache}

    def decode_window():
        for _ in range(n_steps):
            lg, state["cache"] = engine._decode(engine.params, state["cache"],
                                                tok, active)
            lg.float().cpu()                   # the engine's per-tick sync

    C = engine.prefill_chunk
    chunk = torch.ones((engine.n_slots, C), dtype=torch.int32, device=dev)
    n_valid = torch.full((engine.n_slots,), C, dtype=torch.int32, device=dev)

    def prefill_window():
        cache = init_cache(engine.cfg, engine.n_slots, engine.max_len,
                           device=dev)
        cache["pos"] = torch.zeros((engine.n_slots,), dtype=torch.int32,
                                   device=dev)
        for _ in range(n_chunks):
            lg, cache = engine._prefill(engine.params, cache, chunk, n_valid)
            lg[:, 0].float().cpu()             # the engine's per-call sync

    for what, window, n, rows in (
            ("decode call", decode_window, n_steps, engine.n_slots),
            ("prefill-chunk call", prefill_window, n_chunks,
             engine.n_slots * C)):
        wall_ms, busy_ms, ops, joint_ms, kernels = _profile_window(window, n)
        if busy_ms is None:
            log(f"[profile] {what}: device busy share not measured (the "
                f"profiler recorded no device time)")
            continue
        log(f"[profile] {what} (batch {engine.n_slots}, {rows} rows per "
            f"projection, {n} calls): {wall_ms:.2f} ms wall, device busy "
            f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
            f"{ops:.0f} device ops per call; joint kernel {joint_ms:.3f} "
            f"ms/call, {joint_ms / busy_ms:.1%} of busy")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            ms = e.self_device_time_total / 1e3 / n
            log(f"[profile]   {ms:.3f} ms/call ({ms / busy_ms:.1%} of busy), "
                f"{e.count / n:.0f}/call: {e.key[:100]}")


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


def _time_auto(fn, budget_s=0.2):
    """Mean ms per call with CUDA events after warm-up, over as many calls
    as fit in about ``budget_s`` (at least 3, at most 200)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    once = max(time.monotonic() - t0, 1e-6)
    iters = int(min(200, max(3, budget_s / once)))
    return _time(fn, iters=iters, warmup=min(iters, 5))


def _host_us(fn, iters=20, windows=7):
    """Host µs per call: the time to issue ``iters`` back-to-back calls,
    read before the device has finished them (the launch queue holds them
    all), so the wrapper's and the launch's host work alone; the fastest of
    ``windows`` windows, since the host's other work only ever adds."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * best / iters


def _device_ms(fn, iters=10, attempts=3):
    """Mean device time per call (ms) from torch.profiler's device-side
    records (kernels, copies) over ``iters`` calls after a warm-up call:
    what the card spent, without the wrappers' host time. A profiling
    window now and then comes back with no device records; it is taken
    again, up to ``attempts`` times in all, and None is returned if none
    recorded device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    return None


def _bound(nbytes, ops, peak_ops):
    """(bound ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_cases(cfg, packs, tables_by_mode, dev, n_slots=4, M=256):
    """Per work unit, one case per launch: the kernel, its plain version
    and the library call as closures, with the bytes and operations the
    launch needs. The joint kernel at the decode shapes (M = n_slots) and,
    as units of their own, at the JOINT_PREFILL_M rows; the block-sparse
    and FTA/INT8 kernels over phase 5's layer tables and the DBMU kernel
    over the four projection shapes (M rows)."""
    from repro_torch.core import dyadic, pruning
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import dbmu_sim
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(3)
    bf16 = torch.bfloat16
    cases = {name: [] for name in KERNELS}
    joint_units = {"joint_sparse_matmul": n_slots,
                   **{f"{JOINT_UNIT} M={m}": m for m in JOINT_PREFILL_M}}
    cases.update({unit: [] for unit in joint_units})
    for name, K, N in _path_shapes(cfg):
        p = packs[(K, N)]
        w_dense = ops.unpack_joint_sparse(p).to(bf16)
        stored = p.w_blocks.numel()
        nt, maxb, _, bn = p.w_blocks.shape
        for unit, rows in joint_units.items():
            x = torch.randn((rows, K), generator=gen).to(bf16).to(dev)
            cases[unit].append(dict(
                name=name, K=K, N=N, NT=nt, MAXB=maxb,
                kernel=lambda x=x, p=p: jsm.joint_sparse_matmul(
                    x, p.w_blocks, p.idx, p.scales),
                plain=lambda x=x, p=p: jsm.joint_sparse_matmul_plain(
                    x, p.w_blocks, p.idx, p.scales),
                library=lambda x=x, w=w_dense: torch.matmul(x, w),
                bytes=(x.numel() * 2 + stored + p.idx.numel() * 4
                       + p.scales.numel() * 4 + rows * nt * bn * 2),
                ops=2 * rows * stored, peak=BF16_FLOPS, repeat=cfg.n_layers))
        x = torch.randn((M, K), generator=gen).to(bf16).to(dev)
        t = tables_by_mode["value"][name]
        wb, idx, w_dense = t["w_blocks"].to(bf16), t["idx"], t["w"].to(bf16)
        stored = wb.numel()
        cases["block_sparse_matmul"].append(dict(
            name=name, K=K, N=N, NT=wb.shape[0], MAXB=wb.shape[1],
            kernel=lambda x=x, wb=wb, idx=idx: bsk.block_sparse_matmul(
                x, wb, idx),
            plain=lambda x=x, wb=wb, idx=idx: bsk.block_sparse_matmul_plain(
                x, wb, idx),
            library=lambda x=x, w=w_dense: torch.matmul(x, w),
            bytes=x.numel() * 2 + stored * 2 + idx.numel() * 4 + M * N * 2,
            ops=2 * M * stored, peak=BF16_FLOPS))
        t = tables_by_mode["bit"][name]
        q, sc = t["q"], t["scales"]
        w_deq = (q.float() * sc).to(bf16)
        cases["fta_int8_matmul"].append(dict(
            name=name, K=K, N=N,
            kernel=lambda x=x, q=q, sc=sc: ftk.fta_int8_matmul(x, q, sc),
            plain=lambda x=x, q=q, sc=sc: ftk.fta_int8_matmul_plain(x, q, sc),
            library=lambda x=x, w=w_deq: torch.matmul(x, w),
            bytes=x.numel() * 2 + K * N + N * 4 + M * N * 2,
            ops=2 * M * K * N, peak=BF16_FLOPS))
    for name, K, N in _distinct(_path_shapes(cfg)):
        w = (torch.randn((K, N), generator=gen) * K ** -0.5).to(dev)
        _, _, packed, _ = ops.fta_pack(
            w, pruning.block_prune_mask(w, 0.6, alpha=8))
        x = torch.randint(-128, 128, (M, K), generator=gen,
                          dtype=torch.int32).to(dev)
        x8 = x.to(torch.int8)
        w8 = dyadic.unpack_terms(packed).to(torch.int8)
        cases["dbmu_matmul"].append(dict(
            name=name, K=K, N=N,
            kernel=lambda x=x, p=packed: dbmu_sim.dbmu_matmul(x, p),
            plain=lambda x=x, p=packed: dbmu_sim.dbmu_matmul_plain(x, p),
            library=lambda a=x8, b=w8: torch._int_mm(a, b),
            bytes=x.numel() * 4 + K * N * 2 + M * N * 4,
            ops=2 * M * K * N, peak=INT8_OPS))
    attn = _row_attention_cases(cfg, dev, gen)
    norm = _row_norm_cases(cfg, dev, gen)
    cases["row_attention"] = [c for c in attn if c["name"] != "long context"]
    cases[ATTN_LONG_UNIT] = [c for c in attn if c["name"] == "long context"]
    cases["row_norm"] = [c for c in norm if c["K"] != LONG_B * LONG_C]
    cases[NORM_LONG_UNIT] = [c for c in norm if c["K"] == LONG_B * LONG_C]
    return cases


def _row_attention_cases(cfg, dev, gen):
    """A decode call and a prefill-chunk call of one layer's attention at
    the serving shapes, and a prefill-chunk call of the long-context cell,
    each repeated over the layers. Bytes: the queries, positions and
    outputs once, and the live cache rows of each slot once; operations:
    4 * hd per live key and query head."""
    import torch.nn.functional as F
    from repro_torch.kernels import row_attention as rak
    serve = _serve_attention_inputs(cfg, dev, torch.bfloat16, gen)
    long = _long_attention_inputs(cfg, dev, torch.bfloat16, gen)
    cases = []
    for what, a in (("decode", serve), ("chunk", serve), ("long", long)):
        k, v = a["k"], a["v"]
        B, A, Hkv, hd = k.shape
        rep = cfg.n_heads // Hkv
        kh = torch.repeat_interleave(k, rep, dim=2).transpose(1, 2)
        vh = torch.repeat_interleave(v, rep, dim=2).transpose(1, 2)
        q, pos = a[what]
        live = torch.clamp(pos.long(), max=A - 1) + 1               # (B, Sq)
        mask = (torch.arange(A, device=dev)[None, None] <
                live[:, :, None])[:, None]                          # (B,1,Sq,A)
        qh = q.transpose(1, 2)
        cases.append(dict(
            name="long context" if what == "long" else what,
            K=tuple(q.shape), N=tuple(k.shape),
            kernel=lambda q=q, pos=pos, k=k, v=v: rak.row_attention(
                q, k, v, pos),
            plain=lambda q=q, pos=pos, k=k, v=v: rak.row_attention_plain(
                q, k, v, pos),
            library=lambda qh=qh, mask=mask, kh=kh, vh=vh:
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
            bytes=(2 * q.numel() * 2 + pos.numel() * 4
                   + 2 * int(live.max(dim=1).values.sum()) * Hkv * hd * 2),
            ops=4 * hd * cfg.n_heads * int(live.sum()), peak=BF16_FLOPS,
            repeat=cfg.n_layers))
    return cases


def _row_norm_cases(cfg, dev, gen):
    """The norms of a decode call (4 rows), of a prefill-chunk call (256
    rows) and of a long-context prefill-chunk call (16 x 256 rows), 2 per
    layer and the final one. Bytes: x and out once, the scale once;
    operations: 4 fp32 flops per element."""
    import torch.nn.functional as F
    from repro_torch.kernels import row_norm as rnk
    D = cfg.d_model
    scale = (1 + 0.1 * torch.randn((D,), generator=gen)).to(dev)
    scale_bf16 = scale.to(torch.bfloat16)
    cases = []
    for R in (4, 256, LONG_B * LONG_C):
        x = torch.randn((R, D), generator=gen).to(torch.bfloat16).to(dev)
        library = None
        if hasattr(F, "rms_norm"):
            library = (lambda x=x: F.rms_norm(x, (D,), scale_bf16, 1e-6))
        cases.append(dict(
            name=f"{R} rows", K=R, N=D,
            kernel=lambda x=x: rnk.row_norm(x, scale),
            plain=lambda x=x: rnk.row_norm_plain(x, scale),
            library=library,
            bytes=2 * R * D * 2 + D * 4, ops=4 * R * D, peak=FP32_FLOPS,
            repeat=2 * cfg.n_layers + 1))
    return cases


def phase_times(cfg, packs, tables_by_mode, dev):
    """Each kernel, its plain version and its library yardstick, launch by
    launch over its work unit, beside the bound; the joint kernel's
    decode-step totals count each projection once per layer. Returns
    {kernel: totals and per-launch rows for the JSON line}."""
    def us(v):
        return "not measured" if v is None else f"{v * 1e3:.1f} us"

    def ms_(v):
        return "n/a" if v is None else f"{v:.4f} ms"

    out = {}
    for kname, rows in _time_cases(cfg, packs, tables_by_mode, dev).items():
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                   library_device_ms=0.0, bytes=0, ops=0, host_us=0.0)
        per_shape = []
        n_launches = 0
        for c in rows:
            repeat = c.get("repeat", 1)
            n_launches += repeat
            ms, plain = _time_auto(c["kernel"]), _time_auto(c["plain"])
            dev_ms, host = _device_ms(c["kernel"]), _host_us(c["kernel"])
            lib = lib_dev = None
            if c["library"]:
                lib, lib_dev = (_time_auto(c["library"]),
                                _device_ms(c["library"]))
            bound, by = _bound(c["bytes"], c["ops"], c["peak"])
            per_shape.append(dict(
                {k: v for k, v in c.items()
                 if k not in ("kernel", "plain", "library", "peak")},
                ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=bound, bound_by=by,
                host_us=host))
            for key, val in (("ms", ms), ("device_ms", dev_ms),
                             ("plain_ms", plain), ("library_ms", lib),
                             ("library_device_ms", lib_dev),
                             ("bytes", c["bytes"]), ("ops", c["ops"]),
                             ("host_us", host)):
                tot[key] = None if val is None or tot[key] is None \
                    else tot[key] + repeat * val
            log(f"[times] {kname} {c['name']} {c['K']}x{c['N']}: kernel "
                f"{us(ms)} (device {us(dev_ms)}, host {host:.1f} us), plain "
                f"{us(plain)}, library "
                f"{'n/a' if c['library'] is None else us(lib)} (device "
                f"{'n/a' if c['library'] is None else us(lib_dev)}), bound "
                f"{bound * 1e3:.2f} us ({by}, {c['bytes'] / 1e6:.3f} MB)")
        tot["bound_ms"], tot["bound_by"] = _bound(tot["bytes"], tot["ops"],
                                                  rows[0]["peak"])
        tot["host_us"] /= n_launches             # per launch
        tot["per_shape"] = per_shape
        out[kname] = tot
        log(f"[times] {kname}, {n_launches} launches: kernel "
            f"{ms_(tot['ms'])} (device {ms_(tot['device_ms'])}), plain "
            f"{ms_(tot['plain_ms'])}, library {ms_(tot['library_ms'])} "
            f"(device {ms_(tot['library_device_ms'])}), bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}, "
            f"{tot['bytes'] / 1e6:.1f} MB); host {tot['host_us']:.1f} us per "
            f"launch")
    return out


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
    worst = {"joint_sparse_matmul": phase_kernel(cfg, packs, dev),
             **phase_kernel_value_bit_dbmu(cfg, dev)}
    worst.update(phase_kernel_rows(cfg, dev))
    serve_launches, engine = phase_serve(dev)
    mode_launches, tables_by_mode = phase_modes(dev)
    launches = {**serve_launches, **mode_launches,
                "dbmu_matmul": phase_dbmu(cfg, dev)}
    phase_profile(engine)
    times = phase_times(cfg, packs, tables_by_mode, dev)

    kernels = []
    for name, replaces, work in (
            ("joint_sparse_matmul", "kernels/joint_sparse_matmul.py:129",
             "one decode step: 22 layers x 7 projections, M=4, bf16"),
            ("block_sparse_matmul", "kernels/block_sparse_matmul.py:73",
             "one full-width layer: 7 projections, M=256, bf16, vs=0.6"),
            ("fta_int8_matmul", "kernels/fta_int8_matmul.py:68",
             "one full-width layer: 7 projections, M=256, bf16 x, int8 W"),
            ("dbmu_matmul", "kernels/dbmu_sim.py:74",
             "the four projection shapes, M=256, int8-range x"),
            ("row_attention", "models/attention.py:48",
             "one decode call and one 64-token prefill-chunk call: 22 "
             "launches each, batch 4, 512-slot cache, bf16 (replaces plain "
             "jnp einsums, no TPU kernel)"),
            ("row_norm", "models/layers.py:33",
             "one decode call (4 rows) and one prefill-chunk call (256 "
             "rows): 45 launches each, d=2048, bf16 (replaces plain jnp, no "
             "TPU kernel)")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/{replaces}",
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "host_us": t["host_us"], "work": work,
            "per_shape": t["per_shape"]})
        units = {"joint_sparse_matmul": [
            (f"one prefill call: 22 layers x 7 projections, M={m}, bf16",
             f"{JOINT_UNIT} M={m}") for m in JOINT_PREFILL_M],
            "row_attention": [
                ("one long-context prefill-chunk call: 22 launches, batch 16 "
                 "x 256 queries, 2048-slot cache, bf16", ATTN_LONG_UNIT)],
            "row_norm": [
                ("one long-context prefill-chunk call: 45 launches, 4096 "
                 "rows, d=2048, bf16", NORM_LONG_UNIT)]}.get(name)
        if units:
            kernels[-1]["units"] = [
                {"work": w, **{k: v for k, v in times[u].items()
                               if k != "per_shape"}} for w, u in units]
    assert all(k["launches"] > 0 for k in kernels), \
        [(k["name"], k["launches"]) for k in kernels]
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
