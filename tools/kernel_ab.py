"""Time two trees' versions of the port's kernels on one card, in turns.

    python3 tools/kernel_ab.py --other build/parent

``--other`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into ``build/``, which git ignores).
For ``dbmu_matmul``, ``fta_int8_matmul``, ``joint_sparse_matmul``,
``block_sparse_matmul``, ``row_attention`` and ``row_norm``, both trees'
``src/repro_torch/kernels/csrc/<name>.cu`` are compiled by nvcc with the
port's flags into ``build/kernel_ab/``, all builds at once, and both versions are called through their C entry points,
which have the same signature in both trees, on the same inputs. The work
units (tinyllama-1.1b's projections at full width, random weights from a
seed):

  * dbmu_matmul: the four projection shapes at M = 256, weights through
    the DB-PIM pipeline (block pruning at 0.6, alpha 8, FTA, dyadic terms),
    x uniform over the int8 range.
  * fta_int8_matmul: one layer's seven projections at M = 256, bf16 x,
    bf16 out, INT8/FTA weights with per-filter scales.
  * joint_sparse_matmul: one decode step (the seven projections at M = 4,
    each counted once per layer: 154 launches), and one layer at M = 64 and
    at M = 256; bf16 x and out, the joint pack at vs = 0.6 (bk = bn = 128);
    and one layer at M = 4 with f32 x (the CUDA-core path).
  * block_sparse_matmul: one layer at M = 256, the value pack at vs = 0.6
    (global tile pruning), bf16 x and payload; and the same with f32 x.
  * row_attention (bf16): one layer's attention of a decode call (batch 4,
    512-slot cache), of a 64-query prefill-chunk call, and of a prefill
    call of the long-context cell (batch 16 x 256 queries, 2048-slot
    cache), each counted once per layer (22 launches); the streaming case
    (64 queries at the end of 32,768 keys, 22 launches); whisper-base's
    encoder (4 x 1,500 non-causal queries, 6 launches); pixtral-12b's
    forward (2 x 512 causal queries, 40 launches); gemma-7b's decode call
    (hd 256, group 1, 28 launches); and the windowed streaming case
    (mixtral's window of 4,096 at the end of 32,768 keys, 32 launches):
    the inputs of ``chip_smoke.py``'s times phase.
  * row_norm (bf16 RMSNorm, d = 2048): 4, 256 and 4096 rows, each counted
    45 times (2 per layer and the final norm).
  * row_norm_bwd, the norm backward (entry point ``row_norm_bwd_launch``
    in ``row_norm.cu``, each tree's ``partial`` sized by its own
    ``row_norm_bwd_slots``): 1,024 rows (tinyllama's training batch, 8 x
    128) of RMSNorm at d = 2048 and 4096 (the gated norm's width) and of
    LayerNorm at d = 2048 in bf16, and of RMSNorm at d = 2048 in f32, each
    counted 45 times (a training step's norms).
  * row_attention_bwd_dq and row_attention_bwd_dkv, the backward kernels
    (a) and (b) (entry points ``row_attention_bwd_dq_launch`` and
    ``row_attention_bwd_dkv_launch`` in ``row_attention.cu``): tinyllama's
    training shape (B 8 x S 128 causal, 32 / 4 heads of 64, bf16, 22
    launches: a step's layers) and ``chip_smoke.py``'s long phase-9 case
    (B 1 x S 2048) in bf16 and f32, 22 launches each. Kernel (b) is given
    the rows' lse and D from their plain version, the same for both trees.

Each version's outputs are first held against the plain version (DBMU bit
for bit; bf16 out within one bf16 ulp of the peak, attention within 2^-6
of it, f32 out within 1e-5 of it); a version that disagrees fails the
run, and so do f32 attention backward outputs that are not bitwise the
same in both trees (the norm backward's parameter sums may change their
order between trees). ``--kernels`` picks some of the kernels. Then, in
the turns other, this, this, other, each shape is timed with CUDA events
over back-to-back
launches, in device time from torch.profiler's device-side records (the
clocks of ``chip_smoke.py``'s times phase), and in host µs per launch: the
time to issue back-to-back calls, before the device has finished them (the
fastest of several windows). For the joint, block-sparse, attention and
norm units the host time is that of the port's Python wrapper, whose
library is swapped for each tree's (the wrappers are the same in both
trees); for the others, that of the C entry point; and for every unit also
that of the C entry point alone, where the two trees' code differs. The
card's name and power limit are printed first, then a line per unit and
turn, then the whole result as one JSON object on the last line. Needs a
CUDA card and nvcc.
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
from chip_smoke import (ATTN_BWD_CASES, ATTN_REL_TOL,  # noqa: E402
                        LONG_B, LONG_C, PIXTRAL_BATCH, PIXTRAL_TOKENS,
                        STREAM_A_BF16, STREAM_C, _attn_bwd_inputs,
                        _device_ms, _encoder_attention_inputs,
                        _host_us, _long_attention_inputs,
                        _serve_attention_inputs, _stream_attention_inputs,
                        _time, _window_inputs)

LAYER = [("wq", 2048, 2048), ("wk", 2048, 256), ("wv", 2048, 256),
         ("wo", 2048, 2048), ("w_gate", 2048, 5632), ("w_up", 2048, 5632),
         ("w_down", 5632, 2048)]
DBMU_SHAPES = [("wq", 2048, 2048), ("wk", 2048, 256), ("w_gate", 2048, 5632),
               ("w_down", 5632, 2048)]
N_LAYERS = 22
#: (kernel, unit label, M, shapes, launches of each shape per unit, x dtype)
UNITS = [
    ("dbmu_matmul", "four shapes, M=256", 256, DBMU_SHAPES, 1, torch.int32),
    ("fta_int8_matmul", "one layer, M=256", 256, LAYER, 1, torch.bfloat16),
    ("joint_sparse_matmul", "decode step, M=4", 4, LAYER, N_LAYERS,
     torch.bfloat16),
    ("joint_sparse_matmul", "one layer, M=64", 64, LAYER, 1, torch.bfloat16),
    ("joint_sparse_matmul", "one layer, M=256", 256, LAYER, 1,
     torch.bfloat16),
    ("joint_sparse_matmul", "one layer, M=4, f32 x", 4, LAYER, 1,
     torch.float32),
    ("block_sparse_matmul", "one layer, M=256", 256, LAYER, 1,
     torch.bfloat16),
    ("block_sparse_matmul", "one layer, M=256, f32 x", 256, LAYER, 1,
     torch.float32),
    ("row_attention", "decode call", None, [("decode", 0, 0)], N_LAYERS,
     torch.bfloat16),
    ("row_attention", "64-query chunk call", None, [("chunk", 0, 0)],
     N_LAYERS, torch.bfloat16),
    ("row_attention", "long-context chunk call", None, [("long", 0, 0)],
     N_LAYERS, torch.bfloat16),
    ("row_attention", "streaming, 32768 keys", None, [("stream", 0, 0)],
     N_LAYERS, torch.bfloat16),
    ("row_attention", "whisper-base encoder call", None,
     [("encoder", 0, 0)], 6, torch.bfloat16),
    ("row_attention", "pixtral-12b forward call", None, [("forward", 0, 0)],
     40, torch.bfloat16),
    ("row_attention", "gemma-7b decode call", None, [("gemma", 0, 0)], 28,
     torch.bfloat16),
    ("row_attention", "windowed streaming, window 4096", None,
     [("window", 0, 0)], 32, torch.bfloat16),
    ("row_norm", "4 rows", 4, [("rms", 0, 2048)], 2 * N_LAYERS + 1,
     torch.bfloat16),
    ("row_norm", "256 rows", 256, [("rms", 0, 2048)], 2 * N_LAYERS + 1,
     torch.bfloat16),
    ("row_norm", "4096 rows", LONG_B * LONG_C, [("rms", 0, 2048)],
     2 * N_LAYERS + 1, torch.bfloat16),
] + [("row_norm_bwd", label, 1024, [(kind, 0, D)], 2 * N_LAYERS + 1, dt)
     for label, kind, D, dt in (
         ("RMSNorm, d=2048", "rms", 2048, torch.bfloat16),
         ("RMSNorm, d=4096", "rms", 4096, torch.bfloat16),
         ("LayerNorm, d=2048", "layernorm", 2048, torch.bfloat16),
         ("RMSNorm, d=2048, f32", "rms", 2048, torch.float32))
] + [(name, label, None, [(what, 0, 0)], N_LAYERS, dt)
     for name in ("row_attention_bwd_dq", "row_attention_bwd_dkv")
     for label, what, dt in (
         ("training step, B 8 x S 128", "train", torch.bfloat16),
         ("long sequence, B 1 x S 2048", "long", torch.bfloat16),
         ("long sequence, B 1 x S 2048, f32", "long", torch.float32))]
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: the arguments of each C entry point before the stream
SIGNATURE = {"dbmu_matmul": [_P] * 3 + [_I] * 3,
             "fta_int8_matmul": [_P] * 4 + [_I] * 5,
             "joint_sparse_matmul": [_P] * 5 + [_I] * 9,
             "block_sparse_matmul": [_P] * 4 + [_I] * 7,
             "row_attention": [_P] * 5 + [_I] * 7 + [_L, _L, _F, _I],
             "row_norm": [_P] * 4 + [_I, _I, _F, _I, _I],
             "row_norm_bwd": [_P] * 3 + [_I] + [_P] * 4 + [_I, _I, _F, _I, _I],
             "row_attention_bwd_dq": [_P] * 9 + [_I] * 7 + [_L, _L, _F, _I],
             "row_attention_bwd_dkv": [_P] * 9 + [_I] * 7 + [_L, _L, _F, _I]}
#: the source of each entry point, where it is not ``<kernel>.cu``
SOURCE = {"row_norm_bwd": "row_norm",
          "row_attention_bwd_dq": "row_attention",
          "row_attention_bwd_dkv": "row_attention"}
ORDER = ("other", "this", "this", "other")
ITERS = 20
#: host-time windows per shape; the fastest counts (chip_smoke._host_us)
HOST_WINDOWS = 15
VS = 0.6


def _build(trees, names):
    """{(label, name): loaded library}: one nvcc per (tree, source), all
    started together."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, tree in trees.items():
        for src_name in dict.fromkeys(SOURCE.get(n, n) for n in names):
            src = (tree / "src" / "repro_torch" / "kernels" / "csrc"
                   / f"{src_name}.cu")
            lib = out_dir / f"{label}-{src_name}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
            procs[(label, src_name)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    loaded = {}
    for key, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        loaded[key] = ctypes.CDLL(str(lib))
    return {(label, n): loaded[(label, SOURCE.get(n, n))] for label in trees
            for n in names}


def _entry(lib, name):
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = SIGNATURE[name] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _wrappers():
    """kernel -> its wrapper module (holding ``_LIB``), where the unit's
    host time is the wrapper's."""
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    return {"joint_sparse_matmul": jsm, "block_sparse_matmul": bsk,
            "row_attention": rak, "row_norm": rnk, "row_norm_bwd": rnk}


def _row_case(name, what, M, dev, gen):
    """One launch of an attention or norm unit, as ``_case``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    if name == "row_norm":
        x = torch.randn((M, 2048), generator=gen).to(torch.bfloat16).to(dev)
        scale = (1 + 0.1 * torch.randn((2048,), generator=gen)).to(dev)
        y = torch.empty_like(x)
        return dict(ptrs=(x, scale, None, y), ints=(M, 2048, 1e-6, 0, 1),
                    y=y, want=rnk.row_norm_plain(x, scale),
                    wrapper=lambda: rnk.row_norm(x, scale))
    bf16, window = torch.bfloat16, 0
    if what in ("decode", "chunk", "long", "stream"):
        cfg = get_config("tinyllama-1.1b")
        a = (_long_attention_inputs(cfg, dev, bf16, gen) if what == "long"
             else _stream_attention_inputs(cfg, dev, bf16, gen,
                                           STREAM_A_BF16)
             if what == "stream"
             else _serve_attention_inputs(cfg, dev, bf16, gen))
        (q, pos), k, v = a[what], a["k"], a["v"]
    elif what == "gemma":
        a = _serve_attention_inputs(get_config("gemma-7b"), dev, bf16, gen)
        (q, pos), k, v = a["decode"], a["k"], a["v"]
    elif what == "encoder":
        cfg = get_config("whisper-base")
        q, k, v, pos = _encoder_attention_inputs(cfg, dev, bf16, gen,
                                                 cfg.encoder_seq)
    else:
        cfg = get_config("pixtral-12b" if what == "forward"
                         else "mixtral-8x7b")
        S = cfg.n_patches + PIXTRAL_TOKENS
        q, k, v, pos = (_window_inputs(cfg, dev, bf16, gen, PIXTRAL_BATCH, S,
                                       S) if what == "forward"
                        else _window_inputs(cfg, dev, bf16, gen, 1,
                                            STREAM_A_BF16, STREAM_C))
        window = cfg.window
    B, Sq, Hq, hd = q.shape
    y = torch.empty_like(q)
    return dict(ptrs=(q, k, v, pos, y),
                ints=(B, Sq, Hq, k.shape[2], k.shape[1], hd, window,
                      k.stride(0), v.stride(0), hd ** -0.5, 1),
                y=y, want=rak.row_attention_plain(q, k, v, pos, window),
                tol=ATTN_REL_TOL,
                wrapper=lambda: rak.row_attention(q, k, v, pos, window))


def _norm_bwd_case(kind, D, dtype, dev, gen, R):
    """One launch of a norm backward unit, as ``_case``: dx, dscale (and
    dbias) from x, dy and the scale. ``ptrs`` takes the tree's library,
    whose ``row_norm_bwd_slots`` sizes that tree's ``partial``."""
    from repro_torch.kernels import row_norm as rnk
    x, dy = (torch.randn((R, D), generator=gen).to(dtype).to(dev)
             for _ in range(2))
    scale = (1 + 0.1 * torch.randn((D,), generator=gen)).to(dev)
    bias = ((0.1 * torch.randn((D,), generator=gen)).to(dev)
            if kind == "layernorm" else None)
    dx = torch.empty_like(x)
    dscale = torch.empty((D,), dtype=torch.float32, device=dev)
    dbias = None if bias is None else torch.empty_like(dscale)
    layer = int(bias is not None)

    def ptrs(lib):
        rows = (1 + layer) * lib.row_norm_bwd_slots(R, D)
        partial = torch.empty((rows, D), dtype=torch.float32, device=dev)
        return (x, dy, scale, layer, dx, partial, dscale, dbias)
    want = rnk.row_norm_backward_plain(dy, x, scale, bias)
    ys = [dx, dscale] + ([] if dbias is None else [dbias])
    return dict(ptrs=ptrs, ints=(R, D, 1e-6, 0, 0 if dtype == torch.float32
                                 else 1),
                ys=ys, wants=[w for w in want if w is not None],
                wrapper=lambda: rnk.row_norm_backward(dy, x, scale, bias))


def _bwd_case(name, what, dtype, dev, gen):
    """One launch of a backward unit, as ``_case``: kernel (a) writes dq,
    lse and D; kernel (b) reads the rows' lse and D (here from their plain
    version) and writes dk and dv. Both trees' f32 outputs must agree bit
    for bit."""
    from repro_torch.kernels import row_attention as rak
    case = ATTN_BWD_CASES[0 if what == "train" else 1]
    B, S, Hq, Hkv, hd, _ = case
    q, k, v, qpos, dout, window = _attn_bwd_inputs(case, dtype, dev, gen)
    qpos = qpos.contiguous()            # the entry points read (B, Sq) rows
    out = rak.row_attention(q, k, v, qpos, window)
    want = rak.row_attention_backward_plain(dout, q, k, v, qpos, window)
    ints = (B, S, Hq, Hkv, S, hd, window, k.stride(0), v.stride(0),
            hd ** -0.5, 0 if dtype == torch.float32 else 1)
    if name == "row_attention_bwd_dq":
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
        dq = torch.empty_like(q)
        return dict(ptrs=(q, k, v, qpos, out, dout, dq, lse,
                          torch.empty_like(lse)),
                    ints=ints, ys=[dq], wants=[want[0]], tol=ATTN_REL_TOL,
                    bitwise_f32=True, wrapper=None)
    rep = Hq // Hkv
    kr, vr = (torch.repeat_interleave(t, rep, dim=2) for t in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kr).float() * hd ** -0.5
    live = torch.arange(S, device=dev)[None, :] <= qpos[0][:, None]
    lse = torch.logsumexp(torch.where(live, logits, -float("inf")), -1)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    del kr, vr, logits
    return dict(ptrs=(q, k, v, qpos, dout, lse.contiguous(),
                      delta.contiguous(), dk, dv),
                ints=ints, ys=[dk, dv], wants=[want[1], want[2]],
                tol=ATTN_REL_TOL, bitwise_f32=True, wrapper=None)


def _case(name, K, N, M, xdt, dev, gen):
    """One launch of a unit: inputs, output, the launch arguments after the
    pointers, the plain version's output and the wrapper call (or None)."""
    from repro_torch.core import pruning
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import dbmu_sim, ops
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import joint_sparse_matmul as jsm
    w = torch.randn((K, N), generator=gen) * K ** -0.5
    if name == "dbmu_matmul":
        _, _, packed, _ = ops.fta_pack(w, pruning.block_prune_mask(
            w, VS, alpha=8))
        x = torch.randint(-128, 128, (M, K), generator=gen,
                          dtype=torch.int32).to(dev)
        packed = packed.to(dev)
        y = torch.empty((M, N), dtype=torch.int32, device=dev)
        return dict(ptrs=(x, packed, y), ints=(M, K, N), y=y,
                    want=dbmu_sim.dbmu_matmul_plain(x, packed), wrapper=None)
    x = torch.randn((M, K), generator=gen).to(xdt).to(dev)
    code = {torch.float32: 0, torch.bfloat16: 1}[xdt]
    if name == "fta_int8_matmul":
        q, sc = ops.quantize_int8_fta(w, torch.ones((K, N), dtype=torch.int32))
        q, sc = q.to(torch.int8).to(dev), sc.to(dev)
        y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        return dict(ptrs=(x, q, sc, y), ints=(M, K, N, code, 1), y=y,
                    want=ftk.fta_int8_matmul_plain(x, q, sc), wrapper=None)
    if name == "joint_sparse_matmul":
        p = ops.slice_joint_stacked(ops.pack_joint_sparse_stacked(
            w.to(torch.bfloat16)[None].to(dev), value_sparsity=VS, bk=128,
            bn=128), 0)
        nt, maxb, bk, bn = p.w_blocks.shape
        y = torch.empty((M, nt * bn), dtype=xdt, device=dev)
        return dict(ptrs=(x, p.w_blocks, p.idx, p.scales, y),
                    ints=(M, K, nt, maxb, bk, bn, code, 2, code), y=y,
                    want=jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx,
                                                       p.scales),
                    wrapper=lambda: jsm.joint_sparse_matmul(
                        x, p.w_blocks, p.idx, p.scales))
    mask = ops.tile_prune_mask(w, VS)
    wb, idx = ops.pack_block_sparse((w * mask).to(dev),
                                    torch.ones_like(mask).to(dev))
    wb = wb.to(xdt)
    nt, maxb, bk, bn = wb.shape
    y = torch.empty((M, nt * bn), dtype=xdt, device=dev)
    return dict(ptrs=(x, wb, idx, y), ints=(M, K, nt, maxb, bk, bn, code),
                y=y, want=bsk.block_sparse_matmul_plain(x, wb, idx),
                wrapper=lambda: bsk.block_sparse_matmul(x, wb, idx))


def _launcher(fn, case, lib):
    ptrs = case["ptrs"](lib) if callable(case["ptrs"]) else case["ptrs"]
    args = [t if isinstance(t, int) else None if t is None else t.data_ptr()
            for t in ptrs] + list(case["ints"])

    def run(_ptrs=ptrs):                 # holds this version's scratch
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return run


def _check(name, version, label, case, run):
    """Runs the version once and holds its outputs against the plain
    version's; returns copies of them."""
    run()
    torch.cuda.synchronize()
    for got, want in zip(case.get("ys", [case.get("y")]),
                         case.get("wants", [case.get("want")])):
        if name == "dbmu_matmul":
            ok = torch.equal(got, want)
        else:
            peak = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            tol = 1e-5 * peak if got.dtype == torch.float32 else \
                case["tol"] * peak if "tol" in case else \
                2.0 ** (math.floor(math.log2(peak)) - 7)
            ok = err <= tol
        if not ok:
            raise AssertionError(f"{version} {name} {label} disagrees with "
                                 f"the plain version")
    return [y.clone() for y in case.get("ys", [case.get("y")])]


def _us(ms):
    return "n/a" if ms is None else f"{ms * 1e3:.1f}"


def _time_turn(name, runs, lib, wrappers):
    """Rows (event ms, device ms, host µs) of one version's launches
    ((case, launcher) pairs)."""
    mod = wrappers.get(name)
    if mod is not None:
        mod._LIB = lib
    rows = []
    for c, run in runs:
        call = c["wrapper"] if mod is not None else run
        rows.append(dict(shape=c["label"], K=c["K"], N=c["N"],
                         event_ms=_time(run, iters=ITERS, warmup=3),
                         device_ms=_device_ms(run, iters=ITERS),
                         host_us=_host_us(call, windows=HOST_WINDOWS),
                         entry_us=_host_us(run, windows=HOST_WINDOWS)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--kernels", nargs="+", choices=list(SIGNATURE),
                    default=list(SIGNATURE), help="kernels to time "
                    "(default: all)")
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
    units = [u for u in UNITS if u[0] in args.kernels]
    names = list(dict.fromkeys(u[0] for u in units))
    t0 = time.monotonic()
    libs = _build(trees, names)
    print(f"built {len(libs)} libraries in {time.monotonic() - t0:.2f} s",
          flush=True)
    dev = torch.device("cuda")
    wrappers = _wrappers()
    saved = {name: mod._LIB for name, mod in wrappers.items()}
    result = {"card": smi, "order": ORDER, "units": []}
    try:
        for name, label, M, shapes, repeat, xdt in units:
            gen = torch.Generator().manual_seed(11)
            cases = [dict(_norm_bwd_case(s, N, xdt, dev, gen, M)
                          if name == "row_norm_bwd"
                          else _bwd_case(name, s, xdt, dev, gen)
                          if name in SOURCE
                          else _row_case(name, s, M, dev, gen)
                          if name in ("row_attention", "row_norm")
                          else _case(name, K, N, M, xdt, dev, gen),
                          label=s, K=K, N=N) for s, K, N in shapes]
            fns = {v: _entry(libs[(v, name)], name) for v in trees}
            runs = {v: [(c, _launcher(fns[v], c, libs[(v, name)]))
                        for c in cases] for v in trees}
            outs = {v: [_check(name, v, f"{label} {c['label']}", c, run)
                        for c, run in runs[v]] for v in trees}
            for i, c in enumerate(cases):
                if c.get("bitwise_f32") and xdt == torch.float32 and not all(
                        torch.equal(a, b) for a, b in zip(outs["this"][i],
                                                          outs["other"][i])):
                    raise AssertionError(f"{name} {label}: f32 outputs differ "
                                         f"between the trees")
            turns = []
            for v in ORDER:
                rows = _time_turn(name, runs[v], libs[(v, name)], wrappers)
                dev_tot = None if any(r["device_ms"] is None for r in rows) \
                    else repeat * sum(r["device_ms"] for r in rows)
                turns.append(dict(
                    version=v, rows=rows,
                    event_ms=repeat * sum(r["event_ms"] for r in rows),
                    device_ms=dev_tot,
                    host_us=sum(r["host_us"] for r in rows) / len(rows),
                    entry_us=sum(r["entry_us"] for r in rows) / len(rows)))
                cells = ", ".join(
                    f"{r['shape']} {_us(r['event_ms'])}/{_us(r['device_ms'])}"
                    f"/{r['host_us']:.1f}" for r in rows)
                print(f"[ab] {name} ({label}) {v}: {cells} us (event/device/"
                      f"host); x{repeat} total event "
                      f"{turns[-1]['event_ms']:.4f} ms, device "
                      f"{'n/a' if dev_tot is None else f'{dev_tot:.4f} ms'}, "
                      f"host {turns[-1]['host_us']:.2f} us per launch (C entry "
                      f"alone {turns[-1]['entry_us']:.2f} us)",
                      flush=True)
            result["units"].append(dict(kernel=name, unit=label, M=M,
                                        repeat=repeat, turns=turns))
    finally:
        for name, mod in wrappers.items():
            mod._LIB = saved[name]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
