"""Dry run: reckon every (architecture x input shape x pod mesh) cell on
meta tensors and record its cost and per-device memory for the roofline
analysis.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
        --shape decode_32k --mesh single

Port of ``repro.launch.dryrun``. Each cell builds the port's train,
prefill or decode step and its shardings on the pod mesh
(``launch.mesh.make_production_mesh``: (16, 16), or (2, 16, 16) for
``multi``) over meta params, optimizer state, cache and batch, so nothing
is allocated on any device. A record holds:

  * ``params`` and ``active_params``;
  * ``jaxpr_cost``: ``runtime.op_cost.analyze`` of the step on the meta
    state (the reference's ``jaxpr_cost.analyze``; the kernels report
    through their cost hooks, the train step's backward included);
  * ``memory_analysis.argument_size_in_bytes``: the bytes one device
    holds of params, optimizer state, cache and batch under their specs
    (``runtime.sharding.local_shape``), where the reference reads XLA's
    memory analysis;
  * ``lower_s`` (state, specs and the cost walk) and ``total_s``.

XLA's ``temp_size_in_bytes``, ``cost_analysis`` and ``hlo_bytes`` have no
counterpart and are left out of the record. ``collectives`` is null, with
``collectives_reason``: the port has no SPMD partitioner, and the one-card
program issues no collective. The reference's train step rematerializes
each layer in its backward (``cfg.remat``), which its walker charges as a
second forward; the port keeps the activations and charges one.

Records land in experiments/dryrun_torch/<arch>.<shape>.<mesh>.json;
``launch.roofline`` reads them.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step, prefill_shardings,
                                      train_shardings, trainable)
from repro_torch.models import init_cache, init_params
from repro_torch.models.config import (SHAPES, active_param_count,
                                       param_count)
from repro_torch.models.inputs import decode_token_spec, train_batch_spec
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw_init
from repro_torch.runtime import op_cost
from repro_torch.runtime import sharding as shr

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# Grad-accumulation microbatch count per arch for train_4k (activation
# memory control).
MICROBATCHES = {
    "arctic-480b": 8, "jamba-v0.1-52b": 8, "mixtral-8x7b": 8,
    "pixtral-12b": 8, "qwen3-8b": 8, "gemma-7b": 8, "tinyllama-1.1b": 8,
    "stablelm-1.6b": 8, "mamba2-1.3b": 8, "whisper-base": 8,
}

COLLECTIVES_REASON = ("the port has no SPMD partitioner; the one-card "
                      "program issues no collective")


def should_skip(arch: str, shape_name: str, cfg) -> str:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: O(S^2) prefill / full 500k cache "
                "decode excluded by design (DESIGN.md long_500k table)")
    return ""


def abstract_state(cfg, spec):
    """Meta params and AdamW state: shapes and dtypes, nothing
    allocated."""
    params = init_params(cfg, device="meta")
    return params, adamw_init(params)


def _cell(cfg, arch, shape_name, spec, mesh, variant):
    """(step, its arguments, their specs, extra record keys) of one cell,
    all on the meta device."""
    params, opt = abstract_state(cfg, spec)
    B, S = spec.global_batch, spec.seq_len
    if spec.kind == "train":
        mb = MICROBATCHES.get(arch, 1) if shape_name == "train_4k" else 1
        step = build_train_step(cfg, microbatches=mb, mesh=mesh)
        batch = train_batch_spec(cfg, B, S)
        specs = train_shardings(mesh)(params, opt, batch)
        # the step differentiates the params it is given (the meta copies
        # the walk makes of them)
        return ((lambda p, o, b: step(trainable(p), o, b)),
                (params, opt, batch), specs, {"microbatches": mb})
    if spec.kind == "prefill":
        step = build_prefill_step(cfg, mesh=mesh)
        batch = train_batch_spec(cfg, B, S)
        batch.pop("labels")
        return (step, (params, batch), prefill_shardings(mesh)(params, batch),
                {})
    step, shard_fn = build_serve_step(cfg, mesh,
                                      int8_weights=(variant == "int8serve"))
    if variant == "int8serve":
        from repro_torch.sparsity.sparse_linear import \
            quantize_params_for_serving
        params = quantize_params_for_serving(params)
    enc = None
    if cfg.is_encdec:
        enc = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                          dtype=dtype_of(cfg), device="meta")
    cache = init_cache(cfg, B, S, device="meta", enc_out=enc)
    token = decode_token_spec(cfg, B)["token"]
    return (step, (params, cache, token), shard_fn(params, cache, token), {})


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: Path = OUT_DIR, verbose: bool = True,
             variant: str = "") -> dict:
    """One cell's record, written to ``out_dir``. variant="int8serve":
    decode cells store projections INT8 (the DB-PIM/FTA serving format);
    "dotsremat": the config's remat policy "dots" (the port does not
    rematerialize, so it costs the same)."""
    cfg = get_config(arch)
    if variant == "dotsremat":
        cfg = cfg.scaled(remat_policy="dots")
    spec = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(mesh.shape), "status": "ok", "variant": variant,
        "params": param_count(cfg), "active_params": active_param_count(cfg),
    }
    skip = should_skip(arch, shape_name, cfg)
    if skip:
        rec["status"] = "skip"
        rec["reason"] = skip
        _write(rec, out_dir)
        return rec

    t0 = time.time()
    try:
        step, args, specs, extra = _cell(cfg, arch, shape_name, spec, mesh,
                                         variant)
        rec.update(extra)
        rec["jaxpr_cost"] = op_cost.analyze(step, *args)
        rec["lower_s"] = round(time.time() - t0, 1)
        rec["memory_analysis"] = {"argument_size_in_bytes": sum(
            shr.local_bytes(a, s, mesh) for a, s in zip(args, specs))}
        rec["collectives"] = None
        rec["collectives_reason"] = COLLECTIVES_REASON
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    _write(rec, out_dir)
    if verbose:
        msg = rec["status"]
        if rec["status"] == "ok":
            flops = rec["jaxpr_cost"]["dot_flops"]
            args_gb = rec["memory_analysis"]["argument_size_in_bytes"] / 1e9
            msg += (f" flops={flops:.3e} args/device={args_gb:.3f}GB "
                    f"lower={rec['lower_s']}s")
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {msg}",
              flush=True)
    return rec


def _write(rec, out_dir: Path):
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f".{rec['variant']}" if rec.get("variant") else ""
    path = out_dir / f"{rec['arch']}.{rec['shape']}.{rec['mesh']}{suffix}.json"
    slim = {k: v for k, v in rec.items() if k != "traceback"}
    path.write_text(json.dumps(slim, indent=1))
    if "traceback" in rec:
        (out_dir / (path.stem + ".err.txt")).write_text(rec["traceback"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    n_ok = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = OUT_DIR / f"{arch}.{shape}.{mesh_kind}.json"
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skip"):
                        continue
                rec = run_cell(arch, shape, mesh_kind, out_dir=OUT_DIR,
                               variant=args.variant)
                if rec["status"] == "error":
                    n_err += 1
                else:
                    n_ok += 1
    print(f"[dryrun] done: {n_ok} ok/skip, {n_err} errors", flush=True)
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
