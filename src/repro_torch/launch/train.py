"""End-to-end training driver of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Port of ``repro.launch.train``: config -> seeded params -> the train step
(``launch.steps.build_train_step``: microbatch gradient accumulation,
AdamW with the cosine schedule, optional INT8 optimizer state and gradient
compression) -> the synthetic data pipeline -> async checkpoints with
resume (``checkpoint.CheckpointManager``) -> the straggler monitor, with
``--dbpim-every N`` projecting every eligible projection onto the DB-PIM
FTA grid every N steps (``sparsity.sparsify_params`` + ``dequant_tree``,
Fig. 4 stage 2 in the loop). One device, eagerly: on the card (the
default) the norms and attention run forward and backward in the port's
row kernels, the projections as plain matmuls, as the reference trains;
``--device cpu`` runs the plain versions. The run enters the one-card
mesh (``launch.mesh.make_test_mesh``); ``--production-mesh`` asks for the
reference's pod mesh (16, 16) instead, which is refused with an error
naming the 256 devices it needs and the count present, as the reference
refuses it on one device. ``--layers`` cuts the depth at full width. ``main`` returns the losses; ``run`` the
whole ``TrainRun`` (the final params and optimizer state, each step's
wall time, the device's peak memory).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.steps import build_train_step, trainable
from repro_torch.models import init_params
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime.fault import StragglerMonitor


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--dbpim-every", type=int, default=0,
                    help="every N steps, project weights to the DB-PIM "
                         "FTA grid (hybrid-grained pruning, Fig. 4 stage "
                         "2): train the compressed model in the loop")
    ap.add_argument("--dbpim-value-sparsity", type=float, default=0.0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) pod mesh: refused, as "
                         "the port runs on one card")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    return ap


def _on(tree, device):
    return tree_map(lambda t: t.to(device), tree)


@dataclass
class TrainRun:
    losses: List[float]
    params: dict
    opt_state: AdamWState
    step_s: List[float]              # each step's wall time (loss read back)
    tokens_per_step: int
    peak_bytes: Optional[int]        # the card's peak allocation; None on cpu


def run(args) -> TrainRun:
    """The training loop of ``main`` for parsed ``args``."""
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers is not None:
        cfg = cfg.scaled(n_layers=args.layers)
    dev = resolve_device(args.device)
    mesh = (make_production_mesh() if args.production_mesh
            else make_test_mesh(dev))
    print(f"[train] {cfg.name}: mesh={mesh.shape} device={dev} "
          f"layers={cfg.n_layers} dtype={cfg.dtype}")
    with mesh:
        return _train(args, cfg, dev, mesh)


def _train(args, cfg, dev, mesh) -> TrainRun:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    params = trainable(init_params(cfg, seed=args.seed, device=dev))
    opt_state = adamw_init(params, int8_state=args.int8_opt)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] params: {n_params / 1e6:.1f}M")

    step_fn = build_train_step(cfg, microbatches=args.microbatches,
                               grad_compression=args.grad_compression,
                               mesh=mesh)
    ds = SyntheticLMDataset(cfg, args.batch, args.seq, seed=args.seed)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        restored = ckpt.restore_or_none((params, opt_state))
        if restored is not None:
            (params, opt_state), start_step, _ = restored
            params = trainable(_on(params, dev))
            opt_state = AdamWState(*_on(tuple(opt_state), dev))
            print(f"[train] resumed from step {start_step}")

    mon = StragglerMonitor()
    losses, step_s = [], []
    pipe = make_pipeline(ds, start_step)
    try:
        for step in range(start_step, args.steps):
            batch = next(pipe)
            t0 = time.time()
            params, opt_state, loss = step_fn(params, opt_state, batch)
            loss_v = float(loss)
            dt = time.time() - t0
            losses.append(loss_v)
            step_s.append(dt)
            if mon.record(dt):
                print(f"[train] step {step}: straggler ({dt:.2f}s vs "
                      f"p50 {mon.p50:.2f}s)")
            if step % args.log_every == 0:
                print(f"[train] step {step}: loss={loss_v:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if args.dbpim_every and (step + 1) % args.dbpim_every == 0:
                # FTA-aware training: periodic projection of every eligible
                # projection onto the FTA-compliant INT8 grid (the paper
                # applies it per epoch; training goes on from the
                # projected weights between projections)
                from repro_torch.sparsity import dequant_tree, sparsify_params
                with torch.no_grad():
                    comp = sparsify_params(
                        params, cfg, value_sparsity=args.dbpim_value_sparsity)
                    params = trainable(dequant_tree(params, comp))
            if ckpt:
                ckpt.maybe_save(step + 1, (params, opt_state),
                                extra={"loss": loss_v})
        if ckpt:
            ckpt.wait()
    finally:
        pipe.close()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> "
              f"last loss {losses[-1]:.4f}")
    return TrainRun(losses, params, opt_state, step_s,
                    args.batch * args.seq, peak)


def main(argv=None):
    return run(build_parser().parse_args(argv)).losses


if __name__ == "__main__":
    main()
