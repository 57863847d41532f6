"""Beyond-paper example on the PyTorch/CUDA port: DB-PIM hybrid-grained
compression applied to a transformer LM (the paper evaluates CNNs only).

    PYTHONPATH=src python examples/torch_dbpim_compress_lm.py [--device cpu]

The port's counterpart of ``examples/dbpim_compress_lm.py``: it
compresses every projection of a TinyLlama-family model with the paper's
pipeline (block pruning + FTA), runs the same model code on the
reconstructed FTA-compliant weights, reports the loss on the synthetic
stream, and estimates the DB-PIM chip speedup with the cost model. It
runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.sparsity import (dequant_tree, pim_speedup_estimate,
                                  sparsify_params)

VALUE_SPARSITIES = (0.0, 0.4, 0.6)


@torch.no_grad()
def run(cfg, params, batch, device="cuda"):
    """Compress ``params`` at each of VALUE_SPARSITIES and print one line
    each; returns those lines' figures: [{value_sparsity, base_loss, loss,
    bit_sparsity, orig_bytes, int8_bytes, speedup, energy_savings, u_act,
    n_projections}]. ``batch``: numpy arrays or tensors."""
    dev = resolve_device(device)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    base_loss = float(loss_fn(params, batch, cfg))
    rows = []
    for vs in VALUE_SPARSITIES:
        comp = sparsify_params(params, cfg, value_sparsity=vs)
        loss_c = float(loss_fn(dequant_tree(params, comp), batch, cfg))
        est = pim_speedup_estimate(comp, cfg)
        int8 = sum(r["int8_bytes"] for r in comp.report.values())
        orig = sum(r["orig_bytes"] for r in comp.report.values())
        bit_s = float(np.mean([r["bit_sparsity"]
                               for r in comp.report.values()]))
        row = dict(value_sparsity=vs, base_loss=base_loss, loss=loss_c,
                   bit_sparsity=bit_s, orig_bytes=orig, int8_bytes=int8,
                   speedup=est["speedup"],
                   energy_savings=est["energy_savings"], u_act=est["u_act"],
                   n_projections=est["n_projections"])
        print(f"value_sparsity={vs:.1f}: loss {base_loss:.3f} -> "
              f"{loss_c:.3f} | bit_sparsity={bit_s:.2f} | "
              f"bytes {orig} -> {int8} ({int8 / orig:.2f}x) | "
              f"PIM speedup {row['speedup']:.2f}x, "
              f"energy savings {row['energy_savings'] * 100:.1f}%, "
              f"U_act {row['u_act'] * 100:.1f}% over "
              f"{row['n_projections']} projections")
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("tinyllama-1.1b", reduced=True)
    params = init_params(cfg, seed=0, device=dev)
    batch = SyntheticLMDataset(cfg, 8, 128, seed=0).batch_at(0)
    return run(cfg, params, batch, dev)


if __name__ == "__main__":
    main()
