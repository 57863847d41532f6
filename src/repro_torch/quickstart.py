"""Quickstart: the DB-PIM pipeline end to end on one weight matrix.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

The port of ``examples/quickstart.py``, with its seed and sizes; it runs
on the CUDA card unless ``--device cpu`` is given (then every kernel
wrapper takes its plain version).

1. Random "trained" weights -> coarse block pruning (value sparsity).
2. FTA quantization (CSD fixed threshold, Alg. 1) -> bit sparsity.
3. Dyadic-block packing (the offline compilation of Fig. 4).
4. Bit-true DBMU datapath check (the dbmu_matmul kernel).
5. DB-PIM cost model: speedup / energy / utilization vs dense PIM.
6. Joint value x bit kernel: value-compacted + INT8 bit-compressed
   weights served by one matmul kernel, the paper's headline fusion.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import dyadic, fta, pruning, qat
from repro_torch.core.pim_model import (LayerGEMM, evaluate_dense_baseline,
                                        evaluate_model, sparsity_from_export)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref


def run(device="cuda") -> dict:
    """The six steps on ``device``; prints each result and returns them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    K, N = 256, 128
    out = {}

    print("== 1. weights + coarse block pruning (60% value sparsity)")
    w = torch.from_numpy(rng.laplace(0, 0.02, (K, N)).astype(np.float32))
    w = w.to(dev)
    mask = pruning.block_prune_mask(w, 0.6, alpha=8)
    out["value_sparsity"] = pruning.value_sparsity(mask)
    print(f"   value sparsity: {out['value_sparsity']:.2f}")

    print("== 2. FTA quantization (phi_th in {0,1,2})")
    scale = w.abs().max() / 127.0
    q = qat.quantize_int8(w, scale)
    q_fta, phi = fta.fta_quantize(q, mask)
    out["phi_hist"] = np.bincount(phi.cpu().numpy(), minlength=3)
    out["bit_sparsity"] = fta.achieved_bit_sparsity(q_fta, mask)
    print(f"   phi_th histogram: {out['phi_hist']}")
    print(f"   bit sparsity of kept weights: "
          f"{out['bit_sparsity']:.3f} (>= 0.75)")

    print("== 3. dyadic-block packing (signs + indices)")
    packed = dyadic.pack_terms(q_fta)
    out["pack_exact"] = bool((dyadic.unpack_terms(packed) == q_fta).all())
    print(f"   pack/unpack exact: {out['pack_exact']}")

    print(f"== 4. bit-true DBMU datapath (dbmu_matmul on {dev.type})")
    x = torch.from_numpy(rng.integers(-127, 128, (16, K), dtype=np.int32))
    x = x.to(dev)
    got = ops.dbmu_reference_check(x, packed)
    want = ref.dbmu_matmul_ref(x, packed)
    out["dbmu_exact"] = bool((got.long() == want).all())
    print(f"   bit-serial AND + CSD tree == int matmul: {out['dbmu_exact']}")

    print("== 5. DB-PIM vs dense digital PIM (cost model)")
    layer = LayerGEMM("demo", M=64, K=K, N=N, kind="fc")
    sp = sparsity_from_export(q_fta.cpu().numpy(), mask.cpu().numpy(),
                              phi.cpu().numpy())
    ours = evaluate_model([layer], {"demo": sp})
    dense = evaluate_dense_baseline([layer])
    out["speedup"] = dense.cycles / ours.cycles
    out["energy_savings"] = 1 - ours.energy_pj / dense.energy_pj
    out["u_act"] = ours.u_act
    print(f"   speedup {out['speedup']:.2f}x | energy savings "
          f"{out['energy_savings'] * 100:.1f}% | "
          f"U_act {out['u_act'] * 100:.1f}%")

    print("== 6. joint value x bit kernel (the serving path)")
    packed = ops.pack_joint_sparse(w, mask)
    xf = torch.from_numpy(rng.normal(0, 1, (64, K)).astype(np.float32))
    xf = xf.to(dev)
    y = ops.joint_dense(xf, packed)
    want = ref.joint_packed_ref(xf, packed)
    out["joint_err"] = float((y - want).abs().max())
    out["joint_bytes"] = ops.joint_storage_bytes(packed)
    print(f"   weight bytes: joint={out['joint_bytes']} vs dense "
          f"bf16={2 * K * N} ({out['joint_bytes'] / (2 * K * N):.2f}x) | "
          f"max |kernel - dense ref| = {out['joint_err']:.2e}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
