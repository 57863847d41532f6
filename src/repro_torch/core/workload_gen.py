"""Synthetic-but-realistic weight/activation generation for the PIM model
benchmarks.

Port of ``repro.core.workload_gen``. The paper's CIFAR-100 models are not
retrained here, so the performance numbers come from weight tensors whose
*distributional* shape matches trained networks (heavy-tailed, near-zero
concentrated: the source of the paper's phi_th in {0, 1, 2} spread),
pushed through the real hybrid pipeline (block pruning -> FTA), with the
resulting metadata fed to the cost model. ``redundancy`` controls the tail
weight: redundant models (VGG19, AlexNet) concentrate harder around zero
=> lower phi_th modes => bigger hardware wins, the paper's qualitative
finding (Sec. VI-C).

The draws stay in numpy, from the caller's ``np.random.Generator`` in the
reference's order: one generator runs through every layer, so one draw
out of place would change every later layer. Pruning and FTA run on
``device`` (the card unless the caller asks for the CPU); both are exact
there (``core.pruning``, ``core.fta``), so the metadata equals the
reference's field for field on every device. The activation statistic
and ``sparsity_from_export`` stay numpy on the host, as in ``pim_model``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import fta, pruning
from .pim_model import (LayerGEMM, LayerSparsity, input_zero_col_fraction,
                        sparsity_from_export)

# Paper-motivated redundancy ranking (Sec. VI-C): redundant models (VGG19,
# AlexNet) have weight distributions concentrated on small integers after
# min-max INT8 quantization => per-filter phi_th mode of 1 is frequent;
# compact models (MobileNetV2, EfficientNetB0) spread wider => phi_th = 2
# dominates.
# (base_q, dead_group_frac): typical quantized magnitude and the fraction of
# alpha-filter groups that training left essentially dead (FTA phi_th = 0).
# Redundant models (VGG19/AlexNet) carry many dead groups, the paper's
# explanation for VGG's >4x bit-only speedup ("filter thresholds vary
# between 0 and 2"); compact models have almost none.
MODEL_WEIGHT_STATS = {
    "alexnet": (5.0, 0.15),
    "vgg19": (5.0, 0.25),
    "resnet18": (6.0, 0.06),
    "mobilenetv2": (10.0, 0.02),
    "efficientnetb0": (10.0, 0.02),
}


def synth_quantized_weight(K: int, N: int, base_q: float, rng,
                           dead_frac: float = 0.0,
                           alpha: int = 8) -> np.ndarray:
    """INT8 weights with trained-network-like statistics, int32 (K, N).

    Per-filter Laplace scales drawn lognormally around ``base_q`` give the
    across-filter diversity that makes the FTA threshold vary in {0, 1, 2};
    per-group correlation (dead groups + shared group scale) mirrors the
    filter-importance correlation of trained convnets.
    """
    n_groups = max(N // alpha, 1)
    gscale = rng.lognormal(mean=0.0, sigma=0.5, size=(1, n_groups))
    dead = (rng.random((1, n_groups)) < dead_frac).astype(np.float64)
    gfac = np.repeat(gscale * (1.0 - dead), alpha, axis=1)[:, :N]
    scales = rng.lognormal(mean=np.log(base_q), sigma=0.3, size=(1, N))
    q = rng.laplace(0.0, 1.0, size=(K, N)) * scales * gfac
    return np.clip(np.round(q), -127, 127).astype(np.int32)


def synth_activation(M: int, K: int, rng) -> np.ndarray:
    """Post-ReLU int8 activations (for the IPU input bit-column statistic).

    Real post-BN/ReLU activations are zero-heavy with rare large outliers,
    so min-max INT8 quantization leaves the high bit-columns mostly zero
    (Fig. 3b). Modeled as ReLU'd Laplace with a thin outlier tail.
    """
    a = np.maximum(rng.laplace(0.0, 1.0, size=(M, K)), 0.0)
    n_out = max(int(a.size * 0.002), 1)
    a.ravel()[rng.integers(0, a.size, size=n_out)] *= 3.0
    amax = a.max() + 1e-8
    return np.round(a / amax * 127.0).astype(np.int32)


def layer_metadata(layer: LayerGEMM, value_sparsity: float,
                   base_q: float, rng,
                   with_input_stats: bool = True,
                   dead_frac: float = 0.0,
                   device="cuda") -> LayerSparsity:
    """Run the real algorithm stack on synthetic weights for one layer:
    the INT8 weight is drawn on the host, pruned and FTA-projected on
    ``device``, and its export read back for the cost model."""
    dev = resolve_device(device)
    alpha = pruning.DEFAULT_ALPHA
    N_pad = ((layer.N + alpha - 1) // alpha) * alpha
    q = synth_quantized_weight(layer.K, N_pad, base_q, rng, dead_frac, alpha)
    q_t = torch.from_numpy(q).to(dev)
    mask = pruning.block_prune_mask(q_t.float(), value_sparsity, alpha)
    q_fta, phi_th = fta.fta_quantize(q_t, mask)
    in_frac = 0.0
    if with_input_stats:
        m_sample = min(layer.M, 64)
        acts = synth_activation(m_sample, min(layer.K, 4096), rng)
        # The skip is taken when a bit-column is zero across ALL inputs
        # broadcast that cycle: Tm macros x 8 cores run in lockstep under
        # the top controller => 128-input granularity, not 16.
        in_frac = input_zero_col_fraction(acts, group=128)
    return sparsity_from_export(q_fta.cpu().numpy(), mask.cpu().numpy(),
                                phi_th.cpu().numpy(), in_frac)


def model_metadata(layers: Sequence[LayerGEMM], value_sparsity: float,
                   model_name: str, seed: int = 0,
                   accel_kinds=("std", "pw", "fc"),
                   device="cuda") -> Dict[str, LayerSparsity]:
    """{layer name: LayerSparsity} of every layer of ``accel_kinds``, all
    drawn from one generator seeded with ``seed``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    base_q, dead = MODEL_WEIGHT_STATS.get(model_name, (4.5, 0.1))
    out = {}
    for layer in layers:
        if layer.kind not in accel_kinds:
            continue
        out[layer.name] = layer_metadata(layer, value_sparsity, base_q, rng,
                                         dead_frac=dead, device=dev)
    return out
