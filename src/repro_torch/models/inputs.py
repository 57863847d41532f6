"""Concrete random inputs: a training batch (with whisper's stub frames or
pixtral's stub patch embeddings), a decode token, and the serve CLI's
stub frames.

Port of the concrete half of ``repro.models.inputs``: the same numpy
``default_rng(seed)`` draws in the same order, so both packages get the
same tokens and frames for a seed. (The reference's ``ShapeDtypeStruct``
specs are dry-run stand-ins; the port has no dry run yet.)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from .config import ModelConfig
from .layers import dtype_of


def make_train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"} (batch, seq) int32, and "frames" (batch,
    encoder_seq, d) for enc-dec configs or "frontend" (batch, n_patches,
    d) for the vision stub, normal(0, 1) in cfg.dtype."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def ints():
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))
                                .astype(np.int32)).to(dev)

    out = {"tokens": ints(), "labels": ints()}
    if cfg.is_encdec:
        out["frames"] = _normal(rng, (batch, cfg.encoder_seq, cfg.d_model),
                                dtype_of(cfg), dev)
    if cfg.frontend == "vision_stub":
        out["frontend"] = _normal(rng, (batch, cfg.n_patches, cfg.d_model),
                                  dtype_of(cfg), dev)
    return out


def stub_frames(cfg: ModelConfig, batch: int, seed: int = 0,
                device="cuda") -> torch.Tensor:
    """(batch, encoder_seq, d) bf16 encoder input, normal(0, 1): the first
    draw of numpy ``default_rng(seed)``, as the reference serve CLI draws
    it (make_train_batch draws its frames after the tokens)."""
    return _normal(np.random.default_rng(seed),
                   (batch, cfg.encoder_seq, cfg.d_model), torch.bfloat16,
                   resolve_device(device))


def _normal(rng, shape, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(rng.normal(0, 1, shape)).to(dtype).to(dev)


def make_decode_token(cfg: ModelConfig, batch: int, seed: int = 0,
                      device="cuda") -> torch.Tensor:
    """(batch, 1) int32 tokens."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, 1))
                            .astype(np.int32)).to(resolve_device(device))
