"""Input specs for the dry run, and concrete random inputs: a training
batch (with whisper's stub frames or pixtral's stub patch embeddings), a
decode token, and the serve CLI's stub frames.

Port of ``repro.models.inputs``. The specs are meta tensors
(``device="meta"``): the shapes and dtypes of the reference's
``jax.ShapeDtypeStruct`` stand-ins, with nothing allocated. The concrete
inputs take the same numpy ``default_rng(seed)`` draws in the same order,
so both packages get the same tokens and frames for a seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from .config import ModelConfig
from .layers import dtype_of


def train_batch_spec(cfg: ModelConfig, batch: int,
                     seq: int) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"} (batch, seq) int32, and "frames" (batch,
    encoder_seq, d) for enc-dec configs or "frontend" (batch, n_patches,
    d) for the vision stub in cfg.dtype: meta tensors, nothing
    allocated."""
    meta = dict(device="meta")
    spec = {"tokens": torch.empty((batch, seq), dtype=torch.int32, **meta),
            "labels": torch.empty((batch, seq), dtype=torch.int32, **meta)}
    if cfg.is_encdec:
        spec["frames"] = torch.empty((batch, cfg.encoder_seq, cfg.d_model),
                                     dtype=dtype_of(cfg), **meta)
    if cfg.frontend == "vision_stub":
        spec["frontend"] = torch.empty((batch, cfg.n_patches, cfg.d_model),
                                       dtype=dtype_of(cfg), **meta)
    return spec


def decode_token_spec(cfg: ModelConfig, batch: int) -> Dict[str, torch.Tensor]:
    """{"token": (batch, 1) int32}, a meta tensor."""
    return {"token": torch.empty((batch, 1), dtype=torch.int32,
                                 device="meta")}


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
