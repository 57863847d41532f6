"""Weight bridge: a JAX param tree, as numpy arrays, to the port's params.

``np.asarray`` of the JAX ``init_params`` tree is a nested dict of numpy
arrays, with bf16 leaves as ``ml_dtypes.bfloat16``, a dtype torch cannot
read. Those cross through a 16-bit integer view, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


#: keys of the leaves the JAX ``init_params`` makes float32 whatever
#: cfg.dtype is: norm scales and biases (stacked (L, d) ones included), the
#: qk-norm scales, the MoE router and the SSM's A_log, D, dt_bias and gated
#: norm scale
FLOAT32_KEYS = frozenset({"scale", "bias", "q_norm", "k_norm", "router",
                          "A_log", "D", "dt_bias", "norm_scale"})


def _leaf_to_torch(a, device, dtype):
    a = np.asarray(a)
    # ascontiguousarray makes a 0-d array 1-d: reshape keeps a scalar leaf
    a = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``. Every leaf keeps its dtype (bf16 bit for bit) unless
    ``dtype`` is given, which recasts the floating leaves the JAX params
    keep in cfg.dtype (projections, embeddings, ``conv_w`` / ``conv_b``).
    A leaf whose key is in ``FLOAT32_KEYS`` stays as it is, whatever its
    rank: the JAX params keep those float32."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: (params_from_numpy(v, dev, None if k in FLOAT32_KEYS
                                      else dtype))
                for k, v in tree.items()}
    return _leaf_to_torch(tree, dev, dtype)
