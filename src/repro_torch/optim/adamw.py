"""AdamW (the paper's optimizer) as pure functions over param trees, with
optional INT8-quantized first and second moments.

Port of ``repro.optim.adamw``. A param tree is a nested dict (or list /
tuple) of tensors, as the port's params are; ``m`` and ``v`` mirror it.
A moment is a float32 tensor of the param's shape or, with
``int8_state``, a block-quantized dict (bitsandbytes-style): blocks of
256 elements, ``{"q": int8 (nblk, 256), "scale": float32 (nblk, 1)}``,
linear for ``m`` and in the square-root domain for ``v``, which carries
the marker key ``"sqrt"`` (the reference's codec, so a checkpoint of
either package restores in the other). Leaves under 256 elements stay
float32.

The update computes in float32 and casts back to the param's dtype. Its
bias corrections ``1 - b ** t`` are float32 with ``t`` a float32 tensor,
as the reference's: Python's float64 ``0.9 ** step`` would differ in the
last bits. It runs under ``torch.no_grad`` and returns new tensors (the
reference's arrays are immutable; the train step hands the new params
their ``requires_grad`` again).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: elements per INT8 moment block
BLOCK = 256


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates applied so far
    m: dict
    v: dict


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts / lists / tuples with the
    first tree's structure (the reference's ``jax.tree_util.tree_map`` over
    the port's params). A dict in the first tree is a node, so a moment
    dict (``{"q", "scale"}``) is never a leaf of it: map over params."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)) and not hasattr(head, "_fields"):
        return type(head)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _zeros_like_state(p, int8: bool, sqrt_domain: bool):
    """The block-quantized INT8 moment of ``p``, or a float32 zero tensor
    (int8 off, a scalar, or fewer than 256 elements). The second moment
    (>= 0, a huge dynamic range) is stored in the square-root domain:
    linear INT8 on v collapses small entries to zero and 1 / sqrt(v +
    eps) then explodes."""
    if int8 and p.ndim >= 1 and p.numel() >= BLOCK:
        nblk = -(-p.numel() // BLOCK)
        d = {"q": torch.zeros((nblk, BLOCK), dtype=torch.int8,
                              device=p.device),
             "scale": torch.zeros((nblk, 1), dtype=torch.float32,
                                  device=p.device)}
        if sqrt_domain:
            d["sqrt"] = torch.ones((), dtype=torch.int8, device=p.device)
        return d
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _dequant(s, shape):
    if isinstance(s, dict):
        val = s["q"].float() * s["scale"]
        if "sqrt" in s:
            val = val * val
        n = 1
        for d in shape:
            n *= int(d)
        return val.reshape(-1)[:n].reshape(shape)
    return s


def _quant(x, like):
    if isinstance(like, dict):
        nblk, blk = like["q"].shape
        flat = torch.nn.functional.pad(x.reshape(-1),
                                       (0, nblk * blk - x.numel()))
        flat = flat.reshape(nblk, blk)
        if "sqrt" in like:
            flat = sqrt_f32(torch.clamp(flat, min=0.0))
        scale = flat.abs().amax(dim=1, keepdim=True) / _f32(127.0, x) + 1e-12
        out = {"q": torch.round(flat / scale).to(torch.int8),
               "scale": scale.float()}
        if "sqrt" in like:
            out["sqrt"] = like["sqrt"]
        return out
    return x


def sqrt_f32(x):
    """The correctly rounded float32 square root, as the reference's (and
    the card's) ``sqrt``: torch's vectorised float32 sqrt on the CPU is
    not, so the CPU takes it in float64 and rounds once."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _f32(v, like):
    """A float32 scalar tensor on ``like``'s device: a divisor the card
    divides by exactly (it divides by a Python number as a reciprocal
    product, an ulp off)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def adamw_init(params, int8_state: bool = False) -> AdamWState:
    """Zero moments for ``params``, INT8 block-quantized with
    ``int8_state``; step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: _zeros_like_state(p, int8_state, False), params),
        v=tree_map(lambda p: _zeros_like_state(p, int8_state, True), params))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
    """One AdamW step: (new params, new state). ``lr`` a number or a
    float32 scalar tensor (``cosine_with_warmup``); ``grads`` mirrors
    ``params`` (any floating dtype)."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_f32(b1, t), t)
    c2 = 1.0 - torch.pow(_f32(b2, t), t)

    def upd(p, g, m_s, v_s):
        g = g.float()
        pf = p.detach().float()
        m = b1 * _dequant(m_s, p.shape) + (1 - b1) * g
        v = b2 * _dequant(v_s, p.shape) + (1 - b2) * g * g
        update = (m / c1) / (sqrt_f32(v / c2) + eps)
        update = update + weight_decay * pf
        new_p = (pf - lr * update).to(p.dtype)
        return new_p, _quant(m, m_s), _quant(v, v_s)

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (tree_map(lambda p, o: o[i], params, out)
                           for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
