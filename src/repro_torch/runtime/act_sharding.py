"""Activation sharding constraints with logical axis names.

Port of ``repro.runtime.act_sharding``. The reference resolves the
logical axes of ``constrain(x, "dp", None, "tp", None)`` against the mesh
active at trace time ("dp" -> (pod, data), "tp" -> model, with the
divisibility checks of ``_resolve``) and pins the activation's layout
with ``with_sharding_constraint``. The port runs on one card, which holds
every array whole, so both functions return ``x`` itself, the same
object, inside a mesh and outside one.

The port's models do not call them: the reference's call sites
(``models/layers.py``'s MLP hidden state, attention's q/k/v and the MoE
dispatch buffers) would be identity calls on one card, each with host
cost on the eager prefill step, so they are left out.
"""

from __future__ import annotations


def _resolve(mesh, logical, dim):
    if logical is None:
        return None
    if logical == "dp":
        axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
        axes = axes if len(axes) > 1 else (axes[0] if axes else None)
    elif logical == "tp":
        axes = "model" if "model" in mesh.axis_names else None
    else:
        axes = logical if logical in mesh.axis_names else None
    if axes is None:
        return None
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= dict(mesh.shape)[a]
    return axes if dim % size == 0 else None


def constrain(x, *logical_axes):
    """``x`` itself: on one card every layout is the whole array."""
    return x


def constrain_any(x, *candidate_specs):
    """``x`` itself, as ``constrain``."""
    return x
