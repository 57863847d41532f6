"""Meshes: the pod meshes the sharding rules and the dry run are reckoned
on, and the one-card mesh the port runs on.

Port of ``repro.launch.mesh``. A ``Mesh`` names its axes, maps each name
to its size in order (``shape``), and lists the devices it spans. The pod
meshes of ``make_production_mesh`` span no device: they exist so that
``runtime.sharding`` and ``launch.dryrun`` can be reckoned at pod sizes.
The port runs on one card, so ``with mesh:`` accepts only a mesh of one
device (``make_test_mesh``) and raises for any other.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


def concrete_device(device) -> torch.device:
    """``device`` with its index filled in: a bare "cuda" is the current
    card, so that it compares equal to the device of a tensor on it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A named device mesh: ``axis_names``, ``shape`` {axis name: size} in
    axis order, and the ``devices`` it spans (none for a pod mesh that
    exists only to be reckoned on)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence = ()):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for {len(axis_names)} "
                             f"axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n)
                                      for a, n in zip(axis_names, sizes)}
        self.devices: Tuple[torch.device, ...] = tuple(
            concrete_device(d) for d in devices)

    @property
    def size(self) -> int:
        """Devices the mesh's axes need."""
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        """The one device of a one-card mesh; raises for any other mesh."""
        self._check_one_card()
        return self.devices[0]

    def _check_one_card(self):
        if self.size != 1 or len(self.devices) != 1:
            present = (torch.cuda.device_count()
                       if torch.cuda.is_available() else 0)
            raise RuntimeError(
                f"the port runs on one card: mesh {self.shape} needs "
                f"{self.size} devices and spans {len(self.devices)}; "
                f"{present} CUDA device(s) present")

    def __enter__(self) -> "Mesh":
        self._check_one_card()
        return self

    def __exit__(self, *exc):
        return False


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``: no devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(device="cuda") -> Mesh:
    """The (1, 1) mesh with the production axis names on one device: the
    card by default, the CPU when the caller asks for it."""
    return Mesh((1, 1), ("data", "model"),
                devices=(resolve_device(device),))
