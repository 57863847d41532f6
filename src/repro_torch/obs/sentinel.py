"""Recompilation sentinel: the fixed-shape no-recompile contract, guarded.

Port of ``repro.obs.sentinel``. The serving engine's performance rests on
every request flowing through a handful of steps compiled once: on the
card each is one captured CUDA graph (``launch.steps.compile_step``). A
shape regression (a scalar position sneaking back in, a cache replaced
by a new one between calls) would silently capture a new graph every
tick and only surface as a wall-clock anomaly. The sentinel turns it into
a hard invariant: each compiled step is registered under a
``(call_kind, arch)`` key with a compile budget (default: ONE), and
``check()`` (called once per engine tick) raises ``RecompileError`` the
tick the budget is exceeded, naming the offender and its compile count.

Counting uses the compiled step's ``_cache_size()``: the number of
distinct input signatures (shape, dtype, device, and the identity of the
buffers it reads and writes in place) it has captured, the counterpart of
the jit cache size. The count is kept on the CPU too, where the step runs
eagerly, so the sentinel guards both. A step without the hook leaves the
sentinel inert (counts report -1, ``check`` passes); ``available`` says
which mode it is in.
"""

from __future__ import annotations

from typing import Dict


class RecompileError(RuntimeError):
    """A registered step compiled more often than its budget — the
    fixed-shape serving contract is broken."""


def _cache_size(fn) -> int:
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return -1
    return int(probe())


class RecompileSentinel:
    """Registry of compiled step functions + per-key compile budgets."""

    def __init__(self, budget: int = 1):
        self.budget = budget
        self._fns: Dict[str, object] = {}

    @staticmethod
    def key(call_kind: str, arch: str) -> str:
        return f"{call_kind}@{arch}"

    def register(self, key: str, compiled):
        """Track ``compiled`` (a ``launch.steps.compile_step`` result)
        under ``key``. Re-registering a key replaces the function (engines
        rebuild steps on reconfig)."""
        self._fns[key] = compiled

    @property
    def available(self) -> bool:
        """False when a registered step exposes no signature count — the
        sentinel is then inert, not wrong."""
        return all(_cache_size(f) >= 0 for f in self._fns.values())

    def counts(self) -> Dict[str, int]:
        """Compile count per registered key (-1: introspection missing)."""
        return {k: _cache_size(f) for k, f in self._fns.items()}

    def check(self):
        """Raise RecompileError if any registered step exceeded its
        budget. Cheap (one int read per step), intended per-tick."""
        over = {k: n for k, n in self.counts().items() if n > self.budget}
        if over:
            raise RecompileError(
                f"step(s) recompiled past the budget of {self.budget} "
                f"compile(s): " +
                ", ".join(f"{k} compiled {n}x" for k, n in over.items()) +
                " — a fixed-shape serving step changed its input "
                "signature between calls")
