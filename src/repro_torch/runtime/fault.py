"""Fault tolerance and elasticity harness: port of ``repro.runtime.fault``.

  * ``StragglerMonitor`` tracks per-step wall time and flags outliers.
    The train CLI records every step here; the serving engine records
    every tick, an outlier tick counted in
    ``metrics.summary()["straggler_ticks"]``.
  * ``run_resilient`` wraps a step loop: on a failure it restores the
    last checkpoint's step and continues, and from the second failure on
    halves the ``ElasticMeshPlan``'s data-parallel slices (a lost
    model-parallel peer loses the weights' shards, a lost data-parallel
    slice only throughput). Pure host logic: on one card the plan is
    bookkeeping handed to the loop, which is free to ignore it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class StragglerMonitor:
    window: int = 50
    threshold: float = 2.0          # x median => straggler
    warmup: int = 10                # samples before flagging starts
    times: List[float] = field(default_factory=list)
    flagged: int = 0                # total stragglers seen (monotonic)

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < self.warmup:
            return False
        med = float(np.median(self.times))
        if dt > self.threshold * med:
            self.flagged += 1
            return True
        return False

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


@dataclass
class ElasticMeshPlan:
    """How to shrink the mesh when a slice dies: drop along the data axis
    (model-parallel groups must stay complete)."""
    data_parallel: int
    model_parallel: int

    def degrade(self) -> "ElasticMeshPlan":
        if self.data_parallel <= 1:
            raise RuntimeError("cannot degrade below 1 data-parallel slice")
        return ElasticMeshPlan(self.data_parallel // 2, self.model_parallel)


def run_resilient(train_loop: Callable[[int, Optional[ElasticMeshPlan]], int],
                  *, total_steps: int, restore_step: Callable[[], int],
                  max_failures: int = 5,
                  plan: Optional[ElasticMeshPlan] = None,
                  on_failure: Optional[Callable[[BaseException], None]] = None
                  ) -> int:
    """Drive ``train_loop(start_step, plan)`` to completion with restarts.

    train_loop runs until done or raises; restore_step() returns the step
    to resume from (the last durable checkpoint). Each failure past the
    first degrades the mesh plan (elastic downscale); more than
    ``max_failures`` raise RuntimeError from the last one."""
    failures = 0
    step = restore_step()
    while step < total_steps:
        try:
            step = train_loop(step, plan)
        except Exception as e:   # noqa: BLE001 — any step failure
            failures += 1
            if on_failure:
                on_failure(e)
            if failures > max_failures:
                raise RuntimeError(
                    f"exceeded {max_failures} failures; last: {e}") from e
            step = restore_step()
            if plan is not None and failures >= 2:
                plan = plan.degrade()   # repeated failures: shed capacity
    return step
