"""Per-step wall-time outlier detection.

Port of ``StragglerMonitor`` from ``repro.runtime.fault``. The serving
engine records every tick's wall time here; an outlier tick is counted in
``metrics.summary()["straggler_ticks"]``.

The rest of the reference module, ``ElasticMeshPlan`` and
``run_resilient``, drives the training loop (restart from the last
checkpoint, shrink the mesh along its data axis). The port has no
training loop yet; they come with it (ROADMAP Queue 1, the training
path).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

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
