"""Request-level serving of the port: the engine (FIFO or SPF admission
over a contiguous cache, chunked or stepwise prefill, SLO shedding, fault
containment), load generation, metrics and deterministic fault
injection."""

from .engine import EngineStuckError, ServeEngine, SlotState  # noqa: F401
from .faults import (FAULT_KINDS, INJECTABLE_KINDS,  # noqa: F401
                     EngineCrash, FaultEvent, FaultPlan, InjectedFault)
from .metrics import MetricsRecorder  # noqa: F401
from .prefill import PREFILL_MODES, assemble_chunk  # noqa: F401
from .workload import Request, WorkloadSpec, make_trace  # noqa: F401
