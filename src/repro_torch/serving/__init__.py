"""Request-level serving of the port: the engine (FIFO or SPF admission
over a contiguous or paged cache, chunked or stepwise prefill, SLO
shedding, fault containment), load generation, metrics, deterministic
fault injection, and the durability layer (write-ahead journal and
snapshot / restore for bitwise warm restarts)."""

from .engine import EngineStuckError, ServeEngine, SlotState  # noqa: F401
from .faults import (FAULT_KINDS, INJECTABLE_KINDS,  # noqa: F401
                     EngineCrash, FaultEvent, FaultPlan, InjectedFault)
from .journal import (Journal, JournalError, fold_records,  # noqa: F401
                      read_journal)
from .metrics import MetricsRecorder  # noqa: F401
from .paging import PageAllocError, PageAllocator  # noqa: F401
from .prefill import PREFILL_MODES, assemble_chunk  # noqa: F401
from .snapshot import (SnapshotError, read_snapshot_meta,  # noqa: F401
                       save_snapshot)
from .workload import Request, WorkloadSpec, make_trace  # noqa: F401
