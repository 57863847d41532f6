"""Request-level serving of the port: engine (FIFO admission over a
contiguous cache, chunked or stepwise prefill), load generation and
metrics."""

from .engine import ServeEngine, SlotState  # noqa: F401
from .metrics import MetricsRecorder  # noqa: F401
from .prefill import PREFILL_MODES, assemble_chunk  # noqa: F401
from .workload import Request, WorkloadSpec, make_trace  # noqa: F401
