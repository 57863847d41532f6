"""Observability of the port: two-clock tracing of the serving engine and
its Chrome-trace export, log-bucketed latency histograms, the
recompilation sentinel, kernel launches counted from the device's own
records, and the per-call-kind weight-traffic waterfall.

The tracer is PASSIVE instrumentation: with it on, the engine issues the
same device calls and kernel launches, and gives the same outputs, as
with it off."""

from .chrome import to_chrome_trace  # noqa: F401
from .histogram import LogHistogram  # noqa: F401
from .launches import (device_launches, encoder_per_call,  # noqa: F401
                       per_call)
from .sentinel import RecompileError, RecompileSentinel  # noqa: F401
from .trace import (EVENT_NAMES, SPAN_NAMES, TRACE_VERSION,  # noqa: F401
                    TraceError, Tracer, load, validate)
from .waterfall import (engine_waterfall, serving_cost_by_kind,  # noqa: F401
                        table_const_weights)
