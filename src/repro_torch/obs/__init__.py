"""Observability of the port: log-bucketed latency histograms and the
recompilation sentinel, and kernel launches counted from the device's
own records."""

from .histogram import LogHistogram  # noqa: F401
from .launches import device_launches, per_call  # noqa: F401
from .sentinel import RecompileError, RecompileSentinel  # noqa: F401
