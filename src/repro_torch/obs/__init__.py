"""Observability of the port: log-bucketed latency histograms."""

from .histogram import LogHistogram  # noqa: F401
