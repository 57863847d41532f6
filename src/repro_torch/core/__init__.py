"""Bit-level core used by packing: CSD tables and FTA quantization."""

from . import csd, fta  # noqa: F401
