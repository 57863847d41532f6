"""Deterministic synthetic token pipeline."""

from .pipeline import SyntheticLMDataset, make_pipeline  # noqa: F401
