"""Architecture configs: the 10 assigned LM-family archs (the same data
as the JAX package's ``repro.configs``, kept as the port's own copy)."""

from .registry import get_config, list_archs, ARCHS  # noqa: F401
