"""Registry of the 10 assigned architectures (filled in by arch modules)."""

from __future__ import annotations

import importlib
from typing import Dict, List

ARCHS: List[str] = [
    "qwen3-8b", "tinyllama-1.1b", "gemma-7b", "stablelm-1.6b",
    "arctic-480b", "mixtral-8x7b", "mamba2-1.3b", "pixtral-12b",
    "whisper-base", "jamba-v0.1-52b",
]

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_")
                            for a in ARCHS}


#: DB-PIM kernel modes selectable per config (mirrors
#: sparsity.sparse_linear.KERNEL_MODES; kept literal so the registry
#: stays import-light).
DBPIM_MODES = ("dense", "value", "bit", "joint")


def get_config(arch: str, reduced: bool = False,
               dbpim_mode: str = None, prefill_exact: bool = None):
    """Load the ModelConfig for `arch`. reduced=True returns the small
    smoke-test variant of the same family. dbpim_mode selects the DB-PIM
    kernel path ("dense" | "value" | "bit" | "joint") the serving stack
    packs for (sparsity.sparse_linear.build_stacked_tables).
    prefill_exact=True makes SSM prefill chunks run the exact per-token
    recurrence instead of the parallel SSD form (attention chunks are
    always exact)."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg = mod.reduced_config() if reduced else mod.config()
    if dbpim_mode is not None:
        if dbpim_mode not in DBPIM_MODES:
            raise KeyError(f"unknown dbpim_mode {dbpim_mode!r}; "
                           f"choose from {DBPIM_MODES}")
        cfg = cfg.scaled(dbpim=True, dbpim_mode=dbpim_mode)
    if prefill_exact is not None:
        cfg = cfg.scaled(prefill_exact=prefill_exact)
    return cfg


def list_archs() -> List[str]:
    return list(ARCHS)
