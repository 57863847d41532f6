"""The benchmark's manifest and the files it names.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) is found by name;
its configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its correctness limit ``cells/<cell>.json``,
and each per-layer metric a reader ``metrics/<metric>.py`` with a
``read(run)`` function. Adding a cell, a mix or a metric adds files and
manifest entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # portbench/
ROOT = HERE.parent


def load() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def cell(bench: dict, name: str) -> dict:
    """{"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} of one cell."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]

    def mine(metric):
        return name in metric.get("workloads", [name])
    return {"workload": w, "config": _json("configs", w["config"]),
            "traffic": _json("traffic", w["traffic"]),
            "limits": _json("cells", name),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
