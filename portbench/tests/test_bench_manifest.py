"""BENCHMARK.json and every file it names load by name and keep to the
benchmark's contract."""

import json
import re

import pytest
from conftest import HERE, ROOT

from portbench.harness import check, manifest

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"tokens_per_s", "ttft_p95_ms", "itl_p95_ms",
                        "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = manifest.cell(BENCH, name)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e, (name, m["name"])
        assert callable(manifest.reader(m["name"]))
    numbers = set(cell["limits"]) - {"sample_requests"}
    assert numbers and numbers <= set(check.NUMBERS)
    assert all(cell["limits"][k] > 0 for k in numbers)
    assert cell["limits"]["sample_requests"] >= 1
    spec = cell["config"]
    for key in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size", "dtype", "dbpim_value_sparsity"):
        assert key in spec
    eng = cell["traffic"]["engine"]
    hi = (cell["traffic"]["prompt_len"]["hi"]
          + cell["traffic"]["gen_len"]["hi"])
    assert hi <= eng["max_len"]


def test_every_file_is_named():
    """Each configuration, mix, cell limit and metric file belongs to an
    entry of the manifest, and each entry has its file."""
    cfgs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
    assert {p.stem for p in (HERE / "configs").glob("*.json")} == cfgs
    assert {p.stem for p in (HERE / "traffic").glob("*.json")} == \
        {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (HERE / "cells").glob("*.json")} == set(CELLS)
    assert {p.name[:-3] for p in (HERE / "metrics").glob("*.py")} == \
        {m["name"] for m in BENCH["per_layer"]}
