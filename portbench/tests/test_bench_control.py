"""On the card, at the cell's own size: the program's numbers lie within
the cell's limits and the float8 control's, on the same served tokens,
past one of them (``control.py`` reads more seeds; PERF.md gives the
readings)."""

import importlib.util
import json

import pytest
from conftest import HERE, ROOT

spec = importlib.util.spec_from_file_location("portbench_run_ctl",
                                              HERE / "run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_limit_separates_program_and_control(card, name):
    from portbench.harness import manifest
    cell = manifest.cell(BENCH, name)
    r = run.execute(cell, 2 ** 31 + 77, BENCH["run_seconds"], False, card,
                    control=True)
    numbers = [k for k in r["compared"] if k != "served_tokens"]
    assert r["correct"] and numbers
    assert any(r["control_gap"][k] > cell["limits"][k] for k in numbers)
