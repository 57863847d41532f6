"""One run of a cell, driven on the CPU at test size: the result line
keeps to the contract's keys, the comparison passes a sound program and
fails one whose tokens are altered where they are produced, and the
command refuses to run without a card."""

import importlib.util
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import HERE, ROOT, small_cell

spec = importlib.util.spec_from_file_location("portbench_run",
                                              HERE / "run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CPU = torch.device("cpu")
CASES = [("stablelm-1.6b", "open"), ("mixtral-8x7b", "closed")]


@pytest.mark.parametrize("config,loop", CASES)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(config, loop, trace):
    r = run.execute(small_cell(config, loop), 2 ** 31 + 11, 1.0,
                    bool(trace), CPU)
    assert list(r)[:5] == KEYS and list(r)[-1] == "compared"
    assert set(r) <= set(KEYS) | {"breakdown", "compared"}
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    names = {m["name"] for m in small_cell(config)[
        "per_layer" if trace else "end_to_end"]}
    assert set(r["metrics"]) <= names and r["metrics"]
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("config,loop", CASES)
def test_altered_token_fails(config, loop, monkeypatch):
    """The decode step's logits rolled by one token underneath the
    harness: every token it makes is altered where it is produced."""
    build = run.build

    def broken_build(*args, **kw):
        cfg, engine, tracer, setup_s = build(*args, **kw)
        step = engine._decode

        def broken(*a):
            logits, cache = step(*a)
            return logits.roll(1, dims=-1), cache
        engine._decode = broken
        return cfg, engine, tracer, setup_s
    monkeypatch.setattr(run, "build", broken_build)
    cell = small_cell(config, loop)
    r = run.execute(cell, 5, 1.0, False, CPU)
    gap = r["compared"]["mean_token_gap"]
    assert r["correct"] is False and gap["value"] > gap["limit"]


def test_one_slot_fault_fails_by_request():
    """The decode step's logits rolled in slot 0 alone: the sample holds a
    request of every slot, and that slot's request reads wide on its own
    even where the mean over all the sample's tokens would dilute it."""
    build = run.build

    def broken_build(*args, **kw):
        cfg, engine, tracer, setup_s = build(*args, **kw)
        step = engine._decode

        def broken(*a):
            logits, cache = step(*a)
            logits = logits.clone()
            logits[0] = logits[0].roll(1, dims=-1)
            return logits, cache
        engine._decode = broken
        return cfg, engine, tracer, setup_s
    cell = small_cell("stablelm-1.6b", "closed")
    cell["limits"] = {"request_mean_gap": 0.25, "sample_requests": 4}
    r = run.execute(cell, 9, 1.0, False, CPU)
    assert r["correct"] is True
    run.build = broken_build
    try:
        r = run.execute(cell, 9, 1.0, False, CPU)
    finally:
        run.build = build
    gap = r["compared"]["request_mean_gap"]
    assert r["correct"] is False and gap["value"] > gap["limit"]
    assert list(r["compared"]) == ["request_mean_gap", "served_tokens"]


def test_sample_spreads_over_slots():
    from portbench.harness.check import sample
    from portbench.harness.traffic import Req
    reqs = []
    for i, slot in enumerate([0, 0, 0, 0, 1, 1, 1, 2, 3, 3]):
        r = Req(index=i, prompt=np.ones(5 + (i == 9), np.int32), gen_len=4)
        r.slot, r.done = slot, 1.0
        reqs.append(r)
    reqs.append(Req(index=10, prompt=np.ones(50, np.int32), gen_len=4))
    for seed in range(20):
        got = sample(reqs, seed, 4)
        assert got[0].index == 9                 # the longest finished
        assert sorted(r.slot for r in got) == [0, 1, 2, 3]
        assert len({r.index for r in sample(reqs, seed, 7)}) == 7
    assert sample(reqs, 3, 4) == sample(reqs, 3, 4)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "stablelm-1.6b.chat-poisson", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "stablelm-1.6b.chat-poisson", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and not p.stdout.strip().startswith("{")
