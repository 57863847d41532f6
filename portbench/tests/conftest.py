"""Shared pieces of the benchmark's tests: reduced configurations of the
two families and cells built from them, small enough for the CPU.

Tests that need a card take the ``card`` fixture, which skips without
one; they run on the chip with ``python -m pytest -q portbench/tests``."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

HERE = ROOT / "portbench"


def reduced(config: str, **over) -> dict:
    """A configuration file cut to test size (widths too: CPU only)."""
    spec = json.loads((HERE / "configs" / f"{config}.json").read_text())
    spec.update(n_layers=2, d_model=64, head_dim=16, d_ff=128,
                vocab_size=256)
    spec["n_heads"] = 4
    spec["n_kv_heads"] = 2 if spec.get("n_experts") else 4
    if spec.get("n_experts"):
        spec.update(n_experts=4, top_k=2, window=32, capacity_factor=2.0)
    spec.update(over)
    return spec


def small_cell(config: str, loop: str = "closed", **over) -> dict:
    """A cell of a reduced configuration under a small mix."""
    mix = {"loop": loop, "clients": 4, "rate_per_s": 20.0,
           "prompt_len": {"dist": "uniform", "lo": 6, "hi": 20},
           "gen_len": {"dist": "uniform", "lo": 4, "hi": 10},
           "block": 8,
           "engine": {"slots": 4, "max_len": 32, "prefill_chunk": 8}}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {"workload": {"name": f"{config}.small", "chips": 1},
            "config": reduced(config, **over), "traffic": mix,
            "limits": {"mean_token_gap": 0.25, "sample_requests": 3},
            "end_to_end": copy.deepcopy(bench["end_to_end"]),
            "per_layer": copy.deepcopy(bench["per_layer"])}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
