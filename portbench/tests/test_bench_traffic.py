"""The seeded traffic generator: the same trace for the same seed, the
same sizes block for block for every seed, and due times as the mix
states them."""

import math

import numpy as np
import pytest
from conftest import HERE

import json

from portbench.harness.traffic import Stream, _quantile

MIXES = {p.stem: json.loads(p.read_text())
         for p in (HERE / "traffic").glob("*.json")}


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_seed_same_trace(name):
    a, b = Stream(MIXES[name], 2 ** 31 + 5, 32000, 40.0), \
        Stream(MIXES[name], 2 ** 31 + 5, 32000, 40.0)
    for i in range(70):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert ra.gen_len == rb.gen_len
    if MIXES[name]["loop"] == "open":
        assert a.arrivals(30.0) == b.arrivals(30.0)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_seeds_share_sizes_per_block(name):
    mix = MIXES[name]
    s1, s2 = Stream(mix, 1, 32000, 40.0), Stream(mix, 99, 32000, 40.0)
    blk = s1.block
    for b in range(3):
        idx = range(b * blk, (b + 1) * blk)
        assert sorted(s1.prompt_len(i) for i in idx) == \
            sorted(s2.prompt_len(i) for i in idx)
        assert sorted(s1.gen_len(i) for i in idx) == \
            sorted(s2.gen_len(i) for i in idx)
    same_order = [s1.prompt_len(i) for i in range(blk)] == \
        [s2.prompt_len(i) for i in range(blk)]
    assert same_order == ("order_seed" in mix)
    assert not np.array_equal(s1.request(0).prompt[:8],
                              s2.request(0).prompt[:8])
    for i in range(blk):
        r = s1.request(i)
        assert mix["prompt_len"]["lo"] <= len(r.prompt) <= \
            mix["prompt_len"]["hi"]
        assert 1 <= r.gen_len <= mix["gen_len"]["hi"]
        assert r.prompt.min() >= 1 and r.prompt.max() < 32000


def test_open_loop_due_times():
    mix = MIXES["chat-poisson"]
    s = Stream(mix, 3, 100, 20.0)
    due = s.arrivals(20.0)
    # the window holds one whole block (and perhaps the next's first)
    assert s.block == round(20.0 * mix["rate_per_s"])
    assert s.block <= len(due) <= s.block + 1
    gaps = np.diff([0.0] + due)
    assert np.allclose(gaps, [s.gap(i) for i in range(len(due))])
    assert due[-1] <= 20.0 < due[-1] + s.gap(len(due))
    blk = s.block
    total = sum(s.gap(i) for i in range(blk))
    want = sum(-math.log(1 - (j + 0.5) / blk) for j in range(blk)) \
        / mix["rate_per_s"]
    assert total == pytest.approx(want)


def test_closed_loop_clients_and_stagger():
    mix = MIXES["reasoning-closed64"]
    s = Stream(mix, 4, 32000)
    n = mix["clients"]
    assert s.closed(5, 2).index == 2 * n + 5
    full = [s.gen_len(c) for c in range(n)]
    first = [s.closed(c, 0).gen_len for c in range(n)]
    assert all(1 <= f <= g for f, g in zip(first, full))
    assert sum(first) < 0.6 * sum(full)
    assert s.closed(3, 1).gen_len == s.gen_len(n + 3)


def test_lognormal_is_the_ports():
    d = {"dist": "lognormal", "lo": 256, "hi": 3072, "sigma": 0.8}
    assert _quantile(d, 0.3) == 256
    assert _quantile(d, 0.5) == 256
    assert _quantile(d, 0.9) == round(256 * math.exp(0.8 * 1.2815515655446004))
    assert _quantile(d, 0.99999) == 3072
