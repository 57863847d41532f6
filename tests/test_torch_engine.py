"""The port's serving engine on reduced fp32 tinyllama in joint mode:
traces equal the JAX package's, every request's greedy stream equals the
JAX stepwise-decode greedy stream of the same request on the same params,
and the FIFO scheduler keeps the reference's invariants."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.serving.workload import WorkloadSpec as JaxSpec
from repro.serving.workload import make_trace as jax_make_trace
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro_torch.configs import get_config
from repro_torch.kernels import joint_sparse_matmul as jsm
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

SPEC = dict(n_requests=6, arrival_rate=0.7, prompt_len=(3, 11),
            gen_len=(3, 6), seed=3)


@pytest.mark.parametrize("dist", ["uniform", "bimodal", "fixed",
                                  "lognormal", "zipf"])
def test_traces_identical_to_jax(dist):
    kw = dict(SPEC, dist=dist, gen_dist=dist, n_requests=20)
    mine = make_trace(WorkloadSpec(**kw), 256)
    ref = jax_make_trace(JaxSpec(**kw), 256)
    assert [(r.rid, r.prompt, r.gen_len, r.arrival, r.deadline)
            for r in mine] == \
        [(r.rid, r.prompt, r.gen_len, r.arrival, r.deadline) for r in ref]


def _jax_greedy_streams(jcfg, jparams, jt, trace, max_len):
    """Every request through JAX stepwise decode, one batch row each: a row
    feeds its prompt token by token, then its own greedy tokens."""
    step = jax.jit(lambda p, c, tok: jax_decode_step(p, c, tok, jcfg,
                                                     tables=jt))
    B = len(trace)
    cache = jax_init_cache(jcfg, B, max_len)
    cache["pos"] = jnp.zeros((B,), jnp.int32)
    streams = [[] for _ in trace]
    n_steps = max(r.prompt_len + r.gen_len - 1 for r in trace)
    for t in range(n_steps):
        tok = np.zeros((B, 1), np.int32)
        for i, r in enumerate(trace):
            tok[i, 0] = (r.prompt[t] if t < r.prompt_len
                         else streams[i][-1] if streams[i] else 0)
        lg, cache = step(jparams, cache, jnp.asarray(tok))
        nxt = np.asarray(lg[:, 0, :], np.float32).argmax(-1)
        for i, r in enumerate(trace):
            if r.prompt_len - 1 <= t and len(streams[i]) < r.gen_len:
                streams[i].append(int(nxt[i]))
    return {r.rid: streams[i] for i, r in enumerate(trace)}


@pytest.fixture(scope="module")
def served():
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True,
                          dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    cfg = get_config("tinyllama-1.1b", reduced=True,
                     dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    jt = jax_tables(jparams, jcfg, bk=32, bn=32)
    tables = build_stacked_tables(params, cfg, bk=32, bn=32)
    trace = make_trace(WorkloadSpec(**SPEC), cfg.vocab_size)
    before = jsm.LAUNCHES
    engine = ServeEngine(cfg, strip_packed_projections(params, cfg),
                         n_slots=3, max_len=24, prefill_chunk=4,
                         stacked_tables=tables, device="cpu")
    outputs = engine.run(trace)
    launches = jsm.LAUNCHES - before
    ref = _jax_greedy_streams(jcfg, jparams, jt, trace, 24)
    return engine, trace, outputs, ref, launches


def test_greedy_streams_equal_jax_stepwise(served):
    _, trace, outputs, ref, _ = served
    assert set(outputs) == {r.rid for r in trace}
    for r in trace:
        assert outputs[r.rid] == ref[r.rid], r.rid
        assert len(outputs[r.rid]) == r.gen_len


def test_scheduler_invariants(served):
    engine, trace, _, _, _ = served
    s = engine.metrics.summary()
    assert s["n_completed"] == len(trace)
    rows = {row["rid"]: row for row in engine.metrics.per_request()}
    # FIFO: admission order is arrival order
    order = sorted(trace, key=lambda r: (r.arrival, r.rid))
    admitted = [rows[r.rid]["admitted_tick"] for r in order]
    assert admitted == sorted(admitted)
    for r in trace:
        row = rows[r.rid]
        assert row["admitted_tick"] >= r.arrival
        # TTFT in ceil(P / C) prefill calls: the chunk that holds the last
        # prompt token yields the first token
        assert row["prefill_steps"] == math.ceil(r.prompt_len / 4)
        assert row["first_token_tick"] == \
            row["admitted_tick"] + row["prefill_steps"] - 1
        # the decode call of the same tick already emits the second token
        assert row["done_tick"] == row["first_token_tick"] + r.gen_len - 2
    # a slot serves one request at a time
    by_slot = {}
    for iv in engine.slot_log:
        by_slot.setdefault(iv.slot, []).append(iv)
    for ivs in by_slot.values():
        for a, b in zip(ivs, ivs[1:]):
            assert a.release_tick <= b.admit_tick
    assert s["generated_tokens"] == sum(r.gen_len for r in trace)
    assert s["device_calls"] == s["decode_calls"] + s["prefill_calls"]
    assert set(s["calls_by_kind"]) == {"decode", "prefill_chunk_exact"}


def test_first_logits_keep_the_reference_row(served):
    """first_logits holds what the reference keeps: the (1, V) logits row
    of each request's first token in the model's logits dtype (float32
    here), whose argmax is the first generated token."""
    engine, trace, outputs, _, _ = served
    assert set(engine.first_logits) == {r.rid for r in trace}
    for r in trace:
        row = engine.first_logits[r.rid]
        assert isinstance(row, torch.Tensor) and row.device.type == "cpu"
        assert row.shape == (1, engine.cfg.vocab_size)
        assert row.dtype == torch.float32
        assert int(row[0].argmax()) == outputs[r.rid][0]


def test_first_logits_of_a_bf16_model_stay_bf16():
    from repro_torch.models import init_params
    from repro_torch.serving import Request
    cfg = get_config("tinyllama-1.1b", reduced=True)
    assert cfg.dtype == "bfloat16"
    engine = ServeEngine(cfg, init_params(cfg, device="cpu"), n_slots=2,
                         max_len=16, prefill_chunk=4, device="cpu")
    out = engine.run([Request(0, (1, 2, 3, 4, 5), 2), Request(1, (7, 8), 3)])
    for rid in (0, 1):
        row = engine.first_logits[rid]
        assert row.shape == (1, cfg.vocab_size) and row.dtype == torch.bfloat16
        assert torch.isfinite(row).all()
        assert int(row[0].float().argmax()) == out[rid][0]


def test_no_kernel_launches_on_cpu(served):
    assert served[4] == 0


def test_engine_refuses_unported_features(tmp_path):
    """Every keyword of the reference's ServeEngine is ported (one card has
    no mesh): the durability and paging ones construct an engine, and an
    unknown keyword is a TypeError."""
    import inspect
    from repro.serving.engine import ServeEngine as JaxEngine
    from repro_torch.models import init_params
    ref = set(inspect.signature(JaxEngine.__init__).parameters) - {"mesh"}
    assert ref <= set(inspect.signature(ServeEngine.__init__).parameters)
    cfg = get_config("tinyllama-1.1b", reduced=True)
    params = init_params(cfg, device="cpu")
    engine = ServeEngine(cfg, params, n_slots=2, max_len=16, device="cpu",
                         paged=True, page_size=4, n_pages=6,
                         journal=str(tmp_path / "j.log"),
                         snapshot_dir=str(tmp_path / "snap"),
                         snapshot_every=2, snapshot_keep=3)
    assert engine.paged and engine.n_pages == 6 and engine.journal is not None
    with pytest.raises(TypeError, match="unexpected keyword"):
        ServeEngine(cfg, params, device="cpu", pages=True)


def test_oversized_request_is_rejected_not_served():
    from repro_torch.models import init_params
    from repro_torch.serving import Request
    cfg = get_config("tinyllama-1.1b", reduced=True)
    engine = ServeEngine(cfg, init_params(cfg, device="cpu"), n_slots=1,
                         max_len=8, prefill_chunk=4, device="cpu")
    out = engine.run([Request(0, (1, 2, 3), 3), Request(1, (1,) * 6, 4)])
    assert set(out) == {0} and engine.rejected == {1: "oversized"}


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "tinyllama-1.1b", "--reduced",
                      "--dbpim-mode", "joint", "--device", "cpu",
                      "--requests", "3", "--max-len", "24", "--gen-len", "3",
                      "--prompt-len", "2", "9", "--prefill-chunk", "4"])
    assert len(out) == 3 and all(len(v) == 3 for v in out.values())
    assert "3/3 requests" in capsys.readouterr().out


def test_latency_histogram_matches_jax():
    from repro.obs.histogram import LogHistogram as JaxHistogram
    from repro_torch.obs.histogram import LogHistogram
    samples = np.random.default_rng(0).lognormal(-4, 1.5, 500)
    mine, ref = LogHistogram(), JaxHistogram()
    for v in samples:
        mine.add(float(v))
        ref.add(float(v))
    assert mine.summary_ms() == ref.summary_ms()
    assert mine.buckets == ref.buckets
