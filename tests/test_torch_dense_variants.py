"""The plain dense variants served by the port on reduced configs:
qwen3-8b (qk-norm), gemma-7b (GeGLU, (1 + w) RMSNorm, embedding scaling,
tied unembedding, MHA) and stablelm-1.6b (LayerNorm with bias, 25 %
partial RoPE, MHA). For each, in float32 joint mode (tables bk = bn =
32), the port's engine serves a small trace with chunked prefill, and
every greedy stream equals the JAX package's stepwise greedy stream on
the same params, with one compiled signature per step kind; and the
serve CLI completes a reduced run on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_dense_variants.py
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro_torch.configs import get_config
from repro_torch.obs import RecompileSentinel
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy
from test_torch_engine import _jax_greedy_streams

pytestmark = pytest.mark.port

ARCHS = ["qwen3-8b", "gemma-7b", "stablelm-1.6b"]
#: the engine's shape: 2 slots, chunks of 3 tokens, a 16-row cache
SLOTS, CHUNK, MAX_LEN = 2, 3, 16


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_equal_jax_stepwise(arch):
    """The engine over its compiled in-place steps (decode, exact prefill
    chunks, reset) against JAX stepwise decode, request by request."""
    jcfg = jax_get_config(arch, reduced=True, dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    cfg = get_config(arch, reduced=True, dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    trace = make_trace(WorkloadSpec(n_requests=5, arrival_rate=1.0,
                                    prompt_len=(2, 9), gen_len=(2, 6),
                                    seed=13), cfg.vocab_size)
    engine = ServeEngine(cfg, strip_packed_projections(params, cfg),
                         n_slots=SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK,
                         stacked_tables=build_stacked_tables(
                             params, cfg, bk=32, bn=32), device="cpu")
    outputs = engine.run(trace)
    assert engine.prefill_kind == "prefill_chunk_exact"
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(kind, cfg.name): 1
        for kind in ("decode", "prefill_chunk_exact", "reset")}
    ref = _jax_greedy_streams(jcfg, jparams,
                              jax_tables(jparams, jcfg, bk=32, bn=32),
                              trace, MAX_LEN)
    for r in trace:
        assert len(outputs[r.rid]) == r.gen_len, r.rid
        assert outputs[r.rid] == ref[r.rid], r.rid


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_completes_on_the_cpu(arch, capsys):
    """repro_torch.launch.serve --arch <arch> --reduced --dbpim-mode joint
    --device cpu serves every request, with one signature per step."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--reduced", "--dbpim-mode", "joint",
                      "--device", "cpu", "--requests", "3", "--max-len",
                      "24", "--gen-len", "3", "--prompt-len", "2", "9",
                      "--prefill-chunk", "4"])
    assert len(out) == 3 and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert "3/3 requests" in text
    name = get_config(arch, reduced=True).name
    for kind in ("decode", "prefill_chunk_exact", "reset"):
        assert f"{kind}@{name}=1" in text, (kind, text)
