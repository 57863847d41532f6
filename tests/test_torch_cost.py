"""The port's op-cost walker and waterfall against the reference walker.

``repro_torch.runtime.op_cost.analyze`` and ``repro_torch.obs.waterfall``
against ``repro.runtime.jaxpr_cost`` and ``repro.obs.waterfall`` on the
same numpy params and tables: weight_bytes, every weight_bytes_by_path
row and pallas_flops equal exactly, in every call kind, for the dense
decode step, the engine's joint steps (decode, exact and parallel
chunks, paged), the value / bit / joint layer hooks, the DBMU kernel and
the lock-step "serve" step, dense and INT8. dot_flops are equal too,
except where the reference computes a three-operand SSM einsum as
products with no contracted dimension (dot_generals it counts) and
torch.einsum as elementwise products, and where the port sums the MoE
combine's k choices in order with elementwise ops (the reference's
einsum "tkd,tk->td"): those gaps are named and computed below. The walker is passive: its arguments and every kernel's
``LAUNCHES`` stay as they were, and a traced serve run gives the same
streams with its waterfalls as without.

The reference walker reads ``jax.core.Var``, which jax 0.9 has moved to
``jax.extend.core.Var``. The ``ref`` fixture swaps the walker module's
``jcore`` name for a namespace holding that class, with monkeypatch, for
this module's run only; no file of the JAX package changes.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_cost.py
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_test_mesh
from repro.launch.steps import build_step as jax_build_step
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.config import ModelConfig as JaxConfig
from repro.models.layers import apply_mlp as jax_apply_mlp
from repro.models.layers import init_mlp as jax_init_mlp
from repro.sparsity import sparse_linear as jsl
from repro_torch.configs import get_config
from repro_torch.kernels import (block_sparse_matmul, dbmu_sim,
                                 fta_int8_matmul, joint_sparse_matmul, ops,
                                 row_attention, row_norm)
from repro_torch.launch.steps import build_step
from repro_torch.models import decode_step, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp
from repro_torch.models.segments import decoder_layout
from repro_torch.obs import (Tracer, engine_waterfall, serving_cost_by_kind,
                             validate)
from repro_torch.runtime import op_cost
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity import quantize_params_for_serving
from repro_torch.sparsity.sparse_linear import (build_kernel_tables,
                                                build_stacked_tables,
                                                kernel_dense_fn,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

#: the engine's shape in the waterfall cases
N_SLOTS, MAX_LEN, CHUNK = 2, 48, 4

#: the reference's per-call weight bytes of the reduced configs in joint
#: mode (2 slots, max_len 48, chunks of 4, tables from
#: build_stacked_tables), by arch and call kind
JOINT_WEIGHT_BYTES = {
    "tinyllama-1.1b": {"decode": 110_648, "prefill_chunk_exact": 110_648},
    "mamba2-1.3b": {"decode": 101_920, "prefill_parallel": 101_920,
                    "prefill_chunk_exact": 309_376},
    "mixtral-8x7b": {"decode": 267_904},
    "jamba-v0.1-52b": {"decode": 410_296, "prefill_parallel": 410_296,
                       "prefill_chunk_exact": 721_480},
}


@pytest.fixture(scope="module")
def ref():
    """The reference walker module, runnable on jax 0.9: its ``jcore``
    swapped for a namespace with ``Var = jax.extend.core.Var``."""
    import jax.extend.core
    from repro.runtime import jaxpr_cost
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaxpr_cost, "jcore",
                   types.SimpleNamespace(Var=jax.extend.core.Var))
        yield jaxpr_cost


def _rows(acc):
    return {k: int(v) for k, v in acc["weight_bytes_by_path"].items()}


def _assert_same_weights(mine, theirs, what):
    """weight_bytes, every row and pallas_flops equal, rows summing to
    weight_bytes exactly."""
    assert _rows(mine) == _rows(theirs), what
    assert mine["weight_bytes"] == theirs["weight_bytes"], what
    assert mine["pallas_flops"] == theirs["pallas_flops"], what
    assert sum(mine["weight_bytes_by_path"].values()) == \
        mine["weight_bytes"], what
    for key in ("flops", "bytes", "dot_flops"):
        assert mine[key] > 0, (what, key)


def _port_params(jparams, dtype=None):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu", dtype=dtype)


def _einsum_gap(ref, spec, *shapes):
    """Reference minus port dot_flops of one einsum at ``shapes``."""
    theirs = ref.analyze(lambda *a: jnp.einsum(spec, *a),
                         *[jnp.zeros(s, jnp.float32) for s in shapes],
                         weight_argnums=())["dot_flops"]
    mine = op_cost.analyze(lambda *a: torch.einsum(spec, *a),
                           *[torch.zeros(s) for s in shapes],
                           weight_argnums=())["dot_flops"]
    return theirs - mine


def _ssm_gap(ref, cfg, kind, B, C):
    """The named dot_flops gap of one call of ``kind``: the decode step's
    outer product "bh,bn,bhp->bhpn" per SSM layer (an exact chunk runs it
    once per token), or the parallel SSD chunk's "bqn,bqh,bhpn->bqhp" and
    "bqh,bqn,bqhp->bhpn"; 0 without SSM layers."""
    from repro.models.ssm import ssm_dims
    n_ssm = sum(s.length for s in decoder_layout(cfg) if s.mixer == "ssm")
    if not n_ssm:
        return 0
    _, nh, N, P = ssm_dims(cfg)
    outer = _einsum_gap(ref, "bh,bn,bhp->bhpn", (B, nh), (B, N), (B, nh, P))
    if kind == "decode":
        return n_ssm * outer
    if kind == "prefill_chunk_exact":
        return n_ssm * C * outer
    return n_ssm * (
        _einsum_gap(ref, "bqn,bqh,bhpn->bqhp", (B, C, N), (B, C, nh),
                    (B, nh, P, N))
        + _einsum_gap(ref, "bqh,bqn,bqhp->bhpn", (B, C, nh), (B, C, N),
                      (B, C, nh, P)))


def _combine_gap(ref, cfg, T):
    """The named dot_flops gap of the MoE combine: the reference's einsum
    "tkd,tk->td" over a call's T tokens in every MoE layer, a dot_general
    it counts, which the port sums over the k choices in order as
    elementwise products (``models.moe._group_combine``); 0 without MoE
    layers."""
    n_moe = sum(s.length for s in decoder_layout(cfg) if s.ffn == "moe")
    if not n_moe:
        return 0
    K, D = cfg.top_k, cfg.d_model
    return n_moe * ref.analyze(
        lambda g, w: jnp.einsum("tkd,tk->td", g, w),
        jnp.zeros((T, K, D), jnp.float32), jnp.zeros((T, K), jnp.float32),
        weight_argnums=())["dot_flops"]


def _dot_gap(ref, cfg, kind, B, C):
    """Every named dot_flops gap of one call of ``kind`` over B slots
    (C tokens a slot in a chunk)."""
    return (_ssm_gap(ref, cfg, kind, B, C)
            + _combine_gap(ref, cfg, B * (1 if kind == "decode" else C)))


# ------------------------------------------------ dense decode step --

def _analytic_weight_bytes(cfg):
    """What one decode step's projections weigh (the reference's
    ``tests/test_moe_serving.py`` contract): attention q/k/v/o + router +
    per-expert gate/up/down (+ arctic's dense residual MLP) per layer, +
    the unembedding; SSM in/out per layer. No activation einsums, caches
    or norms."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    bpe = 2 if cfg.dtype == "bfloat16" else 4
    if cfg.family == "ssm":
        from repro.models.ssm import ssm_dims
        d_in, nh, N, _ = ssm_dims(cfg)
        return cfg.n_layers * (d * (2 * d_in + 2 * N + nh)
                               + d_in * d) * bpe + d * cfg.vocab_size * bpe
    per_layer = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d) * bpe
    if E:
        n_mlp = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        per_layer += d * E * 4                    # router (f32)
        per_layer += E * n_mlp * d * f * bpe      # expert stacks
        if cfg.dense_residual:
            per_layer += n_mlp * d * f * bpe
    else:
        per_layer += 3 * d * f * bpe
    return cfg.n_layers * per_layer + d * cfg.vocab_size * bpe


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b",
                                  "arctic-480b", "mamba2-1.3b"])
def test_dense_decode_step_equals_reference(ref, arch):
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    theirs = ref.analyze(lambda p, c, t: jax_decode_step(p, c, t, jcfg),
                         jparams, jax_init_cache(jcfg, 4, 16),
                         jnp.ones((4, 1), jnp.int32))
    mine = op_cost.analyze(lambda p, c, t: decode_step(p, c, t, cfg),
                           _port_params(jparams),
                           init_cache(cfg, 4, 16, device="cpu"),
                           torch.ones((4, 1), dtype=torch.int32))
    _assert_same_weights(mine, theirs, arch)
    assert int(mine["weight_bytes"]) == _analytic_weight_bytes(jcfg)
    assert theirs["dot_flops"] - mine["dot_flops"] == \
        _dot_gap(ref, cfg, "decode", 4, 1)


# --------------------------------------------- the engine's steps --

def _joint_costs(ref, arch, *, paged=False, dtype=None):
    """(port, reference) serving_cost_by_kind of ``arch`` reduced in joint
    mode, with the exact-chunk fallback."""
    jcfg = jax_get_config(arch, reduced=True, dbpim_mode="joint")
    cfg = get_config(arch, reduced=True, dbpim_mode="joint")
    if dtype is not None:
        jcfg, cfg = jcfg.scaled(dtype=dtype), cfg.scaled(dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jtables = jsl.build_stacked_tables(jparams, jcfg)
    pages = dict(n_pages=12, page_size=8) if paged else {}
    max_pages = MAX_LEN // 8 if paged else 0
    jenc = enc = None
    if jcfg.is_encdec:
        jenc = jnp.zeros((N_SLOTS, 8, jcfg.d_model), jnp.dtype(jcfg.dtype))
        enc = torch.zeros((N_SLOTS, 8, cfg.d_model),
                          dtype=getattr(torch, cfg.dtype))
    jcache = jax_init_cache(jcfg, N_SLOTS, MAX_LEN, enc_out=jenc, **pages)
    jcache["pos"] = jnp.zeros((N_SLOTS,), jnp.int32)
    if "attn" in jcache and "pos" in jcache["attn"]:
        jcache["attn"]["pos"] = jnp.zeros((N_SLOTS,), jnp.int32)
    from repro.obs import serving_cost_by_kind as jax_cost
    theirs = jax_cost(jcfg, make_test_mesh(),
                      jsl.strip_packed_projections(jparams, jcfg), jcache,
                      n_slots=N_SLOTS, prefill_chunk=CHUNK, tables=jtables,
                      include_exact_fallback=True, paged=paged,
                      max_pages=max_pages)
    params = _port_params(jparams)
    tables = build_stacked_tables(params, cfg)
    cache = init_cache(cfg, N_SLOTS, MAX_LEN, device="cpu", enc_out=enc,
                       **pages)
    mine = serving_cost_by_kind(cfg, strip_packed_projections(params, cfg),
                                cache, n_slots=N_SLOTS, prefill_chunk=CHUNK,
                                tables=tables, include_exact_fallback=True,
                                paged=paged, max_pages=max_pages)
    return cfg, mine, theirs


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b",
                                  "mixtral-8x7b", "jamba-v0.1-52b",
                                  "whisper-base"])
def test_joint_serving_costs_equal_reference(ref, arch):
    cfg, mine, theirs = _joint_costs(ref, arch)
    assert set(mine) == set(theirs)
    for kind in theirs:
        _assert_same_weights(mine[kind], theirs[kind], (arch, kind))
        assert any(p.startswith("tables/") for p in _rows(mine[kind]))
        assert theirs[kind]["dot_flops"] - mine[kind]["dot_flops"] == \
            _dot_gap(ref, cfg, kind, N_SLOTS, CHUNK), (arch, kind)
    if arch in JOINT_WEIGHT_BYTES:
        assert {k: int(v["weight_bytes"]) for k, v in mine.items()} == \
            JOINT_WEIGHT_BYTES[arch]
    if arch == "tinyllama-1.1b":
        assert int(mine["decode"]["dot_flops"]) == 2_473_984
        assert int(mine["decode"]["pallas_flops"]) == 2_359_296
        assert int(mine["prefill_chunk_exact"]["pallas_flops"]) == 2_359_296


def test_paged_serving_costs_equal_reference(ref):
    _, mine, theirs = _joint_costs(ref, "tinyllama-1.1b", paged=True)
    assert set(mine) == set(theirs) == {"decode", "prefill_chunk_exact"}
    for kind in theirs:
        _assert_same_weights(mine[kind], theirs[kind], kind)
        assert mine[kind]["dot_flops"] == theirs[kind]["dot_flops"]


# --------------------------------------- the per-layer kernel hooks --

@pytest.mark.parametrize("rows", [(2, 64), (1, 37)], ids=["rows128",
                                                          "rows37"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["value", "bit", "joint"])
def test_layer_kernel_modes_equal_reference(ref, mode, dtype, rows):
    """One MLP through kernel_dense_fn: 128 rows take the value and bit
    kernels, 37 rows the reference's plain math (an untagged dot rhs)."""
    kw = dict(name="t", family="dense", n_layers=1, vocab_size=64,
              dtype=dtype, dbpim=True, dbpim_value_sparsity=0.5,
              dbpim_mode=mode, d_model=512, n_heads=4, n_kv_heads=2,
              d_ff=1024)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jax_init_mlp(
        jcfg, jax.random.PRNGKey(0), jcfg.d_model, jcfg.d_ff))
    named = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal(
        rows + (cfg.d_model,)).astype(np.float32)
    jmm = jsl.kernel_dense_fn(jsl.build_kernel_tables(named, jcfg))
    theirs = ref.analyze(lambda p, v: jax_apply_mlp(p, v, jcfg, jmm),
                         jax.tree_util.tree_map(jnp.asarray, jp),
                         jnp.asarray(x).astype(jnp.dtype(dtype)))
    tables = build_kernel_tables(
        {k: torch.from_numpy(v.copy()) for k, v in named.items()}, cfg)
    mm = kernel_dense_fn(op_cost.to_meta(tables))
    mine = op_cost.analyze(lambda p, v: apply_mlp(p, v, cfg, mm),
                           params_from_numpy(jp, device="cpu"),
                           torch.from_numpy(x).to(getattr(torch, dtype)))
    _assert_same_weights(mine, theirs, (mode, dtype, rows))
    assert mine["dot_flops"] == theirs["dot_flops"]
    if mode != "joint" and rows == (1, 37):
        assert op_cost.UNTAGGED_DOT in _rows(mine)
    else:
        assert op_cost.UNTAGGED_PALLAS in _rows(mine)


def test_dbmu_kernel_equals_reference(ref):
    from repro.kernels.dbmu_sim import dbmu_matmul as jax_dbmu
    M, K, N = 16, 64, 256
    x = np.random.default_rng(1).integers(-127, 128, (M, K)).astype(np.int32)
    packed = np.random.default_rng(2).integers(0, 32, (K, N, 2)).astype(
        np.uint8)
    theirs = ref.analyze(lambda p, v: jax_dbmu(v, p["packed"]),
                         {"packed": jnp.asarray(packed)}, jnp.asarray(x))
    mine = op_cost.analyze(
        lambda p, v: ops.dbmu_reference_check(v, p["packed"]),
        {"packed": torch.from_numpy(packed)}, torch.from_numpy(x))
    _assert_same_weights(mine, theirs, "dbmu")
    assert mine["dot_flops"] == theirs["dot_flops"]
    # the two term planes, and the integer activation as an untagged
    # weight-like operand, as the reference counts it
    assert _rows(mine) == {"packed": K * N * 2,
                           op_cost.UNTAGGED_PALLAS: M * K * 4}


# ------------------------------------------ the lock-step "serve" step --

#: tinyllama reduced: (dtype, int8) -> (weight_bytes, untagged dot rhs)
SERVE_BYTES = {("bfloat16", False): (180_224, 0),
               ("bfloat16", True): (180_224, 147_456),
               ("float32", False): (360_448, 0),
               ("float32", True): (212_992, 147_456)}


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_serve_step_equals_reference(ref, arch, dtype, int8):
    """The int8 step is charged as the reference charges it: its weights
    are dequantized to bf16 by a multiply, which drops their tags, so each
    projection lands in the untagged dot row at bf16 size (converted to
    f32 at the product in an f32 model)."""
    jcfg = jax_get_config(arch, reduced=True).scaled(dtype=dtype)
    cfg = get_config(arch, reduced=True).scaled(dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jfn, _ = jax_build_step(jcfg, make_test_mesh(), "serve",
                            int8_weights=int8)
    theirs = ref.analyze(
        jfn, jsl.quantize_params_for_serving(jparams) if int8 else jparams,
        jax_init_cache(jcfg, 4, 16), jnp.ones((4, 1), jnp.int32))
    params = _port_params(jparams)
    fn = build_step(cfg, "serve", int8_weights=int8)
    assert fn.call_kind == "decode"
    mine = op_cost.analyze(
        fn, quantize_params_for_serving(params) if int8 else params,
        init_cache(cfg, 4, 16, device="cpu"),
        torch.ones((4, 1), dtype=torch.int32))
    _assert_same_weights(mine, theirs, (arch, dtype, int8))
    assert theirs["dot_flops"] - mine["dot_flops"] == \
        _dot_gap(ref, cfg, "decode", 4, 1)
    if arch == "tinyllama-1.1b":
        total, untagged = SERVE_BYTES[dtype, int8]
        assert int(mine["weight_bytes"]) == total
        assert _rows(mine).get(op_cost.UNTAGGED_DOT, 0) == untagged


def test_serve_step_refuses_what_the_reference_refuses():
    cfg = get_config("tinyllama-1.1b", reduced=True, dbpim_mode="joint")
    from repro_torch.models import init_params
    tables = build_stacked_tables(init_params(cfg, seed=0, device="cpu"),
                                  cfg)
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_step(cfg, "serve", stacked_tables=tables, int8_weights=True)
    with pytest.raises(ValueError, match="'serve' step format"):
        build_step(cfg, "decode", int8_weights=True)
    paged = init_cache(cfg, 2, 16, device="cpu", n_pages=4, page_size=8)
    with pytest.raises(ValueError, match="page table"):
        build_step(cfg, "serve")(init_params(cfg, seed=0, device="cpu"),
                                 paged, torch.ones((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="not in"):
        build_step(cfg, "train")


# ------------------------------------------------------- passivity --

def test_analyze_is_passive():
    """The in-place decode step analysed: its args keep their bits, no
    wrapper's LAUNCHES moves, and analyze does not nest."""
    cfg = get_config("tinyllama-1.1b", reduced=True, dbpim_mode="joint")
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, device="cpu")
    tables = build_stacked_tables(params, cfg)
    params = strip_packed_projections(params, cfg)
    cache = init_cache(cfg, N_SLOTS, MAX_LEN, device="cpu")
    cache["pos"] = torch.tensor([3, 5], dtype=torch.int32)
    cache["attn"]["pos"] = cache["pos"].clone()
    cache["attn"]["k"].normal_()
    before = {k: v.clone() for k, v in cache["attn"].items()}
    kernels = (joint_sparse_matmul, block_sparse_matmul, fta_int8_matmul,
               dbmu_sim, row_attention, row_norm)
    launches = [k.LAUNCHES for k in kernels]
    step = build_step(cfg, "decode", stacked_tables=op_cost.to_meta(tables))
    with pytest.raises(RuntimeError, match="nest"):
        op_cost.analyze(lambda: op_cost.analyze(lambda: None))
    tok = torch.ones((N_SLOTS, 1), dtype=torch.int32)
    act = torch.ones((N_SLOTS,), dtype=torch.bool)
    acc = op_cost.analyze(step, params, cache, tok, act)
    assert acc["weight_bytes"] > 0 and not op_cost.recording()
    for k, v in before.items():
        assert torch.equal(cache["attn"][k], v), k
    assert torch.equal(cache["pos"], torch.tensor([3, 5], dtype=torch.int32))
    assert [k.LAUNCHES for k in kernels] == launches


def test_wrappers_report_only_meta_calls_of_their_thread():
    """While analyze runs, a kernel wrapper reports only calls on meta
    tensors: a host tensor reaching one in the analysing thread is refused,
    not skipped; another thread's host call runs its plain version and is
    not charged; a meta tensor with nothing recording is refused by the
    wrapper itself."""
    import threading
    x = torch.randn(3, 8)
    scale = torch.rand(8)
    with pytest.raises(RuntimeError, match="only its meta copies"):
        op_cost.analyze(lambda: row_norm.row_norm(x, scale))
    seen = {}

    def host_call():
        seen["y"] = row_norm.row_norm(x, scale)

    def fn(m, s):
        t = threading.Thread(target=host_call)
        t.start()
        t.join()
        return row_norm.row_norm(m, s)

    acc = op_cost.analyze(fn, x, scale, weight_argnums=())
    assert torch.equal(seen["y"], row_norm.row_norm_plain(x, scale))
    # one RMS norm of 3 rows of 8 as the hook charges it, and the 24
    # elements of its empty meta output; the other thread's ops are not
    assert acc["flops"] == (3 * 24 + 4 * 3) + 24
    with pytest.raises(ValueError, match="not meta"):
        row_norm.row_norm(x.to("meta"), scale.to("meta"))


def test_engine_waterfall_leaves_the_engine_as_it_was():
    cfg = get_config("tinyllama-1.1b", reduced=True, dbpim_mode="joint")
    from repro_torch.models import init_params
    params = init_params(cfg, seed=0, device="cpu")
    tables = build_stacked_tables(params, cfg)
    engine = ServeEngine(cfg, strip_packed_projections(params, cfg),
                         n_slots=N_SLOTS, max_len=MAX_LEN,
                         prefill_chunk=CHUNK, stacked_tables=tables,
                         device="cpu")
    trace = make_trace(WorkloadSpec(n_requests=3, arrival_rate=1.0,
                                    prompt_len=(2, 7), gen_len=(2, 4),
                                    seed=5), cfg.vocab_size)
    engine.run(trace)
    cache = {k: v.clone() for k, v in engine.cache["attn"].items()}
    counts = engine.sentinel.counts()
    wf = engine_waterfall(engine)
    assert set(wf) == {"decode", "prefill_chunk_exact"}
    for kind, w in wf.items():
        assert sum(w["rows"].values()) == w["total"]
        assert w["total"] == JOINT_WEIGHT_BYTES["tinyllama-1.1b"][kind]
    assert engine.sentinel.counts() == counts
    for k, v in cache.items():
        assert torch.equal(engine.cache["attn"][k], v), k


def test_serve_cli_waterfalls_are_passive_and_render(tmp_path, capsys):
    """--trace-out embeds one waterfall per call kind: the same streams as
    the run without a trace, a trace that validates under both packages,
    and the report renders its waterfalls as the reference's render."""
    from repro.launch.report import render as ref_render
    from repro.obs import validate as ref_validate
    from repro_torch.launch import report, serve
    from repro_torch.obs import load
    args = ["--arch", "mamba2-1.3b", "--reduced", "--dbpim-mode", "joint",
            "--device", "cpu", "--requests", "3", "--max-len", "24",
            "--gen-len", "3", "--prompt-len", "2", "9", "--prefill-chunk",
            "4"]
    bare = serve.main(args)
    path = tmp_path / "t.jsonl"
    traced = serve.main(args + ["--trace-out", str(path)])
    capsys.readouterr()
    assert traced == bare
    records = load(str(path))
    stats = validate(records)
    assert stats == ref_validate(records)
    waterfalls = [r for r in records if r["type"] == "waterfall"]
    assert stats["waterfalls"] == len(waterfalls) == 2
    assert {w["kind"]: w["total"] for w in waterfalls} == {
        "decode": 101_920.0, "prefill_parallel": 101_920.0}
    for w in waterfalls:
        assert sum(w["rows"].values()) == w["total"]
    out = report.render(records)
    assert "WATERFALL" in out and out == ref_render(records)


def test_tracer_waterfall_record():
    tr = Tracer(arch="a")
    tr.waterfall("decode", {"embed/out": 3, "tables/wq/idx": 5}, 8)
    assert tr.records[-1] == {"type": "waterfall", "kind": "decode",
                              "total": 8.0, "rows": {"embed/out": 3.0,
                                                     "tables/wq/idx": 5.0}}
    assert validate(tr.records)["waterfalls"] == 1
