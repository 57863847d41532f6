"""The port's full-sequence forward against the JAX package's on reduced
configs of every family: causal_mask, _chunked_sdpa and the windowed
plain attention (row_attention_plain) against the reference's masks and
_sdpa, the SSM's _causal_conv and apply_ssm, forward (tinyllama, qwen3,
gemma, stablelm, mixtral past its window, mamba2, jamba, whisper with
enc_out, pixtral with its patch embeddings) with and without stacked
joint tables, decode.prefill (whisper with frames) and build_prefill_step
on a make_train_batch batch against the reference's prefill (text only:
pixtral's patches enter through forward); pixtral served text-only by the engine
against JAX stepwise decode, and by the serve CLI; and, in the port
alone, forward's logits against stepwise decode's at every position. The
same JAX-initialised params go to both packages through
params_from_numpy.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_forward.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro.models.decode import prefill as jax_prefill
from repro.models.inputs import make_train_batch as jax_train_batch
from repro.models.transformer import encode as jax_encode
from repro.models.transformer import forward as jax_forward
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro_torch.configs import get_config
from repro_torch.kernels import row_attention as rak
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import (decode_step, encode, forward, init_cache,
                                init_params, prefill)
from repro_torch.models import attention, ssm
from repro_torch.models.ssm import PARALLEL_PREFILL_ATOL
from repro_torch.models.inputs import make_train_batch
from repro_torch.obs import RecompileSentinel
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

#: the nine families' reduced configs forward runs
ARCHS = ["tinyllama-1.1b", "qwen3-8b", "gemma-7b", "stablelm-1.6b",
         "mixtral-8x7b", "mamba2-1.3b", "jamba-v0.1-52b", "whisper-base",
         "pixtral-12b"]
#: float32 on both sides, sums in another order: relative to max|ref|
F32_RTOL = 1e-5
#: bf16 on both sides: each side rounds its own products and sums to bf16
BF16_RTOL = 2e-2
#: tokens per sequence: reduced mixtral's window is 32, so S = 64 runs
#: past it; a multiple of the reduced SSM chunk (32)
SEQ = 64


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, ref, rtol, what=""):
    """max|got - ref| <= rtol * max|ref|."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    tol = rtol * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _cfgs(arch, dtype="float32"):
    jcfg = jax_get_config(arch, reduced=True, dbpim_mode="joint").scaled(
        dtype=dtype, dbpim_value_sparsity=0.5)
    cfg = get_config(arch, reduced=True, dbpim_mode="joint").scaled(
        dtype=dtype, dbpim_value_sparsity=0.5)
    return jcfg, cfg


def _model(arch, dtype="float32", seed=0):
    """(jcfg, JAX params, cfg, the same params in the port)."""
    jcfg, cfg = _cfgs(arch, dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def _extra(arch, jcfg, jparams, cfg, params, B, seed=1):
    """forward's extra inputs of a family, made once in numpy: whisper's
    encoder output (JAX's and the port's, from the same frames) and
    pixtral's patch embeddings; {} for the rest. Returns (jax kwargs,
    port kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        frames = rng.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model))
        jf = jnp.asarray(frames, jcfg.dtype)
        tf = params_from_numpy(np.asarray(jf), device="cpu")
        return ({"enc_out": jax_encode(jparams, jf, jcfg)},
                {"enc_out": encode(params, tf, cfg)})
    if cfg.frontend == "vision_stub":
        fe = rng.normal(0, 1, (B, cfg.n_patches, cfg.d_model))
        jf = jnp.asarray(fe, jcfg.dtype)
        return ({"frontend_embeds": jf},
                {"frontend_embeds": params_from_numpy(np.asarray(jf),
                                                      device="cpu")})
    return {}, {}


def _tokens(cfg, B=2, S=SEQ, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ------------------------------------------------- masks and attention ---

@pytest.mark.parametrize("sq,skv,window", [(8, 8, 0), (8, 8, 3), (5, 12, 0),
                                           (5, 12, 4), (16, 16, 16),
                                           (1, 20, 6)])
def test_causal_mask_matches_jax(sq, skv, window):
    """causal_mask byte for byte, with and without a window."""
    got = attention.causal_mask(sq, skv, window)
    ref = np.asarray(jax_attention.causal_mask(sq, skv, window))
    assert got.dtype == torch.bool and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _qkv(seed, B=2, S=32, Hq=4, Hkv=2, hd=16, repeat=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, S, Hq, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, Hkv, hd)).astype(np.float32)
    if repeat:
        k, v = (np.repeat(a, Hq // Hkv, axis=2) for a in (k, v))
    return q, k, v


@pytest.mark.parametrize("window", [0, 12])
def test_chunked_sdpa_matches_jax_and_the_plain_twin(window):
    """_chunked_sdpa at chunk 8 over S = 32 (4 x 4 blocks, upper ones
    masked) against the reference's, and against row_attention_plain at
    the same window, float32 at 1e-5 of the peak."""
    jcfg, cfg = _cfgs("mixtral-8x7b")
    jcfg, cfg = jcfg.scaled(window=window), cfg.scaled(window=window)
    q, k, v = _qkv(3, repeat=True)
    ref = jax_attention._chunked_sdpa(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jcfg, jnp.float32,
                                      chunk=8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention._chunked_sdpa(tq, tk, tv, cfg, torch.float32, chunk=8)
    _close(got, ref, F32_RTOL, "_chunked_sdpa")
    qpos = torch.arange(32, dtype=torch.int32).expand(2, 32)
    _close(got, rak.row_attention_plain(tq, tk, tv, qpos, window),
           F32_RTOL, "row_attention_plain")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 1, 5, 12, 32])
def test_windowed_plain_twin_matches_jax_sdpa(window, dtype):
    """row_attention_plain(window=...) with GQA against the reference's
    _sdpa under causal_mask(S, S, window) on the repeated KV heads."""
    q, k, v = _qkv(4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    ref = jax_attention._sdpa(jq, jax_attention._repeat_kv(jk, 2),
                              jax_attention._repeat_kv(jv, 2),
                              jax_attention.causal_mask(32, 32, window), jdt)
    tq, tk, tv = (params_from_numpy(np.asarray(a), device="cpu")
                  for a in (jq, jk, jv))
    qpos = torch.arange(32, dtype=torch.int32).expand(2, 32)
    got = rak.row_attention(tq, tk, tv, qpos, window)
    _close(got, ref, F32_RTOL if dtype == "float32" else BF16_RTOL)


def test_row_attention_refuses_a_negative_window():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5))
    qpos = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        rak.row_attention(q, k, v, qpos, -1)
    with pytest.raises(ValueError, match="window"):
        rak._check(q, k, v, qpos, -3)


@pytest.mark.parametrize("window", [0, 6])
def test_causal_attention_matches_jax(window):
    """attention(causal=True) of one layer (projections, RoPE, GQA, the
    window) against the reference's; it no longer raises."""
    jcfg, jparams, cfg, params = _model("mixtral-8x7b")
    jcfg, cfg = jcfg.scaled(window=window), cfg.scaled(window=window)
    x = np.random.default_rng(6).normal(0, 1, (2, 20, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["attn"])
    p = {k: v[0] for k, v in params["blocks"]["attn"].items()}
    ref = jax_attention.attention(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = attention.attention(p, torch.from_numpy(x), cfg,
                              torch.from_numpy(pos.copy()))
    _close(got, ref, F32_RTOL)


# ----------------------------------------------------------------- SSM ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(7)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xbc, w, b = (jnp.asarray(rng.normal(0, 1, s), jdt)
                 for s in ((2, 10, 24), (4, 24), (24,)))
    ref = jax_ssm._causal_conv(xbc, w, b)
    got = ssm._causal_conv(*(params_from_numpy(np.asarray(a), device="cpu")
                             for a in (xbc, w, b)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, F32_RTOL if dtype == "float32" else BF16_RTOL)


@pytest.mark.parametrize("L", [32, 64])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_apply_ssm_matches_jax(arch, L):
    """apply_ssm of one layer, one chunk (L = ssm_chunk = 32) and two,
    against the reference's; a sequence the chunk does not divide is
    refused, as the reference's assertion refuses it."""
    jcfg, cfg = _cfgs(arch)
    jp = jax_ssm.init_ssm(jcfg, jax.random.PRNGKey(8))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                          device="cpu")
    x = np.random.default_rng(9).normal(0, 1, (2, L, cfg.d_model)).astype(
        np.float32)
    ref = jax_ssm.apply_ssm(jp, jnp.asarray(x), jcfg)
    got = ssm.apply_ssm(p, torch.from_numpy(x), cfg)
    _close(got, ref, F32_RTOL)
    with pytest.raises(AssertionError, match="not divisible"):
        ssm.apply_ssm(p, torch.zeros((1, 40, cfg.d_model)), cfg)


# ------------------------------------------------------------- forward ---

@pytest.mark.parametrize("tables", ["dense", "joint"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, tables):
    """forward over 2 x 64 tokens (pixtral: 8 patches first), all logits,
    float32, plain matmuls or every projection through the stacked joint
    tables (32-wide tiles), against the reference's forward at 1e-5 of
    the peak."""
    jcfg, jparams, cfg, params = _model(arch)
    jt = t = None
    if tables == "joint":
        jt = jax_tables(jparams, jcfg, bk=32, bn=32)
        t = build_stacked_tables(params, cfg, bk=32, bn=32)
    jx, tx = _extra(arch, jcfg, jparams, cfg, params, 2)
    toks = _tokens(cfg)
    ref = jax_forward(jparams, jnp.asarray(toks), jcfg, tables=jt, **jx)
    got = forward(params, torch.from_numpy(toks), cfg, tables=t, **tx)
    assert tuple(got.shape) == (2, SEQ, cfg.vocab_size)
    _close(got, ref, F32_RTOL, f"{arch} {tables}")


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "jamba-v0.1-52b"])
def test_forward_bf16_matches_jax(arch):
    """The same in bf16 (the served dtype), last position only, at 2e-2 of
    the peak: each side rounds its own sums to bf16. (jamba's 16-expert
    top-2 routing flips near-tied choices between the two sides' bf16
    roundings, as on the card; its float32 forward is held above.)"""
    jcfg, jparams, cfg, params = _model(arch, "bfloat16")
    jx, tx = _extra(arch, jcfg, jparams, cfg, params, 2)
    toks = _tokens(cfg, seed=2)
    ref = jax_forward(jparams, jnp.asarray(toks), jcfg, last_only=True, **jx)
    got = forward(params, torch.from_numpy(toks), cfg, last_only=True, **tx)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (2, 1, cfg.vocab_size)
    _close(got, ref, BF16_RTOL, arch)


def test_pixtral_params_carry_patch_proj():
    """The port's pixtral tree has the reference's patch_proj (d, d) in
    cfg.dtype beside the decoder, and the weight bridge carries it."""
    jcfg, jparams, cfg, params = _model("pixtral-12b", "bfloat16")
    mine = init_params(cfg, seed=0, device="cpu")
    assert set(mine) == set(jparams) == set(params)
    assert mine["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    assert mine["patch_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["patch_proj"].view(torch.int16).numpy(),
        np.asarray(jparams["patch_proj"]).view(np.int16))


def test_prefill_matches_jax():
    """decode.prefill of whisper (frames encoded first) against the
    reference's prefill, with and without tables."""
    jcfg, jparams, cfg, params = _model("whisper-base")
    frames = np.random.default_rng(10).normal(
        0, 1, (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    toks = _tokens(cfg, S=16)
    for jt, t in ((None, None),
                  (jax_tables(jparams, jcfg, bk=32, bn=32),
                   build_stacked_tables(params, cfg, bk=32, bn=32))):
        ref = jax_prefill(jparams, jnp.asarray(toks), jcfg,
                          frames=jnp.asarray(frames), tables=jt)
        got = prefill(params, torch.from_numpy(toks), cfg,
                      frames=torch.from_numpy(frames), tables=t)
        assert tuple(got.shape) == (2, 1, cfg.vocab_size)
        _close(got, ref, F32_RTOL)


def _train_batches(arch):
    """The JAX package's and the port's make_train_batch (the same draws:
    pixtral's patches, whisper's frames) and the reduced model of
    ``arch`` with its joint tables on both sides."""
    jcfg, jparams, cfg, params = _model(arch)
    jb = jax_train_batch(jcfg, 2, 24, seed=3)
    b = make_train_batch(cfg, 2, 24, seed=3, device="cpu")
    assert set(b) == set(jb)
    for key in jb:
        np.testing.assert_array_equal(_np(b[key]), _np(jb[key]), key)
    return (jcfg, jparams, jax_tables(jparams, jcfg, bk=32, bn=32), jb,
            cfg, params, build_stacked_tables(params, cfg, bk=32, bn=32), b)


@pytest.mark.parametrize("arch", ["pixtral-12b", "whisper-base",
                                  "tinyllama-1.1b"])
def test_prefill_step_on_a_train_batch_matches_jax(arch):
    """build_prefill_step on make_train_batch against what the reference's
    build_prefill_step calls on its own batch, with joint tables:
    ``prefill(params, batch["tokens"], cfg, frames=batch.get("frames"))``
    (text only: pixtral's patches are not passed on)."""
    jcfg, jparams, jt, jb, cfg, params, tables, b = _train_batches(arch)
    ref = jax_prefill(jparams, jb["tokens"], jcfg, frames=jb.get("frames"),
                      tables=jt)
    step = build_prefill_step(cfg, stacked_tables=tables)
    assert step.call_kind == "prefill"
    got = step(params, b)
    assert tuple(got.shape) == (2, 1, cfg.vocab_size)
    _close(got, ref, F32_RTOL)


def test_prefill_step_leaves_pixtral_patches_to_forward():
    """On a pixtral batch with patches, the port's prefill step equals the
    reference's (text only), and so parts from forward(frontend_embeds=...),
    which the patch path is held to against the reference's own."""
    jcfg, jparams, jt, jb, cfg, params, tables, b = _train_batches(
        "pixtral-12b")
    assert b["frontend"].shape == (2, cfg.n_patches, cfg.d_model)
    step = build_prefill_step(cfg, stacked_tables=tables)(params, b)
    _close(step, jax_prefill(jparams, jb["tokens"], jcfg, tables=jt),
           F32_RTOL)
    patched = forward(params, b["tokens"], cfg, frontend_embeds=b["frontend"],
                      last_only=True, tables=tables)
    _close(patched, jax_forward(jparams, jb["tokens"], jcfg,
                                frontend_embeds=jb["frontend"],
                                last_only=True, tables=jt), F32_RTOL)
    gap = (step - patched).abs().max().item()
    assert gap > 100 * F32_RTOL * patched.abs().max().item(), gap


# ------------------------------------------------- forward == decoding ---

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_stepwise_decode(arch):
    """The port alone: forward's logits at every position against stepwise
    decode's over the same tokens. Attention stacks in bf16 within 2e-2
    (the reference's tests/test_system.py holds its own the same way);
    mixtral's ring (32 rows) wraps once over the 64 tokens; pixtral
    decodes text-only; whisper reads the same encoder output both ways.
    Stacks with SSM layers (mamba2, jamba) run the parallel SSD form in
    forward, held in float32 within the reference's contract of that form
    against the recurrence (PARALLEL_PREFILL_ATOL). MoE stacks run with
    capacity for every assignment: forward dispatches the whole sequence
    under one capacity, and the tokens it drops past an expert's capacity
    a decode step never drops (the reference's forward parts from its own
    stepwise decode there too)."""
    ssm_layers = arch in ("mamba2-1.3b", "jamba-v0.1-52b")
    dtype = "float32" if ssm_layers else "bfloat16"
    _, cfg = _cfgs(arch, dtype)
    if cfg.n_experts:
        cfg = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
    params = init_params(cfg, seed=4, device="cpu")
    B = 2
    enc = None
    if cfg.is_encdec:
        frames = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                             generator=torch.Generator().manual_seed(5))
        enc = encode(params, frames.to(params["embed"]["tok"].dtype), cfg)
    toks = torch.from_numpy(_tokens(cfg, B))
    full = forward(params, toks, cfg, enc_out=enc)
    cache = init_cache(cfg, B, SEQ, device="cpu", enc_out=enc)
    steps = []
    for i in range(SEQ):
        lg, cache = decode_step(params, cache, toks[:, i:i + 1], cfg)
        steps.append(lg[:, 0])
    tol = (dict(rtol=0, atol=PARALLEL_PREFILL_ATOL[dtype]) if ssm_layers
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(_np(torch.stack(steps, 1)), _np(full), **tol)


# ---------------------------------------------------- pixtral served ---

def _jax_greedy_streams(jcfg, jparams, jt, trace, max_len):
    """Every request through JAX stepwise decode, one batch row each: a row
    feeds its prompt token by token, then its own greedy tokens."""
    step = jax.jit(lambda p, c, tok: jax_decode_step(p, c, tok, jcfg,
                                                     tables=jt))
    B = len(trace)
    cache = jax_init_cache(jcfg, B, max_len)
    cache["pos"] = jnp.zeros((B,), jnp.int32)
    streams = [[] for _ in trace]
    for t in range(max(r.prompt_len + r.gen_len - 1 for r in trace)):
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


def test_pixtral_engine_streams_equal_jax_stepwise():
    """The engine serves reduced fp32 pixtral text-only on joint tables
    (chunks tagged prefill_chunk_exact, one signature per step): every
    greedy stream equals JAX stepwise decode's on the same params."""
    jcfg, jparams, cfg, params = _model("pixtral-12b")
    spec = WorkloadSpec(n_requests=5, arrival_rate=0.7, prompt_len=(3, 12),
                        gen_len=(4, 8), seed=3)
    trace = make_trace(spec, cfg.vocab_size)
    engine = ServeEngine(cfg, strip_packed_projections(params, cfg),
                         n_slots=3, max_len=24, prefill_chunk=4,
                         stacked_tables=build_stacked_tables(
                             params, cfg, bk=32, bn=32), device="cpu")
    outputs = engine.run(trace)
    assert engine.prefill_kind == "prefill_chunk_exact"
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(k, cfg.name): 1
        for k in ("decode", "prefill_chunk_exact", "reset")}
    ref = _jax_greedy_streams(jcfg, jparams,
                              jax_tables(jparams, jcfg, bk=32, bn=32),
                              trace, 24)
    for r in trace:
        assert outputs[r.rid] == ref[r.rid], r.rid
        assert len(outputs[r.rid]) == r.gen_len


def test_serve_cli_serves_pixtral_on_the_cpu(capsys):
    """repro_torch.launch.serve --arch pixtral-12b --reduced --device cpu:
    pixtral is no longer refused; it serves text-only, as the reference's
    CLI does."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", "pixtral-12b", "--reduced", "--dbpim-mode",
                      "joint", "--device", "cpu", "--requests", "3",
                      "--max-len", "24", "--gen-len", "3", "--prompt-len",
                      "2", "9", "--prefill-chunk", "4"])
    assert len(out) == 3 and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert "3/3 requests" in text
    assert "prefill_chunk_exact@pixtral-smoke=1" in text
