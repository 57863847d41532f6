"""The port's decode path against the JAX package's on reduced fp32
dense-family models: decode_step with stacked joint tables against JAX
decode_step with tables (Pallas in interpret mode), decode_chunk against
JAX stepwise decode, and the port's own chunk == stepwise invariant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro.sparsity.sparse_linear import \
    reconstruct_stacked_params as jax_reconstruct
from repro_torch.configs import get_config
from repro_torch.models import (decode_chunk, decode_step, init_cache,
                                merge_slots, reset_slots)
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                reconstruct_stacked_params,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port


def _close(got, ref, what=""):
    """The tolerance of tests/test_stacked_serving.py: 1e-4 * max(|ref|, 1)
    (fp32 on both sides, sums in another order)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    tol = 1e-4 * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _setup(arch="tinyllama-1.1b", bk=32):
    jcfg = jax_get_config(arch, reduced=True, dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    cfg = get_config(arch, reduced=True, dbpim_mode="joint").scaled(
        dtype="float32", dbpim_value_sparsity=0.5)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return (jcfg, jparams, jax_tables(jparams, jcfg, bk=bk, bn=bk),
            cfg, params, build_stacked_tables(params, cfg, bk=bk, bn=bk))


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def _cache_close(cache, jcache):
    for key in ("k", "v"):
        _close(cache["attn"][key], jcache["attn"][key], key)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_decode_step_with_tables_matches_jax(tiny):
    """Three steps from a fresh cache (scalar pos), then steps at per-slot
    (B,) positions: logits and caches at tolerance every step."""
    jcfg, jparams, jt, cfg, params, t = tiny
    B, max_len = 3, 16
    rng = np.random.default_rng(0)
    jcache = jax_init_cache(jcfg, B, max_len)
    cache = init_cache(cfg, B, max_len, device="cpu")
    for step in range(3):
        tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jax_decode_step(jparams, jcache, jnp.asarray(tok), jcfg,
                                     tables=jt)
        lg, cache = decode_step(params, cache, torch.from_numpy(tok), cfg,
                                tables=t)
        _close(lg, jl, f"logits step {step}")
        _cache_close(cache, jcache)
    pos = np.array([3, 7, 5], np.int32)
    jcache["pos"] = jnp.asarray(pos)
    cache["pos"] = torch.from_numpy(pos)
    tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
    jl, jcache = jax_decode_step(jparams, jcache, jnp.asarray(tok), jcfg,
                                 tables=jt)
    lg, cache = decode_step(params, cache, torch.from_numpy(tok), cfg,
                            tables=t)
    _close(lg, jl, "logits at per-slot positions")
    _cache_close(cache, jcache)


def test_stripped_params_give_bitwise_logits(tiny):
    _, _, _, cfg, params, t = tiny
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    cache = init_cache(cfg, 2, 8, device="cpu")
    a, _ = decode_step(params, cache, tok, cfg, tables=t)
    stripped = strip_packed_projections(params, cfg)
    assert stripped["blocks"]["attn"]["wq"].shape == (cfg.n_layers, 1, 1)
    b, _ = decode_step(stripped, cache, tok, cfg, tables=t)
    assert torch.equal(a, b)


def test_reconstructed_params_match_jax_and_serve_like_tables(tiny):
    jcfg, jparams, jt, cfg, params, t = tiny
    recon = reconstruct_stacked_params(params, t, cfg)
    jrecon = jax_reconstruct(jparams, jt, jcfg)
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(
            recon["blocks"]["attn"][name].numpy(),
            np.asarray(jrecon["blocks"]["attn"][name]))
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    cache = init_cache(cfg, 2, 8, device="cpu")
    a, _ = decode_step(params, cache, tok, cfg, tables=t)
    b, _ = decode_step(recon, cache, tok, cfg)
    _close(a, b.numpy(), "tables vs reconstructed plain matmuls")


def _jax_stepwise(jcfg, jparams, jt, prompts, max_len):
    step = jax.jit(lambda p, c, tok: jax_decode_step(p, c, tok, jcfg,
                                                     tables=jt))
    jcache = jax_init_cache(jcfg, prompts.shape[0], max_len)
    jcache["pos"] = jnp.zeros((prompts.shape[0],), jnp.int32)
    for i in range(prompts.shape[1]):
        jl, jcache = step(jparams, jcache, jnp.asarray(prompts[:, i:i + 1]))
    return jl, jcache


def _port_stepwise(cfg, params, t, prompts, max_len):
    cache = init_cache(cfg, prompts.shape[0], max_len, device="cpu")
    cache["pos"] = torch.zeros((prompts.shape[0],), dtype=torch.int32)
    for i in range(prompts.shape[1]):
        lg, cache = decode_step(params, cache,
                                torch.from_numpy(prompts[:, i:i + 1]), cfg,
                                tables=t)
    return lg, cache


def _port_chunked(cfg, params, t, prompts, max_len, chunk):
    B, P = prompts.shape
    cache = init_cache(cfg, B, max_len, device="cpu")
    cache["pos"] = torch.zeros((B,), dtype=torch.int32)
    for s in range(0, P, chunk):
        n = min(chunk, P - s)
        toks = np.zeros((B, chunk), np.int32)
        toks[:, :n] = prompts[:, s:s + n]
        lg, cache = decode_chunk(params, cache, torch.from_numpy(toks),
                                 torch.full((B,), n, dtype=torch.int32), cfg,
                                 tables=t)
    return lg, cache


def test_chunk_matches_jax_stepwise_and_port_stepwise(tiny):
    """The JAX chunk path is not bitwise its stepwise decode on this tree,
    so the port's chunk is held against JAX *stepwise* at tolerance.

    Inside the port, a 1-token chunk is bitwise one decode step (the same
    math), and wider chunks agree with stepwise decode to 1e-6 * max(|ref|,
    1), not bitwise: PyTorch's CPU matmuls block their K-sums by the row
    count, so a row of a C-row product differs from the same row of a
    1-row product in the last bits (measured: 7.2e-7 on logits of
    magnitude 3.3). The CUDA kernel is row-stable by construction;
    chip_smoke.py holds its rows bitwise across M on the card."""
    jcfg, jparams, jt, cfg, params, t = tiny
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 7)).astype(np.int32)
    jl, jcache = _jax_stepwise(jcfg, jparams, jt, prompts, 16)
    sl, scache = _port_stepwise(cfg, params, t, prompts, 16)
    _close(sl, jl, "port stepwise vs JAX stepwise")
    cl, ccache = _port_chunked(cfg, params, t, prompts, 16, 1)
    assert torch.equal(cl, sl)
    for key in ("k", "v"):
        assert torch.equal(ccache["attn"][key], scache["attn"][key])
    tol = 1e-6 * max(sl.abs().max().item(), 1.0)
    for chunk in (3, 7, 8):
        cl, ccache = _port_chunked(cfg, params, t, prompts, 16, chunk)
        _close(cl, jl, f"port chunk {chunk} vs JAX stepwise")
        _cache_close(ccache, jcache)
        assert (cl - sl).abs().max().item() <= tol, chunk
        assert torch.equal(cl.argmax(-1), sl.argmax(-1))
        for key in ("k", "v"):
            assert (ccache["attn"][key] - scache["attn"][key]).abs().max() \
                <= tol
        assert torch.equal(ccache["pos"], scache["pos"])


def test_idle_slot_cache_untouched_and_last_valid_row(tiny):
    """n_valid = 0 leaves a slot's cache slice bitwise as it was; the
    logits come from each slot's last valid row (clip(n_valid-1, 0, C-1))."""
    _, _, _, cfg, params, t = tiny
    B, C = 2, 4
    cache = init_cache(cfg, B, 16, device="cpu")
    cache["pos"] = torch.zeros((B,), dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    cache["attn"]["k"] = torch.randn(cache["attn"]["k"].shape, generator=g)
    cache["attn"]["v"] = torch.randn(cache["attn"]["v"].shape, generator=g)
    toks = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 10]], dtype=torch.int32)
    lg, new = decode_chunk(params, cache, toks,
                           torch.tensor([2, 0], dtype=torch.int32), cfg,
                           tables=t)
    assert torch.equal(new["attn"]["k"][:, 1], cache["attn"]["k"][:, 1])
    assert torch.equal(new["attn"]["v"][:, 1], cache["attn"]["v"][:, 1])
    assert torch.equal(new["attn"]["k"][:, 0, 2:], cache["attn"]["k"][:, 0, 2:])
    assert new["pos"].tolist() == [2, 0]
    one, _ = decode_chunk(params, cache, toks[:, :2],
                          torch.tensor([2, 0], dtype=torch.int32), cfg,
                          tables=t)
    assert torch.equal(lg[0], one[0])


def test_merge_and_reset_slots():
    cfg = get_config("tinyllama-1.1b", reduced=True)
    old = init_cache(cfg, 3, 8, device="cpu")
    new = {"pos": torch.tensor(5, dtype=torch.int32),
           "attn": {k: torch.ones_like(v) for k, v in old["attn"].items()}}
    keep = torch.tensor([True, False, True])
    m = merge_slots(new, old, keep, cfg)
    assert m["pos"].tolist() == [5, 0, 5]
    assert m["attn"]["pos"].tolist() == [1, 0, 1]
    assert m["attn"]["k"][:, 1].abs().sum() == 0
    assert (m["attn"]["k"][:, 0] == 1).all()
    r = reset_slots(m, torch.tensor([True, False, False]), cfg)
    assert r["pos"].tolist() == [0, 0, 5]
    assert r["attn"]["k"][:, 0].abs().sum() == 0
    assert (r["attn"]["k"][:, 2] == 1).all()


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma-7b", "stablelm-1.6b",
                                  "pixtral-12b"])
def test_dense_variants_decode_step_match_jax(arch):
    """qk-norm (qwen3), (1 + w) norm / geglu / embed scale / tied
    embeddings (gemma), layernorm / partial RoPE (stablelm), a
    vision-stub config decoding text-only (pixtral: its patch_proj rides
    in the params, unread): one decode step with tables against JAX."""
    jcfg, jparams, jt, cfg, params, t = _setup(arch, bk=None)
    tok = np.array([[3], [17]], np.int32)
    jl, jcache = jax_decode_step(jparams, jax_init_cache(jcfg, 2, 8),
                                 jnp.asarray(tok), jcfg, tables=jt)
    lg, cache = decode_step(params, init_cache(cfg, 2, 8, device="cpu"),
                            torch.from_numpy(tok), cfg, tables=t)
    _close(lg, jl, arch)
    _cache_close(cache, jcache)
