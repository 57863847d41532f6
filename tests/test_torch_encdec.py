"""The port's enc-dec family (whisper: the encoder, cross-attention,
sinusoidal positions, LayerNorm and the plain gelu MLP) against the JAX
package on reduced fp32 whisper: the inputs, the param tree, the packs
(cross-attention included) and what strip_packed_projections strips (the
encoder stays dense), encode and cross_attention, decode_step and
decode_chunk with every cache leaf, chunk == stepwise, the slot surgery
around "enc_out", the engine (its streams against JAX stepwise decode)
and the serve CLI. Card tests hold the kernels at whisper's full-width
shapes against their plain versions and skip without a card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_encdec.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models.decode import _sinusoidal_at as jax_sinusoidal_at
from repro.models.inputs import make_decode_token as jax_decode_token
from repro.models.inputs import make_train_batch as jax_train_batch
from repro.models.transformer import _sinusoidal as jax_sinusoidal
from repro.models.transformer import encode as jax_encode
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro.sparsity.sparse_linear import \
    strip_packed_projections as jax_strip
from repro_torch.configs import get_config
from repro_torch.models import (decode_chunk, decode_step, encode,
                                init_cache, init_params, merge_slots,
                                reset_slots, reset_slots_)
from repro_torch.models import attention, layers, moe
from repro_torch.models.decode import _sinusoidal_at
from repro_torch.models.inputs import (make_decode_token, make_train_batch,
                                       stub_frames)
from repro_torch.models.segments import decoder_layout
from repro_torch.models.transformer import _check_supported, _sinusoidal
from repro_torch.models.transformer import layer_slice
from repro_torch.obs import RecompileSentinel, encoder_per_call, per_call
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                init_stacked_serving,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

ARCH = "whisper-base"
FIELDS = ("w_blocks", "idx", "scales", "nblocks")
#: (chunk, prompt length): one-token chunks, whole chunks, ragged tails
CHUNK_CASES = [(1, 3), (4, 8), (4, 11)]


def _close(got, ref, what="", atol=None):
    """1e-4 * max(|ref|, 1) unless ``atol`` is given: fp32 on both sides,
    sums in another order."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    tol = atol if atol is not None else \
        1e-4 * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _ints(a):
    """A tensor or array as numpy, bf16 as its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _flat(tree, path=""):
    """{'/'-joined path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _spec(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _flat(tree).items()}


def _cache_close(cache, jcache, what=""):
    """Every leaf of the port's cache against the JAX cache's, same paths."""
    mine, ref = _flat(cache), _flat(jcache)
    assert set(mine) == set(ref), (set(mine) ^ set(ref))
    for path, leaf in ref.items():
        if path.endswith("pos"):
            np.testing.assert_array_equal(mine[path].numpy(),
                                          np.asarray(leaf))
        else:
            _close(mine[path], leaf, f"{what} {path}")


def _cfgs(mode="joint", **kw):
    jcfg = jax_get_config(ARCH, reduced=True, dbpim_mode=mode).scaled(
        dtype="float32", dbpim_value_sparsity=0.5, **kw)
    cfg = get_config(ARCH, reduced=True, dbpim_mode=mode).scaled(
        dtype="float32", dbpim_value_sparsity=0.5, **kw)
    return jcfg, cfg


def _to_port(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def model():
    """JAX params of reduced fp32 whisper, the same params in the port,
    both packs of joint tables (32-wide tiles), and the encoder's output
    of 3 rows of frames from a seed (JAX's, and the port's)."""
    jcfg, cfg = _cfgs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = _to_port(jparams)
    frames = jax_train_batch(jcfg, 3, 4, seed=5)["frames"]
    jenc = jax_encode(jparams, frames, jcfg)
    enc = encode(params, torch.from_numpy(np.asarray(frames)), cfg)
    return (jcfg, jparams, jax_tables(jparams, jcfg, bk=32, bn=32), jenc,
            cfg, params, build_stacked_tables(params, cfg, bk=32, bn=32),
            enc)


# ------------------------------------------- inputs, positions, layers ---

def test_inputs_match_jax():
    """make_train_batch and make_decode_token draw what the JAX functions
    draw from the same seed: tokens, labels and whisper's bf16 frames bit
    for bit (full width: 1,500 frames of 512)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    ref = jax_train_batch(jcfg, 2, 6, seed=4)
    got = make_train_batch(cfg, 2, 6, seed=4, device="cpu")
    assert set(got) == set(ref) == {"tokens", "labels", "frames"}
    assert got["frames"].shape == (2, 1500, 512)
    assert got["frames"].dtype == torch.bfloat16
    for key in ref:
        np.testing.assert_array_equal(_ints(got[key]), _ints(ref[key]), key)
    np.testing.assert_array_equal(
        make_decode_token(cfg, 3, seed=2, device="cpu").numpy(),
        np.asarray(jax_decode_token(jcfg, 3, seed=2)))


@pytest.mark.parametrize("batch,seed", [(4, 0), (2, 7)])
def test_stub_frames_are_the_reference_serve_draw(batch, seed):
    """stub_frames draws the reference serve CLI's encoder input: the
    first normal(0, 1) draw of default_rng(seed) cast to bf16 by jnp, bit
    for bit (full width: 1,500 frames of 512)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    ref = jnp.asarray(np.random.default_rng(seed).normal(
        0, 1, (batch, jcfg.encoder_seq, jcfg.d_model)), jnp.bfloat16)
    got = stub_frames(cfg, batch, seed, device="cpu")
    assert got.shape == (batch, 1500, 512) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_ints(got), _ints(ref))


def test_sinusoidal_positions_match_jax():
    """_sinusoidal (the encoder's table) and _sinusoidal_at (decode and
    chunk positions) against the JAX functions within 1e-6; a position's
    row is bitwise the same whether it sits in a chunk or alone."""
    _close(_sinusoidal(1500, 512, torch.float32),
           jax_sinusoidal(1500, 512, jnp.float32), atol=1e-6)
    pos = np.array([[0, 1, 2, 3], [7, 8, 9, 10], [443, 444, 445, 446]],
                   np.int32)
    got = _sinusoidal_at(torch.from_numpy(pos), 512)
    _close(got, jax_sinusoidal_at(jnp.asarray(pos), 512), atol=1e-5)
    for t in range(4):
        assert torch.equal(_sinusoidal_at(torch.from_numpy(pos[:, t:t + 1]),
                                          512), got[:, t:t + 1])


@pytest.mark.parametrize("where", ["mlp", "moe"])
def test_gelu_mlp_matches_jax(where):
    """The plain gelu MLP (w_up, w_down; no w_gate), and gelu experts,
    against the JAX functions; init_mlp makes no w_gate for it."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    if where == "mlp":
        jp = jax_layers.init_mlp(jcfg, jax.random.PRNGKey(1), 64, 128)
        p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
        assert set(p) == set(layers.init_mlp(cfg, None, 64, 128, "meta")) \
            == {"w_up", "w_down"}
        _close(layers.apply_mlp(p, torch.from_numpy(x), cfg),
               jax_layers.apply_mlp(jp, jnp.asarray(x), jcfg))
        return
    jcfg = jcfg.scaled(n_experts=4, top_k=2)
    cfg = cfg.scaled(n_experts=4, top_k=2)
    jp = jax_moe.init_moe(jcfg, jax.random.PRNGKey(2))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(p) == {"router", "w_up", "w_down"}
    ref, _ = jax_moe.apply_moe(jp, jnp.asarray(x), jcfg)
    got, _ = moe.apply_moe(p, torch.from_numpy(x), cfg)
    _close(got, ref)


def test_check_supported_accepts_every_layout_but_the_vision_stub():
    """Hybrid stacks, enc-dec and the gelu MLP are served, and since the
    full-sequence forward's slice so is pixtral's vision stub (its patch
    embeddings enter through forward; decode serves it text-only): every
    config's decoder layout comes back."""
    for arch in (ARCH, "jamba-v0.1-52b", "mamba2-1.3b", "arctic-480b",
                 "pixtral-12b"):
        cfg = get_config(arch, reduced=True)
        assert _check_supported(cfg) == decoder_layout(cfg)
    _check_supported(get_config("tinyllama-1.1b").scaled(mlp_type="gelu"))


# ------------------------------------------------- params and packs ------

def test_param_tree_matches_jax():
    """The port's whisper tree (decoder with norm_x and xattn, enc_blocks,
    enc_final_norm; LayerNorm scale and bias float32) equals JAX
    init_params' in paths, shapes and dtypes: reduced and at full width
    (the meta device against eval_shape); the weight bridge carries every
    leaf bit for bit, keeping its dtype."""
    jcfg, cfg = jax_get_config(ARCH, reduced=True), get_config(ARCH,
                                                               reduced=True)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    spec = _spec(init_params(cfg, device="cpu"))
    assert spec == _spec(jp)
    assert spec["/blocks/xattn/wk"] == ((2, 64, 64), "bfloat16")
    assert spec["/enc_blocks/norm1/bias"] == ((2, 64), "float32")
    full = jax.eval_shape(lambda k: jax_init_params(jax_get_config(ARCH), k),
                          jax.random.PRNGKey(0))
    assert _spec(init_params(get_config(ARCH), device="meta")) == \
        _spec(full)
    bridged, ref = _flat(_to_port(jp)), _flat(jp)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(_ints(bridged[path]), _ints(leaf),
                                      err_msg=path)


@pytest.mark.parametrize("bk", [None, 32], ids=["default_tiles", "tiles32"])
def test_packs_byte_identical_and_strip_exact_paths(bk):
    """The decoder's tables (self-attention, xattn/wq..wo, w_up, w_down)
    against the JAX package's byte for byte; strip_packed_projections
    strips exactly the paths the JAX function strips: the decoder's
    cross-attention copies, never the dense encoder's identically-suffixed
    weights; the slice-by-slice build equals the whole-tree build."""
    jcfg, cfg = _cfgs()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = _to_port(jparams)
    jt = jax_tables(jparams, jcfg, bk=bk, bn=bk)
    t = build_stacked_tables(params, cfg, bk=bk, bn=bk)
    assert t.static == jt.static
    assert set(t.arrays) == set(jt.arrays) == {
        "wq", "wk", "wv", "wo", "xattn/wq", "xattn/wk", "xattn/wv",
        "xattn/wo", "w_up", "w_down"}
    for name, ref in jt.arrays.items():
        for field in FIELDS:
            np.testing.assert_array_equal(_ints(t.arrays[name][field]),
                                          _ints(ref[field]),
                                          err_msg=f"{name} {field}")
    stripped = strip_packed_projections(params, cfg)
    assert _spec(stripped) == _spec(jax_strip(jparams, jcfg))
    flat = _flat(stripped)
    assert flat["/blocks/xattn/wk"].shape == (2, 1, 1)
    assert torch.equal(flat["/enc_blocks/attn/wk"],
                       params["enc_blocks"]["attn"]["wk"])
    sp, st = init_stacked_serving(cfg, seed=2, device="cpu")
    whole = init_params(cfg, seed=2, device="cpu")
    wt = build_stacked_tables(whole, cfg)
    for path, leaf in _flat(strip_packed_projections(whole, cfg)).items():
        assert torch.equal(_flat(sp)[path], leaf), path
    for name, arr in wt.arrays.items():
        for field in FIELDS:
            assert torch.equal(arr[field], st.arrays[name][field])


# ------------------------------------------ encoder, cross-attention -----

def test_encode_matches_jax(model):
    """The encoder (sinusoidal positions, LayerNorm, non-causal attention
    over every frame, the gelu MLP, the final norm) against JAX encode
    within 1e-4 * max(|ref|, 1); the encoder runs no joint kernel and its
    launches per call are 0 joint / L attention / 2L + 1 norm."""
    jenc, enc = model[3], model[7]
    assert enc.shape == (3, 32, 64)
    _close(enc, jenc, "encode")
    assert encoder_per_call(get_config(ARCH)) == {
        "joint_sparse_matmul": 0, "row_attention": 6, "row_norm": 13}


@pytest.mark.parametrize("tables", ["dense", "joint"])
def test_cross_attention_matches_jax(model, tables):
    """cross_attention of layer 0 (wq on x, wk and wv on enc_out at every
    call) against the JAX function, plain and through the joint tables'
    hook; the encoder's non-causal attention and the full-sequence causal
    attention too."""
    jcfg, jparams, jt, jenc, cfg, params, t, enc = model
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])
    p = layer_slice(params["blocks"], 0)
    jfn = fn = None
    if tables == "joint":
        seg, jseg = t.segments["blocks"], jt.segments["blocks"]
        jfn = jseg.dense_fn(jax.tree_util.tree_map(lambda a: a[0],
                                                   jseg.arrays))
        fn = seg.dense_fn(layer_slice(seg.arrays, 0))
    x = np.random.default_rng(6).standard_normal((3, 5, 64)).astype(
        np.float32)
    ref = jax_attention.cross_attention(jp["xattn"], jnp.asarray(x), jenc,
                                        jcfg, dense_fn=jfn)
    got = attention.cross_attention(p["xattn"], torch.from_numpy(x), enc,
                                    cfg, dense_fn=fn)
    _close(got, ref, "cross_attention")
    zeros = jnp.zeros((3, 5), jnp.int32)
    ref = jax_attention.attention(jp["attn"], jnp.asarray(x), jcfg, zeros,
                                  causal=False)
    got = attention.attention(p["attn"], torch.from_numpy(x), cfg,
                              torch.zeros((3, 5), dtype=torch.int32),
                              causal=False)
    _close(got, ref, "non-causal attention")
    # causal attention (the full-sequence forward's) no longer raises
    pos = jnp.broadcast_to(jnp.arange(5, dtype=jnp.int32), (3, 5))
    ref = jax_attention.attention(jp["attn"], jnp.asarray(x), jcfg, pos)
    got = attention.attention(p["attn"], torch.from_numpy(x), cfg,
                              torch.from_numpy(np.asarray(pos)))
    _close(got, ref, "causal attention")


# ------------------------------------------------------ decode, chunks ---

@pytest.mark.parametrize("tables", ["dense", "joint"])
def test_decode_step_matches_jax(model, tables):
    """Three steps from a fresh cache holding enc_out (scalar pos), then a
    step at per-slot positions: the logits and every cache leaf (k/v rows,
    "pos", "enc_out") at tolerance every step."""
    jcfg, jparams, jt, jenc, cfg, params, t, enc = model
    if tables == "dense":
        jt = t = None
    B = 3
    rng = np.random.default_rng(0)
    jcache = jax_init_cache(jcfg, B, 16, enc_out=jenc)
    cache = init_cache(cfg, B, 16, device="cpu", enc_out=enc)
    assert set(cache) == set(jcache) == {"pos", "attn", "enc_out"}
    for step in range(4):
        if step == 3:
            pos = np.array([3, 7, 5], np.int32)
            jcache["pos"] = jnp.asarray(pos)
            cache["pos"] = torch.from_numpy(pos)
        tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jax_decode_step(jparams, jcache, jnp.asarray(tok), jcfg,
                                     tables=jt)
        lg, cache = decode_step(params, cache, torch.from_numpy(tok), cfg,
                                tables=t)
        _close(lg, jl, f"logits step {step}")
        _cache_close(cache, jcache, f"step {step}")
        assert cache["enc_out"] is enc


def _port_run(cfg, params, t, enc, prompts, chunk=None, max_len=16):
    """Prompts through stepwise decode_step calls (``chunk`` None) or
    decode_chunk calls with ragged tails, on a fresh cache."""
    B, P = prompts.shape
    cache = init_cache(cfg, B, max_len, device="cpu", enc_out=enc)
    cache["pos"] = torch.zeros((B,), dtype=torch.int32)
    if chunk is None:
        for i in range(P):
            lg, cache = decode_step(params, cache,
                                    torch.from_numpy(prompts[:, i:i + 1]),
                                    cfg, tables=t)
        return lg, cache
    for s in range(0, P, chunk):
        n = min(chunk, P - s)
        toks = np.zeros((B, chunk), np.int32)
        toks[:, :n] = prompts[:, s:s + n]
        lg, cache = decode_chunk(params, cache, torch.from_numpy(toks),
                                 torch.full((B,), n, dtype=torch.int32), cfg,
                                 tables=t)
    return lg, cache


def _jax_chunked(jcfg, jparams, jt, jenc, prompts, chunk, max_len=16):
    from repro.models import decode_chunk as jax_decode_chunk
    B, P = prompts.shape
    cache = jax_init_cache(jcfg, B, max_len, enc_out=jenc)
    cache["pos"] = jnp.zeros((B,), jnp.int32)
    for s in range(0, P, chunk):
        n = min(chunk, P - s)
        toks = np.zeros((B, chunk), np.int32)
        toks[:, :n] = prompts[:, s:s + n]
        lg, cache = jax_decode_chunk(jparams, cache, jnp.asarray(toks),
                                     jnp.full((B,), n, jnp.int32), jcfg,
                                     tables=jt)
    return lg, cache


@pytest.mark.parametrize("chunk,plen", CHUNK_CASES)
def test_chunk_matches_jax_and_stepwise(model, chunk, plen):
    """decode_chunk (joint tables) against JAX decode_chunk: logits and
    every cache leaf within 1e-4 * max(|ref|, 1); against the port's own
    stepwise decode within 1e-6 * max(|ref|, 1) on the CPU (PyTorch's CPU
    matmuls block their K-sums by the row count, ROADMAP Queue 3 item 4;
    one-token chunks bitwise; the card holds every chunk bitwise)."""
    jcfg, jparams, jt, jenc, cfg, params, t, enc = model
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (3, plen)).astype(np.int32)
    jl, jcache = _jax_chunked(jcfg, jparams, jt, jenc, prompts, chunk)
    cl, ccache = _port_run(cfg, params, t, enc, prompts, chunk)
    _close(cl, jl, "port chunk vs JAX chunk")
    _cache_close(ccache, jcache, "port chunk vs JAX chunk")
    sl, scache = _port_run(cfg, params, t, enc, prompts)
    for what, got, ref in [("logits", cl, sl)] + [
            (p, _flat(ccache)[p], leaf) for p, leaf in _flat(scache).items()]:
        if chunk == 1 or what.endswith("pos") or what == "/enc_out":
            assert torch.equal(got, ref), what
        else:
            _close(got, ref.numpy(), what,
                   atol=1e-6 * max(ref.abs().max().item(), 1.0))


def test_slot_surgery_leaves_enc_out_untouched(model):
    """merge_slots, reset_slots and reset_slots_ select and zero the k/v
    rows and positions of their slots and pass "enc_out" through: the
    same tensor, bit for bit."""
    _, _, _, _, cfg, params, t, enc = model
    prompts = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 5)).astype(np.int32)
    _, cache = _port_run(cfg, params, t, enc, prompts)
    keep = torch.tensor([True, False, True])
    fresh = init_cache(cfg, 3, 16, device="cpu", enc_out=enc)
    merged = merge_slots(cache, fresh, keep, cfg)
    assert merged["enc_out"] is enc
    assert merged["pos"].tolist() == [5, 0, 5]
    before = enc.clone()
    mask = torch.tensor([False, True, False])
    r = reset_slots(cache, mask, cfg)
    assert r["enc_out"] is enc and r["pos"].tolist() == [5, 0, 5]
    r = reset_slots_(cache, mask, cfg)
    assert r["enc_out"] is enc and torch.equal(enc, before)
    assert r["attn"]["k"][:, 1].abs().sum() == 0
    assert r["attn"]["k"][:, 0].abs().sum() > 0


def test_compiled_step_holds_enc_out_by_identity(model):
    """The compiled decode step takes the cache's enc_out as a leaf held
    where it lies: calls on the same cache share one signature (and leave
    enc_out's bits as they were); a cache holding another encoder output,
    equal in value, is a new signature for the sentinel."""
    from repro_torch.launch.steps import build_step, compile_step
    _, _, _, _, cfg, params, t, enc = model
    step = compile_step(build_step(cfg, "decode", stacked_tables=t),
                        buffer_argnums=(0, 1))
    cache = init_cache(cfg, 3, 16, device="cpu", enc_out=enc)
    cache["pos"] = torch.zeros((3,), dtype=torch.int32)
    cache["attn"]["pos"] = torch.zeros((3,), dtype=torch.int32)
    before = enc.clone()
    tok = torch.ones((3, 1), dtype=torch.int32)
    active = torch.ones((3,), dtype=torch.bool)
    for _ in range(2):
        step(params, cache, tok, active)
    assert step._cache_size() == 1 and torch.equal(enc, before)
    cache["enc_out"] = enc.clone()
    step(params, cache, tok, active)
    assert step._cache_size() == 2


# --------------------------------------------------------- the engine ---

def test_engine_streams_equal_jax_stepwise(model):
    """The engine on reduced fp32 joint tables with enc_out (one row per
    slot, kept across the requests each slot serves): every greedy stream
    equals JAX stepwise decode's, each request in the batch row of the
    slot it ran in; chunks tagged prefill_chunk_exact, one signature per
    step; without enc_out the engine refuses an enc-dec config."""
    jcfg, jparams, jt, jenc, cfg, params, t, enc = model
    spec = WorkloadSpec(n_requests=5, arrival_rate=0.7, prompt_len=(3, 12),
                        gen_len=(4, 8), seed=3)
    trace = make_trace(spec, cfg.vocab_size)
    engine = ServeEngine(cfg, strip_packed_projections(params, cfg),
                         n_slots=3, max_len=24, prefill_chunk=4,
                         stacked_tables=t, enc_out=enc, device="cpu")
    outputs = engine.run(trace)
    assert engine.prefill_kind == "prefill_chunk_exact"
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(k, cfg.name): 1
        for k in ("decode", "prefill_chunk_exact", "reset")}
    assert engine.cache["enc_out"] is enc
    slot_of = {iv.rid: iv.slot for iv in engine.slot_log}
    for slot in range(3):
        rows = [r for r in trace if slot_of[r.rid] == slot]
        ref = _jax_greedy_streams_enc(jcfg, jparams, jt, jenc[slot:slot + 1],
                                      rows, 24)
        for r in rows:
            assert outputs[r.rid] == ref[r.rid], r.rid
    with pytest.raises(ValueError, match="enc_out"):
        ServeEngine(cfg, params, n_slots=3, device="cpu")


def _jax_greedy_streams_enc(jcfg, jparams, jt, jenc_row, trace, max_len):
    """Every request through JAX stepwise decode, one batch row each, all
    rows against the same encoder row."""
    step = jax.jit(lambda p, c, tok: jax_decode_step(p, c, tok, jcfg,
                                                     tables=jt))
    B = len(trace)
    cache = jax_init_cache(jcfg, B, max_len,
                           enc_out=jnp.repeat(jenc_row, B, axis=0))
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


def test_serve_cli_on_the_cpu(capsys):
    """The serve CLI encodes the frames once and serves reduced whisper on
    the CPU (chunks tagged prefill_chunk_exact), printing the encoder's
    time apart; without --device cpu and with no card it raises."""
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--reduced", "--dbpim-mode", "joint",
            "--device", "cpu", "--requests", "3", "--max-len", "24",
            "--gen-len", "3", "--prompt-len", "2", "9",
            "--prefill-chunk", "4"]
    out = serve.main(argv)
    assert len(out) == 3 and all(len(v) == 3 for v in out.values())
    text = capsys.readouterr().out
    assert "[serve] encoder: (4, 32, 64) frames in" in text
    assert "3/3 requests" in text
    assert "prefill_chunk_exact@whisper-smoke=1" in text
    assert per_call(get_config(ARCH)) == {
        "joint_sparse_matmul": 60, "row_attention": 12, "row_norm": 19}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(argv[:5])


# ------------------------------------------------------- on the card -----

@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("K,N", [(512, 512), (512, 2048), (2048, 512)])
def test_joint_kernel_at_whisper_shapes_on_card(cuda, K, N):
    """The joint kernel at whisper's projections, M in {4, 64, 6000} (6000
    = 4 slots x 1500 encoder rows: xattn/wk and wv every decode step):
    bf16 within one bf16 ulp of max|ref| of the plain version, the rows of
    M = 4 bitwise equal to the same rows of the others."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((1, K, N), generator=gen) * K ** -0.5).to(cuda)
    p = ops.slice_joint_stacked(ops.pack_joint_sparse_stacked(
        w, value_sparsity=0.6, bk=128, bn=128), 0)
    x = torch.randn((6000, K), generator=gen).to(torch.bfloat16).to(cuda)
    head = None
    for M in (4, 64, 6000):
        y = jsm.joint_sparse_matmul(x[:M].contiguous(), p.w_blocks, p.idx,
                                    p.scales)
        ref = jsm.joint_sparse_matmul_plain(x[:M], p.w_blocks, p.idx,
                                            p.scales)
        peak = ref.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert (y.float() - ref.float()).abs().max().item() <= ulp, M
        head = y[:4] if head is None else head
        assert torch.equal(head, y[:4]), M


@pytest.mark.parametrize("Sq", [1500, 1, 64], ids=["encoder", "cross_decode",
                                                   "cross_chunk"])
def test_row_attention_non_causal_on_card(cuda, Sq):
    """row_attention with every query at the last of 1,500 keys (the
    all-ones mask), hd 64, 8 heads, group 1, batch 4: the encoder's 1,500
    queries and cross-attention's 1 and 64 queries a slot, within 2^-6 x
    max|ref| of the plain version; a query alone bitwise equal to the
    same query in the call."""
    from repro_torch.kernels import row_attention as rak
    gen = torch.Generator().manual_seed(2)
    bf16 = torch.bfloat16
    B, A, H, hd = 4, 1500, 8, 64
    k = torch.randn((B, A, H, hd), generator=gen).to(bf16).to(cuda)
    v = torch.randn((B, A, H, hd), generator=gen).to(bf16).to(cuda)
    q = torch.randn((B, Sq, H, hd), generator=gen).to(bf16).to(cuda)
    qpos = torch.full((B, Sq), A - 1, dtype=torch.int32, device=cuda)
    y = rak.row_attention(q, k, v, qpos)
    ref = rak.row_attention_plain(q, k, v, qpos)
    peak = ref.float().abs().max().item()
    assert (y.float() - ref.float()).abs().max().item() <= 2 ** -6 * peak
    t = Sq - 1
    one = rak.row_attention(q[:, t:t + 1].contiguous(), k, v,
                            qpos[:, t:t + 1].contiguous())
    assert torch.equal(one, y[:, t:t + 1])


@pytest.mark.parametrize("Sq", [1, 64], ids=["decode", "chunk"])
def test_row_attention_at_whisper_self_attention_on_card(cuda, Sq):
    """row_attention at whisper's decoder self-attention: hd 64, 8 heads,
    group 1, batch 4, a 448-slot cache, a decode call and a 64-query
    chunk at causal positions inside the cache, within 2^-6 x max|ref| of
    the plain version; a query alone bitwise equal to the same query in
    the call."""
    from repro_torch.kernels import row_attention as rak
    gen = torch.Generator().manual_seed(4)
    bf16 = torch.bfloat16
    B, A, H, hd = 4, 448, 8, 64
    k = torch.randn((B, A, H, hd), generator=gen).to(bf16).to(cuda)
    v = torch.randn((B, A, H, hd), generator=gen).to(bf16).to(cuda)
    q = torch.randn((B, Sq, H, hd), generator=gen).to(bf16).to(cuda)
    start = torch.tensor([40, 120, 200, 380], dtype=torch.int32)
    qpos = (start[:, None] + torch.arange(Sq, dtype=torch.int32)[None]
            ).to(cuda)
    y = rak.row_attention(q, k, v, qpos)
    ref = rak.row_attention_plain(q, k, v, qpos)
    peak = ref.float().abs().max().item()
    assert (y.float() - ref.float()).abs().max().item() <= 2 ** -6 * peak
    t = Sq - 1
    one = rak.row_attention(q[:, t:t + 1].contiguous(), k, v,
                            qpos[:, t:t + 1].contiguous())
    assert torch.equal(one, y[:, t:t + 1])


def test_row_norm_layernorm_at_whisper_width_on_card(cuda):
    """row_norm as LayerNorm with a bias at d = 512, 4, 256 and 6,000 rows:
    within one bf16 ulp of max|ref|, the rows of 4 bitwise equal to the
    same rows of the others."""
    from repro_torch.kernels import row_norm as rnk
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((6000, 512), generator=gen).to(torch.bfloat16).to(cuda)
    scale = (1 + 0.1 * torch.randn((512,), generator=gen)).to(cuda)
    bias = (0.1 * torch.randn((512,), generator=gen)).to(cuda)
    head = None
    for R in (4, 256, 6000):
        y = rnk.row_norm(x[:R].contiguous(), scale, bias)
        ref = rnk.row_norm_plain(x[:R], scale, bias)
        peak = ref.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert (y.float() - ref.float()).abs().max().item() <= ulp, R
        head = y[:4] if head is None else head
        assert torch.equal(head, y[:4]), R
