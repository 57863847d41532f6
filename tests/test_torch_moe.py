"""The port's MoE family (mixtral, arctic) against the JAX package on
reduced configs: grouped packs byte for byte, capacity, apply_moe in its
three groupings with and without the expert hook, the param tree and
the stacked tables, decode through the sliding-window ring (mixtral,
past two wraps), arctic's chunks, the serving-capability gates, the
engine's fallback to stepwise prefill, and the slice-by-slice build
against the whole-stack build. Card tests hold the expert hook against
its plain version.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_moe.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import decode_chunk as jax_decode_chunk
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro.sparsity.sparse_linear import build_stacked_tables as jax_tables
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import (decode_chunk, decode_chunk_, decode_step,
                                decode_step_, init_cache, init_params,
                                merge_slots, reset_slots, reset_slots_)
from repro_torch.models import attention, moe
from repro_torch.models.transformer import layer_slice
from repro_torch.obs import RecompileSentinel, per_call
from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                init_stacked_serving,
                                                reconstruct_stacked_params,
                                                strip_packed_projections)
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

ARCHS = ["mixtral-8x7b", "arctic-480b"]
FIELDS = ("w_blocks", "idx", "scales", "nblocks")


def _close(got, ref, what=""):
    """1e-4 * max(|ref|, 1): fp32 on both sides, sums in another order."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    tol = 1e-4 * max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol, err_msg=what)


def _ints(a):
    """A tensor or array as numpy, bf16 as its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_pack(mine, ref, what=""):
    for field in FIELDS:
        a = mine[field] if isinstance(mine, dict) else getattr(mine, field)
        b = ref[field] if isinstance(ref, dict) else getattr(ref, field)
        np.testing.assert_array_equal(_ints(a), _ints(b),
                                      err_msg=f"{what} {field}")


def _cfgs(arch, mode="joint", **kw):
    jcfg = jax_get_config(arch, reduced=True, dbpim_mode=mode).scaled(
        dtype="float32", dbpim_value_sparsity=0.5, **kw)
    cfg = get_config(arch, reduced=True, dbpim_mode=mode).scaled(
        dtype="float32", dbpim_value_sparsity=0.5, **kw)
    return jcfg, cfg


def _to_port(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """JAX params of the reduced fp32 config, the same params in the port,
    and both packs of joint tables (32-wide tiles)."""
    jcfg, cfg = _cfgs(request.param)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = _to_port(jparams)
    return (jcfg, jparams, jax_tables(jparams, jcfg, bk=32, bn=32), cfg,
            params, build_stacked_tables(params, cfg, bk=32, bn=32))


# ----------------------------------------------------- the grouped pack ---

@pytest.mark.parametrize("payload", ["int8", "bf16"])
@pytest.mark.parametrize("vs", [0.0, 0.6])
@pytest.mark.parametrize("K,N", [(256, 256), (200, 100)])
def test_grouped_pack_byte_identical_and_round_trip(K, N, vs, payload):
    """pack_joint_sparse_grouped against the JAX pack byte for byte
    (ragged tiles included); unpack, and each (layer, expert) slice,
    equal the reference's; balanced pruning leaves no padded slot."""
    rng = np.random.default_rng(0)
    L, E, bk, bn = 2, 3, 32, 32
    ws = rng.laplace(0, 0.02, (L, E, K, N)).astype(np.float32)
    kw = dict(value_sparsity=vs or None, bk=bk, bn=bn, payload=payload)
    ref = jops.pack_joint_sparse_grouped(ws, **kw)
    p = ops.pack_joint_sparse_grouped(torch.from_numpy(ws), **kw)
    _same_pack(p, ref)
    assert (p.k, p.n, p.k_pad, p.maxb) == (ref.k, ref.n, ref.k_pad,
                                           ref.maxb)
    dense = ops.unpack_joint_sparse_grouped(p)
    assert dense.shape == (L, E, K, N) and dense.dtype == torch.float32
    np.testing.assert_array_equal(dense.numpy(),
                                  jops.unpack_joint_sparse_grouped(ref))
    for l in range(L):
        for e in range(E):
            _same_pack(ops.slice_joint_grouped(p, l, e),
                       jops.slice_joint_grouped(ref, l, e), f"({l}, {e})")
    if vs:
        assert (p.nblocks == p.maxb).all()
        assert p.maxb == ops.balanced_maxb(K, vs, bk)
    assert ops.joint_storage_bytes(p) == jops.joint_storage_bytes(ref)


@pytest.mark.parametrize("payload", ["int8", "bf16"])
def test_grouped_pack_ragged_masks_share_maxb(payload):
    """Explicit ragged masks: MAXB is the most survivors of any (layer,
    expert); short members pad with zero-payload slots; byte for byte the
    JAX pack."""
    rng = np.random.default_rng(1)
    L, E, K, N, bk = 2, 2, 128, 64, 32
    masks = np.ones((L, E, K, N), np.int32)
    masks[0, 0, bk:] = 0                  # (0, 0) keeps 1 of 4 K-blocks
    masks[0, 1, 2 * bk:] = 0              # (0, 1) keeps 2
    ws = rng.laplace(0, 0.02, (L, E, K, N)).astype(np.float32)
    ref = jops.pack_joint_sparse_grouped(ws, masks, bk=bk, bn=32,
                                         payload=payload)
    p = ops.pack_joint_sparse_grouped(torch.from_numpy(ws),
                                      torch.from_numpy(masks), bk=bk, bn=32,
                                      payload=payload)
    _same_pack(p, ref)
    assert p.maxb == 4
    assert p.nblocks[0, 0].max() == 1 and p.nblocks[0, 1].max() == 2
    for l in range(L):
        for e in range(E):
            for n_t in range(p.w_blocks.shape[2]):
                assert not p.w_blocks[l, e, n_t, p.nblocks[l, e, n_t]:].any()
    np.testing.assert_array_equal(ops.unpack_joint_sparse_grouped(p).numpy(),
                                  jops.unpack_joint_sparse_grouped(ref))


@pytest.mark.parametrize("payload", ["int8", "bf16"])
def test_slices_pack_in_column_blocks(monkeypatch, payload):
    """A slice packed in blocks of N tiles (``PACK_BLOCK_ELEMS`` small: 3
    tiles a block, the last block ragged) equals the JAX stacked pack byte
    for byte."""
    rng = np.random.default_rng(5)
    L, K, N, bk, bn = 2, 96, 300, 32, 40
    ws = rng.laplace(0, 0.02, (L, K, N)).astype(np.float32)
    monkeypatch.setattr(ops, "PACK_BLOCK_ELEMS", 3 * K * bn)
    for vs in (None, 0.6):
        kw = dict(value_sparsity=vs, bk=bk, bn=bn, payload=payload)
        _same_pack(ops.pack_joint_sparse_stacked(torch.from_numpy(ws), **kw),
                   jops.pack_joint_sparse_stacked(ws, **kw), f"vs={vs}")


def test_grouped_pack_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ops.pack_joint_sparse_grouped(torch.zeros((2, 4, 4)),
                                      value_sparsity=0.5)


# ------------------------------------------------------------- routing ---

@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    cfg = get_config(arch, reduced=True)
    full = get_config(arch)
    jcfg, jfull = jax_get_config(arch, reduced=True), jax_get_config(arch)
    for n in (1, 2, 3, 4, 5, 8, 16, 33, 64, 100, 256, 1000):
        assert moe.capacity(cfg, n) == jax_moe.capacity(jcfg, n), n
        assert moe.capacity(full, n) == jax_moe.capacity(jfull, n), n


#: (per_position, B, S): the three groupings (per position for chunks;
#: per sequence from S = 64, with drops past capacity; one flat group)
GROUPINGS = {"per_position": (True, 3, 5), "per_sequence": (False, 2, 64),
             "flat": (False, 3, 5)}


@pytest.mark.parametrize("hook", [False, True], ids=["plain", "expert_hook"])
@pytest.mark.parametrize("grouping", list(GROUPINGS))
def test_apply_moe_block_matches_jax(model, grouping, hook):
    """apply_moe_block on layer 0 (arctic: with its dense residual MLP)
    against the JAX function: gate indices equal, output and aux within
    1e-4 * max(|ref|, 1); with the hook the experts run through the
    stacked tables' ``expert`` attribute."""
    jcfg, jparams, jt, cfg, params, t = model
    per_position, B, S = GROUPINGS[grouping]
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"])
    p = layer_slice(params["blocks"]["moe"], 0)
    jfn = fn = None
    if hook:
        jfn = jt.segments["blocks"].dense_fn(jax.tree_util.tree_map(
            lambda a: a[0], jt.segments["blocks"].arrays))
        fn = t.segments["blocks"].dense_fn(
            layer_slice(t.segments["blocks"].arrays, 0))
    # a shared direction skews the routing, so the per-sequence groups
    # overflow their capacity
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((B, S, cfg.d_model))
         + 2 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    ref, jaux = jax_moe.apply_moe_block(jp, jnp.asarray(x), jcfg,
                                        dense_fn=jfn,
                                        per_position=per_position)
    got, aux = moe.apply_moe_block(p, torch.from_numpy(x), cfg, dense_fn=fn,
                                   per_position=per_position)
    assert got.shape == (B, S, cfg.d_model)
    _close(got, ref, "moe output")
    for key in ("load_balance", "dropped_frac"):
        _close(aux[key], jaux[key], key)
    if grouping == "per_sequence":
        assert float(jaux["dropped_frac"]) > 0     # capacity drops happen
    # the gate indices of the groups, against the reference's routing
    xg = x.swapaxes(0, 1) if per_position else \
        x if S >= 64 else x.reshape(1, B * S, -1)
    probs = jax.nn.softmax(jnp.asarray(xg) @ jp["router"], axis=-1)
    jvals, jidx = jax.lax.top_k(probs, cfg.top_k)
    _, vals, idx = moe._route(torch.from_numpy(np.ascontiguousarray(xg)),
                              p["router"], cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(vals, np.asarray(jvals) / np.asarray(jvals).sum(-1,
                                                           keepdims=True))


# --------------------------------------------------- params and tables ---

def _tree_spec(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_spec(v, f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_weight_bridge_match_jax(arch):
    """The port's MoE tree (bf16 config) equals JAX init_params' in keys,
    shapes and dtypes, reduced and at full width (meta device against
    eval_shape); the JAX tree crosses bit for bit: router float32, expert
    stacks bf16."""
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(
        arch, reduced=True)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    assert _tree_spec(init_params(cfg, device="cpu")) == _tree_spec(jp)
    full = jax.eval_shape(lambda k: jax_init_params(jax_get_config(arch), k),
                          jax.random.PRNGKey(0))
    meta = init_params(get_config(arch), device="meta")
    assert _tree_spec(meta) == _tree_spec(full)
    p = _to_port(jp)
    for name in ("router", "w_gate", "w_up", "w_down"):
        mine, ref = p["blocks"]["moe"][name], jp["blocks"]["moe"][name]
        assert mine.dtype == (torch.float32 if name == "router"
                              else torch.bfloat16)
        np.testing.assert_array_equal(_ints(mine), _ints(ref))
    # the draws: expert stacks at the JAX scales
    tp = init_params(cfg, device="cpu")["blocks"]["moe"]
    for name, scale in (("w_gate", cfg.d_model ** -0.5),
                        ("w_down", cfg.d_ff ** -0.5),
                        ("router", cfg.d_model ** -0.5)):
        std = tp[name].float().std().item()
        assert 0.8 * scale < std < 1.2 * scale, (name, std, scale)


@pytest.mark.parametrize("mode", ["joint", "value", "bit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_tables_byte_identical(arch, mode):
    """Every segment's tables (grouped expert packs included) against the
    JAX package's, byte for byte, default and 32-wide tiles."""
    jcfg, cfg = _cfgs(arch, mode)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = _to_port(jparams)
    for bk in (None, 32):
        jt = jax_tables(jparams, jcfg, bk=bk, bn=bk)
        t = build_stacked_tables(params, cfg, bk=bk, bn=bk)
        assert t.static == jt.static
        assert set(t.arrays) == set(jt.arrays)
        assert t.arrays["moe/w_gate"]["w_blocks"].ndim == 6
        for name in jt.arrays:
            _same_pack(t.arrays[name], jt.arrays[name], name)


def test_strip_and_reconstruct_grouped(model):
    """Stripped expert stacks are (L, 1, 1) placeholders, as the
    reference's; reconstruct unpacks the grouped tables like JAX's."""
    from repro.sparsity.sparse_linear import \
        reconstruct_stacked_params as jax_reconstruct
    from repro.sparsity.sparse_linear import \
        strip_packed_projections as jax_strip
    jcfg, jparams, jt, cfg, params, t = model
    assert _tree_spec(strip_packed_projections(params, cfg)) == \
        _tree_spec(jax_strip(jparams, jcfg))
    recon = reconstruct_stacked_params(params, t, cfg)
    jrecon = jax_reconstruct(jparams, jt, jcfg)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            recon["blocks"]["moe"][name].numpy(),
            np.asarray(jrecon["blocks"]["moe"][name]))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _same_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("mode", ["joint", "value", "bit", "dense"])
@pytest.mark.parametrize("arch", ARCHS + ["tinyllama-1.1b", "mamba2-1.3b"])
def test_slice_by_slice_build_equals_whole_stack_build(arch, mode):
    """init_stacked_serving (each expert slice packed as it is drawn; the
    serve CLI's build for every family) returns
    strip_packed_projections(init_params(...)) and
    build_stacked_tables(init_params(...)) byte for byte (bf16 config,
    default tiles and 32-wide ones)."""
    cfg = get_config(arch, reduced=True, dbpim_mode=mode)
    full = init_params(cfg, seed=5, device="cpu")
    for bk in (None, 32):
        params, tables = init_stacked_serving(cfg, seed=5, device="cpu",
                                              bk=bk, bn=bk)
        if mode == "dense":
            assert tables is None
            _same_trees(params, full)
            return
        ref = build_stacked_tables(full, cfg, bk=bk, bn=bk)
        _same_trees(params, strip_packed_projections(full, cfg))
        assert tables.static == ref.static
        assert set(tables.arrays) == set(ref.arrays)
        for name in ref.arrays:
            _same_pack(tables.arrays[name], ref.arrays[name], name)


# ----------------------------------------------- decode and the chunk ---

@pytest.mark.parametrize("tables", ["dense", "joint"])
def test_decode_step_matches_jax(model, tables):
    """Three steps from a fresh cache (scalar pos), then a step at
    per-slot positions: logits and caches at tolerance every step."""
    jcfg, jparams, jt, cfg, params, t = model
    if tables == "dense":
        jt = t = None
    B = 3
    rng = np.random.default_rng(0)
    jcache = jax_init_cache(jcfg, B, 16)
    cache = init_cache(cfg, B, 16, device="cpu")
    jstep = jax.jit(lambda p, c, tok: jax_decode_step(p, c, tok, jcfg,
                                                      tables=jt))
    for step in range(4):
        if step == 3:
            pos = np.array([3, 7, 5], np.int32)
            jcache["pos"] = jnp.asarray(pos)
            cache["pos"] = torch.from_numpy(pos)
        tok = rng.integers(1, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        lg, cache = decode_step(params, cache, torch.from_numpy(tok), cfg,
                                tables=t)
        _close(lg, jl, f"logits step {step}")
        for key in ("k", "v"):
            _close(cache["attn"][key], jcache["attn"][key], f"{key} {step}")


def test_mixtral_ring_wraps_match_jax():
    """Reduced mixtral (window 32) at max-len 48 decodes 72 positions, the
    ring past two wraps: the JAX step runs here (cache rows 32, logits (2,
    1, 256)); an 8-token prompt, then greedy tokens: streams equal, logits
    and the ring at tolerance every step."""
    jcfg, cfg = _cfgs("mixtral-8x7b")
    assert cfg.window == 32
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = _to_port(jparams)
    jt = jax_tables(jparams, jcfg, bk=32, bn=32)
    t = build_stacked_tables(params, cfg, bk=32, bn=32)
    step = jax.jit(lambda p, c, tok: jax_decode_step(p, c, tok, jcfg,
                                                     tables=jt))
    B, n_steps = 2, 72
    jcache = jax_init_cache(jcfg, B, 48)
    cache = init_cache(cfg, B, 48, device="cpu")
    assert jcache["attn"]["k"].shape[2] == cache["attn"]["k"].shape[2] == 32
    prompt = np.random.default_rng(3).integers(1, cfg.vocab_size, (B, 8))
    jtok = tok = prompt[:, :1].astype(np.int32)
    streams, jstreams = [], []
    for i in range(n_steps):
        jl, jcache = step(jparams, jcache, jnp.asarray(jtok))
        lg, cache = decode_step(params, cache, torch.from_numpy(tok), cfg,
                                tables=t)
        assert jl.shape == tuple(lg.shape) == (B, 1, cfg.vocab_size)
        _close(lg, jl, f"logits at position {i}")
        nxt = lg[:, 0].argmax(-1).numpy().astype(np.int32)[:, None]
        jnxt = np.asarray(jl[:, 0]).argmax(-1).astype(np.int32)[:, None]
        if i + 1 < prompt.shape[1]:
            tok = jtok = prompt[:, i + 1:i + 2].astype(np.int32)
        else:
            tok, jtok = nxt, jnxt
            streams.append(nxt[:, 0].tolist())
            jstreams.append(jnxt[:, 0].tolist())
    assert streams == jstreams
    assert int(cache["pos"]) == n_steps > 2 * 32
    for key in ("k", "v"):
        _close(cache["attn"][key], jcache["attn"][key], key)


def test_ring_inplace_steps_equal_functional():
    """decode_step_ on the ring (some slots inactive, positions past two
    wraps) leaves the cache bitwise as decode_step + merge_slots, with the
    active slots' logits equal; reset_slots_ equals reset_slots."""
    _, cfg = _cfgs("mixtral-8x7b")
    params = init_params(cfg, seed=1, device="cpu")
    t = build_stacked_tables(params, cfg, bk=32, bn=32)
    B = 3
    cache = _per_slot(init_cache(cfg, B, 48, device="cpu"), [5, 31, 66])
    cache["attn"]["k"].normal_(generator=torch.Generator().manual_seed(0))
    cache["attn"]["v"].normal_(generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(4)
    for i in range(40):
        tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, 1)))
        active = torch.from_numpy(rng.random(B) < 0.7)
        lg, new = decode_step(params, cache, tok, cfg, tables=t)
        ref = merge_slots(new, cache, active, cfg)
        lg_, cache = decode_step_(params, _clone(cache), tok, active, cfg,
                                  tables=t)
        _same_trees(cache, ref)
        assert torch.equal(lg_[active], lg[active]), i
    mask = torch.tensor([True, False, True])
    _same_trees(reset_slots_(_clone(cache), mask, cfg),
                reset_slots(cache, mask, cfg))


def _per_slot(cache, pos):
    """The cache with per-slot positions in every "pos" leaf, as the
    engine keeps them."""
    pos = torch.tensor(pos, dtype=torch.int32)
    cache["pos"] = pos
    cache["attn"]["pos"] = pos.clone()
    return cache


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def test_windowed_chunk_is_refused():
    """Sliding-window archs prefill stepwise: the chunk and the chunked
    attention raise, as in the reference."""
    _, cfg = _cfgs("mixtral-8x7b")
    params = init_params(cfg, device="cpu")
    cache = _per_slot(init_cache(cfg, 2, 16, device="cpu"), [0, 0])
    toks = torch.ones((2, 4), dtype=torch.int32)
    n = torch.full((2,), 4, dtype=torch.int32)
    for fn in (decode_chunk, decode_chunk_):
        with pytest.raises(ValueError, match="sliding-window"):
            fn(params, cache, toks, n, cfg)
    with pytest.raises(ValueError, match="sliding-window"):
        attention.prefill_attention(
            layer_slice(params["blocks"]["attn"], 0),
            torch.zeros((2, 4, cfg.d_model)), cache["attn"]["k"][0],
            cache["attn"]["v"][0], torch.zeros(2, dtype=torch.int32), n, cfg)


#: (chunk, prompt length): one token a chunk, ragged tails, one chunk
CHUNK_CASES = [(1, 5), (4, 11), (8, 8)]


def _port_stepwise(cfg, params, t, prompts, max_len=16):
    B = prompts.shape[0]
    cache = _per_slot(init_cache(cfg, B, max_len, device="cpu"), [0] * B)
    for i in range(prompts.shape[1]):
        lg, cache = decode_step(params, cache,
                                torch.from_numpy(prompts[:, i:i + 1]), cfg,
                                tables=t)
    return lg, cache


def _port_chunked(cfg, params, t, prompts, chunk, max_len=16, inplace=False):
    B, P = prompts.shape
    cache = _per_slot(init_cache(cfg, B, max_len, device="cpu"), [0] * B)
    fn = decode_chunk_ if inplace else decode_chunk
    for s in range(0, P, chunk):
        n = min(chunk, P - s)
        toks = np.zeros((B, chunk), np.int32)
        toks[:, :n] = prompts[:, s:s + n]
        lg, cache = fn(params, cache, torch.from_numpy(toks),
                       torch.full((B,), n, dtype=torch.int32), cfg, tables=t)
    return lg, cache


@pytest.mark.parametrize("chunk,plen", CHUNK_CASES)
def test_arctic_chunks_match_jax_and_stepwise(chunk, plen):
    """Arctic (no window, per-position capacity dispatch): decode_chunk
    with joint tables against JAX decode_chunk at tolerance; against the
    port's own stepwise decode within 1e-6 * max(|ref|, 1) on the CPU,
    whose matmuls may sum a chunk's rows in another order (bitwise on the
    card, where the kernels are row-stable: chip_smoke.py); the in-place
    chunk bitwise the functional one."""
    jcfg, cfg = _cfgs("arctic-480b")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = _to_port(jparams)
    jt = jax_tables(jparams, jcfg, bk=32, bn=32)
    t = build_stacked_tables(params, cfg, bk=32, bn=32)
    prompts = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (3, plen)).astype(np.int32)
    jchunk = jax.jit(lambda p, c, tok, n: jax_decode_chunk(
        p, c, tok, n, jcfg, tables=jt))
    jcache = jax_init_cache(jcfg, 3, 16)
    jcache["pos"] = jnp.zeros((3,), jnp.int32)
    for s in range(0, plen, chunk):
        n = min(chunk, plen - s)
        toks = np.zeros((3, chunk), np.int32)
        toks[:, :n] = prompts[:, s:s + n]
        jl, jcache = jchunk(jparams, jcache, jnp.asarray(toks),
                            jnp.full((3,), n, jnp.int32))
    cl, ccache = _port_chunked(cfg, params, t, prompts, chunk)
    _close(cl, jl, "port chunk vs JAX chunk")
    for key in ("k", "v"):
        _close(ccache["attn"][key], jcache["attn"][key], key)
    np.testing.assert_array_equal(ccache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    sl, scache = _port_stepwise(cfg, params, t, prompts)
    tol = 1e-6 * max(float(sl.abs().max()), 1.0)
    assert (cl - sl).abs().max().item() <= tol
    il, icache = _port_chunked(cfg, params, t, prompts, chunk, inplace=True)
    assert torch.equal(il, cl)
    _same_trees(icache, ccache)


# --------------------------------------------------------- the serving ---

def test_serving_capability_gates():
    """Every family packs stacked tables; chunked prefill gates only on
    sliding windows: arctic chunks, mixtral's reduced config keeps window
    32 and prefills stepwise."""
    mixtral = get_config("mixtral-8x7b", reduced=True)
    arctic = get_config("arctic-480b", reduced=True)
    jamba = get_config("jamba-v0.1-52b", reduced=True)
    for cfg in (mixtral, arctic, jamba):
        assert cfg.serving_capabilities().stacked_tables
    assert not mixtral.serving_capabilities().chunked_prefill
    assert mixtral.serving_capabilities().prefill_modes == ("full",)
    assert arctic.serving_capabilities().chunked_prefill
    assert jamba.serving_capabilities().chunked_prefill
    for arch in ARCHS + ["jamba-v0.1-52b"]:
        mine = get_config(arch, reduced=True).serving_capabilities()
        ref = jax_get_config(arch, reduced=True).serving_capabilities()
        assert (mine.stacked_tables, mine.chunked_prefill,
                mine.prefill_modes, mine.packable) == \
            (ref.stacked_tables, ref.chunked_prefill, ref.prefill_modes,
             ref.packable)


@pytest.mark.parametrize("arch,mode", [("mixtral-8x7b", "chunked"),
                                       ("arctic-480b", "chunked"),
                                       ("arctic-480b", "full")])
def test_engine_streams_equal_jax_stepwise(arch, mode):
    """The engine on reduced fp32 joint tables: mixtral falls back to
    "full" prefill (no chunk step built or registered), arctic chunks or
    prefills stepwise as asked; every greedy stream equals JAX stepwise
    decode's. Mixtral's requests reach past the 32-row ring."""
    from test_torch_engine import _jax_greedy_streams
    jcfg, cfg = _cfgs(arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = _to_port(jparams)
    jt = jax_tables(jparams, jcfg, bk=32, bn=32)
    t = build_stacked_tables(params, cfg, bk=32, bn=32)
    spec = WorkloadSpec(n_requests=5, arrival_rate=0.7, prompt_len=(3, 30),
                        gen_len=(6, 14), seed=3)
    trace = make_trace(spec, cfg.vocab_size)
    engine = ServeEngine(cfg, strip_packed_projections(params, cfg),
                         n_slots=3, max_len=48, prefill_chunk=4,
                         prefill_mode=mode, stacked_tables=t, device="cpu")
    outputs = engine.run(trace)
    full = arch == "mixtral-8x7b" or mode == "full"
    assert engine.prefill_mode == ("full" if full else "chunked")
    assert (engine._prefill is None) == full
    assert engine.prefill_kind == (None if full else "prefill_chunk_exact")
    kinds = ("decode", "reset") if full else \
        ("decode", "prefill_chunk_exact", "reset")
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(k, cfg.name): 1 for k in kinds}
    s = engine.metrics.summary()
    assert s["n_completed"] == len(trace)
    assert (s["prefill_calls"] == 0) == full
    if arch == "mixtral-8x7b":
        assert max(r.prompt_len + r.gen_len for r in trace) > cfg.window
    ref = _jax_greedy_streams(jcfg, jparams, jt, trace, 48)
    for r in trace:
        assert outputs[r.rid] == ref[r.rid], r.rid
    with pytest.raises(ValueError, match="prefill_mode"):
        ServeEngine(cfg, params, n_slots=2, prefill_mode="eager",
                    device="cpu")


def test_per_call_counts_one_launch_per_expert():
    """A decode call of mixtral-8x7b: 32 x (4 + 3 x 8) = 896 joint, 32
    attention and 65 norm launches; arctic at 2 of its 35 layers: 2 x (4
    + 3 x 128 + 3) = 782 joint, its dense residual MLP included."""
    assert per_call(get_config("mixtral-8x7b")) == {
        "joint_sparse_matmul": 896, "row_attention": 32, "row_norm": 65}
    assert per_call(get_config("arctic-480b").scaled(n_layers=2)) == {
        "joint_sparse_matmul": 782, "row_attention": 2, "row_norm": 5}


# ------------------------------------------------------- on the card -----

@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("N", [256, 200], ids=["full_tiles", "partial_tile"])
def test_expert_hook_on_card(cuda, N):
    """The expert hook on the card, x (G, E, C, K) bf16 with C = 8 rows a
    launch (a decode step's capacity at batch 4): one joint launch per
    expert, each within one bf16 ulp of max|ref| of the plain version, a
    partial last N tile (N = 200, bn = 128) included; rows bitwise equal
    to a launch of one row; the grouped pack on the card equals the
    CPU's."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.sparsity.sparse_linear import StackedKernelTables
    gen = torch.Generator().manual_seed(0)
    L, E, K, C = 1, 4, 384, 8
    w = (torch.randn((L, E, K, N), generator=gen) * K ** -0.5).to(
        torch.bfloat16)
    cpu = ops.pack_joint_sparse_grouped(w, value_sparsity=0.6, bk=128,
                                        bn=128)
    card = ops.pack_joint_sparse_grouped(w.to(cuda), value_sparsity=0.6,
                                         bk=128, bn=128)
    _same_pack({f: getattr(card, f).cpu() for f in FIELDS}, cpu)
    arrays = {"moe/w_up": {f: getattr(card, f) for f in FIELDS}}
    st = StackedKernelTables(arrays, {"moe/w_up": (card.k, card.n,
                                                   card.k_pad)})
    mm = st.dense_fn(layer_slice(arrays, 0))
    x = torch.randn((1, E, C, K), generator=gen).to(torch.bfloat16).to(cuda)
    before = jsm.LAUNCHES
    y = mm.expert(None, x, "moe/w_up")
    torch.cuda.synchronize()
    assert jsm.LAUNCHES - before == E
    assert y.shape == (1, E, C, N) and y.dtype == torch.bfloat16
    for e in range(E):
        p = ops.slice_joint_grouped(card, 0, e)
        ref = jsm.joint_sparse_matmul_plain(x[0, e].contiguous(), p.w_blocks,
                                            p.idx, p.scales)[:, :N]
        peak = ref.float().abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(peak)) - 7)
        assert (y[0, e].float() - ref.float()).abs().max().item() <= ulp
        one = ops.joint_dense(x[0, e, 3:4].contiguous(), p)
        assert torch.equal(one[0], y[0, e, 3])
