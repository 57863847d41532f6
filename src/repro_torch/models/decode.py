"""Serving path: cache init, single-token decode, chunked prefill, the
full-forward prefill and per-slot cache surgery, for every segment
layout the port serves
(attention with an MLP or MoE FFN, SSM, hybrid interleavings of both, the
whisper decoder with cross-attention) on a contiguous cache (a ring of
``window`` rows for sliding-window archs, which prefill stepwise).

Port of ``repro.models.decode``. The decoder is the segment list of
``models.segments``; where JAX scans each segment's stacked params, cache
slices and table slices, the port walks the layers in a Python loop and
slices layer ``l`` of each, dispatching on the segment's mixer. Caches
keep the JAX layout, the batch on axis 1 of every leaf: attention
segments hold stacked (L_seg, B, A, Hkv, hd) k/v, SSM segments stacked
(L_seg, B, W-1, Ch) conv windows and (L_seg, B, nh, P, N) float32 states,
and "pos" is a scalar or a (B,) vector of per-slot depths; a hybrid stack
keys each segment's cache by its name and keeps one global "pos". An
enc-dec cache also holds "enc_out" (B, Se, D), the encoder's output,
which every step reads and no step or slot surgery writes. Functions
return new caches, as in JAX.

The serving engine's compiled steps use the in-place forms
(``decode_step_``, ``decode_chunk_``, ``reset_slots_``): the same code,
with each layer's k/v rows (conv window and state) written into the cache
where it lies and the positions advanced in place, the counterpart of the
reference's donated cache. For the same inputs they leave the cache
bitwise as the functional step leaves it (``decode_step`` +
``merge_slots``, ``decode_chunk``, ``reset_slots``) and give the same
logits for every slot that computed.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device
from . import attention as attn_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import apply_norm, embed_tokens, logits_from_hidden
from .transformer import (_block_tail, _check_supported, _sinusoidal_at,
                          encode, forward, layer_slice, segment_tables)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", enc_out=None) -> Dict:
    """Per-segment caches: {"pos": scalar, seg.cache: {"k", "v" (L_seg, B,
    A, Hkv, hd), "pos"} for attention, {"conv", "state"} for SSM};
    multi-segment stacks track one global "pos". An enc-dec config given
    ``enc_out`` (B, Se, D) keeps it under "enc_out", as it is."""
    dev = resolve_device(device)
    cache: Dict = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for seg in _check_supported(cfg):
        if seg.mixer == "ssm":
            cache[seg.cache] = ssm_mod.init_ssm_cache(cfg, batch, seg.length,
                                                      dev)
            continue
        c = attn_mod.init_cache(cfg, batch, max_len, seg.length, dev)
        if seg.cache != "attn":
            c.pop("pos")
        cache[seg.cache] = c
    if cfg.is_encdec and enc_out is not None:
        cache["enc_out"] = enc_out
    return cache


#: a layer's two cache leaves, by the segment's mixer
_CACHE_KEYS = {"attn": ("k", "v"), "ssm": ("conv", "state")}


def _run_segments(params, cache, x, cfg, tables, layer_fn, new_pos,
                  inplace=False):
    """Walk every segment's layers: ``layer_fn(seg, p, h, a, b, mm)``
    returns (h, a, b) for one layer, a and b its two cache leaves (k and v
    for attention, conv and state for SSM). Returns (h, new cache) with
    every position advanced to ``new_pos``; ``inplace`` (layer_fn wrote
    into the cache slices it was given) advances the positions of
    ``cache`` itself and returns it."""
    segs = _check_supported(cfg)
    seg_tables = segment_tables(tables, segs, cfg)
    new_cache = dict(cache)
    for seg in segs:
        st = seg_tables.get(seg.name)
        c = cache[seg.cache]
        ka, kb = _CACHE_KEYS[seg.mixer]
        outs_a, outs_b = [], []
        for l in range(seg.length):
            p = layer_slice(params[seg.name], l)
            mm = (st.dense_fn(layer_slice(st.arrays, l))
                  if st is not None else None)
            x, a, b = layer_fn(seg, p, x, c[ka][l], c[kb][l], mm)
            outs_a.append(a)
            outs_b.append(b)
        if inplace:
            continue
        new_cache[seg.cache] = {ka: torch.stack(outs_a),
                                kb: torch.stack(outs_b)}
        if "pos" in c:
            new_cache[seg.cache]["pos"] = new_pos
    if inplace:
        for pos in _positions(cache):
            pos.copy_(new_pos)
        return x, cache
    new_cache["pos"] = new_pos
    return x, new_cache


def _positions(cache):
    """Every "pos" leaf of a cache tree."""
    for key, val in cache.items():
        if isinstance(val, dict):
            yield from _positions(val)
        elif key == "pos":
            yield val


def _check_inplace(cache, B: int):
    """The in-place steps keep per-slot (B,) positions where they lie."""
    for pos in _positions(cache):
        if tuple(pos.shape) != (B,):
            raise ValueError(f"in-place steps need per-slot positions of "
                             f"shape ({B},), got {tuple(pos.shape)}")


def decode_step(params, cache, token, cfg: ModelConfig, tables=None):
    """token (B, 1) int -> (logits (B, 1, V), new cache).

    ``tables`` (sparsity.sparse_linear.SegmentedKernelTables) routes every
    projection of every layer through the joint kernel; None keeps plain
    matmuls."""
    return _decode(params, cache, token, cfg, tables, None)


def decode_step_(params, cache, token, active, cfg: ModelConfig,
                 tables=None):
    """``decode_step`` followed by ``merge_slots(new, cache, active)``, in
    place: the active slots' k/v rows (conv windows and states) are written
    into ``cache`` and their positions advanced; inactive slots keep their
    slices and positions. Returns (logits (B, 1, V), cache). The active
    slots' logits and the whole cache equal the functional pair's bitwise;
    inactive slots' logits may differ (their attention reads their old
    row) and are not meant to be read. Positions must be (B,) vectors."""
    _check_inplace(cache, token.shape[0])
    return _decode(params, cache, token, cfg, tables, active)


def _decode(params, cache, token, cfg, tables, active):
    pos = cache["pos"]
    x = embed_tokens(params["embed"], token, cfg)
    if cfg.rope_pct == 0:
        posv = attn_mod._per_slot_pos(pos, token.shape[0], token.device)
        x = x + _sinusoidal_at(posv[:, None], cfg.d_model).to(x.dtype)
    enc_out = cache.get("enc_out")

    def layer(seg, p, h, a, b, mm):
        hn = apply_norm(p["norm1"], h, cfg)
        if seg.mixer == "attn":
            y, a, b = attn_mod.decode_attention(p["attn"], hn, a, b, pos,
                                                cfg, dense_fn=mm,
                                                active=active)
        else:
            y, a, b = ssm_mod.decode_ssm(p["ssm"], hn, a, b, cfg,
                                         dense_fn=mm, active=active)
        return _block_tail(seg, p, h + y, cfg, mm, enc_out), a, b

    if active is None:
        new_pos = pos + 1
    else:
        new_pos = torch.where(active, pos + 1, pos)
    x, new_cache = _run_segments(params, cache, x, cfg, tables, layer,
                                 new_pos, inplace=active is not None)
    x = apply_norm(params["final_norm"], x, cfg)
    return logits_from_hidden(params["embed"], x, cfg), new_cache


def decode_chunk(params, cache, tokens, n_valid, cfg: ModelConfig,
                 tables=None):
    """Chunked cache-filling prefill: C prompt tokens per slot in one step.

    tokens (B, C) int; n_valid (B,) int in [0, C] real tokens per slot
    (ragged tails and idle slots pass fewer or 0; their cache slices are
    left untouched). Returns (logits (B, 1, V) of each slot's last valid
    token, cache advanced by n_valid per slot).

    Per token, the math of attention segments is that of running
    decode_step n_valid times, and so is that of SSM segments with
    cfg.prefill_exact (``ssm.prefill_ssm``). The default SSM chunk is the
    parallel SSD form (``ssm.prefill_ssm_parallel``): the in/out
    projections read once per chunk instead of once per token, within
    ``ssm.PARALLEL_PREFILL_ATOL`` of stepwise decode, not bitwise. MoE
    layers group their capacity dispatch by chunk position, so each
    position routes the pool one decode step routes.

    Requires full causal attention (cfg.window == 0): a sliding-window
    ring overwrites rows within a chunk, which only a sequential walk
    reproduces."""
    return _chunk(params, cache, tokens, n_valid, cfg, tables, False)


def decode_chunk_(params, cache, tokens, n_valid, cfg: ModelConfig,
                  tables=None):
    """``decode_chunk`` in place: the valid tokens' k/v rows are written
    into ``cache`` (the conv windows and states of the slots with n_valid
    > 0) and its positions advanced by n_valid; rows n_valid excludes are
    not written. Returns (logits (B, 1, V), cache), bitwise the functional
    step's. Positions must be (B,) vectors."""
    _check_inplace(cache, tokens.shape[0])
    return _chunk(params, cache, tokens, n_valid, cfg, tables, True)


def _chunk(params, cache, tokens, n_valid, cfg, tables, inplace):
    if cfg.window:
        raise ValueError(f"chunked prefill is not supported for {cfg.name}"
                         f": sliding-window ring caches need stepwise "
                         f"prefill")
    B, C = tokens.shape
    pos = attn_mod._per_slot_pos(cache["pos"], B, tokens.device)
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                              device=tokens.device)
    x = embed_tokens(params["embed"], tokens, cfg)
    if cfg.rope_pct == 0:
        qpos = pos[:, None] + torch.arange(C, dtype=torch.int32,
                                           device=tokens.device)[None, :]
        x = x + _sinusoidal_at(qpos, cfg.d_model).to(x.dtype)
    enc_out = cache.get("enc_out")

    ssm_prefill = (ssm_mod.prefill_ssm if cfg.prefill_exact
                   else ssm_mod.prefill_ssm_parallel)

    def layer(seg, p, h, a, b, mm):
        hn = apply_norm(p["norm1"], h, cfg)
        if seg.mixer == "attn":
            y, a, b = attn_mod.prefill_attention(p["attn"], hn, a, b, pos,
                                                 n_valid, cfg, dense_fn=mm,
                                                 inplace=inplace)
        else:
            y, a, b = ssm_prefill(p["ssm"], hn, a, b, n_valid, cfg,
                                  dense_fn=mm, inplace=inplace)
        return (_block_tail(seg, p, h + y, cfg, mm, enc_out,
                            per_position=True), a, b)

    x, new_cache = _run_segments(params, cache, x, cfg, tables, layer,
                                 pos + n_valid, inplace=inplace)
    x = apply_norm(params["final_norm"], x, cfg)
    last = torch.clamp(n_valid - 1, 0, C - 1).long()
    x_last = x[torch.arange(B, device=x.device), last][:, None]   # (B, 1, D)
    return logits_from_hidden(params["embed"], x_last, cfg), new_cache


def prefill(params, tokens, cfg: ModelConfig, frames=None, tables=None):
    """Last-position logits (B, 1, V) of the full forward over a prompt
    batch, the reference's ``prefill``: an enc-dec config encodes
    ``frames`` (B, Se, D) first (``encode``, unpacked). Text only, as the
    reference's: pixtral's patch embeddings enter through
    ``forward(frontend_embeds=...)``. Fills no cache: the engine fills
    caches through chunked or stepwise decode."""
    enc_out = encode(params, frames, cfg) if cfg.is_encdec else None
    return forward(params, tokens, cfg, enc_out=enc_out, last_only=True,
                   tables=tables)


# ---------------------------------------------------------------------------
# Per-slot cache surgery (the serving engine's slot scheduler)
# ---------------------------------------------------------------------------

def merge_slots(new_cache, old_cache, keep_mask, cfg: ModelConfig):
    """Per-slot cache select: slots where keep_mask (B,) is True take the
    updated cache, the rest keep their previous contents and position.
    Every k/v, conv and state leaf carries the batch on axis 1; "pos"
    leaves come out as (B,) vectors whatever shape they came in;
    "enc_out" passes through as the new cache has it."""
    B = keep_mask.shape[0]

    def visit(key, new, old):
        if isinstance(new, dict):
            return {k: visit(k, new[k], old[k]) for k in new}
        if key == "enc_out":
            return new
        if key == "pos":
            return torch.where(keep_mask,
                               attn_mod._per_slot_pos(new, B, new.device),
                               attn_mod._per_slot_pos(old, B, old.device))
        shape = [1] * new.ndim
        shape[1] = B
        return torch.where(keep_mask.reshape(shape), new, old)

    return visit(None, new_cache, old_cache)


def reset_slots(cache, slot_mask, cfg: ModelConfig):
    """Zero the KV / SSM cache slices and position of the slots where
    slot_mask (B,) is True: the admission step before a freed slot takes a
    new request (without it an SSM state would carry the previous
    request's activations into the new one). "enc_out" is the slots'
    encoder output, not a request's: it stays as it is."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: (v if k == "enc_out" else zeros(v))
                    for k, v in tree.items()}
        return torch.zeros_like(tree)
    return merge_slots(cache, zeros(cache), ~slot_mask, cfg)


def reset_slots_(cache, slot_mask, cfg: ModelConfig):
    """``reset_slots`` in place: the masked slots' cache slices and
    positions are zeroed where they lie ("enc_out" untouched). Returns
    ``cache``, bitwise the functional result. Positions must be (B,)
    vectors."""
    B = slot_mask.shape[0]
    _check_inplace(cache, B)

    def visit(key, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(k, v)
        elif key == "enc_out":
            return
        elif key == "pos":
            tree.masked_fill_(slot_mask, 0)
        else:
            shape = [1] * tree.ndim
            shape[1] = B
            tree.masked_fill_(slot_mask.reshape(shape), 0)

    visit(None, cache)
    return cache
