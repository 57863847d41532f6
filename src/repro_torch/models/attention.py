"""Attention: GQA with RoPE and qk-norm against a contiguous static-shape
KV cache, a ring of ``window`` rows for sliding-window archs (mixtral);
the full-sequence attention of ``transformer.forward`` (causal, with the
sliding window as a lower key bound) and of the whisper encoder
(non-causal); the decoder's cross-attention.

Port of the contiguous branches of ``repro.models.attention``, with the
same -1e30 masking and the fp32 softmax cast back to the activation dtype.
The reference's plain einsums run in one hand-written kernel
(``kernels.row_attention``), whose queries come out bitwise the same
however many share a call: chunked prefill reproduces stepwise decode.

Shapes: x (B, S, D); q (B, S, Hq, hd); k/v (B, S, Hkv, hd). Cache:
{"k", "v"} (B, A, Hkv, hd) per layer, A = allocated length.

The ring (cfg.window > 0): A = min(max_len, window) rows, a decode step
writes position ``pos`` at row ``pos mod A``, and a row is valid if it
was written (row <= pos) or the ring is full (pos >= A), when every row
is. That is ``row_attention`` with the query's position clamped to A - 1:
the same kernel serves it. Windowed archs prefill stepwise; the chunk
(``prefill_attention``) refuses them, as the reference does.

Attention without a cache runs the same kernel over the sequence's own
keys. Causal ``attention`` (the full-sequence forward) puts query i at
position i, with ``cfg.window`` as the kernel's lower key bound
(``kpos > qpos - window``, the reference's ``causal_mask``); its
resident and streaming kernels never hold the (S, S) logits, so the card
needs no counterpart of the reference's ``_chunked_sdpa``, which the CPU
takes where the reference does. Non-causal ``attention(causal=False)``
(the whisper encoder) and the decoder's ``cross_attention`` over the
encoder output (whose k/v are projected from it at every call, as in the
reference) put each query's position at the last key.

Each attention takes the cache functionally (new k/v come back, as in
JAX) or, for the serving engine's compiled steps, writes its rows into the
given cache slices in place (``active`` for decode, ``inplace`` for a
chunk): the counterpart of the reference's donated cache.

The paged cache (``init_paged_cache``; ``ptab`` given to the decode and
chunk attentions): a layer's k/v live in a pool of pages shared by every
slot, and the page table (B, MP) int32 maps each slot's positions to pages
(-1: unallocated). A write scatters through the table; a read gathers each
slot's pages into a contiguous (B, MP * PS, Hkv, hd) view (plain torch
indexing, as the reference's is plain jnp) and hands it to row_attention.
When MP * PS equals the contiguous cache's A, the kernel sees exactly the
contiguous input, so paged attention is bitwise the contiguous one. The
reference drops the writes it routes out of range (``mode="drop"``, to
page NP): inactive slots', invalid chunk tokens' and unallocated pages'.
Torch has no such scatter, and a boolean-mask index is a data-dependent
shape no CUDA graph can capture, so the port's pools carry one spare page
past the reference's NP, which takes those writes and which no table
names: it is never read, and snapshots and fault injection leave it out.
"""

from __future__ import annotations

import torch

from ..kernels import row_attention
from .config import ModelConfig
from .layers import (_normal, apply_rope, dtype_of, plain_mm,
                     rms_head_norm, rope_frequencies)


def init_attention(cfg: ModelConfig, gen, device, lead=()):
    dt = dtype_of(cfg)
    d = cfg.d_model
    s = d ** -0.5
    p = {"wq": (_normal(gen, lead + (d, cfg.q_dim), device) * s).to(dt),
         "wk": (_normal(gen, lead + (d, cfg.kv_dim), device) * s).to(dt),
         "wv": (_normal(gen, lead + (d, cfg.kv_dim), device) * s).to(dt),
         "wo": (_normal(gen, lead + (cfg.q_dim, d), device)
                * cfg.q_dim ** -0.5).to(dt)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (cfg.hd,), dtype=torch.float32,
                                 device=device)
        p["k_norm"] = torch.ones(lead + (cfg.hd,), dtype=torch.float32,
                                 device=device)
    return p


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _sdpa(q, k, v, qpos, window: int = 0):
    """q (B,Sq,Hq,hd), k/v (B,A,Hkv,hd) the cache, qpos (B,Sq) each
    query's position: it attends to cache rows qpos - window < j <= qpos
    (window 0: 0..qpos)."""
    return row_attention.row_attention(q, k, v, qpos, window)


#: the sequence length from which the reference's full-sequence causal
#: attention takes ``_chunked_sdpa`` (with S % 2048 == 0)
CHUNKED_ATTN_THRESHOLD = 16384


def causal_mask(sq: int, skv: int, window: int = 0, device=None):
    """(1, 1, sq, skv) bool; offsets assume q positions are the last sq of
    skv (prefill: sq == skv). The reference's ``causal_mask``."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m[None, None]


def _chunked_sdpa(q, k, v, cfg: ModelConfig, dtype, chunk: int = 2048):
    """Flash-style two-level blocked attention with online softmax, in
    plain torch: the reference's ``_chunked_sdpa``, in its order of
    operations and rounding points. q/k/v (B, S, H, hd), the KV heads
    already repeated to H. Never holds (S, S): an outer loop over query
    chunks, an inner one over key chunks with a running (max, sum, acc);
    causal (and window) masking at element level inside each block,
    upper-triangular blocks masked, not skipped."""
    B, S, H, hd = q.shape
    nq = S // chunk
    scale = hd ** -0.5
    base = torch.arange(chunk, device=q.device)
    blocks = []
    for qi in range(nq):
        qb = q[:, qi * chunk:(qi + 1) * chunk]
        qpos = qi * chunk + base
        m = torch.full((B, H, chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, chunk, hd), dtype=dtype, device=q.device)
        for kj in range(nq):
            kb = k[:, kj * chunk:(kj + 1) * chunk]
            vb = v[:, kj * chunk:(kj + 1) * chunk]
            kpos = kj * chunk + base
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb).float() * scale
            mask = kpos[None, :] <= qpos[:, None]
            if cfg.window:
                mask &= kpos[None, :] > qpos[:, None] - cfg.window
            s = torch.where(mask[None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p.to(dtype), vb)
            acc = acc * corr[..., None].to(dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(dtype)
        blocks.append(out.transpose(1, 2))               # (B, chunk, H, hd)
    return torch.cat(blocks, dim=1)


def _all_keys(x, n_keys: int):
    """(B, S) query positions that reach every one of ``n_keys`` keys: the
    reference's all-ones mask in ``row_attention``'s terms."""
    return torch.full(x.shape[:2], n_keys - 1, dtype=torch.int32,
                      device=x.device)


def attention(p, x, cfg: ModelConfig, positions, causal: bool = True,
              dense_fn=None):
    """Full-sequence attention without a cache (the forward / prefill,
    and the whisper encoder). x (B, S, D); positions (B, S) for RoPE.
    Causal: query i attends to keys i - window < j <= i (``cfg.window``;
    0: 0..i), the reference's ``causal_mask(S, S, cfg.window)``; on the
    CPU a long sequence (S >= CHUNKED_ATTN_THRESHOLD, S % 2048 == 0) takes
    ``_chunked_sdpa``, as the reference does. ``causal=False`` (the
    whisper encoder): every query attends to all S keys."""
    mm = dense_fn or plain_mm
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, positions, cfg, mm)
    if not causal:
        out = _sdpa(q, k, v, _all_keys(x, S))
    elif (x.device.type == "cpu" and S >= CHUNKED_ATTN_THRESHOLD
          and S % 2048 == 0):
        rep = cfg.n_heads // cfg.n_kv_heads
        out = _chunked_sdpa(q, torch.repeat_interleave(k, rep, dim=2),
                            torch.repeat_interleave(v, rep, dim=2), cfg,
                            x.dtype)
    else:
        qpos = torch.arange(S, dtype=torch.int32,
                            device=x.device).expand(B, S)
        out = _sdpa(q, k, v, qpos, cfg.window)
    return mm(p["wo"], out.reshape(B, S, cfg.q_dim), "wo")


def cross_attention(p, x, enc_out, cfg: ModelConfig, dense_fn=None):
    """Decoder cross-attention over the encoder output (whisper). x (B, S,
    D); enc_out (B, Se, D). wq projects x, and wk and wv project enc_out
    at every call (B x Se rows each), as in the reference; no RoPE, no
    qk-norm. Hook names carry the "xattn/" prefix, so a block's self- and
    cross-attention projections are distinct table entries."""
    mm = dense_fn or plain_mm
    B, S, _ = x.shape
    q = _split_heads(mm(p["wq"], x, "xattn/wq"), cfg.n_heads, cfg.hd)
    k = _split_heads(mm(p["wk"], enc_out, "xattn/wk"), cfg.n_kv_heads,
                     cfg.hd)
    v = _split_heads(mm(p["wv"], enc_out, "xattn/wv"), cfg.n_kv_heads,
                     cfg.hd)
    out = _sdpa(q, k, v, _all_keys(x, enc_out.shape[1]))
    return mm(p["wo"], out.reshape(B, S, cfg.q_dim), "xattn/wo")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
               device):
    """Stacked KV cache for a layer stack. Sliding-window archs allocate
    only the window (the ring)."""
    dt = dtype_of(cfg)
    alloc = min(max_len, cfg.window) if cfg.window else max_len
    shape = (n_layers, batch, alloc, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     n_layers: int, device):
    """Paged KV pool for a layer stack: ``{"pk", "pv"}`` of shape
    (n_layers, n_pages + 1, page_size, Hkv, hd), the reference's pool and
    the spare page that takes dropped writes (module docstring). No batch
    axis: a slot's cache is the pages its page-table row names. The table
    is host state (``serving.paging.PageAllocator``) passed into each step.
    Sliding-window archs keep the ring cache: ValueError."""
    if cfg.window:
        raise ValueError(f"paged KV cache does not support sliding-window "
                         f"ring caches ({cfg.name}); serve contiguous")
    dt = dtype_of(cfg)
    shape = (n_layers, n_pages + 1, page_size, cfg.n_kv_heads, cfg.hd)
    return {"pk": torch.zeros(shape, dtype=dt, device=device),
            "pv": torch.zeros(shape, dtype=dt, device=device)}


def _paged_view(pool, ptab, n_kv: int, hd: int):
    """A per-slot contiguous view (B, MP * PS, Hkv, hd) gathered from one
    layer's pool (NP + 1, PS, Hkv, hd) through the page table (B, MP).
    Unallocated entries (-1) clamp to page 0, as in the reference: their
    rows lie past every query's position, dead keys."""
    gid = ptab.long().clamp(0, pool.shape[0] - 2)
    view = pool[gid]                                    # (B, MP, PS, H, hd)
    B, MP, PS = view.shape[:3]
    return view.reshape(B, MP * PS, n_kv, hd)


def _paged_put(pool, ptab, wpos, new, live, inplace: bool):
    """Write ``new`` (B, C, Hkv, hd) at positions ``wpos`` (B, C) of each
    slot's pages where ``live`` (B, C) and the page is allocated; every
    other write goes to the spare page (the reference's dropped write).
    Returns ``pool`` written in place, or a written copy."""
    PS = pool.shape[1]
    pid = torch.gather(ptab.long(), 1, wpos // PS)                 # (B, C)
    ok = pid >= 0
    if live is not None:
        ok &= live
    pid = torch.where(ok, pid, pool.shape[0] - 1)
    out = pool if inplace else pool.clone()
    out[pid, wpos % PS] = new
    return out


def _per_slot_pos(pos, B: int, device=None):
    """A cache position, scalar (lock-step batch) or (B,) (per-slot
    depths), as a (B,) int32 vector: both shapes flow through the same
    math."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return torch.atleast_1d(pos).expand(B)


def _put_rows_(cache, b_idx, rows, new, live):
    """cache[b_idx, rows] = new where ``live``, in place. A write that is
    not live puts back the row's own contents, so its row must be one no
    live write of the call targets: the row then keeps its bits."""
    old = cache[b_idx, rows]
    cache[b_idx, rows] = torch.where(live[..., None, None], new, old)


def _project_qkv(p, x, positions, cfg: ModelConfig, mm):
    q = _split_heads(mm(p["wq"], x, "wq"), cfg.n_heads, cfg.hd)
    k = _split_heads(mm(p["wk"], x, "wk"), cfg.n_kv_heads, cfg.hd)
    v = _split_heads(mm(p["wv"], x, "wv"), cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if cfg.rope_pct > 0:
        cos, sin = rope_frequencies(cfg, positions)
        q = apply_rope(q, cos, sin, cfg)
        k = apply_rope(k, cos, sin, cfg)
    return q, k, v


def decode_attention(p, x, cache_k, cache_v, pos, cfg: ModelConfig,
                     dense_fn=None, active=None, ptab=None, write_mask=None):
    """Single-token decode against one layer's cache slice. x (B, 1, D);
    cache_k/v (B, A, Hkv, hd); pos = tokens already in the cache, scalar
    or (B,). Returns (out, new_k, new_v). A windowed arch's cache is the
    ring: the new row goes to pos mod A and the query attends to every
    valid row (its position clamped to A - 1).

    active (B,) bool writes the new rows into cache_k/v in place, for the
    active slots only (inactive slots' slices keep their bits; their
    outputs then attend to their old row and are not meant to be read),
    and returns them as new_k/v; None leaves cache_k/v as they are.

    Paged (ptab (B, MP) int32 given): cache_k/v are one layer's pools (NP
    + 1, PS, Hkv, hd), the new row goes through the table to position
    min(pos, MP * PS - 1) of the slot's pages, and the query attends to
    the gathered view. ``write_mask`` (B,) drops the writes of the slots it
    leaves out, functionally (the reference's in-step drop); ``active``
    does the same in place."""
    mm = dense_fn or plain_mm
    B = x.shape[0]
    posv = _per_slot_pos(pos, B, x.device)                         # (B,)
    q, k, v = _project_qkv(p, x, posv[:, None], cfg, mm)
    if ptab is not None:
        if cfg.window:
            raise ValueError("paged attention does not support "
                             "sliding-window ring caches; serve contiguous")
        A = ptab.shape[1] * cache_k.shape[1]
        wpos = torch.clamp(posv, max=A - 1).long()[:, None]        # (B, 1)
        live = active if active is not None else write_mask
        live = None if live is None else live[:, None]
        new_k = _paged_put(cache_k, ptab, wpos, k, live, active is not None)
        new_v = _paged_put(cache_v, ptab, wpos, v, live, active is not None)
        out = _sdpa(q, _paged_view(new_k, ptab, cfg.n_kv_heads, cfg.hd),
                    _paged_view(new_v, ptab, cfg.n_kv_heads, cfg.hd),
                    posv[:, None])
        return mm(p["wo"], out.reshape(B, 1, cfg.q_dim), "wo"), new_k, new_v
    A = cache_k.shape[1]
    slot = (torch.remainder(posv, A) if cfg.window
            else torch.clamp(posv, max=A - 1)).long()
    rows = torch.arange(B, device=x.device)
    if active is None:
        new_k = cache_k.clone()
        new_v = cache_v.clone()
        new_k[rows, slot] = k[:, 0]
        new_v[rows, slot] = v[:, 0]
    else:
        new_k, new_v = cache_k, cache_v
        _put_rows_(new_k, rows, slot, k[:, 0], active)
        _put_rows_(new_v, rows, slot, v[:, 0], active)
    qpos = torch.clamp(posv, max=A - 1) if cfg.window else posv
    out = _sdpa(q, new_k, new_v, qpos[:, None])
    return mm(p["wo"], out.reshape(B, 1, cfg.q_dim), "wo"), new_k, new_v


def prefill_attention(p, x, cache_k, cache_v, pos, n_valid,
                      cfg: ModelConfig, dense_fn=None, inplace=False,
                      ptab=None):
    """Chunked cache-filling attention: C prompt tokens in one step.

    x (B, C, D); pos (B,) tokens already cached per slot; n_valid (B,) in
    [0, C] real tokens in this chunk. Writes the valid tokens' k/v at
    pos..pos+n_valid-1 and leaves every other cache row untouched (slots
    with n_valid = 0 keep their slice as it was), then attends each query
    to every cached position <= its own. Returns (out, new_k, new_v);
    ``inplace`` writes the valid rows into cache_k/v themselves (every
    other row keeps its bits) and returns them.

    Requires cfg.window == 0: a sliding-window ring overwrites rows within
    the chunk, which only a sequential walk reproduces.

    Paged (ptab (B, MP) given): cache_k/v are the layer's pools (NP + 1,
    PS, Hkv, hd); the valid tokens' rows go through the table, invalid
    tokens' and unallocated pages' to the spare page, and the queries
    attend to the gathered view; bitwise the contiguous chunk when MP * PS
    is its A."""
    if cfg.window:
        raise ValueError("chunked prefill does not support sliding-window "
                         "ring caches; use stepwise (full-forward) prefill")
    mm = dense_fn or plain_mm
    B, C, _ = x.shape
    A = (cache_k.shape[1] if ptab is None
         else ptab.shape[1] * cache_k.shape[1])
    posv = _per_slot_pos(pos, B, x.device)                         # (B,)
    qpos = posv[:, None] + torch.arange(C, dtype=torch.int32,
                                        device=x.device)[None, :]    # (B,C)
    q, k, v = _project_qkv(p, x, qpos, cfg, mm)
    tok_valid = torch.arange(C, device=x.device)[None, :] < n_valid[:, None]
    if ptab is not None:
        wpos = torch.clamp(qpos, max=A - 1).long()
        new_k = _paged_put(cache_k, ptab, wpos, k, tok_valid, inplace)
        new_v = _paged_put(cache_v, ptab, wpos, v, tok_valid, inplace)
        out = _sdpa(q, _paged_view(new_k, ptab, cfg.n_kv_heads, cfg.hd),
                    _paged_view(new_v, ptab, cfg.n_kv_heads, cfg.hd), qpos)
        return mm(p["wo"], out.reshape(B, C, cfg.q_dim), "wo"), new_k, new_v
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, C)
    if inplace:
        # an invalid token writes its row back onto itself at qpos mod A:
        # the C positions of a slot's chunk are C distinct rows mod A, and
        # its valid ones (pos + n_valid <= A) are their own rows
        if C > A:
            raise ValueError(f"a chunk of {C} tokens is longer than the "
                             f"cache ({A} rows)")
        rows = torch.where(tok_valid, torch.clamp(qpos, max=A - 1),
                           torch.remainder(qpos, A)).long()
        new_k, new_v = cache_k, cache_v
        _put_rows_(new_k, b_idx, rows, k, tok_valid)
        _put_rows_(new_v, b_idx, rows, v, tok_valid)
    else:
        # masked write: valid chunk tokens land on their rows, invalid ones
        # on a scratch row A that is dropped (the reference's mode="drop"
        # scatter)
        write_rows = torch.where(tok_valid, torch.clamp(qpos, max=A - 1),
                                 A).long()
        pad = cache_k.new_zeros((B, 1) + cache_k.shape[2:])
        new_k = torch.cat([cache_k, pad], dim=1)
        new_v = torch.cat([cache_v, pad], dim=1)
        new_k[b_idx, write_rows] = k
        new_v[b_idx, write_rows] = v
        new_k, new_v = new_k[:, :A], new_v[:, :A]
    out = _sdpa(q, new_k, new_v, qpos)
    return mm(p["wo"], out.reshape(B, C, cfg.q_dim), "wo"), new_k, new_v
