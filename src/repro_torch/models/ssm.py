"""Mamba2 state-space (SSD) block (mamba2's layers, and jamba's SSM layers
at N = 16, 128 heads): the full-sequence forward (``apply_ssm``), decode,
the exact per-token chunk and the parallel SSD chunk.

Port of ``repro.models.ssm`` (arXiv:2405.21060):
inputs are projected to per-head x, a scalar decay A per head and B/C
shared across heads (n_groups = 1), with a depthwise causal conv on (x, B,
C) and a gated RMSNorm before the output projection. The reference's SSD
math is plain jnp; here it is plain torch, in the reference's order of
operations and rounding points. The gated norm is
``rms_head_norm(scale, y * silu(z))``, the row-stable ``row_norm`` kernel.

Cache per layer: ``conv`` (B, W-1, d_in + 2N) in cfg.dtype, the last W-1
conv inputs; ``state`` (B, nh, P, N) float32.

Each serving function takes the cache functionally (the new conv window
and state come back, as in JAX) or, for the engine's compiled steps,
writes them into the given cache slices in place (``active`` for decode,
``inplace`` for a chunk) through device masks only, bitwise what the
functional function followed by ``merge_slots`` leaves. The forward
(``apply_ssm``) runs the sequence in chunks of ``cfg.ssm_chunk`` through
the same ``_ssd_chunk`` as the parallel prefill, after a causal conv over
the whole sequence (``_causal_conv``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _normal, dtype_of, plain_mm, rms_head_norm

#: Equivalence contract of the parallel-form prefill: max |logit delta|
#: against the sequential decode recurrence over a full prompt, keyed by
#: activation dtype (the reference's ``repro.models.ssm
#: .PARALLEL_PREFILL_ATOL``). The parallel chunk reassociates the f32 state
#: accumulation (exp(cum_i - cum_j) segment products instead of a running
#: product), so results are tolerance-equal, not bitwise;
#: cfg.prefill_exact=True restores bit-identity at C x the weight traffic.
PARALLEL_PREFILL_ATOL = {"float32": 2e-4, "bfloat16": 0.5}


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_state, cfg.ssm_head_dim


def init_ssm(cfg: ModelConfig, gen, device, lead=()):
    """The reference's tree, shapes, dtypes and scales: projections and the
    conv in cfg.dtype; A_log, D, dt_bias and norm_scale float32."""
    dt = dtype_of(cfg)
    d = cfg.d_model
    d_in, nh, N, _ = ssm_dims(cfg)
    conv_ch = d_in + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": (_normal(gen, lead + (d, 2 * d_in + 2 * N + nh), device)
                    * d ** -0.5).to(dt),
        "conv_w": (_normal(gen, lead + (cfg.ssm_conv_width, conv_ch), device)
                   * 0.2).to(dt),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dt, device=device),
        "A_log": torch.zeros(lead + (nh,), **f32),
        "D": torch.ones(lead + (nh,), **f32),
        "dt_bias": torch.zeros(lead + (nh,), **f32),
        "norm_scale": torch.ones(lead + (d_in,), **f32),
        "out_proj": (_normal(gen, lead + (d_in, d), device)
                     * d_in ** -0.5).to(dt)}


def init_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int, device):
    d_in, nh, N, P = ssm_dims(cfg)
    conv_ch = d_in + 2 * N
    return {"conv": torch.zeros((n_layers, batch, cfg.ssm_conv_width - 1,
                                 conv_ch), dtype=dtype_of(cfg),
                                device=device),
            "state": torch.zeros((n_layers, batch, nh, P, N),
                                 dtype=torch.float32, device=device)}


def _split_proj(proj, cfg: ModelConfig):
    d_in, nh, N, _ = ssm_dims(cfg)
    z, xbc, dt = torch.split(proj, [d_in, d_in + 2 * N, nh], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along time, then silu. xbc (B, L, C); w (W,
    C); b (C,). The reference's ``_causal_conv``: the W shifted products
    added in order 0..W-1."""
    W = w.shape[0]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(W))
    return F.silu(out + b)


def _gated_norm(y, z, scale, eps=1e-6):
    """RMSNorm of y * silu(z) in float32, cast back to y's dtype: the
    reference's ``_gated_norm``, which is ``rms_head_norm`` of the gated
    product."""
    return rms_head_norm(scale, y * F.silu(z), eps)


def _ssd_chunk(state, xq, bq, cq, dtq, A):
    """One parallel-form SSD chunk (arXiv:2405.21060 §6): Q tokens in
    matrix form against a carried state.

    state (B, H, P, N) f32; xq (B, Q, H, P); bq/cq (B, Q, N); dtq (B, Q, H)
    f32, already softplus'd (a token with dtq == 0 is an exact identity on
    the state and contributes nothing, which is how the prefill masks
    invalid tokens); A (H,) f32. Returns (new_state, y (B, Q, H, P) f32)."""
    Q = dtq.shape[1]
    cum = torch.cumsum(dtq * A, dim=1)                     # (B,Q,H)
    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (c_i.b_j) x_j
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=dtq.device))
    # the pairs past the diagonal are masked before the exp, not after:
    # there cum_i - cum_j > 0 overflows exp once a chunk's decay passes
    # ~88 (full-width mamba2 at seq 128), and the gradient of where(tri,
    # exp(seg), 0) is then 0 * inf = NaN. exp(-inf) is the same 0, so the
    # forward is bitwise the reference's
    seg = torch.where(tri[None, :, :, None],
                      cum[:, :, None, :] - cum[:, None, :, :],
                      -torch.inf)                          # (B,Q,Q,H)
    decay = torch.exp(seg)
    cf, bf = cq.float(), bq.float()
    cb = torch.einsum("bqn,bkn->bqk", cf, bf)              # (B,Q,Q)
    w = cb[:, :, :, None] * decay * dtq[:, None, :, :]     # (B,Q,Q,H)
    xf = xq.float()
    y = torch.einsum("bqkh,bkhp->bqhp", w, xf)
    # inter-chunk: contribution of the carried state
    dec0 = torch.exp(cum)                                  # (B,Q,H)
    y = y + torch.einsum("bqn,bqh,bhpn->bqhp", cf, dec0, state)
    # state update
    decT = torch.exp(cum[:, -1:, :] - cum)                 # (B,Q,H)
    contrib = torch.einsum("bqh,bqn,bqhp->bhpn", decT * dtq, bf, xf)
    new_state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + contrib
    return new_state, y


def apply_ssm(p, x, cfg: ModelConfig, dense_fn=None):
    """The full-sequence forward. x (B, L, D) -> (B, L, D).

    dense_fn(w, x, name) intercepts the in/out projections (the joint
    kernel's hook); the chunked state scan between them is projection-free
    torch math, in the reference's order: the in-projection over the whole
    sequence, the causal conv, then chunks of Q = min(cfg.ssm_chunk, L)
    tokens through ``_ssd_chunk`` carrying the (B, nh, P, N) float32
    state from zero, the D skip and the gated norm."""
    mm = dense_fn or plain_mm
    Bsz, L, _ = x.shape
    d_in, nh, N, P = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, L)
    assert L % Q == 0, f"seq {L} not divisible by chunk {Q}"

    z, xbc, dt_raw = _split_proj(mm(p["in_proj"], x, "in_proj"), cfg)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bmat, Cmat = torch.split(xbc, [d_in, N, N], dim=-1)
    xs = xs.reshape(Bsz, L, nh, P)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                # (B,L,nh)
    A = -torch.exp(p["A_log"])                                     # (nh,)
    state = torch.zeros((Bsz, nh, P, N), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c in range(0, L, Q):
        state, y = _ssd_chunk(state, xs[:, c:c + Q], Bmat[:, c:c + Q],
                              Cmat[:, c:c + Q], dt[:, c:c + Q], A)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, L, d_in).to(x.dtype)
    return mm(p["out_proj"], _gated_norm(y, z, p["norm_scale"]), "out_proj")


def _put_slots_(cache, new, keep):
    """cache[b] = new[b] where keep[b], in place, through a device mask:
    the other slots keep their bits."""
    shape = (keep.shape[0],) + (1,) * (cache.ndim - 1)
    torch.where(keep.reshape(shape), new, cache, out=cache)


def decode_ssm(p, x, conv_state, ssm_state, cfg: ModelConfig,
               dense_fn=None, active=None):
    """One-token decode. x (B, 1, D); conv_state (B, W-1, Ch); ssm_state
    (B, nh, P, N). Returns (y, new_conv, new_state).

    active (B,) bool writes the new conv window and state into conv_state
    and ssm_state in place, for the active slots only (the others keep
    their bits), and returns them; None leaves them as they are."""
    mm = dense_fn or plain_mm
    Bsz = x.shape[0]
    d_in, nh, N, P = ssm_dims(cfg)
    z, xbc, dt_raw = _split_proj(mm(p["in_proj"], x[:, 0], "in_proj"), cfg)
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)
    conv = torch.sum(window * p["conv_w"][None], dim=1) + p["conv_b"]
    xbc_t = F.silu(conv)
    xs, Bv, Cv = torch.split(xbc_t, [d_in, N, N], dim=-1)
    xs = xs.reshape(Bsz, nh, P).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                 # (B,nh)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A)                                         # (B,nh)
    contrib = torch.einsum("bh,bn,bhp->bhpn", dt, Bv.float(), xs)
    new_state = ssm_state * da[:, :, None, None] + contrib
    y = torch.einsum("bn,bhpn->bhp", Cv.float(), new_state)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(Bsz, 1, d_in).to(x.dtype)
    out = mm(p["out_proj"], _gated_norm(y, z[:, None, :], p["norm_scale"]),
             "out_proj")
    new_conv = window[:, 1:]
    if active is None:
        return out, new_conv, new_state
    _put_slots_(conv_state, new_conv, active)
    _put_slots_(ssm_state, new_state, active)
    return out, conv_state, ssm_state


def prefill_ssm(p, x, conv_state, ssm_state, n_valid, cfg: ModelConfig,
                dense_fn=None, inplace=False):
    """Chunked cache-filling prefill through the exact decode recurrence:
    C prompt tokens, one ``decode_ssm`` step each, bit-identical conv and
    state trajectories to n_valid sequential decode calls.

    x (B, C, D); conv_state (B, W-1, Ch); ssm_state (B, nh, P, N); n_valid
    (B,) in [0, C] real tokens per slot. Per-slot validity gating leaves
    ragged tails and idle slots' caches untouched. Returns (y (B, C, D),
    new_conv, new_state); ``inplace`` writes them into conv_state and
    ssm_state for the slots with n_valid > 0 and returns those."""
    C = x.shape[1]
    conv, state = conv_state, ssm_state
    ys = []
    for t in range(C):
        y, new_conv, new_state = decode_ssm(p, x[:, t:t + 1], conv, state,
                                            cfg, dense_fn=dense_fn)
        keep = t < n_valid                                         # (B,)
        conv = torch.where(keep[:, None, None], new_conv, conv)
        state = torch.where(keep[:, None, None, None], new_state, state)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    if not inplace:
        return y, conv, state
    keep = n_valid > 0
    _put_slots_(conv_state, conv, keep)
    _put_slots_(ssm_state, state, keep)
    return y, conv_state, ssm_state


def prefill_ssm_parallel(p, x, conv_state, ssm_state, n_valid,
                         cfg: ModelConfig, dense_fn=None, inplace=False):
    """Parallel-form (SSD) chunked prefill: C prompt tokens with ONE read of
    the in/out projections, instead of the C reads of ``prefill_ssm``.

    Same signature and cache semantics as ``prefill_ssm``. The
    in-projection runs over the whole chunk, the causal conv slides over
    [conv_state ++ chunk], and the recurrence is evaluated in matrix form
    (``_ssd_chunk``) seeded with the carried state. Invalid positions (>=
    n_valid, idle slots included) are masked by zeroing dt, an exact
    identity on the state, and the new conv window is gathered at each
    slot's n_valid, so ragged tails and idle slots leave their caches
    untouched. Tolerance-equal to sequential decode
    (``PARALLEL_PREFILL_ATOL``), not bitwise."""
    mm = dense_fn or plain_mm
    Bsz, C, _ = x.shape
    d_in, nh, N, P = ssm_dims(cfg)

    z, xbc, dt_raw = _split_proj(mm(p["in_proj"], x, "in_proj"), cfg)
    # causal conv over the carried prefix: window[t + i] for i in [0, W)
    # reproduces decode's per-token window at position t
    W = p["conv_w"].shape[0]
    window = torch.cat([conv_state, xbc.to(conv_state.dtype)], dim=1)
    conv = sum(window[:, i:i + C, :] * p["conv_w"][i] for i in range(W))
    xbc_t = F.silu(conv + p["conv_b"])
    # the new conv window ends at the last valid token: rows n_valid ..
    # n_valid + W - 2 of `window` (n_valid = 0 gives conv_state back)
    gather = (n_valid[:, None]
              + torch.arange(W - 1, device=x.device)[None, :]).long()
    new_conv = torch.gather(
        window, 1, gather[:, :, None].expand(-1, -1, window.shape[-1]))

    xs, Bmat, Cmat = torch.split(xbc_t, [d_in, N, N], dim=-1)
    xs = xs.reshape(Bsz, C, nh, P)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    valid = (torch.arange(C, device=x.device)[None, :]
             < n_valid[:, None])                                   # (B, C)
    dt = torch.where(valid[:, :, None], dt, 0.0)     # dt = 0: state identity
    A = -torch.exp(p["A_log"])
    new_state, y = _ssd_chunk(ssm_state, xs, Bmat, Cmat, dt, A)
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, C, d_in).to(x.dtype)
    out = mm(p["out_proj"], _gated_norm(y, z, p["norm_scale"]), "out_proj")
    if not inplace:
        return out, new_conv, new_state
    keep = n_valid > 0
    _put_slots_(conv_state, new_conv, keep)
    _put_slots_(ssm_state, new_state, keep)
    return out, conv_state, ssm_state
