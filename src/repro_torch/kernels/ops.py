"""Packing utilities and the public ops over the port's kernels, on torch
tensors.

Port of ``repro.kernels.ops``: the block-sparse pack and ``sparse_dense``
(value level), ``fta_pack`` and ``fta_dense`` (bit level), the joint pack
and ``joint_dense`` (value x bit), and ``dbmu_reference_check`` (the
bit-true DB-PIM datapath). The joint pack runs on
whatever device its weights lie on, so a full-width model packs on the
card in seconds instead of spending minutes of host time in numpy. It is
byte-identical to the JAX package's numpy pack:

  * quantization follows numpy's promotion: ``w * m`` of a float32 weight
    and an int32 mask is float64 there, so amax, the scale and
    ``w * m / scales`` are evaluated in float64 here too, and
    ``torch.round`` rounds half to even like ``np.round``;
  * tile norms for pruning are summed in float64 (numpy sums float32),
    which only matters for tiles whose norms tie to 1e-7, and makes the
    card's pack equal to the CPU's;
  * argsorts are stable, and the FTA pass is integer table lookups.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import dyadic, fta, qat
from .block_sparse_matmul import block_sparse_matmul
from .dbmu_sim import dbmu_matmul
from .fta_int8_matmul import fta_int8_matmul
from .joint_sparse_matmul import joint_sparse_matmul

#: the TPU kernel's tiles; reduced configs pack smaller (sparse_linear)
BM, BK, BN = 128, 128, 128


def _compact_order(alive, maxb: int):
    """Per N tile, its surviving K-blocks first in ascending K order:
    (order (nt, maxb) int64 source block per slot, real (nt, maxb) bool)."""
    kt = alive.shape[0]
    nblocks = alive.sum(dim=0)                                   # (nt,)
    k_ar = torch.arange(kt, device=alive.device)
    key = (~alive).T.to(torch.int64) * kt + k_ar[None, :]        # (nt, kt)
    order = torch.argsort(key, dim=1)[:, :maxb]
    real = (torch.arange(maxb, device=alive.device)[None, :]
            < nblocks[:, None])
    return order, real


def pack_block_sparse(w_dense, mask, bk: int = BK, bn: int = BN):
    """Compact a masked (K, N) weight into the surviving K-blocks of each N
    tile: (w_blocks (NT, MAXB, bk, bn) in w's dtype, idx (NT, MAXB) int32),
    on w's device. A K-block survives for an N tile iff its (bk, bn) tile
    of ``w * mask`` holds a non-zero weight; MAXB is the most survivors of
    any tile (at least 1), shorter tiles pad with zero blocks at index 0.
    K and N must be multiples of bk and bn."""
    w_dense = torch.as_tensor(w_dense)
    w = w_dense * torch.as_tensor(mask, device=w_dense.device).to(
        w_dense.dtype)
    K, N = w.shape
    if K % bk or N % bn:
        raise ValueError(f"({K}, {N}) is not a multiple of ({bk}, {bn})")
    kt, nt = K // bk, N // bn
    tiles = w.reshape(kt, bk, nt, bn)
    alive = (tiles != 0).any(dim=3).any(dim=1)                   # (kt, nt)
    maxb = max(int(alive.sum(dim=0).max()), 1)
    order, real = _compact_order(alive, maxb)
    w_blocks = torch.gather(
        tiles.permute(2, 0, 1, 3), 1,
        order[:, :, None, None].expand(nt, maxb, bk, bn))
    w_blocks = w_blocks * real[:, :, None, None].to(w.dtype)
    idx = torch.where(real, order, torch.zeros_like(order)).to(torch.int32)
    return w_blocks.contiguous(), idx


def sparse_dense(x, w_blocks, idx):
    """Block-sparse y = x @ W for (..., K) activations, in x's dtype."""
    shape = x.shape
    y = block_sparse_matmul(x.reshape(-1, shape[-1]).contiguous(), w_blocks,
                            idx)
    return y.reshape(shape[:-1] + (y.shape[-1],))


def fta_pack(w, mask):
    """The DB-PIM weight compilation of one matrix: per-tensor INT8 scale
    (max|w| / 127, in w's dtype) -> FTA projection under ``mask`` ->
    dyadic term bytes. Returns (q_fta int8, scale, packed (K, N, 2) uint8,
    phi_th (N,) int32), on w's device."""
    w = torch.as_tensor(w)
    scale = w.abs().max() / 127.0
    q = qat.quantize_int8(w, scale)
    q_fta, phi = fta.fta_quantize(q, torch.as_tensor(mask, device=w.device))
    return q_fta.to(torch.int8), scale, dyadic.pack_terms(q_fta), phi


def fta_dense(x, w_q, scales):
    """y = x @ (int8 FTA weights x per-filter scales) for (..., K)
    activations; bf16 out, as the kernel's default."""
    shape = x.shape
    y = fta_int8_matmul(x.reshape(-1, shape[-1]).contiguous(), w_q, scales)
    return y.reshape(shape[:-1] + (y.shape[-1],))


def random_tile_mask(gen: torch.Generator, K: int, N: int, sparsity: float,
                     tile: int = 128, device=None):
    """Whole-(tile x tile) random survival mask (ceil + crop, so ragged
    shapes work): int32 (K, N) on ``device``; at least one tile survives.
    The draw comes from ``gen`` (its device must be ``device``'s)."""
    kt, nt = -(-K // tile), -(-N // tile)
    alive = torch.rand((kt, nt), generator=gen, device=device) >= sparsity
    if not alive.any():
        alive[0, 0] = True
    return _expand_tiles(alive, tile, tile, K, N)


def dbmu_reference_check(x_int8, packed):
    """Run the bit-true DBMU datapath: x (M, K) int8-range ints, packed
    (K, N, 2) uint8 term bytes -> (M, N) int32."""
    x = torch.as_tensor(x_int8).to(torch.int32).contiguous()
    return dbmu_matmul(x, torch.as_tensor(packed).contiguous())


def _tile_norms(w, bk: int, bn: int):
    """(kt, nt) float64 squared L2 norms of the zero-padded (bk, bn) tiles."""
    K, N = w.shape
    kt, nt = -(-K // bk), -(-N // bn)
    wp = F.pad(w.double(), (0, nt * bn - N, 0, kt * bk - K))
    return (wp.reshape(kt, bk, nt, bn) ** 2).sum(dim=(1, 3))


def _expand_tiles(alive, bk: int, bn: int, K: int, N: int):
    full = alive.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    return full[:K, :N].to(torch.int32)


def tile_prune_mask(w, value_sparsity: float, bk: int = BK, bn: int = BN):
    """Drop the lowest-L2 (bk, bn) weight tiles at the target ratio,
    globally (ceil + crop for ragged shapes). At least one tile survives."""
    K, N = w.shape
    norms = _tile_norms(w, bk, bn)
    kt, nt = norms.shape
    alive = torch.ones((kt, nt), dtype=torch.bool, device=w.device)
    n_drop = min(int(round(value_sparsity * kt * nt)), kt * nt - 1)
    if n_drop > 0:
        order = torch.argsort(norms.reshape(-1), stable=True)
        alive.view(-1)[order[:n_drop]] = False
    return _expand_tiles(alive, bk, bn, K, N)


def tile_prune_mask_balanced(w, value_sparsity: float, bk: int = BK,
                             bn: int = BN):
    """Column-balanced tile pruning: drop the lowest-L2 ``round(vs * kt)``
    K-tiles in EVERY N-tile column, so every column keeps the same number
    of K-blocks and a stack packs to one shared MAXB with no padded slots."""
    K, N = w.shape
    norms = _tile_norms(w, bk, bn)
    kt, nt = norms.shape
    n_drop = min(int(round(value_sparsity * kt)), kt - 1)
    alive = torch.ones((kt, nt), dtype=torch.bool, device=w.device)
    if n_drop > 0:
        order = torch.argsort(norms, dim=0, stable=True)
        alive.scatter_(0, order[:n_drop], False)
    return _expand_tiles(alive, bk, bn, K, N)


def quantize_int8_fta(w, mask, fta_project: bool = True):
    """Per-filter symmetric INT8 scale over the kept weights, then (unless
    fta_project=False) the FTA projection. Returns (q int32 (K, N) masked
    and on the grid, scales float32 (1, N))."""
    m = mask.to(torch.int32)
    wm = w.double() * m.double()
    amax = wm.abs().amax(dim=0)
    scales = (amax / 127.0 + 1e-12).float()
    q = torch.clamp(torch.round(wm / scales.double()), -127, 127)
    q = q.to(torch.int32)
    if fta_project:
        q, _phi = fta.fta_quantize(q, m)
    return q * m, scales.reshape(1, -1)


class JointPacked(NamedTuple):
    """One layer's joint artifact: ``w_blocks`` (NT, MAXB, bk, bn) int8 or
    bf16, ``idx`` (NT, MAXB) int32, ``scales`` (1, N_pad) float32,
    ``nblocks`` (NT,) int32 real blocks per tile; ``k``/``n`` are the
    logical dims, ``k_pad`` the padded K the index table refers to."""
    w_blocks: torch.Tensor
    idx: torch.Tensor
    scales: torch.Tensor
    nblocks: torch.Tensor
    k: int
    n: int
    k_pad: int


class JointPackedStacked(NamedTuple):
    """All L layers of one projection, packed with one shared MAXB: the
    JointPacked fields with a leading layer axis."""
    w_blocks: torch.Tensor
    idx: torch.Tensor
    scales: torch.Tensor
    nblocks: torch.Tensor
    k: int
    n: int
    k_pad: int

    @property
    def maxb(self) -> int:
        return self.w_blocks.shape[2]


def _tile_alive(m, bk: int, bn: int):
    """(kt, nt) bool: does the zero-padded (bk, bn) mask tile keep any
    weight? The survivor rule shared by the per-layer and stacked packs."""
    K, N = m.shape
    kt, nt = -(-K // bk), -(-N // bn)
    mp = F.pad(m.to(torch.int32), (0, nt * bn - N, 0, kt * bk - K))
    return mp.reshape(kt, bk, nt, bn).sum(dim=(1, 3)) > 0


def _quantize_and_compact(w, m, bk, bn, fta_project, maxb=None,
                          payload: str = "int8"):
    """Pad -> quantize -> compact one 2D layer. Returns (w_blocks, idx,
    nblocks, scales (1, Np), Kp, Np). ``maxb`` forces the slot count (a
    stack shares one); None uses this layer's own survivor maximum.
    Payload "int8" is the joint/bit artifact, "bf16" the raw surviving
    weights with unit scales (the value-only layout)."""
    alive = _tile_alive(m, bk, bn)                              # (kt, nt)
    K, N = w.shape
    w = F.pad(w, (0, (-N) % bn, 0, (-K) % bk))
    m = F.pad(m.to(torch.int32), (0, (-N) % bn, 0, (-K) % bk))
    Kp, Np = w.shape
    if payload == "int8":
        q, scales = quantize_int8_fta(w, m, fta_project=fta_project)
        q = q.to(torch.int8)
    elif payload == "bf16":
        q = (w.double() * m.double()).to(torch.bfloat16)
        scales = torch.ones((1, Np), dtype=torch.float32, device=w.device)
    else:
        raise ValueError(f"payload {payload!r} not in ('int8', 'bf16')")

    kt, nt = Kp // bk, Np // bn
    nblocks = alive.sum(dim=0).to(torch.int32)                  # (nt,)
    if maxb is None:
        maxb = max(int(nblocks.max()), 1)
    order, real = _compact_order(alive, maxb)
    idx = torch.where(real, order, torch.zeros_like(order)).to(torch.int32)
    tiles = q.reshape(kt, bk, nt, bn).permute(2, 0, 1, 3)        # (nt,kt,bk,bn)
    w_blocks = torch.gather(
        tiles, 1, order[:, :, None, None].expand(nt, maxb, bk, bn))
    # padded slots hold +0 (a product with 0 would keep a bf16 sign)
    w_blocks = torch.where(real[:, :, None, None], w_blocks,
                           torch.zeros((), dtype=w_blocks.dtype,
                                       device=w_blocks.device))
    return (w_blocks.contiguous(), idx, nblocks, scales.reshape(1, Np),
            Kp, Np)


def pack_joint_sparse(w_dense, mask=None, *, bk: int = BK, bn: int = BN,
                      value_sparsity: float = None,
                      fta_project: bool = True) -> JointPacked:
    """Full joint compilation of one (K, N) weight: prune (``mask``, or
    global tile pruning at ``value_sparsity``) -> INT8/FTA -> compact."""
    w = w_dense.float()
    K, N = w.shape
    if mask is None:
        m = (tile_prune_mask(w, value_sparsity, bk, bn) if value_sparsity
             else torch.ones((K, N), dtype=torch.int32, device=w.device))
    else:
        m = mask.to(torch.int32)
    w_blocks, idx, nblocks, scales, Kp, _ = _quantize_and_compact(
        w, m, bk, bn, fta_project)
    return JointPacked(w_blocks, idx, scales, nblocks, K, N, Kp)


def _balanced_mask(w, value_sparsity, bk: int, bn: int):
    """The stacked and grouped packs' mask of one (K, N) slice:
    column-balanced tile pruning at ``value_sparsity``, or every weight
    kept when it is 0 or None."""
    if value_sparsity:
        return tile_prune_mask_balanced(w, value_sparsity, bk, bn)
    return torch.ones(w.shape, dtype=torch.int32, device=w.device)


def balanced_maxb(K: int, value_sparsity, bk: int = BK) -> int:
    """MAXB of a stacked or grouped pack with no explicit masks, from the
    shape alone: column-balanced pruning keeps ``kt - round(vs * kt)``
    K-blocks in every N-tile column of every slice (``kt`` with no
    pruning), the keep count of ``tile_prune_mask_balanced``."""
    kt = -(-K // bk)
    if not value_sparsity:
        return kt
    return kt - min(int(round(value_sparsity * kt)), kt - 1)


def pack_joint_sparse_stacked(w_stack, masks=None, *, bk: int = BK,
                              bn: int = BN, value_sparsity: float = None,
                              fta_project: bool = True,
                              payload: str = "int8") -> JointPackedStacked:
    """Stack-uniform joint compilation of (L, K, N) layer weights: per layer
    column-balanced tile pruning (or the explicit ``masks``), INT8/FTA
    quantization and compaction into one shared MAXB (the max survivor
    count over every (layer, column); short layers pad with zero-payload
    slots). Payload "bf16" is the value-only layout. With no explicit
    masks MAXB follows from the shape (``balanced_maxb``) and the layers
    pack one at a time, in float32 one layer at a time."""
    if w_stack.ndim != 3 or not w_stack.shape[0]:
        raise ValueError(f"w_stack must be (L, K, N), got "
                         f"{tuple(w_stack.shape)}")
    L, K, N = w_stack.shape
    if masks is None:
        maxb = balanced_maxb(K, value_sparsity, bk)
        parts = [pack_joint_sparse_balanced(
                     w_stack[l], maxb, bk=bk, bn=bn,
                     value_sparsity=value_sparsity, fta_project=fta_project,
                     payload=payload) for l in range(L)]
        fields = [(p.w_blocks, p.idx, p.scales, p.nblocks) for p in parts]
        Kp = parts[0].k_pad
    else:
        w_stack = w_stack.float()
        ms = [masks[l].to(torch.int32) for l in range(L)]
        maxb = max(1, max(int(_tile_alive(ms[l], bk, bn).sum(dim=0).max())
                          for l in range(L)))
        parts = [_quantize_and_compact(w_stack[l], ms[l], bk, bn,
                                       fta_project, maxb=maxb,
                                       payload=payload) for l in range(L)]
        fields = [(p[0], p[1], p[3], p[2]) for p in parts]
        Kp = parts[0][4]
    return JointPackedStacked(*(torch.stack(f) for f in zip(*fields)),
                              K, N, Kp)


#: weights per column block of ``pack_joint_sparse_balanced``: its int64
#: and float64 temporaries stay near 1 GiB whatever the slice's width
PACK_BLOCK_ELEMS = 1 << 23


def pack_joint_sparse_balanced(w, maxb: int, *, bk: int = BK, bn: int = BN,
                               value_sparsity: float = None,
                               fta_project: bool = True,
                               payload: str = "int8") -> JointPacked:
    """One (K, N) slice of a stacked or grouped pack with no explicit
    masks, packed on its own at the pack's shared ``maxb``
    (``balanced_maxb``): byte for byte the slice the whole-stack pack
    makes, with only this slice in memory. Every step (balanced pruning
    within each N-tile column, the per-filter scale, FTA, compaction) is
    local to an N tile, so the slice packs in blocks of whole N tiles,
    ``PACK_BLOCK_ELEMS`` weights at a time."""
    K, N = w.shape
    cols = bn * max(1, PACK_BLOCK_ELEMS // (K * bn))
    parts = []
    for c0 in range(0, N, cols):
        blk = w[:, c0:c0 + cols].float()
        parts.append(_quantize_and_compact(
            blk, _balanced_mask(blk, value_sparsity, bk, bn), bk, bn,
            fta_project, maxb=maxb, payload=payload))
    w_blocks, idx, nblocks, scales = (
        torch.cat([p[i] for p in parts], dim=d)
        for i, d in ((0, 0), (1, 0), (2, 0), (3, 1)))
    return JointPacked(w_blocks, idx, scales, nblocks, K, N, parts[0][4])


class JointPackedGrouped(NamedTuple):
    """A grouped projection family (MoE experts): all L layers x E members
    packed with ONE shared MAXB over every (layer, member) pair. The
    JointPacked fields with leading (L, E) axes: ``w_blocks`` (L, E, NT,
    MAXB, bk, bn) int8 or bf16, ``idx`` (L, E, NT, MAXB) int32,
    ``scales`` (L, E, 1, N_pad) float32, ``nblocks`` (L, E, NT) int32."""
    w_blocks: torch.Tensor
    idx: torch.Tensor
    scales: torch.Tensor
    nblocks: torch.Tensor
    k: int
    n: int
    k_pad: int

    @property
    def maxb(self) -> int:
        return self.w_blocks.shape[3]


def pack_joint_sparse_grouped(w_group, masks=None, *, bk: int = BK,
                              bn: int = BN, value_sparsity: float = None,
                              fta_project: bool = True,
                              payload: str = "int8") -> JointPackedGrouped:
    """Group-uniform joint compilation of (L, E, K, N) expert weights: the
    stacked pack over the flattened (L * E) axis (per-slice balanced tile
    pruning or the explicit ``masks`` (L, E, K, N), one MAXB shared by
    every layer of every expert), then the (L, E) axes restored."""
    if w_group.ndim != 4 or not (w_group.shape[0] and w_group.shape[1]):
        raise ValueError(f"w_group must be (L, E, K, N), got "
                         f"{tuple(w_group.shape)}")
    L, E, K, N = w_group.shape
    flat_masks = None
    if masks is not None:
        flat_masks = torch.as_tensor(masks).reshape(L * E, K, N)
    flat = pack_joint_sparse_stacked(
        w_group.reshape(L * E, K, N), flat_masks, bk=bk, bn=bn,
        value_sparsity=value_sparsity, fta_project=fta_project,
        payload=payload)

    def regroup(a):
        return a.reshape((L, E) + tuple(a.shape[1:]))
    return JointPackedGrouped(
        regroup(flat.w_blocks), regroup(flat.idx), regroup(flat.scales),
        regroup(flat.nblocks), flat.k, flat.n, flat.k_pad)


def slice_joint_grouped(packed: JointPackedGrouped, l: int,
                        e: int) -> JointPacked:
    """Expert e of layer l as a per-projection JointPacked view."""
    return JointPacked(packed.w_blocks[l, e], packed.idx[l, e],
                       packed.scales[l, e], packed.nblocks[l, e],
                       packed.k, packed.n, packed.k_pad)


def unpack_joint_sparse_grouped(packed: JointPackedGrouped):
    """Invert pack_joint_sparse_grouped -> dense float32 (L, E, K, N)."""
    L, E = packed.w_blocks.shape[:2]
    return torch.stack([
        torch.stack([unpack_joint_sparse(slice_joint_grouped(packed, l, e))
                     for e in range(E)]) for l in range(L)])


def slice_joint_stacked(packed: JointPackedStacked, l: int) -> JointPacked:
    """Layer l's view of a stacked pack."""
    return JointPacked(packed.w_blocks[l], packed.idx[l], packed.scales[l],
                       packed.nblocks[l], packed.k, packed.n, packed.k_pad)


def unpack_joint_sparse(packed: JointPacked):
    """Invert pack_joint_sparse -> dense float32 (K, N) == q * mask * scale,
    for int8 and bf16 payloads alike."""
    wb = packed.w_blocks.float()
    nt, maxb, bk, bn = wb.shape
    dense = torch.zeros((packed.k_pad // bk, bk, nt, bn), dtype=torch.float32,
                        device=wb.device)
    real = (torch.arange(maxb, device=wb.device)[None, :]
            < packed.nblocks.to(wb.device)[:, None])
    ns, bs = real.nonzero(as_tuple=True)
    dense[packed.idx[ns, bs].long(), :, ns, :] = wb[ns, bs]
    dense = dense.reshape(packed.k_pad, nt * bn) * packed.scales
    return dense[:packed.k, :packed.n]


def unpack_joint_sparse_stacked(packed: JointPackedStacked):
    """Invert pack_joint_sparse_stacked -> dense float32 (L, K, N)."""
    return torch.stack([unpack_joint_sparse(slice_joint_stacked(packed, l))
                        for l in range(packed.w_blocks.shape[0])])


def joint_storage_bytes(packed) -> int:
    """Device bytes of a joint artifact as the JAX package counts them
    (payload elements + 4-byte index + 4-byte scales); JointPacked,
    JointPackedStacked or JointPackedGrouped."""
    return int(packed.w_blocks.numel() + packed.idx.numel() * 4
               + packed.scales.numel() * 4)


def pick_row_tile(m: int, dtype) -> int:
    """The TPU kernel's row tile (full 128-row tiles for big batches, the
    smallest sublane multiple for small ones). The CUDA kernel masks
    ragged M itself and takes no row tile; kept so tests can pin it
    against the JAX rule."""
    if m >= BM:
        return BM
    sub = 8 if dtype.itemsize >= 4 else 16
    return max(sub, sub * (-(-m // sub)))


def joint_dense(x, packed: JointPacked):
    """Joint value x bit sparse y = x @ W for (..., K) activations. Pads K
    to the packed K with zeros (padded columns meet only pruned weight
    rows) and slices N back; M needs no padding."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    K = x2.shape[1]
    if K != packed.k:
        raise ValueError(f"activation K={K} != packed k={packed.k}")
    if packed.k_pad != K:
        x2 = F.pad(x2, (0, packed.k_pad - K))
    y = joint_sparse_matmul(x2.contiguous(), packed.w_blocks, packed.idx,
                            packed.scales)
    return y[:, :packed.n].reshape(shape[:-1] + (packed.n,))
