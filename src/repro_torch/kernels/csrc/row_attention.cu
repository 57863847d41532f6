// Row-stable masked GQA attention for Hopper (sm_90a): the serving path's
// attention against a contiguous KV cache.
//
// Replaces no TPU kernel: the reference computes this with plain jnp
// einsums (`_sdpa`, src/repro/models/attention.py). The port runs it in a
// kernel of its own so that a 1-token decode and a C-token prefill chunk
// give every query bitwise the same output: a batched matmul and torch's
// softmax pick their summation order from the whole shape, so the two
// paths would part in the last bits. Same function as the reference:
//
//   l[j]   = cast_T( sum_d q[d] * k[j, d] ) * scale      (fp32 sum)
//   l[j]   = -1e30 where j > qpos or j <= qpos - window  (causal mask,
//                                                        sliding window)
//   p[j]   = cast_T( softmax(l)[j] )                     (fp32 softmax)
//   out[d] = cast_T( sum_j p[j] * v[j, d] )              (fp32 sum)
//
// q (B, Sq, Hq, hd), contiguous; k, v (B, A, Hkv, hd), each batch row
// contiguous (any batch stride); qpos (B, Sq) int32, the query's position
// in the cache; out (B, Sq, Hq, hd) in q's dtype. Query head h reads KV
// head h / (Hq / Hkv), as the reference's repeat of the KV heads does.
// Keys past qpos add exp(-1e30 - max) = 0 to the softmax and 0 * v to the
// output; they are skipped. So are keys at or below qpos - window when
// window > 0 (0: no lower bound), the reference's sliding-window mask
// `kpos > qpos - window`. A row's live keys are [lo, n): lo = max(0, qpos -
// window + 1), n = min(qpos, A - 1) + 1. A row with none (a negative qpos,
// or lo >= n) masks every key, and the softmax then spreads evenly over
// all A of them, as the reference's does.
//
// The row bound. An optional nq (B,) int32, read on the device (so one
// captured graph serves every value), bounds the queries computed per batch
// row: query s of row b is computed only if s < nq[b], and the queries at
// or past it come out as exact zeros (finite, whatever the cache holds). A
// null nq computes every query. The serving engine's chunk call passes each
// slot's valid tokens, so its padding rows cost next to nothing:
//   * bf16: a block whose 16 rows all lie past the bound stores its zeros
//     and returns before any K/V load, dead-key scan or cluster barrier.
//     Every rank of a cluster holds the same (row block, KV head, batch
//     row), so all of them return together, before the first
//     cluster.sync(), and none waits on a partner that left. In a block
//     that is partly past the bound those rows join as the rows past the
//     call's do (no live key), so they add nothing to the block's key range
//     [first, live), and the stores write zeros for them. Computed tiles:
//     sum_b ceil(nq[b] G / 16) Hkv.
//   * f32: a block is one (query, head): past the bound it stores zeros and
//     returns.
// The launch shape does not depend on nq, and a query below the bound
// comes out bitwise what it is without one (the row-stability argument
// below: it never depended on the other rows of its tile), NaN columns
// from dead non-finite V values included.
//
// Dead keys and non-finite values. The reference multiplies every dead
// key's v by its zero probability, and 0 * NaN = 0 * Inf = NaN: a
// non-finite v[j, d] at a dead key j makes column d of the row's output
// NaN. A dead k stays hidden (its logit is replaced by the mask). So the
// kernels read the V rows they skip without adding them: each block takes
// the columns in which a skipped row holds a non-finite value and writes
// NaN there. A finite output is bitwise what it is without the check, and
// the live keys' sums keep their order.
//
// Bound. At the serving shapes the work is small: a decode call reads each
// live K/V row once per KV head (0.2 us of HBM time at batch 4), a 64-query
// chunk does ~0.27 GFLOP. A launch is bound by latency: load round trips,
// barriers, and the exact softmax's exp and divide per (row, key), which
// one warp runs as a serial chain. At long context (A = 2048, 256-query
// chunks) the products and the K/V traffic per 16-row block dominate.
//
// Design, bf16 (tensor cores, mma.sync m16n8k16; wgmma needs 64-row tiles,
// and a decode call has 8 rows per KV head):
//   * A block is one MMA tile of 16 rows, (query, head) pairs of one KV
//     head's group, flat index s * G + g (G = Hq / Hkv): at G = 8 two
//     queries of eight heads, so each K/V tile it loads (64 keys, 16-byte
//     cp.async into padded shared rows, two stages) serves every head of
//     the group. Its four warps split every key tile: warp w takes keys
//     16 w .. 16 w + 15, so a decode call's 8 rows keep four warps busy.
//   * Keys split further over a thread-block cluster of `splits` blocks (a
//     power of two <= 8 with at least 8 key tiles a rank, from A alone:
//     one block up to A = 960, 4 at A = 2048); rank r takes key tiles
//     [r TR, (r+1) TR), each tile at absolute cache positions t*64 ..
//     t*64+63. Ranks past the block's live keys do no work and send
//     nothing; the others skip them (their sums are exact zeros).
//   * Pass 1: S = Q K^T on the tensor cores, l = bf16(S) * scale (the
//     reference's einsum output and its scaling) kept in shared memory as
//     fp32; row maxima over live keys, warps then ranks (max is exact in
//     any order; ranks through distributed shared memory).
//   * Pass 2: e = exp(l - max), kept in place of l; row sums: thread
//     (lane & 3) adds its keys (== 2 (lane & 3), +1 mod 8) in key order, a
//     quad butterfly adds the four, the warps are added in order, the
//     ranks in rank order. Rows r and r + 8 of the tile take the same path.
//   * Pass 3: p = bf16(e / sum) (the quotient correctly rounded, from the
//     row's reciprocal and one exact-remainder correction) straight into
//     the A fragment, 0 for a dead key; P V on the tensor cores over the
//     warp's keys of the rank's tiles in order. The warps' partials are
//     added in warp order; with a split each rank pushes its partial into
//     the owner rank's park (distributed shared memory, float4), one
//     cluster barrier, and the owner adds them in rank order.
//   Every order is fixed by absolute key positions and by (A, hd, Hq/Hkv):
//   the tile shape, split count and load path never depend on Sq, B or
//   qpos. A row's dead keys add exact zeros (a zero probability times a
//   finite v leaves an MMA accumulator as it was), so the row comes out the
//   same whichever rows share its tile and call.
//   * The window. A block works on the key tiles [first, live) that hold a
//     live key of one of its rows; tiles below every row's lower bound are
//     skipped, and so are the cluster ranks that hold only such tiles (the
//     ranks' partials are then added from the first live rank on). A
//     skipped tile, or a skipped rank, would only have added exact zeros
//     to each of the block's rows for finite values: every live key is
//     added at the same place in the same order as without the skip, and
//     with window 0 the kernel is the one without a window. The f32
//     kernels mask instead: a key below the bound gets a -inf logit, so
//     its probability is an exact zero and the sums see the same live
//     terms in the same order.
//   * Dead keys' non-finite values. Inside the tiles a block multiplies, a
//     dead key's zero probability meets its v in the MMA, which gives NaN
//     for a non-finite v as the reference's product does. The V rows of
//     the rank's tiles it skips are read once (16-byte loads, eight in
//     flight a thread, overlapping the first K tiles' arrival), their
//     non-finite columns OR-ed into a bit mask in every rank of the
//     cluster (distributed shared memory), and the stores write NaN in
//     those columns. Every skipped key is dead for every row of the block,
//     so one mask serves the block. The f32 kernels add 0 * v for the rows
//     past n, after the live keys.
//
// Caches whose logits do not fit a block's shared memory take streaming
// kernels of their own (chosen from (A, hd) alone): they recompute the
// logits in each pass instead of keeping them, with the same sums in the
// same orders (below).
//
// f32 keeps exact fp32 on the CUDA cores (TF32 would break the 1e-5
// contract): one block of four warps per (query, head), lanes over the
// head dims, the logits in shared memory, orders fixed by hd alone.
//
// Backward (the training path's gradient; the reference differentiates
// its jnp einsums with XLA). Two kernels with the forward's live-key rule
// (qpos, window), no float atomics, every sum in an order fixed by the
// shapes and key positions, so two launches on the same inputs give the
// same bits. The logit is the forward's: l = bf16(q . k) * scale. A row
// with no live key (its softmax spreads evenly over all A keys and ignores
// q and k) gives dQ = 0 and adds (1 / A)_T dO to every dV row.
//
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulators), tiles laid
// out as the forward's: 16 rows of (query, head) pairs of one KV head's
// group, flat index s * G + g, so each K/V tile serves the whole group.
//   attention_bwd_dq_tc_kernel (a), a block per 16-row tile, four warps
//     splitting every 64-key tile (16 keys each), K (pass 1) and K and V
//     (pass 2) tiles through a two-stage cp.async ring, Q and dO as A
//     fragments (registers up to hd 128, shared memory at 256). D = dO . O
//     per row (lanes over the head dims, then an xor butterfly). Pass 1:
//     S = Q K^T, l, the row's max and exp-sum over its live keys, each
//     thread online over its keys tile by tile, then the quad, then the
//     warps in order: lse = max + log(sum). Pass 2: S and dP = dO V^T again,
//     p = exp(l - lse), dS = p (dP - D), selected to exactly 0 at a dead key,
//     then bf16(dS * scale) (the reference rounds its logit gradient to
//     bf16 before its dq einsum) as an A fragment and dQ += dS K with K
//     read by ldmatrix.trans; the warps' dQ added in warp order.
//   attention_bwd_dkv_tc_kernel (b), a block per 16 keys of one (batch, KV
//     head) (and one half of the head dims at hd 256, so that a warp's dK
//     and dV accumulators stay 2 x 16 x 128 fp32), K and V tiles in shared
//     memory, and W warps (8 up to hd 128, 4 at 256: their stages must fit).
//     Warp w walks the row tiles w, w + W, ... in order that hold a row whose
//     live keys meet the block's (or a row with none: the even softmax
//     reaches every key); a skipped tile adds exact zeros. Each warp stages
//     its tiles' Q, dO, lse, D and positions through a two-stage cp.async
//     ring of its own. S^T = K Q^T and dP^T = V dO^T come out of the
//     accumulators already in A-fragment layout (the FlashAttention-2
//     trick): P^T = bf16(exp(l - lse)) (the reference's probabilities),
//     dS^T = bf16(p (dP - D) * scale), both selected to 0 at a dead pair,
//     then dV += P^T dO and dK += dS^T Q with dO and Q read transposed. The
//     warps' partial dK and dV are added in shared memory in warp order.
//   Every launch shape comes from (A, hd, Hq / Hkv) alone.
// f32: exact fp32 on the CUDA cores (TF32 would break the 1e-5 contract),
// as the forward keeps its own f32 kernels:
//   attention_bwd_dq_kernel, one warp per (batch, query, head): D, the row's
//     max and sum over its live keys (each lane its keys in order, online,
//     then an xor butterfly), then per tile of 32 keys (a lane a key) p,
//     dp = dO . v_j, ds = p (dp - D) and dQ = scale * sum_j ds_j k_j with
//     lanes over the head dims, the tile's keys in order.
//   attention_bwd_dkv_kernel, one warp per (batch, key, KV head): over the
//     group's heads in order, the queries in tiles of 32 (a lane a query),
//     those whose live keys hold this key recompute l and p from the saved
//     lse, and dV += p dO, dK += scale * ds q, lanes over the head dims.
//
// Dead keys and non-finite values. The reference's own autograd gives NaN
// in every row's dq column d for a non-finite k[j, d] at any key, and in
// dk / dv through 0 * NaN as well. The f32 kernels do not read dead keys:
// nothing of a dead K or V row reaches the gradients. The bf16 kernels
// multiply whole tiles that mix live and dead keys, and select the dead
// pairs' p and dS to exact zeros, so:
//   * a non-finite value in a dead V row reaches nothing;
//   * a non-finite k[j, d] at a dead key j makes column d of dQ NaN in
//     every row of each 16-row block of kernel (a) whose key tiles hold j
//     (the 64-key tiles from the one holding the block's lowest live key
//     through the one holding its highest), as 0 * k[j, d] in dS K;
//   * dK and dV of a key that is dead for every row are exact zeros (plus
//     the even softmax's (1 / A)_T dO in dV for rows with no live key);
//   * every other gradient value is bitwise what it is without them.
// The training path's keys are the sequence's own.
//
// Bound, at tinyllama's training shape (B 8, S 128, 32 / 4 heads of 64,
// bf16): bytes, each input read once and each output written once, 5.4 us
// a launch of (a) (q, out, dout, dq, k, v, lse and D) and 3.2 us of (b)
// (q, dout, k, v, dk, dv, lse and D) at 3.35 TB/s; operations, 6 hd and
// 8 hd per live (query, key) pair as chip_smoke.py's times phase counts
// them: 0.82 and 1.09 us at 989 TFLOP/s. So both are bound by bytes; what they
// pay for beyond it is latency (a few tiles a block, loads, barriers) and
// the tiles' dead halves on the causal diagonal.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

enum DType { F32 = 0, BF16 = 1 };

constexpr int SMEM_MAX = 232448;          // a block's shared memory on H100

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int BK = 64;                    // keys per tile
constexpr int ROWS = 16;                  // (query, head) rows per block: one MMA tile
constexpr int WARPS = 4;                  // each takes 16 keys of every tile
constexpr int KW = BK / WARPS;
constexpr int NT = 32 * WARPS;
constexpr int MAX_SPLITS = 8;             // portable cluster size
constexpr int MIN_TILES_PER_RANK = 8;     // key tiles a cluster rank takes at least

// the head dim padded to an MMA-friendly width (zeros in q and k past hd)
__host__ __device__ __forceinline__ int pad_hd(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// The launch shape: a function of (A, hd) alone.
struct Plan {
  int hdp, splits, tiles_per_rank;
  bool stream;                            // the logits do not fit: attention_stream_kernel
  size_t smem;
};

// Shared memory before the K/V stages: the queries (ROWS x (hdp + 8)
// bf16), and with a split the park of the combine (ROWS x hdp fp32) over
// the same bytes.
__host__ __device__ __forceinline__ int front_bytes(int hdp, int splits) {
  const int q = ROWS * (hdp + 8) * 2, park = splits > 1 ? ROWS * hdp * 4 : 0;
  return q > park ? q : park;
}

// Then two K/V stages and the fp32 logits of the rank's keys, whose room
// holds the warps' partial outputs once both are dead.
__host__ __device__ __forceinline__ int body_bytes(int hdp, int tiles_per_rank) {
  const int live = 2 * BK * (hdp + 8) * 2 + ROWS * (tiles_per_rank * BK + 8) * 4;
  const int outs = WARPS * ROWS * hdp * 4;
  return live > outs ? live : outs;
}

// The streaming kernel's shared memory: the queries beside the park (it
// reads them until its last product, while other ranks may already push
// into the park), then four K/V stages, whose room holds the warps'
// partial outputs at the end, and the row stats.
constexpr int STREAM_STAGES = 4;          // K/V stages

__host__ __device__ __forceinline__ int stream_front_bytes(int hdp, int splits) {
  return ROWS * (hdp + 8) * 2 + (splits > 1 ? ROWS * hdp * 4 : 0);
}

__host__ __device__ __forceinline__ int stream_body_bytes(int hdp) {
  const int live = STREAM_STAGES * BK * (hdp + 8) * 2, outs = WARPS * ROWS * hdp * 4;
  return live > outs ? live : outs;
}

__host__ Plan plan(int A, int hd) {
  Plan p;
  p.hdp = pad_hd(hd);
  const int tiles = (A + BK - 1) / BK;
  int c = 1;
  while (2 * c <= MAX_SPLITS && 2 * c * MIN_TILES_PER_RANK <= tiles) c *= 2;
  p.splits = c;
  p.tiles_per_rank = (tiles + c - 1) / c;
  p.smem = static_cast<size_t>(front_bytes(p.hdp, c)) + body_bytes(p.hdp, p.tiles_per_rank) +
           (6 + WARPS) * ROWS * 4;                                // row stats
  p.stream = p.smem > SMEM_MAX;
  if (p.stream)
    p.smem = static_cast<size_t>(stream_front_bytes(p.hdp, c)) + stream_body_bytes(p.hdp) +
             (6 + WARPS) * ROWS * 4;
  return p;
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* qpos;
  const int32_t* nq;                      // (B,) queries computed per batch row; null: all
  __nv_bfloat16* out;
  long long k_bstride, v_bstride;
  int Sq, Hq, Hkv, G, A, hd, window, row_blocks, tiles_per_rank, splits, vec;
  float scale;
};

// The queries of batch row b that are computed: [0, bound)
__device__ __forceinline__ int row_bound(const int32_t* nq, int b, int Sq) {
  return nq ? min(Sq, max(0, nq[b])) : Sq;
}

// A block of 16 rows all at or past the bound: each cluster rank stores its
// share of the block's zeros (its (query, head) rows below Sq). The caller
// returns next, before any load or barrier.
__device__ __forceinline__ void store_zero_rows(const Args& a, int rb, int hk, int b, int rank,
                                               int tid) {
  const int hd = a.hd;
  for (int e = rank * NT + tid; e < ROWS * hd; e += a.splits * NT) {
    const int r = e / hd, f = rb * ROWS + r, s = f / a.G, g = f - s * a.G;
    if (s < a.Sq)
      a.out[((static_cast<size_t>(b) * a.Sq + s) * a.Hq + hk * a.G + g) * hd + (e - r * hd)] =
          __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(tc::smem_addr(p)));
}

// d += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [row0, row0 + R) of a (A, row_stride) bf16 array into shared rows
// of stride LD, columns [0, hd), by NTH threads; rows past A are zeros.
// 16-byte cp.async when every row is 16-byte aligned, else element by
// element: the rows hold the same values either way. No commit.
template <int LD, int R, int NTH>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int A, int hd,
                                          bool vec, int tid) {
  if (vec) {
    const int chunks = hd / 8;
    for (int e = tid; e < R * chunks; e += NTH) {
      const int r = e / chunks, c = (e - r * chunks) * 8;
      __nv_bfloat16* d = dst + r * LD + c;
      if (row0 + r < A)
        tc::cp_async16(d, src + (row0 + r) * row_stride + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = tid; e < R * hd; e += NTH) {
      const int r = e / hd, c = e - r * hd;
      dst[r * LD + c] = row0 + r < A ? src[(row0 + r) * row_stride + c] : __float2bfloat16(0.f);
    }
  }
}

// A stage of BK rows by the block's NT threads, committed as one group
template <int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int A, int hd,
                                          bool vec, int tid) {
  copy_rows<LD, BK, NT>(dst, src, row_stride, row0, A, hd, vec, tid);
  tc::cp_async_commit();
}

// l = bf16(s) * scale for two neighbouring keys (-1e30 when all masked)
__device__ __forceinline__ float2 logits(float s0, float s1, bool none, float scale) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(s0, s1);
  return none ? make_float2(-1e30f, -1e30f)
              : make_float2(__fmul_rn(__low2float(h), scale), __fmul_rn(__high2float(h), scale));
}

// e / sum from the row's rounded reciprocal r = 1 / sum: q = e r, then one
// correction with the exact remainder e - q sum. By Markstein's theorem
// the result is the correctly rounded quotient whenever it is a normal
// float (e <= 1 and sum >= 1 rule out overflow); only quotients below
// 2^-126 may differ from IEEE division, in their last subnormal bit.
__device__ __forceinline__ float quotient(float e, float sum, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, sum, e), r, q);
}

// The live keys [lo, n) of a query at position pos in a cache of A rows
// (window 0: no lower bound); a query with none masks every key, and then
// takes all A of them with lo = -1 (its logits are all -1e30).
__device__ __forceinline__ void live_keys(int pos, int A, int window, int& lo, int& n) {
  n = min(pos, A - 1) + 1;
  lo = window > 0 ? max(0, pos - window + 1) : 0;
  if (pos < 0 || lo >= n) {
    n = A;
    lo = -1;
  }
}

__device__ __forceinline__ bool is_live(int key, int lo, int n) { return key >= lo && key < n; }

// bf16(e / sum) of two neighbouring keys at e, 0 for a dead key, packed
// as an A-fragment register
__device__ __forceinline__ uint32_t probs(const float* e, int key, int lo, int n, float sum,
                                          float r) {
  if (key >= n || key + 1 < lo) return 0u;
  const float2 v = *reinterpret_cast<const float2*>(e);
  return pack_bf16(key >= lo ? quotient(v.x, sum, r) : 0.f,
                   is_live(key + 1, lo, n) ? quotient(v.y, sum, r) : 0.f);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Bit i set when bf16 i of the eight in x (little-endian, element 0 in the
// low half of x.x) is Inf or NaN: its exponent is all ones.
__device__ __forceinline__ uint32_t nonfinite2(uint32_t x) {
  return ((x & 0x7f80u) == 0x7f80u ? 1u : 0u) | ((x & 0x7f800000u) == 0x7f800000u ? 2u : 0u);
}
__device__ __forceinline__ uint32_t nonfinite8(const uint4& x) {
  return nonfinite2(x.x) | nonfinite2(x.y) << 2 | nonfinite2(x.z) << 4 | nonfinite2(x.w) << 6;
}

// Eight bf16 at src (cols of them real, zeros past), one 16-byte load when
// the row is aligned and whole
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, int cols, bool vec) {
  if (vec && cols == 8) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < cols) w[i >> 1] |= static_cast<uint32_t>(h[i]) << (16 * (i & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The non-finite columns of V rows [k0, k1) (row stride `stride`, hd
// columns): thread tid reads the column chunk c = tid % (HDP / 8), columns
// 8c .. 8c + 7, of every (NT / (HDP / 8))-th row, eight rows in flight, and
// returns bit i set when column 8c + i is non-finite in one of them.
template <int HDP>
__device__ __forceinline__ uint32_t dead_nonfinite(const __nv_bfloat16* vb, long long stride,
                                                   int k0, int k1, int hd, bool vec, int tid) {
  constexpr int CH = HDP / 8, STEP = NT / CH, U = 8;
  const int c = tid % CH, cols = min(8, hd - 8 * c);
  uint32_t bad = 0;
  if (cols <= 0) return 0;
  for (int k = k0 + tid / CH; k < k1; k += U * STEP) {
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = k + u * STEP;
      x[u] = kk < k1 ? load8(vb + kk * stride + 8 * c, cols, vec) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) bad |= nonfinite8(x[u]);
  }
  return bad;
}

// The V rows of the rank's key tiles [t0, t1) that it does not multiply:
// all of them when it has no live tile, else those outside [ts, ts +
// ntiles)
template <int HDP>
__device__ __forceinline__ uint32_t skipped_nonfinite(const __nv_bfloat16* vb, long long stride,
                                                      int t0, int t1, int ts, int ntiles, int A,
                                                      int hd, bool vec, int tid) {
  const int end = min(A, t1 * BK);
  if (ntiles <= 0) return dead_nonfinite<HDP>(vb, stride, t0 * BK, end, hd, vec, tid);
  return dead_nonfinite<HDP>(vb, stride, t0 * BK, ts * BK, hd, vec, tid) |
         dead_nonfinite<HDP>(vb, stride, (ts + ntiles) * BK, end, hd, vec, tid);
}

// OR a thread's mask of dead_nonfinite into the block's column mask, in
// every rank of the cluster
template <int HDP>
__device__ __forceinline__ void publish_nonfinite(uint32_t bad, uint32_t* mask, int C, int tid,
                                                  cooperative_groups::cluster_group& cluster) {
  if (!bad) return;
  const int col = 8 * (tid % (HDP / 8));
  uint32_t* w = mask + (col >> 5);
  const uint32_t bits = bad << (col & 31);
  if (C == 1) {
    atomicOr(w, bits);
    return;
  }
  for (int r = 0; r < C; ++r) atomicOr(cluster.map_shared_rank(w, r), bits);
}

// Column col of the output is NaN: a dead key's v there is non-finite
__device__ __forceinline__ bool nan_column(const uint32_t* mask, int col) {
  return (mask[col >> 5] >> (col & 31)) & 1u;
}

template <int HDP>
__global__ void __launch_bounds__(NT, HDP <= 64 ? 4 : 1) attention_tc_kernel(const Args a) {
  constexpr int LD = HDP + 8;             // padded rows: conflict-free ldmatrix
  constexpr int KS = HDP / 16;            // MMA steps over the head dim
  constexpr int NO = HDP / 8;             // n8 tiles of the output
  constexpr int STAGE = BK * LD;          // bf16 elements of a K/V stage
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = a.splits, TR = a.tiles_per_rank, lld = TR * BK + 8;
  // the queries, dead once in registers, share their room with the park
  // the other ranks push their partial outputs into
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* park = reinterpret_cast<float4*>(smem);
  uint8_t* body = smem + front_bytes(HDP, C);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(body);  // two K/V stages
  float* ls = reinterpret_cast<float*>(ring + 2 * STAGE);       // ROWS x lld logits
  float4* ocomb = reinterpret_cast<float4*>(body);  // after pass 3: the warps' outputs
  int* rown = reinterpret_cast<int*>(body + body_bytes(HDP, TR));
  int* rlo = rown + ROWS;
  float* wred = reinterpret_cast<float*>(rlo + ROWS);           // WARPS x ROWS
  float* pmax = wred + WARPS * ROWS;
  float* psum = pmax + ROWS;
  float* gmax = psum + ROWS;
  float* gsum = gmax + ROWS;
  // rown and rlo are dead once read into registers: their room holds the
  // column mask of non-finite dead V values, zeroed after pass 1
  uint32_t* nanmask = reinterpret_cast<uint32_t*>(rown);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int rank = blockIdx.z;
  const int rb = blockIdx.x % a.row_blocks, hk = blockIdx.x / a.row_blocks, b = blockIdx.y;
  const int A = a.A, G = a.G, Sq = a.Sq, hd = a.hd;
  const bool vec = a.vec != 0;
  const int sb = row_bound(a.nq, b, Sq);  // queries [sb, Sq) are zeros
  if (rb * ROWS / G >= sb) {              // the same in every rank
    store_zero_rows(a, rb, hk, b, rank, tid);
    return;
  }

  // each row's live keys [max(rlo, 0), rown): none for rows past the
  // call's or the bound, all A (rlo = -1) when all are masked
  if (tid < ROWS) {
    const int s = (rb * ROWS + tid) / G;
    int n = 0, lo = 0;
    if (s < sb) live_keys(a.qpos[b * Sq + s], A, a.window, lo, n);
    rown[tid] = n;
    rlo[tid] = lo;
  }
  // the stages' columns past hd stay zero (loads write [0, hd) only)
  if (hd < HDP)
    for (int e = tid; e < 2 * BK * (HDP - hd); e += NT) {
      const int r = e / (HDP - hd);
      ring[r * LD + hd + (e - r * (HDP - hd))] = __float2bfloat16(0.f);
    }
  __syncthreads();

  int bn = 0, blo = A;                    // live keys of the block's rows
  for (int r = 0; r < ROWS; ++r)
    if (rown[r] > 0) {
      bn = max(bn, rown[r]);
      blo = min(blo, max(rlo[r], 0));
    }
  // key tiles [first, live) hold a live key of the block; the ranks [L0,
  // L) hold one of them (the same in every rank: the rows are the same);
  // the rank's live tiles start at ts
  const int T = (A + BK - 1) / BK, t0 = rank * TR, t1 = min(T, t0 + TR);
  const int live = (bn + BK - 1) / BK, first = min(blo, bn) / BK;
  const int L0 = first / TR, L = min(C, (live + TR - 1) / TR);
  const int ts = max(t0, first), ntiles = max(0, min(t1, live) - ts);
  const int r0 = gq, r1 = gq + 8;
  const int n0 = rown[r0], n1 = rown[r1];
  const int lo0 = max(rlo[r0], 0), lo1 = max(rlo[r1], 0);
  const bool none0 = rlo[r0] < 0, none1 = rlo[r1] < 0;
  const int kw = warp * KW;               // the warp's keys in every tile

  const long long kv_stride = static_cast<long long>(a.Hkv) * hd;
  const __nv_bfloat16* kb = a.k + b * a.k_bstride + static_cast<size_t>(hk) * hd;
  const __nv_bfloat16* vb = a.v + b * a.v_bstride + static_cast<size_t>(hk) * hd;
  // the rank's K tiles, then its V tiles, stream through two stages: stream
  // tile i sits in stage i & 1, and i + 2 loads once i is done
  auto issue = [&](int i) {
    if (i >= 2 * ntiles) return;
    const bool is_v = i >= ntiles;
    load_rows<LD>(ring + (i & 1) * STAGE, is_v ? vb : kb, kv_stride,
                  (ts + (is_v ? i - ntiles : i)) * BK, A, hd, vec, tid);
  };
  auto wait = [&](int i) {
    if (i + 1 < 2 * ntiles)
      tc::cp_async_wait<1>();
    else
      tc::cp_async_wait<0>();
    __syncthreads();
  };
  if (ntiles > 0) {
    // the block's queries (zeros past hd and past the call's rows or the
    // bound) arrive with the first K tile
    for (int e = tid; e < ROWS * (HDP / 8); e += NT) {
      const int r = e / (HDP / 8), c = (e - r * (HDP / 8)) * 8;
      const int f = rb * ROWS + r, s = f / G, g = f - s * G;
      __nv_bfloat16* d = qs + r * LD + c;
      const __nv_bfloat16* src =
          a.q + ((static_cast<size_t>(b) * Sq + s) * a.Hq + hk * G + g) * hd + c;
      if (s < sb && vec && c + 8 <= hd) {
        tc::cp_async16(d, src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d[i] = s < sb && c + i < hd ? src[i] : __float2bfloat16(0.f);
      }
    }
    issue(0);
    issue(1);
  }
  const uint32_t bad =
      skipped_nonfinite<HDP>(vb, kv_stride, t0, t1, ts, ntiles, A, hd, vec, tid);

  // ---- pass 1: logits l = bf16(q.k) * scale of the warp's keys of the
  // rank's live tiles (fp32 in shared memory), row maxima
  float m0 = -INFINITY, m1 = -INFINITY;
  {
    uint32_t qa[KS][4];
    for (int i = 0; i < ntiles; ++i) {
      wait(i);
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qa[kk], qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + kk * 16 +
                              (lane >> 4) * 8);
      }
      const __nv_bfloat16* kt = ring + (i & 1) * STAGE;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bf[4];
        ldsm_x4(bf, kt + (kw + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[0], qa[kk], bf[0], bf[1]);
        mma_bf16(s[1], qa[kk], bf[2], bf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = i * BK + kw + j * 8 + 2 * cq, key = ts * BK + kc;
        const float2 l0 = logits(s[j][0], s[j][1], none0, a.scale);
        const float2 l1 = logits(s[j][2], s[j][3], none1, a.scale);
        *reinterpret_cast<float2*>(ls + r0 * lld + kc) = l0;
        *reinterpret_cast<float2*>(ls + r1 * lld + kc) = l1;
        if (is_live(key, lo0, n0)) m0 = fmaxf(m0, l0.x);
        if (is_live(key + 1, lo0, n0)) m0 = fmaxf(m0, l0.y);
        if (is_live(key, lo1, n1)) m1 = fmaxf(m1, l1.x);
        if (is_live(key + 1, lo1, n1)) m1 = fmaxf(m1, l1.y);
      }
      __syncthreads();                    // the stage is free to refill
      issue(i + 2);
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  if (cq == 0) {
    wred[warp * ROWS + r0] = m0;
    wred[warp * ROWS + r1] = m1;
  }
  __syncthreads();
  if (tid < (HDP + 31) / 32) nanmask[tid] = 0u;
  if (tid < ROWS) {
    float m = wred[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, wred[w * ROWS + tid]);
    pmax[tid] = m;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (C > 1) cluster.sync(); else __syncthreads();
  publish_nonfinite<HDP>(bad, nanmask, C, tid, cluster);
  if (tid < ROWS && ntiles > 0) {
    float m = pmax[tid];
    for (int r = L0; r < L; ++r)
      if (r != rank) m = fmaxf(m, *cluster.map_shared_rank(pmax + tid, r));
    gmax[tid] = m;
  }
  __syncthreads();

  // ---- pass 2: e = exp(l - max), kept in place of l; row sums: each
  // thread's keys in key order (a row's tiles past its live keys skipped:
  // they add nothing), the quad, the warps in order, the ranks in order
  const float M0 = gmax[r0], M1 = gmax[r1];
  auto row_sum = [&](int row, int lo, int n, float m) {
    float sum = 0.f;
    for (int i = 0; i < ntiles && (ts + i) * BK < n; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = i * BK + kw + j * 8 + 2 * cq, key = ts * BK + kc;
        float2* p = reinterpret_cast<float2*>(ls + row * lld + kc);
        float2 e = *p;
        e.x = expf(__fsub_rn(e.x, m));
        e.y = expf(__fsub_rn(e.y, m));
        *p = e;
        if (is_live(key, lo, n)) sum += e.x;
        if (is_live(key + 1, lo, n)) sum += e.y;
      }
    return quad_sum(sum);
  };
  const float s0 = row_sum(r0, lo0, n0, M0), s1 = row_sum(r1, lo1, n1, M1);
  __syncthreads();                        // wred is read: reuse it
  if (cq == 0) {
    wred[warp * ROWS + r0] = s0;
    wred[warp * ROWS + r1] = s1;
  }
  __syncthreads();
  if (tid < ROWS) {
    float s = wred[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += wred[w * ROWS + tid];
    psum[tid] = s;
  }
  if (C > 1) cluster.sync(); else __syncthreads();
  if (tid < ROWS && ntiles > 0) {
    float s = rank == L0 ? psum[tid] : *cluster.map_shared_rank(psum + tid, L0);
    for (int r = L0 + 1; r < L; ++r)
      s += r == rank ? psum[tid] : *cluster.map_shared_rank(psum + tid, r);
    gsum[tid] = s;
  }
  __syncthreads();

  // ---- pass 3: p = bf16(e / sum), 0 for a dead key; P V over the warp's
  // keys of the rank's tiles in order
  const float S0 = gsum[r0], S1 = gsum[r1];
  const float R0 = __frcp_rn(S0), R1 = __frcp_rn(S1);
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    wait(ntiles + i);
    const __nv_bfloat16* vt = ring + ((ntiles + i) & 1) * STAGE;
    const int kc = i * BK + kw + 2 * cq, key = ts * BK + kc;
    uint32_t pa[4];
    pa[0] = probs(ls + r0 * lld + kc, key, lo0, n0, S0, R0);
    pa[1] = probs(ls + r1 * lld + kc, key, lo1, n1, S1, R1);
    pa[2] = probs(ls + r0 * lld + kc + 8, key + 8, lo0, n0, S0, R0);
    pa[3] = probs(ls + r1 * lld + kc + 8, key + 8, lo1, n1, S1, R1);
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t bf[4];
      tc::ldmatrix_x4_trans(bf, vt + (kw + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + np * 16 +
                                    (lane >> 4) * 8);
      mma_bf16(o[2 * np], pa, bf[0], bf[1]);
      mma_bf16(o[2 * np + 1], pa, bf[2], bf[3]);
    }
    __syncthreads();                      // the stage is free to refill
    issue(ntiles + i + 2);
  }

  // ---- the rank's output: the warps' partials added in warp order (the
  // stages and logits are dead: their room holds them)
  if (ntiles > 0) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
      ocomb[(warp * NO + j) * 32 + lane] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  }
  __syncthreads();
  // output element f = j * 32 + l: lane l's n8 tile j, rows l / 4 and
  // l / 4 + 8, columns 8 j + 2 (l % 4), +1
  auto store = [&](int f, const float4& t) {
    const int j = f >> 5, l = f & 31, col = 8 * j + 2 * (l & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ff = rb * ROWS + (l >> 2) + 8 * h, s = ff / G, g = ff - s * G;
      if (s >= Sq) continue;
      float x = h ? t.z : t.x, y = h ? t.w : t.y;
      if (nan_column(nanmask, col)) x = NAN;
      if (nan_column(nanmask, col + 1)) y = NAN;
      if (s >= sb) x = y = 0.f;           // past the bound: not computed
      __nv_bfloat16* dst = a.out + ((static_cast<size_t>(b) * Sq + s) * a.Hq + hk * G + g) * hd;
      if (col + 1 < hd && (hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < hd) dst[col] = __float2bfloat16_rn(x);
        if (col + 1 < hd) dst[col + 1] = __float2bfloat16_rn(y);
      }
    }
  };
  auto warp_total = [&](int f) {
    float4 t = ocomb[f];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 u = ocomb[w * NO * 32 + f];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    return t;
  };
  if (C == 1) {
    for (int f = tid; f < NO * 32; f += NT) store(f, warp_total(f));
    return;
  }
  // element f belongs to rank f / per; a live rank puts it in that rank's
  // park at [rank][f - owner * per]. A rank outside [L0, L) holds only
  // zeros and sends nothing.
  const int per = NO * 32 / C;
  if (ntiles > 0)
    for (int f = tid; f < NO * 32; f += NT) {
      const int q = f / per;
      *(cluster.map_shared_rank(park, q) + rank * per + (f - q * per)) = warp_total(f);
    }
  cluster.sync();                         // every partial has arrived
  for (int e = tid; e < per; e += NT) {
    float4 t = park[L0 * per + e];
    for (int r = L0 + 1; r < L; ++r) {
      const float4 u = park[r * per + e];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    store(rank * per + e, t);
  }
}

template <int HDP>
int launch_tc(const Args& a, int B, const Plan& p, cudaStream_t stream) {
  static bool opted[64] = {};             // per device: the shared-memory opt-in
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !opted[dev]) {
    e = cudaFuncSetAttribute(attention_tc_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) opted[dev] = true;
  }
  e = tc::launch_split(attention_tc_kernel<HDP>, dim3(a.row_blocks * a.Hkv, B), p.splits, NT,
                       static_cast<int>(p.smem), stream, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16, streamed logits -------------------------------------------------
//
// A rank's 16 rows of fp32 logits outgrow a block's shared memory past
// 25,600 keys at hd 64 (23,040 at hd 128, 17,920 at hd 256; 8 ranks of the
// cluster). Such caches take this kernel, chosen from (A, hd) alone. It
// keeps no logits: each pass streams the rank's K tiles again (pass 3 K
// and V together, through four stages) and recomputes S = Q K^T and
// l = bf16(S) * scale in registers. In the resident kernel a thread reads
// back only the logits it wrote itself, so here it recomputes the same l,
// e = exp(l - max) and p = bf16(e / sum) and adds them in the same orders:
// the two kernels give the same bits, at three Q K^T products per key
// instead of one. The queries stay in shared memory for the products of
// every pass, beside the park.

// probs() from two recomputed logits: the same e = exp(l - max) as pass 2
// adds, the same correctly rounded quotient
__device__ __forceinline__ uint32_t probs_of(float2 l, int key, int lo, int n, float m,
                                             float sum, float r) {
  if (key >= n || key + 1 < lo) return 0u;
  const float px = key >= lo ? quotient(expf(__fsub_rn(l.x, m)), sum, r) : 0.f;
  return pack_bf16(px, is_live(key + 1, lo, n) ? quotient(expf(__fsub_rn(l.y, m)), sum, r)
                                                : 0.f);
}

template <int HDP>
__global__ void __launch_bounds__(NT, HDP <= 64 ? 4 : 1) attention_stream_kernel(const Args a) {
  constexpr int LD = HDP + 8;             // padded rows: conflict-free ldmatrix
  constexpr int KS = HDP / 16;            // MMA steps over the head dim
  constexpr int NO = HDP / 8;             // n8 tiles of the output
  constexpr int STAGE = BK * LD;          // bf16 elements of a K/V stage
  constexpr int NS = STREAM_STAGES;
  extern __shared__ __align__(16) uint8_t smem[];
  const int C = a.splits, TR = a.tiles_per_rank;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* park = reinterpret_cast<float4*>(smem + ROWS * LD * 2);
  uint8_t* body = smem + stream_front_bytes(HDP, C);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(body);  // NS K/V stages
  float4* ocomb = reinterpret_cast<float4*>(body);  // after pass 3: the warps' outputs
  int* rown = reinterpret_cast<int*>(body + stream_body_bytes(HDP));
  int* rlo = rown + ROWS;
  float* wred = reinterpret_cast<float*>(rlo + ROWS);           // WARPS x ROWS
  float* pmax = wred + WARPS * ROWS;
  float* psum = pmax + ROWS;
  float* gmax = psum + ROWS;
  float* gsum = gmax + ROWS;
  // rown and rlo are dead once read into registers: their room holds the
  // column mask of non-finite dead V values, zeroed after pass 1
  uint32_t* nanmask = reinterpret_cast<uint32_t*>(rown);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int rank = blockIdx.z;
  const int rb = blockIdx.x % a.row_blocks, hk = blockIdx.x / a.row_blocks, b = blockIdx.y;
  const int A = a.A, G = a.G, Sq = a.Sq, hd = a.hd;
  const bool vec = a.vec != 0;
  const int sb = row_bound(a.nq, b, Sq);  // queries [sb, Sq) are zeros
  if (rb * ROWS / G >= sb) {              // the same in every rank
    store_zero_rows(a, rb, hk, b, rank, tid);
    return;
  }

  // each row's live keys [max(rlo, 0), rown): none for rows past the
  // call's or the bound, all A (rlo = -1) when all are masked
  if (tid < ROWS) {
    const int s = (rb * ROWS + tid) / G;
    int n = 0, lo = 0;
    if (s < sb) live_keys(a.qpos[b * Sq + s], A, a.window, lo, n);
    rown[tid] = n;
    rlo[tid] = lo;
  }
  // the stages' columns past hd stay zero (loads write [0, hd) only)
  if (hd < HDP)
    for (int e = tid; e < NS * BK * (HDP - hd); e += NT) {
      const int r = e / (HDP - hd);
      ring[r * LD + hd + (e - r * (HDP - hd))] = __float2bfloat16(0.f);
    }
  __syncthreads();

  int bn = 0, blo = A;                    // live keys of the block's rows
  for (int r = 0; r < ROWS; ++r)
    if (rown[r] > 0) {
      bn = max(bn, rown[r]);
      blo = min(blo, max(rlo[r], 0));
    }
  const int T = (A + BK - 1) / BK, t0 = rank * TR, t1 = min(T, t0 + TR);
  const int live = (bn + BK - 1) / BK, first = min(blo, bn) / BK;
  const int L0 = first / TR, L = min(C, (live + TR - 1) / TR);
  const int ts = max(t0, first), ntiles = max(0, min(t1, live) - ts);
  const int r0 = gq, r1 = gq + 8;
  const int n0 = rown[r0], n1 = rown[r1];
  const int lo0 = max(rlo[r0], 0), lo1 = max(rlo[r1], 0);
  const bool none0 = rlo[r0] < 0, none1 = rlo[r1] < 0;
  const int kw = warp * KW;               // the warp's keys in every tile

  const long long kv_stride = static_cast<long long>(a.Hkv) * hd;
  const __nv_bfloat16* kb = a.k + b * a.k_bstride + static_cast<size_t>(hk) * hd;
  const __nv_bfloat16* vb = a.v + b * a.v_bstride + static_cast<size_t>(hk) * hd;
  // the stream: the rank's K tiles (pass 1), its K tiles again (pass 2),
  // then K and V of each tile in turn (pass 3); item i sits in stage
  // i % NS, and i + NS loads once i is done
  const int items = 4 * ntiles;
  auto issue = [&](int i) {
    if (i >= items) return;
    const int j = i - 2 * ntiles;
    const bool is_v = j >= 0 && (j & 1);
    const int tile = j >= 0 ? j >> 1 : i < ntiles ? i : i - ntiles;
    load_rows<LD>(ring + (i % NS) * STAGE, is_v ? vb : kb, kv_stride, (ts + tile) * BK, A, hd,
                  vec, tid);
  };
  // item i has landed, items [0, issued) having been issued
  auto wait = [&](int i, int issued) {
    const int pending = min(issued, items) - 1 - i;
    if (pending >= 3)
      tc::cp_async_wait<3>();
    else if (pending == 2)
      tc::cp_async_wait<2>();
    else if (pending == 1)
      tc::cp_async_wait<1>();
    else
      tc::cp_async_wait<0>();
    __syncthreads();
  };
  // S of the warp's 16 keys of the K tile kt: s[j] holds keys kw + 8 j +
  // 2 cq, +1 of rows r0 (s[j][0], s[j][1]) and r1 (s[j][2], s[j][3])
  auto scores = [&](const __nv_bfloat16* kt, float (&s)[2][4]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qf[4], bf[4];
      ldsm_x4(qf, qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(bf, kt + (kw + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qf, bf[0], bf[1]);
      mma_bf16(s[1], qf, bf[2], bf[3]);
    }
  };
  if (ntiles > 0) {
    // the block's queries (zeros past hd and past the call's rows or the
    // bound) arrive with the first K tile
    for (int e = tid; e < ROWS * (HDP / 8); e += NT) {
      const int r = e / (HDP / 8), c = (e - r * (HDP / 8)) * 8;
      const int f = rb * ROWS + r, s = f / G, g = f - s * G;
      __nv_bfloat16* d = qs + r * LD + c;
      const __nv_bfloat16* src =
          a.q + ((static_cast<size_t>(b) * Sq + s) * a.Hq + hk * G + g) * hd + c;
      if (s < sb && vec && c + 8 <= hd) {
        tc::cp_async16(d, src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d[i] = s < sb && c + i < hd ? src[i] : __float2bfloat16(0.f);
      }
    }
    for (int i = 0; i < NS; ++i) issue(i);
  }
  const uint32_t bad =
      skipped_nonfinite<HDP>(vb, kv_stride, t0, t1, ts, ntiles, A, hd, vec, tid);

  // ---- pass 1: row maxima of l = bf16(q.k) * scale over live keys
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int i = 0; i < ntiles; ++i) {
    wait(i, i + NS);
    float s[2][4];
    scores(ring + (i % NS) * STAGE, s);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = (ts + i) * BK + kw + j * 8 + 2 * cq;
      const float2 l0 = logits(s[j][0], s[j][1], none0, a.scale);
      const float2 l1 = logits(s[j][2], s[j][3], none1, a.scale);
      if (is_live(key, lo0, n0)) m0 = fmaxf(m0, l0.x);
      if (is_live(key + 1, lo0, n0)) m0 = fmaxf(m0, l0.y);
      if (is_live(key, lo1, n1)) m1 = fmaxf(m1, l1.x);
      if (is_live(key + 1, lo1, n1)) m1 = fmaxf(m1, l1.y);
    }
    __syncthreads();                      // the stage is free to refill
    issue(i + NS);
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  if (cq == 0) {
    wred[warp * ROWS + r0] = m0;
    wred[warp * ROWS + r1] = m1;
  }
  __syncthreads();
  if (tid < (HDP + 31) / 32) nanmask[tid] = 0u;
  if (tid < ROWS) {
    float m = wred[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, wred[w * ROWS + tid]);
    pmax[tid] = m;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (C > 1) cluster.sync(); else __syncthreads();
  publish_nonfinite<HDP>(bad, nanmask, C, tid, cluster);
  if (tid < ROWS && ntiles > 0) {
    float m = pmax[tid];
    for (int r = L0; r < L; ++r)
      if (r != rank) m = fmaxf(m, *cluster.map_shared_rank(pmax + tid, r));
    gmax[tid] = m;
  }
  __syncthreads();

  // ---- pass 2: row sums of e = exp(l - max), each thread's keys in key
  // order (a row's tiles past its live keys add nothing), the quad, the
  // warps in order, the ranks in order
  const float M0 = gmax[r0], M1 = gmax[r1];
  float s0 = 0.f, s1 = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const int it = ntiles + i;
    wait(it, it + NS);
    float s[2][4];
    scores(ring + (it % NS) * STAGE, s);
    const int k0 = (ts + i) * BK;       // the tile's first key
    const bool live0 = k0 < n0 && k0 + BK > lo0, live1 = k0 < n1 && k0 + BK > lo1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = k0 + kw + j * 8 + 2 * cq;
      if (live0) {
        const float2 l = logits(s[j][0], s[j][1], none0, a.scale);
        const float ex = expf(__fsub_rn(l.x, M0)), ey = expf(__fsub_rn(l.y, M0));
        if (is_live(key, lo0, n0)) s0 += ex;
        if (is_live(key + 1, lo0, n0)) s0 += ey;
      }
      if (live1) {
        const float2 l = logits(s[j][2], s[j][3], none1, a.scale);
        const float ex = expf(__fsub_rn(l.x, M1)), ey = expf(__fsub_rn(l.y, M1));
        if (is_live(key, lo1, n1)) s1 += ex;
        if (is_live(key + 1, lo1, n1)) s1 += ey;
      }
    }
    __syncthreads();                      // the stage is free to refill
    issue(it + NS);
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
  if (cq == 0) {
    wred[warp * ROWS + r0] = s0;
    wred[warp * ROWS + r1] = s1;
  }
  __syncthreads();
  if (tid < ROWS) {
    float s = wred[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += wred[w * ROWS + tid];
    psum[tid] = s;
  }
  if (C > 1) cluster.sync(); else __syncthreads();
  if (tid < ROWS && ntiles > 0) {
    float s = rank == L0 ? psum[tid] : *cluster.map_shared_rank(psum + tid, L0);
    for (int r = L0 + 1; r < L; ++r)
      s += r == rank ? psum[tid] : *cluster.map_shared_rank(psum + tid, r);
    gsum[tid] = s;
  }
  __syncthreads();

  // ---- pass 3: p = bf16(e / sum), 0 for a dead key; P V over the warp's
  // keys of the rank's tiles in order
  const float S0 = gsum[r0], S1 = gsum[r1];
  const float R0 = __frcp_rn(S0), R1 = __frcp_rn(S1);
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const int it = 2 * ntiles + 2 * i;    // K tile i, then V tile i
    wait(it + 1, it + NS);
    float s[2][4];
    scores(ring + (it % NS) * STAGE, s);
    const __nv_bfloat16* vt = ring + ((it + 1) % NS) * STAGE;
    const int key = (ts + i) * BK + kw + 2 * cq;
    uint32_t pa[4];
    pa[0] = probs_of(logits(s[0][0], s[0][1], none0, a.scale), key, lo0, n0, M0, S0, R0);
    pa[1] = probs_of(logits(s[0][2], s[0][3], none1, a.scale), key, lo1, n1, M1, S1, R1);
    pa[2] = probs_of(logits(s[1][0], s[1][1], none0, a.scale), key + 8, lo0, n0, M0, S0, R0);
    pa[3] = probs_of(logits(s[1][2], s[1][3], none1, a.scale), key + 8, lo1, n1, M1, S1, R1);
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t bf[4];
      tc::ldmatrix_x4_trans(bf, vt + (kw + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + np * 16 +
                                    (lane >> 4) * 8);
      mma_bf16(o[2 * np], pa, bf[0], bf[1]);
      mma_bf16(o[2 * np + 1], pa, bf[2], bf[3]);
    }
    __syncthreads();                      // the stages are free to refill
    issue(it + NS);
    issue(it + 1 + NS);
  }

  // ---- the rank's output, as the resident kernel's
  if (ntiles > 0) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
      ocomb[(warp * NO + j) * 32 + lane] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
  }
  __syncthreads();
  auto store = [&](int f, const float4& t) {
    const int j = f >> 5, l = f & 31, col = 8 * j + 2 * (l & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ff = rb * ROWS + (l >> 2) + 8 * h, s = ff / G, g = ff - s * G;
      if (s >= Sq) continue;
      float x = h ? t.z : t.x, y = h ? t.w : t.y;
      if (nan_column(nanmask, col)) x = NAN;
      if (nan_column(nanmask, col + 1)) y = NAN;
      if (s >= sb) x = y = 0.f;           // past the bound: not computed
      __nv_bfloat16* dst = a.out + ((static_cast<size_t>(b) * Sq + s) * a.Hq + hk * G + g) * hd;
      if (col + 1 < hd && (hd & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x, y);
      } else {
        if (col < hd) dst[col] = __float2bfloat16_rn(x);
        if (col + 1 < hd) dst[col + 1] = __float2bfloat16_rn(y);
      }
    }
  };
  auto warp_total = [&](int f) {
    float4 t = ocomb[f];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 u = ocomb[w * NO * 32 + f];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    return t;
  };
  if (C == 1) {
    for (int f = tid; f < NO * 32; f += NT) store(f, warp_total(f));
    return;
  }
  const int per = NO * 32 / C;
  if (ntiles > 0)
    for (int f = tid; f < NO * 32; f += NT) {
      const int q = f / per;
      *(cluster.map_shared_rank(park, q) + rank * per + (f - q * per)) = warp_total(f);
    }
  cluster.sync();                         // every partial has arrived
  for (int e = tid; e < per; e += NT) {
    float4 t = park[L0 * per + e];
    for (int r = L0 + 1; r < L; ++r) {
      const float4 u = park[r * per + e];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    store(rank * per + e, t);
  }
}

template <int HDP>
int launch_stream(const Args& a, int B, const Plan& p, cudaStream_t stream) {
  static bool opted[64] = {};             // per device: the shared-memory opt-in
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !opted[dev]) {
    e = cudaFuncSetAttribute(attention_stream_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) opted[dev] = true;
  }
  e = tc::launch_split(attention_stream_kernel<HDP>, dim3(a.row_blocks * a.Hkv, B), p.splits, NT,
                       static_cast<int>(p.smem), stream, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: CUDA cores -------------------------------------------------------

constexpr int F32_NT = 128;
constexpr int F32_WARPS = F32_NT / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide reduction of one value per thread in a fixed order: xor
// butterflies inside each warp (every lane ends with the same value), then
// the warps' results in order.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = IS_MAX ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < F32_WARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// The V rows past the live keys, [n, A): the reference multiplies them by
// their zero probability, and so does this loop, after the live keys (keys
// below the window's bound are in the main loop with their zero
// probability already). For a finite v the product is an exact zero and
// the accumulator keeps its bits (it is never -0: it starts at +0, and
// +0 + -0 = +0); a NaN or Inf v makes its column NaN, as in the
// reference. Warp w reads rows n + w, n + w + 4, ...; lane l columns l,
// l + 32, ...
template <int NDL>
__device__ __forceinline__ void nonfinite_past(const float* vb, size_t krow, int n, int A,
                                               int hd, int lane, int warp, float (&acc)[NDL]) {
#pragma unroll 4
  for (int j = n + warp; j < A; j += F32_WARPS) {
    const float* vr = vb + j * krow;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc[i] = fmaf(0.f, vr[d], acc[i]);
    }
  }
}

// A query at or past its batch row's bound (nq given): its output row is
// stored as zeros and the block returns, before any load or barrier
__device__ __forceinline__ bool past_bound(const int32_t* nq, int b, int s, float* orow, int hd,
                                           int tid) {
  if (!nq || s < nq[b]) return false;
  for (int d = tid; d < hd; d += F32_NT) orow[d] = 0.f;
  return true;
}

// One block per (query head, query, batch row): logits in shared memory (A
// floats); warp w takes keys w, w + 4, ...; lane l holds head dims l, l +
// 32, ... (NDL of them). A logit is lane l's in-order partial dot, then an
// xor butterfly; the softmax sum runs over keys tid, tid + 128, ... per
// thread, then the fixed block tree; the output is each warp's in-order sum
// over its keys, the four warps added in order.
template <int NDL>
__global__ void __launch_bounds__(F32_NT)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int32_t* __restrict__ qpos,
                     const int32_t* __restrict__ nq, float* __restrict__ out, int Sq, int Hq,
                     int Hkv, int A, int hd, int window, long long k_bstride,
                     long long v_bstride, float scale) {
  extern __shared__ float fsmem[];
  __shared__ float red[F32_WARPS];
  float* p = fsmem;                       // A: logits, then probabilities
  float* part = p + A;                    // F32_WARPS * hd partial output sums

  const int h = blockIdx.x % Hq, s = blockIdx.x / Hq, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = h / (Hq / Hkv);
  float* orow = out + ((static_cast<size_t>(b) * Sq + s) * Hq + h) * hd;
  if (past_bound(nq, b, s, orow, hd, tid)) return;
  int lo, n;
  live_keys(qpos[b * Sq + s], A, window, lo, n);
  // keys below lo are masked: their logits are -inf, so they add exact
  // zeros to the softmax sum and to the output, and every live key is
  // added by the same thread, warp and lane in the same order

  const float* qrow = q + ((static_cast<size_t>(b) * Sq + s) * Hq + h) * hd;
  float qv[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < hd ? qrow[d] : 0.f;
  }

  const float* kb = k + b * k_bstride + static_cast<size_t>(hk) * hd;
  const size_t krow = static_cast<size_t>(Hkv) * hd;
  float m = -FLT_MAX;
#pragma unroll 2
  for (int j = warp; j < n; j += F32_WARPS) {
    const float* kr = kb + j * krow;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc = fmaf(qv[i], kr[d], acc);
    }
    acc = warp_sum(acc);
    const float l = lo < 0 ? -1e30f : j < lo ? -INFINITY : acc * scale;
    if (lane == 0) p[j] = l;
    m = fmaxf(m, l);
  }
  m = block_reduce<true>(m, red);

  float sum = 0.f;
  for (int j = tid; j < n; j += F32_NT) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int j = tid; j < n; j += F32_NT) p[j] = p[j] / sum;
  __syncthreads();

  const float* vb = v + b * v_bstride + static_cast<size_t>(hk) * hd;
  float acc[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int j = warp; j < n; j += F32_WARPS) {
    const float pj = p[j];
    const float* vr = vb + j * krow;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc[i] = fmaf(pj, vr[d], acc[i]);
    }
  }
  nonfinite_past<NDL>(vb, krow, n, A, hd, lane, warp, acc);
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) part[warp * hd + d] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += F32_NT) {
    float o = part[d];
#pragma unroll
    for (int w = 1; w < F32_WARPS; ++w) o += part[w * hd + d];
    orow[d] = o;
  }
}

__host__ size_t f32_smem(int A, int hd) {
  return sizeof(float) * (static_cast<size_t>(A) + static_cast<size_t>(F32_WARPS) * hd);
}

template <int NDL>
int launch_f32(const void* q, const void* k, const void* v, const void* qpos, const void* nq,
               void* out, int B, int Sq, int Hq, int Hkv, int A, int hd, int window,
               long long k_bstride, long long v_bstride, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem(A, hd);
  if (smem + sizeof(float) * F32_WARPS > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_f32_kernel<NDL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attention_f32_kernel<NDL><<<dim3(Hq * Sq, B), F32_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(nq),
      static_cast<float*>(out), Sq, Hq, Hkv, A, hd, window, k_bstride, v_bstride, scale);
  return static_cast<int>(cudaGetLastError());
}

// The logit of key j (row kr), as the resident f32 kernel computes it:
// lane l's in-order partial dot over head dims l, l + 32, ..., then the
// xor butterfly; -1e30 when the query has no live key (lo < 0), -inf for a
// key below the window's bound lo.
template <int NDL>
__device__ __forceinline__ float f32_logit(const float (&qv)[NDL], const float* kr, int lane,
                                           int hd, int j, int lo, float scale) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) acc = fmaf(qv[i], kr[d], acc);
  }
  acc = warp_sum(acc);
  return lo < 0 ? -1e30f : j < lo ? -INFINITY : acc * scale;
}

// The f32 kernel's streamed form, for caches whose A logits do not fit a
// block's shared memory (past 57,852 keys at hd 64): one chunk of F32_NT
// logits at a time, recomputed in passes 2 and 3, each sum taken by the
// same thread, warp and lane in the same order as in the resident kernel.
// The normalisation is the correctly rounded quotient from the sum's
// reciprocal (quotient()), the resident kernel's IEEE division wherever the
// quotient is a normal float.
template <int NDL>
__global__ void __launch_bounds__(F32_NT)
attention_f32_stream_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int32_t* __restrict__ qpos,
                            const int32_t* __restrict__ nq, float* __restrict__ out, int Sq,
                            int Hq, int Hkv, int A, int hd, int window, long long k_bstride,
                            long long v_bstride, float scale) {
  extern __shared__ float fsmem[];
  __shared__ float red[F32_WARPS];
  float* p = fsmem;                       // F32_NT: a chunk's logits, then probabilities
  float* part = p + F32_NT;               // F32_WARPS * hd partial output sums

  const int h = blockIdx.x % Hq, s = blockIdx.x / Hq, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = h / (Hq / Hkv);
  float* orow = out + ((static_cast<size_t>(b) * Sq + s) * Hq + h) * hd;
  if (past_bound(nq, b, s, orow, hd, tid)) return;
  int lo, n;
  live_keys(qpos[b * Sq + s], A, window, lo, n);
  // keys below lo are masked (f32_logit gives them -inf), as in the
  // resident kernel

  const float* qrow = q + ((static_cast<size_t>(b) * Sq + s) * Hq + h) * hd;
  float qv[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < hd ? qrow[d] : 0.f;
  }
  const float* kb = k + b * k_bstride + static_cast<size_t>(hk) * hd;
  const float* vb = v + b * v_bstride + static_cast<size_t>(hk) * hd;
  const size_t krow = static_cast<size_t>(Hkv) * hd;

  float m = -FLT_MAX;
#pragma unroll 4
  for (int j = warp; j < n; j += F32_WARPS)
    m = fmaxf(m, f32_logit<NDL>(qv, kb + j * krow, lane, hd, j, lo, scale));
  m = block_reduce<true>(m, red);

  float sum = 0.f;
  for (int c0 = 0; c0 < n; c0 += F32_NT) {
    for (int j = c0 + warp; j < min(n, c0 + F32_NT); j += F32_WARPS) {
      const float l = f32_logit<NDL>(qv, kb + j * krow, lane, hd, j, lo, scale);
      if (lane == 0) p[j - c0] = l;
    }
    __syncthreads();
    if (c0 + tid < n) sum += expf(p[tid] - m);
    __syncthreads();
  }
  sum = block_reduce<false>(sum, red);
  const float r = __frcp_rn(sum);

  float acc[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < n; c0 += F32_NT) {
    const int c1 = min(n, c0 + F32_NT);
    for (int j = c0 + warp; j < c1; j += F32_WARPS) {
      const float l = f32_logit<NDL>(qv, kb + j * krow, lane, hd, j, lo, scale);
      if (lane == 0) p[j - c0] = l;
    }
    __syncthreads();
    if (c0 + tid < n) p[tid] = quotient(expf(p[tid] - m), sum, r);
    __syncthreads();
#pragma unroll 4
    for (int j = c0 + warp; j < c1; j += F32_WARPS) {
      const float pj = p[j - c0];
      const float* vr = vb + j * krow;
#pragma unroll
      for (int i = 0; i < NDL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) acc[i] = fmaf(pj, vr[d], acc[i]);
      }
    }
    __syncthreads();
  }
  nonfinite_past<NDL>(vb, krow, n, A, hd, lane, warp, acc);
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) part[warp * hd + d] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += F32_NT) {
    float o = part[d];
#pragma unroll
    for (int w = 1; w < F32_WARPS; ++w) o += part[w * hd + d];
    orow[d] = o;
  }
}

template <int NDL>
int launch_f32_stream(const void* q, const void* k, const void* v, const void* qpos,
                      const void* nq, void* out, int B, int Sq, int Hq, int Hkv, int A, int hd,
                      int window, long long k_bstride, long long v_bstride, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (F32_NT + static_cast<size_t>(F32_WARPS) * hd);
  attention_f32_stream_kernel<NDL><<<dim3(Hq * Sq, B), F32_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(nq),
      static_cast<float*>(out), Sq, Hq, Hkv, A, hd, window, k_bstride, v_bstride, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }


// ------------------------------------------------------------- backward ---

constexpr int BWD_WARPS = 4;
constexpr int BWD_NT = 32 * BWD_WARPS;
constexpr int BWD_MAX_HD = 256;
constexpr int BWD_C = BWD_MAX_HD / 32;    // head dims a lane holds, at most

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* out;
  const T* dout;
  const int32_t* qpos;
  T* dq;
  T* dk;
  T* dv;
  float* lse;       // (B, Hq, Sq)
  float* delta;     // (B, Hq, Sq)
  long long k_bstride, v_bstride;
  int B, Sq, Hq, Hkv, A, hd, window;
  float scale;
  bool vec;         // 16-byte row loads: hd % 8 == 0 and every row aligned
};

// The f32 kernels' element helpers (bf16 takes the tensor-core kernels)
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

__device__ __forceinline__ void bwd_load8(float (&x)[8], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 w = *reinterpret_cast<const float4*>(p + 4);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  x[4] = w.x; x[5] = w.y; x[6] = w.z; x[7] = w.w;
}

// sum_d s[d] * row[d], d ascending (s in shared memory, row in memory)
template <typename T>
__device__ __forceinline__ float dot_row(const float* s, const T* row, int hd, bool vec) {
  float acc = 0.f;
  if (vec) {
    for (int d = 0; d < hd; d += 8) {
      float x[8];
      bwd_load8(x, row + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(s[d + i], x[i], acc);
    }
  } else {
    for (int d = 0; d < hd; ++d) acc = fmaf(s[d], to_float(row[d]), acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(BWD_NT) attention_bwd_dq_kernel(const BwdArgs<T> a) {
  __shared__ float sm[BWD_WARPS][2][BWD_MAX_HD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * BWD_WARPS + warp;
  if (row >= static_cast<long long>(a.B) * a.Sq * a.Hq) return;
  const int hd = a.hd;
  const int h = static_cast<int>(row % a.Hq);
  const long long bi = row / a.Hq;                       // b * Sq + i
  const int b = static_cast<int>(bi / a.Sq), i = static_cast<int>(bi % a.Sq);
  const int g = h / (a.Hq / a.Hkv);
  float* sq = sm[warp][0];
  float* sdo = sm[warp][1];
  const size_t qo = static_cast<size_t>(row) * hd;
  float dsum = 0.f;
  for (int d = lane; d < hd; d += 32) {
    const float qd = to_float(a.q[qo + d]), dod = to_float(a.dout[qo + d]);
    sq[d] = qd;
    sdo[d] = dod;
    dsum = fmaf(dod, to_float(a.out[qo + d]), dsum);
  }
  dsum = warp_sum(dsum);
  __syncwarp();
  int lo, n;
  live_keys(a.qpos[bi], a.A, a.window, lo, n);
  const size_t lr = (static_cast<size_t>(b) * a.Hq + h) * a.Sq + i;
  const long long kst = static_cast<long long>(a.Hkv) * hd;
  const T* kb = a.k + b * a.k_bstride + static_cast<long long>(g) * hd;
  const T* vb = a.v + b * a.v_bstride + static_cast<long long>(g) * hd;
  float acc[BWD_C];
#pragma unroll
  for (int c = 0; c < BWD_C; ++c) acc[c] = 0.f;
  float lse = 0.f;
  if (lo >= 0) {                     // lo < 0: no live key, dQ = 0
    float m = -INFINITY, s = 0.f;
    for (int j = lo + lane; j < n; j += 32) {
      const float l = __fmul_rn(round_as(dot_row(sq, kb + j * kst, hd, a.vec), a.q), a.scale);
      if (l > m) {
        s = s * expf(m - l) + 1.f;
        m = l;
      } else {
        s += expf(l - m);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      const float mn = fmaxf(m, m2);
      s = (s == 0.f ? 0.f : s * expf(m - mn)) + (s2 == 0.f ? 0.f : s2 * expf(m2 - mn));
      m = mn;
    }
    lse = m + logf(s);
    for (int j0 = lo; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      float ds = 0.f;
      if (j < n) {
        const float l = __fmul_rn(round_as(dot_row(sq, kb + j * kst, hd, a.vec), a.q), a.scale);
        const float p = expf(l - lse);
        ds = p * (dot_row(sdo, vb + j * kst, hd, a.vec) - dsum);
      }
      const int cnt = min(32, n - j0);
      for (int t = 0; t < cnt; ++t) {
        const float dst = __shfl_sync(0xffffffffu, ds, t);
        const T* kr = kb + (j0 + t) * kst;
#pragma unroll
        for (int c = 0; c < BWD_C; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[c] = fmaf(dst, to_float(kr[d]), acc[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < BWD_C; ++c) {
    const int d = lane + 32 * c;
    if (d < hd) store_as(a.dq + qo + d, acc[c] * a.scale);
  }
  if (lane == 0) {
    a.lse[lr] = lse;
    a.delta[lr] = dsum;
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_NT) attention_bwd_dkv_kernel(const BwdArgs<T> a) {
  __shared__ float sm[BWD_WARPS][2][BWD_MAX_HD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * BWD_WARPS + warp;
  if (row >= static_cast<long long>(a.B) * a.A * a.Hkv) return;
  const int hd = a.hd;
  const int g = static_cast<int>(row % a.Hkv);
  const long long bj = row / a.Hkv;                      // b * A + j
  const int b = static_cast<int>(bj / a.A), j = static_cast<int>(bj % a.A);
  const int G = a.Hq / a.Hkv;
  float* sk = sm[warp][0];
  float* sv = sm[warp][1];
  const long long ko = (static_cast<long long>(j) * a.Hkv + g) * hd;
  for (int d = lane; d < hd; d += 32) {
    sk[d] = to_float(a.k[b * a.k_bstride + ko + d]);
    sv[d] = to_float(a.v[b * a.v_bstride + ko + d]);
  }
  __syncwarp();
  float dk[BWD_C], dv[BWD_C];
#pragma unroll
  for (int c = 0; c < BWD_C; ++c) dk[c] = dv[c] = 0.f;
  const float even = round_as(1.f / static_cast<float>(a.A), a.q);
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    for (int i0 = 0; i0 < a.Sq; i0 += 32) {
      const int i = i0 + lane;
      float p = 0.f, ds = 0.f;
      bool take = false;
      if (i < a.Sq) {
        int lo, n;
        live_keys(a.qpos[static_cast<size_t>(b) * a.Sq + i], a.A, a.window, lo, n);
        if (lo < 0) {                // no live key: the even softmax
          p = even;
          take = true;
        } else if (j >= lo && j < n) {
          const size_t qo = ((static_cast<size_t>(b) * a.Sq + i) * a.Hq + h) * hd;
          const size_t lr = (static_cast<size_t>(b) * a.Hq + h) * a.Sq + i;
          const float l = __fmul_rn(round_as(dot_row(sk, a.q + qo, hd, a.vec), a.q), a.scale);
          const float pf = expf(l - a.lse[lr]);
          ds = pf * (dot_row(sv, a.dout + qo, hd, a.vec) - a.delta[lr]);
          p = round_as(pf, a.q);
          take = true;
        }
      }
      const unsigned live = __ballot_sync(0xffffffffu, take);
      if (live == 0u) continue;
      for (int t = 0; t < 32; ++t) {
        if (!((live >> t) & 1u)) continue;
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const float dst = __shfl_sync(0xffffffffu, ds, t);
        const size_t qo = ((static_cast<size_t>(b) * a.Sq + i0 + t) * a.Hq + h) * hd;
#pragma unroll
        for (int c = 0; c < BWD_C; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) {
            dv[c] = fmaf(pt, to_float(a.dout[qo + d]), dv[c]);
            dk[c] = fmaf(dst, to_float(a.q[qo + d]), dk[c]);
          }
        }
      }
    }
  }
  const size_t o = static_cast<size_t>(row) * hd;
#pragma unroll
  for (int c = 0; c < BWD_C; ++c) {
    const int d = lane + 32 * c;
    if (d < hd) {
      store_as(a.dk + o + d, dk[c] * a.scale);
      store_as(a.dv + o + d, dv[c]);
    }
  }
}

template <typename T>
int launch_bwd(const BwdArgs<T>& a, bool dkv, cudaStream_t stream) {
  const long long rows = dkv ? static_cast<long long>(a.B) * a.A * a.Hkv
                             : static_cast<long long>(a.B) * a.Sq * a.Hq;
  const long long blocks = (rows + BWD_WARPS - 1) / BWD_WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (dkv)
    attention_bwd_dkv_kernel<T><<<static_cast<unsigned>(blocks), BWD_NT, 0, stream>>>(a);
  else
    attention_bwd_dq_kernel<T><<<static_cast<unsigned>(blocks), BWD_NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 backward: tensor cores -------------------------------------------

constexpr int DKV_KEYS = ROWS;            // (b): keys per block, one MMA tile

// (b)'s warps, each walking its own row tiles: eight where their stages
// fit two blocks (hd <= 64) or one (hd 128) on an SM, else four
__host__ __device__ constexpr int dkv_warps(int hdp) { return hdp <= 128 ? 8 : 4; }

// (b) splits the head dims of dK and dV over this many blocks: at hd 256 a
// warp's two accumulators would be 2 x 16 x 256 fp32
__host__ __device__ constexpr int dkv_halves(int hdp) { return hdp == 256 ? 2 : 1; }

// (a)'s shared memory: Q and dO (ROWS x (hdp + 8) bf16 each), two stages of
// a K and a V tile (BK rows each), whose room holds the warps' partial dQ
// at the end, then the row stats (live keys, lo, D, lse, the warps' max
// and sum)
__host__ __device__ __forceinline__ int dq_ring_bytes(int hdp) {
  const int ring = 2 * 2 * BK * (hdp + 8) * 2, outs = WARPS * ROWS * hdp * 4;
  return ring > outs ? ring : outs;
}
__host__ __device__ __forceinline__ int dq_smem(int hdp) {
  return 2 * ROWS * (hdp + 8) * 2 + dq_ring_bytes(hdp) + (4 + 2 * WARPS) * ROWS * 4;
}

// (b)'s: the block's K and V tiles (DKV_KEYS x (hdp + 8) bf16 each), then
// per warp two stages of a row tile (its Q and dO, then the rows' lse, D
// and positions), whose room holds the warps' partial dK and dV at the end
__host__ __device__ __forceinline__ int dkv_stage_bytes(int hdp) {
  return 2 * ROWS * (hdp + 8) * 2 + 3 * ROWS * 4;
}
__host__ __device__ __forceinline__ int dkv_smem(int hdp) {
  const int stages = dkv_warps(hdp) * 2 * dkv_stage_bytes(hdp);
  const int outs = 2 * dkv_warps(hdp) * DKV_KEYS * (hdp / dkv_halves(hdp)) * 4;
  return 2 * DKV_KEYS * (hdp + 8) * 2 + (stages > outs ? stages : outs);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(tc::smem_addr(dst)), "l"(src));
}

// Columns [c, c + 8) of a row (zeros past `cols` and for a row that is not
// `real`): one 16-byte cp.async when the row is aligned and whole
__device__ __forceinline__ void bwd_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src, bool real,
                                          int cols, bool vec) {
  if (real && vec && cols >= 8) {
    tc::cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = real && i < cols ? src[i] : __float2bfloat16(0.f);
}

// s (16 x 16 fp32, two n8 tiles) = X Y^T over the padded head dim: X's 16
// rows as A fragments, from shared memory (xs) or registers (xf); Y's 16
// rows at ys
template <int KS, int LD>
__device__ __forceinline__ void xyt(float (&s)[2][4], const __nv_bfloat16* xs,
                                    const __nv_bfloat16* ys, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4], bf[4];
    ldsm_x4(af, xs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 4) * 8);
    ldsm_x4(bf, ys + ((lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16(s[0], af, bf[0], bf[1]);
    mma_bf16(s[1], af, bf[2], bf[3]);
  }
}
template <int KS, int LD>
__device__ __forceinline__ void xyt(float (&s)[2][4], const uint32_t (&xf)[KS][4],
                                    const __nv_bfloat16* ys, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t bf[4];
    ldsm_x4(bf, ys + ((lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16(s[0], xf[kk], bf[0], bf[1]);
    mma_bf16(s[1], xf[kk], bf[2], bf[3]);
  }
}

// o (16 x 8 NO fp32) += P (16 x 16, an A fragment) Y, Y's 16 rows at ys
// (columns [0, 8 NO)) read transposed
template <int NO, int LD>
__device__ __forceinline__ void pxy(float (&o)[NO][4], const uint32_t (&pa)[4],
                                    const __nv_bfloat16* ys, int lane) {
#pragma unroll
  for (int np = 0; np < NO / 2; ++np) {
    uint32_t bf[4];
    tc::ldmatrix_x4_trans(bf, ys + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + np * 16 +
                                  (lane >> 4) * 8);
    mma_bf16(o[2 * np], pa, bf[0], bf[1]);
    mma_bf16(o[2 * np + 1], pa, bf[2], bf[3]);
  }
}

// (m, e): an exp-sum e relative to its max m, merged with another
__device__ __forceinline__ void merge_exp_sum(float& m, float& e, float m2, float e2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  e = (e == 0.f ? 0.f : e * expf(m - mn)) + (e2 == 0.f ? 0.f : e2 * expf(m2 - mn));
  m = mn;
}

// (m, e) over four more logits l (-inf: a dead key), added in order
__device__ __forceinline__ void online_exp_sum(float& m, float& e, const float (&l)[4]) {
  const float mn = fmaxf(fmaxf(m, fmaxf(l[0], l[1])), fmaxf(l[2], l[3]));
  if (mn == -INFINITY) return;
  e = e == 0.f ? 0.f : e * expf(m - mn);
#pragma unroll
  for (int x = 0; x < 4; ++x) e += expf(__fsub_rn(l[x], mn));
  m = mn;
}

// Flat row f = s * G + g of a KV head's group: returns the query s, sets g
// (a 32-bit division wherever f fits one)
__device__ __forceinline__ int tile_row(long long f, int G, int& g) {
  const int s = f <= 0x7fffffffLL ? static_cast<int>(f) / G : static_cast<int>(f / G);
  g = static_cast<int>(f - static_cast<long long>(s) * G);
  return s;
}

template <int HDP>
__global__ void __launch_bounds__(NT, HDP <= 64 ? 4 : 1)
    attention_bwd_dq_tc_kernel(const BwdArgs<__nv_bfloat16> a) {
  constexpr int LD = HDP + 8;             // padded rows: conflict-free ldmatrix
  constexpr int KS = HDP / 16;            // MMA steps over the head dim
  constexpr int NO = HDP / 8;             // n8 tiles of dQ
  constexpr int STAGE = BK * LD;          // bf16 elements of a K or V tile
  constexpr bool FREG = HDP <= 128;       // Q and dO fragments held in registers
  constexpr int NF = FREG ? KS : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + ROWS * LD;
  __nv_bfloat16* ring = dos + ROWS * LD;  // two stages of a K and a V tile
  float4* ocomb = reinterpret_cast<float4*>(ring);  // after pass 2: the warps' dQ
  int* rown = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(ring) + dq_ring_bytes(HDP));
  int* rlo = rown + ROWS;
  float* rd = reinterpret_cast<float*>(rlo + ROWS);             // D = dO . O
  float* rlse = rd + ROWS;
  float* wmax = rlse + ROWS;                                    // WARPS x ROWS
  float* wsum = wmax + WARPS * ROWS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int G = a.Hq / a.Hkv, Sq = a.Sq, A = a.A, hd = a.hd;
  const int row_blocks = static_cast<int>((static_cast<long long>(Sq) * G + ROWS - 1) / ROWS);
  const int rb = blockIdx.x % row_blocks, hk = blockIdx.x / row_blocks, b = blockIdx.y;
  const long long f0 = static_cast<long long>(rb) * ROWS;
  // element offset of the row of query s, head g of the group (q's layout)
  auto row_at = [&](int s, int g) {
    return ((static_cast<size_t>(b) * Sq + s) * a.Hq + hk * G + g) * hd;
  };

  // each row's live keys [rlo, rown); none (rown = 0) for rows past the
  // call's and rows whose keys are all masked (their dQ is 0)
  if (tid < ROWS) {
    int g;
    const int s = tile_row(f0 + tid, G, g);
    int n = 0, lo = 0;
    if (s < Sq) {
      live_keys(a.qpos[static_cast<size_t>(b) * Sq + s], A, a.window, lo, n);
      if (lo < 0) lo = n = 0;
    }
    rown[tid] = n;
    rlo[tid] = lo;
  }
  // the stages' columns past hd stay zero (loads write [0, hd) only)
  if (hd < HDP)
    for (int e = tid; e < 4 * BK * (HDP - hd); e += NT) {
      const int r = e / (HDP - hd);
      ring[r * LD + hd + (e - r * (HDP - hd))] = __float2bfloat16(0.f);
    }
  __syncthreads();

  int bn = 0, blo = A;                    // live keys of the block's rows
  for (int r = 0; r < ROWS; ++r)
    if (rown[r] > 0) {
      bn = max(bn, rown[r]);
      blo = min(blo, rlo[r]);
    }
  // key tiles [first, first + nt) hold a live key of the block
  const int first = min(blo, bn) / BK, nt = max(0, (bn + BK - 1) / BK - first);
  const int r0 = gq, r1 = gq + 8;
  const int n0 = rown[r0], n1 = rown[r1], lo0 = rlo[r0], lo1 = rlo[r1];
  const int kw = warp * KW;               // the warp's keys in every tile

  const long long kv_stride = static_cast<long long>(a.Hkv) * hd;
  const __nv_bfloat16* kb = a.k + b * a.k_bstride + static_cast<size_t>(hk) * hd;
  const __nv_bfloat16* vb = a.v + b * a.v_bstride + static_cast<size_t>(hk) * hd;
  // pass 1 streams the K tiles, pass 2 the K and V tiles, through two
  // stages: stream tile u sits in stage u & 1, and u + 2 loads once u is done
  auto fetch = [&](int u) {
    if (u >= 2 * nt) return;
    __nv_bfloat16* st = ring + (u & 1) * 2 * STAGE;
    const int t = first + (u < nt ? u : u - nt);
    copy_rows<LD, BK, NT>(st, kb, kv_stride, t * BK, A, hd, a.vec, tid);
    if (u >= nt) copy_rows<LD, BK, NT>(st + STAGE, vb, kv_stride, t * BK, A, hd, a.vec, tid);
    tc::cp_async_commit();
  };
  auto wait = [&](int u) {
    if (u + 1 < 2 * nt)
      tc::cp_async_wait<1>();
    else
      tc::cp_async_wait<0>();
    __syncthreads();
  };
  if (nt > 0) {
    // the block's Q and dO rows (zeros past hd and past the call's rows)
    // arrive with the first K tile
    for (int e = tid; e < ROWS * (HDP / 8); e += NT) {
      const int r = e / (HDP / 8), c = (e - r * (HDP / 8)) * 8;
      int g;
      const int s = tile_row(f0 + r, G, g);
      const size_t o = s < Sq ? row_at(s, g) + c : 0;
      bwd_chunk(qs + r * LD + c, a.q + o, s < Sq, hd - c, a.vec);
      bwd_chunk(dos + r * LD + c, a.dout + o, s < Sq, hd - c, a.vec);
    }
    fetch(0);
    fetch(1);
  }
  // D = dO . O of rows warp, warp + WARPS, ...: each lane its head dims in
  // order, then the xor butterfly
#pragma unroll
  for (int i = 0; i < ROWS / WARPS; ++i) {
    const int r = warp + i * WARPS;
    int g;
    const int s = tile_row(f0 + r, G, g);
    float acc = 0.f;
    if (s < Sq) {
      const size_t o = row_at(s, g);
#pragma unroll
      for (int c = 0; c < (HDP + 31) / 32; ++c) {
        const int d = lane + 32 * c;
        if (d < hd)
          acc = fmaf(__bfloat162float(a.dout[o + d]), __bfloat162float(a.out[o + d]), acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) rd[r] = acc;
  }

  // ---- pass 1: l = bf16(q.k) * scale over the warp's keys of every tile;
  // each thread's max and exp-sum of rows r0 and r1 over its live keys,
  // tile by tile
  uint32_t qa[NF][4], da[NF][4];
  float m0 = -INFINITY, m1 = -INFINITY, e0 = 0.f, e1 = 0.f;
  for (int i = 0; i < nt; ++i) {
    wait(i);
    if (FREG && i == 0) {
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {
        const int at = (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(qa[kk], qs + at);
        ldsm_x4(da[kk], dos + at);
      }
    }
    const __nv_bfloat16* kt = ring + (i & 1) * 2 * STAGE + kw * LD;
    float s[2][4];
    if constexpr (FREG)
      xyt<KS, LD>(s, qa, kt, lane);
    else
      xyt<KS, LD>(s, qs, kt, lane);
    const int key = (first + i) * BK + kw + 2 * cq;
    float l0[4], l1[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 a0 = logits(s[j][0], s[j][1], false, a.scale);
      const float2 a1 = logits(s[j][2], s[j][3], false, a.scale);
      const int k = key + 8 * j;
      l0[2 * j] = is_live(k, lo0, n0) ? a0.x : -INFINITY;
      l0[2 * j + 1] = is_live(k + 1, lo0, n0) ? a0.y : -INFINITY;
      l1[2 * j] = is_live(k, lo1, n1) ? a1.x : -INFINITY;
      l1[2 * j + 1] = is_live(k + 1, lo1, n1) ? a1.y : -INFINITY;
    }
    online_exp_sum(m0, e0, l0);
    online_exp_sum(m1, e1, l1);
    __syncthreads();                      // the stage is free to refill
    fetch(i + 2);
  }
  // the quad, then the warps in order
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float mx0 = __shfl_xor_sync(0xffffffffu, m0, off);
    const float ex0 = __shfl_xor_sync(0xffffffffu, e0, off);
    const float mx1 = __shfl_xor_sync(0xffffffffu, m1, off);
    const float ex1 = __shfl_xor_sync(0xffffffffu, e1, off);
    merge_exp_sum(m0, e0, mx0, ex0);
    merge_exp_sum(m1, e1, mx1, ex1);
  }
  if (cq == 0) {
    wmax[warp * ROWS + r0] = m0;
    wsum[warp * ROWS + r0] = e0;
    wmax[warp * ROWS + r1] = m1;
    wsum[warp * ROWS + r1] = e1;
  }
  __syncthreads();
  if (tid < ROWS) {
    float m = wmax[tid], e = wsum[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) merge_exp_sum(m, e, wmax[w * ROWS + tid], wsum[w * ROWS + tid]);
    const float lse = rown[tid] > 0 ? m + logf(e) : 0.f;
    rlse[tid] = lse;
    int g;
    const int s = tile_row(f0 + tid, G, g);
    if (s < Sq) {
      const size_t lr = (static_cast<size_t>(b) * a.Hq + hk * G + g) * Sq + s;
      a.lse[lr] = lse;
      a.delta[lr] = rd[tid];
    }
  }
  __syncthreads();

  // ---- pass 2: S and dP = dO V^T again; dS = p (dP - D), exactly 0 at a
  // dead key; dQ += bf16(dS * scale) K over the warp's keys of every tile
  const float L0 = rlse[r0], L1 = rlse[r1], D0 = rd[r0], D1 = rd[r1];
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  for (int i = 0; i < nt; ++i) {
    wait(nt + i);
    const __nv_bfloat16* kt = ring + ((nt + i) & 1) * 2 * STAGE + kw * LD;
    const __nv_bfloat16* vt = kt + STAGE;
    float s[2][4], dp[2][4];
    if constexpr (FREG) {
      xyt<KS, LD>(s, qa, kt, lane);
      xyt<KS, LD>(dp, da, vt, lane);
    } else {
      xyt<KS, LD>(s, qs, kt, lane);
      xyt<KS, LD>(dp, dos, vt, lane);
    }
    const int key = (first + i) * BK + kw + 2 * cq;
    float ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 a0 = logits(s[j][0], s[j][1], false, a.scale);
      const float2 a1 = logits(s[j][2], s[j][3], false, a.scale);
      const float l[4] = {a0.x, a0.y, a1.x, a1.y};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool top = x < 2;
        const int k = key + 8 * j + (x & 1);
        const float p = expf(__fsub_rn(l[x], top ? L0 : L1));
        const float g = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[j][x], top ? D0 : D1)), a.scale);
        ds[j][x] = is_live(k, top ? lo0 : lo1, top ? n0 : n1) ? g : 0.f;
      }
    }
    const uint32_t pa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                            pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
    pxy<NO, LD>(dq, pa, kt, lane);
    __syncthreads();                      // the stage is free to refill
    fetch(nt + i + 2);
  }

  // ---- dQ: the warps' partials added in warp order (the stages are dead:
  // their room holds them)
#pragma unroll
  for (int j = 0; j < NO; ++j)
    ocomb[(warp * NO + j) * 32 + lane] = make_float4(dq[j][0], dq[j][1], dq[j][2], dq[j][3]);
  __syncthreads();
  // element f = j * 32 + l: lane l's n8 tile j, rows l / 4 and l / 4 + 8,
  // columns 8 j + 2 (l % 4), +1
  for (int f = tid; f < NO * 32; f += NT) {
    float4 t = ocomb[f];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 u = ocomb[w * NO * 32 + f];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    const int j = f >> 5, l = f & 31, col = 8 * j + 2 * (l & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int g;
      const int s = tile_row(f0 + (l >> 2) + 8 * h, G, g);
      if (s >= Sq || col >= hd) continue;
      tc::store2(a.dq, row_at(s, g) + col, col + 1 < hd && (hd & 1) == 0, col + 1 < hd,
                 h ? t.z : t.x, h ? t.w : t.y);
    }
  }
}

template <int HDP, int NH>
__global__ void __launch_bounds__(32 * dkv_warps(HDP), HDP <= 64 ? 2 : 1)
    attention_bwd_dkv_tc_kernel(const BwdArgs<__nv_bfloat16> a) {
  constexpr int WARPS = dkv_warps(HDP), NT = 32 * WARPS;
  constexpr int LD = HDP + 8;             // padded rows: conflict-free ldmatrix
  constexpr int KS = HDP / 16;            // MMA steps over the head dim
  constexpr int OC = HDP / NH;            // the block's columns of dK and dV
  constexpr int NO = OC / 8;              // their n8 tiles
  constexpr int TILE = ROWS * LD;         // bf16 elements of a 16-row tile
  const int stage_bytes = dkv_stage_bytes(HDP);
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* kts = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vts = kts + TILE;
  uint8_t* stages = smem + 2 * TILE * 2;  // warp w's stage i at (2 w + i) * stage_bytes
  float4* comb = reinterpret_cast<float4*>(stages);  // at the end: [dV, dK][warp][NO][32]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int G = a.Hq / a.Hkv, Sq = a.Sq, A = a.A, hd = a.hd;
  const int KT = (A + DKV_KEYS - 1) / DKV_KEYS;
  const int hk = blockIdx.x / (KT * NH), rest = blockIdx.x - hk * (KT * NH);
  const int kt = rest / NH, c0 = (rest - kt * NH) * OC, b = blockIdx.y;
  const int j0 = kt * DKV_KEYS, j1 = min(A, j0 + DKV_KEYS);
  const int RT = static_cast<int>((static_cast<long long>(Sq) * G + ROWS - 1) / ROWS);
  const int* qp = a.qpos + static_cast<size_t>(b) * Sq;

  // every tile's columns past hd stay zero (loads write [0, hd) only)
  if (hd < HDP)
    for (int e = tid; e < (2 + 4 * WARPS) * ROWS * (HDP - hd); e += NT) {
      const int r = e / (HDP - hd), t = r / ROWS;
      __nv_bfloat16* base =
          t < 2 ? kts + t * TILE
                : reinterpret_cast<__nv_bfloat16*>(stages + ((t - 2) >> 1) * stage_bytes) +
                      ((t - 2) & 1) * TILE;
      base[(r - t * ROWS) * LD + hd + (e - r * (HDP - hd))] = __float2bfloat16(0.f);
    }
  __syncthreads();
  const long long kv_stride = static_cast<long long>(a.Hkv) * hd;
  copy_rows<LD, DKV_KEYS, NT>(kts, a.k + b * a.k_bstride + static_cast<size_t>(hk) * hd,
                              kv_stride, j0, A, hd, a.vec, tid);
  copy_rows<LD, DKV_KEYS, NT>(vts, a.v + b * a.v_bstride + static_cast<size_t>(hk) * hd,
                              kv_stride, j0, A, hd, a.vec, tid);
  tc::cp_async_commit();

  // whether row tile rt holds a row whose live keys meet [j0, j1), or a row
  // with none (the even softmax reaches every key)
  auto needed = [&](int rt) {
    const long long f = static_cast<long long>(rt) * ROWS;
    const int s0 = static_cast<int>(f / G);
    const int s1 = static_cast<int>(min(static_cast<long long>(Sq) - 1, (f + ROWS - 1) / G));
    bool need = false;
    for (int s = s0; s <= s1; ++s) {
      int lo, n;
      live_keys(qp[s], A, a.window, lo, n);
      need |= lo < 0 || (lo < j1 && n > j0);
    }
    return need;
  };
  // the warp's needed row tiles among warp, warp + WARPS, ..., in order;
  // each lane tests one of the next 32
  int base = warp - 32 * WARPS;
  unsigned cand = 0u;
  auto next = [&]() {
    while (!cand) {
      base += 32 * WARPS;
      if (base >= RT) return RT;
      const int rt = base + lane * WARPS;
      cand = __ballot_sync(0xffffffffu, rt < RT && needed(rt));
    }
    const int bit = __ffs(cand) - 1;
    cand &= cand - 1;
    return base + bit * WARPS;
  };
  // row tile rt into the warp's stage i: the Q tile, the dO tile, then the
  // rows' lse, D and positions
  auto fetch = [&](int rt, int i) {
    uint8_t* sb = stages + (2 * warp + i) * stage_bytes;
    __nv_bfloat16* qd = reinterpret_cast<__nv_bfloat16*>(sb);
    float* sl = reinterpret_cast<float*>(sb + 2 * TILE * 2);
    const long long f = static_cast<long long>(rt) * ROWS;
    const int CH = (hd + 7) / 8;
    for (int e = lane; e < ROWS * CH; e += 32) {
      const int r = e / CH, c = (e - r * CH) * 8;
      int g;
      const int s = tile_row(f + r, G, g);
      const size_t o =
          s < Sq ? ((static_cast<size_t>(b) * Sq + s) * a.Hq + hk * G + g) * hd + c : 0;
      bwd_chunk(qd + r * LD + c, a.q + o, s < Sq, hd - c, a.vec);
      bwd_chunk(qd + TILE + r * LD + c, a.dout + o, s < Sq, hd - c, a.vec);
    }
    if (lane < ROWS) {
      int g;
      const int s = tile_row(f + lane, G, g);
      if (s < Sq) {
        const size_t lr = (static_cast<size_t>(b) * a.Hq + hk * G + g) * Sq + s;
        cp_async4(sl + lane, a.lse + lr);
        cp_async4(sl + ROWS + lane, a.delta + lr);
        cp_async4(sl + 2 * ROWS + lane, qp + s);
      } else {
        sl[lane] = sl[ROWS + lane] = 0.f;
        reinterpret_cast<int*>(sl)[2 * ROWS + lane] = 0;
      }
    }
    tc::cp_async_commit();
  };

  const float even = __bfloat162float(__float2bfloat16_rn(1.f / static_cast<float>(A)));
  const int ja = j0 + gq, jb = ja + 8;    // the thread's keys (accumulator rows)
  float dv[NO][4], dk[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
  // the warp's i-th row tile loads into stage i & 1: cur is computed while
  // nxt arrives
  int cur = next();
  if (cur < RT) fetch(cur, 0);
  int nxt = cur < RT ? next() : RT;
  if (nxt < RT) fetch(nxt, 1);
  tc::cp_async_wait<0>();                 // the K and V tiles, the first two row tiles
  __syncthreads();
  for (int i = 0; cur < RT; ++i) {
    if (i > 0) {
      if (nxt < RT)
        tc::cp_async_wait<1>();
      else
        tc::cp_async_wait<0>();
      __syncwarp();
    }
    const uint8_t* sb = stages + (2 * warp + (i & 1)) * stage_bytes;
    const __nv_bfloat16* qt = reinterpret_cast<const __nv_bfloat16*>(sb);
    const __nv_bfloat16* dt = qt + TILE;
    const float* sl = reinterpret_cast<const float*>(sb + 2 * TILE * 2);
    const int* sp = reinterpret_cast<const int*>(sl + 2 * ROWS);
    // S^T = K Q^T and dP^T = V dO^T: accumulator row = key, column = row
    float st[2][4], dpt[2][4];
    xyt<KS, LD>(st, kts, qt, lane);
    xyt<KS, LD>(dpt, vts, dt, lane);
    float p[2][4], ds[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 la = logits(st[j][0], st[j][1], false, a.scale);
      const float2 lb = logits(st[j][2], st[j][3], false, a.scale);
      const float l[4] = {la.x, la.y, lb.x, lb.y};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 8 * j + 2 * cq + c;
        int g, lo = 0, n = 0;
        if (tile_row(static_cast<long long>(cur) * ROWS + r, G, g) < Sq)
          live_keys(sp[r], A, a.window, lo, n);
        const float lse = sl[r], d = sl[ROWS + r];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 2 * h + c;
          const bool live = lo >= 0 && is_live(h ? jb : ja, lo, n);
          const float pf = expf(__fsub_rn(l[x], lse));
          const float gs = __fmul_rn(__fmul_rn(pf, __fsub_rn(dpt[j][x], d)), a.scale);
          p[j][x] = lo < 0 ? even : live ? pf : 0.f;
          ds[j][x] = live ? gs : 0.f;
        }
      }
    }
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
    const uint32_t sa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                            pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
    pxy<NO, LD>(dv, pa, dt + c0, lane);
    pxy<NO, LD>(dk, sa, qt + c0, lane);
    __syncwarp();                         // the stage is free to refill
    cur = nxt;
    nxt = cur < RT ? next() : RT;
    if (nxt < RT) fetch(nxt, i & 1);
  }

  // ---- the warps' partial dV and dK added in warp order
  __syncthreads();                        // every warp is done with its stages
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    comb[(warp * NO + j) * 32 + lane] = make_float4(dv[j][0], dv[j][1], dv[j][2], dv[j][3]);
    comb[((WARPS + warp) * NO + j) * 32 + lane] =
        make_float4(dk[j][0], dk[j][1], dk[j][2], dk[j][3]);
  }
  __syncthreads();
  for (int f = tid; f < 2 * NO * 32; f += NT) {
    const int m = f / (NO * 32), e = f - m * NO * 32;
    float4 t = comb[m * WARPS * NO * 32 + e];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 u = comb[(m * WARPS + w) * NO * 32 + e];
      t.x += u.x;
      t.y += u.y;
      t.z += u.z;
      t.w += u.w;
    }
    const int j = e >> 5, l = e & 31, col = c0 + 8 * j + 2 * (l & 3);
    __nv_bfloat16* out = m ? a.dk : a.dv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = j0 + (l >> 2) + 8 * h;
      if (key >= A || col >= hd) continue;
      tc::store2(out, ((static_cast<size_t>(b) * A + key) * a.Hkv + hk) * hd + col,
                 col + 1 < hd && (hd & 1) == 0, col + 1 < hd, h ? t.z : t.x, h ? t.w : t.y);
    }
  }
}

template <int HDP>
int launch_bwd_tc(const BwdArgs<__nv_bfloat16>& a, bool dkv, cudaStream_t stream) {
  if (dkv) {
    constexpr int NH = dkv_halves(HDP);
    const long long blocks =
        static_cast<long long>((a.A + DKV_KEYS - 1) / DKV_KEYS) * NH * a.Hkv;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = tc::allow_smem<attention_bwd_dkv_tc_kernel<HDP, NH>>(SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attention_bwd_dkv_tc_kernel<HDP, NH>
        <<<dim3(static_cast<unsigned>(blocks), a.B), 32 * dkv_warps(HDP), dkv_smem(HDP),
           stream>>>(a);
  } else {
    const long long blocks =
        (static_cast<long long>(a.Sq) * (a.Hq / a.Hkv) + ROWS - 1) / ROWS * a.Hkv;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = tc::allow_smem<attention_bwd_dq_tc_kernel<HDP>>(SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attention_bwd_dq_tc_kernel<HDP>
        <<<dim3(static_cast<unsigned>(blocks), a.B), NT, dq_smem(HDP), stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 takes the tensor-core kernels, at the head dim padded as the forward's
int launch_bwd(const BwdArgs<__nv_bfloat16>& a, bool dkv, cudaStream_t stream) {
  if (a.B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (pad_hd(a.hd)) {
    case 16: return launch_bwd_tc<16>(a, dkv, stream);
    case 32: return launch_bwd_tc<32>(a, dkv, stream);
    case 64: return launch_bwd_tc<64>(a, dkv, stream);
    case 128: return launch_bwd_tc<128>(a, dkv, stream);
    default: return launch_bwd_tc<256>(a, dkv, stream);
  }
}

}  // namespace

// C entry point, loaded with ctypes. q, k, v and out share `dtype`;
// `window` > 0 masks the keys at or below qpos - window (0: none); `nq`,
// null or (B,) int32, bounds the queries computed per batch row (the rest
// are zeros).
// Launches on `stream` and returns a CUDA error code, 0 on success
// (cudaErrorInvalidValue for shapes or dtypes the kernel does not take:
// hd > 256, B > 65535, a negative window, more blocks than a grid holds).
// A cache whose logits do not fit a block's shared memory takes the
// streaming kernel.
extern "C" int row_attention_launch(const void* q, const void* k, const void* v, const void* qpos,
                                    const void* nq, void* out, int B, int Sq, int Hq, int Hkv,
                                    int A, int hd, int window, long long k_bstride,
                                    long long v_bstride, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || A <= 0 || hd <= 0 || hd > 256 ||
      B > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32) {
    if (static_cast<long long>(Hq) * Sq > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    if (f32_smem(A, hd) + sizeof(float) * F32_WARPS > SMEM_MAX) {
      if (hd <= 32)
        return launch_f32_stream<1>(q, k, v, qpos, nq, out, B, Sq, Hq, Hkv, A, hd, window,
                                    k_bstride, v_bstride, scale, s);
      if (hd <= 64)
        return launch_f32_stream<2>(q, k, v, qpos, nq, out, B, Sq, Hq, Hkv, A, hd, window,
                                    k_bstride, v_bstride, scale, s);
      if (hd <= 128)
        return launch_f32_stream<4>(q, k, v, qpos, nq, out, B, Sq, Hq, Hkv, A, hd, window,
                                    k_bstride, v_bstride, scale, s);
      return launch_f32_stream<8>(q, k, v, qpos, nq, out, B, Sq, Hq, Hkv, A, hd, window,
                                  k_bstride, v_bstride, scale, s);
    }
    if (hd <= 32)
      return launch_f32<1>(q, k, v, qpos, nq, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                           v_bstride, scale, s);
    if (hd <= 64)
      return launch_f32<2>(q, k, v, qpos, nq, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                           v_bstride, scale, s);
    if (hd <= 128)
      return launch_f32<4>(q, k, v, qpos, nq, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                           v_bstride, scale, s);
    return launch_f32<8>(q, k, v, qpos, nq, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                         v_bstride, scale, s);
  }
  if (dtype != BF16) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(A, hd);
  const int G = Hq / Hkv;
  const long long rows = static_cast<long long>(Sq) * G;
  const long long row_blocks = (rows + ROWS - 1) / ROWS;
  if (p.smem > SMEM_MAX || row_blocks * Hkv > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.qpos = static_cast<const int32_t*>(qpos);
  a.nq = static_cast<const int32_t*>(nq);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.k_bstride = k_bstride;
  a.v_bstride = v_bstride;
  a.Sq = Sq;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.G = G;
  a.A = A;
  a.hd = hd;
  a.window = window;
  a.row_blocks = static_cast<int>(row_blocks);
  a.tiles_per_rank = p.tiles_per_rank;
  a.splits = p.splits;
  a.vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && k_bstride % 8 == 0 &&
          v_bstride % 8 == 0;
  a.scale = scale;
  switch (p.hdp) {
    case 16: return p.stream ? launch_stream<16>(a, B, p, s) : launch_tc<16>(a, B, p, s);
    case 32: return p.stream ? launch_stream<32>(a, B, p, s) : launch_tc<32>(a, B, p, s);
    case 64: return p.stream ? launch_stream<64>(a, B, p, s) : launch_tc<64>(a, B, p, s);
    case 128: return p.stream ? launch_stream<128>(a, B, p, s) : launch_tc<128>(a, B, p, s);
    default: return p.stream ? launch_stream<256>(a, B, p, s) : launch_tc<256>(a, B, p, s);
  }
}

namespace {

template <typename T>
int bwd_entry(const void* q, const void* k, const void* v, const void* qpos, const void* out,
              const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta, int B,
              int Sq, int Hq, int Hkv, int A, int hd, int window, long long k_bstride,
              long long v_bstride, float scale, bool dkv, cudaStream_t stream) {
  BwdArgs<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.out = static_cast<const T*>(out);
  a.dout = static_cast<const T*>(dout);
  a.qpos = static_cast<const int32_t*>(qpos);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.k_bstride = k_bstride;
  a.v_bstride = v_bstride;
  a.B = B;
  a.Sq = Sq;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.A = A;
  a.hd = hd;
  a.window = window;
  a.scale = scale;
  a.vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
          k_bstride % 8 == 0 && v_bstride % 8 == 0;
  return launch_bwd(a, dkv, stream);     // bf16: the tensor-core overload
}

int bwd_dispatch(const void* q, const void* k, const void* v, const void* qpos, const void* out,
                 const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta, int B,
                 int Sq, int Hq, int Hkv, int A, int hd, int window, long long k_bstride,
                 long long v_bstride, float scale, int dtype, bool dkv, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || A <= 0 || hd <= 0 ||
      hd > BWD_MAX_HD || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return bwd_entry<float>(q, k, v, qpos, out, dout, dq, dk, dv, lse, delta, B, Sq, Hq, Hkv, A,
                            hd, window, k_bstride, v_bstride, scale, dkv, s);
  if (dtype == BF16)
    return bwd_entry<__nv_bfloat16>(q, k, v, qpos, out, dout, dq, dk, dv, lse, delta, B, Sq, Hq,
                                    Hkv, A, hd, window, k_bstride, v_bstride, scale, dkv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Backward kernel (a), loaded with ctypes: dq (q's layout and dtype) and
// the rows' lse and delta (B, Hq, Sq) float32 from q, the cache k / v (the
// forward's layout and batch strides), qpos, the forward's out and dout
// (q's layout). Returns cudaGetLastError() (cudaErrorInvalidValue for
// shapes it does not take).
extern "C" int row_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                           const void* qpos, const void* out, const void* dout,
                                           void* dq, void* lse, void* delta, int B, int Sq,
                                           int Hq, int Hkv, int A, int hd, int window,
                                           long long k_bstride, long long v_bstride,
                                           float scale, int dtype, void* stream) {
  return bwd_dispatch(q, k, v, qpos, out, dout, dq, nullptr, nullptr,
                      lse, delta, B, Sq, Hq, Hkv, A, hd, window, k_bstride, v_bstride, scale,
                      dtype, false, stream);
}

// Backward kernel (b): dk, dv (B, A, Hkv, hd) contiguous, in the cache's
// dtype, from q, k, v, qpos, dout and kernel (a)'s lse and delta; launch
// it after (a) on the same stream.
extern "C" int row_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                            const void* qpos, const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int B, int Sq,
                                            int Hq, int Hkv, int A, int hd, int window,
                                            long long k_bstride, long long v_bstride,
                                            float scale, int dtype, void* stream) {
  return bwd_dispatch(q, k, v, qpos, nullptr, dout, nullptr, dk, dv, const_cast<void*>(lse),
                      const_cast<void*>(delta), B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                      v_bstride, scale, dtype, true, stream);
}
