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
//     to each of the block's rows: every live key is added at the same
//     place in the same order as without the skip, and with window 0 the
//     kernel is the one without a window. The f32 kernels mask instead: a
//     key below the bound gets a -inf logit, so its probability is an
//     exact zero and the sums see the same live terms in the same order.
//
// Caches whose logits do not fit a block's shared memory take streaming
// kernels of their own (chosen from (A, hd) alone): they recompute the
// logits in each pass instead of keeping them, with the same sums in the
// same orders (below).
//
// f32 keeps exact fp32 on the CUDA cores (TF32 would break the 1e-5
// contract): one block of four warps per (query, head), lanes over the
// head dims, the logits in shared memory, orders fixed by hd alone.

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
  __nv_bfloat16* out;
  long long k_bstride, v_bstride;
  int Sq, Hq, Hkv, G, A, hd, window, row_blocks, tiles_per_rank, splits, vec;
  float scale;
};

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

// Rows [row0, row0 + BK) of a (A, row_stride) bf16 array into a stage
// (row stride LD), columns [0, hd); rows past A are zeros. 16-byte
// cp.async when every row is 16-byte aligned, else element by element:
// the stage holds the same values either way.
template <int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int A, int hd,
                                          bool vec, int tid) {
  if (vec) {
    const int chunks = hd / 8;
    for (int e = tid; e < BK * chunks; e += NT) {
      const int r = e / chunks, c = (e - r * chunks) * 8;
      __nv_bfloat16* d = dst + r * LD + c;
      if (row0 + r < A)
        tc::cp_async16(d, src + (row0 + r) * row_stride + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = tid; e < BK * hd; e += NT) {
      const int r = e / hd, c = e - r * hd;
      dst[r * LD + c] = row0 + r < A ? src[(row0 + r) * row_stride + c] : __float2bfloat16(0.f);
    }
  }
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

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int rank = blockIdx.z;
  const int rb = blockIdx.x % a.row_blocks, hk = blockIdx.x / a.row_blocks, b = blockIdx.y;
  const int A = a.A, G = a.G, Sq = a.Sq, hd = a.hd;
  const bool vec = a.vec != 0;

  // each row's live keys [max(rlo, 0), rown): none for rows past the
  // call's, all A (rlo = -1) when all are masked
  if (tid < ROWS) {
    const int s = (rb * ROWS + tid) / G;
    int n = 0, lo = 0;
    if (s < Sq) live_keys(a.qpos[b * Sq + s], A, a.window, lo, n);
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
    // the block's queries (zeros past hd and past the call's rows) arrive
    // with the first K tile
    for (int e = tid; e < ROWS * (HDP / 8); e += NT) {
      const int r = e / (HDP / 8), c = (e - r * (HDP / 8)) * 8;
      const int f = rb * ROWS + r, s = f / G, g = f - s * G;
      __nv_bfloat16* d = qs + r * LD + c;
      const __nv_bfloat16* src =
          a.q + ((static_cast<size_t>(b) * Sq + s) * a.Hq + hk * G + g) * hd + c;
      if (s < Sq && vec && c + 8 <= hd) {
        tc::cp_async16(d, src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d[i] = s < Sq && c + i < hd ? src[i] : __float2bfloat16(0.f);
      }
    }
    issue(0);
    issue(1);
  }

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
  if (tid < ROWS) {
    float m = wred[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, wred[w * ROWS + tid]);
    pmax[tid] = m;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (C > 1) cluster.sync(); else __syncthreads();
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
      const float x = h ? t.z : t.x, y = h ? t.w : t.y;
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

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, cq = lane & 3;
  const int rank = blockIdx.z;
  const int rb = blockIdx.x % a.row_blocks, hk = blockIdx.x / a.row_blocks, b = blockIdx.y;
  const int A = a.A, G = a.G, Sq = a.Sq, hd = a.hd;
  const bool vec = a.vec != 0;

  // each row's live keys [max(rlo, 0), rown): none for rows past the
  // call's, all A (rlo = -1) when all are masked
  if (tid < ROWS) {
    const int s = (rb * ROWS + tid) / G;
    int n = 0, lo = 0;
    if (s < Sq) live_keys(a.qpos[b * Sq + s], A, a.window, lo, n);
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
    // the block's queries (zeros past hd and past the call's rows) arrive
    // with the first K tile
    for (int e = tid; e < ROWS * (HDP / 8); e += NT) {
      const int r = e / (HDP / 8), c = (e - r * (HDP / 8)) * 8;
      const int f = rb * ROWS + r, s = f / G, g = f - s * G;
      __nv_bfloat16* d = qs + r * LD + c;
      const __nv_bfloat16* src =
          a.q + ((static_cast<size_t>(b) * Sq + s) * a.Hq + hk * G + g) * hd + c;
      if (s < Sq && vec && c + 8 <= hd) {
        tc::cp_async16(d, src);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d[i] = s < Sq && c + i < hd ? src[i] : __float2bfloat16(0.f);
      }
    }
    for (int i = 0; i < NS; ++i) issue(i);
  }

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
  if (tid < ROWS) {
    float m = wred[tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, wred[w * ROWS + tid]);
    pmax[tid] = m;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (C > 1) cluster.sync(); else __syncthreads();
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
      const float x = h ? t.z : t.x, y = h ? t.w : t.y;
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
                     float* __restrict__ out, int Sq, int Hq, int Hkv, int A, int hd,
                     int window, long long k_bstride, long long v_bstride, float scale) {
  extern __shared__ float fsmem[];
  __shared__ float red[F32_WARPS];
  float* p = fsmem;                       // A: logits, then probabilities
  float* part = p + A;                    // F32_WARPS * hd partial output sums

  const int h = blockIdx.x % Hq, s = blockIdx.x / Hq, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = h / (Hq / Hkv);
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
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) part[warp * hd + d] = acc[i];
  }
  __syncthreads();
  float* orow = out + ((static_cast<size_t>(b) * Sq + s) * Hq + h) * hd;
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
int launch_f32(const void* q, const void* k, const void* v, const void* qpos, void* out, int B,
               int Sq, int Hq, int Hkv, int A, int hd, int window, long long k_bstride,
               long long v_bstride, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem(A, hd);
  if (smem + sizeof(float) * F32_WARPS > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_f32_kernel<NDL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attention_f32_kernel<NDL><<<dim3(Hq * Sq, B), F32_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(qpos), static_cast<float*>(out), Sq, Hq, Hkv, A, hd, window,
      k_bstride, v_bstride, scale);
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
                            float* __restrict__ out, int Sq, int Hq, int Hkv, int A, int hd,
                            int window, long long k_bstride, long long v_bstride,
                            float scale) {
  extern __shared__ float fsmem[];
  __shared__ float red[F32_WARPS];
  float* p = fsmem;                       // F32_NT: a chunk's logits, then probabilities
  float* part = p + F32_NT;               // F32_WARPS * hd partial output sums

  const int h = blockIdx.x % Hq, s = blockIdx.x / Hq, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = h / (Hq / Hkv);
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
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) part[warp * hd + d] = acc[i];
  }
  __syncthreads();
  float* orow = out + ((static_cast<size_t>(b) * Sq + s) * Hq + h) * hd;
  for (int d = tid; d < hd; d += F32_NT) {
    float o = part[d];
#pragma unroll
    for (int w = 1; w < F32_WARPS; ++w) o += part[w * hd + d];
    orow[d] = o;
  }
}

template <int NDL>
int launch_f32_stream(const void* q, const void* k, const void* v, const void* qpos, void* out,
                      int B, int Sq, int Hq, int Hkv, int A, int hd, int window,
                      long long k_bstride, long long v_bstride, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (F32_NT + static_cast<size_t>(F32_WARPS) * hd);
  attention_f32_stream_kernel<NDL><<<dim3(Hq * Sq, B), F32_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(qpos), static_cast<float*>(out), Sq, Hq, Hkv, A, hd, window,
      k_bstride, v_bstride, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// C entry point, loaded with ctypes. q, k, v and out share `dtype`;
// `window` > 0 masks the keys at or below qpos - window (0: none).
// Launches on `stream` and returns a CUDA error code, 0 on success
// (cudaErrorInvalidValue for shapes or dtypes the kernel does not take:
// hd > 256, B > 65535, a negative window, more blocks than a grid holds).
// A cache whose logits do not fit a block's shared memory takes the
// streaming kernel.
extern "C" int row_attention_launch(const void* q, const void* k, const void* v, const void* qpos,
                                    void* out, int B, int Sq, int Hq, int Hkv, int A, int hd,
                                    int window, long long k_bstride, long long v_bstride,
                                    float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || A <= 0 || hd <= 0 || hd > 256 ||
      B > 65535 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32) {
    if (static_cast<long long>(Hq) * Sq > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    if (f32_smem(A, hd) + sizeof(float) * F32_WARPS > SMEM_MAX) {
      if (hd <= 32)
        return launch_f32_stream<1>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                                    v_bstride, scale, s);
      if (hd <= 64)
        return launch_f32_stream<2>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                                    v_bstride, scale, s);
      if (hd <= 128)
        return launch_f32_stream<4>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                                    v_bstride, scale, s);
      return launch_f32_stream<8>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride,
                                  v_bstride, scale, s);
    }
    if (hd <= 32)
      return launch_f32<1>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride, v_bstride,
                           scale, s);
    if (hd <= 64)
      return launch_f32<2>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride, v_bstride,
                           scale, s);
    if (hd <= 128)
      return launch_f32<4>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride, v_bstride,
                           scale, s);
    return launch_f32<8>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, window, k_bstride, v_bstride,
                         scale, s);
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
