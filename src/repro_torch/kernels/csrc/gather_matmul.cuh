// Gathered-K matmul for Hopper (sm_90a), shared by `joint_sparse_matmul.cu`
// and `block_sparse_matmul.cu`: the compacted layout of the joint and
// value-level sparse weights.
//
//   y[m, n*bn + c] = cast( s[n*bn + c] *
//       sum_{b < MAXB} sum_{k < bk} x[m, idx[n, b]*bk + k] * float(w[n, b, k, c]) )
//
// x (M, K) row-major; w (NT, MAXB, bk, bn), the surviving K-blocks of each
// N tile (zero payload in padded slots); idx (NT, MAXB) int32; s the
// per-filter scales (NT * bn,) f32, or none (s = 1); y (M, NT * bn). Any M;
// bk <= 128, bk % 8 == 0, bn % 8 == 0, K % bk == 0.
//
// Two kernels:
//   * bf16 x: `gathered_tc_kernel`, on the tensor cores. Exactness: an
//     int8 or bf16 payload value times a bf16 x value is exact in fp32, so
//     the bf16 `wgmma` with fp32 accumulators forms the plain version's
//     products; only the order of the fp32 sums differs.
//   * f32 x: `gathered_fp32_kernel`, true fp32 FMAs on the CUDA cores. TF32
//     would keep about three decimal digits and break the 1e-5 * max|ref|
//     contract of f32 activations, so f32 x stays off the tensor cores.
//
// Bound. At decode (M = 4 rows) the kernel does 8 flops per stored weight
// value and is bound by device-memory bytes: the payload, read once. At
// 256 rows bytes and bf16 tensor-core operations are about even for the
// wide projections; the narrow ones stay bound by bytes.
//
// Design of the tensor-core kernel. The product runs transposed,
// y^T = w^T x^T, on `wgmma` m64n64k16: one block per (64 output columns
// of one N tile, RT row tiles of 64 rows of x, split), one consumer
// warpgroup and one producer warp.
//   * K runs over tiles of 64: slot b of the N tile gives ceil(bk / 64)
//     tiles. The producer warp reads the N tile's idx row once (32 slots per
//     load, one per lane, handed to lane 0 by shuffle) and keeps a ring of
//     tiles in flight. With TMA each stage is two boxes: x seen as a 3-D
//     array (M, K / bk, bk), box (64 RT rows, block idx[n, b], 64 k) in the
//     128-byte-swizzled layout `wgmma` reads; and the payload seen as a 4-D
//     array (NT, MAXB, bk, bn), box (n, b, 64 k, 64 columns); the first
//     idx batch is read while the block sets up. TMA fills the parts outside
//     either array with zeros: rows past M, k past bk (a bk that is not a
//     multiple of 64), columns past bn. Those zeros add +0. Arrays that TMA
//     cannot take (a base or a row not 16-byte aligned: an int8 payload with
//     bn % 16 != 0) arrive by cp.async from the producer warp into the same
//     layouts, zeros written where TMA would fill them, one row tile a block.
//   * The payload is operand A, read from the ring into registers once per
//     tile and used for all RT row tiles: an int8 tile by ldmatrix.trans and
//     widened to bf16 with integer and fp32 adds (tc::load_a_s8; its columns
//     come in a permuted order the store undoes), a bf16 tile
//     (128-byte-swizzled rows) by ldmatrix.trans as it is. x is operand B,
//     read by the tensor cores straight from the ring. Tile j's operands are
//     loaded into registers while the tensor cores still multiply tile
//     j - 1; a stage goes back to the producer once its products are done.
//   * RT sets how many row tiles share one read and one widening of each
//     payload tile: the fewest whose grid fits one wave of the SMs
//     (launch_tc below), so wide projections at prefill reuse each payload
//     tile for up to 256 rows and narrow ones spread over more SMs.
//   * Few output tiles split K over a thread-block cluster: the block of
//     rank r takes K tiles [KT * r / splits, KT * (r + 1) / splits). Each
//     block sends the partial sums of the outputs another rank stores
//     straight into that rank's park (distributed shared memory) and, after
//     one cluster barrier, adds the partials of its own outputs in rank
//     order. The split count comes from (NT, MAXB, bk, bn) alone
//     (split_count below).
//   * The scale is applied once per output at the store, then the cast.
//
// Row stability: every output sums its K tiles in order, each 16-deep step
// in the tensor core's fixed order, and its splits in rank order; every
// output comes from the same m64n64k16 instruction (M = 4 is 64 rows with 60
// of zeros; RT only says how many of them one block issues per tile), and
// the split count does not depend on M. A row comes out bitwise the same
// whatever M is, which chunked prefill == stepwise decode rests on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "tc_tile.cuh"

// Internal linkage: the joint and block-sparse libraries both hold these
// kernels, and a static of an inline function or template with external
// linkage (tc::allow_smem's per-kernel flag, the map cache) would be one
// object across every library loaded into the process.
namespace gather {
namespace {

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

constexpr int MAX_BK = 128;

// The operands of one call.
struct Args {
  const void* x;          // (M, K)
  const void* w;          // (NT, MAXB, bk, bn)
  const int32_t* idx;     // (NT, MAXB)
  const float* scales;    // (NT * bn,), or null: no scale
  void* y;                // (M, NT * bn)
  int M, K, NT, MAXB, bk, bn;
};

__host__ inline bool valid(const Args& a) {
  return a.M > 0 && a.NT > 0 && a.MAXB > 0 && a.bk > 0 && a.bk <= MAX_BK && a.bk % 8 == 0 &&
         a.bn > 0 && a.bn % 8 == 0 && a.K > 0 && a.K % a.bk == 0;
}

// ---- bf16 x: the tensor cores ---------------------------------------------

constexpr int BN = 64;                    // output columns per block: wgmma M
constexpr int BM = 64;                    // rows of x per row tile: wgmma N
constexpr int KT = 64;                    // K tile: four wgmma K steps
constexpr int NTHREADS = 128;             // one consumer warpgroup
constexpr int BLOCK = NTHREADS + 32;      // + the producer warp
constexpr int ACC = BN * BM / NTHREADS;   // fp32 accumulators per thread and row tile

// Split K. At decode a projection has NT * ceil(bn / 64) column tiles (wq
// 32, wk and wv 4, w_gate and w_up 88, w_down 32 at tinyllama's widths) and
// each a K loop of MAXB * ceil(bk / 64) tiles, which one block runs one
// after another. A split moves tiles off that critical path but adds the
// combine (a cluster barrier and the partials through distributed shared
// memory), which costs about as much as a few K tiles at decode and more at
// 256 rows (four row tiles of partials). So only projections with few
// column tiles split: the split count is the power of two that brings
// column tiles x splits to MIN_BLOCKS (about half the SMs), at most
// MAX_SPLITS (the portable cluster size) and at most one split per
// MIN_TILES_PER_SPLIT tiles (one 128-deep slot). MIN_BLOCKS = 64 was chosen
// over 128, 256 and no split at all by timing those rules on the H100 at
// M = 4, 64 and 256: 64 was as fast or faster at each. The count depends on
// (NT, MAXB, bk, bn) alone, never on M: at vs = 0.6, wq and wo (MAXB = 6)
// split 2 ways, wk and wv 4, w_gate and w_up not at all, w_down 2.
constexpr int MAX_SPLITS = 8;
constexpr int MIN_TILES_PER_SPLIT = 2;
constexpr int MIN_BLOCKS = 64;

__host__ inline int split_count(int col_tiles, int k_tiles) {
  int s = 1;
  while (2 * s <= MAX_SPLITS && 2 * s * MIN_TILES_PER_SPLIT <= k_tiles &&
         s * col_tiles < MIN_BLOCKS)
    s *= 2;
  return s;
}

// Shared memory of one block covering RT row tiles: a ring of STAGES
// stages, each an x tile (64 RT rows x 64 k, bf16, 128-byte-swizzled rows)
// and a payload tile (64 k x 64 columns: int8 in dense 64-byte rows, bf16
// in 128-byte-swizzled rows); the park, where the other splits of the
// cluster leave their partial sums; the ring's "full" and "empty"
// mbarriers.
template <typename WT, int RT>
struct Layout {
  static constexpr int STAGES = RT == 4 ? 3 : 4;
  static constexpr int X_SLOT = RT * BM * KT * 2;
  static constexpr int W_ROW = BN * static_cast<int>(sizeof(WT));
  static constexpr int W_SLOT = KT * W_ROW;
  static constexpr int STAGE = X_SLOT + W_SLOT;
  static constexpr int PARK = STAGES * STAGE;
  static constexpr int BARS = PARK + RT * ACC * NTHREADS * 4;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;   // + alignment slack
  static_assert(STAGE % 1024 == 0, "swizzled tiles sit on 1024-byte boundaries");
  static_assert(SMEM <= 227 * 1024, "one block fits an SM");
};

// byte offset of 16-byte chunk `ch` of row `r` in a tile of 128-byte rows
// with the 128-byte swizzle (as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it)
__device__ __forceinline__ int sw128(int r, int ch) { return r * 128 + ((ch ^ (r & 7)) << 4); }

// The bf16 A fragments (four K steps) of a 64-deep bf16 payload tile:
// ldmatrix.trans of the 8 x 8 blocks (k, columns) gives each lane the
// mma A fragment of columns 16 warp .. + 15 in their natural order. The
// fragments pass through a byte permute that keeps them as they are: with
// ldmatrix writing wgmma's operand registers itself, ptxas serializes the
// products (C7513).
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4][4], const uint8_t* w_tile, int lane,
                                            int warp) {
  const int i = lane >> 3, r = lane & 7;  // matrix i: k + 8 (i / 2), columns + 8 (i % 2)
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t q[4];
    tc::ldmatrix_x4_trans(q, w_tile + sw128(16 * s + 8 * (i >> 1) + r, 2 * warp + (i & 1)));
#pragma unroll
    for (int e = 0; e < 4; ++e) a[s][e] = __byte_perm(q[e], q[(e + 1) & 3], 0x3210);
  }
}

template <typename WT>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* w_tile, int lane,
                                       int warp) {
  if constexpr (sizeof(WT) == 1)
    tc::load_a_s8<BN>(a, w_tile, lane, warp);
  else
    load_a_bf16(a, w_tile, lane, warp);
}

// A 16-byte piece at `src` of which the first `valid` bytes lie in the
// array (0..16), into shared memory `dst`: one cp.async when whole and
// `vec`, else element by element (ELEM bytes each) with zeros past `valid`.
template <int ELEM>
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src, int valid, bool vec) {
  if (valid >= 16 && vec) {
    tc::cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int b = 0; b < 16; b += ELEM) {
    if (b < valid) {
      if constexpr (ELEM == 2)
        *reinterpret_cast<uint16_t*>(dst + b) = *reinterpret_cast<const uint16_t*>(src + b);
      else
        dst[b] = src[b];
    } else {
      for (int z = 0; z < ELEM; ++z) dst[b + z] = 0;
    }
  }
}

// The producer warp's cp.async copy of one stage (one row tile), in the
// layouts TMA writes, zeros where TMA would fill them: the x tile (rows
// m0.., k kk.. of block kb) and the payload tile (slot b of N tile n, k
// kk.., columns c0..).
template <typename WT>
__device__ __forceinline__ void copy_stage(uint8_t* sx, const Args& a, int n, int b, int kb,
                                           int kk, int m0, int c0, int lane) {
  using L = Layout<WT, 1>;
  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int e = lane; e < BM * 8; e += 32) {
    const int r = e >> 3, ch = e & 7, m = m0 + r, k = kk + 8 * ch;
    const bool in = m < a.M && k < a.bk;   // bk % 8 == 0: a chunk is all in or all out
    copy16<2>(sx + sw128(r, ch),
              in ? x + (static_cast<size_t>(m) * a.K + static_cast<size_t>(kb) * a.bk + k) * 2
                 : x,
              in ? 16 : 0, x_vec);
  }
  constexpr int E = sizeof(WT), CHUNKS = L::W_ROW / 16;
  const uint8_t* w = static_cast<const uint8_t*>(a.w);
  const bool w_vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && (a.bn * E) % 16 == 0;
  uint8_t* sw = sx + L::X_SLOT;
  for (int e = lane; e < KT * CHUNKS; e += 32) {
    const int k = e / CHUNKS, ch = e % CHUNKS, c = c0 + ch * (16 / E);
    const int valid = (kk + k < a.bk && c < a.bn) ? min(16, (a.bn - c) * E) : 0;
    const size_t at = ((static_cast<size_t>(n) * a.MAXB + b) * a.bk + kk + k) * a.bn + c;
    copy16<E>(sw + (E == 1 ? k * L::W_ROW + 16 * ch : sw128(k, ch)), valid ? w + at * E : w,
              valid, w_vec);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One block: output columns c0.. of N tile n (64, wgmma M), rows m0.. (RT
// row tiles of 64, wgmma N each), K tiles of split `rank`.
template <typename WT, typename OT, bool TMA, int RT>
__global__ void __launch_bounds__(BLOCK)
gathered_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w, const Args a) {
  using L = Layout<WT, RT>;
  constexpr int STAGES = L::STAGES;
  constexpr bool S8 = sizeof(WT) == 1;
  static_assert(TMA || RT == 1, "the cp.async path copies one row tile per stage");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* park = reinterpret_cast<float*>(smem + L::PARK);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = (a.bn + BN - 1) / BN;
  const int n = blockIdx.x / chunks, c0 = (blockIdx.x - n * chunks) * BN;
  const int m0 = blockIdx.y * BM * RT;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int per_slot = (a.bk + KT - 1) / KT;
  const int k_tiles = a.MAXB * per_slot;
  const int kt0 = k_tiles * rank / splits;
  const int T = k_tiles * (rank + 1) / splits - kt0;   // this split's K tiles, >= 1
  const bool producer = warp == NTHREADS / 32;

  // acc[rt][4 q + 2 h + c]: A row 16 warp + lane / 4 + 8 h, x row 64 rt +
  // 8 q + 2 (lane % 4) + c. A row -> payload column: int8 16 warp + 2 (lane
  // / 4) + h (the permuted order of load_a_s8, a pair of neighbouring
  // columns), bf16 16 warp + lane / 4 + 8 h. The scales of the thread's two
  // columns (s0 at h = 0, s1 at h = 1) are read before the K loop, off the
  // store's path.
  const int col = c0 + 16 * warp + (S8 ? 2 * (lane >> 2) : lane >> 2);
  const int col1 = S8 ? col + 1 : col + 8;
  const size_t N = static_cast<size_t>(a.NT) * a.bn;
  OT* y = static_cast<OT*>(a.y) + static_cast<size_t>(n) * a.bn;

  // the producer warp reads the N tile's idx row 32 slots at a time (lane i
  // holds idx[n, base + i]); the first batch and the maps' prefetch overlap
  // the barriers' set-up
  const int32_t* idx_row = a.idx + static_cast<size_t>(n) * a.MAXB;
  int base = kt0 / per_slot, mine = 0;
  if (producer) {
    if (TMA && lane == 0) {
      tc::prefetch_tensor_map(&map_w);
      tc::prefetch_tensor_map(&map_x);
    }
    mine = base + lane < a.MAXB ? __ldg(idx_row + base + lane) : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tc::mbar_init(&full[s], TMA ? 1 : 32);   // cp.async: every producer lane arrives
      tc::mbar_init(&empty[s], 1);
    }
    tc::mbar_init_fence();
  }
  // every block of the cluster has started before any writes to its park
  // (the matching wait comes before the partials are sent)
  if (splits > 1) cluster_arrive_relaxed();
  __syncthreads();
  float s0 = 1.f, s1 = 1.f;
  if (a.scales && !producer) {
    const float* sc = a.scales + static_cast<size_t>(n) * a.bn;
    if (col < a.bn) s0 = __ldg(sc + col);
    if (col1 < a.bn) s1 = __ldg(sc + col1);
  }

  if (producer) {
    for (int j = 0; j < T; ++j) {
      const int t = kt0 + j, b = t / per_slot, kk = (t - b * per_slot) * KT;
      if (b - base >= 32) {
        base = b;
        mine = b + lane < a.MAXB ? __ldg(idx_row + b + lane) : 0;
      }
      const int kb = __shfl_sync(0xffffffffu, mine, b - base);
      const int slot = j % STAGES;
      uint8_t* sx = smem + slot * L::STAGE;
      if constexpr (TMA) {
        if (lane == 0) {
          // slot: its previous tile (j - STAGES) handed back
          if (j >= STAGES) tc::mbar_wait(&empty[slot], (j / STAGES - 1) & 1);
          tc::mbar_expect_tx(&full[slot], L::STAGE);
          tc::tma_load_4d(sx + L::X_SLOT, &map_w, c0, kk, b, n, &full[slot]);
          tc::tma_load_3d(sx, &map_x, kk, kb, m0, &full[slot]);
        }
        __syncwarp();
      } else {
        if (j >= STAGES) tc::mbar_wait(&empty[slot], (j / STAGES - 1) & 1);
        copy_stage<WT>(sx, a, n, b, kb, kk, m0, c0, lane);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        tc::fence_proxy_async();          // this lane's writes, visible to wgmma
        tc::mbar_arrive(&full[slot]);
      }
    }
  }

  float acc[RT][ACC];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[rt][i] = 0.f;

  if (!producer) {                        // the consumer warpgroup
    // Tile j's A fragments (one payload tile, widened once for all RT row
    // tiles) are loaded while the tensor cores still multiply tile j - 1;
    // prev: tile j - 1's fragments, read by the tensor cores until the wait,
    // so kept live (and out of a's registers) until then.
    auto step = [&](uint32_t(&ar)[4][4], uint32_t(&prev)[4][4], int j) {
      const uint8_t* sx = smem + (j % STAGES) * L::STAGE;
      tc::mbar_wait(&full[j % STAGES], (j / STAGES) & 1);   // tile j has landed
      load_a<WT>(ar, sx + L::X_SLOT, lane, warp);
      tc::wgmma_wait<0>();                // tile j - 1's products are done
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) tc::fence_regs(acc[rt]);
#pragma unroll
      for (int s = 0; s < 4; ++s) tc::fence_regs(prev[s]);
      // tile j - 1's stage is free: its x was read by those products, its
      // payload by every warp's load_a before they were issued
      if (j > 0 && tid == 0) tc::mbar_arrive(&empty[(j - 1) % STAGES]);
#pragma unroll
      for (int s = 0; s < 4; ++s) tc::fence_regs(ar[s]);
      tc::wgmma_fence();
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          tc::wgmma_bf16_n64_rs(acc[rt], ar[s],
                                tc::wgmma_desc_sw128(sx + rt * BM * 128 + 32 * s));
      tc::wgmma_commit();
    };
    uint32_t a0[4][4], a1[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) a1[s][i] = 0;
    for (int j = 0; j < T; j += 2) {
      step(a0, a1, j);
      if (j + 1 < T) step(a1, a0, j + 1);
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) tc::fence_regs(acc[rt]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      tc::fence_regs(a0[s]);
      tc::fence_regs(a1[s]);
    }
  }

  // p = 2 q + c: the x row of an output pair; v0 at h = 0, v1 at h = 1
  auto out = [&](int rt, int p, float v0, float v1) {
    const int m = m0 + BM * rt + 8 * (p >> 1) + 2 * (lane & 3) + (p & 1);
    if (m >= a.M) return;
    const size_t row = static_cast<size_t>(m) * N;
    if constexpr (S8) {                   // columns col, col + 1 (bn % 8 == 0: both or none)
      if (col < a.bn) tc::store2(y, row + col, true, true, v0 * s0, v1 * s1);
    } else {                              // columns col, col + 8
      if (col < a.bn) tc::store2(y, row + col, false, false, v0 * s0, 0.f);
      if (col + 8 < a.bn) tc::store2(y, row + col + 8, false, false, v1 * s1, 0.f);
    }
  };
  if (splits == 1) {
    if (!producer) {
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int p = 0; p < ACC / 2; ++p)
          out(rt, p, acc[rt][4 * (p >> 1) + (p & 1)], acc[rt][4 * (p >> 1) + (p & 1) + 2]);
    }
    return;
  }
  // Split K: rank q stores the outputs of float4 chunks [q per, (q + 1) per)
  // of each thread's 32 accumulators (chunk i: pairs p = 2 i and 2 i + 1, as
  // (p 2i h 0, p 2i+1 h 0, p 2i h 1, p 2i+1 h 1)). Every rank sends its
  // partials of those chunks straight into q's park (distributed shared
  // memory: park[rank][rt][chunk - q per][thread]); after the cluster's
  // barrier, q adds them in rank order 0, 1, ...
  const int per = ACC / 4 / splits;
  float4* park4 = reinterpret_cast<float4*>(park);
  cluster_wait();                         // every block of the cluster has started
  if (!producer) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
#pragma unroll
    for (int i = 0; i < ACC / 4; ++i) {
      const int q = i / per;
      float4* dst = cluster.map_shared_rank(park4, q) +
                    (rank * RT * per + i - q * per) * NTHREADS + tid;
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
        dst[rt * per * NTHREADS] =
            make_float4(acc[rt][4 * i], acc[rt][4 * i + 1], acc[rt][4 * i + 2], acc[rt][4 * i + 3]);
    }
  }
  tc::cluster_sync();                     // every partial has arrived
  if (!producer) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
      for (int v = 0; v < per; ++v) {
        const float4* src = park4 + (rt * per + v) * NTHREADS + tid;
        float4 t = src[0];
#pragma unroll
        for (int r = 1; r < MAX_SPLITS; ++r)
          if (r < splits) {
            const float4 u = src[r * RT * per * NTHREADS];
            t.x += u.x;
            t.y += u.y;
            t.z += u.z;
            t.w += u.w;
          }
        const int i = rank * per + v;
        out(rt, 2 * i, t.x, t.z);
        out(rt, 2 * i + 1, t.y, t.w);
      }
  }
}

// A direct-mapped cache of tensor maps. The serving path calls each packed
// table again and again (154 tables per decode call), and its activations
// come back to the same addresses call after call. A map depends on its key
// (address and shape) and on the call site that encodes it alone, so a hit
// is the map the key encodes; each call site (each Encode type) has a cache
// of its own.
struct MapKey {
  const void* base;
  int dims[4];
};

template <typename Encode>
__host__ bool cached_map(CUtensorMap* map, const MapKey& key, Encode encode) {
  struct Entry {
    CUtensorMap map;
    MapKey key;
    bool used, ok;
  };
  constexpr int SLOTS = 1024;
  static Entry cache[SLOTS];
  static std::mutex lock;
  uint64_t h = static_cast<uint64_t>(reinterpret_cast<uintptr_t>(key.base) >> 4);
  for (int d : key.dims) h = h * 0x9E3779B97F4A7C15ull + static_cast<uint32_t>(d);
  Entry& e = cache[(h * 0x9E3779B97F4A7C15ull) >> 54];
  std::lock_guard<std::mutex> guard(lock);
  if (!e.used || e.key.base != key.base || memcmp(e.key.dims, key.dims, sizeof key.dims)) {
    e.ok = encode(&e.map);
    e.key = key;
    e.used = true;
  }
  if (e.ok) *map = e.map;
  return e.ok;
}

// The map of x (bf16) as a 3-D array (M, K / bk, bk), boxes of (64 RT
// rows, one block, 64 k) in the 128-byte swizzle.
__host__ inline bool x_map(CUtensorMap* map, const Args& a, int rt) {
  return cached_map(map, MapKey{a.x, {a.M, a.K, a.bk, rt}}, [&](CUtensorMap* m) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.bk),
                                static_cast<cuuint64_t>(a.K / a.bk),
                                static_cast<cuuint64_t>(a.M)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(a.bk) * 2,
                                   static_cast<cuuint64_t>(a.K) * 2};
    const cuuint32_t box[3] = {KT, 1, static_cast<cuuint32_t>(BM * rt)};
    return tc::tensor_map_nd(m, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  });
}

// The map of the payload as a 4-D array (NT, MAXB, bk, bn), boxes of (one
// tile, one slot, 64 k, 64 columns): int8 in dense rows, bf16 in the
// 128-byte swizzle.
template <typename WT>
__host__ bool w_map(CUtensorMap* map, const Args& a) {
  return cached_map(map, MapKey{a.w, {a.NT, a.MAXB, a.bk, a.bn}}, [&](CUtensorMap* m) {
    constexpr int E = sizeof(WT);
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.bn), static_cast<cuuint64_t>(a.bk),
                                static_cast<cuuint64_t>(a.MAXB),
                                static_cast<cuuint64_t>(a.NT)};
    const cuuint64_t row = static_cast<cuuint64_t>(a.bn) * E;
    const cuuint64_t strides[3] = {row, row * a.bk, row * a.bk * a.MAXB};
    const cuuint32_t box[4] = {BN, KT, 1, 1};
    return tc::tensor_map_nd(
        m, a.w, E == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
        dims, strides, box, E == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  });
}

template <typename WT, typename OT, bool TMA, int RT>
cudaError_t launch_tc_with(const CUtensorMap& mx, const CUtensorMap& mw, const Args& a,
                           int col_tiles, int splits, cudaStream_t stream) {
  constexpr int bytes = Layout<WT, RT>::SMEM;
  const cudaError_t e = tc::allow_smem<gathered_tc_kernel<WT, OT, TMA, RT>>(bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(col_tiles, (a.M + BM * RT - 1) / (BM * RT));
  return tc::launch_split(gathered_tc_kernel<WT, OT, TMA, RT>, grid, splits, BLOCK, bytes,
                          stream, mx, mw, a);
}

// the current device's SM count, read once per device
__host__ inline int sm_count() {
  constexpr int MAX_DEVICES = 64;
  static int count[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < MAX_DEVICES && count[dev]) return count[dev];
  int n = 1;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < MAX_DEVICES) count[dev] = n;
  return n;
}

// bf16 x: TMA when both arrays can be mapped, the producer's cp.async
// otherwise (one row tile a block). RT, the row tiles of one block, is the
// fewest (the most blocks) whose grid still fits one wave of the SMs, and
// no more than M fills: at decode and for narrow projections 1; at 256 rows
// 2 for wq, wo and w_down and 4 for w_gate and w_up, whose 88 column tiles
// at RT = 2 would take a second wave. Every output's sum is the same
// whatever RT.
template <typename WT, typename OT>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  const int col_tiles = a.NT * ((a.bn + BN - 1) / BN);
  const int splits = split_count(col_tiles, a.MAXB * ((a.bk + KT - 1) / KT));
  int rt = 1;
  while (rt < 4 && BM * rt < a.M &&
         col_tiles * splits * ((a.M + BM * rt - 1) / (BM * rt)) > sm_count())
    rt *= 2;
  CUtensorMap mx, mw;
  if (w_map<WT>(&mw, a) && x_map(&mx, a, rt)) {
    if (rt == 1) return launch_tc_with<WT, OT, true, 1>(mx, mw, a, col_tiles, splits, stream);
    if (rt == 2) return launch_tc_with<WT, OT, true, 2>(mx, mw, a, col_tiles, splits, stream);
    return launch_tc_with<WT, OT, true, 4>(mx, mw, a, col_tiles, splits, stream);
  }
  return launch_tc_with<WT, OT, false, 1>(mx, mw, a, col_tiles, splits, stream);
}

// ---- f32 x: fp32 FMAs on the CUDA cores -----------------------------------
//
// One thread block per (row tile of FM rows, N tile, column chunk of CW
// columns); the slots run as a loop inside the block, which reads its own
// idx[n, b], stages the gathered x rows and the (bk, CW) payload slice in
// shared memory as f32 and keeps one f32 accumulator per output in
// registers. Every output sums b = 0..MAXB-1, then k = 0..bk-1, in that
// order, whatever M and whichever row tile holds the row.

constexpr int FM = 16;                    // rows per block
constexpr int CW = 32;                    // output columns per block (= lanes)
constexpr int WARPS = 4;                  // block = (CW, WARPS) threads
constexpr int ROWS_PER_THREAD = FM / WARPS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename WT, typename OT>
__global__ void __launch_bounds__(CW * WARPS) gathered_fp32_kernel(const Args a) {
  __shared__ float xs[FM][MAX_BK];        // gathered activation rows, 8 KB
  __shared__ float ws[MAX_BK][CW];        // payload slice as f32, 16 KB
  const float* x = static_cast<const float*>(a.x);
  const WT* w_blocks = static_cast<const WT*>(a.w);
  const int bk = a.bk, bn = a.bn;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * CW + lane;
  const int nthreads = CW * WARPS;
  const int m0 = blockIdx.x * FM;
  const int n = blockIdx.y;
  const int c0 = blockIdx.z * CW;
  const int col = c0 + lane;              // column inside the N tile
  const int N = a.NT * bn;

  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.f;

  for (int b = 0; b < a.MAXB; ++b) {
    const int kb = a.idx[n * a.MAXB + b];
    const float* xsrc = x + static_cast<size_t>(kb) * bk;
    for (int e = tid; e < FM * bk; e += nthreads) {
      const int r = e / bk, k = e - r * bk;
      const int m = m0 + r;
      xs[r][k] = (m < a.M) ? xsrc[static_cast<size_t>(m) * a.K + k] : 0.f;
    }
    const WT* wsrc = w_blocks + static_cast<size_t>(n * a.MAXB + b) * bk * bn;
    for (int e = tid; e < bk * CW; e += nthreads) {
      const int k = e / CW, c = e - k * CW;
      ws[k][c] = (c0 + c < bn) ? to_f32(wsrc[static_cast<size_t>(k) * bn + c0 + c]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < bk; ++k) {
      const float wv = ws[k][lane];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        acc[i] = fmaf(xs[warp + i * WARPS][k], wv, acc[i]);
    }
    __syncthreads();
  }

  if (col >= bn) return;
  const int out_col = n * bn + col;
  const float s = a.scales ? a.scales[out_col] : 1.f;
  OT* y = static_cast<OT*>(a.y);
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + warp + i * WARPS;
    if (m < a.M) store(&y[static_cast<size_t>(m) * N + out_col], acc[i] * s);
  }
}

template <typename WT, typename OT>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.M + FM - 1) / FM, a.NT, (a.bn + CW - 1) / CW);
  gathered_fp32_kernel<WT, OT><<<grid, dim3(CW, WARPS), 0, stream>>>(a);
  return cudaSuccess;
}

}  // namespace
}  // namespace gather
