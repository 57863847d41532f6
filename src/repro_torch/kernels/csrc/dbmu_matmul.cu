// Bit-true DBMU + CSD adder tree evaluation for Hopper (sm_90a), on the
// int8 tensor cores.
//
// Replaces the Pallas TPU kernel `dbmu_matmul` (src/repro/kernels/dbmu_sim.py,
// `_kernel` and its `pl.pallas_call`). Same function, the DB-PIM macro's
// datapath: inputs stream in bit-serially as sign-magnitude planes; each
// stored Comp pattern (one 6T cell: sign s, position p = 2 * blk + hi) ANDs
// the input bit, and the CSD adder tree recombines the partials as
//
//   y[m, n] = sum_k sum_{bit < 8} sum_{t < 2}
//               sign(x[m, k]) * bit_b(|x[m, k]|) * valid_t * s_t * 2^(p_t) << bit
//
// x (M, K) int32; the datapath reads 8 magnitude planes, so x enters as
// x' = sign(x) * (|x| mod 256), and x' = x for every |x| <= 255; packed
// (K, N, 2) uint8 term bytes (bit0 sign, bit1 hi/lo, bits 2-3 block, bit4
// valid; bits 5-7 unused; repro_torch.core.dyadic.pack_terms); y (M, N)
// int32, equal to the integer matmul x' @ unpack_terms(packed) exactly.
//
// Exact evaluation. The input planes fold: sum_bit 2^bit * sign(x) *
// bit_b(|x|) = x, so x enters as one int8 operand. The weight keeps the
// macro's position structure: for each block b in {0..3}
//
//   S_b[k, n] = sum_t valid_t * s_t * 2^(hi_t) * [blk_t == b]   in [-4, 4]
//
// (in [-2, 2] for pack_terms' packs, whose two CSD digits sit in different
// blocks), and 2^(p_t) = 2^(hi_t) * 4^(blk_t), so
//
//   y = sum_b (x @ S_b) << 2b,
//
// four int8 products per K step, recombined by the adder tree's shifts.
// x' is one int8 operand when it lies in [-128, 127]. A K tile of a block
// with any x outside that range splits it instead, x' = 4 h + l with
// h = sign * (|x'| >> 2) in [-63, 63] and l = sign * (|x'| & 3): the adder
// tree's shift by 4 between neighbouring blocks takes the factor 4, so
//
//   y = sum_b 4^b (l @ S_b) + sum_{b < 3} 4^(b+1) (h @ S_b) + 4^3 (h @ 4 S_3),
//
// eight products into the same four accumulators (4 S_3 in [-16, 16]).
// Each accumulator is an int32 tensor-core sum of terms of at most
// 4 * 3 + 4 * 63 + 16 * 63 = 1272 per K, so it stays below 2^31 for every
// K the entry point takes (MAX_K = 87,000; 128 * 192 * K bounds y for
// pack_terms' packs). The shift-add runs in uint32, i.e. modulo 2^32, so y
// is the exact integer result modulo 2^32: bit for bit what the plain
// version's int64 sum cast to int32 gives, wrap-around included.
//
// Design. One block of two warpgroups per 128 x 64 output tile, `wgmma`
// m64n64k32 s8 * s8 -> s32, one int32 accumulator set per block position b
// in registers.
//   * Thread 0 keeps a 3-stage ring of 64-deep K tiles in flight with TMA:
//     x as int32 rows and the term bytes, each stage completing on an
//     mbarrier (arrays whose rows TMA cannot take arrive by cp.async).
//   * Each K tile is decoded once per block while the tensor cores still
//     multiply the previous one: x narrowed to int8 in registers, as
//     wgmma's register operand A; each weight's four S_b into a shared-
//     memory operand B (two buffers). The four S_b of a weight are the sum
//     of two 32-entry table words, one per term byte (any bytes at all),
//     with a bias that keeps the bytewise sum free of carries.
//   * The two warpgroups share one decode of the weight tile; the epilogue
//     is the adder tree: the four products shifted and added.
//   * Whether a K tile splits x is one block-wide vote per tile
//     (__syncthreads_or), so x in the int8 range costs one compare per
//     value; a split tile reads h and l from the staged int32 rows before
//     the slot refills and waits for its own products.
//   * Few output tiles (narrow N) split K over a cluster of up to 4 blocks,
//     a split count fixed by K and N, the int32 partials added through
//     distributed shared memory (integer sums: any order, the same bits).
//   Ragged M, K and N are masked (tc_tile.cuh).
//
// Bound. The function is one int8 matmul: at M = 256 the four tinyllama
// projection shapes move about 78 MB as the times phase counts them (x as
// int32, the term bytes, y as int32) and do 7 G multiply-adds, so the
// card's bound is its memory rate. The exact evaluation of the datapath
// costs four tensor-core products per multiply-add (one per block
// position), a decode of 64 x 64 weights per block and K tile, and x read
// as int32, 4 bytes per value, once per 64 output columns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int BM = 128;                   // output rows per block: two warpgroups of 64
constexpr int BN = 64;                    // output columns per block: wgmma N
constexpr int BK = 64;                    // K tile: two wgmma K steps
constexpr int STAGES = 3;                 // ring depth
constexpr int NTHREADS = 256;             // two warpgroups
constexpr int NBLK = 4;                   // DB block positions
constexpr int ACC = BM * BN / NTHREADS;   // int32 accumulators per thread and block b
constexpr int MAX_K = 87000;

constexpr int X_LD = BK * 4;              // int32 x tile row, bytes
constexpr int X_SLOT = BM * X_LD;
constexpr int T_LD = BN * 2;              // term-byte tile row, bytes
constexpr int T_SLOT = BK * T_LD;
constexpr int SS_BYTES = BN * BK;         // one S_b operand (B^T), core-matrix layout
constexpr int TERM_WORDS = 32;
// shared memory: the ring (x, terms), two sets of four S_b, the term table,
// the ring's mbarriers
constexpr int T_RING = STAGES * X_SLOT;
constexpr int SS_OFF = T_RING + STAGES * T_SLOT;
constexpr int S4_OFF = SS_OFF + 2 * NBLK * SS_BYTES;   // 4 S_3 of a split tile
constexpr int TW_OFF = S4_OFF + SS_BYTES;
constexpr int BAR_OFF = TW_OFF + TERM_WORDS * 4;
constexpr int SMEM_BYTES = BAR_OFF + STAGES * 8 + 1024;   // + alignment slack
constexpr int TX_BYTES = X_SLOT + T_SLOT;
static_assert(ACC * NTHREADS * 4 <= T_RING, "the split partials fit the ring");

// One term byte's contribution to the four S_b of its weight, one byte per
// block position b, biased by 4: (blk == b ? valid * sign * 2^hi : 0) + 4.
// Two such words add without carries (each byte lands in [4, 12]), and
// (sum + 0x78787878) ^ 0x80808080 takes 8 off every byte as an int8: the
// four S_b of the pair, for any two term bytes.
__device__ __forceinline__ uint32_t term_word(int t) {
  const int v = ((t >> 4) & 1) * (1 - 2 * (t & 1)) * (1 << ((t >> 1) & 1));
  const int blk = (t >> 2) & 3;
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < NBLK; ++b) w |= static_cast<uint32_t>((b == blk ? v : 0) + 4) << (8 * b);
  return w;
}

__device__ __forceinline__ uint32_t pair_word(const uint32_t* tw, uint32_t p) {
  return ((tw[p & 31] + tw[(p >> 8) & 31]) + 0x78787878u) ^ 0x80808080u;
}

// The A fragments of one K tile from its int32 rows: fragment register
// (row r, k 4 t .. 4 t + 3) is the low bytes of one 16-byte chunk of x.
// Returns whether any of the thread's x lies outside [-128, 127].
__device__ __forceinline__ bool load_a(uint32_t (&a)[BK / 32][4], const uint8_t* x_tile,
                                       int lane, int warp) {
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t out = 0;
#pragma unroll
  for (int s = 0; s < BK / 32; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // rows g, g + 8; k 4 t4, 16 + 4 t4
      const int r = 16 * warp + g + 8 * (i & 1), k = 32 * s + 16 * (i >> 1) + 4 * t4;
      const uint4 v = *reinterpret_cast<const uint4*>(x_tile + r * X_LD + k * 4);
      a[s][i] =
          __byte_perm(__byte_perm(v.x, v.y, 0x0040), __byte_perm(v.z, v.w, 0x0040), 0x5410);
      out |= static_cast<uint32_t>((v.x + 128u) > 255u) | static_cast<uint32_t>((v.y + 128u) > 255u) |
             static_cast<uint32_t>((v.z + 128u) > 255u) | static_cast<uint32_t>((v.w + 128u) > 255u);
    }
  return out != 0;
}

// The split of one x value: x' = sign * (|x| & 255) = 4 h + l; the bytes of
// h and l put at byte q of hi and lo.
__device__ __forceinline__ void split_value(uint32_t x, int q, uint32_t& lo, uint32_t& hi) {
  const int v = static_cast<int>(x);
  const int m = (v < 0 ? -v : v) & 255;   // |INT_MIN| wraps to itself: m = 0, as in the planes
  const int h = v < 0 ? -(m >> 2) : m >> 2, l = v < 0 ? -(m & 3) : m & 3;
  lo |= static_cast<uint32_t>(l & 0xFF) << (8 * q);
  hi |= static_cast<uint32_t>(h & 0xFF) << (8 * q);
}

// The A fragments of x' = 4 h + l (load_a's layout): l into lo, h into hi.
__device__ __forceinline__ void load_split(uint32_t (&lo)[BK / 32][4], uint32_t (&hi)[BK / 32][4],
                                           const uint8_t* x_tile, int lane, int warp) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int s = 0; s < BK / 32; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + g + 8 * (i & 1), k = 32 * s + 16 * (i >> 1) + 4 * t4;
      const uint4 v = *reinterpret_cast<const uint4*>(x_tile + r * X_LD + k * 4);
      uint32_t l = 0, h = 0;
      split_value(v.x, 0, l, h);
      split_value(v.y, 1, l, h);
      split_value(v.z, 2, l, h);
      split_value(v.w, 3, l, h);
      lo[s][i] = l;
      hi[s][i] = h;
    }
}

// Term bytes of one K tile -> the four S_b operands (B^T: BN rows of K).
// A thread takes one column n and 16 k (one core-matrix row of each S_b):
// neighbouring threads read neighbouring term pairs and write neighbouring
// 16-byte rows, and the 32-word table has a bank per word, so no access
// conflicts.
__device__ __forceinline__ void decode_terms(const uint8_t* rt, const uint32_t* tw, uint8_t* sS,
                                             int tid) {
  constexpr int UNITS = BN * (BK / 16);
  static_assert(UNITS % NTHREADS == 0, "whole units per thread");
#pragma unroll
  for (int u = tid; u < UNITS; u += NTHREADS) {
    const int n = u % BN, kg = u / BN;
    uint32_t o[NBLK][4];                  // o[b][q]: S_b at k = 16 kg + 4 q .. + 3
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t w[4];                      // w[j]: the four S_b at k = 16 kg + 4 q + j
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = pair_word(
            tw, *reinterpret_cast<const uint16_t*>(rt + (16 * kg + 4 * q + j) * T_LD + 2 * n));
      const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
      o[0][q] = __byte_perm(lo01, lo23, 0x5410);
      o[1][q] = __byte_perm(lo01, lo23, 0x7632);
      o[2][q] = __byte_perm(hi01, hi23, 0x5410);
      o[3][q] = __byte_perm(hi01, hi23, 0x7632);
    }
#pragma unroll
    for (int b = 0; b < NBLK; ++b)
      *reinterpret_cast<uint4*>(sS + b * SS_BYTES + tc::core_offset(BN, n, 16 * kg)) =
          make_uint4(o[b][0], o[b][1], o[b][2], o[b][3]);
  }
}

template <bool TMA>
__global__ void __launch_bounds__(NTHREADS)
dbmu_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_t, tc::GTile gx, tc::GTile gt,
                   int32_t* __restrict__ y, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* raw_x = smem;                          // the ring: int32 x tiles
  uint8_t* raw_t = smem + T_RING;                 //           term-byte tiles
  uint8_t* sS = smem + SS_OFF;                    // two sets of four S_b operands
  uint8_t* s4 = smem + S4_OFF;                    // 4 S_3 of a split tile
  uint32_t* tw = reinterpret_cast<uint32_t*>(smem + TW_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = k_tiles * rank / splits;
  const int T = k_tiles * (rank + 1) / splits - kt0;   // this split's K tiles, >= 1

  // local tile j (global K tile kt0 + j) -> ring slot j % STAGES
  auto tma_stage = [&](int j) {           // thread 0
    const int slot = j % STAGES, kt = kt0 + j;
    tc::mbar_expect_tx(&full[slot], TX_BYTES);
    tc::tma_load(raw_x + slot * X_SLOT, &map_x, m0, kt * BK, &full[slot]);
    tc::tma_load(raw_t + slot * T_SLOT, &map_t, kt * BK, 2 * n0, &full[slot]);
  };
  auto copy_stage = [&](int j) {          // every thread, cp.async
    const int kt = kt0 + j, slot = j % STAGES;
    tc::load_tile<BM, X_LD, X_LD, 4, NTHREADS>(raw_x + slot * X_SLOT, gx, m0,
                                               static_cast<size_t>(kt) * X_LD, tid);
    tc::load_tile<BK, T_LD, T_LD, 2, NTHREADS>(raw_t + slot * T_SLOT, gt, kt * BK,
                                               static_cast<size_t>(n0) * 2, tid);
    tc::cp_async_commit();
  };

  if (tid < TERM_WORDS) tw[tid] = term_word(tid);
  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) tc::mbar_init(&full[s], 1);
      tc::mbar_init_fence();
      tc::prefetch_tensor_map(&map_x);
      tc::prefetch_tensor_map(&map_t);
      for (int s = 0; s < STAGES && s < T; ++s) tma_stage(s);
    }
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < T) {
        copy_stage(s);
      } else {
        tc::cp_async_commit();
      }
    }
  }
  __syncthreads();

  int32_t acc[NBLK][ACC];
#pragma unroll
  for (int b = 0; b < NBLK; ++b)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[b][i] = 0;

  // Tile j is decoded (its S_b into buffer j & 1, its x into registers)
  // while the tensor cores still multiply tile j - 1; warpgroup wg
  // multiplies rows 64 wg .. 64 wg + 63. a: tile j's x fragments; prev:
  // tile j - 1's, read by the tensor cores until the wait, so kept live
  // (and out of a's registers) until then.
  auto step = [&](uint32_t(&a)[BK / 32][4], uint32_t(&prev)[BK / 32][4], int j) {
    const int slot = j % STAGES;
    if constexpr (TMA) {
      tc::mbar_wait(&full[slot], (j / STAGES) & 1);     // tile j has landed
    } else {
      tc::cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (j + STAGES - 1 < T) {
        copy_stage(j + STAGES - 1);       // slot of tile j - 1, read at step j - 1
      } else {
        tc::cp_async_commit();
      }
    }
    uint8_t* s_tiles = sS + (j & 1) * NBLK * SS_BYTES;   // read by tile j - 2's products
    decode_terms(raw_t + slot * T_SLOT, tw, s_tiles, tid);
    const bool wide = load_a(a, raw_x + slot * X_SLOT, lane, warp);
    tc::fence_proxy_async();
    // every S_b written, the slot read; does any x of the tile need a split?
    const bool split = __syncthreads_or(wide);
    uint32_t ah[BK / 32][4];
    if (split) {                          // the whole block: l into a, h into ah, 4 S_3
      load_split(a, ah, raw_x + slot * X_SLOT, lane, warp);
      static_assert(SS_BYTES == 16 * NTHREADS, "one 16-byte chunk of 4 S_3 per thread");
      const uint4 w = reinterpret_cast<const uint4*>(s_tiles + 3 * SS_BYTES)[tid];
      reinterpret_cast<uint4*>(s4)[tid] = make_uint4((w.x << 2) & 0xFCFCFCFCu, (w.y << 2) & 0xFCFCFCFCu,
                                                     (w.z << 2) & 0xFCFCFCFCu, (w.w << 2) & 0xFCFCFCFCu);
      tc::fence_proxy_async();
      __syncthreads();                    // 4 S_3 written, the slot read
    }
    if constexpr (TMA) {
      if (tid == 0 && j + STAGES < T) tma_stage(j + STAGES);
    }
    tc::wgmma_wait<0>();                  // tile j - 1's products are done
#pragma unroll
    for (int b = 0; b < NBLK; ++b) tc::fence_regs(acc[b]);
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      tc::fence_regs(prev[s]);
      tc::fence_regs(a[s]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 32; ++s)     // 32 K values = two 16-byte chunks of S_b
#pragma unroll
      for (int b = 0; b < NBLK; ++b)
        tc::wgmma_s8_n64_rs(
            acc[b], a[s], tc::wgmma_desc(s_tiles + b * SS_BYTES + 2 * s * BN * 16, BN * 16, 128));
    if (split) {                          // 4^(b+1) h @ S_b, and 4^3 h @ 4 S_3
#pragma unroll
      for (int s = 0; s < BK / 32; ++s) {
#pragma unroll
        for (int b = 0; b + 1 < NBLK; ++b)
          tc::wgmma_s8_n64_rs(acc[b + 1], ah[s],
                              tc::wgmma_desc(s_tiles + b * SS_BYTES + 2 * s * BN * 16, BN * 16,
                                             128));
        tc::wgmma_s8_n64_rs(acc[NBLK - 1], ah[s],
                            tc::wgmma_desc(s4 + 2 * s * BN * 16, BN * 16, 128));
      }
    }
    tc::wgmma_commit();
    if (split) {                          // ah and 4 S_3 are free once the products are done
      tc::wgmma_wait<0>();
#pragma unroll
      for (int b = 0; b < NBLK; ++b) tc::fence_regs(acc[b]);
#pragma unroll
      for (int s = 0; s < BK / 32; ++s) {
        tc::fence_regs(a[s]);
        tc::fence_regs(ah[s]);
      }
    }
  };
  uint32_t a0[BK / 32][4], a1[BK / 32][4];
#pragma unroll
  for (int s = 0; s < BK / 32; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) a1[s][i] = 0;
  for (int j = 0; j < T; j += 2) {
    step(a0, a1, j);
    if (j + 1 < T) step(a1, a0, j + 1);
  }
  tc::wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NBLK; ++b) tc::fence_regs(acc[b]);
#pragma unroll
  for (int s = 0; s < BK / 32; ++s) {
    tc::fence_regs(a0[s]);
    tc::fence_regs(a1[s]);
  }
  if constexpr (!TMA) tc::cp_async_wait<0>();

  // the CSD adder tree: y = P0 + P1 << 2 + P2 << 4 + P3 << 6, modulo 2^32
  uint32_t v[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    v[i] = 0;
#pragma unroll
    for (int b = 0; b < NBLK; ++b) v[i] += static_cast<uint32_t>(acc[b][i]) << (2 * b);
  }
  // v[4 q + 2 h + c]: row 16 warp + lane / 4 + 8 h, column 8 q + 2 (lane %
  // 4) + c
  const int row0 = m0 + 16 * warp + (lane >> 2), col0 = n0 + 2 * (lane & 3);
  auto out = [&](int p, uint32_t v0, uint32_t v1) {   // p = 2 q + h: columns n, n + 1
    const int m = row0 + 8 * (p & 1), n = col0 + 8 * (p >> 1);
    if (m >= M || n >= N) return;
    int32_t* at = y + static_cast<size_t>(m) * N + n;
    if (n + 1 < N && N % 2 == 0) {
      *reinterpret_cast<int2*>(at) = make_int2(static_cast<int32_t>(v0), static_cast<int32_t>(v1));
    } else {
      at[0] = static_cast<int32_t>(v0);
      if (n + 1 < N) at[1] = static_cast<int32_t>(v1);
    }
  };
  if (splits == 1) {
#pragma unroll
    for (int p = 0; p < ACC / 2; ++p) out(p, v[2 * p], v[2 * p + 1]);
    return;
  }
  // split K: park the partials (over the ring, all of it consumed), then
  // rank r sums pairs p % splits == r (integer sums modulo 2^32: any order
  // gives the same bits)
  __syncthreads();
  uint32_t* park = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
  for (int i = 0; i < ACC; ++i) park[i * NTHREADS + tid] = v[i];
  tc::cluster_sync();
#pragma unroll
  for (int p = 0; p < ACC / 2; ++p)
    if (p % splits == rank)
      out(p, tc::split_sum<uint32_t, NTHREADS>(park, 2 * p, tid, splits),
          tc::split_sum<uint32_t, NTHREADS>(park, 2 * p + 1, tid, splits));
  tc::cluster_sync();                     // the other blocks' reads of this park are done
}

template <bool TMA>
cudaError_t launch_with(const CUtensorMap& mx, const CUtensorMap& mt, const void* x,
                        const void* packed, void* y, int M, int K, int N, cudaStream_t stream) {
  const cudaError_t e = tc::allow_smem<dbmu_matmul_kernel<TMA>>(SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const tc::GTile gx = tc::make_gtile(x, M, static_cast<size_t>(K) * 4);
  const tc::GTile gt = tc::make_gtile(packed, K, static_cast<size_t>(N) * 2);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  return tc::launch_split(dbmu_matmul_kernel<TMA>, grid,
                          tc::k_splits((K + BK - 1) / BK, grid.x, 2 * tc::MIN_BLOCKS), NTHREADS,
                          SMEM_BYTES, stream, mx, mt, gx, gt, static_cast<int32_t*>(y), M, K, N);
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes the kernel does not
// take).
extern "C" int dbmu_matmul_launch(const void* x, const void* packed, void* y, int M, int K,
                                  int N, void* stream) {
  if (M <= 0 || K <= 0 || K > MAX_K || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // TMA when both arrays' rows are 16-byte aligned, cp.async otherwise
  CUtensorMap mx, mt;
  const bool tma = tc::tensor_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, M, K, BM, BK,
                                  CU_TENSOR_MAP_SWIZZLE_NONE) &&
                   tc::tensor_map(&mt, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, 2 * N, BK,
                                  2 * BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t l = tma ? launch_with<true>(mx, mt, x, packed, y, M, K, N, s)
                            : launch_with<false>(mx, mt, x, packed, y, M, K, N, s);
  return static_cast<int>(l == cudaSuccess ? cudaGetLastError() : l);
}
