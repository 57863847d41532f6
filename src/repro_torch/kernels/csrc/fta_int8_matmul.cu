// FTA/INT8 weight matmul for Hopper (sm_90a) on the bf16 tensor cores: the
// bit-level sparsity path.
//
// Replaces the Pallas TPU kernel `fta_int8_matmul`
// (src/repro/kernels/fta_int8_matmul.py, `_kernel` and its
// `pl.pallas_call`). Same function:
//
//   y[m, n] = cast_out( scales[n] * sum_{k < K} bf16(x[m, k]) * float(w_q[k, n]) )
//
// x (M, K) f32 or bf16, row-major, rounded to bf16 first (round to nearest
// even) exactly as the TPU kernel's `x.astype(bf16)` does, even when x is
// f32; w_q (K, N) int8, row-major (FTA weights are exact on the INT8 grid);
// scales (N,) f32, applied once per output at the store (scales commute
// with the K sum); y (M, N) f32 or bf16. Any M, K and N.
//
// Exactness. An int8 value is exact in bf16 (8 significant bits), and the
// product of two bf16 values (8 + 8 significant bits) is exact in fp32, so
// the bf16 tensor cores with fp32 accumulators form the same products as
// the fp32 reference; only the order of the fp32 sums differs, within the
// 1e-5 * max|ref| (f32 out) and one-bf16-ulp (bf16 out) tolerances.
//
// Bound. At the per-layer path's 256 rows the work is 2 * M * K * N flops
// on 1 byte of weight each: on the card's peaks it is bound by operations
// (989 TFLOP/s bf16) for the 2048-wide projections and by bytes for the
// narrow ones. At M = 256 a 64 x 64 tiling leaves about one block per SM,
// so each block's own latency sets the time: a warpgroup that issues its
// own cp.async copies stalls on the issue, and one that widens the weight
// into shared memory waits on a barrier before every product. The design
// below issues whole tiles by TMA from a warp of their own and widens the
// weight in registers.
//
// Design. The product runs transposed, y^T = w^T x^T, on `wgmma`
// m64n64k16: one block per 64 x 64 output tile, one consumer warpgroup and
// one producer warp.
//   * The producer warp's lane 0 keeps a 4-stage ring of K tiles (64 deep)
//     in flight with TMA: x (bf16) as one box in the 128-byte-swizzled
//     layout wgmma reads, the int8 weight as one box of dense 64-byte rows
//     (1 byte per value in memory and in shared memory), each stage
//     completing on a "full" mbarrier and handed back on an "empty" one.
//   * The consumers read the weight tile with ldmatrix.trans and widen it
//     to bf16 in registers with integer and fp32 adds only (no conversion
//     instructions), as wgmma's register operand A; x is operand B, read by
//     the tensor cores straight from the ring. Tile k + 1 is widened while
//     the tensor cores still multiply tile k.
//   * Few output tiles (narrow N) split K over a cluster of up to 4 blocks,
//     a split count fixed by K and N (tc_tile.cuh), the partial sums added
//     in rank order through distributed shared memory.
//   * f32 x lands row-major and is rounded into a bf16 operand buffer; rows
//     that TMA cannot take (not 16-byte aligned) arrive by cp.async instead.
//
// Row stability: every output sums its K tiles in order, each 16-deep step
// in the tensor core's fixed order, and the splits in rank order; nothing
// depends on M, so a row comes out bitwise the same whatever M is.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

// y^T = w^T x^T on wgmma m64n64k16: A (64 weight columns n x 16 k) in
// registers, B (16 k x 64 rows m of x) in shared memory.
constexpr int BN = 64;                    // output columns per block: wgmma M
constexpr int BM = 64;                    // output rows per block: wgmma N
constexpr int BK = 64;                    // K tile: four wgmma K steps
constexpr int NTHREADS = 128;             // one consumer warpgroup
constexpr int BLOCK = NTHREADS + 32;      // + one producer warp (TMA path)
constexpr int ACC = BN * BM / NTHREADS;   // fp32 accumulators per thread
constexpr int X_BYTES = BM * BK * 2;      // bf16 x operand, core-matrix layout
constexpr int X_LBO = BM * 16, SBO = 128;

enum DType { F32 = 0, BF16 = 1 };

// Shared memory of one block. The ring holds STAGES K tiles of x and of
// the int8 weight. With TMA (the main path) a producer warp has them copied
// whole, x (bf16) in the operand's 128-byte-swizzled layout and the weight
// in dense 64-byte rows, each stage completing on its "full" mbarrier and
// handed back on its "empty" one; without TMA (rows not 16-byte aligned)
// the consumers copy them by cp.async, x in the core-matrix layout and the
// weight in padded rows. An f32 x tile lands row-major and is rounded into
// one of two operand buffers (core-matrix layout).
template <typename XT, bool TMA>
struct Layout {
  static constexpr bool DIRECT = sizeof(XT) == 2;
  static constexpr int STAGES = 4;                 // ring depth
  static constexpr int X_ROW = BK * static_cast<int>(sizeof(XT));
  static constexpr int X_LD = DIRECT ? 0 : X_ROW;  // 0: core-matrix layout
  static constexpr int X_SLOT = BM * X_ROW;
  static constexpr int W_LD = TMA ? BN : BN + 16;  // padded: ldmatrix conflict-free
  static constexpr int W_SLOT = BK * W_LD;
  static constexpr int W_OFF = STAGES * X_SLOT;
  static constexpr int SX = W_OFF + STAGES * W_SLOT;
  static constexpr int BARS = SX + (DIRECT ? 0 : 2 * X_BYTES);
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;   // + alignment slack
  static constexpr int TX_BYTES = X_SLOT + BK * BN;       // bytes one stage's TMA brings
  static_assert(STAGES >= 3, "the ring keeps tiles in flight while one is multiplied");
  static_assert(ACC * NTHREADS * 4 <= W_OFF, "the split partials fit the ring");
};

// an f32 x tile -> the bf16 operand, rounded to nearest even
__device__ __forceinline__ void round_x(const uint8_t* raw, uint8_t* sx, int tid) {
#pragma unroll
  for (int i = 0; i < BM * (BK / 4) / NTHREADS; ++i) {
    const int e = tid + i * NTHREADS;
    const int r = e / (BK / 4), c = e % (BK / 4);
    const float4 v = *reinterpret_cast<const float4*>(raw + r * BK * 4 + c * 16);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(sx + tc::core_offset(BM, r, c * 8)) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <typename XT, typename OT, bool TMA>
__global__ void __launch_bounds__(BLOCK)
fta_int8_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w, tc::GTile gx, tc::GTile gw,
                       const float* __restrict__ scales, OT* __restrict__ y, int M, int K,
                       int N) {
  using L = Layout<XT, TMA>;
  constexpr int STAGES = L::STAGES;
  constexpr bool SW128 = TMA && L::DIRECT;        // x as TMA writes it, 128-byte swizzle
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* raw_x = smem;
  uint8_t* raw_w = smem + L::W_OFF;
  uint8_t* sx = smem + L::SX;                     // two rounded x tiles (f32 x only)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z, rank = blockIdx.z;
  const int k_tiles = (K + BK - 1) / BK;
  const int kt0 = k_tiles * rank / splits;
  const int T = k_tiles * (rank + 1) / splits - kt0;   // this split's K tiles, >= 1

  // local tile j (global K tile kt0 + j) -> ring slot j % STAGES
  auto tma_stage = [&](int j) {           // the producer's lane 0
    const int kt = kt0 + j, slot = j % STAGES;
    tc::mbar_expect_tx(&full[slot], L::TX_BYTES);
    tc::tma_load(raw_x + slot * L::X_SLOT, &map_x, m0, kt * BK, &full[slot]);
    tc::tma_load(raw_w + slot * L::W_SLOT, &map_w, kt * BK, n0, &full[slot]);
  };
  auto copy_stage = [&](int j) {          // the consumers, cp.async
    const int kt = kt0 + j, slot = j % STAGES;
    tc::load_tile<BM, L::X_ROW, L::X_LD, sizeof(XT), NTHREADS>(
        raw_x + slot * L::X_SLOT, gx, m0, static_cast<size_t>(kt) * L::X_ROW, tid);
    tc::load_tile<BK, BN, L::W_LD, 1, NTHREADS>(raw_w + slot * L::W_SLOT, gw, kt * BK,
                                                static_cast<size_t>(n0), tid);
    tc::cp_async_commit();
  };
  // the B descriptor of K step s of tile j
  auto x_desc = [&](int j, int s) -> uint64_t {
    if constexpr (SW128) return tc::wgmma_desc_sw128(raw_x + (j % STAGES) * L::X_SLOT + 32 * s);
    const uint8_t* t = L::DIRECT ? raw_x + (j % STAGES) * L::X_SLOT : sx + (j & 1) * X_BYTES;
    return tc::wgmma_desc(t + 2 * s * X_LBO, X_LBO, SBO);
  };

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) {
        tc::mbar_init(&full[s], 1);
        tc::mbar_init(&empty[s], 1);
      }
      tc::mbar_init_fence();
    }
    __syncthreads();
    if (warp == NTHREADS / 32) {          // the producer warp
      if (lane == 0) {
        tc::prefetch_tensor_map(&map_x);
        tc::prefetch_tensor_map(&map_w);
        for (int j = 0; j < T; ++j) {
          // slot j % STAGES: its previous tile (j - STAGES) handed back
          if (j >= STAGES) tc::mbar_wait(&empty[j % STAGES], (j / STAGES - 1) & 1);
          tma_stage(j);
        }
      }
    }
  } else if (tid < NTHREADS) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < T) {
        copy_stage(s);
      } else {
        tc::cp_async_commit();
      }
    }
  }

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  if (tid < NTHREADS) {                   // the consumer warpgroup
    // The ring runs ahead of the products. Tile j's A fragments are widened
    // in registers while the tensor cores still multiply tile j - 1.
    // a: tile j's fragments; prev: tile j - 1's, read by the tensor cores
    // until the wait, so kept live (and out of a's registers) until then.
    auto step = [&](uint32_t(&a)[BK / 16][4], uint32_t(&prev)[BK / 16][4], int j) {
      if constexpr (TMA) {
        tc::mbar_wait(&full[j % STAGES], (j / STAGES) & 1);   // tile j has landed
      } else {
        // tile j has landed; every warp is done with tile j - 1's raw w
        tc::cp_async_wait<STAGES - 2>();
        if constexpr (L::DIRECT) tc::fence_proxy_async();
        tc::named_sync(1, NTHREADS);
      }
      if constexpr (!L::DIRECT) {
        round_x(raw_x + (j % STAGES) * L::X_SLOT, sx + (j & 1) * X_BYTES, tid);
        tc::fence_proxy_async();
        tc::named_sync(1, NTHREADS);
      }
      tc::load_a_s8<L::W_LD>(a, raw_w + (j % STAGES) * L::W_SLOT, lane, warp);
      tc::wgmma_wait<0>();                // tile j - 1's products are done
      tc::fence_regs(acc);
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) tc::fence_regs(prev[s]);
      // tile j - 1's ring slot is free: its x was read by those products,
      // its weight by every warp's load_a_s8 before they were issued
      if constexpr (TMA) {
        if (j > 0 && tid == 0) tc::mbar_arrive(&empty[(j - 1) % STAGES]);
      } else {
        if (j + STAGES - 1 < T) {
          copy_stage(j + STAGES - 1);
        } else {
          tc::cp_async_commit();
        }
      }
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) tc::fence_regs(a[s]);
      tc::wgmma_fence();
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) tc::wgmma_bf16_n64_rs(acc, a[s], x_desc(j, s));
      tc::wgmma_commit();
    };
    uint32_t a0[BK / 16][4], a1[BK / 16][4];
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) a1[s][i] = 0;
    for (int j = 0; j < T; j += 2) {
      step(a0, a1, j);
      if (j + 1 < T) step(a1, a0, j + 1);
    }
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      tc::fence_regs(a0[s]);
      tc::fence_regs(a1[s]);
    }
    if constexpr (!TMA) tc::cp_async_wait<0>();
  }

  // acc[4 q + 2 h + c]: A row 16 warp + lane / 4 + 8 h (weight column n0 +
  // 16 warp + 2 (lane / 4) + h), x row 8 q + 2 (lane % 4) + c; the scale
  // once per output, at the store
  const int n = n0 + 16 * warp + 2 * (lane >> 2);
  auto out = [&](int p, float v0, float v1) {   // p = 2 q + c: x row, columns n, n + 1
    const int m = m0 + 8 * (p >> 1) + 2 * (lane & 3) + (p & 1);
    if (m >= M || n >= N) return;
    const bool second = n + 1 < N;
    tc::store2(y, static_cast<size_t>(m) * N + n, second && N % 2 == 0, second, v0 * scales[n],
           second ? v1 * scales[n + 1] : 0.f);
  };
  auto pair = [](int p) { return 4 * (p >> 1) + (p & 1); };   // acc index of (p, h = 0)
  if (splits == 1) {
    if (tid < NTHREADS) {
#pragma unroll
      for (int p = 0; p < ACC / 2; ++p) out(p, acc[pair(p)], acc[pair(p) + 2]);
    }
    return;
  }
  // split K: park the partials (over the ring, all of it consumed), then
  // rank r sums pairs p % splits == r
  __syncthreads();
  float* park = reinterpret_cast<float*>(smem);
  if (tid < NTHREADS) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) park[i * NTHREADS + tid] = acc[i];
  }
  tc::cluster_sync();
  if (tid < NTHREADS) {
#pragma unroll
    for (int p = 0; p < ACC / 2; ++p)
      if (p % splits == rank)
        out(p, tc::split_sum<float, NTHREADS>(park, pair(p), tid, splits),
            tc::split_sum<float, NTHREADS>(park, pair(p) + 2, tid, splits));
  }
  tc::cluster_sync();                     // the other blocks' reads of this park are done
}

template <typename XT, typename OT, bool TMA>
cudaError_t launch_with(const CUtensorMap& mx, const CUtensorMap& mw, const void* x,
                        const void* w_q, const void* scales, void* y, int M, int K, int N,
                        cudaStream_t stream) {
  constexpr int bytes = Layout<XT, TMA>::SMEM;
  const cudaError_t e = tc::allow_smem<fta_int8_matmul_kernel<XT, OT, TMA>>(bytes);
  if (e != cudaSuccess) return e;
  const tc::GTile gx = tc::make_gtile(x, M, static_cast<size_t>(K) * sizeof(XT));
  const tc::GTile gw = tc::make_gtile(w_q, K, static_cast<size_t>(N));
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  return tc::launch_split(fta_int8_matmul_kernel<XT, OT, TMA>, grid,
                          tc::k_splits((K + BK - 1) / BK, grid.x), BLOCK, bytes, stream, mx,
                          mw, gx, gw, static_cast<const float*>(scales), static_cast<OT*>(y),
                          M, K, N);
}

// TMA when both arrays' rows are 16-byte aligned, cp.async otherwise
template <typename XT, typename OT>
cudaError_t launch(const void* x, const void* w_q, const void* scales, void* y, int M, int K,
                   int N, cudaStream_t stream) {
  CUtensorMap mx, mw;
  constexpr bool bf16 = sizeof(XT) == 2;
  const CUtensorMapDataType x_type =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const bool tma =
      tc::tensor_map(&mx, x, x_type, sizeof(XT), M, K, BM, BK,
                     bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tc::tensor_map(&mw, w_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, BK, BN,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (tma) return launch_with<XT, OT, true>(mx, mw, x, w_q, scales, y, M, K, N, stream);
  return launch_with<XT, OT, false>(mx, mw, x, w_q, scales, y, M, K, N, stream);
}

template <typename XT>
cudaError_t dispatch_out(int out_dtype, const void* x, const void* w_q, const void* scales,
                         void* y, int M, int K, int N, cudaStream_t stream) {
  if (out_dtype == F32) return launch<XT, float>(x, w_q, scales, y, M, K, N, stream);
  if (out_dtype == BF16) return launch<XT, __nv_bfloat16>(x, w_q, scales, y, M, K, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns the
// launch's error (cudaErrorInvalidValue for shapes or dtypes the kernel
// does not take).
extern "C" int fta_int8_matmul_launch(const void* x, const void* w_q, const void* scales,
                                      void* y, int M, int K, int N, int x_dtype, int out_dtype,
                                      void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == F32)
    e = dispatch_out<float>(out_dtype, x, w_q, scales, y, M, K, N, s);
  else if (x_dtype == BF16)
    e = dispatch_out<__nv_bfloat16>(out_dtype, x, w_q, scales, y, M, K, N, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
