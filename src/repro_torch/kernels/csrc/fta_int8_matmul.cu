// FTA/INT8 weight matmul for Hopper (sm_90a): the bit-level sparsity path.
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
// with the K sum); y (M, N) f32 or bf16.
//
// Design. One thread block per (row tile of BM rows, chunk of CW output
// columns). The TPU's sequential K grid dim (BK = 512) becomes a loop
// inside the block over K chunks of KC; each chunk stages the bf16-rounded
// x rows and the int8 weight slice in shared memory as f32, and each thread
// keeps one f32 accumulator per output in registers. A bf16 x int8 product
// is exact in f32, so only the sum order differs from the TPU. No TPU tile
// constraint survives: any M, K and N, ragged edges masked here.
//
// Row stability: every output sums k = 0..K-1 in order, whatever M.
//
// Bound. At the per-layer path's 256 rows the work is 2 * M * K * N flops on
// 1 byte of weight each; the tensor cores would leave it bytes-bound at
// small M and compute-bound at large M. These CUDA-core FMAs are far below
// either bound: a simple first kernel (no TMA, no tensor cores), to be made
// fast later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;                    // rows per block
constexpr int CW = 32;                    // output columns per block (= lanes)
constexpr int WARPS = 4;                  // block = (CW, WARPS) threads
constexpr int ROWS_PER_THREAD = BM / WARPS;
constexpr int KC = 128;                   // K chunk staged per iteration

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename XT, typename OT>
__global__ void __launch_bounds__(CW * WARPS)
fta_int8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w_q,
                       const float* __restrict__ scales, OT* __restrict__ y, int M, int K,
                       int N) {
  __shared__ float xs[BM][KC];            // bf16-rounded activation rows, 8 KB
  __shared__ float ws[KC][CW];            // int8 weight slice as f32, 16 KB

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * CW + lane;
  const int nthreads = CW * WARPS;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * CW;
  const int col = c0 + lane;

  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int e = tid; e < BM * kc; e += nthreads) {
      const int r = e / kc, k = e - r * kc;
      const int m = m0 + r;
      xs[r][k] = (m < M) ? bf16_round(x[static_cast<size_t>(m) * K + k0 + k]) : 0.f;
    }
    for (int e = tid; e < kc * CW; e += nthreads) {
      const int k = e / CW, c = e - k * CW;
      ws[k][c] = (c0 + c < N)
                     ? static_cast<float>(w_q[static_cast<size_t>(k0 + k) * N + c0 + c])
                     : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float wv = ws[k][lane];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
        acc[i] = fmaf(xs[warp + i * WARPS][k], wv, acc[i]);
    }
    __syncthreads();
  }

  if (col >= N) return;
  const float s = scales[col];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + warp + i * WARPS;
    if (m < M) store(&y[static_cast<size_t>(m) * N + col], acc[i] * s);
  }
}

template <typename XT, typename OT>
void launch(const void* x, const void* w_q, const void* scales, void* y, int M, int K, int N,
            cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + CW - 1) / CW);
  const dim3 block(CW, WARPS);
  fta_int8_matmul_kernel<XT, OT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(scales), static_cast<OT*>(y), M, K, N);
}

template <typename XT>
bool dispatch_out(int out_dtype, const void* x, const void* w_q, const void* scales, void* y,
                  int M, int K, int N, cudaStream_t stream) {
  if (out_dtype == F32)
    launch<XT, float>(x, w_q, scales, y, M, K, N, stream);
  else if (out_dtype == BF16)
    launch<XT, __nv_bfloat16>(x, w_q, scales, y, M, K, N, stream);
  else
    return false;
  return true;
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes or dtypes the kernel
// does not take).
extern "C" int fta_int8_matmul_launch(const void* x, const void* w_q, const void* scales,
                                      void* y, int M, int K, int N, int x_dtype, int out_dtype,
                                      void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (x_dtype == F32)
    ok = dispatch_out<float>(out_dtype, x, w_q, scales, y, M, K, N, s);
  else if (x_dtype == BF16)
    ok = dispatch_out<__nv_bfloat16>(out_dtype, x, w_q, scales, y, M, K, N, s);
  else
    ok = false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
