// Joint value x bit sparse matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `joint_sparse_matmul`
// (src/repro/kernels/joint_sparse_matmul.py, `_kernel` and its
// `pl.pallas_call`). Same function:
//
//   y[m, n*bn + c] = cast( scales[n*bn + c] *
//       sum_{b < MAXB} sum_{k < bk} x[m, idx[n, b]*bk + k] * float(w_blocks[n, b, k, c]) )
//
// x (M, K) f32 or bf16, row-major; w_blocks (NT, MAXB, bk, bn) int8 (joint /
// bit payload) or bf16 (value payload); idx (NT, MAXB) int32; scales (N,)
// f32 with N = NT * bn; y (M, N) f32 or bf16. Padded slots carry zero
// payload and add exactly 0.
//
// Design. One thread block per (row tile of BM rows, N tile, column chunk
// of CW columns): the TPU grid's (M/bm, NT) parallel dims, with the N tile
// split further so a decode step (M = 4) still launches several blocks per
// SM's worth of work. The TPU's sequential MAXB grid dim becomes a loop
// inside the block. Each block reads its own idx[n, b] (no scalar prefetch
// on Hopper), stages the gathered x rows and the (bk, CW) payload slice in
// shared memory as f32, and accumulates in f32 registers, one accumulator
// per output element. The per-filter scale is applied once at the store,
// then the cast. Ragged M is masked here, so callers do not pad M.
//
// Row stability: every output element sums b = 0..MAXB-1, then k = 0..bk-1,
// in that order, whatever M and whichever row tile holds the row. No split
// K. A row of an M = 4 call is therefore bitwise equal to the same row of an
// M = 256 call, which chunked prefill == stepwise decode rests on.
//
// Bound. At decode (M = n_slots, a handful of rows) the kernel does
// 2 * M flops per stored weight byte and is bound by device-memory bytes:
// the payload, read once. A simple first kernel: no TMA, no tensor cores;
// each block streams its payload slice through shared memory with plain
// loads. Making it reach the bytes bound is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;                    // rows per block
constexpr int CW = 32;                    // output columns per block (= lanes)
constexpr int WARPS = 4;                  // block = (CW, WARPS) threads
constexpr int ROWS_PER_THREAD = BM / WARPS;
constexpr int MAX_BK = 128;

enum DType { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename XT, typename WT, typename OT>
__global__ void __launch_bounds__(CW * WARPS)
joint_sparse_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ w_blocks,
                           const int32_t* __restrict__ idx, const float* __restrict__ scales,
                           OT* __restrict__ y, int M, int K, int NT, int MAXB, int bk, int bn) {
  __shared__ float xs[BM][MAX_BK];        // gathered activation rows, 8 KB
  __shared__ float ws[MAX_BK][CW];        // payload slice as f32, 16 KB

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * CW + lane;
  const int nthreads = CW * WARPS;
  const int m0 = blockIdx.x * BM;
  const int n = blockIdx.y;
  const int c0 = blockIdx.z * CW;
  const int col = c0 + lane;              // column inside the N tile
  const int N = NT * bn;

  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.f;

  for (int b = 0; b < MAXB; ++b) {
    const int kb = idx[n * MAXB + b];
    const XT* xsrc = x + static_cast<size_t>(kb) * bk;
    for (int e = tid; e < BM * bk; e += nthreads) {
      const int r = e / bk, k = e - r * bk;
      const int m = m0 + r;
      xs[r][k] = (m < M) ? to_f32(xsrc[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    const WT* wsrc = w_blocks + static_cast<size_t>(n * MAXB + b) * bk * bn;
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
  const float s = scales[out_col];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + warp + i * WARPS;
    if (m < M) store(&y[static_cast<size_t>(m) * N + out_col], acc[i] * s);
  }
}

template <typename XT, typename WT, typename OT>
void launch(const void* x, const void* w, const void* idx, const void* scales, void* y,
            int M, int K, int NT, int MAXB, int bk, int bn, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, NT, (bn + CW - 1) / CW);
  const dim3 block(CW, WARPS);
  joint_sparse_matmul_kernel<XT, WT, OT><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w), static_cast<const int32_t*>(idx),
      static_cast<const float*>(scales), static_cast<OT*>(y), M, K, NT, MAXB, bk, bn);
}

template <typename XT, typename WT>
bool dispatch_out(int out_dtype, const void* x, const void* w, const void* idx,
                  const void* scales, void* y, int M, int K, int NT, int MAXB, int bk, int bn,
                  cudaStream_t stream) {
  if (out_dtype == F32) {
    launch<XT, WT, float>(x, w, idx, scales, y, M, K, NT, MAXB, bk, bn, stream);
  } else if (out_dtype == BF16) {
    launch<XT, WT, __nv_bfloat16>(x, w, idx, scales, y, M, K, NT, MAXB, bk, bn, stream);
  } else {
    return false;
  }
  return true;
}

template <typename XT>
bool dispatch_w(int w_dtype, int out_dtype, const void* x, const void* w, const void* idx,
                const void* scales, void* y, int M, int K, int NT, int MAXB, int bk, int bn,
                cudaStream_t stream) {
  if (w_dtype == I8)
    return dispatch_out<XT, int8_t>(out_dtype, x, w, idx, scales, y, M, K, NT, MAXB, bk, bn,
                                    stream);
  if (w_dtype == BF16)
    return dispatch_out<XT, __nv_bfloat16>(out_dtype, x, w, idx, scales, y, M, K, NT, MAXB,
                                           bk, bn, stream);
  return false;
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes or dtypes the kernel
// does not take), so a refused launch never passes silently.
extern "C" int joint_sparse_matmul_launch(const void* x, const void* w_blocks, const void* idx,
                                          const void* scales, void* y, int M, int K, int NT,
                                          int MAXB, int bk, int bn, int x_dtype, int w_dtype,
                                          int out_dtype, void* stream) {
  if (M <= 0 || NT <= 0 || MAXB <= 0 || bk <= 0 || bk > MAX_BK || bk % 8 || bn <= 0 ||
      bn % 8 || K % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (x_dtype == F32)
    ok = dispatch_w<float>(w_dtype, out_dtype, x, w_blocks, idx, scales, y, M, K, NT, MAXB, bk,
                           bn, s);
  else if (x_dtype == BF16)
    ok = dispatch_w<__nv_bfloat16>(w_dtype, out_dtype, x, w_blocks, idx, scales, y, M, K, NT,
                                   MAXB, bk, bn, s);
  else
    ok = false;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
