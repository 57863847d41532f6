// Block-sparse matmul for Hopper (sm_90a): the value-level sparsity path.
//
// Replaces the Pallas TPU kernel `block_sparse_matmul`
// (src/repro/kernels/block_sparse_matmul.py, `_kernel` and its
// `pl.pallas_call`). Same function:
//
//   y[m, n*bn + c] = cast( sum_{b < MAXB} sum_{k < bk}
//                          x[m, idx[n, b]*bk + k] * w_blocks[n, b, k, c] )
//
// x (M, K) f32 or bf16, row-major; w_blocks (NT, MAXB, bk, bn) in x's dtype
// (the surviving K-blocks of each N tile, zero blocks in padded slots);
// idx (NT, MAXB) int32; y (M, NT * bn) in x's dtype. No scales and no
// quantization: this is the joint kernel's compacted layout with a raw
// payload.
//
// Design. One thread block per (row tile of BM rows, N tile, column chunk
// of CW columns): the TPU grid's parallel (M/BM, NT) dims, with the N tile
// split further so small M still launches several blocks per SM. The
// TPU's sequential MAXB grid dim becomes a loop inside the block; each
// block reads its own idx[n, b] (Hopper has no scalar prefetch), stages
// the gathered x rows and the (bk, CW) payload slice in shared memory as
// f32, and keeps one f32 accumulator per output in registers. Every
// product is a true fp32 FMA (no TF32), so f32 activations keep full
// precision. Ragged M is masked here; callers do not pad M, and the TPU's
// M % 128 == 0 rule does not carry over.
//
// Row stability: every output sums b = 0..MAXB-1, then k = 0..bk-1, in that
// order, whatever M and whichever row tile holds the row.
//
// Bound. At the per-layer path's 256 rows the kernel does 2 * M flops per
// stored weight; the H100's tensor cores would make it bytes-bound, these
// CUDA-core FMAs make it compute-bound far below that. A simple first
// kernel: no TMA, no tensor cores. Making it reach its bound is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;                    // rows per block
constexpr int CW = 32;                    // output columns per block (= lanes)
constexpr int WARPS = 4;                  // block = (CW, WARPS) threads
constexpr int ROWS_PER_THREAD = BM / WARPS;
constexpr int MAX_BK = 128;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(CW * WARPS)
block_sparse_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w_blocks,
                           const int32_t* __restrict__ idx, T* __restrict__ y,
                           int M, int K, int NT, int MAXB, int bk, int bn) {
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
    const T* xsrc = x + static_cast<size_t>(kb) * bk;
    for (int e = tid; e < BM * bk; e += nthreads) {
      const int r = e / bk, k = e - r * bk;
      const int m = m0 + r;
      xs[r][k] = (m < M) ? to_f32(xsrc[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    const T* wsrc = w_blocks + static_cast<size_t>(n * MAXB + b) * bk * bn;
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
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + warp + i * WARPS;
    if (m < M) store(&y[static_cast<size_t>(m) * N + out_col], acc[i]);
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* idx, void* y, int M, int K, int NT,
            int MAXB, int bk, int bn, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, NT, (bn + CW - 1) / CW);
  const dim3 block(CW, WARPS);
  block_sparse_matmul_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int32_t*>(idx),
      static_cast<T*>(y), M, K, NT, MAXB, bk, bn);
}

}  // namespace

// C entry point, loaded with ctypes. x, w_blocks and y share `dtype`.
// Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes or dtypes the kernel does not take).
extern "C" int block_sparse_matmul_launch(const void* x, const void* w_blocks, const void* idx,
                                          void* y, int M, int K, int NT, int MAXB, int bk,
                                          int bn, int dtype, void* stream) {
  if (M <= 0 || NT <= 0 || MAXB <= 0 || bk <= 0 || bk > MAX_BK || bk % 8 || bn <= 0 ||
      bn % 8 || K % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    launch<float>(x, w_blocks, idx, y, M, K, NT, MAXB, bk, bn, s);
  else if (dtype == BF16)
    launch<__nv_bfloat16>(x, w_blocks, idx, y, M, K, NT, MAXB, bk, bn, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
