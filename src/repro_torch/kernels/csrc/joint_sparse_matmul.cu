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
// payload and add exactly +0.
//
// Design, bound and row stability: gather_matmul.cuh. bf16 x (the serving
// dtype) runs on the tensor cores: `wgmma` with the payload as the register
// operand (int8 widened to bf16 in registers), the gathered x tiles and the
// payload tiles brought by TMA from a producer warp, split K over a cluster
// for projections with few column tiles. f32 x runs fp32 FMAs on the CUDA
// cores (no TF32). At decode (M = 4) the kernel is bound by the payload's
// bytes; the per-filter scale is applied once per output at the store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gather_matmul.cuh"

namespace {

using gather::Args;

template <typename WT>
cudaError_t dispatch_out(int x_dtype, int out_dtype, const Args& a, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == gather::BF16) {
    if (out_dtype == gather::F32) return gather::launch_tc<WT, float>(a, s);
    if (out_dtype == gather::BF16) return gather::launch_tc<WT, bf16>(a, s);
  } else if (x_dtype == gather::F32) {
    if (out_dtype == gather::F32) return gather::launch_fp32<WT, float>(a, s);
    if (out_dtype == gather::BF16) return gather::launch_fp32<WT, bf16>(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns the
// launch's error (cudaErrorInvalidValue for shapes or dtypes the kernel
// does not take), so a refused launch never passes silently.
extern "C" int joint_sparse_matmul_launch(const void* x, const void* w_blocks, const void* idx,
                                          const void* scales, void* y, int M, int K, int NT,
                                          int MAXB, int bk, int bn, int x_dtype, int w_dtype,
                                          int out_dtype, void* stream) {
  const Args a{x, w_blocks, static_cast<const int32_t*>(idx), static_cast<const float*>(scales),
               y, M, K, NT, MAXB, bk, bn};
  if (!gather::valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (w_dtype == gather::I8)
    e = dispatch_out<int8_t>(x_dtype, out_dtype, a, s);
  else if (w_dtype == gather::BF16)
    e = dispatch_out<__nv_bfloat16>(x_dtype, out_dtype, a, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
