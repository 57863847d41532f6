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
// quantization: the joint kernel's compacted layout with a raw payload, so
// both run the gathered-K kernels of gather_matmul.cuh (design, bound and
// row stability there). bf16 runs on the tensor cores (`wgmma`, the bf16
// payload as the register operand, x and payload tiles by TMA from a
// producer warp, split K over a cluster for few column tiles); f32 runs
// true fp32 FMAs on the CUDA cores (no TF32), so f32 activations keep full
// precision. Ragged M is masked in the kernel; the TPU's M % 128 == 0 rule
// does not carry over. At the per-layer path's 256 rows the kernel is
// bound by bytes (the payload and x, read once).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gather_matmul.cuh"

// C entry point, loaded with ctypes. x, w_blocks and y share `dtype`.
// Launches on `stream` and returns the launch's error
// (cudaErrorInvalidValue for shapes or dtypes the kernel does not take).
extern "C" int block_sparse_matmul_launch(const void* x, const void* w_blocks, const void* idx,
                                          void* y, int M, int K, int NT, int MAXB, int bk,
                                          int bn, int dtype, void* stream) {
  const gather::Args a{x, w_blocks, static_cast<const int32_t*>(idx), nullptr, y, M, K, NT,
                       MAXB, bk, bn};
  if (!gather::valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == gather::F32)
    e = gather::launch_fp32<float, float>(a, s);
  else if (dtype == gather::BF16)
    e = gather::launch_tc<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
