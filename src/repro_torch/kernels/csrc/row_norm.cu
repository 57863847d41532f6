// Row-stable RMSNorm / LayerNorm for Hopper (sm_90a): the serving path's
// norms over the last axis.
//
// Replaces no TPU kernel: the reference computes these with plain jnp
// (`apply_norm`, `rms_head_norm`, src/repro/models/layers.py). The port runs
// them in a kernel of its own so that a row comes out bitwise the same in
// a 1-token decode and a C-token prefill chunk: torch's mean picks its
// summation order from the whole shape (how many rows share a block), so
// the two paths would part in the last bits. Same function as the
// reference, in fp32, the result cast to x's dtype:
//
//   rms:        out = x * rsqrt(mean(x * x) + eps) * s,  s = scale or 1 + scale
//   layernorm:  out = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * scale + bias
//
// x (R, D) f32 or bf16, contiguous; scale, bias (D,) f32; out (R, D) in x's
// dtype.
//
// Design. One warp per row, four rows per block. Lane l sums elements
// l, l + 32, ... in order, the warp adds the 32 partial sums by xor
// butterflies: the order depends on D alone, whatever R is.
//
// Bound. Reads x once (plus L1 re-reads for the second pass) and writes
// out once: bytes-bound, a few flops per element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 4;                   // rows per block, one warp each

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * ROWS)
row_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out, int R, int D, float eps,
                int plus_one) {
  const int lane = threadIdx.x;
  const int r = blockIdx.x * ROWS + threadIdx.y;
  if (r >= R) return;
  const T* xr = x + static_cast<size_t>(r) * D;
  T* orow = out + static_cast<size_t>(r) * D;
  const float fd = static_cast<float>(D);
  if (bias == nullptr) {
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float xv = to_f32(xr[d]);
      ss = fmaf(xv, xv, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / fd + eps);
    for (int d = lane; d < D; d += 32) {
      const float s = plus_one ? 1.f + scale[d] : scale[d];
      store(&orow[d], to_f32(xr[d]) * inv * s);
    }
  } else {
    float sx = 0.f;
    for (int d = lane; d < D; d += 32) sx += to_f32(xr[d]);
    const float mu = warp_sum(sx) / fd;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = to_f32(xr[d]) - mu;
      ss = fmaf(c, c, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / fd + eps);
    for (int d = lane; d < D; d += 32)
      store(&orow[d], (to_f32(xr[d]) - mu) * inv * scale[d] + bias[d]);
  }
}

template <typename T>
void launch(const void* x, const float* scale, const float* bias, void* out, int R, int D,
            float eps, int plus_one, cudaStream_t stream) {
  const dim3 grid((R + ROWS - 1) / ROWS);
  const dim3 block(32, ROWS);
  row_norm_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), scale, bias,
                                                  static_cast<T*>(out), R, D, eps, plus_one);
}

}  // namespace

// C entry point, loaded with ctypes. x and out share `dtype`; bias is null
// for RMSNorm. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes or dtypes the kernel does not take).
extern "C" int row_norm_launch(const void* x, const void* scale, const void* bias, void* out,
                               int R, int D, float eps, int plus_one, int dtype, void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == F32)
    launch<float>(x, sc, bi, out, R, D, eps, plus_one, s);
  else if (dtype == BF16)
    launch<__nv_bfloat16>(x, sc, bi, out, R, D, eps, plus_one, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
