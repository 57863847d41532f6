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
// x (R, D) f32 or bf16, contiguous (any base alignment); scale, bias (D,)
// f32; out (R, D) in x's dtype.
//
// Bound. Reads x once and writes out once, a few flops per element: bytes
// (at R = 4, D = 2048 all of 33 KB, so a launch is latency: one load round
// trip, a reduction, one store).
//
// Design. The row is cut into chunks of 8 elements (16 bytes of bf16).
// `tpr` threads share a row and `rpb` rows share a block, both from D
// alone: tpr the power of two >= D / 8 up to 256, rpb = 256 / tpr. Thread t
// holds chunks t, t + tpr, ... in registers (16-byte loads where the chunk
// is whole and aligned, element by element otherwise, the same values
// either way), so x is read from memory once. Summation order, over
// element indices: thread t adds its elements in index order, an xor
// butterfly adds the threads of a warp, the warps of a row are added in
// order. Nothing in it depends on R or on how the elements were loaded.
// scale and bias are read as float4 where aligned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;                // threads per block, the most per row
constexpr int MAX_CPT = 16;               // chunks per thread, at most

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 8 elements at p (whole and aligned: one or two 16-byte loads)
__device__ __forceinline__ void load8(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the chunk of 8 elements at [i0, i0 + 8) of a row of D, zeros past D
template <typename T>
__device__ __forceinline__ void load_chunk(float (&v)[8], const T* row, int i0, int D) {
  if (i0 + 8 <= D && aligned16(row + i0)) {
    load8(v, row + i0);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i0 + i < D ? to_f32(row[i0 + i]) : 0.f;
  }
}

// The sum of every thread's value over the `tpr` threads of its row: the
// xor butterfly inside the warp (all lanes of a row end equal), then the
// row's warps in order through `red` (a block barrier each way).
__device__ __forceinline__ float row_sum(float v, int tpr, int row_in_block, float* red) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tpr <= 32) return v;
  const int nw = tpr >> 5, w = (threadIdx.x % tpr) >> 5;
  if ((threadIdx.x & 31) == 0) red[row_in_block * nw + w] = v;
  __syncthreads();
  float s = red[row_in_block * nw];
  for (int i = 1; i < nw; ++i) s += red[row_in_block * nw + i];
  __syncthreads();
  return s;
}

template <typename T, int CPT>
__global__ void __launch_bounds__(BLOCK)
row_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ out, int R, int D, float eps,
                int plus_one, int tpr) {
  __shared__ float red[BLOCK / 32];
  const int rpb = blockDim.x / tpr;
  const int row_in_block = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int r = blockIdx.x * rpb + row_in_block;
  const bool live = r < R;                // rows past R still take the barriers
  const T* xr = x + static_cast<size_t>(live ? r : 0) * D;
  T* orow = out + static_cast<size_t>(r) * D;
  const float fd = static_cast<float>(D);

  float xv[CPT][8];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i0 = (t + c * tpr) * 8;
    if (live && i0 < D) {
      load_chunk(xv[c], xr, i0, D);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[c][i] = 0.f;
    }
  }

  float mu = 0.f;
  if (bias != nullptr) {
    float sx = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) sx += xv[c][i];   // zeros past D add nothing
    mu = row_sum(sx, tpr, row_in_block, red) / fd;
  }
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i0 = (t + c * tpr) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i0 + i < D) {
        const float d = bias != nullptr ? xv[c][i] - mu : xv[c][i];
        ss = fmaf(d, d, ss);
      }
    }
  }
  const float inv = rsqrtf(row_sum(ss, tpr, row_in_block, red) / fd + eps);
  if (!live) return;

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i0 = (t + c * tpr) * 8;
    if (i0 >= D) continue;
    float sc[8], bi[8], y[8];
    load_chunk(sc, scale, i0, D);
    if (bias != nullptr) {
      load_chunk(bi, bias, i0, D);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = (xv[c][i] - mu) * inv * sc[i] + bi[i];
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = xv[c][i] * inv * (plus_one ? 1.f + sc[i] : sc[i]);
    }
    if (i0 + 8 <= D && aligned16(orow + i0)) {
      store8(orow + i0, y);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i0 + i < D) store1(orow + i0 + i, y[i]);
    }
  }
}

// (threads per row, chunks per thread) from D alone; cpt 0 when D is too long
__host__ void layout(int D, int* tpr, int* cpt) {
  const int chunks = (D + 7) / 8;
  int t = 1;
  while (t < chunks && t < BLOCK) t *= 2;
  int c = (chunks + t - 1) / t;
  // rounded up to an instantiated count: the extra chunks lie past D
  constexpr int COUNTS[] = {1, 2, 3, 4, 6, 8, 12, MAX_CPT};
  for (const int k : COUNTS)
    if (c <= k) {
      c = k;
      break;
    }
  *tpr = t;
  *cpt = c <= MAX_CPT ? c : 0;
}

template <typename T, int CPT>
int launch_cpt(const void* x, const float* scale, const float* bias, void* out, int R, int D,
               float eps, int plus_one, int tpr, cudaStream_t stream) {
  const int rpb = BLOCK / tpr;
  const long long blocks = (static_cast<long long>(R) + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  row_norm_kernel<T, CPT><<<static_cast<unsigned>(blocks), BLOCK, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), R, D, eps, plus_one, tpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* scale, const float* bias, void* out, int R, int D,
           float eps, int plus_one, cudaStream_t stream) {
  int tpr = 0, cpt = 0;
  layout(D, &tpr, &cpt);
  switch (cpt) {
    case 1: return launch_cpt<T, 1>(x, scale, bias, out, R, D, eps, plus_one, tpr, stream);
    case 2: return launch_cpt<T, 2>(x, scale, bias, out, R, D, eps, plus_one, tpr, stream);
    case 3: return launch_cpt<T, 3>(x, scale, bias, out, R, D, eps, plus_one, tpr, stream);
    case 4: return launch_cpt<T, 4>(x, scale, bias, out, R, D, eps, plus_one, tpr, stream);
    case 6: return launch_cpt<T, 6>(x, scale, bias, out, R, D, eps, plus_one, tpr, stream);
    case 8: return launch_cpt<T, 8>(x, scale, bias, out, R, D, eps, plus_one, tpr, stream);
    case 12: return launch_cpt<T, 12>(x, scale, bias, out, R, D, eps, plus_one, tpr, stream);
    case 16: return launch_cpt<T, 16>(x, scale, bias, out, R, D, eps, plus_one, tpr, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point, loaded with ctypes. x and out share `dtype`; bias is null
// for RMSNorm. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes or dtypes the kernel does not take:
// D > 32768, the most 256 threads hold at 16 chunks of 8 each).
extern "C" int row_norm_launch(const void* x, const void* scale, const void* bias, void* out,
                               int R, int D, float eps, int plus_one, int dtype, void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == F32) return launch<float>(x, sc, bi, out, R, D, eps, plus_one, s);
  if (dtype == BF16) return launch<__nv_bfloat16>(x, sc, bi, out, R, D, eps, plus_one, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
