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
//
// Backward (the training path's gradient; the reference differentiates
// its jnp norms with XLA). Two kernels, launched one after the other by
// `row_norm_bwd_launch`:
//
//   row_norm_bwd_kernel: per row, in fp32 from x and dy (x's dtype),
//     xhat = (x - mu) * inv (RMSNorm: mu = 0), g = dy * s,
//     rms:        dx = inv * (g - xhat * mean(g * xhat))
//     layernorm:  dx = inv * (g - mean(g) - xhat * mean(g * xhat))
//   cast to x's dtype, with the forward's layout (tpr threads a row,
//   chunks of 8 in registers; the row sums in the forward's order). The
//   parameter gradients dscale = sum over rows of dy * xhat (and dbias =
//   sum of dy) take no float atomics: a block's row slot (block b, row r
//   of the block) walks rows slot, slot + P, ... (P = the slots of the
//   grid) and keeps its partial per element in registers, written to
//   `partial` (P, D) at the end;
//   row_norm_param_sum_kernel: one thread a column adds the P partials in
//   slot order.
// Every order is fixed by (R, D), so two launches on the same inputs give
// the same bits. Bound: bytes (x and dy read once, dx written once; the
// partials are P x D floats, P <= 264 x rows a block). Up to D = 8192 (4
// chunks a thread: x, dy and the partials stay in registers); a longer
// row raises in the wrapper.

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

constexpr int BWD_MAX_CPT = 4;            // chunks a thread in the backward
constexpr int BWD_MAX_BLOCKS = 264;       // blocks of the backward's grid: 2 an SM

template <typename T, int CPT, bool LAYER>
__global__ void __launch_bounds__(BLOCK)
row_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ scale, T* __restrict__ dx,
                    float* __restrict__ partial, int R, int D, float eps, int plus_one, int tpr) {
  constexpr bool layer = LAYER;
  __shared__ float red[BLOCK / 32];
  const int rpb = blockDim.x / tpr;
  const int row_in_block = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int slot = blockIdx.x * rpb + row_in_block;
  const int P = gridDim.x * rpb;
  const float fd = static_cast<float>(D);
  float acc_s[CPT][8], acc_b[CPT][8];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_s[c][i] = acc_b[c][i] = 0.f;

  // every slot of the block walks the same number of rows, so each takes
  // every barrier; rows past R load zeros and store nothing
  const int rounds = (R + P - 1) / P;
  for (int k = 0; k < rounds; ++k) {
    const int r = slot + k * P;
    const bool live = r < R;
    const T* xr = x + static_cast<size_t>(live ? r : 0) * D;
    const T* gr = dy + static_cast<size_t>(live ? r : 0) * D;
    float xv[CPT][8], gv[CPT][8], sc[CPT][8];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i0 = (t + c * tpr) * 8;
      if (live && i0 < D) {
        load_chunk(xv[c], xr, i0, D);
        load_chunk(gv[c], gr, i0, D);
        load_chunk(sc[c], scale, i0, D);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[c][i] = gv[c][i] = sc[c][i] = 0.f;
      }
    }
    float mu = 0.f;
    if (layer) {
      float sx = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) sx += xv[c][i];
      mu = row_sum(sx, tpr, row_in_block, red) / fd;
    }
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i0 = (t + c * tpr) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i0 + i < D) {
          const float d = layer ? xv[c][i] - mu : xv[c][i];
          ss = fmaf(d, d, ss);
        }
      }
    }
    const float inv = rsqrtf(row_sum(ss, tpr, row_in_block, red) / fd + eps);
    // xhat in place of x, g = dy * s in place of the scale
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i0 = (t + c * tpr) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i0 + i < D) {
          const float xh = (layer ? xv[c][i] - mu : xv[c][i]) * inv;
          const float s = (plus_one && !layer) ? 1.f + sc[c][i] : sc[c][i];
          const float g = gv[c][i] * s;
          acc_s[c][i] = fmaf(gv[c][i], xh, acc_s[c][i]);
          if (layer) acc_b[c][i] += gv[c][i];
          xv[c][i] = xh;
          sc[c][i] = g;
          sg += g;
          sgx = fmaf(g, xh, sgx);
        }
      }
    }
    const float mg = layer ? row_sum(sg, tpr, row_in_block, red) / fd : 0.f;
    const float mgx = row_sum(sgx, tpr, row_in_block, red) / fd;
    if (!live) continue;
    T* drow = dx + static_cast<size_t>(r) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i0 = (t + c * tpr) * 8;
      if (i0 >= D) continue;
      float y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = inv * (sc[c][i] - mg - xv[c][i] * mgx);
      if (i0 + 8 <= D && aligned16(drow + i0)) {
        store8(drow + i0, y);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i0 + i < D) store1(drow + i0 + i, y[i]);
      }
    }
  }
  // this slot's partials: dscale's rows [0, P), dbias's [P, 2P)
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i0 = (t + c * tpr) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i0 + i < D) {
        partial[static_cast<size_t>(slot) * D + i0 + i] = acc_s[c][i];
        if (layer) partial[static_cast<size_t>(P + slot) * D + i0 + i] = acc_b[c][i];
      }
    }
  }
}

// dscale[d] (and dbias[d]) = the P partials of column d, added in slot order
__global__ void __launch_bounds__(BLOCK)
row_norm_param_sum_kernel(const float* __restrict__ partial, int P, int D, int layer,
                          float* __restrict__ dscale, float* __restrict__ dbias) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float s = 0.f, b = 0.f;
  for (int p = 0; p < P; ++p) s += partial[static_cast<size_t>(p) * D + d];
  dscale[d] = s;
  if (layer) {
    for (int p = 0; p < P; ++p) b += partial[static_cast<size_t>(P + p) * D + d];
    dbias[d] = b;
  }
}

// the backward's grid: (blocks, threads a row, chunks a thread); blocks 0
// when D is past the backward's limit
__host__ void bwd_layout(int R, int D, int* blocks, int* tpr, int* cpt) {
  layout(D, tpr, cpt);
  if (*cpt == 0 || *cpt > BWD_MAX_CPT) {
    *blocks = 0;
    return;
  }
  const int rpb = BLOCK / *tpr;
  const long long need = (static_cast<long long>(R) + rpb - 1) / rpb;
  *blocks = static_cast<int>(need < BWD_MAX_BLOCKS ? need : BWD_MAX_BLOCKS);
}

template <typename T, int CPT>
int launch_bwd_cpt(const void* x, const void* dy, const float* scale, int layer, void* dx,
                   float* partial, float* dscale, float* dbias, int R, int D, float eps,
                   int plus_one, int tpr, int blocks, cudaStream_t stream) {
  if (layer)
    row_norm_bwd_kernel<T, CPT, true><<<blocks, BLOCK, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), scale, static_cast<T*>(dx), partial,
        R, D, eps, plus_one, tpr);
  else
    row_norm_bwd_kernel<T, CPT, false><<<blocks, BLOCK, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), scale, static_cast<T*>(dx), partial,
        R, D, eps, plus_one, tpr);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int P = blocks * (BLOCK / tpr);
  row_norm_param_sum_kernel<<<(D + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(partial, P, D, layer,
                                                                          dscale, dbias);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const float* scale, int layer, void* dx,
               float* partial, float* dscale, float* dbias, int R, int D, float eps,
               int plus_one, cudaStream_t stream) {
  int blocks = 0, tpr = 0, cpt = 0;
  bwd_layout(R, D, &blocks, &tpr, &cpt);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (cpt) {
    case 1: return launch_bwd_cpt<T, 1>(x, dy, scale, layer, dx, partial, dscale, dbias, R, D,
                                        eps, plus_one, tpr, blocks, stream);
    case 2: return launch_bwd_cpt<T, 2>(x, dy, scale, layer, dx, partial, dscale, dbias, R, D,
                                        eps, plus_one, tpr, blocks, stream);
    case 3: return launch_bwd_cpt<T, 3>(x, dy, scale, layer, dx, partial, dscale, dbias, R, D,
                                        eps, plus_one, tpr, blocks, stream);
    case 4: return launch_bwd_cpt<T, 4>(x, dy, scale, layer, dx, partial, dscale, dbias, R, D,
                                        eps, plus_one, tpr, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The backward's partial rows for R rows of D: the row slots of its grid
// (dscale's; LayerNorm's dbias takes as many again), 0 when D is past its
// limit of 8192. The wrapper allocates `partial` from it.
extern "C" int row_norm_bwd_slots(int R, int D) {
  if (R <= 0 || D <= 0) return 0;
  int blocks = 0, tpr = 0, cpt = 0;
  bwd_layout(R, D, &blocks, &tpr, &cpt);
  return blocks * (BLOCK / tpr);
}

// C entry point of the backward, loaded with ctypes: dx (x's dtype, R x D)
// and dscale, dbias (D floats; dbias only for LayerNorm, `layer` = 1) from
// x and dy (x's dtype) and the forward's scale; `partial` holds
// row_norm_bwd_slots(R, D) x D floats (twice that for LayerNorm). Launches
// both kernels on `stream`; returns the first cudaGetLastError() that is
// not 0 (cudaErrorInvalidValue for shapes it does not take).
extern "C" int row_norm_bwd_launch(const void* x, const void* dy, const void* scale, int layer,
                                   void* dx, void* partial, void* dscale, void* dbias, int R,
                                   int D, float eps, int plus_one, int dtype, void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* pa = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  if (dtype == F32)
    return launch_bwd<float>(x, dy, sc, layer, dx, pa, ds, db, R, D, eps, plus_one, s);
  if (dtype == BF16)
    return launch_bwd<__nv_bfloat16>(x, dy, sc, layer, dx, pa, ds, db, R, D, eps, plus_one, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
