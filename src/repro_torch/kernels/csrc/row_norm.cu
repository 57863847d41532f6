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
// `row_norm_bwd_launch`; they write every element of dx, dscale and
// dbias, so nothing is zero-filled first.
//
//   row_norm_bwd_kernel: per row, in fp32 from x and dy (x's dtype),
//     xhat = (x - mu) * inv (RMSNorm: mu = 0), g = dy * s,
//     rms:        dx = inv * (g - xhat * mean(g * xhat))
//     layernorm:  dx = inv * (g - mean(g) - xhat * mean(g * xhat))
//   cast to x's dtype. A row is cut into chunks of 8; `tpr` threads share
//   it, from D alone: the least power of two that holds it at 4 chunks a
//   thread (D = 2048: 64 threads, two warps). One pass over the row's
//   registers gives all its sums at once (sum (x - mu)^2, sum g (x - mu),
//   LayerNorm's sum g; mean(g * xhat) = inv * sum g (x - mu) / D), each
//   thread one chain a chunk, then its chunks in order, then an xor
//   butterfly in the warp and, past one warp, the row's warps in order
//   behind a named barrier of the row's own threads: one row sum a row
//   (LayerNorm two: mu first), no barrier of the whole block. That order
//   over element indices is fixed by D alone, never by R. A second pass
//   writes dx. x and dy stay as raw 16-byte words in registers; a block
//   of 256 threads holds 256 / tpr rows, two blocks an SM, so that at
//   1,024 rows of 2,048 every row of the call is in flight at once, the
//   first row's loads issued before the scale's. The scale (1 + scale) is
//   read once a block, into shared memory.
//   The parameter gradients dscale = sum over rows of dy * xhat (and dbias
//   = sum of dy) take no float atomics: a row slot (block b, row group g)
//   walks rows slot, slot + S, ... (S the slots of the grid) and keeps its
//   sums per element in registers; the block then adds its row groups'
//   sums in group order through shared memory (one barrier) into one
//   partial row of `partial` (P, D), P the blocks of the grid (256 at
//   1,024 rows of 2,048; at most 264);
//   row_norm_param_sum_kernel: a block per 32 columns, 16 warps; warp w
//   adds its fixed run of the P partials in slot order (16 loads in flight
//   before their adds), then warp 0 adds the warps' sums in warp order.
// Every order is fixed by (R, D), so two launches on the same inputs give
// the same bits. Bound: bytes, x and dy read once and dx written once (at
// 1,024 x 2,048 bf16, 12.6 MB: 3.76 us at 3.35 TB/s); the partials, P x D
// floats (twice that for LayerNorm), are written and read once more,
// mostly in L2. What the time is beyond the bound: each row's sum is a
// chain of latencies (loads, shuffles, the row's barrier) that the other
// rows of an SM must cover, and the second launch. Up to D = 8192 (256
// threads of 4 chunks); a longer row raises in the wrapper.

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

constexpr int BWD_BLOCK = 256;            // threads of a backward block
constexpr int BWD_CPT = 4;                // chunks a thread holds, at most
constexpr int BWD_SM_BLOCKS = 2;          // backward blocks an SM holds (<= 128 registers)
constexpr int BWD_MAX_BLOCKS = 132 * BWD_SM_BLOCKS;  // the grid's cap: the H100's 132 SMs full
constexpr int SUM_WARPS = 16;             // warps of a parameter-sum block: runs of slots
constexpr int SUM_BATCH = 16;             // partials a thread loads before it adds them

// 8 elements of T as their raw 32-bit words (bf16: two a word, element
// 2k in the low half of word k), zeros past D
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> { uint32_t u[4]; };
template <> struct Raw8<float> { uint32_t u[8]; };

__device__ __forceinline__ float at(const Raw8<__nv_bfloat16>& c, int i) {
  const uint32_t w = c.u[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float at(const Raw8<float>& c, int i) { return __uint_as_float(c.u[i]); }

__device__ __forceinline__ void load_raw(Raw8<__nv_bfloat16>& c, const __nv_bfloat16* row, int i0,
                                         int D) {
  if (i0 + 8 <= D && aligned16(row + i0)) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + i0);
    c.u[0] = q.x; c.u[1] = q.y; c.u[2] = q.z; c.u[3] = q.w;
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + 2 * k;
      const uint32_t lo = i < D ? h[i] : 0u, hi = i + 1 < D ? h[i + 1] : 0u;
      c.u[k] = lo | (hi << 16);
    }
  }
}
__device__ __forceinline__ void load_raw(Raw8<float>& c, const float* row, int i0, int D) {
  if (i0 + 8 <= D && aligned16(row + i0)) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + i0);
    const uint4 b = *reinterpret_cast<const uint4*>(row + i0 + 4);
    c.u[0] = a.x; c.u[1] = a.y; c.u[2] = a.z; c.u[3] = a.w;
    c.u[4] = b.x; c.u[5] = b.y; c.u[6] = b.z; c.u[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) c.u[i] = i0 + i < D ? __float_as_uint(row[i0 + i]) : 0u;
  }
}

// the chunks of a row of x and of dy (`xrow`, `grow`) held by thread t of
// its row group; zeros for a row past R
template <typename T, int CPT>
__device__ __forceinline__ void load_row(Raw8<T> (&xr)[CPT], Raw8<T> (&gr)[CPT], const T* xrow,
                                         const T* grow, bool live, int D, int t, int tpr) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i0 = (t + c * tpr) * 8;
    if (live && i0 < D) {
      load_raw(xr[c], xrow, i0, D);
      load_raw(gr[c], grow, i0, D);
    } else {
#pragma unroll
      for (int k = 0; k < static_cast<int>(sizeof(Raw8<T>) / 4); ++k) xr[c].u[k] = gr[c].u[k] = 0u;
    }
  }
}

// The sums of N values over the tpr threads of row group g, in every one
// of them: the xor butterfly inside the warp, then (tpr > 32) the row's
// warps in order through `red`, behind the row's own named barrier (id
// 1 + g, tpr threads). `red` alternates between two buffers, so a sum
// takes one barrier: a thread writes buffer b again only after the next
// sum's barrier, which every thread of the row passes after reading b.
template <int N>
__device__ __forceinline__ void group_sum(float (&v)[N], int tpr, int g, int& buf,
                                          float (*red)[BWD_BLOCK / 32][3]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < tpr)                        // the offsets tpr / 2, ..., 1 below one warp
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  if (tpr <= 32) return;
  const int nw = tpr >> 5, w0 = g * nw;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int j = 0; j < N; ++j) red[buf][threadIdx.x >> 5][j] = v[j];
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(tpr) : "memory");
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = red[buf][w0][j];
#pragma unroll
    for (int i = 1; i < BWD_BLOCK / 32; ++i)
      if (i < nw) s += red[buf][w0 + i][j];
    v[j] = s;
  }
  buf ^= 1;
}

// The block's sums of one parameter gradient into its partial row `dst`:
// each row group writes its sums to its row of `comb` (rpb x Dp floats),
// then every thread adds the groups' sums of its columns in group order
// and writes them. The caller has synchronised the block before.
template <int CPT>
__device__ __forceinline__ void block_partial(const float (&acc)[CPT][8], float* comb, float* dst,
                                              int D, int t, int tpr, int g, int rpb) {
  const int Dp = (D + 7) & ~7;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int i0 = (t + c * tpr) * 8;
    if (i0 < D) store8(comb + static_cast<size_t>(g) * Dp + i0, acc[c]);
  }
  __syncthreads();
  const bool vec = aligned16(dst) && D % 4 == 0;
  for (int d = threadIdx.x * 4; d < D; d += BWD_BLOCK * 4) {
    float4 v = *reinterpret_cast<const float4*>(comb + d);
    for (int j = 1; j < rpb; ++j) {
      const float4 u = *reinterpret_cast<const float4*>(comb + static_cast<size_t>(j) * Dp + d);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    if (vec) {
      *reinterpret_cast<float4*>(dst + d) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int i = 0; i < 4 && d + i < D; ++i) dst[d + i] = e[i];
    }
  }
}

// Registers: LayerNorm's second sums at 4 chunks, and f32's words at 4
// chunks or beside LayerNorm's sums, pass 128: one block an SM there (the
// grid is the same), two elsewhere.
template <typename T, int CPT, bool LAYER>
__global__ void __launch_bounds__(BWD_BLOCK, (LAYER && CPT == 4) ||
                                                     (sizeof(T) == 4 && (LAYER || CPT == 4))
                                                 ? 1
                                                 : BWD_SM_BLOCKS)
row_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ scale, T* __restrict__ dx,
                    float* __restrict__ partial, int R, int D, float eps, int plus_one, int tpr) {
  // rpb x Dp floats (Dp = D rounded up to whole chunks): the scale (1 +
  // scale) in the first Dp while the rows run, then the row groups' sums
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  __shared__ float red[2][BWD_BLOCK / 32][3];
  const int rpb = BWD_BLOCK / tpr;
  const int g = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int slots = gridDim.x * rpb;
  const int Dp = (D + 7) & ~7;
  const float fd = static_cast<float>(D);

  // the first row's loads go out before the scale's, so that they wait
  // together
  int r = blockIdx.x * rpb + g;
  Raw8<T> xr[CPT], gr[CPT];
  load_row(xr, gr, x + static_cast<size_t>(r < R ? r : 0) * D,
           dy + static_cast<size_t>(r < R ? r : 0) * D, r < R, D, t, tpr);
  for (int d0 = threadIdx.x * 8; d0 < Dp; d0 += BWD_BLOCK * 8) {
    float v[8];
    load_chunk(v, scale, d0, D);          // zeros past D
    if (plus_one)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (d0 + i < D) v[i] = 1.f + v[i];
    store8(sh + d0, v);
  }
  float acc_s[CPT][8], acc_b[CPT][8];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_s[c][i] = acc_b[c][i] = 0.f;
  __syncthreads();                        // the scale is in shared memory
  int buf = 0;

  // every slot of the block walks the same number of rows, so each row
  // group of a warp takes every shuffle; rows past R load zeros, add
  // nothing and store nothing
  const int rounds = (R + slots - 1) / slots;
  for (int k = 0; k < rounds; ++k, r += slots) {
    const bool live = r < R;
    if (k > 0) {
      const size_t off = static_cast<size_t>(live ? r : 0) * D;
      load_row(xr, gr, x + off, dy + off, live, D, t, tpr);
    }
    // Each sum: a thread adds each of its chunks in element order (one
    // chain a chunk, so the chains run side by side), then its chunks in
    // order, then the row's threads (group_sum). Elements past D hold
    // zeros in x, dy and the scale, which add nothing: only LayerNorm's
    // centred values mask them.
    float mu = 0.f;
    if (LAYER) {
      float part[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        part[c] = 0.f;
        if ((t + c * tpr) * 8 < D)
#pragma unroll
          for (int i = 0; i < 8; ++i) part[c] += at(xr[c], i);
      }
      float v[1] = {part[0]};
#pragma unroll
      for (int c = 1; c < CPT; ++c) v[0] += part[c];
      group_sum(v, tpr, g, buf, red);
      mu = v[0] / fd;
    }
    // one pass, one sum of the row: sum (x - mu)^2, sum g (x - mu) and
    // (LayerNorm) sum g, g = dy * s; RMSNorm: mu = 0
    constexpr int NS = LAYER ? 3 : 2;
    float m[NS];
    {
      float part[CPT][NS];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int i0 = (t + c * tpr) * 8;
#pragma unroll
        for (int j = 0; j < NS; ++j) part[c][j] = 0.f;
        if (i0 < D) {
          const float4 sa = *reinterpret_cast<const float4*>(sh + i0);
          const float4 sb = *reinterpret_cast<const float4*>(sh + i0 + 4);
          const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float d = LAYER ? (i0 + i < D ? at(xr[c], i) - mu : 0.f) : at(xr[c], i);
            const float gg = at(gr[c], i) * sc[i];
            part[c][0] = fmaf(d, d, part[c][0]);
            part[c][1] = fmaf(gg, d, part[c][1]);
            if (LAYER) part[c][NS - 1] += gg;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        m[j] = part[0][j];
#pragma unroll
        for (int c = 1; c < CPT; ++c) m[j] += part[c][j];
      }
    }
    group_sum(m, tpr, g, buf, red);
    const float inv = rsqrtf(m[0] / fd + eps);
    const float mgx = m[1] * inv / fd;      // mean(g * xhat)
    const float mg = LAYER ? m[NS - 1] / fd : 0.f;
    T* drow = dx + static_cast<size_t>(live ? r : 0) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int i0 = (t + c * tpr) * 8;
      if (i0 >= D) continue;
      const float4 sa = *reinterpret_cast<const float4*>(sh + i0);
      const float4 sb = *reinterpret_cast<const float4*>(sh + i0 + 4);
      const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      float y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xh = (LAYER ? at(xr[c], i) - mu : at(xr[c], i)) * inv;
        const float gy = at(gr[c], i);
        if (live) {
          acc_s[c][i] = fmaf(gy, xh, acc_s[c][i]);
          if (LAYER) acc_b[c][i] += gy;
        }
        y[i] = inv * (gy * sc[i] - mg - xh * mgx);
      }
      if (!live) continue;
      if (i0 + 8 <= D && aligned16(drow + i0)) {
        store8(drow + i0, y);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i0 + i < D) store1(drow + i0 + i, y[i]);
      }
    }
  }
  // the block's partial rows: dscale's rows [0, P), dbias's [P, 2P)
  __syncthreads();                        // every row is done with the scale
  block_partial(acc_s, sh, partial + static_cast<size_t>(blockIdx.x) * D, D, t, tpr, g, rpb);
  if (LAYER) {
    __syncthreads();                      // the dscale sums are read
    block_partial(acc_b, sh, partial + static_cast<size_t>(gridDim.x + blockIdx.x) * D, D, t,
                  tpr, g, rpb);
  }
}

// dscale[d] (blockIdx.y 0) or dbias[d] (1) = the P partials of column d:
// warp w adds slots [w * seg, (w + 1) * seg) in slot order (SUM_BATCH
// loads in flight before their adds), then warp 0 adds the warps' sums in
// warp order
__global__ void __launch_bounds__(SUM_WARPS * 32)
row_norm_param_sum_kernel(const float* __restrict__ partial, int P, int D,
                          float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float red[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const float* src = partial + static_cast<size_t>(blockIdx.y) * P * D;
  const int seg = (P + SUM_WARPS - 1) / SUM_WARPS;
  const int p1 = min(P, (w + 1) * seg);
  float s = 0.f;
  if (d < D) {
    int p = w * seg;
    for (; p + SUM_BATCH <= p1; p += SUM_BATCH) {
      float v[SUM_BATCH];
#pragma unroll
      for (int i = 0; i < SUM_BATCH; ++i) v[i] = src[static_cast<size_t>(p + i) * D + d];
#pragma unroll
      for (int i = 0; i < SUM_BATCH; ++i) s += v[i];
    }
    for (; p < p1; ++p) s += src[static_cast<size_t>(p) * D + d];
  }
  red[w][lane] = s;
  __syncthreads();
  if (w == 0 && d < D) {
    float u = red[0][lane];
    for (int i = 1; i < SUM_WARPS; ++i) u += red[i][lane];
    (blockIdx.y ? dbias : dscale)[d] = u;
  }
}

// the backward's grid: (blocks, threads a row, chunks a thread), from D
// alone but for the blocks (the rows' slots, capped at BWD_MAX_BLOCKS);
// blocks 0 when D is past the backward's limit
__host__ void bwd_layout(int R, int D, int* blocks, int* tpr, int* cpt) {
  const int chunks = (D + 7) / 8;
  int t = 1;
  while (t * BWD_CPT < chunks) t *= 2;
  *tpr = t;
  *cpt = (chunks + t - 1) / t;
  if (t > BWD_BLOCK) {
    *blocks = 0;
    return;
  }
  const int rpb = BWD_BLOCK / t;
  const long long need = (static_cast<long long>(R) + rpb - 1) / rpb;
  *blocks = static_cast<int>(need < BWD_MAX_BLOCKS ? need : BWD_MAX_BLOCKS);
}

template <typename T, int CPT, bool LAYER>
int launch_row_kernel(const T* x, const T* dy, const float* scale, T* dx, float* partial, int R,
                      int D, float eps, int plus_one, int tpr, int blocks, cudaStream_t stream) {
  // rpb x Dp floats: at most 2048 x 4 (32 KB), under the 48 KB default
  const size_t smem = static_cast<size_t>(BWD_BLOCK / tpr) * ((D + 7) & ~7) * sizeof(float);
  row_norm_bwd_kernel<T, CPT, LAYER><<<blocks, BWD_BLOCK, smem, stream>>>(
      x, dy, scale, dx, partial, R, D, eps, plus_one, tpr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPT>
int launch_bwd_cpt(const void* x, const void* dy, const float* scale, int layer, void* dx,
                   float* partial, float* dscale, float* dbias, int R, int D, float eps,
                   int plus_one, int tpr, int blocks, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int rc = layer ? launch_row_kernel<T, CPT, true>(xt, gt, scale, dxt, partial, R, D, eps,
                                                         plus_one, tpr, blocks, stream)
                       : launch_row_kernel<T, CPT, false>(xt, gt, scale, dxt, partial, R, D, eps,
                                                          plus_one, tpr, blocks, stream);
  if (rc != 0) return rc;
  row_norm_param_sum_kernel<<<dim3((D + 31) / 32, layer ? 2 : 1), SUM_WARPS * 32, 0, stream>>>(
      partial, blocks, D, dscale, dbias);
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

// The backward's partial rows for R rows of D: the blocks of its grid
// (dscale's; LayerNorm's dbias takes as many again), 0 when D is past its
// limit of 8192. The wrapper allocates `partial` from it.
extern "C" int row_norm_bwd_slots(int R, int D) {
  if (R <= 0 || D <= 0) return 0;
  int blocks = 0, tpr = 0, cpt = 0;
  bwd_layout(R, D, &blocks, &tpr, &cpt);
  return blocks;
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
