// Row-stable masked GQA attention for Hopper (sm_90a): the serving path's
// attention against a contiguous KV cache, one query at a time.
//
// Replaces no TPU kernel: the reference computes this with plain jnp
// einsums (`_sdpa`, src/repro/models/attention.py). The port runs it in a
// kernel of its own so that a 1-token decode and a C-token prefill chunk
// give every query bitwise the same output: a batched matmul and torch's
// softmax pick their summation order from the whole shape, so the two
// paths would part in the last bits. Same function as the reference:
//
//   l[j]   = cast_T( sum_d q[d] * k[j, d] ) * scale      (fp32 sum)
//   l[j]   = -1e30 where j > qpos                        (causal mask)
//   p[j]   = cast_T( softmax(l)[j] )                     (fp32 softmax)
//   out[d] = cast_T( sum_j p[j] * v[j, d] )              (fp32 sum)
//
// q (B, Sq, Hq, hd), contiguous; k, v (B, A, Hkv, hd), each batch row
// contiguous (any batch stride); qpos (B, Sq) int32, the query's position
// in the cache; out (B, Sq, Hq, hd) in q's dtype. Query head h reads KV
// head h / (Hq / Hkv), as the reference's repeat of the KV heads does.
//
// Design. One thread block of four warps per (query head, query, batch
// row); its logits live in shared memory (A floats). Keys past qpos are
// masked in the reference, where they add exp(-1e30 - max) = 0 to the
// softmax and 0 * v to the output; here they are skipped. Warp w takes keys
// w, w + 4, ... in order; lane l holds head dims l, l + 32, ... (coalesced
// loads of each K and V row). A logit is lane l's in-order partial dot,
// then an xor butterfly over the lanes; the softmax sum runs over keys
// tid, tid + 128, ... per thread, then a fixed tree; the output is each
// warp's in-order sum over its keys, the four warps added in order. Every
// order is fixed by the number of live keys and hd alone, so a query's
// output does not depend on Sq, on B or on the other queries.
//
// Bound. Each query head reads the live K/V rows of its KV head (the other
// heads of the group hit L2) and does 4 * hd flops per live key; at the
// serving shapes it is latency-bound. A simple first kernel: CUDA-core fp32
// FMAs, no tensor cores, no sharing of K/V tiles across the heads of a group.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;                   // threads per block
constexpr int WARPS = NT / 32;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;   // per block, without opting in

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// rounds to T and back: the reference's einsum and softmax outputs in T
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide reduction of one value per thread in a fixed order: xor
// butterflies inside each warp (every lane ends with the same value), then
// the warps' results in order.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = IS_MAX ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = IS_MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// NDL: head dims per lane, a power of two with 32 * NDL >= hd
template <typename T, int NDL>
__global__ void __launch_bounds__(NT)
row_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int32_t* __restrict__ qpos,
                     T* __restrict__ out, int Sq, int Hq, int Hkv, int A, int hd,
                     long long k_bstride, long long v_bstride, float scale) {
  extern __shared__ float smem[];
  __shared__ float red[WARPS];
  float* p = smem;                        // A: logits, then probabilities
  float* part = p + A;                    // WARPS * hd partial output sums

  const int h = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = h / (Hq / Hkv);
  const int pos = qpos[b * Sq + s];
  // keys 0..n-1 are live; a negative position masks every key, and the
  // reference then spreads its softmax evenly over all A of them
  const bool none = pos < 0;
  const int n = none ? A : min(pos, A - 1) + 1;

  const T* qrow = q + ((static_cast<size_t>(b) * Sq + s) * Hq + h) * hd;
  float qv[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < hd ? to_f32(qrow[d]) : 0.f;
  }

  const T* kb = k + b * k_bstride + static_cast<size_t>(hk) * hd;
  const size_t krow = static_cast<size_t>(Hkv) * hd;
  float m = -FLT_MAX;
#pragma unroll 4
  for (int j = warp; j < n; j += WARPS) {
    const T* kr = kb + j * krow;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc = fmaf(qv[i], to_f32(kr[d]), acc);
    }
    acc = warp_sum(acc);
    const float l = none ? -1e30f : round_to<T>(acc) * scale;
    if (lane == 0) p[j] = l;
    m = fmaxf(m, l);
  }
  m = block_reduce<true>(m, red);

  float sum = 0.f;
  for (int j = tid; j < n; j += NT) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int j = tid; j < n; j += NT) p[j] = round_to<T>(p[j] / sum);
  __syncthreads();

  const T* vb = v + b * v_bstride + static_cast<size_t>(hk) * hd;
  float acc[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int j = warp; j < n; j += WARPS) {
    const float pj = p[j];
    const T* vr = vb + j * krow;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) acc[i] = fmaf(pj, to_f32(vr[d]), acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) part[warp * hd + d] = acc[i];
  }
  __syncthreads();
  T* orow = out + ((static_cast<size_t>(b) * Sq + s) * Hq + h) * hd;
  for (int d = tid; d < hd; d += NT) {
    float o = part[d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) o += part[w * hd + d];
    store(&orow[d], o);
  }
}

template <typename T, int NDL>
int launch_ndl(const void* q, const void* k, const void* v, const void* qpos, void* out, int B,
               int Sq, int Hq, int Hkv, int A, int hd, long long k_bstride,
               long long v_bstride, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(A) + static_cast<size_t>(WARPS) * hd);
  if (smem + sizeof(float) * WARPS > DEFAULT_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_attention_kernel<T, NDL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hq, Sq, B);
  row_attention_kernel<T, NDL><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(qpos), static_cast<T*>(out), Sq, Hq, Hkv, A, hd, k_bstride,
      v_bstride, scale);
  return static_cast<int>(cudaGetLastError());
}

// the kernel variant is chosen by hd alone, so decode and chunk calls of
// one model run the same arithmetic
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* qpos, void* out, int B,
           int Sq, int Hq, int Hkv, int A, int hd, long long k_bstride, long long v_bstride,
           float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch_ndl<T, 1>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, k_bstride, v_bstride,
                            scale, stream);
  if (hd <= 64)
    return launch_ndl<T, 2>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, k_bstride, v_bstride,
                            scale, stream);
  if (hd <= 128)
    return launch_ndl<T, 4>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, k_bstride, v_bstride,
                            scale, stream);
  return launch_ndl<T, 8>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, k_bstride, v_bstride,
                          scale, stream);
}

}  // namespace

// C entry point, loaded with ctypes. q, k, v and out share `dtype`.
// Launches on `stream` and returns a CUDA error code, 0 on success
// (cudaErrorInvalidValue for shapes or dtypes the kernel does not take).
extern "C" int row_attention_launch(const void* q, const void* k, const void* v, const void* qpos,
                                    void* out, int B, int Sq, int Hq, int Hkv, int A, int hd,
                                    long long k_bstride, long long v_bstride, float scale,
                                    int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || A <= 0 || hd <= 0 ||
      hd > 256 || Sq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch<float>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, k_bstride, v_bstride, scale,
                         s);
  if (dtype == BF16)
    return launch<__nv_bfloat16>(q, k, v, qpos, out, B, Sq, Hq, Hkv, A, hd, k_bstride, v_bstride,
                                 scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
