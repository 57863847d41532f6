// Bit-true DBMU + CSD adder tree simulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `dbmu_matmul` (src/repro/kernels/dbmu_sim.py,
// `_kernel` and its `pl.pallas_call`). Same function, the DB-PIM macro's
// datapath: inputs stream in bit-serially as sign-magnitude planes; each
// stored Comp pattern (one 6T cell: sign s, position p = 2 * blk + hi) ANDs
// the input bit, and the CSD adder tree recombines the partials as
//
//   y[m, n] = sum_k sum_{bit < 8} sum_{t < 2}
//               sign(x[m, k]) * bit_b(|x[m, k]|) * valid_t * s_t * 2^(p_t) << bit
//
// x (M, K) int32 in int8 range (|x| <= 128, so eight planes cover it);
// packed (K, N, 2) uint8 term bytes (bit0 sign, bit1 hi/lo, bits 2-3 block,
// bit4 valid; repro_torch.core.dyadic.pack_terms); y (M, N) int32, which
// must equal the integer matmul x @ unpack_terms(packed) exactly.
//
// Design. Pure integer arithmetic, so the result is exact by construction
// (the TPU kernel runs f32 dots of +-2^p values, exact only while the sums
// stay below 2^24; nothing here rounds). |y| <= 128 * 192 * K fits int32
// for K <= 87,000, the most the entry point takes. One thread block per
// (row tile of BM rows, CW output columns); the K loop stages the inputs'
// signs and magnitudes and the
// decoded term values (valid * sign * 2^p) in shared memory, chunk by
// chunk, and each thread accumulates its outputs plane by plane, term by
// term, in int32 registers. Ragged M, K and N are masked here.
//
// Bound. Simulating the datapath costs 8 planes x 2 terms of integer work
// per multiply-accumulate, on the CUDA cores: it is compute-bound, far
// above both the bytes it moves and an int8 tensor-core product of the
// same matmul. It is an oracle of the hardware, not a fast matmul.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;                    // rows per block
constexpr int CW = 32;                    // output columns per block (= lanes)
constexpr int WARPS = 4;                  // block = (CW, WARPS) threads
constexpr int ROWS_PER_THREAD = BM / WARPS;
constexpr int KC = 64;                    // K chunk staged per iteration
constexpr int INPUT_BITS = 8;
constexpr int MAX_TERMS = 2;
constexpr int MAX_K = 87000;              // 128 * 192 * K stays below 2^31

__device__ __forceinline__ int term_value(uint8_t w) {
  const int valid = (w >> 4) & 1;
  const int sign = 1 - 2 * (w & 1);
  const int pos = ((w >> 1) & 1) + 2 * ((w >> 2) & 3);   // 2 * blk + hi/lo
  return valid * sign * (1 << pos);
}

__global__ void __launch_bounds__(CW * WARPS)
dbmu_matmul_kernel(const int32_t* __restrict__ x, const uint8_t* __restrict__ packed,
                   int32_t* __restrict__ y, int M, int K, int N) {
  __shared__ int sx[BM][KC];              // input signs (+1 / -1), 4 KB
  __shared__ int mag[BM][KC];             // input magnitudes, 4 KB
  __shared__ int wt[MAX_TERMS][KC][CW];   // decoded term values, 16 KB

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * CW + lane;
  const int nthreads = CW * WARPS;
  const int m0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * CW;
  const int col = c0 + lane;

  int acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int e = tid; e < BM * KC; e += nthreads) {
      const int r = e / KC, k = e - r * KC;
      const int m = m0 + r;
      const int v = (m < M && k < kc) ? x[static_cast<size_t>(m) * K + k0 + k] : 0;
      sx[r][k] = v < 0 ? -1 : 1;
      mag[r][k] = v < 0 ? -v : v;
    }
    for (int e = tid; e < KC * CW; e += nthreads) {
      const int k = e / CW, c = e - k * CW;
      const bool in = k < kc && c0 + c < N;
      const size_t base = (static_cast<size_t>(k0 + k) * N + c0 + c) * MAX_TERMS;
#pragma unroll
      for (int t = 0; t < MAX_TERMS; ++t) wt[t][k][c] = in ? term_value(packed[base + t]) : 0;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
#pragma unroll
      for (int t = 0; t < MAX_TERMS; ++t) {
        const int w = wt[t][k][lane];
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) {
          const int r = warp + i * WARPS;
          const int s = sx[r][k], a = mag[r][k];
#pragma unroll
          for (int bit = 0; bit < INPUT_BITS; ++bit)
            acc[i] += ((a >> bit) & 1) * s * w * (1 << bit);   // 1b x term, shifted
        }
      }
    }
    __syncthreads();
  }

  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + warp + i * WARPS;
    if (m < M) y[static_cast<size_t>(m) * N + col] = acc[i];
  }
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes the kernel does not
// take).
extern "C" int dbmu_matmul_launch(const void* x, const void* packed, void* y, int M, int K,
                                  int N, void* stream) {
  if (M <= 0 || K <= 0 || K > MAX_K || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM, (N + CW - 1) / CW);
  const dim3 block(CW, WARPS);
  dbmu_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<int32_t*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
