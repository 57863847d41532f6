// Shared pieces of the port's tensor-core matmuls for Hopper (sm_90a):
// `dbmu_matmul.cu` (int8 x int8 -> int32), `fta_int8_matmul.cu` and the
// gathered-K kernel of `gather_matmul.cuh` (bf16 x bf16 -> fp32): warpgroup
// MMA (`wgmma`) with its shared-memory operand layouts and descriptors, an
// int8 weight widened to bf16 in registers, TMA tensor copies with
// mbarriers, `cp.async` tile copies for arrays TMA cannot take, and split K
// over a thread-block cluster with a fixed-order combine.
//
// Ragged edges. TMA fills a box's part outside the array with zeros. The
// cp.async loader copies a 16-byte chunk that lies wholly inside a
// 16-byte-aligned array with one cp.async; a chunk that straddles the
// array's edge, or any chunk of an array whose rows are not 16-byte
// aligned, element by element with zeros outside; a chunk wholly outside
// it is zero-filled. Zeros add nothing to an integer sum and +0 to a float
// sum, so the masked tail leaves every output as it was.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices, transposed; lane l gives the address of row l % 8
// of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// ---- wgmma (sm_90a) -------------------------------------------------------
//
// Operand tiles live in shared memory in the K-major "interleave" layout (no
// swizzle): core matrices of 8 rows x 16 bytes, 128 contiguous bytes each;
// the core matrix of row group i and 16-byte K chunk j sits at
// j * LBO + i * SBO. Here every tile is stored K chunk by K chunk: SBO = 128
// bytes, LBO = (rows / 8) * 128 bytes, so byte (r, c) of a tile of R rows
// is at (c / 16) * R * 16 + r * 16 + c % 16.
__device__ __forceinline__ int core_offset(int rows, int r, int c) {
  return (c >> 4) * rows * 16 + r * 16 + (c & 15);
}

// The shared-memory matrix descriptor: start address, LBO and SBO in
// 16-byte units, layout type 0 (interleave).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lbo_bytes, int sbo_bytes) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread (st.shared, cp.async) become visible
// to the tensor cores' reads (the async proxy) once a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins accumulator registers in place around asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 fp32, 32 per thread) += A (64 x 16 bf16, registers: four
// .b32 per thread, the mma.m16n8k16 A fragment of each warp's 16 rows) *
// B (16 x 64 bf16, K-major in shared memory).
__device__ __forceinline__ void wgmma_bf16_n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d (64 x 64 int32, 32 per thread) += A (64 x 32 s8, registers: four .b32
// per thread, the mma.m16n8k32 A fragment of each warp's 16 rows) * B (32 x
// 64 s8, K-major in shared memory); the int32 sums wrap like the integers
// they hold.
__device__ __forceinline__ void wgmma_s8_n64_rs(int32_t (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// ---- TMA (sm_90) -----------------------------------------------------------
//
// A 2D tensor map describes a row-major global array; one thread asks the
// copy engine for a whole box of it, which lands in shared memory (swizzled
// as the map says, zeros outside the array) and completes a transaction
// count on an mbarrier. cuTensorMapEncodeTiled comes from the driver through
// the runtime, so nothing links against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

__host__ inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (rows x cols) row-major array of `elem`-byte elements, read
// in boxes of (box_rows x box_cols). False when TMA cannot take the array
// (base or row stride not a multiple of 16 bytes).
__host__ inline bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                                int elem, int rows, int cols, int box_rows, int box_cols,
                                CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  const size_t stride = static_cast<size_t>(cols) * elem;
  if (!encode || reinterpret_cast<uintptr_t>(base) % 16 || stride % 16) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of an array of `rank` dims (dims[0] innermost; strides[i] the
// bytes between neighbours along dim i + 1), read in boxes of box[]. False
// when TMA cannot take the array (base or a stride not a multiple of 16
// bytes). A box may reach past the array's edge; TMA fills that part with
// zeros.
__host__ inline bool tensor_map_nd(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                                   int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                                   const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || reinterpret_cast<uintptr_t>(base) % 16) return false;
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16) return false;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// box at (row, col) of `map` -> dst; completes bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int row, int col,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// box at coordinates (c0 innermost, c1, c2) of a 3D map -> dst
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// box at coordinates (c0 innermost, c1, c2, c3) of a 4D map -> dst
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// Barrier `id` (1..15) over the first `threads` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The descriptor of a K-major operand tile stored with the 128-byte swizzle
// (rows of 128 bytes, 1024-byte aligned groups of 8 rows), as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes it; K steps advance the start address.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Byte I of u (= int8 v ^ 0x80, i.e. v + 128) as the f32 2^23 + v + 128;
// minus 2^23 + 128 it is v exactly, and v's f32 bits >> 16 are its bf16
// bits exactly (|v| <= 128 has at most 8 significant bits). Full-rate
// integer and fp32 operations only, no conversion instructions.
template <int I>
__device__ __forceinline__ uint32_t s8_f32_bits(uint32_t u) {
  const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + I));
  return __float_as_uint(__fsub_rn(f, 8388736.0f));
}

// The bf16 A fragments (four K steps) of a 64-deep int8 weight tile whose
// rows (K) are W_LD bytes apart, widened in registers. ldmatrix .trans of
// the int8 tile (as b16 pairs of columns) gives lane (g, t4) the bytes
// w[2 t4][2 g], w[2 t4][2 g + 1], w[2 t4 + 1][2 g], w[2 t4 + 1][2 g + 1] of
// an 8 x 16 block; fragment row g takes column 2 g, row g + 8 column 2 g + 1.
// So A row r of warp w is weight column 16 w + (r < 8 ? 2 r : 2 (r - 8) + 1).
template <int W_LD>
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[4][4], const uint8_t* w_tile, int lane,
                                          int warp) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {         // two K steps per ldmatrix.x4
    uint32_t q[4];
    ldmatrix_x4_trans(q, w_tile + (32 * h + lane) * W_LD + 16 * warp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {       // matrix i: K rows 32 h + 8 i .. + 7
      const uint32_t u = q[i] ^ 0x80808080u;
      const uint32_t f0 = s8_f32_bits<0>(u), f1 = s8_f32_bits<1>(u);
      const uint32_t f2 = s8_f32_bits<2>(u), f3 = s8_f32_bits<3>(u);
      uint32_t(&frag)[4] = a[2 * h + i / 2];
      frag[2 * (i & 1)] = __byte_perm(f0, f2, 0x7632);       // row g: column 2 g
      frag[2 * (i & 1) + 1] = __byte_perm(f1, f3, 0x7632);   // row g + 8: column 2 g + 1
    }
  }
}

// two outputs of one row at columns n, n + 1; one store when `pair` (the
// pair 8-byte (f32) or 4-byte (bf16) aligned)
__device__ __forceinline__ void store2(float* y, size_t at, bool pair, bool second, float v0,
                                       float v1) {
  if (pair) {
    *reinterpret_cast<float2*>(y + at) = make_float2(v0, v1);
  } else {
    y[at] = v0;
    if (second) y[at + 1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* y, size_t at, bool pair, bool second,
                                       float v0, float v1) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(v0, v1);
  } else {
    y[at] = __float2bfloat16_rn(v0);
    if (second) y[at + 1] = __float2bfloat16_rn(v1);
  }
}

// A contiguous row-major global array seen as bytes: `rows` rows of
// `row_bytes` bytes; `vec` when the base and the rows are 16-byte aligned,
// so whole in-bounds chunks may go through cp.async.
struct GTile {
  const uint8_t* base;
  int rows;
  size_t row_bytes;
  bool vec;
};

__host__ __forceinline__ GTile make_gtile(const void* base, int rows, size_t row_bytes) {
  const bool vec = (reinterpret_cast<uintptr_t>(base) % 16 == 0) && (row_bytes % 16 == 0);
  return GTile{static_cast<const uint8_t*>(base), rows, row_bytes, vec};
}

// Lets KERNEL take `bytes` of dynamic shared memory (above the 48 KB
// default) on the current device; set once per device and kernel (the
// kernel itself is the template argument, so two kernels of one signature
// keep two flags).
template <auto KERNEL>
__host__ cudaError_t allow_smem(int bytes) {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

// Split K. At M = 256 a projection with few output columns gives few
// blocks, each with a K loop of a few dozen tiles, and leaves most SMs
// idle. Its K tiles are then split among the `splits` blocks of a
// thread-block cluster (grid z): the block of rank r takes tiles
// [KT * r / splits, KT * (r + 1) / splits). The split count is a function
// of K and N alone (enough column tiles x splits for `min_blocks` blocks per
// row tile, MIN_BLOCKS for 64-row tiles, at least MIN_TILES_PER_SPLIT K
// tiles per block, at most MAX_SPLITS), so the order in which an output's
// sum is taken never depends on M.
constexpr int MAX_SPLITS = 4;
constexpr int MIN_TILES_PER_SPLIT = 8;
constexpr int MIN_BLOCKS = 32;

__host__ __forceinline__ int k_splits(int k_tiles, int col_tiles, int min_blocks = MIN_BLOCKS) {
  int s = (min_blocks + col_tiles - 1) / col_tiles;
  if (s > MAX_SPLITS) s = MAX_SPLITS;
  if (s > k_tiles / MIN_TILES_PER_SPLIT) s = k_tiles / MIN_TILES_PER_SPLIT;
  return s < 1 ? 1 : s;
}

// Launch `kernel` on a (grid.x, grid.y, splits) grid in clusters of
// (1, 1, splits) blocks (no cluster attribute for one split: a block is its
// own cluster of one either way).
template <typename... Params, typename... Args>
__host__ cudaError_t launch_split(void (*kernel)(Params...), dim3 grid, int splits, int threads,
                                  int smem_bytes, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.x, grid.y, splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = splits;
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// The cross-split sum of entry i: each block of the cluster has parked its
// partial sums in its shared memory `park` ([entries][NTHREADS]); the
// partials of the splits are added in rank order 0, 1, ..., read through
// distributed shared memory.
template <typename T, int NTHREADS>
__device__ __forceinline__ T split_sum(T* park, int i, int tid, int splits) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  T* p = park + i * NTHREADS + tid;
  T s = *cluster.map_shared_rank(p, 0);
  for (int q = 1; q < splits; ++q) s += *cluster.map_shared_rank(p, q);
  return s;
}

__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

// Copy the (ROWS x COL_BYTES) window at (r0, c0 bytes) of `g` into shared
// memory `dst` (row stride `DST_LD` bytes), zeros outside the array. ELEM
// is the element size: a straddling chunk is copied element by element.
// A window wholly inside a 16-byte-aligned array (every window of the
// main path's shapes) takes the fast path: one cp.async per chunk.
// DST_LD == 0 stores the window in the core-matrix layout (core_offset).
template <int ROWS, int COL_BYTES, int DST_LD, int ELEM, int NTHREADS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const GTile& g, int r0, size_t c0,
                                          int tid) {
  constexpr int CHUNKS = COL_BYTES / 16;
  static_assert(COL_BYTES % 16 == 0 && DST_LD % 16 == 0, "16-byte chunks");
  static_assert((ROWS * CHUNKS) % NTHREADS == 0, "whole chunks per thread");
  auto at = [&](int r, int c) {
    return dst + (DST_LD ? r * DST_LD + c : core_offset(ROWS, r, c));
  };
  if (g.vec && r0 + ROWS <= g.rows && c0 + COL_BYTES <= g.row_bytes) {
    const uint8_t* src = g.base + static_cast<size_t>(r0) * g.row_bytes + c0;
#pragma unroll
    for (int i = 0; i < ROWS * CHUNKS / NTHREADS; ++i) {
      const int e = tid + i * NTHREADS;
      // row-major: a thread per 16-byte chunk along the row; core layout:
      // two threads per row (one 32-byte sector), rows fastest, so that
      // neighbouring threads write neighbouring 16-byte rows of a core matrix
      int r, c;
      if constexpr (DST_LD || CHUNKS % 2) {
        r = e / CHUNKS;
        c = (e % CHUNKS) * 16;
      } else {
        r = (e >> 1) % ROWS;
        c = (((e >> 1) / ROWS) * 2 + (e & 1)) * 16;
      }
      cp_async16(at(r, c), src + static_cast<size_t>(r) * g.row_bytes + c);
    }
    return;
  }
#pragma unroll 1
  for (int e = tid; e < ROWS * CHUNKS; e += NTHREADS) {
    const int r = e / CHUNKS, c = (e - r * CHUNKS) * 16;
    uint8_t* d = at(r, c);
    const int gr = r0 + r;
    const size_t gc = c0 + c;
    if (gr >= g.rows || gc >= g.row_bytes) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint8_t* s = g.base + static_cast<size_t>(gr) * g.row_bytes + gc;
    if (g.vec && gc + 16 <= g.row_bytes) {
      cp_async16(d, s);
      continue;
    }
#pragma unroll
    for (int b = 0; b < 16; b += ELEM) {
      if (gc + b < g.row_bytes) {
        if (ELEM == 4)
          *reinterpret_cast<uint32_t*>(d + b) = *reinterpret_cast<const uint32_t*>(s + b);
        else if (ELEM == 2)
          *reinterpret_cast<uint16_t*>(d + b) = *reinterpret_cast<const uint16_t*>(s + b);
        else
          d[b] = s[b];
      } else {
        for (int z = 0; z < ELEM; ++z) d[b + z] = 0;
      }
    }
  }
}

}  // namespace tc
