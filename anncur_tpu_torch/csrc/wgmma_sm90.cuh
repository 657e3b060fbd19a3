// Hopper (sm_90a) warpgroup helpers for the port's kernels: wgmma
// m64n64k16 (bf16 in, f32 accumulate) with both operands in shared memory
// or A in registers, wgmma m64n128k8 and m64n64k8 (tf32 in, f32
// accumulate) with A in registers, shared-memory matrix descriptors for
// 128-byte-swizzled tiles, mbarriers, and 2-D and 4-D TMA tile loads with
// their tensor maps.
//
// Layouts (one warpgroup = warps 4i..4i+3, w = warp % 4, lane = threadIdx.x
// % 32, r = lane / 4, c = 2 * (lane % 4)):
//   accumulator of m64n64 (32 f32 a thread): d[4j + e] holds row 16w + r +
//     8 * (e >> 1), column 8j + c + (e & 1), j = 0..7;
//   A from registers for m64k16 (4 regs of bf16x2): a0 (16w + r, c..c+1),
//     a1 (16w + r + 8, c..c+1), a2 (16w + r, c+8..c+9), a3 (16w + r + 8,
//     c+8..c+9).
// So columns 16kk..16kk+15 of an accumulator, rounded to bf16 pairs
// (d[8kk..8kk+7] in order), are the A operand of the k-step over those 16
// columns: P^T and dS^T (kernel C), dS (kernel D) and P (kernel A) feed
// the next product from registers.
//   accumulator of m64n128: the same with j = 0..15 (64 f32 a thread);
//   A from registers for tf32 m64k8 (4 regs of tf32, t = lane % 4): a0
//     (16w + r, t), a1 (16w + r + 8, t), a2 (16w + r, t + 4), a3 (16w + r
//     + 8, t + 4).
//
// A tile is 64 rows of 64 bf16 (128 bytes), as TMA writes it with the
// 128-byte swizzle: the 16-byte unit u of row i sits at unit u ^ (i % 8),
// and the tile starts on a 1024-byte boundary (8 rows, one swizzle atom).
// As a K-major operand (rows are M or N, the 64 columns the reduced axis)
// a k-step of 16 columns starts 32 bytes on; as an MN-major B operand
// (rows are the reduced axis, columns N) a k-step of 16 rows starts 2048
// bytes on. Both strides between 8-row groups are 1024 bytes. A tf32 tile
// has the same bytes: rows of 32 f32, a K-major k-step of 8 columns 32
// bytes on (tf32 takes K-major operands only).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// descriptor of a 128-byte-swizzled tile at shared address addr: leading
// byte offset 16 (unused by these layouts), 1024 bytes between 8-row groups
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// before the first product that reads registers written since the last one
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers an asynchronous product still reads or writes: kept in place
// across the wait (the compiler must not move or reuse them before it)
__device__ __forceinline__ void keep(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WGMMA_D32                                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_D32_OPS(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),     \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),        \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),      \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),      \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64) = A (64 x 16, K-major in shared memory) * B (16 x 64, K-major
// in shared memory) + (accumulate ? d : 0), both by descriptor; d's
// registers need no value when accumulate is 0
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) = A (64 x 16, this thread's bf16 fragment) * B (16 x 64,
// MN-major in shared memory: rows of B are the 16 reduced rows) + d (+ 0
// where accumulate is 0)
__device__ __forceinline__ void mma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64) = A (64 x 8 tf32, this thread's fragment) * B (8 x 64, K-major
// tf32 in shared memory) + (accumulate ? d : 0)
__device__ __forceinline__ void mma_tf32_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WGMMA_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WGMMA_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef WGMMA_D32
#undef WGMMA_D32_OPS

#define WGMMA_D64                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "  \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
  "%62, %63}"
#define WGMMA_D64_OPS(d)                                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),  \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), \
      "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128) = A (64 x 8 tf32, this thread's fragment) * B (8 x 128,
// K-major tf32 in shared memory, by descriptor) + (accumulate ? d : 0)
__device__ __forceinline__ void mma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WGMMA_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WGMMA_D64_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef WGMMA_D64
#undef WGMMA_D64_OPS

__device__ __forceinline__ void keep(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x rounded to tf32, to nearest with ties away from zero: the f32 bits with
// the low 13 zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The small part of an f32 operand read from shared memory in three TF32
// passes. The raw f32 serves as its big part: TF32 wgmma reads the top 19
// bits of each f32 and drops the low 13 (tests/test_torch_cuda.py,
// test_tf32_wgmma_fragments_and_the_low_13_bits, holds the card to it), so
// big = x with its low 13 bits cleared, and x - big is exact in f32 before
// it is rounded to tf32.
__device__ __forceinline__ float tf32_small(float x) {
  return __uint_as_float(tf32_rna(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u)));
}

// this thread's generic-proxy writes to shared memory, ordered before later
// async-proxy accesses (wgmma operand reads, TMA writes) of the block
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// after every mbar_init of the block, before any use (TMA included)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Where a call takes `issue`, only the threads that pass true act: the
// predicate goes into the instruction, so a warpgroup running wgmma takes
// no divergent branch around it (ptxas would serialize its products).

// an arrival, and bytes that TMA will complete on the barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes, bool issue) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 state;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(issue))
      : "memory");
}

// an arrival without bytes (release: this thread's prior writes are seen by
// the threads that wait on the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool issue) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 state;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.release.cta.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<int>(issue))
      : "memory");
}

// until the phase of the given parity has completed (a fresh barrier
// counts its phase of parity 1 as completed); the spin stays inside the
// asm block, whose labels are local to it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------ TMA

// a tile of a 4-D tensor map at coordinates c0..c3 (innermost first) into
// shared memory; its bytes complete on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3, bool issue) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
      "%4, %5}], [%6];\n}\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar)), "r"(static_cast<int>(issue))
      : "memory");
}

// a tile of a 2-D tensor map at coordinates c0 (column), c1 (row) into
// shared memory; its bytes complete on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            bool issue) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n}\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(bar)), "r"(static_cast<int>(issue))
      : "memory");
}

// A (b, rows, nh, cols) bf16 tensor with element strides sb, sr, sh (the
// cols columns contiguous; 64 unless given) as a 4-D tensor map of 64-row x
// 64-column boxes with the 128-byte swizzle; rows past n_rows and columns
// past cols read as zeros. With f32, an f32 tensor in boxes of 64 rows x 32
// columns (128 bytes a row, as well). The three outer
// axes go in order of stride, so any strides TMA takes are taken; `order`
// records where each went: its coordinate slot (1-3) for the head at bits
// 0-1, the row at bits 2-3, the batch at bits 4-5 (tile_coords).
struct RowMap {
  CUtensorMap map;
  int order;
};

__device__ __forceinline__ void tile_coords(int order, int h, int row, int b, int (&c)[4], int col = 0) {
  const int ph = order & 3, pr = (order >> 2) & 3;
  c[0] = col;
#pragma unroll
  for (int i = 1; i < 4; ++i) c[i] = ph == i ? h : (pr == i ? row : b);
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; it is reached through the
// runtime's entry-point lookup, so the libraries link against the runtime
// alone
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

inline cudaError_t make_row_map(RowMap* out, const void* base, int b, int n_rows, int nh, long long sb, long long sr,
                                long long sh, int cols = 64, bool f32 = false) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // (stride, size, box, kind 0 head / 1 row / 2 batch), sorted by stride
  long long axes[3][4] = {{sh, nh, 1, 0}, {sr, n_rows, 64, 1}, {sb, b, 1, 2}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && axes[j][0] < axes[j - 1][0]; --j)
      for (int f = 0; f < 4; ++f) {
        const long long t = axes[j][f];
        axes[j][f] = axes[j - 1][f];
        axes[j - 1][f] = t;
      }
  const size_t es = f32 ? sizeof(float) : sizeof(__nv_bfloat16);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / es), 0, 0, 0};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  out->order = 0;
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(axes[i][1]);
    strides[i] = static_cast<cuuint64_t>(axes[i][0]) * es;
    box[i + 1] = static_cast<cuuint32_t>(axes[i][2]);
    out->order |= (i + 1) << (2 * axes[i][3]);
  }
  const CUresult rc = encode(&out->map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                             const_cast<void*>(base), dims, strides,
                             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major (rows, cols) f32 matrix (cols % 4 == 0, base on 16 bytes) as
// a 2-D tensor map of box_rows x 32-column boxes (128 bytes a row) with the
// 128-byte swizzle; entries past either edge read as zeros.
inline cudaError_t make_f32_matrix_map(CUtensorMap* out, const void* base, int rows, int cols, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box,
                             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wgmma_sm90
