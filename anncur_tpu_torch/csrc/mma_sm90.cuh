// Warp-level tensor-core and async-copy helpers for the port's kernels
// (sm_80 instructions that Hopper runs as they are): 16-byte cp.async with
// zero fill and 4-byte cp.async, ldmatrix (plain and transposed) and the
// bf16 m16n8k16 mma.sync with f32 accumulation.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = threadIdx.x % 32,
// r = lane / 4, c = 2 * (lane % 4)):
//   A (16 x 16, row-major), 4 regs of bf16x2: a0 (r, c..c+1), a1 (r+8, c..c+1),
//     a2 (r, c+8..c+9), a3 (r+8, c+8..c+9);
//   B (16 x 8, k x n), 2 regs of bf16x2: b0 (k = c..c+1, n = r), b1 (k = c+8..c+9, n = r);
//   C/D (16 x 8, f32), 4 regs: d0, d1 (r, c..c+1), d2, d3 (r+8, c..c+1).
// So the C layout of two neighbouring n-tiles, rounded to bf16 pairs, is the
// A layout of a product over those 16 columns: a score tile feeds the next
// product from registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes 16 zero bytes
// and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared (through L1: the 4-byte form has no .cg)
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// register i receives matrix i in the C layout above (row r, columns c..c+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each matrix transposed: register i holds (rows c..c+1, column r)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a * b on the tensor cores: bf16 inputs, f32 accumulation
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace mma_sm90
