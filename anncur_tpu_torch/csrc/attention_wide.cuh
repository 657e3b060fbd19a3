// The wide route of kernels A (attention.cu) and C, D (attention_bwd.cu):
// head dims above 256, any multiple of 16, with the head dim a runtime loop
// count rather than a template parameter (one instantiation per body, not
// one per width).
//
// The products that contract over the head dim (S = Q K^T, and dP = dO V^T
// in C and D) stream both operands through shared memory in chunks of 64
// columns, so no row is held whole in registers or shared memory. The
// outputs (O in A, dK and dV in C, dQ in D) are split into column slices
// over a grid axis; each slice's block recomputes its scores. Every staged
// tile is 64 rows; rows past the sequence and columns past hd are
// zero-filled, so they add nothing to a product. (C and D run these slice
// bodies only past the limits of their Hopper bodies, which compute the
// scores once: csrc/attention_bwd.cu, namespace wide.)
//
// The bf16 bodies keep the tensor-core fragments of the templated route
// (mma.sync m16n8k16, ldmatrix from rows padded by 16 bytes); the f32
// bodies are CUDA-core FFMA over 64 x 64 shared tiles, each of 128 threads
// owning an 8 x 4 piece: rows 8 * ty .. 8 * ty + 7, columns 4 * tx ..
// 4 * tx + 3 (ty = tid / 16, tx = tid % 16; the 16 lanes of one ty share
// their rows, so a row's reductions are four xor shuffles).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace attn_wide {

constexpr int kThreads = 128;
constexpr int kRows = 64;          // rows of every staged tile (queries or keys)
constexpr int kChunk = 64;         // head-dim columns per contraction chunk
constexpr int kLdB = kChunk + 8;   // bf16 chunk rows, padded by 16 bytes
constexpr int kLdF = kChunk + 1;   // f32 tile rows, padded by one word
constexpr int kSliceF = 64;        // output columns of an f32 block

// bf16: rows [r0, r0 + 64) x columns [c0, c0 + cols) of a head slice (row
// stride rs elements) into shared rows of ld elements by cp.async; rows
// >= n_rows and columns >= hd are zero-filled. The caller commits.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, long long rs,
                                           int r0, int n_rows, int c0, int cols, int hd) {
  const int units = cols / 8;
  for (int u = threadIdx.x; u < kRows * units; u += kThreads) {
    const int r = u / units, c = u % units;
    const int row = r0 + r, col = c0 + 8 * c;
    const bool ok = row < n_rows && col < hd;
    mma_sm90::cp_async_16(mma_sm90::smem_addr(dst + r * ld + 8 * c), ok ? src + row * rs + col : src,
                          ok ? 16 : 0);
  }
}

// f32: rows [r0, r0 + 64) x columns [c0, c0 + 64) into a kLdF-row tile, zero
// past n_rows and hd (hd is a multiple of 16, so a 4-wide unit lies wholly
// inside or outside)
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long rs, int r0,
                                          int n_rows, int c0, int hd) {
  for (int u = threadIdx.x; u < kRows * (kChunk / 4); u += kThreads) {
    const int r = u / (kChunk / 4), c = u % (kChunk / 4);
    const int row = r0 + r, col = c0 + 4 * c;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < n_rows && col < hd) x = *reinterpret_cast<const float4*>(src + row * rs + col);
    float* d = dst + r * kLdF + 4 * c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// acc[i][j] += sum_c a[8ty + i][c] * b[4tx + j][c]
__device__ __forceinline__ void mm_nt(float (&acc)[8][4], const float* a, const float* b, int ty,
                                      int tx) {
#pragma unroll 4
  for (int c = 0; c < kChunk; ++c) {
    float x[8], y[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = a[(8 * ty + i) * kLdF + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(4 * tx + j) * kLdF + c];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k a[8ty + i][k] * b[k][4tx + j]
__device__ __forceinline__ void mm_nn(float (&acc)[8][4], const float* a, const float* b, int ty,
                                      int tx) {
#pragma unroll 4
  for (int k = 0; k < kRows; ++k) {
    float x[8], y[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = a[(8 * ty + i) * kLdF + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[k * kLdF + 4 * tx + j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k a[k][8ty + i] * b[k][4tx + j]
__device__ __forceinline__ void mm_tn(float (&acc)[8][4], const float* a, const float* b, int ty,
                                      int tx) {
#pragma unroll 4
  for (int k = 0; k < kRows; ++k) {
    float x[8], y[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = a[k * kLdF + 8 * ty + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[k * kLdF + 4 * tx + j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// sum (or max) over the 16 lanes that share a ty
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// bf16: acc (this warp's 16 rows of a 16 x 64 product, in C fragments) +=
// a rows [arow, arow + 16) times the 64 rows of b, both chunks of kLdB rows,
// contracted over the chunk's 64 columns: S = Q K^T (a = Q, b = K) or S^T =
// K Q^T (a = K, b = Q). a goes through ldmatrix as the A operand, b as B.
__device__ __forceinline__ void mma_chunk_nt(float (&acc)[8][4], const __nv_bfloat16* a, int arow,
                                             const __nv_bfloat16* b, int lane) {
  using namespace mma_sm90;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_addr(a + (arow + (lane & 15)) * kLdB + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < kRows / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, smem_addr(b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdB + kk * 16 +
                                ((lane >> 3) & 1) * 8));
      mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// bf16: acc (this warp's 16 rows x NC columns) += p (the warp's 16 x 64 f32
// C fragments, rounded to bf16 as the A operand) times x, 64 rows of ld
// elements, NC columns read by ldmatrix.trans: O += P V, dV += P^T dO,
// dK += dS^T Q, dQ += dS K
template <int NC>
__device__ __forceinline__ void mma_rows(float (&acc)[NC / 8][4], const float (&p)[8][4],
                                         const __nv_bfloat16* x, int ld, int lane) {
  using namespace mma_sm90;
#pragma unroll
  for (int ks = 0; ks < kRows / 16; ++ks) {
    const uint32_t pa[4] = {
        pack_bf16x2(p[2 * ks][0], p[2 * ks][1]), pack_bf16x2(p[2 * ks][2], p[2 * ks][3]),
        pack_bf16x2(p[2 * ks + 1][0], p[2 * ks + 1][1]), pack_bf16x2(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NC / 16; ++dp) {
      uint32_t xf[4];
      ldmatrix_x4_trans(xf, smem_addr(x + (ks * 16 + (lane & 15)) * ld + dp * 16 + (lane >> 4) * 8));
      mma_bf16_16816(acc[2 * dp], pa, xf[0], xf[1]);
      mma_bf16_16816(acc[2 * dp + 1], pa, xf[2], xf[3]);
    }
  }
}

// bf16 epilogue: this warp's 16 rows x NC columns of acc (times mul) in bf16
// through its own rows of a shared tile of ld elements, then 16-byte stores
// of rows < n_rows and columns < hd into dst (row stride rs elements)
template <int NC>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* tile, int ld, const float (&acc)[NC / 8][4],
                                                float mul0, float mul1, __nv_bfloat16* dst, long long rs,
                                                int row0, int n_rows, int c0, int hd, int lane) {
  using namespace mma_sm90;
  const int r = lane >> 2, kq = 2 * (lane & 3);
#pragma unroll
  for (int d = 0; d < NC / 8; ++d) {
    *reinterpret_cast<uint32_t*>(tile + r * ld + 8 * d + kq) = pack_bf16x2(acc[d][0] * mul0, acc[d][1] * mul0);
    *reinterpret_cast<uint32_t*>(tile + (r + 8) * ld + 8 * d + kq) =
        pack_bf16x2(acc[d][2] * mul1, acc[d][3] * mul1);
  }
  __syncwarp();
  for (int u = lane; u < 16 * (NC / 8); u += 32) {
    const int rr = u / (NC / 8), c = u % (NC / 8);
    const int row = row0 + rr, col = c0 + 8 * c;
    if (row < n_rows && col < hd)
      *reinterpret_cast<uint4*>(dst + row * rs + col) = *reinterpret_cast<const uint4*>(tile + rr * ld + 8 * c);
  }
}

// the 64 valid-key bits of keys [key0, key0 + 64) (0 past s), one ballot pair per warp
__device__ __forceinline__ uint64_t key_bits(const uint8_t* vrow, int key0, int s, int lane) {
  const int j0 = key0 + lane, j1 = j0 + 32;
  const uint32_t lo = __ballot_sync(0xffffffffu, j0 < s && vrow[j0]);
  const uint32_t hi = __ballot_sync(0xffffffffu, j1 < s && vrow[j1]);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

}  // namespace attn_wide
