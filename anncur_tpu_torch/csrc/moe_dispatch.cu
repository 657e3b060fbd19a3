// The expert layer's two memory-bound passes, for Hopper (sm_90a):
// moe_permute puts each token's row into the rows of its experts, in the
// expert-sorted order the expert GEMMs read; moe_combine sums each token's
// expert rows with its routing weights and adds the shared experts' output
// and the residual.
//
// Replace no TPU kernel: the JAX package has no expert layer. They are the
// dispatch and combine around the grouped GEMMs of ops/moe.py (plain
// versions beside them there), added with DeepSeek-V2-Lite.
//
// Bound on the H100: both move bytes and compute next to nothing. At the
// build cell's forward (131,072 tokens, top 6 of 64 experts, hidden 2,048,
// bf16) moe_permute must read the tokens' rows once (0.54 GB) and write
// 786,432 rows (3.22 GB): 1.12 ms at 3.35 TB/s. moe_combine must read
// those rows back (3.22 GB), the shared experts' output and the residual
// (1.07 GB) and write the result (0.54 GB): 1.44 ms.
//
// Design: one block of 256 threads a token, 16 bytes (8 bf16) a thread
// across the row. moe_permute reads a token's row once and writes it to
// each of its k destinations: gathering rows in destination order instead
// would read every token's row k times, and at 0.54 GB the tokens do not
// stay in the 50 MB L2 between the k reads. moe_combine reads a token's k
// rows (each row of the sorted layout belongs to one token, so each is read
// once), sums them in f32 in slot order, multiply and add rounded apart
// (__fmul_rn, __fadd_rn: no FMA contraction), so the same inputs give the
// same bits on every run and the plain version's: no atomics. Then it
// rounds as PyTorch's bf16 ops round: the routed sum to bf16, plus the
// shared output rounded to bf16, plus the residual rounded to bf16.
//
// Rows are bf16 of a width that is a multiple of 8, contiguous, on 16-byte
// bases; dest (int32) holds each (token, slot)'s row of the sorted layout,
// weights (f32) each slot's routing weight, both (tokens, k) contiguous.
// The kernels allocate nothing and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 values a 16-byte vector

__global__ void __launch_bounds__(kThreads)
moe_permute_kernel(const bf16* __restrict__ x, const int32_t* __restrict__ dest, bf16* __restrict__ out,
                   int width, int k) {
  const size_t t = blockIdx.x;
  const int n_vec = width / kVec;
  const uint4* src = reinterpret_cast<const uint4*>(x + t * width);
  const int32_t* d = dest + t * k;
  for (int c = threadIdx.x; c < n_vec; c += kThreads) {
    const uint4 val = src[c];
    for (int i = 0; i < k; ++i)
      reinterpret_cast<uint4*>(out + static_cast<size_t>(d[i]) * width)[c] = val;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const bf16* __restrict__ y, const int32_t* __restrict__ dest, const float* __restrict__ weights,
                   const bf16* __restrict__ shared, const bf16* __restrict__ residual, bf16* __restrict__ out,
                   int width, int k) {
  const size_t t = blockIdx.x;
  const int n_vec = width / kVec;
  const int32_t* d = dest + t * k;
  const float* w = weights + t * k;
  for (int c = threadIdx.x; c < n_vec; c += kThreads) {
    float acc[kVec], row[kVec];
    for (int i = 0; i < k; ++i) {
      unpack(reinterpret_cast<const uint4*>(y + static_cast<size_t>(d[i]) * width)[c], row);
      const float wi = w[i];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = i == 0 ? __fmul_rn(wi, row[j]) : __fadd_rn(acc[j], __fmul_rn(wi, row[j]));
    }
    float sh[kVec], res[kVec];
    unpack(reinterpret_cast<const uint4*>(shared + t * width)[c], sh);
    unpack(reinterpret_cast<const uint4*>(residual + t * width)[c], res);
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float routed = __bfloat162float(__float2bfloat16_rn(acc[2 * j + e]));
        const float moe = __bfloat162float(__float2bfloat16_rn(__fadd_rn(routed, sh[2 * j + e])));
        v[e] = __fadd_rn(res[2 * j + e], moe);
      }
      oh[j] = __floats2bfloat162_rn(v[0], v[1]);
    }
    reinterpret_cast<uint4*>(out + t * width)[c] = o;
  }
}

}  // namespace

// out (rows, width): row dest[t * k + i] <- x's row t, for every token t
// and slot i; rows no slot names are not written.
extern "C" int moe_permute(const void* x, const void* dest, void* out, long long n_tokens, int width, int k,
                           int device, void* stream) {
  if (width <= 0 || width % kVec || k <= 0 || n_tokens < 0 || n_tokens > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_tokens == 0) return cudaSuccess;
  moe_permute_kernel<<<static_cast<unsigned>(n_tokens), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int32_t*>(dest), static_cast<bf16*>(out), width, k);
  return cudaGetLastError();
}

// out (tokens, width): residual + (bf16(sum_i weights[t, i] * y[dest[t, i]]) + shared)
extern "C" int moe_combine(const void* y, const void* dest, const void* weights, const void* shared,
                           const void* residual, void* out, long long n_tokens, int width, int k, int device,
                           void* stream) {
  if (width <= 0 || width % kVec || k <= 0 || n_tokens < 0 || n_tokens > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_tokens == 0) return cudaSuccess;
  moe_combine_kernel<<<static_cast<unsigned>(n_tokens), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const int32_t*>(dest), static_cast<const float*>(weights),
      static_cast<const bf16*>(shared), static_cast<const bf16*>(residual), static_cast<bf16*>(out), width, k);
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
