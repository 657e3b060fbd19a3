// Kernel A: attention forward for the cross-encoder, for Hopper (sm_90a).
//
// Replaces anncur_tpu/models/bert.py::_flash_attention (the stock Pallas TPU
// flash_attention forward) and computes what anncur_tpu/models/bert.py::
// _attn_core computes at every real query row:
//     out = softmax(Q K^T / sqrt(hd) + bias) V,
// bias = 0 at valid keys and -1e9 at padding (exp of a masked key is exactly
// 0 in f32), with f32 scores, f32 softmax and f32 accumulation. The
// probabilities never leave the chip.
//
// Bound on the H100: at s=256, hd=64, nh=12 one pair-layer does ~201 MFLOP
// and moves 1.57 MB of bf16 Q/K/V/O, 128 FLOP/B: below the bf16 tensor-core
// ridge (~295 FLOP/B), so memory bounds it, ~0.47 us per pair-layer at
// 3.35 TB/s. This first version does its arithmetic in f32 FFMA on the CUDA
// cores (67 TFLOP/s), not on the tensor cores, so in practice it is bounded
// by operations at ~3 us per pair-layer; mma/wgmma and TMA are later work.
//
// Design: one block per (pair, head, tile of 128 query rows). The head's K
// and V rows for the whole sequence are copied into dynamic shared memory
// (64 KB at s=256, hd=64, bf16: above the 48 KB default, hence
// cudaFuncSetAttribute) beside the f32 key bias. Each thread owns one query
// row: the row and its output accumulator live in registers, and it runs an
// online softmax over chunks of 16 keys, one rescale per chunk. All threads
// of a warp read the same K/V row at a time, a shared-memory broadcast.
// Layout is the JAX one: q (b, g, nh, hd), k and v (b, s, nh, hd), any
// strides on the batch, row and head axes, hd contiguous; out (b, g, nh, hd)
// contiguous. The kernel allocates nothing and runs on the caller's stream.
//
// For the backward (csrc/attention_bwd.cu) the launch may also write each
// row's log-sum-exp, lse = m + log(l) in f32, shape (b, nh, g): the online
// softmax's running max and sum, which the backward kernels use to recompute
// P = exp(score - lse) without a second pass over the keys. A null lse
// pointer (inference) writes nothing extra.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kKeyChunk = 16;

__device__ __forceinline__ void load8(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(src[4], src[5], src[6], src[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* src) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                     T* __restrict__ out, float* __restrict__ lse, int g, int s, int nh,
                     long long q_sb, long long q_sr, long long q_sh,
                     long long k_sb, long long k_sr, long long k_sh,
                     long long v_sb, long long v_sr, long long v_sh,
                     long long valid_sb, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + static_cast<size_t>(s) * HD;
  float* bias = reinterpret_cast<float*>(vs + static_cast<size_t>(s) * HD);

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;

  // cooperative copy of this head's K and V rows, 16 bytes per thread-step
  constexpr int kUnits = HD * static_cast<int>(sizeof(T)) / 16;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int u = threadIdx.x; u < s * kUnits; u += kThreads) {
    const int r = u / kUnits, c = u % kUnits;
    reinterpret_cast<uint4*>(ks + static_cast<size_t>(r) * HD)[c] =
        reinterpret_cast<const uint4*>(kb + r * k_sr)[c];
    reinterpret_cast<uint4*>(vs + static_cast<size_t>(r) * HD)[c] =
        reinterpret_cast<const uint4*>(vb + r * v_sr)[c];
  }
  for (int j = threadIdx.x; j < s; j += kThreads)
    bias[j] = key_valid[b * valid_sb + j] ? 0.0f : -1e9f;
  __syncthreads();

  const int row = blockIdx.y * kThreads + threadIdx.x;
  if (row >= g) return;

  float qf[HD], acc[HD];
  const T* qp = q + b * q_sb + row * q_sr + h * q_sh;
#pragma unroll
  for (int d = 0; d < HD; d += 8) load8(qp + d, qf + d);
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int j0 = 0; j0 < s; j0 += kKeyChunk) {
    float sc[kKeyChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeyChunk; ++j) {
      sc[j] = -INFINITY;
      if (j0 + j < s) {
        const T* kr = ks + static_cast<size_t>(j0 + j) * HD;
        float dot = 0.0f;
#pragma unroll
        for (int d = 0; d < HD; d += 8) {
          float kv[8];
          load8(kr + d, kv);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qf[d + e], kv[e], dot);
        }
        sc[j] = dot * scale + bias[j0 + j];
      }
      cmax = fmaxf(cmax, sc[j]);
    }
    // the first chunk always holds a key, so m_new is finite from here on
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);  // 0 on the first chunk (m = -inf)
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeyChunk; ++j) {
      if (j0 + j < s) {
        const float p = expf(sc[j] - m_new);
        l += p;
        const T* vr = vs + static_cast<size_t>(j0 + j) * HD;
#pragma unroll
        for (int d = 0; d < HD; d += 8) {
          float vv[8];
          load8(vr + d, vv);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[d + e] = fmaf(p, vv[e], acc[d + e]);
        }
      }
    }
    m = m_new;
  }

  const float inv = 1.0f / l;
  T* op = out + ((static_cast<size_t>(b) * g + row) * nh + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; d += 8) {
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = acc[d + e] * inv;
    store8(op + d, o);
  }
  if (lse != nullptr) lse[(static_cast<size_t>(b) * nh + h) * g + row] = m + logf(l);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_valid,
                   void* out, float* lse, int b, int g, int s, int nh, const long long* st,
                   float scale, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(s) * HD * sizeof(T) + s * sizeof(float);
  auto kern = attention_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * nh, (g + kThreads - 1) / kThreads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<T*>(out), lse, g, s, nh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* key_valid, void* out, float* lse, int b, int g, int s, int nh,
                        const long long* st, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, key_valid, out, lse, b, g, s, nh, st, scale, stream);
    case 32: return launch<T, 32>(q, k, v, key_valid, out, lse, b, g, s, nh, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, key_valid, out, lse, b, g, s, nh, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, key_valid, out, lse, b, g, s, nh, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides (in elements): q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh,
// valid_sb. lse: null, or (b, nh, g) f32 for the row log-sum-exp. Returns
// cudaGetLastError() after the launch.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* key_valid, void* out, void* lse, int is_bf16, int b,
                             int g, int s, int nh, int hd, long long q_sb,
                             long long q_sr, long long q_sh, long long k_sb,
                             long long k_sr, long long k_sh, long long v_sb,
                             long long v_sr, long long v_sh, long long valid_sb,
                             float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long st[10] = {q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, key_valid, out, static_cast<float*>(lse), b, g,
                                      s, nh, st, scale, cs);
  return dispatch_hd<float>(hd, q, k, v, key_valid, out, static_cast<float*>(lse), b, g, s, nh, st,
                            scale, cs);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
