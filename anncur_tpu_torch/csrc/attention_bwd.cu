// Kernels C and D: attention backward for the cross-encoder, for Hopper (sm_90a).
//
// Replace the backward of the stock Pallas TPU flash attention that
// anncur_tpu/models/bert.py::_flash_attention reaches under jax.grad:
// _flash_attention_bwd_dkv (kernel C here) and _flash_attention_bwd_dq
// (kernel D), jax/experimental/pallas/ops/tpu/flash_attention.py. With the
// forward's row log-sum-exp lse (csrc/attention.cu) and D = rowsum(dO * O)
// (a plain torch reduction beforehand, as JAX computes it outside Pallas):
//     P  = exp(Q K^T * scale + bias - lse)          (recomputed, never stored)
//     dV = P^T dO
//     dS = P * (dO V^T - D)
//     dK = scale * dS^T Q
//     dQ = scale * dS K
// bias = 0 at valid keys and -1e9 at padding, as in the forward, so a masked
// key's P is exactly 0 in f32 and it gets dK = dV = 0 exactly. Scores,
// exponentials and sums are f32; dQ, dK, dV are written in q's dtype.
//
// Bound on the H100: at s=256, hd=64, nh=12 one pair-layer reads Q, K, V,
// dO (1.57 MB of bf16) and writes dQ, dK, dV (1.18 MB), and does ~0.5 GFLOP
// (4 products of s x s x hd for C, 3 for D): ~180 FLOP/B, below the bf16
// tensor-core ridge (~295 FLOP/B), so memory bounds it. This first version,
// like kernel A, does its arithmetic in f32 FFMA on the CUDA cores
// (67 TFLOP/s), so in practice operations bound it; mma/wgmma tiles are
// later work.
//
// Design. One thread would hold k, v, dK and dV rows (4 x hd f32 = 256
// registers at hd=64), too many, so the head dim is split across SPLIT
// neighbouring lanes (32 dims each: SPLIT = 2 at hd=64). Each lane holds its
// dims in registers and the two dot products of a (query, key) pair are
// summed across the SPLIT lanes with warp shuffles. The lanes of a group
// own interleaved 16-byte units of the row, so the SPLIT distinct shared-
// memory reads of a warp fall in distinct banks.
// - Kernel C: one block per (pair, head, tile of 128/SPLIT key rows). A lane
//   holds its key's k, v, dK, dV dims; the block walks the g query rows in
//   shared-memory tiles of 64 rows of Q and dO (with their lse and D), every
//   lane of a group reading the same row: a broadcast.
// - Kernel D: one block per (pair, head, tile of 128/SPLIT query rows). A
//   lane holds its row's q, dO, dQ dims; the block walks the keys in tiles
//   of 64 rows of K and V. It skips masked keys (P = 0 there) whenever the
//   pair has a valid key; a pair with none attends every key, as forward.
// Kernel C likewise returns zeros at once from a block whose keys are all
// masked. Layout is the JAX one: q (b, g, nh, hd), k and v (b, s, nh, hd)
// with any strides on the batch, row and head axes and hd contiguous; dO,
// dQ (b, g, nh, hd) and dK, dV (b, s, nh, hd) contiguous; lse and D
// (b, nh, g) f32. The kernels allocate nothing and run on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // rows of the other side staged in shared memory at a time

// one 16-byte unit: 4 f32 or 8 bf16 values, to or from f32
__device__ __forceinline__ void load_unit(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

__device__ __forceinline__ void load_unit(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_unit(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ void store_unit(__nv_bfloat16* p, const float* src) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename T, int HD>
struct Split {
  static constexpr int kDims = HD < 32 ? HD : 32;               // dims per lane
  static constexpr int kLanes = HD / kDims;                     // lanes per row
  static constexpr int kUnit = 16 / static_cast<int>(sizeof(T));  // values per 16 B
  static constexpr int kUnits = kDims / kUnit;                  // units per lane
  static constexpr int kRowUnits = HD / kUnit;                  // units per row
  // element offset of this lane's t-th unit: units part, part + lanes, ...
  __device__ static int offset(int part, int t) { return (part + kLanes * t) * kUnit; }
  // sum over the lanes of one row (neighbouring lanes, xor partners)
  __device__ static float reduce(float x) {
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  }
};

// copy rows [r0, r0 + n) of a (row stride rs) head slice into dense shared rows
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long rs, int r0, int n) {
  constexpr int kRowUnits = Split<T, HD>::kRowUnits;
  for (int u = threadIdx.x; u < n * kRowUnits; u += kThreads) {
    const int r = u / kRowUnits, c = u % kRowUnits;
    reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * HD)[c] =
        reinterpret_cast<const uint4*>(src + (r0 + r) * rs)[c];
  }
}

// whether the pair's key row holds a valid key (block-wide)
__device__ __forceinline__ int pair_has_valid_key(const uint8_t* valid_row, int s) {
  int any = 0;
  for (int j = threadIdx.x; j < s; j += kThreads) any |= valid_row[j];
  return __syncthreads_or(any);
}

// ---------------------------------------------------------------- kernel C

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk_out,
                         T* __restrict__ dv_out, int g, int s, int nh,
                         long long q_sb, long long q_sr, long long q_sh,
                         long long k_sb, long long k_sr, long long k_sh,
                         long long v_sb, long long v_sr, long long v_sh,
                         long long valid_sb, float scale) {
  using S = Split<T, HD>;
  constexpr int kKeys = kThreads / S::kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kTile * HD;
  float* lse_s = reinterpret_cast<float*>(dos + kTile * HD);
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int part = threadIdx.x % S::kLanes;
  const int key = blockIdx.y * kKeys + threadIdx.x / S::kLanes;
  const bool in_range = key < s;
  const int key_c = in_range ? key : s - 1;
  const uint8_t* valid_row = key_valid + b * valid_sb;
  const float bias = valid_row[key_c] ? 0.0f : -1e9f;
  const size_t out_row = ((static_cast<size_t>(b) * s + key_c) * nh + h) * HD;

  // a masked key's P is exactly 0 when its pair has a valid key: a block of
  // only such keys writes zeros and is done (uniform across the block)
  const int has_valid = pair_has_valid_key(valid_row, s);
  if (!__syncthreads_or(in_range && (bias == 0.0f || !has_valid))) {
    if (in_range) {
      float zero[S::kUnit] = {};
#pragma unroll
      for (int t = 0; t < S::kUnits; ++t) {
        store_unit(dk_out + out_row + S::offset(part, t), zero);
        store_unit(dv_out + out_row + S::offset(part, t), zero);
      }
    }
    return;
  }

  float kr[S::kDims], vr[S::kDims], dk[S::kDims], dv[S::kDims];
  const T* kp = k + b * k_sb + key_c * k_sr + h * k_sh;
  const T* vp = v + b * v_sb + key_c * v_sr + h * v_sh;
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) {
    load_unit(kp + S::offset(part, t), kr + t * S::kUnit);
    load_unit(vp + S::offset(part, t), vr + t * S::kUnit);
  }
#pragma unroll
  for (int d = 0; d < S::kDims; ++d) dk[d] = dv[d] = 0.0f;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* dob = dout + (static_cast<size_t>(b) * g * nh + h) * HD;
  const float* lse_b = lse + (static_cast<size_t>(b) * nh + h) * g;
  const float* delta_b = delta + (static_cast<size_t>(b) * nh + h) * g;
  for (int i0 = 0; i0 < g; i0 += kTile) {
    const int n = min(kTile, g - i0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<T, HD>(qs, qb, q_sr, i0, n);
    stage_rows<T, HD>(dos, dob, static_cast<long long>(nh) * HD, i0, n);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      lse_s[i] = lse_b[i0 + i];
      delta_s[i] = delta_b[i0 + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const T* qi = qs + i * HD;
      const T* doi = dos + i * HD;
      float sdot = 0.0f, pdot = 0.0f;
#pragma unroll
      for (int t = 0; t < S::kUnits; ++t) {
        float qv[S::kUnit], dov[S::kUnit];
        load_unit(qi + S::offset(part, t), qv);
        load_unit(doi + S::offset(part, t), dov);
#pragma unroll
        for (int e = 0; e < S::kUnit; ++e) {
          sdot = fmaf(qv[e], kr[t * S::kUnit + e], sdot);
          pdot = fmaf(dov[e], vr[t * S::kUnit + e], pdot);
        }
      }
      sdot = S::reduce(sdot);
      pdot = S::reduce(pdot);
      const float p = expf(sdot * scale + bias - lse_s[i]);
      const float ds = p * (pdot - delta_s[i]);
#pragma unroll
      for (int t = 0; t < S::kUnits; ++t) {
        float qv[S::kUnit], dov[S::kUnit];
        load_unit(qi + S::offset(part, t), qv);
        load_unit(doi + S::offset(part, t), dov);
#pragma unroll
        for (int e = 0; e < S::kUnit; ++e) {
          dv[t * S::kUnit + e] = fmaf(p, dov[e], dv[t * S::kUnit + e]);
          dk[t * S::kUnit + e] = fmaf(ds, qv[e], dk[t * S::kUnit + e]);
        }
      }
    }
  }

  if (!in_range) return;
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) {
    float o[S::kUnit];
#pragma unroll
    for (int e = 0; e < S::kUnit; ++e) o[e] = dk[t * S::kUnit + e] * scale;
    store_unit(dk_out + out_row + S::offset(part, t), o);
    store_unit(dv_out + out_row + S::offset(part, t), dv + t * S::kUnit);
  }
}

// ---------------------------------------------------------------- kernel D

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ key_valid,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq_out, int g, int s,
                        int nh, long long q_sb, long long q_sr, long long q_sh,
                        long long k_sb, long long k_sr, long long k_sh,
                        long long v_sb, long long v_sr, long long v_sh,
                        long long valid_sb, float scale) {
  using S = Split<T, HD>;
  constexpr int kRows = kThreads / S::kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTile * HD;
  float* bias_s = reinterpret_cast<float*>(vs + kTile * HD);

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int part = threadIdx.x % S::kLanes;
  const int row = blockIdx.y * kRows + threadIdx.x / S::kLanes;
  const bool in_range = row < g;
  const int row_c = in_range ? row : g - 1;
  const uint8_t* valid_row = key_valid + b * valid_sb;
  const int has_valid = pair_has_valid_key(valid_row, s);

  float qr[S::kDims], dor[S::kDims], dq[S::kDims];
  const T* qp = q + b * q_sb + row_c * q_sr + h * q_sh;
  const size_t io_row = ((static_cast<size_t>(b) * g + row_c) * nh + h) * HD;
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) {
    load_unit(qp + S::offset(part, t), qr + t * S::kUnit);
    load_unit(dout + io_row + S::offset(part, t), dor + t * S::kUnit);
  }
#pragma unroll
  for (int d = 0; d < S::kDims; ++d) dq[d] = 0.0f;
  const size_t stat = (static_cast<size_t>(b) * nh + h) * g + row_c;
  const float lse_i = lse[stat];
  const float delta_i = delta[stat];

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int j0 = 0; j0 < s; j0 += kTile) {
    const int n = min(kTile, s - j0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<T, HD>(ks, kb, k_sr, j0, n);
    stage_rows<T, HD>(vs, vb, v_sr, j0, n);
    for (int j = threadIdx.x; j < n; j += kThreads) bias_s[j] = valid_row[j0 + j] ? 0.0f : -1e9f;
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float bias = bias_s[j];
      if (bias != 0.0f && has_valid) continue;  // P = 0 exactly; uniform across the block
      const T* kj = ks + j * HD;
      const T* vj = vs + j * HD;
      float sdot = 0.0f, pdot = 0.0f;
#pragma unroll
      for (int t = 0; t < S::kUnits; ++t) {
        float kv[S::kUnit], vv[S::kUnit];
        load_unit(kj + S::offset(part, t), kv);
        load_unit(vj + S::offset(part, t), vv);
#pragma unroll
        for (int e = 0; e < S::kUnit; ++e) {
          sdot = fmaf(qr[t * S::kUnit + e], kv[e], sdot);
          pdot = fmaf(dor[t * S::kUnit + e], vv[e], pdot);
        }
      }
      sdot = S::reduce(sdot);
      pdot = S::reduce(pdot);
      const float ds = expf(sdot * scale + bias - lse_i) * (pdot - delta_i);
#pragma unroll
      for (int t = 0; t < S::kUnits; ++t) {
        float kv[S::kUnit];
        load_unit(kj + S::offset(part, t), kv);
#pragma unroll
        for (int e = 0; e < S::kUnit; ++e) dq[t * S::kUnit + e] = fmaf(ds, kv[e], dq[t * S::kUnit + e]);
      }
    }
  }

  if (!in_range) return;
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) {
    float o[S::kUnit];
#pragma unroll
    for (int e = 0; e < S::kUnit; ++e) o[e] = dq[t * S::kUnit + e] * scale;
    store_unit(dq_out + io_row + S::offset(part, t), o);
  }
}

// ---------------------------------------------------------------- launches

struct Args {
  const void *q, *k, *v, *key_valid, *dout, *lse, *delta;
  void *out0, *out1;  // dK, dV (kernel C) or dQ (kernel D)
  int b, g, s, nh;
  long long st[10];  // q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = 2 * static_cast<size_t>(kTile) * HD * sizeof(T) + 2 * kTile * sizeof(float);
  auto kern = attention_bwd_dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int kKeys = kThreads / Split<T, HD>::kLanes;
  const dim3 grid(a.b * a.nh, (a.s + kKeys - 1) / kKeys);
  const long long* st = a.st;
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.g, a.s, a.nh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = 2 * static_cast<size_t>(kTile) * HD * sizeof(T) + kTile * sizeof(float);
  auto kern = attention_bwd_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int kRows = kThreads / Split<T, HD>::kLanes;
  const dim3 grid(a.b * a.nh, (a.g + kRows - 1) / kRows);
  const long long* st = a.st;
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.g, a.s, a.nh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  return cudaGetLastError();
}

template <typename T, bool kDkv>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return kDkv ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32: return kDkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return kDkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return kDkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDkv>
int run(const void* q, const void* k, const void* v, const void* key_valid, const void* dout,
        const void* lse, const void* delta, void* out0, void* out1, int is_bf16, int b, int g,
        int s, int nh, int hd, long long q_sb, long long q_sr, long long q_sh, long long k_sb,
        long long k_sr, long long k_sh, long long v_sb, long long v_sr, long long v_sh,
        long long valid_sb, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{q, k, v, key_valid, dout, lse, delta, out0, out1, b, g, s, nh,
               {q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb},
               scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch_hd<__nv_bfloat16, kDkv>(hd, a) : dispatch_hd<float, kDkv>(hd, a);
}

}  // namespace

// Kernel C: dK and dV, each (b, s, nh, hd) contiguous in q's dtype. Strides
// (in elements) as attention_fwd's. Returns cudaGetLastError() after the launch.
extern "C" int attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* key_valid, const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int is_bf16, int b,
                                 int g, int s, int nh, int hd, long long q_sb, long long q_sr,
                                 long long q_sh, long long k_sb, long long k_sr, long long k_sh,
                                 long long v_sb, long long v_sr, long long v_sh,
                                 long long valid_sb, float scale, int device, void* stream) {
  return run<true>(q, k, v, key_valid, dout, lse, delta, dk, dv, is_bf16, b, g, s, nh, hd, q_sb,
                   q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb, scale, device,
                   stream);
}

// Kernel D: dQ, (b, g, nh, hd) contiguous in q's dtype.
extern "C" int attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* key_valid, const void* dout, const void* lse,
                                const void* delta, void* dq, int is_bf16, int b, int g, int s,
                                int nh, int hd, long long q_sb, long long q_sr, long long q_sh,
                                long long k_sb, long long k_sr, long long k_sh, long long v_sb,
                                long long v_sr, long long v_sh, long long valid_sb, float scale,
                                int device, void* stream) {
  return run<false>(q, k, v, key_valid, dout, lse, delta, dq, nullptr, is_bf16, b, g, s, nh, hd,
                    q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb, scale, device,
                    stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
