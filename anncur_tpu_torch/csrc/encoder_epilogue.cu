// The encoder layer's elementwise work between its GEMMs, for Hopper (sm_90a),
// in three memory-bound passes over bf16 activations.
//
// Replaces no TPU kernel: the JAX package leaves the bias adds, GELU,
// residual adds and LayerNorms of anncur_tpu/models/bert.py::_encoder_layer
// to XLA, which fuses them beside its GEMMs. Eager PyTorch runs each as its
// own pass (a broadcast bias add, a GELU, a residual add, then .float(),
// F.layer_norm and .to(bf16)), 52 activation widths of traffic a layer;
// these kernels read each input once and write each output once, 20 widths.
// models/bert.py takes them on the inference path (CUDA, bf16, no autograd
// graph, no dropout, no tensor parallelism).
//
//   bias_residual_layernorm  t = bf16(mm + bf16(b)); s = bf16(res + t);
//                            y = bf16(gamma * (rstd * (s - mean)) + beta),
//                            mean and variance of s in f32, two passes over
//                            the row held in registers
//   bias_gelu                t = bf16(mm + bf16(b)); y = bf16(gelu(t)) in f32,
//                            PyTorch's tanh formula or its erf formula
//   bias_add3                x = bf16(x + bf16(b)) in place, for q, k and v
//
// Every rounding point is the plain composition's (ops/encoder_epilogue.py,
// the *_plain functions); only the LayerNorm's f32 reduction order and the
// math library's last bits may differ from PyTorch's kernels.
//
// Bound on the H100: bytes, 3.35 TB/s. Per element, 6 bytes for the
// LayerNorm (mm, res in; y out), 4 for the GELU and the bias add; bias,
// scale and shift are f32 vectors of one row, read from L1 after the first
// warp. The GELU's tanhf costs ~20 instructions an element, about half the
// issue rate that 4 bytes an element leave at 3.35 TB/s.
//
// Design. 16-byte loads and stores (8 bf16), neighbouring threads on
// neighbouring vectors. The LayerNorm takes one warp a row (hidden 768:
// 96 vectors, 3 a lane), 8 rows a block, the row kept as packed bf16 in
// registers between its passes, the sums reduced by warp shuffles; the lane
// count of vectors is a template parameter up to 16 (hidden 4096). The bias
// kernels give each thread one column vector, its bias rounded once into
// registers, and walk 16 rows a block, 8 loads in flight a thread; a block
// is as wide as the row's vectors in whole warps, up to 128 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLnWarps = 8;          // rows (one warp each) a LayerNorm block
constexpr int kLnMaxVecPerLane = 16; // 16-byte vectors a lane: hidden <= 4096
constexpr int kColThreads = 128;     // most column vectors a bias block
constexpr int kRowsPerBlock = 16;    // rows a bias block walks
constexpr int kRowsInFlight = 8;     // loads in flight a thread

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 8 f32 values of a vector from 16-byte-aligned f32 memory (read-only path)
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One warp a row of nvec 16-byte vectors (nvec <= 32 * VPL).
template <int VPL>
__global__ void __launch_bounds__(kLnWarps * 32)
bias_residual_layernorm_kernel(const uint4* __restrict__ mm, const float* __restrict__ bias,
                               const uint4* __restrict__ res, const float* __restrict__ gamma,
                               const float* __restrict__ beta, uint4* __restrict__ out,
                               long long rows, int nvec, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const long long base = row * nvec;
  uint4 a[VPL], r[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      a[i] = mm[base + c];
      r[i] = res[base + c];
    }
  }
  uint4 s[VPL];  // s = bf16(res + bf16(mm + bf16(b))), packed
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float fa[8], fr[8], fb[8], fs[8];
      unpack8(a[i], fa);
      unpack8(r[i], fr);
      load8(bias + 8 * c, fb);
#pragma unroll
      for (int j = 0; j < 8; ++j) fs[j] = fr[j] + round_bf16(fa[j] + round_bf16(fb[j]));
      s[i] = pack8(fs);
      unpack8(s[i], fs);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += fs[j];
    }
  }
  const float width = static_cast<float>(8 * nvec);
  const float mean = warp_sum(sum) / width;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < nvec) {
      float fs[8];
      unpack8(s[i], fs);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = fs[j] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / width + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float fs[8], fg[8], fh[8], y[8];
      unpack8(s[i], fs);
      load8(gamma + 8 * c, fg);
      load8(beta + 8 * c, fh);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = fg[j] * (rstd * (fs[j] - mean)) + fh[j];
      out[base + c] = pack8(y);
    }
  }
}

// PyTorch's GELU formulas in f32 (aten/src/ATen/native/cuda/ActivationGeluKernel.cu)
template <bool kTanh>
__device__ __forceinline__ float gelu(float x) {
  if (kTanh) {
    constexpr float kBeta = 1.41421356237309504880 * 1.12837916709551257390 * 0.5;  // M_SQRT2 * M_2_SQRTPI / 2
    constexpr float kKappa = 0.044715f;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  constexpr float kAlpha = 0.70710678118654752440;  // M_SQRT1_2
  return x * 0.5f * (1.f + erff(x * kAlpha));
}

enum class Epilogue { kBias, kGeluTanh, kGeluErf };

template <Epilogue E>
__device__ __forceinline__ uint4 bias_vector(const uint4& v, const float (&b)[8]) {
  float f[8];
  unpack8(v, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float t = f[j] + b[j];
    if (E == Epilogue::kBias) f[j] = t;
    else f[j] = gelu<E == Epilogue::kGeluTanh>(round_bf16(t));
  }
  return pack8(f);
}

// One column vector a thread; blockIdx.x walks kRowsPerBlock rows of the
// (rows, nvec) matrix, blockIdx.y the column vectors (blockDim.x of them a
// block). `in` may be `out`.
template <Epilogue E>
__device__ __forceinline__ void bias_rows(const uint4* in, const float* __restrict__ bias, uint4* out,
                                          long long rows, int nvec) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  if (c >= nvec || row0 >= rows) return;
  float b[8];
  load8(bias + 8 * c, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = round_bf16(b[j]);
#pragma unroll
  for (int r0 = 0; r0 < kRowsPerBlock; r0 += kRowsInFlight) {
    uint4 v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const long long row = row0 + r0 + u;
      if (row < rows) v[u] = in[row * nvec + c];
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const long long row = row0 + r0 + u;
      if (row < rows) out[row * nvec + c] = bias_vector<E>(v[u], b);
    }
  }
}

template <Epilogue E>
__global__ void __launch_bounds__(kColThreads)
bias_gelu_kernel(const uint4* __restrict__ mm, const float* __restrict__ bias, uint4* __restrict__ out,
                 long long rows, int nvec) {
  bias_rows<E>(mm, bias, out, rows, nvec);
}

struct Add3 {
  uint4* x[3];
  const float* b[3];
  long long rows[3];
  int nvec[3];
};

// blockIdx.z picks q, k or v (by branches: an indexed parameter would go
// to local memory); in place, each element read, then written, by one thread
__global__ void __launch_bounds__(kColThreads) bias_add3_kernel(Add3 p) {
  const int z = blockIdx.z;
  uint4* x = z == 0 ? p.x[0] : z == 1 ? p.x[1] : p.x[2];
  const float* b = z == 0 ? p.b[0] : z == 1 ? p.b[1] : p.b[2];
  const long long rows = z == 0 ? p.rows[0] : z == 1 ? p.rows[1] : p.rows[2];
  const int nvec = z == 0 ? p.nvec[0] : z == 1 ? p.nvec[1] : p.nvec[2];
  bias_rows<Epilogue::kBias>(x, b, x, rows, nvec);
}

unsigned ceil_div(long long a, long long b) { return static_cast<unsigned>((a + b - 1) / b); }

// Threads of a bias block: the row's column vectors rounded up to whole
// warps, at most kColThreads (hidden 768: 96, every thread busy).
int col_threads(int nvec) { return nvec >= kColThreads ? kColThreads : 32 * ((nvec + 31) / 32); }

template <int VPL>
cudaError_t launch_ln(const void* mm, const void* bias, const void* res, const void* gamma,
                      const void* beta, void* out, long long rows, int nvec, float eps, cudaStream_t st) {
  bias_residual_layernorm_kernel<VPL><<<ceil_div(rows, kLnWarps), kLnWarps * 32, 0, st>>>(
      static_cast<const uint4*>(mm), static_cast<const float*>(bias), static_cast<const uint4*>(res),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<uint4*>(out), rows,
      nvec, eps);
  return cudaGetLastError();
}

}  // namespace

// Entries: bf16 rows of `width` elements (a multiple of 8), contiguous, on
// 16-byte bases; f32 vectors of `width`, on 16-byte bases. Each returns
// cudaGetLastError() of its launch (0: launched); no launch for 0 rows.

extern "C" int bias_residual_layernorm(const void* mm, const void* bias, const void* res, const void* gamma,
                                       const void* beta, void* out, long long rows, int width, float eps,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int nvec = width / 8;
  if (width % 8 || nvec < 1 || nvec > 32 * kLnMaxVecPerLane) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((nvec + 31) / 32) {
#define LN_CASE(V) \
    case V: return launch_ln<V>(mm, bias, res, gamma, beta, out, rows, nvec, eps, st);
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4) LN_CASE(5) LN_CASE(6) LN_CASE(7) LN_CASE(8)
    LN_CASE(9) LN_CASE(10) LN_CASE(11) LN_CASE(12) LN_CASE(13) LN_CASE(14) LN_CASE(15) LN_CASE(16)
#undef LN_CASE
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int bias_gelu(const void* mm, const void* bias, void* out, long long rows, int width, int approximate,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int nvec = width / 8;
  if (width % 8 || nvec < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int threads = col_threads(nvec);
  const dim3 grid(ceil_div(rows, kRowsPerBlock), ceil_div(nvec, threads));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint4* in = static_cast<const uint4*>(mm);
  const float* b = static_cast<const float*>(bias);
  uint4* o = static_cast<uint4*>(out);
  if (approximate) bias_gelu_kernel<Epilogue::kGeluTanh><<<grid, threads, 0, st>>>(in, b, o, rows, nvec);
  else bias_gelu_kernel<Epilogue::kGeluErf><<<grid, threads, 0, st>>>(in, b, o, rows, nvec);
  return cudaGetLastError();
}

extern "C" int bias_add3(void* q, void* k, void* v, const void* bq, const void* bk, const void* bv,
                         long long rows_q, long long rows_k, long long rows_v, int width_q, int width_k,
                         int width_v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Add3 p = {{static_cast<uint4*>(q), static_cast<uint4*>(k), static_cast<uint4*>(v)},
            {static_cast<const float*>(bq), static_cast<const float*>(bk), static_cast<const float*>(bv)},
            {rows_q, rows_k, rows_v},
            {width_q / 8, width_k / 8, width_v / 8}};
  long long rows = 0;
  int nvec = 0;
  for (int i = 0; i < 3; ++i) {
    const int w = i == 0 ? width_q : i == 1 ? width_k : width_v;
    if (w % 8 || w < 8) return cudaErrorInvalidValue;
    rows = p.rows[i] > rows ? p.rows[i] : rows;
    nvec = p.nvec[i] > nvec ? p.nvec[i] : nvec;
  }
  if (rows == 0) return cudaSuccess;
  const int threads = col_threads(nvec);
  const dim3 grid(ceil_div(rows, kRowsPerBlock), ceil_div(nvec, threads), 3);
  bias_add3_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
