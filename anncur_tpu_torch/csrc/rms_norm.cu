// RMSNorm over bf16 rows, for Hopper (sm_90a), in one memory-bound pass.
//
// Replaces no TPU kernel: the JAX package has no decoder model. It is the
// norm of models/deepseek_v2.py (three a decoder layer: attn_norm, kv_norm
// over the latent's first 512 of 576 columns and mlp_norm; then the final
// norm),
// whose plain composition (ops/rms_norm.py::rms_norm_plain) eager PyTorch
// runs as seven passes: the f32 cast, the square, the mean, rsqrt, the
// broadcast multiply, the cast back and the weight multiply. This kernel
// reads each row once and writes it once:
//
//   ms = sum(x^2) / width in f32;  r = rsqrt(ms + eps);
//   y  = bf16(w * bf16(x * r))
//
// Every rounding point is the plain composition's: the mean and the eps add
// rounded apart (no FMA contraction), the normalised value rounded once to
// bf16, then the product with the bf16 weight rounded once. The squares of
// bf16 values are exact in f32, so only the order of the f32 row sum differs
// from PyTorch's reduction: where the two sums agree the result has the
// plain composition's bits, elsewhere the normalised value lies at most one
// bf16 ulp from it.
//
// Bound on the H100: bytes, 3.35 TB/s. A row is read once and written once,
// 4 bytes an element; the weight (one row) is read from L1 after the first
// warp. At DeepSeek-V2-Lite's forward of 131,072 tokens x 2,048: 1.07 GB,
// 0.32 ms; kv_norm's 131,072 x 512 (read in place out of 576-wide rows):
// 0.27 GB, 0.08 ms.
//
// Design: one warp a row, 8 rows a block. A lane holds its 16-byte vectors
// (8 bf16) of the row in registers between the sum and the normalisation,
// neighbouring lanes on neighbouring vectors, all of its loads in flight at
// once; the sum of squares is reduced by warp shuffles. The lane count of
// vectors is a template parameter, built at 2 (rows up to 512 wide) and 8
// (up to 2,048; at 16, ptxas spills). The input takes a row stride (in
// elements, a multiple of 8), so a view of the first columns of wider rows
// is read where it lies, with no copy. The output is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // rows (one warp each) a block
constexpr int kMaxVecPerLane = 8;     // 16-byte vectors a lane: width <= 2048

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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One warp a row of nvec 16-byte vectors (nvec <= 32 * VPL); rows start
// stride_vec vectors apart in x and nvec apart in out.
template <int VPL>
__global__ void __launch_bounds__(kWarps * 32)
rms_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ weight, uint4* __restrict__ out,
                long long rows, int nvec, long long stride_vec, float width, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const uint4* src = x + row * stride_vec;
  uint4 v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) v[i] = src[c];
  }
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < nvec) {
      float f[8];
      unpack8(v[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) sq = fmaf(f[j], f[j], sq);  // the square is exact: one rounding, the add's
    }
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), width), eps));
  uint4* dst = out + row * nvec;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      float f[8], w[8];
      unpack8(v[i], f);
      unpack8(__ldg(weight + c), w);
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = pack2(__fmul_rn(w[2 * j], round_bf16(__fmul_rn(f[2 * j], r))),
                     __fmul_rn(w[2 * j + 1], round_bf16(__fmul_rn(f[2 * j + 1], r))));
      dst[c] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int VPL>
cudaError_t launch(const void* x, const void* weight, void* out, long long rows, int nvec, long long stride_vec,
                   float eps, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  rms_norm_kernel<VPL><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(weight), static_cast<uint4*>(out), rows, nvec,
      stride_vec, static_cast<float>(8 * nvec), eps);
  return cudaGetLastError();
}

}  // namespace

// x: rows of `width` bf16 (a multiple of 8, at most 2,048), `row_stride`
// elements apart (a multiple of 8, at least width), on a 16-byte base;
// weight: `width` bf16 on a 16-byte base; out: rows x width bf16,
// contiguous. Returns cudaGetLastError() of the launch (0: launched); no
// launch for 0 rows.
extern "C" int rms_norm(const void* x, const void* weight, void* out, long long rows, int width,
                        long long row_stride, float eps, int device, void* stream) {
  const int nvec = width / 8;
  if (width % 8 || nvec < 1 || nvec > 32 * kMaxVecPerLane || row_stride % 8 || row_stride < width || rows < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long stride_vec = row_stride / 8;
  // the configuration's widths, 512 (kv_norm) and 2,048, each on its own
  // body; other widths run on the narrowest body that holds them
  if (nvec <= 32 * 2) return launch<2>(x, weight, out, rows, nvec, stride_vec, eps, st);
  return launch<kMaxVecPerLane>(x, weight, out, rows, nvec, stride_vec, eps, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
