// Shared by kernels A (attention.cu) and C, D (attention_bwd.cu): the head
// dims they are built for, and the pieces of their f32 CUDA-core bodies.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Every multiple of 16 from 16 to 256: X(hd) once per head dim (wider
// heads take the wide route, csrc/attention_wide.cuh).
#define ATTN_HEAD_DIMS(X)                                                                   \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176) X(192) X(208) X(224) \
  X(240) X(256)

namespace attn_f32 {

constexpr int kF32Threads = 128;
constexpr int kF32Tile = 64;  // rows of K/V (or Q/dO) staged in shared memory at a time

// one 16-byte unit: 4 f32 values
__device__ __forceinline__ void load_unit(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
}

__device__ __forceinline__ void store_unit(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
}

// Lanes that share one row of HD dims: the fewest (a power of two up to 8)
// that leave each lane at most 32 dims in whole 16-byte units, else as many
// as divide the row's units (36 dims a lane at hd=144).
template <int HD>
constexpr int split_lanes() {
  int best = 1;
  for (int p = 1; p <= 8; p <<= 1) {
    if ((HD / 4) % p) break;
    best = p;
    if (HD / p <= 32) break;
  }
  return best;
}

template <int HD>
struct Split {
  static_assert(HD % 16 == 0, "head dims are multiples of 16");
  static constexpr int kLanes = split_lanes<HD>();  // lanes per row
  static constexpr int kDims = HD / kLanes;         // dims per lane
  static constexpr int kUnit = 4;                   // f32 values per 16 B
  static constexpr int kUnits = kDims / kUnit;      // units per lane
  static constexpr int kRowUnits = HD / kUnit;      // units per row
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
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long rs, int r0, int n) {
  constexpr int kRowUnits = Split<HD>::kRowUnits;
  for (int u = threadIdx.x; u < n * kRowUnits; u += kF32Threads) {
    const int r = u / kRowUnits, c = u % kRowUnits;
    reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * HD)[c] =
        reinterpret_cast<const uint4*>(src + (r0 + r) * rs)[c];
  }
}

// whether the pair's key row holds a valid key (block-wide)
__device__ __forceinline__ int pair_has_valid_key(const uint8_t* valid_row, int s) {
  int any = 0;
  for (int j = threadIdx.x; j < s; j += kF32Threads) any |= valid_row[j];
  return __syncthreads_or(any);
}

}  // namespace attn_f32
