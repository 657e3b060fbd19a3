// Kernel B: fused f32 matmul + top-k (exact MIPS), for Hopper (sm_90a).
//
// Replaces anncur_tpu/ops/mips_pallas.py::_mips_kernel and ::_maxmask_kernel,
// and computes the latent projection + top-k_retvr stage of the fixed-anchor
// query (anncur_tpu/core/retriever.py, `approx = anchor_scores @ latent_cols`
// masked at padded columns, then lax.top_k):
//     scores = queries @ items^T   (IEEE f32, FFMA, no TF32 tensor cores)
//     top-k per query over columns < n_valid, scores descending, ties to the
//     smallest item id (lax.top_k's order).
//
// Bound on the H100: at q=32, d=500, n=10240 the kernel must read 20.5 MB of
// items, ~6.1 us at 3.35 TB/s, above the 4.9 us of f32 FMA work
// (2*q*d*n = 328 MFLOP at 67 TFLOP/s): memory bounds it.
//
// Design. The TPU kernels carry a running top-k in scratch from one
// sequential grid step to the next; Hopper runs blocks in parallel and in no
// order, so nothing carries over. Instead, two phases:
//  1. One block per (256-item split, 8-query tile). Its 256 threads each own
//     one item; depth is staged through shared memory 16 columns at a time
//     and each thread accumulates its 8 dot products with fmaf in order over
//     d. The 8 x 256 (score, id) keys are sorted best-first with a bitonic
//     network in shared memory and the best K2 (k rounded up to a power of
//     two, K2 <= 256) of each query are written to scratch.
//  2. Merge launches: one block per (group of sorted lists, query) merges up
//     to 8192/K2 lists by a tree of bitonic merges (best of A[i] and
//     B[K2-1-i], then a bitonic merger), until one list per query is left;
//     the last launch writes the first k as f32 scores and int64 ids.
// Columns >= n_valid become (-inf, INT_MAX) sentinels, which sort after every
// real key and are never selected while k <= n_valid. The comparison is the
// total order (score descending, id ascending), so the result equals a stable
// descending sort of the score row. The wrapper allocates outputs and
// scratch; the kernels allocate nothing and run on the caller's stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSplit = 256;  // items per phase-1 block: one per thread
constexpr int kQTile = 8;    // queries per phase-1 block
constexpr int kDChunk = 16;  // depth staged per shared-memory round
constexpr int kMergeEntries = 8192;  // list entries one merge block holds

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ void swap_keys(float* s, int* id, int a, int b) {
  const float ts = s[a];
  s[a] = s[b];
  s[b] = ts;
  const int ti = id[a];
  id[a] = id[b];
  id[b] = ti;
}

// Sort `rows` rows of n (a power of two) keys each, best first.
__device__ void bitonic_sort_rows(float* s, int* id, int rows, int n) {
  const int half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < rows * half; t += blockDim.x) {
        const int r = t / half, i = t % half;
        const int lo = r * n + 2 * stride * (i / stride) + (i % stride);
        const int hi = lo + stride;
        const bool best_first = ((lo - r * n) & size) == 0;
        if (better(s[hi], id[hi], s[lo], id[lo]) == best_first) swap_keys(s, id, lo, hi);
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mips_split_topk_kernel(const float* __restrict__ qry, const float* __restrict__ items,
                       int q, int n, int d, int n_valid, int k2, int n_splits,
                       float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float qs[kQTile][kDChunk];
  __shared__ float its[kSplit][kDChunk + 1];  // +1: conflict-free column reads
  __shared__ float ks[kQTile * kSplit];
  __shared__ int ki[kQTile * kSplit];

  const int split = blockIdx.x;
  const int q0 = blockIdx.y * kQTile;
  const int t = threadIdx.x;
  const int item0 = split * kSplit;

  float acc[kQTile];
#pragma unroll
  for (int r = 0; r < kQTile; ++r) acc[r] = 0.0f;

  for (int d0 = 0; d0 < d; d0 += kDChunk) {
    if (t < kQTile * kDChunk) {
      const int r = t / kDChunk, c = t % kDChunk;
      const int gq = q0 + r, gd = d0 + c;
      qs[r][c] = (gq < q && gd < d) ? qry[static_cast<size_t>(gq) * d + gd] : 0.0f;
    }
    for (int e = t; e < kSplit * kDChunk; e += kThreads) {
      const int r = e / kDChunk, c = e % kDChunk;
      const int gi = item0 + r, gd = d0 + c;
      its[r][c] = (gi < n && gd < d) ? items[static_cast<size_t>(gi) * d + gd] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kDChunk; ++c) {
      const float x = its[t][c];
#pragma unroll
      for (int r = 0; r < kQTile; ++r) acc[r] = fmaf(qs[r][c], x, acc[r]);
    }
    __syncthreads();
  }

  const int item = item0 + t;
  const bool valid = item < n_valid;
#pragma unroll
  for (int r = 0; r < kQTile; ++r) {
    ks[r * kSplit + t] = valid ? acc[r] : -INFINITY;
    ki[r * kSplit + t] = valid ? item : INT_MAX;
  }
  __syncthreads();
  bitonic_sort_rows(ks, ki, kQTile, kSplit);

  for (int e = t; e < kQTile * k2; e += kThreads) {
    const int r = e / k2, i = e % k2;
    const int gq = q0 + r;
    if (gq < q) {
      const size_t o = (static_cast<size_t>(gq) * n_splits + split) * k2 + i;
      out_s[o] = ks[r * kSplit + i];
      out_i[o] = ki[r * kSplit + i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mips_merge_kernel(const float* __restrict__ in_s, const int* __restrict__ in_i,
                  int n_lists, int k2, int group, float* __restrict__ out_s,
                  int* __restrict__ out_i, float* __restrict__ fin_s,
                  long long* __restrict__ fin_i, int k, int final_level) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.x, row = blockIdx.y, n_out = gridDim.x;
  const int first = grp * group;
  const int nl = min(group, n_lists - first);
  int lp = 1;
  while (lp < nl) lp <<= 1;
  float* ss = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(ss + static_cast<size_t>(group) * k2);

  for (int e = threadIdx.x; e < lp * k2; e += blockDim.x) {
    if (e / k2 < nl) {
      const size_t o = (static_cast<size_t>(row) * n_lists + first) * k2 + e;
      ss[e] = in_s[o];
      si[e] = in_i[o];
    } else {
      ss[e] = -INFINITY;
      si[e] = INT_MAX;
    }
  }
  __syncthreads();

  // tree of pairwise merges: list j absorbs list j + step, keeping its best k2
  for (int step = 1; step < lp; step <<= 1) {
    const int pairs = lp / (2 * step);
    for (int e = threadIdx.x; e < pairs * k2; e += blockDim.x) {
      const int p = e / k2, i = e % k2;
      const int a = 2 * step * p * k2 + i;
      const int bb = (2 * step * p + step) * k2 + (k2 - 1 - i);
      if (better(ss[bb], si[bb], ss[a], si[a])) {
        ss[a] = ss[bb];
        si[a] = si[bb];
      }
    }
    __syncthreads();
    // list j is now bitonic and holds the best k2 of both: sort it best first
    const int half = k2 >> 1;
    for (int stride = half; stride > 0; stride >>= 1) {
      for (int e = threadIdx.x; e < pairs * half; e += blockDim.x) {
        const int p = e / half, i = e % half;
        const int lo = 2 * step * p * k2 + 2 * stride * (i / stride) + (i % stride);
        const int hi = lo + stride;
        if (better(ss[hi], si[hi], ss[lo], si[lo])) swap_keys(ss, si, lo, hi);
      }
      __syncthreads();
    }
  }

  if (final_level) {
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      fin_s[static_cast<size_t>(row) * k + i] = ss[i];
      fin_i[static_cast<size_t>(row) * k + i] = si[i];
    }
  } else {
    for (int i = threadIdx.x; i < k2; i += blockDim.x) {
      const size_t o = (static_cast<size_t>(row) * n_out + grp) * k2 + i;
      out_s[o] = ss[i];
      out_i[o] = si[i];
    }
  }
}

int round_up_pow2(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

}  // namespace

// Entries each of the two scratch arrays (f32 scores, int32 ids) must hold.
extern "C" long long mips_topk_scratch_entries(int q, int n, int k) {
  const int k2 = round_up_pow2(k);
  const long long splits = (n + kSplit - 1) / kSplit;
  const long long group = kMergeEntries / k2;
  return static_cast<long long>(q) * k2 * (splits + (splits + group - 1) / group);
}

// queries (q, d) f32, items (n, d) f32, both row-major; out_s (q, k) f32,
// out_i (q, k) int64. Needs 1 <= k <= min(n_valid, 256) and n_valid <= n.
// Returns cudaGetLastError() after the last launch.
extern "C" int mips_topk_fused(const void* queries, const void* items, void* out_s,
                               void* out_i, void* scratch_s, void* scratch_i, int q,
                               int n, int d, int k, int n_valid, int device,
                               void* stream) {
  const int k2 = round_up_pow2(k);
  if (q < 1 || d < 1 || k < 1 || k2 > kSplit || n_valid < k || n_valid > n)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int n_splits = (n + kSplit - 1) / kSplit;
  const int group = kMergeEntries / k2;
  float* buf_s[2] = {static_cast<float*>(scratch_s),
                     static_cast<float*>(scratch_s) + static_cast<size_t>(q) * n_splits * k2};
  int* buf_i[2] = {static_cast<int*>(scratch_i),
                   static_cast<int*>(scratch_i) + static_cast<size_t>(q) * n_splits * k2};

  const dim3 grid1(n_splits, (q + kQTile - 1) / kQTile);
  mips_split_topk_kernel<<<grid1, kThreads, 0, cs>>>(
      static_cast<const float*>(queries), static_cast<const float*>(items), q, n, d,
      n_valid, k2, n_splits, buf_s[0], buf_i[0]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = static_cast<size_t>(group) * k2 * (sizeof(float) + sizeof(int));
  err = cudaFuncSetAttribute(mips_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int lists = n_splits, cur = 0;
  while (true) {
    const int n_out = (lists + group - 1) / group;
    const int final_level = n_out == 1;
    const dim3 grid2(n_out, q);
    mips_merge_kernel<<<grid2, kThreads, smem, cs>>>(
        buf_s[cur], buf_i[cur], lists, k2, group, buf_s[cur ^ 1], buf_i[cur ^ 1],
        static_cast<float*>(out_s), static_cast<long long*>(out_i), k, final_level);
    err = cudaGetLastError();
    if (err != cudaSuccess || final_level) return err;
    lists = n_out;
    cur ^= 1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
