// Kernel B: exact MIPS, f32 matmul + top-k, for Hopper (sm_90a).
//
// Replaces anncur_tpu/ops/mips_pallas.py::_mips_kernel and ::_maxmask_kernel,
// and computes the latent projection + top-k_retvr stage of the fixed-anchor
// query (anncur_tpu/core/retriever.py, `approx = anchor_scores @ latent_cols`
// masked at padded columns, then lax.top_k) and every candidate pick of the
// adaptive engine (anncur_tpu/core/adaptive_fused.py, `approx.at[rows,
// ids].set(-inf)` then lax.top_k):
//     scores = queries @ items^T   (IEEE f32, FFMA, no TF32 tensor cores)
//     top-k per query over columns < n_valid that are not on the query's
//     row of an optional exclusion list, scores descending, ties to the
//     smallest item id, +0.0 above -0.0 (lax.top_k's order); any
//     1 <= k <= n_valid - S for a list of S ids per row.
//
// Int8 items (mips_topk_int8_fused; anncur_tpu/ops/quantized.py::
// mips_topk_int8, an XLA scan there): item rows of int8 values with one f32
// scale each; score = (the same in-order fmaf chain over float(value)) *
// scale, the scale applied once to the finished sum, as JAX applies it.
//
// Bound on the H100: the f32 FMA work, 2*q*n*d operations at 67 TFLOP/s,
// against the bytes of the queries and items read once. At q=32, d=500,
// n=10,000 the items' 20 MB (6 us) bound it; from q ~ 40 on the operations
// do (q=256, n=104,520: 0.40 ms of FFMA against 0.06 ms of bytes). Int8
// items cut the item bytes 4x, which moves the bound only where bytes set
// it: one text (q=1) over a large corpus.
//
// Design. The TPU kernels carry a running top-k from one sequential grid step
// to the next; Hopper runs blocks in parallel and in no order. So two stages,
// run once per chunk of queries whose (chunk, n_valid) score matrix fits a
// fixed scratch budget:
//  1. mips_score_kernel: a register-tiled FFMA GEMM. A block owns up to
//     64 queries x 128 items, each of its 128 threads up to 8 x 8 of them;
//     depth is staged through shared memory in a 2-4 deep cp.async ring:
//     16-byte copies into row-major tiles read as float4 along the depth
//     when d % 4 == 0, else 4-byte copies into transposed tiles. Each score
//     is one in-order fmaf chain over d from +0.0f (so never -0.0). Int8
//     items, when d % 16 == 0: 16-byte cp.async of the int8 tile (a quarter
//     of the f32 tile's bytes), converted exactly to f32 into one shared
//     f32 tile per step (one more barrier), which the f32 loop then reads
//     unchanged; otherwise plain int8 loads converted as they are stored
//     into the transposed f32 tile. The f32 item tile in shared memory is
//     kept so the inner loop, and its register tiling, is the f32 one. Query
//     tiles are the fastest grid axis, so the blocks that share an item tile
//     run together and the items come from HBM about once per chunk. Scores
//     go to an f32 scratch (chunk, ld).
//  2. mips_select_kernel: an exact radix select, one cluster of 1-8 blocks
//     per query row, launched behind the score kernel (programmatic
//     dependent launch) and waiting for its stores. Each block keeps its
//     slice of the row in shared memory as order-preserving 32-bit keys
//     (+0.0 above -0.0, as lax.top_k and the plain sort rank them). Four
//     8-bit digit rounds build 256-bin block histograms (shared-memory
//     atomics: integer counts, order-free); every block sums bin `tid` over
//     the cluster through distributed shared memory, and a suffix scan finds
//     the exact k-th key T and the count c of keys above it. (11-bit digits
//     in three rounds made every block gather 8 x 2048 bins per round, which
//     measured slower.) The first round counts the keys as they load; after
//     it each warp lists its candidates in id order, the keys whose top byte
//     reaches the first digit (every survivor is one; a list that would
//     pass 256 falls back to the warp's whole chunk), and the later rounds
//     and the compaction read only those. The survivors, the keys > T and
//     the first k - c keys == T by id, are compacted in id order by warp
//     ballots and block and cluster prefix sums (no atomics on positions),
//     as 64-bit (key, ~id) words whose descending order is (score desc, id
//     asc). For k <= 1024 every block receives all of them and places its
//     share by rank (the number of survivors before it), writing the
//     output. Above, they go to global scratch and a bitonic sort orders
//     them (mips_sort_chunk_kernel sorts or finishes 8192-word chunks in
//     shared memory, mips_sort_step_kernel runs the strides that span
//     chunks); its last pass writes the output.
// Exclusions: after the score kernel, each select block writes the bits
// 0xFFFFFFFF (a NaN whose key is 0) over the excluded ids of its own slice of
// the scratch row, then loads its keys. The score kernel never writes those
// bits (it stores that one NaN as 0xFFFFFFFE), so every real key is >= 1 and
// an excluded id ranks below every real score, -inf included, and is never
// taken while k <= n_valid - S. No launch is added.
// Output scores are read back from the score scratch at the selected ids, so
// they carry the kernel's own bits. Every kernel runs on the caller's stream
// and device; the wrapper owns outputs and scratch; nothing is allocated here.

#include <cooperative_groups.h>
#include <initializer_list>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

// score stage
constexpr int kScoreThreads = 128;
// select stage
constexpr int kSelThreads = 256;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kBins = 256;              // 8-bit digits, one bin per thread
constexpr int kMaxCluster = 8;          // portable cluster size
constexpr int kSliceTarget = 2048;      // keys per block before the cluster grows
constexpr int kMaxSmemKeys = 40960;     // a longer slice is re-read from the scratch
constexpr int kClusterSortMax = 1024;   // k placed in-cluster by a rank sort
constexpr int kCandCap = 256;           // candidates a warp lists after the first round
// global sort
constexpr int kSortThreads = 512;
constexpr int kSortChunk = 8192;        // 64 KB of 64-bit words
constexpr size_t kScratchBudget = size_t(256) << 20;
// an excluded id's score bits in the scratch: the key-0 NaN
constexpr uint32_t kExcludedBits = 0xFFFFFFFFu;

// -------------------------------------------------------------------------
// stage 1: scores
// -------------------------------------------------------------------------

// A block computes BM queries x BN items with kScoreThreads threads, each
// TM x TN of them, staging BK of depth per step in a ring of STAGES.
// VEC (d % 4 == 0, 16-byte aligned rows): 16-byte cp.async into row-major
// tiles [row][BK + 4], read as float4 along the depth. Else 4-byte cp.async
// into transposed tiles [BK][rows + 4], read as float4 along the rows.
// Either padding keeps the stores and reads free of bank conflicts.
// I8 (int8 items): VEC (d % 16 == 0) stages the items as int8 [BN][BK] and
// converts each step's tile into one f32 [BN][BK + 4] tile after the ring;
// not VEC, they are converted as they load into the transposed f32 tile.
template <bool VEC_, bool I8_, int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_>
struct ScoreTile {
  static constexpr bool VEC = VEC_, I8 = I8_;
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_, STAGES = STAGES_;
  static constexpr int kRows = BM / TM, kCols = BN / TN;  // threads along queries, items
  static_assert(kRows * kCols == kScoreThreads, "one thread per TM x TN outputs");
  static_assert(TN % 4 == 0 && BK % 8 == 0 && BM % 4 == 0 && BN % 4 == 0, "tile shape");
  static_assert(!(VEC && I8) || BK % 16 == 0, "int8 rows move in 16-byte copies");
  static constexpr int kQFloats = VEC ? BM * (BK + 4) : BK * (BM + 4);
  static constexpr int kStageFloats = !VEC ? BK * (BM + BN + 8)
                                      : I8 ? BM * (BK + 4) + BN * BK / 4
                                           : (BM + BN) * (BK + 4);
  static constexpr int kConvFloats = VEC && I8 ? BN * (BK + 4) : 0;  // the converted item tile
  static constexpr size_t kSmemBytes = sizeof(float) * (kStageFloats * STAGES + kConvFloats);
};

// ROWS x BK floats of a row-major (n_rows, d) matrix from row r0, column k0,
// into dst; out-of-range entries become zeros.
template <class T, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ src, int r0,
                                           int n_rows, int k0, int d) {
  constexpr int BK = T::BK;
  if constexpr (T::VEC) {
    // [ROWS][BK + 4]: a warp copies whole 128-byte row segments
    for (int e = threadIdx.x; e < ROWS * (BK / 4); e += kScoreThreads) {
      const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
      const int gr = r0 + r, gk = k0 + c;
      const bool ok = gr < n_rows && gk < d;
      mma_sm90::cp_async_16(mma_sm90::smem_addr(dst + r * (BK + 4) + c),
                            ok ? src + static_cast<size_t>(gr) * d + gk : src, ok ? 16 : 0);
    }
  } else {
    // [BK][ROWS + 4], transposed: a warp copies 4 rows x 8 columns (four
    // 32-byte sectors) into 32 distinct banks
    for (int e = threadIdx.x; e < ROWS * BK; e += kScoreThreads) {
      const int grp = e >> 5, sub = e & 31;
      const int c = (grp % (BK / 8)) * 8 + (sub & 7);
      const int r = (grp / (BK / 8)) * 4 + (sub >> 3);
      float* to = dst + c * (ROWS + 4) + r;
      const int gr = r0 + r, gk = k0 + c;
      if (gr < n_rows && gk < d)
        mma_sm90::cp_async_4(mma_sm90::smem_addr(to), src + static_cast<size_t>(gr) * d + gk);
      else
        *to = 0.0f;
    }
  }
}

// ROWS x BK of a row-major (n_rows, d) int8 matrix from row r0, column k0,
// out-of-range entries zero: VEC, 16-byte cp.async into int8 [ROWS][BK] at
// dst (d % 16 == 0, so a copy never straddles the row's end); else plain
// loads converted to f32 into the transposed tile [BK][ROWS + 4].
template <class T, int ROWS>
__device__ __forceinline__ void stage_tile_i8(float* dst, const int8_t* __restrict__ src, int r0,
                                              int n_rows, int k0, int d) {
  constexpr int BK = T::BK;
  if constexpr (T::VEC) {
    int8_t* dst8 = reinterpret_cast<int8_t*>(dst);
    for (int e = threadIdx.x; e < ROWS * (BK / 16); e += kScoreThreads) {
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
      const int gr = r0 + r, gk = k0 + c;
      const bool ok = gr < n_rows && gk < d;
      mma_sm90::cp_async_16(mma_sm90::smem_addr(dst8 + r * BK + c),
                            ok ? src + static_cast<size_t>(gr) * d + gk : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * BK; e += kScoreThreads) {
      const int grp = e >> 5, sub = e & 31;
      const int c = (grp % (BK / 8)) * 8 + (sub & 7);
      const int r = (grp / (BK / 8)) * 4 + (sub >> 3);
      const int gr = r0 + r, gk = k0 + c;
      dst[c * (ROWS + 4) + r] =
          gr < n_rows && gk < d ? static_cast<float>(src[static_cast<size_t>(gr) * d + gk]) : 0.0f;
    }
  }
}

// grid: 1-D, query tiles fastest. Thread (ty, tx) owns queries ty + kRows*i
// and, VEC, items tx + kCols*j; else items in float4 groups g*BN/(TN/4) + 4*tx.
// items: f32, or int8 with one f32 scale per row (T::I8).
template <class T>
__global__ void __launch_bounds__(kScoreThreads)
mips_score_kernel(const float* __restrict__ qry, const void* __restrict__ items,
                  const float* __restrict__ scales, int q, int n_valid, int d, int ld,
                  float* __restrict__ scores) {
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, BK = T::BK, STAGES = T::STAGES;
  constexpr int kGroupStride = BN / (TN / 4);
  extern __shared__ __align__(16) float smem_f[];
  const int tid = threadIdx.x, tx = tid % T::kCols, ty = tid / T::kCols;
  const int q_tiles = (q + BM - 1) / BM;
  const int q0 = (blockIdx.x % q_tiles) * BM, i0 = (blockIdx.x / q_tiles) * BN;
  const int n_tiles = (d + BK - 1) / BK;

  auto load = [&](int tile) {
    float* st = smem_f + (tile % STAGES) * T::kStageFloats;
    stage_tile<T, BM>(st, qry, q0, q, tile * BK, d);
    if constexpr (T::I8)
      stage_tile_i8<T, BN>(st + T::kQFloats, static_cast<const int8_t*>(items), i0, n_valid, tile * BK, d);
    else
      stage_tile<T, BN>(st + T::kQFloats, static_cast<const float*>(items), i0, n_valid, tile * BK, d);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load(s);
    mma_sm90::cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    mma_sm90::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + STAGES - 1 < n_tiles) load(t + STAGES - 1);
    mma_sm90::cp_async_commit();
    const float* qs = smem_f + (t % STAGES) * T::kStageFloats;
    const float* is = qs + T::kQFloats;
    if constexpr (T::VEC && T::I8) {
      // tile t's int8 items -> the f32 tile (exact); the barrier at the top of
      // the next step keeps it until every thread has read it
      float* conv = smem_f + STAGES * T::kStageFloats;
      const int8_t* i8 = reinterpret_cast<const int8_t*>(is);
      for (int e = tid; e < BN * (BK / 4); e += kScoreThreads) {
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const char4 v = *reinterpret_cast<const char4*>(i8 + r * BK + c);
        *reinterpret_cast<float4*>(conv + r * (BK + 4) + c) =
            make_float4(static_cast<float>(v.x), static_cast<float>(v.y), static_cast<float>(v.z),
                        static_cast<float>(v.w));
      }
      __syncthreads();
      is = conv;
    }
    if constexpr (T::VEC) {
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (ty + T::kRows * i) * (BK + 4) + k4);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          b[j] = *reinterpret_cast<const float4*>(is + (tx + T::kCols * j) * (BK + 4) + k4);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = qs[kk * (BM + 4) + ty + T::kRows * i];
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(is + kk * (BN + 4) + g * kGroupStride + tx * 4);
          b[4 * g] = v.x, b[4 * g + 1] = v.y, b[4 * g + 2] = v.z, b[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  // the select may launch now; it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if constexpr (T::I8) {
    // each item's scale, once, on the finished sum (columns past n_valid: 0)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = i0 + (T::VEC ? tx + T::kCols * j : (j / 4) * kGroupStride + tx * 4 + j % 4);
      const float sc = col < n_valid ? scales[col] : 0.0f;
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][j] *= sc;
    }
  }
  // the exclusion mark's bits are never a score
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (__float_as_uint(acc[i][j]) == kExcludedBits) acc[i][j] = __uint_as_float(kExcludedBits - 1);
  // columns in [n_valid, ld) hold zeros (their item rows were zero-filled)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gq = q0 + ty + T::kRows * i;
    if (gq >= q) continue;
    float* out = scores + static_cast<size_t>(gq) * ld + i0;
    if constexpr (T::VEC) {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (i0 + tx + T::kCols * j < ld) out[tx + T::kCols * j] = acc[i][j];
    } else {
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        if (i0 + g * kGroupStride + tx * 4 < ld)
          *reinterpret_cast<float4*>(out + g * kGroupStride + tx * 4) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  }
}

// the tilings, by queries per chunk (L: > 32, M: 9-32, S: <= 8), by whether
// rows take 16-byte copies (V) or not (W), and by the item type
template <bool I8> using ScoreLV = ScoreTile<true, I8, 64, 128, 8, 8, 32, 2>;
template <bool I8> using ScoreMV = ScoreTile<true, I8, 32, 64, 4, 4, 32, 4>;
template <bool I8> using ScoreSV = ScoreTile<true, I8, 8, 64, 1, 4, 32, 4>;
template <bool I8> using ScoreLW = ScoreTile<false, I8, 64, 128, 8, 8, 16, 3>;
template <bool I8> using ScoreMW = ScoreTile<false, I8, 32, 64, 4, 4, 32, 4>;
template <bool I8> using ScoreSW = ScoreTile<false, I8, 8, 64, 1, 4, 32, 4>;

// -------------------------------------------------------------------------
// stage 2: select
// -------------------------------------------------------------------------

// f32 -> u32 in lax.top_k's order (+0.0 above -0.0); kExcludedBits -> 0
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// descending order of these words is (key desc, id asc); 0 sorts last
__device__ __forceinline__ u64 pack(uint32_t key, int id) {
  return (static_cast<u64>(key) << 32) | static_cast<uint32_t>(~id);
}

__device__ __forceinline__ int unpack_id(u64 w) { return static_cast<int>(~static_cast<uint32_t>(w)); }

// Bitonic sort, descending, of the n (a power of two) words a[0, n) in
// shared memory that sit at index `base` of the whole sequence: every merge
// size up to n (size == 0), or the strides < n of merge size `size`.
// The caller syncs before; the last stride syncs after.
__device__ void bitonic_smem(u64* a, int n, int base, int size) {
  const int sz_hi = size ? size : n;
  for (int sz = size ? size : 2; sz <= sz_hi; sz <<= 1) {
    for (int stride = min(sz, n) >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = 2 * stride * (t / stride) + (t % stride), j = i + stride;
        const bool desc = ((base + i) & sz) == 0;
        const u64 x = a[i], y = a[j];
        if (x != y && (x < y) == desc) a[i] = y, a[j] = x;
      }
      __syncthreads();
    }
  }
}

// Radix select of one query row per cluster (grid = rows x cluster size).
// survivors == nullptr: k <= kClusterSortMax; every block receives all k
// survivors, ranks its share of them and writes the output. Else the k
// survivors (+ kp - k zero words) go to survivors[row * kp ...] for the
// global sort. exclude: n_ex ids per row at a row stride of ex_ld (int64;
// entries outside [0, n_valid) ignored), marked in the scratch first. The
// scratch is written here, so it is read through plain (coherent) loads.
__global__ void __launch_bounds__(kSelThreads)
mips_select_kernel(float* scores, int ld, int n_valid, int k, int kp,
                   int slice, int keys_in_smem, const long long* __restrict__ exclude, int n_ex,
                   long long ex_ld, u64* __restrict__ survivors,
                   float* __restrict__ out_s, long long* __restrict__ out_i) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.x / n_blocks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* srow = scores + static_cast<size_t>(row) * ld;
  const int lo = rank * slice;
  const int m = max(0, min(n_valid, lo + slice) - lo);  // this block's keys

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);  // [2][kBins]
  u64* surv = reinterpret_cast<u64*>(hist + 2 * kBins);  // [k], in-cluster sort only
  uint32_t* keys = reinterpret_cast<uint32_t*>(surv + (survivors ? 0 : k));  // [slice]
  __shared__ uint32_t cand[kSelWarps][kCandCap];
  __shared__ uint32_t warp_sum[kSelWarps];
  __shared__ uint32_t warp_cnt[2][kSelWarps];
  __shared__ uint32_t block_cnt[2];
  __shared__ uint32_t found[2];
  auto key_at = [&](int i) { return keys_in_smem ? keys[i] : order_key(srow[lo + i]); };

  // warp w owns keys [w0, w1) of the slice. After the first round its
  // candidates, the keys whose top byte is at least the first digit (every
  // survivor is one), are cand_at(0 .. n_c - 1) in id order: a list, or
  // the whole chunk where the list would overflow
  const int per_warp = ((m + kSelWarps - 1) / kSelWarps + 31) & ~31;
  const int w0 = warp * per_warp, w1 = min(m, w0 + per_warp);
  const uint32_t below = (1u << lane) - 1u;
  int n_c = max(0, w1 - w0);
  bool listed = false;
  auto cand_at = [&](int j) { return listed ? static_cast<int>(cand[warp][j]) : w0 + j; };

  hist[tid] = 0;  // the first round's buffer
  __syncthreads();
  // launched early behind the score kernel: wait for its scores
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (n_ex > 0) {
    // mark this block's excluded ids; only this block reads its slice
    const long long* ex = exclude + static_cast<size_t>(row) * ex_ld;
    for (int j = tid; j < n_ex; j += kSelThreads) {
      const long long id = ex[j];
      if (id >= lo && id < lo + m) srow[id] = __uint_as_float(kExcludedBits);
    }
    __syncthreads();
  }
#pragma unroll 4
  for (int i = tid; i < m; i += kSelThreads) {
    const uint32_t key = order_key(srow[lo + i]);
    if (keys_in_smem) keys[i] = key;
    atomicAdd(&hist[key >> 24], 1u);
  }

  // four 8-bit digit rounds, most significant first: after them T = prefix,
  // and the k_rem first keys == T (by id) are taken
  uint32_t prefix = 0, pmask = 0;
  uint32_t k_rem = static_cast<uint32_t>(k);
  for (int round = 0; round < 4; ++round) {
    const int shift = 24 - 8 * round;
    uint32_t* h = hist + (round & 1) * kBins;  // double-buffered: see the sync below
    if (round > 0) {
      h[tid] = 0;
      __syncthreads();
      for (int j = lane; j < n_c; j += 32) {
        const uint32_t key = key_at(cand_at(j));
        if ((key & pmask) == prefix) atomicAdd(&h[(key >> shift) & (kBins - 1)], 1u);
      }
    }
    // every block's histogram is complete; each block also finished reading
    // the other buffer (round - 1) before arriving, so the next round may
    // clear it
    cluster.sync();

    // bin `tid` summed over the cluster, then the keys in the bins above it
    uint32_t s = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_blocks) s += cluster.map_shared_rank(h, r)[tid];
    uint32_t above = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t v = __shfl_down_sync(0xffffffffu, above, off);
      if (lane + off < 32) above += v;
    }
    if (lane == 0) warp_sum[warp] = above;
    __syncthreads();
    above -= s;
    for (int w = warp + 1; w < kSelWarps; ++w) above += warp_sum[w];
    if (above < k_rem && k_rem <= above + s) {  // exactly one bin
      found[0] = static_cast<uint32_t>(tid);
      found[1] = above;
    }
    __syncthreads();
    prefix |= found[0] << shift;
    pmask |= static_cast<uint32_t>(kBins - 1) << shift;
    k_rem -= found[1];
    if (round == 0) {
      int n_pick = 0;
#pragma unroll 4
      for (int base = w0; base < w1; base += 32) {
        const int i = base + lane;
        const bool pick = i < w1 && (key_at(i) >> 24) >= found[0];
        const uint32_t ballot = __ballot_sync(0xffffffffu, pick);
        const int at = n_pick + __popc(ballot & below);
        if (pick && at < kCandCap) cand[warp][at] = static_cast<uint32_t>(i);
        n_pick += __popc(ballot);
      }
      __syncwarp();
      listed = n_pick <= kCandCap;
      if (listed) n_c = n_pick;
    }
  }
  const uint32_t T = prefix;
  const int c = k - static_cast<int>(k_rem);  // keys > T, all taken

  // compaction in id order, over each warp's candidates
  uint32_t n_gt = 0, n_eq = 0;
  for (int base = 0; base < n_c; base += 32) {
    const int j = base + lane;
    const uint32_t key = j < n_c ? key_at(cand_at(j)) : 0u;
    n_gt += __popc(__ballot_sync(0xffffffffu, j < n_c && key > T));
    n_eq += __popc(__ballot_sync(0xffffffffu, j < n_c && key == T));
  }
  if (lane == 0) warp_cnt[0][warp] = n_gt, warp_cnt[1][warp] = n_eq;
  __syncthreads();
  if (tid == 0) {
    uint32_t g = 0, e = 0;
    for (int w = 0; w < kSelWarps; ++w) g += warp_cnt[0][w], e += warp_cnt[1][w];
    block_cnt[0] = g, block_cnt[1] = e;
  }
  cluster.sync();
  uint32_t o_gt = 0, o_eq = 0;  // this warp's first positions
  for (int r = 0; r < rank; ++r) {
    const uint32_t* bc = cluster.map_shared_rank(&block_cnt[0], r);
    o_gt += bc[0], o_eq += bc[1];
  }
  for (int w = 0; w < warp; ++w) o_gt += warp_cnt[0][w], o_eq += warp_cnt[1][w];

  // a survivor goes to every block's shared memory, or once to global memory
  auto put = [&](uint32_t pos, u64 word) {
    if (survivors) {
      survivors[static_cast<size_t>(row) * kp + pos] = word;
      return;
    }
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n_blocks) cluster.map_shared_rank(surv, r)[pos] = word;
  };
  for (int base = 0; base < n_c; base += 32) {
    const int j = base + lane;
    const int i = j < n_c ? cand_at(j) : 0;
    const uint32_t key = j < n_c ? key_at(i) : 0u;
    const bool gt = j < n_c && key > T, eq = j < n_c && key == T;
    const uint32_t b_gt = __ballot_sync(0xffffffffu, gt), b_eq = __ballot_sync(0xffffffffu, eq);
    if (gt) put(o_gt + __popc(b_gt & below), pack(key, lo + i));
    if (eq) {
      const uint32_t r = o_eq + __popc(b_eq & below);
      if (r < k_rem) put(c + r, pack(key, lo + i));
    }
    o_gt += __popc(b_gt), o_eq += __popc(b_eq);
  }
  if (survivors && rank == 0)
    for (int i = k + tid; i < kp; i += kSelThreads) survivors[static_cast<size_t>(row) * kp + i] = 0;
  // survivors written; no block leaves while another reads its block_cnt
  cluster.sync();
  if (survivors) return;

  // rank sort: a survivor's place is the number of survivors before it in
  // (score desc, id asc); block `rank` places survivors [s0, s1), tps
  // threads of one warp per survivor
  const int share = (k + n_blocks - 1) / n_blocks;
  const int s0 = rank * share, s1 = min(k, s0 + share);
  int tps = 1;
  while (tps < 32 && 2 * tps * share <= kSelThreads) tps <<= 1;
  for (int base = s0; base < s1; base += kSelThreads / tps) {
    const int i = base + tid / tps;
    uint32_t place = 0;
    u64 w = 0;
    if (i < s1) {
      w = surv[i];
      for (int j = tid % tps; j < k; j += tps) place += surv[j] > w;
    }
    for (int off = 1; off < tps; off <<= 1) place += __shfl_xor_sync(0xffffffffu, place, off);
    if (i < s1 && tid % tps == 0) {
      const int id = unpack_id(w);
      out_s[static_cast<size_t>(row) * k + place] = srow[id];
      out_i[static_cast<size_t>(row) * k + place] = id;
    }
  }
}

// One chunk of a row's survivors (grid = chunks x rows) through shared
// memory: the whole bitonic sort up to the chunk (size == 0) or the strides
// below the chunk of merge size `size`. out_s != nullptr: the last pass,
// which writes the first k as the output.
__global__ void __launch_bounds__(kSortThreads)
mips_sort_chunk_kernel(u64* __restrict__ survivors, int kp, int chunk, int size,
                       const float* __restrict__ scores, int ld, int k,
                       float* __restrict__ out_s, long long* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* a = reinterpret_cast<u64*>(smem);
  const int row = blockIdx.y, base = blockIdx.x * chunk;
  u64* g = survivors + static_cast<size_t>(row) * kp + base;
  for (int i = threadIdx.x; i < chunk; i += kSortThreads) a[i] = g[i];
  __syncthreads();
  bitonic_smem(a, chunk, base, size);
  if (out_s == nullptr) {
    for (int i = threadIdx.x; i < chunk; i += kSortThreads) g[i] = a[i];
    return;
  }
  const float* srow = scores + static_cast<size_t>(row) * ld;
  for (int i = threadIdx.x; i < chunk && base + i < k; i += kSortThreads) {
    const int id = unpack_id(a[i]);
    out_s[static_cast<size_t>(row) * k + base + i] = srow[id];
    out_i[static_cast<size_t>(row) * k + base + i] = id;
  }
}

// One stride >= the chunk of merge size `size`, over global memory
// (grid = pair blocks x rows).
__global__ void __launch_bounds__(kSortThreads)
mips_sort_step_kernel(u64* __restrict__ survivors, int kp, int size, int stride) {
  const int t = blockIdx.x * kSortThreads + threadIdx.x;
  if (t >= kp / 2) return;
  u64* a = survivors + static_cast<size_t>(blockIdx.y) * kp;
  const int i = 2 * stride * (t / stride) + (t % stride), j = i + stride;
  const bool desc = (i & size) == 0;
  const u64 x = a[i], y = a[j];
  if (x != y && (x < y) == desc) a[i] = y, a[j] = x;
}

// -------------------------------------------------------------------------
// host side
// -------------------------------------------------------------------------

struct Plan {
  int ld;          // score scratch row stride (n_valid rounded up to 4)
  int kp;          // k rounded up to a power of two
  int large;       // kp > kClusterSortMax: survivors sorted in global memory
  int qc;          // queries per chunk
  int cluster;     // blocks per query row in the select
  int slice;       // keys per select block
  int keys_in_smem;
  size_t sel_smem;
  size_t score_bytes, surv_bytes;
};

Plan make_plan(int q, int n_valid, int k) {
  Plan p;
  p.ld = (n_valid + 3) & ~3;
  p.kp = 1;
  while (p.kp < k) p.kp <<= 1;
  p.large = k > kClusterSortMax;
  const size_t per_query = sizeof(float) * p.ld + (p.large ? sizeof(u64) * p.kp : 0);
  size_t qc = kScratchBudget / per_query;
  qc = qc < 1 ? 1 : qc;
  qc = qc > static_cast<size_t>(q) ? q : qc;
  if (qc > 64) qc -= qc % 64;
  p.qc = static_cast<int>(qc < 65535 ? qc : 65535);
  p.cluster = 1;
  while (p.cluster < kMaxCluster && (n_valid + p.cluster - 1) / p.cluster > kSliceTarget)
    p.cluster <<= 1;
  p.slice = (n_valid + p.cluster - 1) / p.cluster;
  p.keys_in_smem = p.slice <= kMaxSmemKeys;
  p.sel_smem = sizeof(uint32_t) * 2 * kBins + (p.large ? 0 : sizeof(u64) * k) +
               (p.keys_in_smem ? sizeof(uint32_t) * p.slice : 0);
  p.score_bytes = (sizeof(float) * p.qc * p.ld + 255) & ~size_t(255);
  p.surv_bytes = p.large ? sizeof(u64) * p.qc * p.kp : 0;
  return p;
}

template <class T>
cudaError_t launch_score(const float* qry, const void* items, const float* scales, int rows, int n_valid,
                         int d, int ld, float* scores, cudaStream_t cs) {
  const int blocks = ((rows + T::BM - 1) / T::BM) * ((n_valid + T::BN - 1) / T::BN);
  mips_score_kernel<T><<<blocks, kScoreThreads, T::kSmemBytes, cs>>>(qry, items, scales, rows, n_valid, d,
                                                                      ld, scores);
  return cudaGetLastError();
}

// the score stage of one chunk of rows, by tiling
template <bool I8>
cudaError_t launch_score_chunk(bool vec, const float* qry, const void* items, const float* scales, int rows,
                               int n_valid, int d, int ld, float* scores, cudaStream_t cs) {
  if (vec)
    return rows > 32 ? launch_score<ScoreLV<I8>>(qry, items, scales, rows, n_valid, d, ld, scores, cs)
           : rows > 8 ? launch_score<ScoreMV<I8>>(qry, items, scales, rows, n_valid, d, ld, scores, cs)
                      : launch_score<ScoreSV<I8>>(qry, items, scales, rows, n_valid, d, ld, scores, cs);
  return rows > 32 ? launch_score<ScoreLW<I8>>(qry, items, scales, rows, n_valid, d, ld, scores, cs)
         : rows > 8 ? launch_score<ScoreMW<I8>>(qry, items, scales, rows, n_valid, d, ld, scores, cs)
                    : launch_score<ScoreSW<I8>>(qry, items, scales, rows, n_valid, d, ld, scores, cs);
}

template <class T>
cudaError_t allow_score_smem() {
  return cudaFuncSetAttribute(mips_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(T::kSmemBytes));
}

}  // namespace

// Kernel attributes (dynamic shared memory above 48 KB): once per device,
// with that device current. Returns the first CUDA error.
extern "C" int mips_topk_init() {
  cudaError_t err = cudaSuccess;
  for (cudaError_t e : {allow_score_smem<ScoreLV<false>>(), allow_score_smem<ScoreMV<false>>(),
                        allow_score_smem<ScoreSV<false>>(), allow_score_smem<ScoreLW<false>>(),
                        allow_score_smem<ScoreMW<false>>(), allow_score_smem<ScoreSW<false>>(),
                        allow_score_smem<ScoreLV<true>>(), allow_score_smem<ScoreMV<true>>(),
                        allow_score_smem<ScoreSV<true>>(), allow_score_smem<ScoreLW<true>>(),
                        allow_score_smem<ScoreMW<true>>(), allow_score_smem<ScoreSW<true>>()})
    if (err == cudaSuccess) err = e;
  const int sel_max = static_cast<int>(sizeof(uint32_t) * (2 * kBins + kMaxSmemKeys) +
                                       sizeof(u64) * kClusterSortMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mips_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sel_max);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mips_sort_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(u64) * kSortChunk));
  return err;
}

// Bytes of device scratch that mips_topk_fused needs for these sizes.
extern "C" long long mips_topk_scratch_bytes(int q, int n_valid, int k) {
  const Plan p = make_plan(q, n_valid, k);
  return static_cast<long long>(p.score_bytes + p.surv_bytes);
}

namespace {

// Both entries: the score stage of each chunk of queries (f32 or int8
// items), then the select and, for k > kClusterSortMax, the global sort.
template <bool I8>
int run_mips_topk(const void* queries, const void* items, const float* scales, void* out_s, void* out_i,
                  const void* exclude, int n_ex, long long ex_ld, void* scratch, long long scratch_bytes,
                  int q, int n, int d, int k, int n_valid, void* stream) {
  if (q < 1 || d < 1 || k < 1 || n_valid > n || n_ex < 0 || k > n_valid - n_ex ||
      (n_ex > 0 && exclude == nullptr) || (I8 && scales == nullptr))
    return cudaErrorInvalidValue;
  const Plan p = make_plan(q, n_valid, k);
  if (scratch_bytes < static_cast<long long>(p.score_bytes + p.surv_bytes)) return cudaErrorInvalidValue;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* scores = static_cast<float*>(scratch);
  u64* surv = p.large ? reinterpret_cast<u64*>(static_cast<unsigned char*>(scratch) + p.score_bytes) : nullptr;
  const int chunk = p.kp < kSortChunk ? p.kp : kSortChunk;
  // 16-byte rows: every f32 row starts 16-byte aligned when d % 4 == 0, an
  // int8 row when d % 16 == 0
  const bool vec = d % (I8 ? 16 : 4) == 0 && reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(items) % 16 == 0;

  for (int q0 = 0; q0 < q; q0 += p.qc) {
    const int rows = q - q0 < p.qc ? q - q0 : p.qc;
    const float* qry = static_cast<const float*>(queries) + static_cast<size_t>(q0) * d;
    float* os = static_cast<float*>(out_s) + static_cast<size_t>(q0) * k;
    long long* oi = static_cast<long long*>(out_i) + static_cast<size_t>(q0) * k;
    const long long* ex = n_ex > 0 ? static_cast<const long long*>(exclude) + q0 * ex_ld : nullptr;

    cudaError_t err = launch_score_chunk<I8>(vec, qry, items, scales, rows, n_valid, d, p.ld, scores, cs);
    if (err != cudaSuccess) return err;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(rows * p.cluster);
    cfg.blockDim = dim3(kSelThreads);
    cfg.dynamicSmemBytes = p.sel_smem;
    cfg.stream = cs;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // see griddepcontrol
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    err = cudaLaunchKernelEx(&cfg, mips_select_kernel, scores, p.ld, n_valid, k, p.kp, p.slice,
                             p.keys_in_smem, ex, n_ex, ex_ld, surv, os, oi);
    if (err != cudaSuccess) return err;
    if (!p.large) continue;

    const size_t chunk_smem = sizeof(u64) * chunk;
    const dim3 chunks(p.kp / chunk, rows), pairs((p.kp / 2 + kSortThreads - 1) / kSortThreads, rows);
    const bool one_pass = p.kp == chunk;
    mips_sort_chunk_kernel<<<chunks, kSortThreads, chunk_smem, cs>>>(
        surv, p.kp, chunk, 0, scores, p.ld, k, one_pass ? os : nullptr, oi);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int size = 2 * chunk; size <= p.kp; size <<= 1) {
      for (int stride = size / 2; stride >= chunk; stride >>= 1) {
        mips_sort_step_kernel<<<pairs, kSortThreads, 0, cs>>>(surv, p.kp, size, stride);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
      mips_sort_chunk_kernel<<<chunks, kSortThreads, chunk_smem, cs>>>(
          surv, p.kp, chunk, size, scores, p.ld, k, size == p.kp ? os : nullptr, oi);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// queries (q, d) f32, items (n, d) f32, both row-major; out_s (q, k) f32,
// out_i (q, k) int64; scratch of mips_topk_scratch_bytes(q, n_valid, k)
// bytes, 256-byte aligned; exclude: null (n_ex = 0) or n_ex int64 ids per
// query at a row stride of ex_ld elements. Needs 1 <= k <= n_valid - n_ex
// and n_valid <= n. Launches on `stream` of the current device. Returns the
// first CUDA error.
extern "C" int mips_topk_fused(const void* queries, const void* items, void* out_s, void* out_i,
                               const void* exclude, int n_ex, long long ex_ld, void* scratch,
                               long long scratch_bytes, int q, int n, int d, int k, int n_valid,
                               void* stream) {
  return run_mips_topk<false>(queries, items, nullptr, out_s, out_i, exclude, n_ex, ex_ld, scratch,
                              scratch_bytes, q, n, d, k, n_valid, stream);
}

// The same over int8 items (n, d) row-major with f32 scales (n,): score =
// the f32 dot of the query and the int8 row, times the row's scale.
extern "C" int mips_topk_int8_fused(const void* queries, const void* items, const void* scales,
                                    void* out_s, void* out_i, const void* exclude, int n_ex,
                                    long long ex_ld, void* scratch, long long scratch_bytes, int q, int n,
                                    int d, int k, int n_valid, void* stream) {
  return run_mips_topk<true>(queries, items, static_cast<const float*>(scales), out_s, out_i, exclude, n_ex,
                             ex_ld, scratch, scratch_bytes, q, n, d, k, n_valid, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
