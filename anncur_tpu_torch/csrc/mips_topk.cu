// Kernel B: exact MIPS, f32 matmul + top-k, for Hopper (sm_90a).
//
// Replaces anncur_tpu/ops/mips_pallas.py::_mips_kernel and ::_maxmask_kernel,
// and computes the latent projection + top-k_retvr stage of the fixed-anchor
// query (anncur_tpu/core/retriever.py, `approx = anchor_scores @ latent_cols`
// masked at padded columns, then lax.top_k) and every candidate pick of the
// adaptive engine (anncur_tpu/core/adaptive_fused.py, `approx.at[rows,
// ids].set(-inf)` then lax.top_k):
//     scores = queries @ items^T   (f32-accurate: an IEEE FFMA chain, or
//                                   three TF32 passes on the tensor cores,
//                                   never one TF32 or bf16 pass)
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
// Bound on the H100: 2*q*n*d operations as an f32-accurate product, three
// TF32 passes at 495 TFLOP/s (165 TFLOP/s of f32 work, 2.5x the 67 TFLOP/s
// of FFMA), against the bytes of the queries and items read once. At q=32,
// d=500, n=10,000 the items' 20 MB (6 us) bound it; from q ~ 100 on the
// operations do (q=256, n=104,520: 0.16 ms on the tensor cores, 0.40 ms of
// FFMA, against 0.06 ms of bytes; ZeShEL-military's 13,063 x 104,520 x 768:
// 12.7 ms, 31.3 ms by FFMA). Int8 items cut the item bytes 4x, which moves
// the bound only where bytes set it: one text (q=1) over a large corpus.
//
// Numerics. The reference asks the TPU for precision="highest"
// (mips_pallas.py:129-133, :176-178), which its matrix unit carries out as
// several bf16 passes. Here every score is f32-accurate: an in-order FFMA
// chain, or on the tensor cores x = big + small for each operand (big =
// tf32(x) by cvt.rna for a query, the raw f32 for an item, whose low 13
// bits the tensor cores drop; small = tf32(x - big)), and per 8 of depth S +=
// small_q big_i + big_q small_i + big_q big_i (small terms first; the
// dropped small_q small_i is below 2^-22 of the product). The tensor cores
// truncate as they accumulate, so each 32-deep stage's sum is kept apart
// and added to the score in f32 (round to nearest): the error against an
// f64 product stays within that of an f32 matmul
// (tests/test_torch_mips_split.py emulates it; chip_smoke.py holds the
// kernel at 4x the plain matmul's at the hard-negative mine and
// ZeShEL-military). Small integers (every card test's exact equality) are
// tf32 with small = 0 and sum exactly.
//
// Design. The TPU kernels carry a running top-k from one sequential grid step
// to the next; Hopper runs blocks in parallel and in no order. So two stages,
// run once per chunk of queries whose (chunk, n_valid) score matrix fits a
// fixed scratch budget:
//  1. mips_score_tc_kernel, for f32 items when rows take 16-byte copies
//     (d % 4 == 0, aligned bases) and a chunk has more than 32 queries: the
//     three TF32 passes on wgmma m64n128k8 (tc:: below). One persistent
//     block an SM walks the chunk's 128-query x 128-item tiles, query tiles
//     fastest; 2-D TMA fills a 4-stage ring of 128-byte-swizzled tiles 32
//     f32 deep (zero past d, past the chunk's rows and past n_valid); two
//     split warps write each item tile's small parts beside it (the raw
//     tile is its big part: TF32 wgmma drops the low 13 bits); two
//     consumer warpgroups of 64 queries split their query fragments in
//     registers, take the item tiles from shared memory by descriptor, and
//     add each stage's sum into f32 registers from +0.0 (so never -0.0).
//     Ties keep their meaning: a duplicated item row scores the same bits
//     wherever it sits (every output of a product is the same sum of the
//     same terms). Every other chunk and the int8 entry take
//     mips_score_kernel, a register-tiled FFMA GEMM. A block owns up to
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
// the scratch row, then loads its keys. Neither score kernel writes those
// bits (each stores that one NaN as 0xFFFFFFFE), so every real key is >= 1 and
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
#include "wgmma_sm90.cuh"

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
// rows take 16-byte copies (V) or not (W), and by the item type; f32 items
// at L with V take the tensor-core kernel below instead, so only int8 uses
// ScoreLV
template <bool I8> using ScoreLV = ScoreTile<true, I8, 64, 128, 8, 8, 32, 2>;
template <bool I8> using ScoreMV = ScoreTile<true, I8, 32, 64, 4, 4, 32, 4>;
template <bool I8> using ScoreSV = ScoreTile<true, I8, 8, 64, 1, 4, 32, 4>;
template <bool I8> using ScoreLW = ScoreTile<false, I8, 64, 128, 8, 8, 16, 3>;
template <bool I8> using ScoreMW = ScoreTile<false, I8, 32, 64, 4, 4, 32, 4>;
template <bool I8> using ScoreSW = ScoreTile<false, I8, 8, 64, 1, 4, 32, 4>;

// -------------------------------------------------------------------------
// stage 1 on the tensor cores: f32-accurate scores in three TF32 passes
// -------------------------------------------------------------------------

namespace tc {

using namespace wgmma_sm90;

constexpr int kBM = 128;                     // queries of a tile: two consumer warpgroups of 64
constexpr int kBN = 128;                     // items of a tile
constexpr int kBK = 32;                      // depth of a stage: one 128-byte row of f32
constexpr int kStages = 4;                   // depth of the ring
constexpr int kSplitWarps = 2;               // warps that split the item tiles (the first issues TMA)
constexpr int kThreads = 256 + 32 * kSplitWarps;
constexpr int kQBytes = kBM * kBK * 4;       // a stage's query tile
constexpr int kIBytes = kBN * kBK * 4;       // its item tile, and again the items' small parts
constexpr int kStageBytes = kQBytes + 2 * kIBytes;
constexpr int kBars = kStages * kStageBytes;
constexpr int kSmem = kBars + 3 * kStages * 8 + 1024;  // + room to align to 1024 bytes

// Scores of every (query tile, item tile) of a chunk, one block an SM
// walking the tiles (query tiles fastest, so the blocks that run together
// share an item tile); per tile the depth streams through a ring of
// kStages stages. Warps 8 and up split: lane 0 of warp 8 keeps TMA loads of
// the query and item tiles kStages stages ahead (full), then they write each
// item's small part beside the item tile and signal ready. Warpgroups 0 and
// 1 own 64 queries each: per stage, each of their threads splits its query
// fragments in registers and issues, per k-step of 8, S += small_q big_i +
// big_q small_i + big_q big_i (small terms first) into a stage accumulator,
// waits, releases the stage (empty) and adds the stage's sum to the tile's
// f32 sum. The tensor cores truncate as they accumulate: the stage's sum is
// what keeps the score f32-accurate (one accumulator over the whole depth
// measured 4.6x and 5.7x the f32 matmul's error against f64 at the mine and
// ZeShEL-military, cli/time_kernels.py; the stage sums 0.27x and 0.30x).
__global__ void __launch_bounds__(kThreads, 1)
mips_score_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap imap, int q,
                     int n_valid, int d, int ld, float* __restrict__ scores) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBars);  // [kStages] a stage's tiles landed
  uint64_t* ready = full + kStages;                            // [kStages] its small parts written
  uint64_t* empty = ready + kStages;                           // [kStages] both warpgroups are done with it
  const int tid = threadIdx.x, lane = tid & 31;
  // 0, 1: the consumer warpgroups; 2: the split warps (uniform in a warp, as
  // the compiler is told, so no wgmma sits in divergent code)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q_tiles = (q + kBM - 1) / kBM;
  const int n_tiles = q_tiles * ((n_valid + kBN - 1) / kBN);
  const int n_k = (d + kBK - 1) / kBK;
  const int total = ((n_tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) /
                     static_cast<int>(gridDim.x)) * n_k;  // this block's stages
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(ready + i, 32 * kSplitWarps);
      mbar_init(empty + i, 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (role == 2) {
    const int ptid = tid - 256;
    // stage f of this block: tile blockIdx.x + (f / n_k) gridDim.x, depth f % n_k
    auto issue = [&](int f, bool on) {
      const int tile = blockIdx.x + (f / n_k) * gridDim.x, kt = f % n_k, s = f % kStages;
      unsigned char* st = smem + s * kStageBytes;
      mbar_arrive_expect_tx(full + s, kQBytes + kIBytes, on);
      tma_load_2d(st, &qmap, full + s, kt * kBK, (tile % q_tiles) * kBM, on);
      tma_load_2d(st + kQBytes, &imap, full + s, kt * kBK, (tile / q_tiles) * kBN, on);
    };
    for (int f = 0; f < kStages && f < total; ++f) issue(f, ptid == 0);
    for (int f = 0; f < total; ++f) {
      const int s = f % kStages;
      unsigned char* st = smem + s * kStageBytes;
      mbar_wait(full + s, (f / kStages) & 1);
      const float4* items = reinterpret_cast<const float4*>(st + kQBytes);
      float4* small = reinterpret_cast<float4*>(st + kQBytes + kIBytes);
#pragma unroll 4
      for (int i = ptid; i < kIBytes / 16; i += 32 * kSplitWarps) {
        const float4 x = items[i];
        small[i] = make_float4(tf32_small(x.x), tf32_small(x.y), tf32_small(x.z), tf32_small(x.w));
      }
      fence_proxy_async();
      mbar_arrive(ready + s, true);
      // the stage of f - 1, once both warpgroups are done with it, takes f - 1 + kStages
      if (f >= 1 && f - 1 + kStages < total) {
        mbar_wait(empty + (f - 1) % kStages, ((f - 1) / kStages) & 1);
        issue(f - 1 + kStages, ptid == 0);
      }
    }
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    return;
  }

  // this thread's query rows in a tile: qrow and qrow + 8; its fragment
  // columns t and t + 4 of each k-step
  const int warp = (tid / 32) % 4, r = lane >> 2, t = lane & 3;
  const int qrow = 64 * role + 16 * warp + r;
  int f = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;  // +0.0: a score is never -0.0 from an empty sum
    for (int kt = 0; kt < n_k; ++kt, ++f) {
      const int s = f % kStages;
      const unsigned char* st = smem + s * kStageBytes;
      mbar_wait(ready + s, (f / kStages) & 1);
      // per k-step of 8: the query fragments split in registers, big =
      // tf32(x) and small = tf32(x - big), then the three products into the
      // stage's sum, committed as a group; two k-steps' fragments live, one
      // group in flight while the next is issued
      const uint32_t big_i = smem_u32(st + kQBytes), small_i = big_i + kIBytes;
      float part[64];  // the first product overwrites it
      uint32_t qb0[4], qs0[4], qb1[4], qs1[4];
      auto issue_k = [&](int kk, uint32_t (&qb)[4], uint32_t (&qs)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = qrow + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
          const float x = *reinterpret_cast<const float*>(st + row * 128 + (((col >> 2) ^ (row & 7)) << 4) + (col & 3) * 4);
          qb[i] = tf32_rna(x);
          qs[i] = tf32_rna(x - __uint_as_float(qb[i]));
        }
        wgmma_fence();
        mma_tf32_rs(part, qs, desc_sw128(big_i + 32 * kk), kk);
        mma_tf32_rs(part, qb, desc_sw128(small_i + 32 * kk), 1);
        mma_tf32_rs(part, qb, desc_sw128(big_i + 32 * kk), 1);
        wgmma_commit();
      };
      issue_k(0, qb0, qs0);
      issue_k(1, qb1, qs1);
      wgmma_wait<1>();
      keep(qb0);
      keep(qs0);
      issue_k(2, qb0, qs0);
      wgmma_wait<1>();
      keep(qb1);
      keep(qs1);
      issue_k(3, qb1, qs1);
      wgmma_wait<0>();
      keep(part);
      keep(qb0);
      keep(qs0);
      keep(qb1);
      keep(qs1);
      mbar_arrive(empty + s, lane == 0);
      // each stage's sum rounded once into the tile's sum
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    // the exclusion mark's bits are never a score; columns in [n_valid, ld)
    // hold zeros (TMA zero-fills the item rows past n_valid)
    const int q0 = (tile % q_tiles) * kBM, i0 = (tile / q_tiles) * kBN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + qrow + 8 * h;
      float* out = scores + static_cast<size_t>(row < q ? row : 0) * ld + i0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (__float_as_uint(v.x) == kExcludedBits) v.x = __uint_as_float(kExcludedBits - 1);
        if (__float_as_uint(v.y) == kExcludedBits) v.y = __uint_as_float(kExcludedBits - 1);
        if (row < q && i0 + 8 * j + 2 * t < ld) *reinterpret_cast<float2*>(out + 8 * j + 2 * t) = v;
      }
    }
  }
  // the select may launch now; it waits for this grid's stores
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// One m64n128k8 product of raw f32 bits, the way the score kernel reads
// its operands (A a register fragment, B a 128-byte-swizzled K-major tile):
// d (64 x 128) = a (64 x 8) b^T (b: 128 x 8), both row-major. A probe for
// tests/test_torch_cuda.py: what TF32 wgmma does with the low 13 bits of
// each f32, and the fragment layouts above.
__global__ void __launch_bounds__(128) tf32_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                                         float* __restrict__ d) {
  __shared__ __align__(1024) float tile[kBN * 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, r = lane >> 2, t = lane & 3;
  for (int i = tid; i < kBN * 32; i += 128) {
    const int row = i / 32, col = i % 32;
    tile[row * 32 + (((col >> 2) ^ (row & 7)) << 2) + (col & 3)] = col < 8 ? b[row * 8 + col] : 0.0f;
  }
  fence_proxy_async();
  __syncthreads();
  uint32_t frag[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) frag[i] = __float_as_uint(a[(16 * warp + r + 8 * (i & 1)) * 8 + t + 4 * (i >> 1)]);
  float acc[64];
  wgmma_fence();
  mma_tf32_rs(acc, frag, desc_sw128(smem_u32(tile)), 0);
  wgmma_commit();
  wgmma_wait<0>();
  keep(acc);
  keep(frag);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[(16 * warp + r + 8 * (e >> 1)) * kBN + 8 * j + 2 * t + (e & 1)] = acc[4 * j + e];
}

}  // namespace tc

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

// the tensor-core score stage of one chunk of rows (f32 items, d % 4 == 0,
// 16-byte aligned bases): one block an SM at most
cudaError_t launch_score_tc(const float* qry, const float* items, int rows, int n_valid, int d, int ld,
                            float* scores, cudaStream_t cs) {
  CUtensorMap qmap, imap;
  cudaError_t err = wgmma_sm90::make_f32_matrix_map(&qmap, qry, rows, d, tc::kBM);
  if (err == cudaSuccess) err = wgmma_sm90::make_f32_matrix_map(&imap, items, n_valid, d, tc::kBN);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = ((rows + tc::kBM - 1) / tc::kBM) * ((n_valid + tc::kBN - 1) / tc::kBN);
  tc::mips_score_tc_kernel<<<tiles < sms ? tiles : sms, tc::kThreads, tc::kSmem, cs>>>(qmap, imap, rows, n_valid,
                                                                                        d, ld, scores);
  return cudaGetLastError();
}

// the score stage of one chunk of rows, by tiling: f32 items with 16-byte
// rows and more than 32 rows on the tensor cores (counted in *tc_chunks),
// the rest by FFMA
template <bool I8>
cudaError_t launch_score_chunk(bool vec, const float* qry, const void* items, const float* scales, int rows,
                               int n_valid, int d, int ld, float* scores, int* tc_chunks, cudaStream_t cs) {
  if (vec && rows > 32) {
    if constexpr (I8) {
      return launch_score<ScoreLV<true>>(qry, items, scales, rows, n_valid, d, ld, scores, cs);
    } else {
      ++*tc_chunks;
      return launch_score_tc(qry, static_cast<const float*>(items), rows, n_valid, d, ld, scores, cs);
    }
  }
  if (vec)
    return rows > 8 ? launch_score<ScoreMV<I8>>(qry, items, scales, rows, n_valid, d, ld, scores, cs)
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
  for (cudaError_t e : {cudaFuncSetAttribute(tc::mips_score_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             tc::kSmem),
                        allow_score_smem<ScoreMV<false>>(),
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
                  int q, int n, int d, int k, int n_valid, int* tc_chunks, void* stream) {
  if (q < 1 || d < 1 || k < 1 || n_valid > n || n_ex < 0 || k > n_valid - n_ex ||
      (n_ex > 0 && exclude == nullptr) || (I8 && scales == nullptr))
    return cudaErrorInvalidValue;
  const Plan p = make_plan(q, n_valid, k);
  if (scratch_bytes < static_cast<long long>(p.score_bytes + p.surv_bytes)) return cudaErrorInvalidValue;
  *tc_chunks = 0;
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

    cudaError_t err = launch_score_chunk<I8>(vec, qry, items, scales, rows, n_valid, d, p.ld, scores, tc_chunks, cs);
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
// and n_valid <= n. Launches on `stream` of the current device; writes to
// *tc_chunks how many chunks of queries took the tensor-core score stage.
// Returns the first CUDA error.
extern "C" int mips_topk_fused(const void* queries, const void* items, void* out_s, void* out_i,
                               const void* exclude, int n_ex, long long ex_ld, void* scratch,
                               long long scratch_bytes, int q, int n, int d, int k, int n_valid,
                               int* tc_chunks, void* stream) {
  return run_mips_topk<false>(queries, items, nullptr, out_s, out_i, exclude, n_ex, ex_ld, scratch,
                              scratch_bytes, q, n, d, k, n_valid, tc_chunks, stream);
}

// The same over int8 items (n, d) row-major with f32 scales (n,): score =
// the f32 dot of the query and the int8 row, times the row's scale.
extern "C" int mips_topk_int8_fused(const void* queries, const void* items, const void* scales,
                                    void* out_s, void* out_i, const void* exclude, int n_ex,
                                    long long ex_ld, void* scratch, long long scratch_bytes, int q, int n,
                                    int d, int k, int n_valid, int* tc_chunks, void* stream) {
  return run_mips_topk<true>(queries, items, static_cast<const float*>(scales), out_s, out_i, exclude, n_ex,
                             ex_ld, scratch, scratch_bytes, q, n, d, k, n_valid, tc_chunks, stream);
}

// tc::tf32_probe_kernel on a (64, 8), b (128, 8) f32 into d (64, 128) f32,
// all contiguous on the current device; returns cudaGetLastError().
extern "C" int mips_tf32_probe(const void* a, const void* b, void* d, void* stream) {
  tc::tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(d));
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
