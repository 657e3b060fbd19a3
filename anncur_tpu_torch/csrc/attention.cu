// Kernel A: attention forward for the cross-encoder, for Hopper (sm_90a).
//
// Replaces anncur_tpu/models/bert.py::_flash_attention, the stock Pallas TPU
// flash-attention forward (jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_kernel), and computes at every real query row what it and
// anncur_tpu/models/bert.py::_attn_core compute:
//     out = softmax(Q K^T / sqrt(hd) + bias) V,
// bias = 0 at valid keys and -1e9 at padding (exp of a masked key is exactly
// 0 in f32, and a pair with no valid key attends every key). Scores, softmax
// and accumulation are f32.
//
// Bound on the H100: at the build's shape (2048 pairs, g = s = 256, nh = 12,
// hd = 64, bf16, random key lengths) the launch must read Q and write O
// (1.61 GB) and read K and V at the valid keys (0.81 GB): 0.725 ms at
// 3.35 TB/s. Its products over the valid keys are 207 GFLOP, 0.21 ms on the
// bf16 tensor cores: ~128 FLOP/B, below the bf16 ridge (~295 FLOP/B), so
// bytes bound it. A work item (a pair, a head, 64 query rows) is short: its
// Q tile, two to four 64-key K/V tiles, its O tile. What keeps such a
// kernel from the byte bound is latency: a block that loads its Q and first
// tiles, then runs, then writes O in turn leaves the card idle between.
//
// Hopper body (bf16, hd = 64, g > 16: every configuration's full layers;
// namespace hopper): one warpgroup a block owns two 64-row query tiles of
// a (pair, head), so each K/V tile it loads serves 128 query rows (the
// blocks of a head run together and share its K/V in L2); a launch that
// would then have fewer blocks than the card has SMs (the towers'
// micro-batch of 4 pairs) gives each block one query tile. Thread 0 issues
// every load by TMA (4-D tensor maps of q, k and v with their strides,
// 128-byte-swizzled 64 x 64 tiles; rows past g or s read as zeros),
// predicated so the warpgroup takes no divergent branch: both Q tiles and
// K/V tile 0 (which always runs) while the block reads the mask, then the
// running K/V tiles through a 3-stage ring. Per key tile: S = Q K^T for
// both query tiles by wgmma m64n64k16 from shared memory (both K-major),
// committed as two groups; the first tile's scale, bias and online softmax
// in f32 (as below) run while the second's S is on the tensor cores, then
// its O += P V (P rounded to bf16 straight from the accumulator as the A
// fragments, V MN-major through the transpose bit) while the second tile's
// softmax runs. The epilogue is the one below, through padded rows of the
// freed ring. Designs timed side by side on the H100 at the build layer
// (cli/time_kernels.py --source; PERF.md): persistent blocks walking
// single 64-row items with the next item's loads in flight, 1.83 ms, or
// walking (pair, head) units, 1.58 ms, against the mma.sync body's 1.63:
// each K/V tile read once per 64 query rows through L2 held them back; two
// query tiles a block, 1.24 ms as here, 1.35 ms with the two softmaxes
// after both products. ptxas reports the wgmma of this body serialised
// (C7515: the second tile's softmax writes its accumulators while the
// first tile's P V runs); the overlap still pays.

// mma.sync design (bf16, every other head dim that is a multiple of 16 up
// to 256, templated on HD, and g <= 16 at hd 64; the Hopper body keeps its
// semantics):
// - One block per (pair, head, tile of query rows), the tile index fastest,
//   so the tiles of one head run together and re-read its K/V from L2. Four
//   warps own 16 query rows each. 64 rows rather than 128: an 8-warp block
//   holds its registers and shared memory for twice as long, fits only two
//   to an SM and timed slower on the H100, and 64-row tiles give twice the
//   blocks at the training shape's 64 pairs and at most 63 padded rows of a
//   ragged g. For g <= 16 (the CLS-only final layer's 1- or 3-row slice)
//   one warp owns a 16-row tile, so no warp computes only padding.
// - Q goes to shared memory once (cp.async, rows >= g zero-filled) and
//   ldmatrix turns it into the A fragments of mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), which stay in registers. K and V stream in 64-key
//   tiles, double-buffered with cp.async (keys >= s zero-filled, their
//   scores -inf); rows are padded by 16 bytes so the ldmatrix row addresses
//   fall in distinct banks. V is read with ldmatrix.trans as the B operand.
// - S = Q K^T on the tensor cores, then S * scale + bias in f32. Online
//   softmax: a row's values lie in a quad of lanes, so its max takes two
//   shuffles; P = exp(S - m) in f32 and l sums the f32 P. P is rounded to
//   bf16 and fed from registers as the A operand of P V, as the TPU kernel
//   (p.astype(v.dtype)) and _attn_core (probs.astype(dtype)) round it.
// - A 64-key tile with no valid key is skipped when its pair has one (one
//   64-bit ballot word per tile, built once per block while Q and tile 0
//   load): exact, since exp(-1e9 - m) is 0 in f32. Tile 0 always runs, so
//   its loads need not wait for the mask: masked keys before a pair's
//   first valid key are wiped exactly by that tile's rescale,
//   exp(-1e9 - m) = 0. A pair with no valid key runs every tile.
// - Epilogue: O / l rounded to bf16, staged in the warp's rows of the Q
//   tile, written in 16-byte coalesced stores; rows >= g are not stored.
//
// Head dims above 256 (any multiple of 16, a runtime count) take the wide
// route. Its Hopper body (namespace wide, bf16 and f32) runs where TMA takes
// the strides and a block's stored tiles fit in shared memory (bf16 s <=
// 1472, f32 s <= 448: launch_wide), and computes S once per (query tile,
// key tile) on wgmma with TMA-filled tiles through a ring of two or three
// slots that side warps keep full (csrc/wide_sm90.cuh, shared with kernels
// C and D). One block per (pair, head, tile of 64 query rows):
// - Phase 1 walks the key tiles that hold a valid key (every tile in a pair
//   with none), each over the head dim in chunks (64 bf16 or 32 f32
//   columns): S = Q K^T, then in f32 the scale, the key bias and the online
//   max and sum, and P = exp(S - m) of the tile goes to shared memory (bf16
//   as the A fragments of the next product, rounded after the running max
//   is taken off, as the TPU kernel rounds p; f32 in fragment order) with
//   each row's rescale factor exp(m before - m after).
// - Phase 2 walks the output columns in slices (bf16 128: two m64n64
//   blocks; f32 64): O = P V over the running tiles, O rescaled before each
//   tile's product, V streaming through the same ring; then O / l. The lse
//   comes from phase 1's m and l.
// - bf16: wgmma m64n64k16, Q and K K-major, V MN-major (the transpose bit).
//   f32: three TF32 passes (m64n64k8), each 32-column chunk of S and each
//   64-key tile of P V summed apart and added in f32; TF32 takes K-major
//   operands only, so the side warps transpose V in the pass that splits
//   it. Columns past hd are zero-filled and computed (a predicated wgmma
//   made ptxas serialise every product, C7520).
// Elsewhere the slice bodies (attention_fwd_bf16_wide_kernel,
// attention_fwd_f32_wide_kernel; shared pieces in csrc/attention_wide.cuh)
// stream Q and K in 64-column chunks and write one column slice of O a
// block (128 in bf16, 64 in f32), recomputing the scores for each. The
// templated bodies keep hd up to 256.
//
// f32 (no main-path caller on the card; the card tests use it): a CUDA-core
// body. One block per (pair, head, tile of 128 / SPLIT query rows) streams
// K, V and the key bias through shared memory in 64-key tiles, so s is not
// bounded by shared memory; SPLIT neighbouring lanes share a row's head dims
// (csrc/attention_common.cuh) and run an online softmax over chunks of 16
// keys in f32 FFMA.
//
// Layout is the JAX one: q (b, g, nh, hd), k and v (b, s, nh, hd), any
// strides on the batch, row and head axes, hd contiguous and rows 16-byte
// aligned; out (b, g, nh, hd) contiguous. For the backward
// (csrc/attention_bwd.cu) a launch may also write each row's natural-log
// log-sum-exp of its scaled, biased scores, lse = m + log(l) in f32, shape
// (b, nh, g). In a pair with no valid key it is taken without the -1e9
// every score then carries, (m + 1e9) + log(l), exact since m is -1e9 plus
// a multiple of 64: -1e9 + log(l) would round to -1e9 and lose l. A null
// lse pointer writes nothing extra, and out is the same either way. The
// kernels allocate nothing and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "attention_wide.cuh"
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"
#include "wide_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_sm90;
using namespace attn_f32;

constexpr int kKeyTile = 64;  // keys per K/V tile of the bf16 kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskBias = -1e9f;

template <int HD, int NW>
constexpr size_t bf16_smem_bytes(int n_tiles) {
  // Q tile, two stages of K and V tiles (rows padded by 8 elements), one
  // mask word per key tile
  return static_cast<size_t>(16 * NW + 4 * kKeyTile) * (HD + 8) * sizeof(bf16) +
         static_cast<size_t>(n_tiles) * sizeof(uint64_t);
}

// sc (a warp's 16 x 64 score tile in C fragments) <- sc * scale + bias,
// bias 0 at valid keys, -1e9 at masked ones and -inf at keys past the end
// (n_keys = keys of the tile below s); kDiag: also -inf at keys past the
// row (tile-local key > row0, the lane's first row; row0 + 8 its second);
// tmax <- each of the lane's two rows' max over its 16 columns
template <bool kAllValid, bool kDiag = false>
__device__ __forceinline__ void scale_and_bias(float (&sc)[kKeyTile / 8][4], float (&tmax)[2],
                                               float scale, uint64_t bits, int n_keys, int kq,
                                               int row0 = 0) {
  tmax[0] = tmax[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kt = 8 * j + kq + e;
      float bias = 0.0f;
      if (!kAllValid) bias = kt >= n_keys ? -INFINITY : (((bits >> kt) & 1) ? 0.0f : kMaskBias);
      sc[j][e] = sc[j][e] * scale + (kDiag && kt > row0 ? -INFINITY : bias);
      sc[j][e + 2] = sc[j][e + 2] * scale + (kDiag && kt > row0 + 8 ? -INFINITY : bias);
      tmax[0] = fmaxf(tmax[0], sc[j][e]);
      tmax[1] = fmaxf(tmax[1], sc[j][e + 2]);
    }
  }
}

// Four 4-warp blocks per SM at hd <= 64: ptxas then keeps the body to 128
// registers (a few spilled bytes); left free it takes ~130, and only three
// blocks fit. The one-warp blocks are bounded by shared memory instead.
template <int HD, int NW>
constexpr int kMinBlocksPerSm = (NW == 4 && HD <= 64) ? 4 : 1;

// The mma.sync body. kCausal (g = s, query row i at position i): key tiles
// past the query tile's last row are never loaded, keys past a row's own
// position score -inf in the tile on the diagonal, and no tile is skipped
// for its mask (a row's visible keys may all be masked while a later key is
// valid), so every other key keeps its -1e9 bias.
template <int HD, int NW, bool kCausal>
__device__ __forceinline__ void attention_fwd_bf16_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ key_valid, bf16* __restrict__ out, float* __restrict__ lse, int g, int s,
    int nh, int n_qt, long long q_sb, long long q_sr, long long q_sh, long long k_sb, long long k_sr,
    long long k_sh, long long v_sb, long long v_sr, long long v_sh, long long valid_sb, float scale) {
  constexpr int kRows = 16 * NW, kThreads = 32 * NW, kLd = HD + 8, kUnits = HD / 8;
  static_assert(!kCausal || kKeyTile % kRows == 0, "a causal query tile ends in one key tile");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRows * kLd;          // 2 stages of kKeyTile rows
  bf16* vs = ks + 2 * kKeyTile * kLd;   // 2 stages of kKeyTile rows
  uint64_t* tile_bits = reinterpret_cast<uint64_t*>(vs + 2 * kKeyTile * kLd);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % nh, b = bh / nh;
  const int row0 = qt * kRows;
  const int n_tiles = kCausal ? min((s + kKeyTile - 1) / kKeyTile, (row0 + kRows - 1) / kKeyTile + 1)
                              : (s + kKeyTile - 1) / kKeyTile;

  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  auto load_kv = [&](int t, int stage) {
    bf16* kd = ks + stage * kKeyTile * kLd;
    bf16* vd = vs + stage * kKeyTile * kLd;
    for (int u = tid; u < kKeyTile * kUnits; u += kThreads) {
      const int r = u / kUnits, c = u % kUnits;
      const int key = t * kKeyTile + r;
      const bool ok = key < s;
      cp_async_16(smem_addr(kd + r * kLd + c * 8), ok ? kb + key * k_sr + c * 8 : kb, ok ? 16 : 0);
      cp_async_16(smem_addr(vd + r * kLd + c * 8), ok ? vb + key * v_sr + c * 8 : vb, ok ? 16 : 0);
    }
  };

  // the Q tile (rows >= g zero) and key tile 0, which always runs
  const bf16* qb = q + b * q_sb + h * q_sh;
  for (int u = tid; u < kRows * kUnits; u += kThreads) {
    const int r = u / kUnits, c = u % kUnits;
    const bool ok = row0 + r < g;
    cp_async_16(smem_addr(qs + r * kLd + c * 8), ok ? qb + (row0 + r) * q_sr + c * 8 : qb,
                ok ? 16 : 0);
  }
  load_kv(0, 0);
  cp_async_commit();

  // one word of valid-key bits per key tile, while those are in flight
  const uint8_t* vrow = key_valid + b * valid_sb;
  bool any_local = false;
  for (int t = warp; t < n_tiles; t += NW) {
    const int j0 = t * kKeyTile + lane, j1 = j0 + 32;
    const uint32_t lo = __ballot_sync(0xffffffffu, j0 < s && vrow[j0]);
    const uint32_t hi = __ballot_sync(0xffffffffu, j1 < s && vrow[j1]);
    if (lane == 0) tile_bits[t] = (static_cast<uint64_t>(hi) << 32) | lo;
    any_local |= (lo | hi) != 0;
  }
  const bool any_valid = __syncthreads_or(any_local);  // also publishes tile_bits
  auto next_tile = [&](int t) {
    while (!kCausal && any_valid && t < n_tiles && tile_bits[t] == 0) ++t;
    return t;
  };
  int t = 0;

  const int wrow = warp * 16;   // this warp's first row in the tile
  const int kq = 2 * (lane & 3);  // this lane's first column of a C fragment
  uint32_t qf[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8
  float l[2] = {0.0f, 0.0f};            // this lane's share of each row's sum
  int stage = 0;
  bool first = true;

  while (t < n_tiles) {
    const int tn = next_tile(t + 1);
    if (tn < n_tiles) load_kv(tn, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(qs + (wrow + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8));
      first = false;
    }
    const bf16* kd = ks + stage * kKeyTile * kLd;
    const bf16* vd = vs + stage * kKeyTile * kLd;

    // S = Q K^T: 8 n-tiles of 8 keys
    float sc[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kKeyTile / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(kd + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16_16816(sc[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16_16816(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // S * scale + bias and the tile's row max; a tile of valid keys only
    // (every full tile of a prefix mask but its last) adds no bias
    const uint64_t bits = tile_bits[t];
    const int key0 = t * kKeyTile;
    float tmax[2];
    if (kCausal && key0 + kKeyTile - 1 > row0 + wrow)  // a key of the tile lies past a row of this warp
      scale_and_bias<false, true>(sc, tmax, scale, bits, s - key0, kq, row0 + wrow + (lane >> 2) - key0);
    else if (bits == ~0ull && key0 + kKeyTile <= s)
      scale_and_bias<true>(sc, tmax, scale, bits, s - key0, kq);
    else
      scale_and_bias<false>(sc, tmax, scale, bits, s - key0, kq);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      // finite: a tile that runs holds a key < s. alpha is 0 on the first
      // tile (m = -inf). Subtract before scaling: at m ~ -1e9 (no valid
      // key) a folded log2(e) would lose the difference.
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        sc[j][e] = exp2f((sc[j][e] - m[i]) * kLog2e);
        l[i] += sc[j][e];
      }
    }

    // O += P V, P rounded to bf16 straight from the score fragments
#pragma unroll
    for (int kstep = 0; kstep < kKeyTile / 16; ++kstep) {
      const uint32_t pa[4] = {
          pack_bf16x2(sc[2 * kstep][0], sc[2 * kstep][1]),
          pack_bf16x2(sc[2 * kstep][2], sc[2 * kstep][3]),
          pack_bf16x2(sc[2 * kstep + 1][0], sc[2 * kstep + 1][1]),
          pack_bf16x2(sc[2 * kstep + 1][2], sc[2 * kstep + 1][3]),
      };
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(vd + (kstep * 16 + (lane & 15)) * kLd + dp * 16 +
                                        (lane >> 4) * 8));
        mma_bf16_16816(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16_16816(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
    t = tn;
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};

  // O / l in bf16 through this warp's own rows of the Q tile
  bf16* os = qs + wrow * kLd;
  const int r = lane >> 2;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    *reinterpret_cast<uint32_t*>(os + r * kLd + 8 * d + kq) =
        pack_bf16x2(o[d][0] * inv[0], o[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (r + 8) * kLd + 8 * d + kq) =
        pack_bf16x2(o[d][2] * inv[1], o[d][3] * inv[1]);
  }
  __syncwarp();
  for (int u = lane; u < 16 * kUnits; u += 32) {
    const int rr = u / kUnits, c = u % kUnits;
    const int row = row0 + wrow + rr;
    if (row < g)
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * g + row) * nh + h) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(os + rr * kLd + c * 8);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    const float shift = any_valid ? 0.0f : kMaskBias;  // exact: m is -1e9 + a multiple of 64
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + wrow + r + 8 * i;
      if (row < g) lse[(static_cast<size_t>(b) * nh + h) * g + row] = (m[i] - shift) + logf(l[i]);
    }
  }
}

#define ATTN_BF16_PARAMS                                                                             \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k, const bf16 *__restrict__ v,                 \
      const uint8_t *__restrict__ key_valid, bf16 *__restrict__ out, float *__restrict__ lse, int g,   \
      int s, int nh, int n_qt, long long q_sb, long long q_sr, long long q_sh, long long k_sb,          \
      long long k_sr, long long k_sh, long long v_sb, long long v_sr, long long v_sh, long long valid_sb, \
      float scale
#define ATTN_BF16_ARGS                                                                               \
  q, k, v, key_valid, out, lse, g, s, nh, n_qt, q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, \
      valid_sb, scale

template <int HD, int NW>
__global__ void __launch_bounds__(NW * 32, kMinBlocksPerSm<HD, NW>)
attention_fwd_bf16_kernel(ATTN_BF16_PARAMS) {
  attention_fwd_bf16_body<HD, NW, false>(ATTN_BF16_ARGS);
}

// causal (g = s): four warps, 64-row query tiles, one key tile on the diagonal;
// instantiated at kCausalHeadDim alone
constexpr int kCausalHeadDim = 192;

template <int HD>
__global__ void __launch_bounds__(128, kMinBlocksPerSm<HD, 4>)
attention_fwd_bf16_causal_kernel(ATTN_BF16_PARAMS) {
  attention_fwd_bf16_body<HD, 4, true>(ATTN_BF16_ARGS);
}

#undef ATTN_BF16_PARAMS
#undef ATTN_BF16_ARGS

// ------------------------------------------------------------- Hopper

// bf16, hd = 64, g > 16: wgmma on TMA-filled, 128-byte-swizzled tiles (the
// header note). One warpgroup a block, owning two query tiles of a (pair,
// head) that share each K/V tile; its thread 0 issues every TMA load,
// predicated.
namespace hopper {

using namespace wgmma_sm90;

constexpr int kRows = 64;                   // query rows of a tile, keys of a K/V tile
constexpr int kTileBytes = kRows * 64 * 2;  // one 64 x 64 bf16 tile
constexpr int kQTiles = 2;                  // query tiles of a block, at most
constexpr int kStages = 3;                  // depth of the K/V ring
constexpr int kThreads = 128;               // one warpgroup
constexpr int kBlocksPerSm = 3;
constexpr int kLdOut = 72;                  // epilogue rows, padded by 16 bytes
// shared memory from a 1024-byte boundary: the query tiles, the ring's K
// and V tiles, the barriers, then one mask word and one running tile index
// per key tile; the epilogue rows reuse the ring
constexpr int kK = kQTiles * kTileBytes;
constexpr int kV = kK + kStages * kTileBytes;
constexpr int kBars = kV + kStages * kTileBytes;
constexpr int kMeta = kBars + (1 + kStages) * 8;
static_assert(kQTiles * kRows * kLdOut * 2 <= 2 * kStages * kTileBytes, "the epilogue fits in the ring");

__host__ __device__ constexpr size_t smem_bytes(int n_tiles) {
  return kMeta + static_cast<size_t>(n_tiles) * (sizeof(uint64_t) + sizeof(int)) + 1024;
}

struct Maps {  // q, k, v as 64-row x 64-column TMA boxes
  RowMap q, k, v;
};

using wide_sm90::load_tile;
using wide_sm90::to_a;

// One query tile's online softmax over a key tile (the mma.sync body's
// arithmetic): s <- exp(s * scale + bias - m) in f32, bias 0 at valid keys,
// -1e9 at masked ones and -inf past s (n_keys keys of the tile below s);
// m, l and o rescaled
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&o)[32], float (&m)[2], float (&l)[2],
                                               uint64_t bits, int n_keys, float scale, int cq) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * jj + cq + (e & 1);
      const float bias = col >= n_keys ? -INFINITY : (((bits >> col) & 1) ? 0.0f : kMaskBias);
      sc[4 * jj + e] = sc[4 * jj + e] * scale + bias;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[4 * jj + e]);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
    // finite: a running tile holds a key < s. alpha is 0 on the first tile
    // (m = -inf); the difference is taken before log2(e), as at m ~ -1e9
    // (no valid key) a folded log2(e) would lose it
    const float m_new = fmaxf(m[i], tmax[i]);
    alpha[i] = exp2f((m[i] - m_new) * kLog2e);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    o[e] *= alpha[(e >> 1) & 1];
    sc[e] = exp2f((sc[e] - m[(e >> 1) & 1]) * kLog2e);
    l[(e >> 1) & 1] += sc[e];
  }
}

// One query tile's O / l in bf16 through the warp's padded rows of
// `stage`, then 16-byte stores of rows < g; its lse
__device__ __forceinline__ void epilogue(bf16* stage, float (&o)[32], float (&m)[2], float (&l)[2], bf16* out,
                                         float* lse, int b, int h, int row0, int g, int nh, float shift, int warp,
                                         int lane) {
  const int r = lane >> 2, cq = 2 * (lane & 3), er = 16 * warp + r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<uint32_t*>(stage + er * kLdOut + 8 * jj + cq) = pack_bf16x2(o[4 * jj] * inv[0], o[4 * jj + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(stage + (er + 8) * kLdOut + 8 * jj + cq) =
        pack_bf16x2(o[4 * jj + 2] * inv[1], o[4 * jj + 3] * inv[1]);
  }
  __syncwarp();
  for (int u = lane; u < 16 * 8; u += 32) {
    const int i = 16 * warp + u / 8, unit = u % 8, row = row0 + i;
    if (row < g)
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * g + row) * nh + h) * 64 + 8 * unit) =
          *reinterpret_cast<const uint4*>(stage + i * kLdOut + 8 * unit);
  }
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + er + 8 * i;
      if (row < g) lse[(static_cast<size_t>(b) * nh + h) * g + row] = (m[i] - shift) + logf(l[i]);
    }
  }
}

// One block per (pair, head, pass of n_q 64-row query tiles: 2, or 1 where
// two a block would leave SMs idle), the pass fastest: O = softmax(Q K^T *
// scale + bias) V for the pass's query tiles over the pair's running key
// tiles (every tile that holds a valid key, and tile 0; every tile in a
// pair with none). Each K/V tile serves both query tiles, their products
// interleaved with the other tile's softmax.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
attention_fwd_wgmma_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ key_valid,
                           bf16* __restrict__ out, float* __restrict__ lse, int g, int s, int nh, int n_q,
                           int n_pass, long long valid_sb, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* kv_full = q_full + 1;  // [kStages]
  const int n_tiles = (s + kRows - 1) / kRows;
  uint64_t* tile_bits = reinterpret_cast<uint64_t*>(smem + kMeta);
  int* run = reinterpret_cast<int*>(tile_bits + n_tiles);  // the running tiles, in order
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pass = blockIdx.x % n_pass, bh = blockIdx.x / n_pass;
  const int h = bh % nh, b = bh / nh;
  const int row0 = pass * n_q * kRows;
  const bool two = n_q == 2 && row0 + kRows < g;  // a second query tile that holds a row < g
  auto load_kv = [&](int t, int st, bool issue) {
    mbar_arrive_expect_tx(kv_full + st, 2 * kTileBytes, issue);
    load_tile(smem + kK + st * kTileBytes, maps.k, kv_full + st, h, t * kRows, b, issue);
    load_tile(smem + kV + st * kTileBytes, maps.v, kv_full + st, h, t * kRows, b, issue);
  };

  // the barriers, then the query tiles and key tile 0 (which always runs)
  // in flight while the block reads the mask
  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(kv_full + i, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(q_full, (two ? 2 : 1) * kTileBytes, true);
    load_tile(smem, maps.q, q_full, h, row0, b, true);
    load_tile(smem + kTileBytes, maps.q, q_full, h, row0 + kRows, b, two);
    load_kv(0, 0, true);
  }
  // one word of valid-key bits per key tile (the barrier also publishes the
  // mbarriers' init)
  const uint8_t* vrow = key_valid + b * valid_sb;
  bool any_local = false;
  for (int t = warp; t < n_tiles; t += kThreads / 32) {
    const int j0 = t * kRows + lane, j1 = j0 + 32;
    const uint32_t lo = __ballot_sync(0xffffffffu, j0 < s && vrow[j0]);
    const uint32_t hi = __ballot_sync(0xffffffffu, j1 < s && vrow[j1]);
    if (lane == 0) tile_bits[t] = (static_cast<uint64_t>(hi) << 32) | lo;
    any_local |= (lo | hi) != 0;
  }
  const bool any_valid = __syncthreads_or(any_local);
  int n_run = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0 && any_valid && tile_bits[t] == 0) continue;
    if (tid == 0) run[n_run] = t;
    ++n_run;
  }
  __syncthreads();  // publishes run
  for (int j = 1; j < kStages && j < n_run; ++j) load_kv(run[j], j, tid == 0);

  const int cq = 2 * (lane & 3);  // accumulator rows 16 warp + (lane / 4) (+ 8), columns 8j + cq (+ 1)
  float oa[32], ob[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oa[i] = ob[i] = 0.0f;
  float ma[2] = {-INFINITY, -INFINITY}, mb[2] = {-INFINITY, -INFINITY};  // rows lane / 4 and + 8
  float la[2] = {0.0f, 0.0f}, lb[2] = {0.0f, 0.0f};  // this lane's share of each row's sum
  const uint32_t qa = smem_u32(smem), qb = qa + kTileBytes;
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_run; ++j) {
    const int t = run[j], st = j % kStages;
    const uint32_t k_addr = smem_u32(smem + kK + st * kTileBytes), v_addr = smem_u32(smem + kV + st * kTileBytes);
    const uint64_t bits = tile_bits[t];
    const int n_keys = s - t * kRows;
    mbar_wait(kv_full + st, (j / kStages) & 1);
    // S = Q K^T for both query tiles, as two groups: queries x keys, hd
    // reduced (both K-major)
    float sa[32], sb[32];  // the first k-step overwrites them
    uint32_t p[4][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(sa, desc_sw128(qa + 32 * kk), desc_sw128(k_addr + 32 * kk), kk);
    wgmma_commit();
    if (two) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_ss(sb, desc_sw128(qb + 32 * kk), desc_sw128(k_addr + 32 * kk), kk);
    }
    wgmma_commit();  // possibly empty: keeps the group count uniform
    wgmma_wait<1>();
    keep(sa);
    // the first tile's softmax while the second's S is on the tensor cores;
    // then its O += P V (keys reduced, V MN-major), and the second tile's
    // softmax while that runs
    online_softmax(sa, oa, ma, la, bits, n_keys, scale, cq);
    to_a(p, sa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs_mn(oa, p[kk], desc_sw128(v_addr + 2048 * kk));
    wgmma_commit();
    if (two) {
      wgmma_wait<1>();  // the second S; the first P V may still run
      keep(sb);
      online_softmax(sb, ob, mb, lb, bits, n_keys, scale, cq);
      wgmma_wait<0>();
      keep(oa);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) keep(p[kk]);
      to_a(p, sb);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs_mn(ob, p[kk], desc_sw128(v_addr + 2048 * kk));
      wgmma_commit();
    }
    wgmma_wait<0>();
    keep(oa);
    keep(ob);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) keep(p[kk]);
    __syncthreads();  // every warp is done with the stage: refill it kStages running tiles on
    const bool refill = j + kStages < n_run;
    load_kv(run[refill ? j + kStages : j], st, tid == 0 && refill);
  }

  // O / l in bf16 through the ring (every product has read it)
  const float shift = any_valid ? 0.0f : kMaskBias;  // exact: m is -1e9 + a multiple of 64
  bf16* stage = reinterpret_cast<bf16*>(smem + kK);
  epilogue(stage, oa, ma, la, out, lse, b, h, row0, g, nh, shift, warp, lane);
  if (two) epilogue(stage + kRows * kLdOut, ob, mb, lb, out, lse, b, h, row0 + kRows, g, nh, shift, warp, lane);
}

}  // namespace hopper

// ----------------------------------------------------------------- f32

// Kernel D's f32 loop run forward: one block per (pair, head, tile of
// 128 / SPLIT query rows); SPLIT lanes share a row's dims (Split). The block
// streams K, V and the key bias through shared memory in 64-key tiles, and
// each row runs an online softmax over chunks of 16 keys.
constexpr int kKeyChunk = 16;

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
attention_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const uint8_t* __restrict__ key_valid,
                         float* __restrict__ out, float* __restrict__ lse, int g, int s, int nh,
                         long long q_sb, long long q_sr, long long q_sh,
                         long long k_sb, long long k_sr, long long k_sh,
                         long long v_sb, long long v_sr, long long v_sh,
                         long long valid_sb, float scale) {
  using S = Split<HD>;
  constexpr int kRows = kF32Threads / S::kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kF32Tile * HD;
  float* bias_s = vs + kF32Tile * HD;

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int part = threadIdx.x % S::kLanes;
  const int row = blockIdx.y * kRows + threadIdx.x / S::kLanes;
  const bool in_range = row < g;
  const int row_c = in_range ? row : g - 1;
  const uint8_t* valid_row = key_valid + b * valid_sb;
  const float shift = pair_has_valid_key(valid_row, s) ? 0.0f : kMaskBias;  // for the lse

  float qr[S::kDims], acc[S::kDims];
  const float* qp = q + b * q_sb + row_c * q_sr + h * q_sh;
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) load_unit(qp + S::offset(part, t), qr + t * S::kUnit);
#pragma unroll
  for (int d = 0; d < S::kDims; ++d) acc[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  for (int j0 = 0; j0 < s; j0 += kF32Tile) {
    const int n = min(kF32Tile, s - j0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD>(ks, kb, k_sr, j0, n);
    stage_rows<HD>(vs, vb, v_sr, j0, n);
    for (int j = threadIdx.x; j < n; j += kF32Threads) bias_s[j] = valid_row[j0 + j] ? 0.0f : kMaskBias;
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += kKeyChunk) {
      float sc[kKeyChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeyChunk; ++j) {
        sc[j] = -INFINITY;
        if (c0 + j < n) {  // uniform across the block: the shuffles are safe
          const float* kj = ks + (c0 + j) * HD;
          float dot = 0.0f;
#pragma unroll
          for (int t = 0; t < S::kUnits; ++t) {
            float kv[S::kUnit];
            load_unit(kj + S::offset(part, t), kv);
#pragma unroll
            for (int e = 0; e < S::kUnit; ++e) dot = fmaf(qr[t * S::kUnit + e], kv[e], dot);
          }
          sc[j] = S::reduce(dot) * scale + bias_s[c0 + j];
        }
        cmax = fmaxf(cmax, sc[j]);
      }
      // the first chunk always holds a key, so m_new is finite from here on
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // 0 on the first chunk (m = -inf)
      l *= alpha;
#pragma unroll
      for (int d = 0; d < S::kDims; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeyChunk; ++j) {
        if (c0 + j < n) {
          const float p = expf(sc[j] - m_new);
          l += p;
          const float* vj = vs + (c0 + j) * HD;
#pragma unroll
          for (int t = 0; t < S::kUnits; ++t) {
            float vv[S::kUnit];
            load_unit(vj + S::offset(part, t), vv);
#pragma unroll
            for (int e = 0; e < S::kUnit; ++e) acc[t * S::kUnit + e] = fmaf(p, vv[e], acc[t * S::kUnit + e]);
          }
        }
      }
      m = m_new;
    }
  }

  if (!in_range) return;
  const float inv = 1.0f / l;
  float* op = out + ((static_cast<size_t>(b) * g + row) * nh + h) * HD;
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) {
    float o[S::kUnit];
#pragma unroll
    for (int e = 0; e < S::kUnit; ++e) o[e] = acc[t * S::kUnit + e] * inv;
    store_unit(op + S::offset(part, t), o);
  }
  if (lse != nullptr && part == 0) lse[(static_cast<size_t>(b) * nh + h) * g + row] = (m - shift) + logf(l);
}

// ----------------------------------------------------------------- wide

// The wide route (csrc/attention_wide.cuh): hd above 256, any multiple of
// 16, a runtime count. One block per (pair, head, output slice, tile of 64
// query rows), the tile index fastest. S = Q K^T streams Q and K through
// shared memory in 64-column chunks; the online softmax is the templated
// body's; O += P V reads the slice's V columns. Each slice's block
// recomputes the scores, and slice 0 writes the lse.
constexpr int kSliceA = 128;  // output columns of a bf16 block

__global__ void __launch_bounds__(attn_wide::kThreads)
attention_fwd_bf16_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                               bf16* __restrict__ out, float* __restrict__ lse, int g, int s, int nh,
                               int hd, int n_qt, int n_sl, long long q_sb, long long q_sr,
                               long long q_sh, long long k_sb, long long k_sr, long long k_sh,
                               long long v_sb, long long v_sr, long long v_sh, long long valid_sb,
                               float scale) {
  using namespace attn_wide;
  constexpr int kLdV = kSliceA + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qc = reinterpret_cast<bf16*>(smem);  // a 64-column chunk of the Q tile
  bf16* kc = qc + kRows * kLdB;              // the same chunk of the key tile
  bf16* vsl = kc + kRows * kLdB;             // the key tile's V columns of this slice

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt;
  const int sl = (blockIdx.x / n_qt) % n_sl;
  const int bh = blockIdx.x / n_qt / n_sl;
  const int h = bh % nh, b = bh / nh;
  const int row0 = qt * kRows, col0 = sl * kSliceA;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const uint8_t* vrow = key_valid + b * valid_sb;
  const bool any_valid = pair_has_valid_key(vrow, s);

  const int wrow = warp * 16, kq = 2 * (lane & 3);
  float o[kSliceA / 8][4];
#pragma unroll
  for (int d = 0; d < kSliceA / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  for (int key0 = 0; key0 < s; key0 += kKeyTile) {
    __syncthreads();  // the previous tile's V is consumed
    stage_bf16(vsl, kLdV, vb, v_sr, key0, s, col0, kSliceA, hd);
    float sc[kKeyTile / 8][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      if (c0) __syncthreads();  // the previous chunk is consumed
      stage_bf16(qc, kLdB, qb, q_sr, row0, g, c0, kChunk, hd);
      stage_bf16(kc, kLdB, kb, k_sr, key0, s, c0, kChunk, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_chunk_nt(sc, qc, wrow, kc, lane);
    }
    float tmax[2];
    scale_and_bias<false>(sc, tmax, scale, key_bits(vrow, key0, s, lane), s - key0, kq);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m[i], tmax[i]);
      alpha[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int d = 0; d < kSliceA / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        sc[j][e] = exp2f((sc[j][e] - m[i]) * kLog2e);
        l[i] += sc[j][e];
      }
    }
    mma_rows<kSliceA>(o, sc, vsl, kLdV, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncthreads();  // vsl is free for the epilogue
  store_rows_bf16<kSliceA>(vsl + wrow * kLdV, kLdV, o, 1.0f / l[0], 1.0f / l[1],
                           out + (static_cast<size_t>(b) * g * nh + h) * hd,
                           static_cast<long long>(nh) * hd, row0 + wrow, g, col0, hd, lane);
  if (lse != nullptr && sl == 0 && (lane & 3) == 0) {
    const float shift = any_valid ? 0.0f : kMaskBias;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + wrow + (lane >> 2) + 8 * i;
      if (row < g) lse[(static_cast<size_t>(b) * nh + h) * g + row] = (m[i] - shift) + logf(l[i]);
    }
  }
}

// f32 wide: the same blocks with 64-column slices; each thread owns 8 query
// rows x 4 keys of a score tile (then 8 rows x 4 output columns), its rows'
// max and sum reduced over the 16 lanes that share them
__global__ void __launch_bounds__(attn_wide::kThreads)
attention_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const uint8_t* __restrict__ key_valid,
                              float* __restrict__ out, float* __restrict__ lse, int g, int s, int nh,
                              int hd, int n_qt, int n_sl, long long q_sb, long long q_sr,
                              long long q_sh, long long k_sb, long long k_sr, long long k_sh,
                              long long v_sb, long long v_sr, long long v_sh, long long valid_sb,
                              float scale) {
  using namespace attn_wide;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kRows * kLdF;
  float* ps = ks + kRows * kLdF;  // P of the key tile
  float* vs = ps + kRows * kLdF;  // the key tile's V columns of this slice

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = blockIdx.x % n_qt;
  const int sl = (blockIdx.x / n_qt) % n_sl;
  const int bh = blockIdx.x / n_qt / n_sl;
  const int h = bh % nh, b = bh / nh;
  const int row0 = qt * kRows, col0 = sl * kSliceF;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const uint8_t* vrow = key_valid + b * valid_sb;
  const float shift = pair_has_valid_key(vrow, s) ? 0.0f : kMaskBias;  // for the lse

  float o[8][4], m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.0f;
  }
  for (int key0 = 0; key0 < s; key0 += kRows) {
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      stage_f32(qs, qb, q_sr, row0, g, c0, hd);
      stage_f32(ks, kb, k_sr, key0, s, c0, hd);
      __syncthreads();
      mm_nt(sc, qs, ks, ty, tx);
    }
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + 4 * tx + j;
      bias[j] = key >= s ? -INFINITY : (vrow[key] ? 0.0f : kMaskBias);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = sc[i][j] * scale + bias[j];
        tmax = fmaxf(tmax, sc[i][j]);
      }
      // finite: every tile holds a key < s
      const float m_new = fmaxf(m[i], row_max16(tmax));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[i][j] *= alpha;
        const float p = expf(sc[i][j] - m_new);
        l[i] += p;
        ps[(8 * ty + i) * kLdF + 4 * tx + j] = p;
      }
    }
    stage_f32(vs, vb, v_sr, key0, s, col0, hd);
    __syncthreads();
    mm_nn(o, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float sum = row_sum16(l[i]);  // every lane shuffles: before any exit
    const int row = row0 + 8 * ty + i;
    if (row >= g) continue;
    const float inv = 1.0f / sum;
    float res[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) res[j] = o[i][j] * inv;
    if (col0 + 4 * tx < hd)
      store_unit(out + ((static_cast<size_t>(b) * g + row) * nh + h) * hd + col0 + 4 * tx, res);
    if (lse != nullptr && sl == 0 && tx == 0)
      lse[(static_cast<size_t>(b) * nh + h) * g + row] = (m[i] - shift) + logf(sum);
  }
}

// ------------------------------------------------------- wide, Hopper body

// Head dims above 256 on wgmma + TMA (the header note): S once per (query
// tile, key tile), every output column from it. The ring, its side warps
// and the products are csrc/wide_sm90.cuh's, shared with kernels C and D.
namespace wide {

using namespace wgmma_sm90;
using namespace wide_sm90;
// declared here, so that they hide the file's own names
using wide_sm90::Cfg;
using wide_sm90::kMaxStages;
using wide_sm90::kRows;
using wide_sm90::kSmemMax;
using wide_sm90::kThreads;
using wide_sm90::kTile;
using hopper::Maps;

// exp(z) as the other bodies take it: f32 expf, bf16 exp2f of z log2(e)
// (z is a difference, taken before the scaling: at m ~ -1e9, no valid key,
// a folded log2(e) would lose it)
template <typename T>
__device__ __forceinline__ float softmax_exp(float z) {
  return std::is_same<T, float>::value ? expf(z) : exp2f(z * kLog2e);
}

// End of a key tile's chunks: x = S (rows queries 16 warp + r and + 8,
// columns keys 8j + cq, + 1 of the tile) times scale plus the key bias in
// f32 (0 at valid keys, -1e9 at masked ones from the tile's mask word,
// -inf past s: n_keys keys of the tile lie below s); each row's running max
// m and sum l moved on, P = exp(S - m) in place with m the max after this
// tile (rounded to bf16 only when stored, as the TPU kernel rounds p
// after subtracting its running max), stored (store_frags), and each row's
// rescale factor exp(m before - m after) at alpha_t (0 on the first tile,
// m = -inf then)
template <typename T>
__device__ __forceinline__ void finish_a(float (&x)[32], unsigned char* st, float* alpha_t, uint64_t bits, int n_keys,
                                         float (&m)[2], float (&l)[2], float scale, int tid) {
  const int cq = 2 * (tid & 3);
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + cq + (e & 1);
      const float bias = col >= n_keys ? -INFINITY : (((bits >> col) & 1) ? 0.0f : kMaskBias);
      x[4 * j + e] = x[4 * j + e] * scale + bias;
      tmax[e >> 1] = fmaxf(tmax[e >> 1], x[4 * j + e]);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
    const float m_new = fmaxf(m[i], tmax[i]);  // finite: a running tile holds a key < s
    alpha[i] = softmax_exp<T>(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    x[e] = softmax_exp<T>(x[e] - m[(e >> 1) & 1]);
    l[(e >> 1) & 1] += x[e];
  }
  store_frags<T>(st, x, tid);
  if ((tid & 3) == 0) {
    const int row = 16 * (tid >> 5) + ((tid & 31) >> 2);
    alpha_t[row] = alpha[0];
    alpha_t[row + 8] = alpha[1];
  }
}

// One block per (pair, head, tile of 64 query rows), the tile fastest.
// Phase 1: per running key tile (one with a valid key; in a pair with none,
// every tile), S = Q K^T over the head dim in chunks, then P and each row's
// rescale factor stored; the lse from the rows' final m and l. Phase 2: per
// slice of columns, O = sum of P V over the running tiles, O rescaled
// before each tile's product, then O / l stored.
template <typename T>
__global__ void __launch_bounds__(kThreads + Cfg<T>::kSide, Cfg<T>::kMinBlocksA)
attention_fwd_wide_wgmma_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ key_valid,
                                T* __restrict__ out, float* __restrict__ lse, int g, int s, int nh, int hd, int n_qt,
                                int n_st, long long valid_sb, float scale) {
  using C = Cfg<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NB = kF32 ? 1 : 2;  // 64-column output blocks of a slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int n_kt = (s + kRows - 1) / kRows;
  unsigned char* stored = smem + n_st * C::kSlotA;  // running tile i's P at i * kStoreA
  float* alphas = reinterpret_cast<float*>(stored + static_cast<size_t>(n_kt) * C::kStoreA);  // [running tile][row]
  uint64_t* full = reinterpret_cast<uint64_t*>(alphas + n_kt * kRows);
  uint64_t* ready = full + kMaxStages;  // [n_st] each, as side_loop says
  uint64_t* empty = ready + kMaxStages;
  uint64_t* tile_bits = empty + kMaxStages;  // [n_kt]
  int* run = reinterpret_cast<int*>(tile_bits + n_kt);  // the running tiles, in order
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt, bh = blockIdx.x / n_qt;
  const int h = bh % nh, b = bh / nh;
  const int row0 = qt * kRows;

  if (tid == 0) {
    for (int i = 0; i < n_st; ++i) {
      mbar_init(full + i, 1);
      mbar_init(ready + i, C::kSide);
      mbar_init(empty + i, kThreads / 32);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  // one word of valid-key bits per key tile (the barrier also publishes
  // the mbarriers' init)
  const uint8_t* vrow = key_valid + b * valid_sb;
  bool any_local = false;
  for (int t = warp; t < n_kt; t += blockDim.x / 32) {
    const uint64_t bits = attn_wide::key_bits(vrow, t * kRows, s, lane);
    if (lane == 0) tile_bits[t] = bits;
    any_local |= bits != 0;
  }
  const bool any_valid = __syncthreads_or(any_local);
  // the running key tiles: a tile without a valid key adds exactly 0 when
  // the pair has one (exp(-1e9 - m) is 0 in f32); a pair with none attends
  // every key
  int n_run = 0;
  for (int t = 0; t < n_kt; ++t) {
    if (any_valid && tile_bits[t] == 0) continue;
    if (tid == 0) run[n_run] = t;
    ++n_run;
  }
  __syncthreads();  // publishes run
  const int n_ch = (hd + C::kCols - 1) / C::kCols, n_sl = (hd + C::kSliceA - 1) / C::kSliceA;
  const int n1 = n_run * n_ch, n_all = n1 + n_sl * n_run;

  // step f's tiles into its slot, issued by the threads that pass `on`.
  // Phase 1 (f < n1), running tile f / n_ch over chunk f % n_ch: the
  // block's Q rows (tile 0) and the key tile's K rows (tile 1). Phase 2,
  // slice (f - n1) / n_run of running tile (f - n1) % n_run: its V columns
  // as two tiles (bf16 64-column blocks, f32 32-column boxes).
  auto issue = [&](int f, int st, bool on) {
    const bool p1 = f < n1;
    const int f2 = f - n1, key0 = run[p1 ? f / n_ch : f2 % n_run] * kRows;
    const int c0 = p1 ? (f % n_ch) * C::kCols : (f2 / n_run) * C::kSliceA;
    unsigned char* slot = smem + st * C::kSlotA;
    uint64_t* bar = full + st;
    mbar_arrive_expect_tx(bar, 2 * kTile, on);
    load_tile(slot, p1 ? maps.q : maps.v, bar, h, p1 ? row0 : key0, b, on, c0);
    load_tile(slot + kTile, p1 ? maps.k : maps.v, bar, h, key0, b, on, p1 ? c0 : c0 + C::kCols);
  };
  // the side warps (uniform in a warp, as the compiler is told)
  if (__shfl_sync(0xffffffffu, tid / kThreads, 0)) {
    side_loop<T, 1, C::kSlotA>(issue, full, ready, empty, smem, n_st, n1, n_all, tid - kThreads);
    return;
  }
  // one ring step: wait for the step's slot (f32: its split operands),
  // work on it, then hand it back to the producer
  Ring ring{n_st};
  auto step = [&](auto&& work) {
    mbar_wait((kF32 ? ready : full) + ring.slot, ring.parity);
    work(smem + ring.slot * C::kSlotA);
    mbar_arrive(empty + ring.slot, lane == 0);
    ring.next();
  };

  float x[32];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // rows 16 warp + r and + 8; l this thread's share
  for (int i = 0; i < n_run; ++i) {
    for (int c = 0; c < n_ch; ++c) step([&](unsigned char* slot) { chunk<T>(x, slot, c == 0, tid); });
    const int t = run[i];
    finish_a<T>(x, stored + static_cast<size_t>(i) * C::kStoreA, alphas + i * kRows, tile_bits[t], s - t * kRows, m,
                l, scale, tid);
  }
  const int r = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (lse != nullptr && (lane & 3) == 0) {
    const float shift = any_valid ? 0.0f : kMaskBias;  // exact: m is -1e9 + a multiple of 64
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 16 * warp + r + 8 * i;
      if (row < g) lse[(static_cast<size_t>(b) * nh + h) * g + row] = (m[i] - shift) + logf(l[i]);
    }
  }
  __syncwarp();  // the rescale factors: lane 4r of this warp wrote those lanes 4r..4r+3 read
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  float o[NB][32];
  T* out_b = out + (static_cast<size_t>(b) * g * nh + h) * hd;
  const long long rs = static_cast<long long>(nh) * hd;
  for (int sl = 0; sl < n_sl; ++sl) {
    for (int i = 0; i < n_run; ++i) {
      const unsigned char* st = stored + static_cast<size_t>(i) * C::kStoreA;
      if (i > 0) {  // O <- O exp(m before tile i - m after it), before the tile's product
        const float a[2] = {alphas[i * kRows + 16 * warp + r], alphas[i * kRows + 16 * warp + r + 8]};
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[j][e] *= a[(e >> 1) & 1];
      }
      step([&](unsigned char* slot) {
        if constexpr (kF32)
          f32_block_step(o[0], slot, reinterpret_cast<const float4*>(st), i > 0, tid);
        else
          bf16_block_step(o, slot, st, i > 0, tid);
      });
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[j][e] *= inv[(e >> 1) & 1];
      store_block<T>(out_b, rs, o[j], 1.0f, row0, g, sl * C::kSliceA + 64 * j, hd, tid);
    }
  }
}

}  // namespace wide

// ----------------------------------------------------------------- launch

template <int HD, int NW, bool kCausal = false>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* key_valid,
                        void* out, float* lse, int b, int g, int s, int nh, const long long* st,
                        float scale, cudaStream_t stream) {
  const int n_tiles = (s + kKeyTile - 1) / kKeyTile;
  const size_t smem = bf16_smem_bytes<HD, NW>(n_tiles);
  auto kern = attention_fwd_bf16_kernel<HD, NW>;
  if constexpr (kCausal) kern = attention_fwd_bf16_causal_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (g + 16 * NW - 1) / (16 * NW);
  const long long blocks = static_cast<long long>(b) * nh * n_qt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<bf16*>(out), lse, g, s, nh, n_qt,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  return cudaGetLastError();
}

// the Hopper body (bf16, hd = 64, g > 16): one block per (pair, head, pass
// of two query tiles), or of one where two would give fewer blocks than
// the card has SMs (a micro-batch of a few pairs)
cudaError_t launch_bf16_hopper(const void* q, const void* k, const void* v, const void* key_valid, void* out,
                               float* lse, int b, int g, int s, int nh, const long long* st, float scale,
                               cudaStream_t stream) {
  using wgmma_sm90::make_row_map;
  hopper::Maps maps;
  cudaError_t err = make_row_map(&maps.q, q, b, g, nh, st[0], st[1], st[2]);
  if (err == cudaSuccess) err = make_row_map(&maps.k, k, b, s, nh, st[3], st[4], st[5]);
  if (err == cudaSuccess) err = make_row_map(&maps.v, v, b, s, nh, st[6], st[7], st[8]);
  const size_t smem = hopper::smem_bytes((s + hopper::kRows - 1) / hopper::kRows);
  auto kern = hopper::attention_fwd_wgmma_kernel;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  const int n_qt = (g + hopper::kRows - 1) / hopper::kRows;
  const long long units = static_cast<long long>(b) * nh;
  const int n_q = units * ((n_qt + hopper::kQTiles - 1) / hopper::kQTiles) < sms ? 1 : hopper::kQTiles;
  const int n_pass = (n_qt + n_q - 1) / n_q;
  if (units * n_pass > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(units * n_pass), hopper::kThreads, smem, stream>>>(
      maps, static_cast<const uint8_t*>(key_valid), static_cast<bf16*>(out), lse, g, s, nh, n_q, n_pass, st[9],
      scale);
  return cudaGetLastError();
}

// whether the Hopper body takes these q, k, v: every axis TMA maps with a
// positive stride (a broadcast view, stride 0, takes the mma.sync body) and
// the mask words of s keys in shared memory
bool hopper_takes(int s, const long long* st) {
  for (int i = 0; i < 9; ++i)
    if (st[i] <= 0) return false;
  return hopper::smem_bytes((s + hopper::kRows - 1) / hopper::kRows) <= 227 * 1024;
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* key_valid,
                       void* out, float* lse, int b, int g, int s, int nh, const long long* st,
                       float scale, cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(kF32Tile) * HD + kF32Tile) * sizeof(float);
  auto kern = attention_fwd_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int kRows = kF32Threads / Split<HD>::kLanes;
  const dim3 grid(b * nh, (g + kRows - 1) / kRows);
  kern<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(key_valid), static_cast<float*>(out), lse, g, s, nh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int is_bf16, const void* q, const void* k, const void* v,
                   const void* key_valid, void* out, float* lse, int b, int g, int s, int nh,
                   const long long* st, float scale, cudaStream_t stream) {
  if (!is_bf16) return launch_f32<HD>(q, k, v, key_valid, out, lse, b, g, s, nh, st, scale, stream);
  if (g <= 16)
    return launch_bf16<HD, 1>(q, k, v, key_valid, out, lse, b, g, s, nh, st, scale, stream);
  if (HD == 64 && hopper_takes(s, st))
    return launch_bf16_hopper(q, k, v, key_valid, out, lse, b, g, s, nh, st, scale, stream);
  return launch_bf16<HD, 4>(q, k, v, key_valid, out, lse, b, g, s, nh, st, scale, stream);
}

// the wide route's Hopper body (namespace wide): one block per (pair, head,
// tile of 64 query rows), the ring three slots where they fit, else two
template <typename T>
cudaError_t launch_wide_hopper(const void* q, const void* k, const void* v, const void* key_valid, void* out,
                               float* lse, int b, int g, int s, int nh, int hd, const long long* st, float scale,
                               cudaStream_t stream) {
  using wgmma_sm90::make_row_map;
  using wide_sm90::Body;
  constexpr bool kF32 = std::is_same<T, float>::value;
  hopper::Maps maps;
  cudaError_t err = make_row_map(&maps.q, q, b, g, nh, st[0], st[1], st[2], hd, kF32);
  if (err == cudaSuccess) err = make_row_map(&maps.k, k, b, s, nh, st[3], st[4], st[5], hd, kF32);
  if (err == cudaSuccess) err = make_row_map(&maps.v, v, b, s, nh, st[6], st[7], st[8], hd, kF32);
  if (err != cudaSuccess) return err;
  const int n_kt = (s + wide::kRows - 1) / wide::kRows, n_qt = (g + wide::kRows - 1) / wide::kRows;
  constexpr int pref = wide::Cfg<T>::kStagesA;
  const int n_st = wide_sm90::smem_bytes<T, Body::A>(pref, n_kt, n_kt) <= wide::kSmemMax ? pref : 2;
  const size_t smem = wide_sm90::smem_bytes<T, Body::A>(n_st, n_kt, n_kt);
  auto kern = wide::attention_fwd_wide_wgmma_kernel<T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(b) * nh * n_qt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), wide::kThreads + wide::Cfg<T>::kSide, smem, stream>>>(
      maps, static_cast<const uint8_t*>(key_valid), static_cast<T*>(out), lse, g, s, nh, hd, n_qt, n_st, st[9],
      scale);
  return cudaGetLastError();
}

// whether the wide Hopper body takes these q, k, v: every axis TMA maps has
// a positive stride (a broadcast view, stride 0, takes the slice bodies),
// and two ring slots, P and the rescale factors of every key tile, the
// barriers and the mask words fit in a block's shared memory (bf16: s <=
// 1472; f32: s <= 448)
bool wide_hopper_takes(int is_bf16, int s, const long long* st) {
  using wide_sm90::Body;
  for (int i = 0; i < 9; ++i)
    if (st[i] <= 0) return false;
  const int n_kt = (s + wide::kRows - 1) / wide::kRows;
  const size_t smem = is_bf16 ? wide_sm90::smem_bytes<bf16, Body::A>(2, n_kt, n_kt)
                              : wide_sm90::smem_bytes<float, Body::A>(2, n_kt, n_kt);
  return smem <= static_cast<size_t>(wide::kSmemMax);
}

// the wide route, hd above 256 (any multiple of 16): the Hopper body where
// it takes the inputs (wide_hopper_takes), which computes the scores once;
// past that the slice bodies, which recompute them for each output slice
cudaError_t launch_wide(int is_bf16, const void* q, const void* k, const void* v,
                        const void* key_valid, void* out, float* lse, int b, int g, int s, int nh,
                        int hd, const long long* st, float scale, cudaStream_t stream) {
  if (wide_hopper_takes(is_bf16, s, st))
    return is_bf16 ? launch_wide_hopper<bf16>(q, k, v, key_valid, out, lse, b, g, s, nh, hd, st, scale, stream)
                   : launch_wide_hopper<float>(q, k, v, key_valid, out, lse, b, g, s, nh, hd, st, scale, stream);
  using namespace attn_wide;
  const int n_qt = (g + kRows - 1) / kRows;
  const int n_sl = (hd + (is_bf16 ? kSliceA : kSliceF) - 1) / (is_bf16 ? kSliceA : kSliceF);
  const long long blocks = static_cast<long long>(b) * nh * n_sl * n_qt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (is_bf16) {
    const size_t smem = (2 * kRows * kLdB + kRows * (kSliceA + 8)) * sizeof(bf16);
    auto kern = attention_fwd_bf16_wide_kernel;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const uint8_t*>(key_valid), static_cast<bf16*>(out), lse, g, s, nh, hd, n_qt, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  } else {
    const size_t smem = 4 * kRows * kLdF * sizeof(float);
    auto kern = attention_fwd_f32_wide_kernel;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const uint8_t*>(key_valid), static_cast<float*>(out), lse, g, s, nh, hd, n_qt, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], scale);
  }
  return cudaGetLastError();
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
  float* lse_f = static_cast<float*>(lse);
  switch (hd) {
#define ATTN_CASE(H) \
    case H: return launch<H>(is_bf16, q, k, v, key_valid, out, lse_f, b, g, s, nh, st, scale, cs);
    ATTN_HEAD_DIMS(ATTN_CASE)
#undef ATTN_CASE
    default:
      if (hd <= 256 || hd % 16) return cudaErrorInvalidValue;
      return launch_wide(is_bf16, q, k, v, key_valid, out, lse_f, b, g, s, nh, hd, st, scale, cs);
  }
}

// The causal entry: attention_fwd's arguments, for bf16 q, k, v with g = s
// and hd 192, the one width a configuration runs (DeepSeek-V2-Lite's qk
// head dim; ops/attention.py pads narrower ones to it); no lse.
extern "C" int attention_fwd_causal(const void* q, const void* k, const void* v,
                                    const void* key_valid, void* out, void* lse, int is_bf16, int b,
                                    int g, int s, int nh, int hd, long long q_sb,
                                    long long q_sr, long long q_sh, long long k_sb,
                                    long long k_sr, long long k_sh, long long v_sb,
                                    long long v_sr, long long v_sh, long long valid_sb,
                                    float scale, int device, void* stream) {
  if (!is_bf16 || lse != nullptr || g != s) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long st[10] = {q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (hd != kCausalHeadDim) return cudaErrorInvalidValue;
  return launch_bf16<kCausalHeadDim, 4, true>(q, k, v, key_valid, out, nullptr, b, g, s, nh, st, scale, cs);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
