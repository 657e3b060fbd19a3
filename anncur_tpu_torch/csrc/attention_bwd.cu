// Kernels C and D: attention backward for the cross-encoder, for Hopper (sm_90a).
//
// Replace the backward of the stock Pallas TPU flash attention that
// anncur_tpu/models/bert.py::_flash_attention reaches under jax.grad:
// _flash_attention_bwd_dkv (kernel C here) and _flash_attention_bwd_dq
// (kernel D), jax/experimental/pallas/ops/tpu/flash_attention.py. With the
// forward's row log-sum-exp lse (csrc/attention.cu) and D = rowsum(dO * O)
// (a plain torch reduction beforehand, as JAX computes it outside Pallas):
//     P  = exp(Q K^T * scale + bias - shift - lse)   (recomputed, never stored)
//     dV = P^T dO
//     dS = P * (dO V^T - D)
//     dK = scale * dS^T Q
//     dQ = scale * dS K
// bias = 0 at valid keys and -1e9 at padding, as in the forward, so a masked
// key's P is exactly 0 in f32 and it gets dK = dV = 0 exactly. shift is 0,
// or -1e9 in a pair with no valid key, whose lse the forward writes without
// the -1e9 (csrc/attention.cu): -1e9 + log(l) rounds to -1e9 in f32, and P
// would come out as 1 instead of 1/l. Scores, exponentials and sums are f32;
// dQ, dK, dV are written in q's dtype.
//
// Bound on the H100: at the train step's shape (63 pairs, g = s = 255,
// nh = 12, hd = 64, bf16, every key valid) kernel C reads Q, K, V, dO, lse
// and D and writes dK and dV, 150 MB: 0.045 ms at 3.35 TB/s. Its four
// products (S^T, dP^T, dV, dK) are 25 GFLOP, 0.025 ms on the bf16 tensor
// cores. Kernel D moves 125 MB (0.037 ms) for three products (0.019 ms).
// Both lie below the bf16 ridge (~295 FLOP/B), so bytes bound them; with
// mma.sync short of the tensor-core peak the two times come close.
//
// bf16 design (hd any multiple of 16 up to 256, templated on HD): mma.sync m16n8k16
// (bf16 in, f32 accumulate), ldmatrix and cp.async from csrc/mma_sm90.cuh.
// - Kernel C: one block per (pair, head, tile of 64 keys), the tile index
//   fastest, so the tiles of one head run together and share its Q and dO
//   in L2. Four warps own 16 keys each and keep their K and V rows in
//   registers as A fragments. The block streams Q, dO, lse and D in tiles
//   of QT query rows (64; 16 when g <= 16), double-buffered with cp.async;
//   rows >= g are zero-filled and get lse = +inf, so their P is 0. Each
//   16-query step makes S^T = K Q^T and dP^T = V dO^T (Q and dO as B
//   through plain ldmatrix), then in f32 P^T and dS^T = P^T * (dP^T - D),
//   then dV += P^T dO and dK += dS^T Q: P^T and dS^T go to the tensor cores
//   as bf16 A fragments straight from the accumulators, dO and Q as B
//   through ldmatrix.trans. A block whose 64 keys are all masked, in a pair
//   that has a valid key, writes zeros and returns.
// - Kernel D: one block per (pair, head, tile of 16 * NW query rows), NW = 4
//   (1 when g <= 16, so no warp computes only padding). Each warp keeps its
//   16 rows of Q and dO as A fragments and their lse and D in registers. K
//   and V stream in 64-key tiles, double-buffered; a tile without a valid
//   key is skipped when the pair has one (one 64-bit ballot word per tile,
//   as in kernel A; tile 0 always runs, and adds exact zeros if masked).
//   Each 16-key step makes S = Q K^T and dP = dO V^T (K and V as B through
//   plain ldmatrix), dS in f32, and dQ += dS K (dS in bf16 from the
//   accumulators, K through ldmatrix.trans).
// - P and dS are rounded to bf16 before the dV, dK and dQ products, as the
//   TPU kernel rounds them (p.astype(do.dtype), ds.astype(q.dtype)); scores,
//   exponentials, dP - D and every sum stay f32. The exponent is the
//   difference S * scale + bias - shift - lse, taken before the log2(e)
//   scaling: at lse ~ -1e9 a folded FMA would lose it.
// - Shared rows are padded by 16 bytes, so the eight row addresses of each
//   8x8 ldmatrix fall in distinct banks. The epilogues stage the bf16
//   results in the warp's own shared rows for 16-byte coalesced stores.
// - Every output row is written by one block and no atomics are used, so
//   two launches on the same inputs give the same bits.
//
// Head dims above 256 (any multiple of 16) take the wide route (the
// *_wide_kernel bodies; shared pieces in csrc/attention_wide.cuh): S and
// dP stream their operands in 64-column chunks, and each block writes one
// 64-column slice of dK and dV (C) or dQ (D), recomputing its scores.
//
// f32 (no main-path caller; the card tests use it): the first version's
// CUDA-core bodies. One thread would hold k, v, dK and dV rows (4 x hd f32 =
// 256 registers at hd=64), too many, so the head dim is split across SPLIT
// neighbouring lanes (csrc/attention_common.cuh: at most 32 dims each where
// the row's 16-byte units allow, SPLIT = 2 at hd=64). Each lane holds its
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
// masked.
//
// Layout is the JAX one: q (b, g, nh, hd), k and v (b, s, nh, hd) with any
// strides on the batch, row and head axes, hd contiguous and rows 16-byte
// aligned; dO, dQ (b, g, nh, hd) and dK, dV (b, s, nh, hd) contiguous; lse
// and D (b, nh, g) f32. The kernels allocate nothing and run on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "attention_wide.cuh"
#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace mma_sm90;
using namespace attn_f32;

constexpr int kTile = 64;  // keys of a kernel C block; keys of a kernel D tile
constexpr float kMaskBias = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ kernel C, bf16

template <int HD, int QT>
constexpr size_t dkv_smem_bytes() {
  // the block's K and V rows, two stages of QT rows of Q and dO (rows padded
  // by 8 elements), two stages of QT lse and D values
  return static_cast<size_t>(2 * kTile + 4 * QT) * (HD + 8) * sizeof(bf16) +
         static_cast<size_t>(4 * QT) * sizeof(float);
}

// Three kernel C blocks per SM at hd <= 64: ptxas then keeps the body to
// 168 registers (a few spilled bytes); left free it takes 174, and only
// two fit. The cap timed faster at the train step's shape.
template <int HD>
constexpr int kDkvMinBlocksPerSm = HD <= 64 ? 3 : 1;

template <int HD, int QT>
__global__ void __launch_bounds__(128, kDkvMinBlocksPerSm<HD>)
attention_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                              const bf16* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, bf16* __restrict__ dk_out,
                              bf16* __restrict__ dv_out, int g, int s, int nh, int n_kt,
                              long long q_sb, long long q_sr, long long q_sh,
                              long long k_sb, long long k_sr, long long k_sh,
                              long long v_sb, long long v_sr, long long v_sh,
                              long long valid_sb, float scale) {
  constexpr int kThreads = 128, kLd = HD + 8, kUnits = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // the block's kTile keys
  bf16* vs = ks + kTile * kLd;
  bf16* qs = vs + kTile * kLd;    // 2 stages of QT rows
  bf16* dos = qs + 2 * QT * kLd;  // 2 stages of QT rows
  float* lse_s = reinterpret_cast<float*>(dos + 2 * QT * kLd);  // 2 stages of QT
  float* delta_s = lse_s + 2 * QT;                              // 2 stages of QT

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt = blockIdx.x % n_kt;
  const int bh = blockIdx.x / n_kt;
  const int h = bh % nh, b = bh / nh;
  const int key0 = kt * kTile;
  const int n_qt = (g + QT - 1) / QT;

  // the block's K and V rows (keys >= s zero) and query tile 0
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  for (int u = tid; u < kTile * kUnits; u += kThreads) {
    const int r = u / kUnits, c = u % kUnits;
    const int key = key0 + r;
    const bool ok = key < s;
    cp_async_16(smem_addr(ks + r * kLd + c * 8), ok ? kb + key * k_sr + c * 8 : kb, ok ? 16 : 0);
    cp_async_16(smem_addr(vs + r * kLd + c * 8), ok ? vb + key * v_sr + c * 8 : vb, ok ? 16 : 0);
  }
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* dob = dout + (static_cast<size_t>(b) * g * nh + h) * HD;
  const long long do_sr = static_cast<long long>(nh) * HD;
  const float* lse_b = lse + (static_cast<size_t>(b) * nh + h) * g;
  const float* delta_b = delta + (static_cast<size_t>(b) * nh + h) * g;
  auto load_q = [&](int t, int stage) {
    bf16* qd = qs + stage * QT * kLd;
    bf16* dd = dos + stage * QT * kLd;
    for (int u = tid; u < QT * kUnits; u += kThreads) {
      const int r = u / kUnits, c = u % kUnits;
      const int row = t * QT + r;
      const bool ok = row < g;
      cp_async_16(smem_addr(qd + r * kLd + c * 8), ok ? qb + row * q_sr + c * 8 : qb, ok ? 16 : 0);
      cp_async_16(smem_addr(dd + r * kLd + c * 8), ok ? dob + row * do_sr + c * 8 : dob, ok ? 16 : 0);
    }
    for (int r = tid; r < QT; r += kThreads) {
      const int row = t * QT + r;
      float* ls = lse_s + stage * QT + r;
      float* ds = delta_s + stage * QT + r;
      if (row < g) {
        cp_async_4(smem_addr(ls), lse_b + row);
        cp_async_4(smem_addr(ds), delta_b + row);
      } else {  // P = exp(... - inf) = 0: the row adds nothing
        *ls = INFINITY;
        *ds = 0.0f;
      }
    }
  };
  load_q(0, 0);
  cp_async_commit();

  // while those are in flight: does the pair have a valid key, and this tile?
  const uint8_t* vrow = key_valid + b * valid_sb;
  int any = 0;
  for (int j = tid; j < s; j += kThreads) any |= vrow[j];
  const bool pair_any = __syncthreads_or(any);
  const bool tile_any = __syncthreads_or(tid < kTile && key0 + tid < s && vrow[key0 + tid]);
  if (pair_any && !tile_any) {
    // every P of the tile is exp(-1e9 + ...) = 0 in f32: dK = dV = 0 exactly
    cp_async_wait<0>();
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int u = tid; u < kTile * kUnits; u += kThreads) {
      const int key = key0 + u / kUnits;
      if (key < s) {
        const size_t o = ((static_cast<size_t>(b) * s + key) * nh + h) * HD + (u % kUnits) * 8;
        *reinterpret_cast<uint4*>(dk_out + o) = zero;
        *reinterpret_cast<uint4*>(dv_out + o) = zero;
      }
    }
    return;
  }
  const float shift = pair_any ? 0.0f : kMaskBias;

  const int wrow = warp * 16;     // this warp's first key in the tile
  const int r = lane >> 2;        // this lane's keys: wrow + r and wrow + r + 8
  const int kq = 2 * (lane & 3);  // this lane's first query column of a C fragment
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + wrow + r + 8 * i;
    bias[i] = key >= s ? -INFINITY : (vrow[key] ? 0.0f : kMaskBias);
  }
  uint32_t kf[HD / 16][4], vf[HD / 16][4];
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.0f;

  for (int t = 0; t < n_qt; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_qt) load_q(t + 1, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (wrow + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(kf[kk], smem_addr(ks + off));
        ldmatrix_x4(vf[kk], smem_addr(vs + off));
      }
    }
    const bf16* qd = qs + stage * QT * kLd;
    const bf16* dd = dos + stage * QT * kLd;
    const float* ls = lse_s + stage * QT;
    const float* ds = delta_s + stage * QT;
#pragma unroll
    for (int i0 = 0; i0 < QT; i0 += 16) {
      // S^T = K Q^T and dP^T = V dO^T over 16 queries: two n-tiles of 8
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (i0 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bd[4];
        ldmatrix_x4(bq, smem_addr(qd + off));
        ldmatrix_x4(bd, smem_addr(dd + off));
        mma_bf16_16816(st[0], kf[kk], bq[0], bq[1]);
        mma_bf16_16816(st[1], kf[kk], bq[2], bq[3]);
        mma_bf16_16816(dpt[0], vf[kk], bd[0], bd[1]);
        mma_bf16_16816(dpt[1], vf[kk], bd[2], bd[3]);
      }
      // P^T and dS^T in f32: rows are this lane's two keys, columns queries
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 lq = *reinterpret_cast<const float2*>(ls + i0 + 8 * j + kq);
        const float2 dq = *reinterpret_cast<const float2*>(ds + i0 + 8 * j + kq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = st[j][e] * scale + bias[e >> 1];
          const float p = exp2f((x - shift - ((e & 1) ? lq.y : lq.x)) * kLog2e);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dq.y : dq.x));
        }
      }
      const uint32_t pa[4] = {pack_bf16x2(st[0][0], st[0][1]), pack_bf16x2(st[0][2], st[0][3]),
                              pack_bf16x2(st[1][0], st[1][1]), pack_bf16x2(st[1][2], st[1][3])};
      const uint32_t sa[4] = {pack_bf16x2(dpt[0][0], dpt[0][1]), pack_bf16x2(dpt[0][2], dpt[0][3]),
                              pack_bf16x2(dpt[1][0], dpt[1][1]), pack_bf16x2(dpt[1][2], dpt[1][3])};
      // dV += P^T dO and dK += dS^T Q, the 16 queries as the reduced axis
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        const int off = (i0 + (lane & 15)) * kLd + dp * 16 + (lane >> 4) * 8;
        uint32_t bd[4], bq[4];
        ldmatrix_x4_trans(bd, smem_addr(dd + off));
        mma_bf16_16816(dv[2 * dp], pa, bd[0], bd[1]);
        mma_bf16_16816(dv[2 * dp + 1], pa, bd[2], bd[3]);
        ldmatrix_x4_trans(bq, smem_addr(qd + off));
        mma_bf16_16816(dk[2 * dp], sa, bq[0], bq[1]);
        mma_bf16_16816(dk[2 * dp + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  // dK * scale and dV in bf16 through this warp's own rows of the K and V tiles
  bf16* kd = ks + wrow * kLd;
  bf16* vd = vs + wrow * kLd;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    *reinterpret_cast<uint32_t*>(kd + r * kLd + 8 * d + kq) = pack_bf16x2(dk[d][0] * scale, dk[d][1] * scale);
    *reinterpret_cast<uint32_t*>(kd + (r + 8) * kLd + 8 * d + kq) = pack_bf16x2(dk[d][2] * scale, dk[d][3] * scale);
    *reinterpret_cast<uint32_t*>(vd + r * kLd + 8 * d + kq) = pack_bf16x2(dv[d][0], dv[d][1]);
    *reinterpret_cast<uint32_t*>(vd + (r + 8) * kLd + 8 * d + kq) = pack_bf16x2(dv[d][2], dv[d][3]);
  }
  __syncwarp();
  for (int u = lane; u < 16 * kUnits; u += 32) {
    const int rr = u / kUnits, c = u % kUnits;
    const int key = key0 + wrow + rr;
    if (key < s) {
      const size_t o = ((static_cast<size_t>(b) * s + key) * nh + h) * HD + c * 8;
      *reinterpret_cast<uint4*>(dk_out + o) = *reinterpret_cast<const uint4*>(kd + rr * kLd + c * 8);
      *reinterpret_cast<uint4*>(dv_out + o) = *reinterpret_cast<const uint4*>(vd + rr * kLd + c * 8);
    }
  }
}

// ------------------------------------------------------------ kernel D, bf16

template <int HD, int NW>
constexpr size_t dq_smem_bytes(int n_tiles) {
  // Q and dO tiles, two stages of K and V tiles (rows padded by 8 elements),
  // one mask word per key tile
  return static_cast<size_t>(2 * 16 * NW + 4 * kTile) * (HD + 8) * sizeof(bf16) +
         static_cast<size_t>(n_tiles) * sizeof(uint64_t);
}

template <int HD, int NW>
__global__ void __launch_bounds__(NW * 32)
attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, bf16* __restrict__ dq_out, int g,
                             int s, int nh, int n_qt, long long q_sb, long long q_sr,
                             long long q_sh, long long k_sb, long long k_sr, long long k_sh,
                             long long v_sb, long long v_sr, long long v_sh,
                             long long valid_sb, float scale) {
  constexpr int kRows = 16 * NW, kThreads = 32 * NW, kLd = HD + 8, kUnits = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kRows * kLd;
  bf16* ks = dos + kRows * kLd;         // 2 stages of kTile rows
  bf16* vs = ks + 2 * kTile * kLd;      // 2 stages of kTile rows
  uint64_t* tile_bits = reinterpret_cast<uint64_t*>(vs + 2 * kTile * kLd);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % nh, b = bh / nh;
  const int row0 = qt * kRows;
  const int n_tiles = (s + kTile - 1) / kTile;

  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  auto load_kv = [&](int t, int stage) {
    bf16* kd = ks + stage * kTile * kLd;
    bf16* vd = vs + stage * kTile * kLd;
    for (int u = tid; u < kTile * kUnits; u += kThreads) {
      const int r = u / kUnits, c = u % kUnits;
      const int key = t * kTile + r;
      const bool ok = key < s;
      cp_async_16(smem_addr(kd + r * kLd + c * 8), ok ? kb + key * k_sr + c * 8 : kb, ok ? 16 : 0);
      cp_async_16(smem_addr(vd + r * kLd + c * 8), ok ? vb + key * v_sr + c * 8 : vb, ok ? 16 : 0);
    }
  };

  // the Q and dO tiles (rows >= g zero) and key tile 0, which always runs
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* dob = dout + (static_cast<size_t>(b) * g * nh + h) * HD;
  const long long do_sr = static_cast<long long>(nh) * HD;
  for (int u = tid; u < kRows * kUnits; u += kThreads) {
    const int r = u / kUnits, c = u % kUnits;
    const int row = row0 + r;
    const bool ok = row < g;
    cp_async_16(smem_addr(qs + r * kLd + c * 8), ok ? qb + row * q_sr + c * 8 : qb, ok ? 16 : 0);
    cp_async_16(smem_addr(dos + r * kLd + c * 8), ok ? dob + row * do_sr + c * 8 : dob, ok ? 16 : 0);
  }
  load_kv(0, 0);
  cp_async_commit();

  // one word of valid-key bits per key tile, while those are in flight
  const uint8_t* vrow = key_valid + b * valid_sb;
  bool any_local = false;
  for (int t = warp; t < n_tiles; t += NW) {
    const int j0 = t * kTile + lane, j1 = j0 + 32;
    const uint32_t lo = __ballot_sync(0xffffffffu, j0 < s && vrow[j0]);
    const uint32_t hi = __ballot_sync(0xffffffffu, j1 < s && vrow[j1]);
    if (lane == 0) tile_bits[t] = (static_cast<uint64_t>(hi) << 32) | lo;
    any_local |= (lo | hi) != 0;
  }
  const bool any_valid = __syncthreads_or(any_local);  // also publishes tile_bits
  auto next_tile = [&](int t) {
    while (any_valid && t < n_tiles && tile_bits[t] == 0) ++t;
    return t;
  };
  const float shift = any_valid ? 0.0f : kMaskBias;

  const int wrow = warp * 16;     // this warp's first row in the tile
  const int r = lane >> 2;        // this lane's rows: wrow + r and wrow + r + 8
  const int kq = 2 * (lane & 3);  // this lane's first key column of a C fragment
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wrow + r + 8 * i;
    const size_t at = (static_cast<size_t>(b) * nh + h) * g + row;
    lse_r[i] = row < g ? lse[at] : INFINITY;  // P = 0 on padding rows
    delta_r[i] = row < g ? delta[at] : 0.0f;
  }
  uint32_t qf[HD / 16][4], df[HD / 16][4];
  float dq[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.0f;
  int t = 0, stage = 0;
  bool first = true;

  while (t < n_tiles) {
    const int tn = next_tile(t + 1);
    if (tn < n_tiles) load_kv(tn, stage ^ 1);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (wrow + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qf[kk], smem_addr(qs + off));
        ldmatrix_x4(df[kk], smem_addr(dos + off));
      }
      first = false;
    }
    const bf16* kd = ks + stage * kTile * kLd;
    const bf16* vd = vs + stage * kTile * kLd;
    const uint64_t bits = tile_bits[t];
    const int n_keys = s - t * kTile;  // keys of the tile below s

#pragma unroll 1  // unrolled, the body holds more registers and timed slower
    for (int j0 = 0; j0 < kTile; j0 += 16) {
      // S = Q K^T and dP = dO V^T over 16 keys: two n-tiles of 8
      float sc[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (j0 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, smem_addr(kd + off));
        ldmatrix_x4(bv, smem_addr(vd + off));
        mma_bf16_16816(sc[0], qf[kk], bk[0], bk[1]);
        mma_bf16_16816(sc[1], qf[kk], bk[2], bk[3]);
        mma_bf16_16816(dp[0], df[kk], bv[0], bv[1]);
        mma_bf16_16816(dp[1], df[kk], bv[2], bv[3]);
      }
      // dS = P * (dP - D) in f32; keys past s get bias -inf, so P = 0
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + 8 * j + kq + (e & 1);
          const float bias = col >= n_keys ? -INFINITY : (((bits >> col) & 1) ? 0.0f : kMaskBias);
          const float x = sc[j][e] * scale + bias;
          const float p = exp2f((x - shift - lse_r[e >> 1]) * kLog2e);
          dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
        }
      }
      const uint32_t sa[4] = {pack_bf16x2(dp[0][0], dp[0][1]), pack_bf16x2(dp[0][2], dp[0][3]),
                              pack_bf16x2(dp[1][0], dp[1][1]), pack_bf16x2(dp[1][2], dp[1][3])};
      // dQ += dS K, the 16 keys as the reduced axis
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, smem_addr(kd + (j0 + (lane & 15)) * kLd + d * 16 + (lane >> 4) * 8));
        mma_bf16_16816(dq[2 * d], sa, bk[0], bk[1]);
        mma_bf16_16816(dq[2 * d + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
    t = tn;
    stage ^= 1;
  }

  // dQ * scale in bf16 through this warp's own rows of the Q tile
  bf16* os = qs + wrow * kLd;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    *reinterpret_cast<uint32_t*>(os + r * kLd + 8 * d + kq) = pack_bf16x2(dq[d][0] * scale, dq[d][1] * scale);
    *reinterpret_cast<uint32_t*>(os + (r + 8) * kLd + 8 * d + kq) = pack_bf16x2(dq[d][2] * scale, dq[d][3] * scale);
  }
  __syncwarp();
  for (int u = lane; u < 16 * kUnits; u += 32) {
    const int rr = u / kUnits, c = u % kUnits;
    const int row = row0 + wrow + rr;
    if (row < g)
      *reinterpret_cast<uint4*>(dq_out + ((static_cast<size_t>(b) * g + row) * nh + h) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(os + rr * kLd + c * 8);
  }
}

// ----------------------------------------------------------------- f32

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
attention_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const uint8_t* __restrict__ key_valid,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dk_out,
                             float* __restrict__ dv_out, int g, int s, int nh,
                             long long q_sb, long long q_sr, long long q_sh,
                             long long k_sb, long long k_sr, long long k_sh,
                             long long v_sb, long long v_sr, long long v_sh,
                             long long valid_sb, float scale) {
  using S = Split<HD>;
  constexpr int kKeys = kF32Threads / S::kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kTile * HD;
  float* lse_s = dos + kTile * HD;
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int part = threadIdx.x % S::kLanes;
  const int key = blockIdx.y * kKeys + threadIdx.x / S::kLanes;
  const bool in_range = key < s;
  const int key_c = in_range ? key : s - 1;
  const uint8_t* valid_row = key_valid + b * valid_sb;
  const float bias = valid_row[key_c] ? 0.0f : kMaskBias;
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
  const float shift = has_valid ? 0.0f : kMaskBias;

  float kr[S::kDims], vr[S::kDims], dk[S::kDims], dv[S::kDims];
  const float* kp = k + b * k_sb + key_c * k_sr + h * k_sh;
  const float* vp = v + b * v_sb + key_c * v_sr + h * v_sh;
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) {
    load_unit(kp + S::offset(part, t), kr + t * S::kUnit);
    load_unit(vp + S::offset(part, t), vr + t * S::kUnit);
  }
#pragma unroll
  for (int d = 0; d < S::kDims; ++d) dk[d] = dv[d] = 0.0f;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* dob = dout + (static_cast<size_t>(b) * g * nh + h) * HD;
  const float* lse_b = lse + (static_cast<size_t>(b) * nh + h) * g;
  const float* delta_b = delta + (static_cast<size_t>(b) * nh + h) * g;
  for (int i0 = 0; i0 < g; i0 += kTile) {
    const int n = min(kTile, g - i0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD>(qs, qb, q_sr, i0, n);
    stage_rows<HD>(dos, dob, static_cast<long long>(nh) * HD, i0, n);
    for (int i = threadIdx.x; i < n; i += kF32Threads) {
      lse_s[i] = lse_b[i0 + i];
      delta_s[i] = delta_b[i0 + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* qi = qs + i * HD;
      const float* doi = dos + i * HD;
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
      const float p = expf(sdot * scale + bias - shift - lse_s[i]);
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

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const uint8_t* __restrict__ key_valid,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ delta, float* __restrict__ dq_out, int g,
                            int s, int nh, long long q_sb, long long q_sr, long long q_sh,
                            long long k_sb, long long k_sr, long long k_sh,
                            long long v_sb, long long v_sr, long long v_sh,
                            long long valid_sb, float scale) {
  using S = Split<HD>;
  constexpr int kRows = kF32Threads / S::kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kTile * HD;
  float* bias_s = vs + kTile * HD;

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int part = threadIdx.x % S::kLanes;
  const int row = blockIdx.y * kRows + threadIdx.x / S::kLanes;
  const bool in_range = row < g;
  const int row_c = in_range ? row : g - 1;
  const uint8_t* valid_row = key_valid + b * valid_sb;
  const int has_valid = pair_has_valid_key(valid_row, s);
  const float shift = has_valid ? 0.0f : kMaskBias;

  float qr[S::kDims], dor[S::kDims], dq[S::kDims];
  const float* qp = q + b * q_sb + row_c * q_sr + h * q_sh;
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

  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  for (int j0 = 0; j0 < s; j0 += kTile) {
    const int n = min(kTile, s - j0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD>(ks, kb, k_sr, j0, n);
    stage_rows<HD>(vs, vb, v_sr, j0, n);
    for (int j = threadIdx.x; j < n; j += kF32Threads) bias_s[j] = valid_row[j0 + j] ? 0.0f : kMaskBias;
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float bias = bias_s[j];
      if (bias != 0.0f && has_valid) continue;  // P = 0 exactly; uniform across the block
      const float* kj = ks + j * HD;
      const float* vj = vs + j * HD;
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
      const float ds = expf(sdot * scale + bias - shift - lse_i) * (pdot - delta_i);
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

// ------------------------------------------------------------------- wide

// The wide route (csrc/attention_wide.cuh): hd above 256, any multiple of
// 16, a runtime count. The score products S and dP stream their operands in
// 64-column chunks; each block writes one column slice of its outputs and
// recomputes the scores. lse, shift and the -inf of rows past g and keys
// past s are as in the templated bodies, so a pair with no valid key and a
// padding row come out the same.
constexpr int kSliceB = 64;  // output columns of a bf16 block

// Kernel C wide: one block per (pair, head, slice, tile of 64 keys), the
// tile fastest; four warps own 16 keys each. Per 64-query tile: S^T = K Q^T
// and dP^T = V dO^T over the chunks, P^T and dS^T in f32, then dV += P^T dO
// and dK += dS^T Q over the slice's columns of Q and dO.
__global__ void __launch_bounds__(attn_wide::kThreads)
attention_bwd_dkv_bf16_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, bf16* __restrict__ dk_out,
                                   bf16* __restrict__ dv_out, int g, int s, int nh, int hd, int n_kt,
                                   int n_sl, long long q_sb, long long q_sr, long long q_sh,
                                   long long k_sb, long long k_sr, long long k_sh, long long v_sb,
                                   long long v_sr, long long v_sh, long long valid_sb, float scale) {
  using namespace attn_wide;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kc = reinterpret_cast<bf16*>(smem);  // 64-column chunks of the block's K and V,
  bf16* vc = kc + kRows * kLdB;               // and of the query tile's Q and dO
  bf16* qc = vc + kRows * kLdB;
  bf16* dc = qc + kRows * kLdB;
  bf16* qsl = dc + kRows * kLdB;  // the query tile's Q and dO columns of this slice
  bf16* dsl = qsl + kRows * kLdB;
  float* lse_s = reinterpret_cast<float*>(dsl + kRows * kLdB);
  float* delta_s = lse_s + kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt = blockIdx.x % n_kt;
  const int sl = (blockIdx.x / n_kt) % n_sl;
  const int bh = blockIdx.x / n_kt / n_sl;
  const int h = bh % nh, b = bh / nh;
  const int key0 = kt * kRows, col0 = sl * kSliceB;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const bf16* dob = dout + (static_cast<size_t>(b) * g * nh + h) * hd;
  const long long do_sr = static_cast<long long>(nh) * hd;
  const float* lse_b = lse + (static_cast<size_t>(b) * nh + h) * g;
  const float* delta_b = delta + (static_cast<size_t>(b) * nh + h) * g;
  const uint8_t* vrow = key_valid + b * valid_sb;
  const float shift = pair_has_valid_key(vrow, s) ? 0.0f : kMaskBias;

  const int wrow = warp * 16, r = lane >> 2, kq = 2 * (lane & 3);
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + wrow + r + 8 * i;
    bias[i] = key >= s ? -INFINITY : (vrow[key] ? 0.0f : kMaskBias);
  }
  float dk[kSliceB / 8][4], dv[kSliceB / 8][4];
#pragma unroll
  for (int d = 0; d < kSliceB / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.0f;

  for (int i0 = 0; i0 < g; i0 += kRows) {
    __syncthreads();  // the previous query tile is consumed
    stage_bf16(qsl, kLdB, qb, q_sr, i0, g, col0, kSliceB, hd);
    stage_bf16(dsl, kLdB, dob, do_sr, i0, g, col0, kSliceB, hd);
    for (int i = tid; i < kRows; i += kThreads) {
      if (i0 + i < g) {
        cp_async_4(smem_addr(lse_s + i), lse_b + i0 + i);
        cp_async_4(smem_addr(delta_s + i), delta_b + i0 + i);
      } else {  // P = exp(... - inf) = 0: the row adds nothing
        lse_s[i] = INFINITY;
        delta_s[i] = 0.0f;
      }
    }
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      if (c0) __syncthreads();  // the previous chunk is consumed
      stage_bf16(kc, kLdB, kb, k_sr, key0, s, c0, kChunk, hd);
      stage_bf16(vc, kLdB, vb, v_sr, key0, s, c0, kChunk, hd);
      stage_bf16(qc, kLdB, qb, q_sr, i0, g, c0, kChunk, hd);
      stage_bf16(dc, kLdB, dob, do_sr, i0, g, c0, kChunk, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_chunk_nt(st, kc, wrow, qc, lane);
      mma_chunk_nt(dpt, vc, wrow, dc, lane);
    }
    // P^T and dS^T in f32: rows are this lane's two keys, columns queries
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lq = *reinterpret_cast<const float2*>(lse_s + 8 * j + kq);
      const float2 dq = *reinterpret_cast<const float2*>(delta_s + 8 * j + kq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = st[j][e] * scale + bias[e >> 1];
        const float p = exp2f((x - shift - ((e & 1) ? lq.y : lq.x)) * kLog2e);
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? dq.y : dq.x));
      }
    }
    attn_wide::mma_rows<kSliceB>(dv, st, dsl, kLdB, lane);
    attn_wide::mma_rows<kSliceB>(dk, dpt, qsl, kLdB, lane);
  }

  __syncthreads();  // kc and vc are free for the epilogue
  bf16* dk_b = dk_out + (static_cast<size_t>(b) * s * nh + h) * hd;
  bf16* dv_b = dv_out + (static_cast<size_t>(b) * s * nh + h) * hd;
  store_rows_bf16<kSliceB>(kc + wrow * kLdB, kLdB, dk, scale, scale, dk_b, do_sr, key0 + wrow, s, col0, hd, lane);
  store_rows_bf16<kSliceB>(vc + wrow * kLdB, kLdB, dv, 1.0f, 1.0f, dv_b, do_sr, key0 + wrow, s, col0, hd, lane);
}

// Kernel D wide: one block per (pair, head, slice, tile of 64 query rows),
// the tile fastest; four warps own 16 rows each. Per 64-key tile: S = Q K^T
// and dP = dO V^T over the chunks, dS in f32, then dQ += dS K over the
// slice's columns of K.
__global__ void __launch_bounds__(attn_wide::kThreads)
attention_bwd_dq_bf16_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                                  const float* __restrict__ delta, bf16* __restrict__ dq_out, int g,
                                  int s, int nh, int hd, int n_qt, int n_sl, long long q_sb,
                                  long long q_sr, long long q_sh, long long k_sb, long long k_sr,
                                  long long k_sh, long long v_sb, long long v_sr, long long v_sh,
                                  long long valid_sb, float scale) {
  using namespace attn_wide;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qc = reinterpret_cast<bf16*>(smem);  // 64-column chunks of the row tile's Q and dO,
  bf16* dc = qc + kRows * kLdB;               // and of the key tile's K and V
  bf16* kc = dc + kRows * kLdB;
  bf16* vc = kc + kRows * kLdB;
  bf16* ksl = vc + kRows * kLdB;  // the key tile's K columns of this slice

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt;
  const int sl = (blockIdx.x / n_qt) % n_sl;
  const int bh = blockIdx.x / n_qt / n_sl;
  const int h = bh % nh, b = bh / nh;
  const int row0 = qt * kRows, col0 = sl * kSliceB;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const bf16* dob = dout + (static_cast<size_t>(b) * g * nh + h) * hd;
  const long long do_sr = static_cast<long long>(nh) * hd;
  const uint8_t* vrow = key_valid + b * valid_sb;
  const float shift = pair_has_valid_key(vrow, s) ? 0.0f : kMaskBias;

  const int wrow = warp * 16, r = lane >> 2, kq = 2 * (lane & 3);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wrow + r + 8 * i;
    const size_t at = (static_cast<size_t>(b) * nh + h) * g + row;
    lse_r[i] = row < g ? lse[at] : INFINITY;  // P = 0 on padding rows
    delta_r[i] = row < g ? delta[at] : 0.0f;
  }
  float dq[kSliceB / 8][4];
#pragma unroll
  for (int d = 0; d < kSliceB / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.0f;

  for (int key0 = 0; key0 < s; key0 += kRows) {
    __syncthreads();  // the previous key tile is consumed
    stage_bf16(ksl, kLdB, kb, k_sr, key0, s, col0, kSliceB, hd);
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      if (c0) __syncthreads();  // the previous chunk is consumed
      stage_bf16(qc, kLdB, qb, q_sr, row0, g, c0, kChunk, hd);
      stage_bf16(dc, kLdB, dob, do_sr, row0, g, c0, kChunk, hd);
      stage_bf16(kc, kLdB, kb, k_sr, key0, s, c0, kChunk, hd);
      stage_bf16(vc, kLdB, vb, v_sr, key0, s, c0, kChunk, hd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      mma_chunk_nt(sc, qc, wrow, kc, lane);
      mma_chunk_nt(dp, dc, wrow, vc, lane);
    }
    // dS = P * (dP - D) in f32; keys past s get bias -inf, so P = 0
    const uint64_t bits = key_bits(vrow, key0, s, lane);
    const int n_keys = s - key0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + kq + (e & 1);
        const float bias = col >= n_keys ? -INFINITY : (((bits >> col) & 1) ? 0.0f : kMaskBias);
        const float x = sc[j][e] * scale + bias;
        const float p = exp2f((x - shift - lse_r[e >> 1]) * kLog2e);
        dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
      }
    }
    attn_wide::mma_rows<kSliceB>(dq, dp, ksl, kLdB, lane);
  }

  __syncthreads();  // qc is free for the epilogue
  store_rows_bf16<kSliceB>(qc + wrow * kLdB, kLdB, dq, scale, scale, dq_out + (static_cast<size_t>(b) * g * nh + h) * hd,
                           do_sr, row0 + wrow, g, col0, hd, lane);
}

// f32 wide kernel C: one block per (pair, head, 64-column slice, tile of 64
// keys). Each thread owns 8 queries x 4 keys of a score tile; P and dS go
// to shared memory, then it owns 8 keys x 4 columns of dK and dV.
__global__ void __launch_bounds__(attn_wide::kThreads)
attention_bwd_dkv_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const uint8_t* __restrict__ key_valid,
                                  const float* __restrict__ dout, const float* __restrict__ lse,
                                  const float* __restrict__ delta, float* __restrict__ dk_out,
                                  float* __restrict__ dv_out, int g, int s, int nh, int hd, int n_kt,
                                  int n_sl, long long q_sb, long long q_sr, long long q_sh,
                                  long long k_sb, long long k_sr, long long k_sh, long long v_sb,
                                  long long v_sr, long long v_sh, long long valid_sb, float scale) {
  using namespace attn_wide;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // chunks, then the slice's columns, of Q and dO
  float* ds = qs + kRows * kLdF;
  float* ks = ds + kRows * kLdF;  // chunks of K and V
  float* vs = ks + kRows * kLdF;
  float* ps = vs + kRows * kLdF;   // P [query][key]
  float* dss = ps + kRows * kLdF;  // dS [query][key]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt = blockIdx.x % n_kt;
  const int sl = (blockIdx.x / n_kt) % n_sl;
  const int bh = blockIdx.x / n_kt / n_sl;
  const int h = bh % nh, b = bh / nh;
  const int key0 = kt * kRows, col0 = sl * kSliceF;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* dob = dout + (static_cast<size_t>(b) * g * nh + h) * hd;
  const long long do_sr = static_cast<long long>(nh) * hd;
  const float* lse_b = lse + (static_cast<size_t>(b) * nh + h) * g;
  const float* delta_b = delta + (static_cast<size_t>(b) * nh + h) * g;
  const uint8_t* vrow = key_valid + b * valid_sb;
  const float shift = pair_has_valid_key(vrow, s) ? 0.0f : kMaskBias;
  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = key0 + 4 * tx + j;
    bias[j] = key >= s ? -INFINITY : (vrow[key] ? 0.0f : kMaskBias);
  }

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.0f;
  for (int i0 = 0; i0 < g; i0 += kRows) {
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunk (and query tile) is consumed
      stage_f32(qs, qb, q_sr, i0, g, c0, hd);
      stage_f32(ds, dob, do_sr, i0, g, c0, hd);
      stage_f32(ks, kb, k_sr, key0, s, c0, hd);
      stage_f32(vs, vb, v_sr, key0, s, c0, hd);
      __syncthreads();
      mm_nt(sc, qs, ks, ty, tx);
      mm_nt(dp, ds, vs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = i0 + 8 * ty + i;
      const float lse_i = row < g ? lse_b[row] : INFINITY;  // P = 0 on padding rows
      const float delta_i = row < g ? delta_b[row] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] * scale + bias[j] - shift - lse_i);
        ps[(8 * ty + i) * kLdF + 4 * tx + j] = p;
        dss[(8 * ty + i) * kLdF + 4 * tx + j] = p * (dp[i][j] - delta_i);
      }
    }
    __syncthreads();  // the chunks are consumed
    stage_f32(qs, qb, q_sr, i0, g, col0, hd);
    stage_f32(ds, dob, do_sr, i0, g, col0, hd);
    __syncthreads();
    mm_tn(dv, ps, ds, ty, tx);
    mm_tn(dk, dss, qs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = key0 + 8 * ty + i;
    if (key >= s || col0 + 4 * tx >= hd) continue;
    const size_t o = ((static_cast<size_t>(b) * s + key) * nh + h) * hd + col0 + 4 * tx;
    float kx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kx[j] = dk[i][j] * scale;
    store_unit(dk_out + o, kx);
    store_unit(dv_out + o, dv[i]);
  }
}

// f32 wide kernel D: one block per (pair, head, 64-column slice, tile of 64
// query rows). Each thread owns 8 rows x 4 keys of a score tile; dS goes to
// shared memory, then it owns 8 rows x 4 columns of dQ.
__global__ void __launch_bounds__(attn_wide::kThreads)
attention_bwd_dq_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const uint8_t* __restrict__ key_valid,
                                 const float* __restrict__ dout, const float* __restrict__ lse,
                                 const float* __restrict__ delta, float* __restrict__ dq_out, int g,
                                 int s, int nh, int hd, int n_qt, int n_sl, long long q_sb,
                                 long long q_sr, long long q_sh, long long k_sb, long long k_sr,
                                 long long k_sh, long long v_sb, long long v_sr, long long v_sh,
                                 long long valid_sb, float scale) {
  using namespace attn_wide;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // chunks of Q and dO
  float* ds = qs + kRows * kLdF;
  float* ks = ds + kRows * kLdF;  // chunks, then the slice's columns, of K; chunks of V
  float* vs = ks + kRows * kLdF;
  float* dss = vs + kRows * kLdF;  // dS [row][key]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = blockIdx.x % n_qt;
  const int sl = (blockIdx.x / n_qt) % n_sl;
  const int bh = blockIdx.x / n_qt / n_sl;
  const int h = bh % nh, b = bh / nh;
  const int row0 = qt * kRows, col0 = sl * kSliceF;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* dob = dout + (static_cast<size_t>(b) * g * nh + h) * hd;
  const long long do_sr = static_cast<long long>(nh) * hd;
  const uint8_t* vrow = key_valid + b * valid_sb;
  const float shift = pair_has_valid_key(vrow, s) ? 0.0f : kMaskBias;
  float lse_r[8], delta_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + 8 * ty + i;
    const size_t at = (static_cast<size_t>(b) * nh + h) * g + row;
    lse_r[i] = row < g ? lse[at] : INFINITY;  // P = 0 on padding rows
    delta_r[i] = row < g ? delta[at] : 0.0f;
  }

  float dq[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.0f;
  for (int key0 = 0; key0 < s; key0 += kRows) {
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
    for (int c0 = 0; c0 < hd; c0 += kChunk) {
      __syncthreads();  // the previous chunk (and key tile) is consumed
      stage_f32(qs, qb, q_sr, row0, g, c0, hd);
      stage_f32(ds, dob, do_sr, row0, g, c0, hd);
      stage_f32(ks, kb, k_sr, key0, s, c0, hd);
      stage_f32(vs, vb, v_sr, key0, s, c0, hd);
      __syncthreads();
      mm_nt(sc, qs, ks, ty, tx);
      mm_nt(dp, ds, vs, ty, tx);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + 4 * tx + j;
      const float bias = key >= s ? -INFINITY : (vrow[key] ? 0.0f : kMaskBias);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dss[(8 * ty + i) * kLdF + 4 * tx + j] =
            expf(sc[i][j] * scale + bias - shift - lse_r[i]) * (dp[i][j] - delta_r[i]);
    }
    __syncthreads();  // the chunks are consumed
    stage_f32(ks, kb, k_sr, key0, s, col0, hd);
    __syncthreads();
    mm_nn(dq, dss, ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + 8 * ty + i;
    if (row >= g || col0 + 4 * tx >= hd) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = dq[i][j] * scale;
    store_unit(dq_out + ((static_cast<size_t>(b) * g + row) * nh + h) * hd + col0 + 4 * tx, o);
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

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <int HD, int QT>
cudaError_t launch_dkv_bf16(const Args& a) {
  auto kern = attention_bwd_dkv_bf16_kernel<HD, QT>;
  const size_t smem = dkv_smem_bytes<HD, QT>();
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.s + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(a.b) * a.nh * n_kt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const long long* st = a.st;
  kern<<<static_cast<unsigned>(blocks), 128, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.g, a.s, a.nh, n_kt,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  return cudaGetLastError();
}

template <int HD, int NW>
cudaError_t launch_dq_bf16(const Args& a) {
  auto kern = attention_bwd_dq_bf16_kernel<HD, NW>;
  const size_t smem = dq_smem_bytes<HD, NW>((a.s + kTile - 1) / kTile);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.g + 16 * NW - 1) / (16 * NW);
  const long long blocks = static_cast<long long>(a.b) * a.nh * n_qt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const long long* st = a.st;
  kern<<<static_cast<unsigned>(blocks), NW * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.g, a.s, a.nh, n_qt,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_f32(const Args& a) {
  auto kern = attention_bwd_dkv_f32_kernel<HD>;
  const size_t smem = 2 * static_cast<size_t>(kTile) * HD * sizeof(float) + 2 * kTile * sizeof(float);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  constexpr int kKeys = kF32Threads / Split<HD>::kLanes;
  const dim3 grid(a.b * a.nh, (a.s + kKeys - 1) / kKeys);
  const long long* st = a.st;
  kern<<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.g, a.s, a.nh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_f32(const Args& a) {
  auto kern = attention_bwd_dq_f32_kernel<HD>;
  const size_t smem = 2 * static_cast<size_t>(kTile) * HD * sizeof(float) + kTile * sizeof(float);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  constexpr int kRows = kF32Threads / Split<HD>::kLanes;
  const dim3 grid(a.b * a.nh, (a.g + kRows - 1) / kRows);
  const long long* st = a.st;
  kern<<<grid, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.out0), a.g, a.s, a.nh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  return cudaGetLastError();
}

// bf16 tiles of 16 query rows (one warp in D) when g <= 16: the CLS-only
// final layer, so no warp computes only padding
template <int HD, bool kDkv>
cudaError_t launch(int is_bf16, const Args& a) {
  if (!is_bf16) return kDkv ? launch_dkv_f32<HD>(a) : launch_dq_f32<HD>(a);
  if (kDkv) return a.g <= 16 ? launch_dkv_bf16<HD, 16>(a) : launch_dkv_bf16<HD, 64>(a);
  return a.g <= 16 ? launch_dq_bf16<HD, 1>(a) : launch_dq_bf16<HD, 4>(a);
}

// the wide route: hd above 256, any multiple of 16
template <bool kDkv>
cudaError_t launch_wide(int is_bf16, int hd, const Args& a) {
  using namespace attn_wide;
  const int n_tiles = ((kDkv ? a.s : a.g) + kRows - 1) / kRows;
  const int slice = is_bf16 ? kSliceB : kSliceF;
  const int n_sl = (hd + slice - 1) / slice;
  const long long blocks = static_cast<long long>(a.b) * a.nh * n_sl * n_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // bf16: six chunk tiles (C: K, V, Q, dO chunks and Q, dO slices) or five
  // (D) and C's lse and D; f32: six 64 x 65 tiles (C) or five (D)
  const size_t smem = is_bf16 ? (kDkv ? 6 * kRows * kLdB * sizeof(bf16) + 2 * kRows * sizeof(float)
                                      : 5 * kRows * kLdB * sizeof(bf16))
                              : (kDkv ? 6 : 5) * kRows * kLdF * sizeof(float);
  const long long* st = a.st;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (is_bf16 && kDkv) {
    auto kern = attention_bwd_dkv_bf16_wide_kernel;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const uint8_t*>(a.key_valid), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
        static_cast<bf16*>(a.out1), a.g, a.s, a.nh, hd, n_tiles, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  } else if (is_bf16) {
    auto kern = attention_bwd_dq_bf16_wide_kernel;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const uint8_t*>(a.key_valid), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0),
        a.g, a.s, a.nh, hd, n_tiles, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  } else if (kDkv) {
    auto kern = attention_bwd_dkv_f32_wide_kernel;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.g, a.s, a.nh, hd, n_tiles, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  } else {
    auto kern = attention_bwd_dq_f32_wide_kernel;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
        a.g, a.s, a.nh, hd, n_tiles, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], a.scale);
  }
  return cudaGetLastError();
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
  switch (hd) {
#define ATTN_CASE(H) \
    case H: return launch<H, kDkv>(is_bf16, a);
    ATTN_HEAD_DIMS(ATTN_CASE)
#undef ATTN_CASE
    default:
      if (hd <= 256 || hd % 16) return cudaErrorInvalidValue;
      return launch_wide<kDkv>(is_bf16, hd, a);
  }
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
