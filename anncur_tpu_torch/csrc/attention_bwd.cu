// Kernels C and D: attention backward for the cross-encoder, for Hopper (sm_90a).
//
// Replace the backward of the stock Pallas TPU flash attention that
// anncur_tpu/models/bert.py::_flash_attention reaches under jax.grad:
// _flash_attention_bwd_dkv (kernel C here) and _flash_attention_bwd_dq
// (kernel D), jax/experimental/pallas/ops/tpu/flash_attention.py. With the
// forward's row log-sum-exp lse (csrc/attention.cu):
//     D  = rowsum(dO * O)                            (kernel D writes it)
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
// D = rowsum(dO * O) is JAX's di (flash_attention.py:273, computed there
// outside Pallas). Here kernel D computes it: its blocks own whole query
// rows of dO, so each also reads those rows of O, sums the products in f32
// (bf16 products are exact in f32), uses the sum for its dS and writes it
// to the (b, nh, g) f32 delta buffer. The wrapper launches D, then C on the
// same stream; C reads D's delta. Every route does this (the wide route in
// its blocks too: each column slice sums whole rows, slice 0 writes them),
// so the backward is two launches and no torch pass.
//
// Bound on the H100: at the train step's shape (63 pairs, g = s = 255,
// nh = 12, hd = 64, bf16, every key valid) kernel C reads Q, K, V, dO, lse
// and D and writes dK and dV, 150 MB: 0.045 ms at 3.35 TB/s. Its four
// products (S^T, dP^T, dV, dK) are 25 GFLOP, 0.025 ms on the bf16 tensor
// cores. Kernel D reads Q, K, V, dO, O and lse and writes dQ and D, 150 MB
// (0.045 ms) for three products (0.019 ms). Both lie below the bf16 ridge
// (~295 FLOP/B), so bytes bound them: the design keeps every tile's bytes
// read once per block, the products on the tensor cores at their full
// rate, and shared memory out of the way of both.
//
// Hopper bodies (bf16, hd = 64, g > 16: every configuration's full layers;
// namespace hopper): wgmma m64n64k16 with operands in 128-byte-swizzled
// shared memory filled by TMA (csrc/wgmma_sm90.cuh), and the recomputed
// P^T / dS^T (C) or dS (D) fed back from registers as A. A block is one
// warpgroup; its thread 0 keeps TMA loads a ring of kStages tiles ahead,
// each stage completing on its mbarrier. No producer warp: the register
// file is allocated per warp at the kernel's count, so a fifth warp would
// cost its 32 threads' share and leave room for two blocks an SM instead
// of three (a design with one measured C 0.1178 ms, D 0.1109 against
// 0.0922 and 0.0874 at the train step's shape on the H100,
// cli/time_attention_bwd.py; PERF.md). The swizzle replaces the
// 16-byte row padding of the mma.sync bodies (wgmma descriptors take no
// padded rows) and keeps every operand read free of bank conflicts; wgmma
// reads its operands from shared memory itself, so no ldmatrix traffic
// competes with the tensor cores. S (or S^T) and dP (dP^T) are committed
// as two groups, so the exponentials of P run while dP is on the tensor
// cores.
// - Kernel C: one block per (pair, head, tile of 64 keys). K and V load
//   once, then 64-row tiles of Q and dO, with their lse and D by cp.async
//   (rows >= g: TMA zero-fills Q and dO, lse = +inf, so their P is 0). Per
//   tile: S^T = K Q^T and dP^T = V dO^T (both operands K-major), P^T and
//   dS^T in f32 registers, rounded to bf16 A fragments for dV += P^T dO and
//   dK += dS^T Q (dO and Q as MN-major B, wgmma's transpose bit). The four
//   accumulators are 128 registers a thread. A block whose 64 keys are all
//   masked, in a pair that has a valid key, writes zeros and returns.
// - Kernel D: one block per (pair, head, tile of 64 query rows). Q and dO
//   load once, then the key tiles that hold a valid key (one 64-bit ballot
//   word per tile; every tile in a pair with none), K and V through the
//   ring. The first kStages key tiles go in flight with Q, dO and O,
//   before the mask is read, on the guess that none of them is skipped (a
//   wrong guess waits for them and loads the right ones). D for the
//   block's rows is summed from the dO and O tiles in shared memory (four
//   lanes a row; summed from global memory instead, its loads sat on the
//   block's critical path and cost D ~23% at the train step's shape). Per
//   tile: S = Q K^T and dP = dO V^T, dS in f32, dQ += dS K (K as MN-major
//   B).
// - Both stage their bf16 results through the freed ring in padded rows
//   for 16-byte coalesced stores.
//
// mma.sync bodies (bf16, every other head dim that is a multiple of 16 up
// to 256, and g <= 16 at hd = 64, the CLS-only final layer): mma.sync
// m16n8k16 (bf16 in, f32 accumulate), ldmatrix and cp.async from
// csrc/mma_sm90.cuh.
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
//   16 rows of Q and dO as A fragments and their lse and D in registers (D
//   summed from global dO and O by the four lanes of each row). K and V
//   stream in 64-key tiles, double-buffered; a tile without a valid key is
//   skipped when the pair has one (one 64-bit ballot word per tile, as in
//   kernel A; tile 0 always runs, and adds exact zeros if masked). Each
//   16-key step makes S = Q K^T and dP = dO V^T (K and V as B through plain
//   ldmatrix), dS in f32, and dQ += dS K (dS in bf16 from the accumulators,
//   K through ldmatrix.trans).
// - Shared rows are padded by 16 bytes, so the eight row addresses of each
//   8x8 ldmatrix fall in distinct banks. The epilogues stage the bf16
//   results in the warp's own shared rows for 16-byte coalesced stores.
//
// In every bf16 body P and dS are rounded to bf16 before the dV, dK and dQ
// products, as the TPU kernel rounds them (p.astype(do.dtype),
// ds.astype(q.dtype)); scores, exponentials, dP - D and every sum stay f32.
// The exponent is the difference S * scale + bias - shift - lse, taken
// before the log2(e) scaling: at lse ~ -1e9 a folded FMA would lose it.
// Every output row is written by one block and no atomics are used, so two
// launches on the same inputs give the same bits.
//
// Head dims above 256 (any multiple of 16) take the wide route. Its Hopper
// bodies (namespace wide, bf16 and f32) run where TMA takes the strides and
// a block's stored tiles fit in shared memory (bf16: g <= 640 for C, s <=
// 1280 for D; f32: g <= 256, s <= 512), and compute S and dP once per
// (query tile, key tile), on wgmma with TMA-filled tiles through a ring of
// two or three slots that side warps keep full (namespace wide's note):
// - Kernel C: one block per (pair, head, tile of 64 keys). Phase 1 walks
//   the query tiles, each over the head dim in chunks (64 bf16 or 32 f32
//   columns): S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T of every
//   query row go to shared memory (bf16 as the A fragments of the next
//   products, f32 as their values). Phase 2 walks the output columns in
//   slices (bf16 128: two m64n64 blocks each of dK and dV; f32 64): dV =
//   P^T dO and dK = dS^T Q over the query tiles, Q and dO streaming through
//   the same ring. A block whose keys are all masked, in a pair that has a
//   valid key, writes zeros and returns.
// - Kernel D: the same with rows and keys swapped, one block per (pair,
//   head, tile of 64 query rows), over the key tiles that hold a valid key
//   (every tile in a pair with none): dS of every running key stored, then
//   dQ = dS K by slices (bf16 128, f32 64). D = rowsum(dO * O) is summed
//   from device memory while the first loads land.
// - bf16: wgmma m64n64k16, phase 1's operands K-major, phase 2's dO, Q and
//   K MN-major (the transpose bit). Columns past hd are zero-filled and
//   computed (a wgmma skipped by a predicate made ptxas serialise every
//   product, C7520: 1.17x the time at hd 768). f32: three TF32 passes
//   (m64n64k8; A split in registers, B's small part written beside it by
//   the side warps, its raw tile the big part), each chunk or tile of 64
//   reduced rows summed apart and added in f32; phase 2 in 64-column
//   blocks, kernel C's dV and dK in ring steps of their own. TF32 takes
//   K-major operands only, so phase 2's dO, Q and K are transposed in the
//   pass that splits them, their reduced rows placed in the order of the
//   stored A fragments.
// Elsewhere the slice bodies (the *_wide_kernel bodies; shared pieces in
// csrc/attention_wide.cuh) stream S and dP in 64-column chunks and write
// one 64-column slice of dK and dV (C) or dQ (D) a block, recomputing the
// scores for each.
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
//   lane holds its row's q, dO, dQ dims (and sums its part of D); the block
//   walks the keys in tiles of 64 rows of K and V. It skips masked keys (P =
//   0 there) whenever the pair has a valid key; a pair with none attends
//   every key, as forward.
// Kernel C likewise returns zeros at once from a block whose keys are all
// masked.
//
// Layout is the JAX one: q, dO and O (b, g, nh, hd), k and v (b, s, nh, hd),
// each with any strides on the batch, row and head axes, hd contiguous and
// rows 16-byte aligned; dQ (b, g, nh, hd) and dK, dV (b, s, nh, hd)
// contiguous; lse and D (b, nh, g) f32. The kernels allocate nothing and
// run on the caller's stream.

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

constexpr int kTile = 64;  // keys of a kernel C block; keys of a kernel D tile
constexpr float kMaskBias = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// rowsum(dO * O) of one row of hd bf16 values in f32, split over the four
// lanes of a quad (part = lane % 4 takes the 16-byte units part, part + 4,
// ...) and summed across it, (p0 + p1) + (p2 + p3), so all four hold the
// same bits; 0 where !ok (every lane of the warp must call it)
__device__ __forceinline__ float quad_row_delta(const bf16* dor, const bf16* orow, int hd, bool ok, int part) {
  float acc = 0.0f;
  if (ok) {
    for (int u = part; u < hd / 8; u += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(dor + 8 * u);
      const uint4 y = *reinterpret_cast<const uint4*>(orow + 8 * u);
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xs[e]), yf = __bfloat1622float2(ys[e]);
        acc = fmaf(xf.x, yf.x, acc);  // the product is exact in f32
        acc = fmaf(xf.y, yf.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// the same of f32 rows: lane part takes the 16-byte units part, part + 4, ...
__device__ __forceinline__ float quad_row_delta(const float* dor, const float* orow, int hd, bool ok, int part) {
  float acc = 0.0f;
  if (ok) {
    for (int u = part; u < hd / 4; u += 4) {
      const float4 x = *reinterpret_cast<const float4*>(dor + 4 * u);
      const float4 y = *reinterpret_cast<const float4*>(orow + 4 * u);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

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
                              long long valid_sb, long long do_sb, long long do_sr,
                              long long do_sh, float scale) {
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
  const bf16* dob = dout + b * do_sb + h * do_sh;
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
                             const bf16* __restrict__ dout, const bf16* __restrict__ out,
                             const float* __restrict__ lse, float* __restrict__ delta,
                             bf16* __restrict__ dq_out, int g, int s, int nh, int n_qt,
                             long long q_sb, long long q_sr, long long q_sh, long long k_sb,
                             long long k_sr, long long k_sh, long long v_sb, long long v_sr,
                             long long v_sh, long long valid_sb, long long do_sb, long long do_sr,
                             long long do_sh, long long o_sb, long long o_sr, long long o_sh,
                             float scale) {
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
  const bf16* dob = dout + b * do_sb + h * do_sh;
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
  // lse and D of this lane's rows; D summed from dO and O by the row's quad
  const bf16* ob = out + b * o_sb + h * o_sh;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wrow + r + 8 * i;
    const bool ok = row < g;
    const size_t at = (static_cast<size_t>(b) * nh + h) * g + row;
    lse_r[i] = ok ? lse[at] : INFINITY;  // P = 0 on padding rows
    delta_r[i] = quad_row_delta(dob + (ok ? row : 0) * do_sr, ob + (ok ? row : 0) * o_sr, HD, ok, lane & 3);
    if (ok && (lane & 3) == 0) delta[at] = delta_r[i];
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

// ------------------------------------------------ kernels C and D, Hopper

// bf16, hd = 64, g > 16: wgmma on TMA-filled, 128-byte-swizzled tiles (the
// header note). One warpgroup a block; its thread 0 issues the TMA loads.
namespace hopper {

using namespace wgmma_sm90;

constexpr int kRows = 64;                    // rows of every tile: a C block's keys, a D block's queries
constexpr int kTileBytes = kRows * 64 * 2;   // one 64 x 64 bf16 tile
constexpr int kStages = 2;                   // depth of the ring
constexpr int kThreads = 128;                // one warpgroup
constexpr int kBlocksPerSm = 3;              // C at <= 168 registers, D likewise
constexpr int kLdOut = 72;                   // epilogue rows, padded by 16 bytes

struct Maps {  // q, k, v, dO and (kernel D) O as 64-row x 64-column TMA boxes
  RowMap q, k, v, dout, out;
};

// kernel C's shared memory, from a 1024-byte boundary: K, V, the ring's Q
// and dO tiles, its lse and D rows, the barriers
constexpr int kDkvQ = 2 * kTileBytes;
constexpr int kDkvDo = kDkvQ + kStages * kTileBytes;
constexpr int kDkvStats = kDkvDo + kStages * kTileBytes;
constexpr int kDkvBars = kDkvStats + 2 * kStages * kRows * 4;
constexpr int kDkvSmem = kDkvBars + (kStages + 1) * 8 + 1024;  // + room to align

// kernel D's: Q, dO, O, the ring's K and V tiles, the barriers, one mask
// word per key tile, then the running tiles' indices
constexpr int kDqK = 3 * kTileBytes;
constexpr int kDqV = kDqK + kStages * kTileBytes;
constexpr int kDqBars = kDqV + kStages * kTileBytes;
constexpr int kDqBits = kDqBars + (kStages + 1) * 8;
static_assert(2 * kRows * kLdOut * 2 <= 2 * kStages * kTileBytes, "C's epilogue fits in the ring");
static_assert(kRows * kLdOut * 2 <= kStages * kTileBytes, "D's epilogue fits in the K ring");

using wide_sm90::aligned_smem;
using wide_sm90::load_tile;
using wide_sm90::to_a;

// two tiles (one box each of two maps) at one row into dst0, dst1, their
// bytes on bar; issued by the threads that pass `issue` (one a block)
__device__ __forceinline__ void load_pair(void* dst0, const RowMap& m0, void* dst1, const RowMap& m1, uint64_t* bar,
                                          int h, int row, int b, bool issue) {
  mbar_arrive_expect_tx(bar, 2 * kTileBytes, issue);
  load_tile(dst0, m0, bar, h, row, b, issue);
  load_tile(dst1, m1, bar, h, row, b, issue);
}

// this warp's 16 rows of a 64 x 64 accumulator (times mul) in bf16 into
// padded shared rows, then 16-byte stores of rows < n_rows: row i of the
// tile goes to dst + (row0 + i) * rs
__device__ __forceinline__ void store_acc(bf16* stage, const float (&d)[32], float mul, bf16* dst, long long rs,
                                          int row0, int n_rows, int warp, int lane) {
  const int r = 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + r * kLdOut + 8 * j + c) = pack_bf16x2(d[4 * j] * mul, d[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (r + 8) * kLdOut + 8 * j + c) =
        pack_bf16x2(d[4 * j + 2] * mul, d[4 * j + 3] * mul);
  }
  __syncwarp();
  for (int u = lane; u < 16 * 8; u += 32) {
    const int i = 16 * warp + u / 8, unit = u % 8;
    if (row0 + i < n_rows)
      *reinterpret_cast<uint4*>(dst + (row0 + i) * rs + 8 * unit) =
          *reinterpret_cast<const uint4*>(stage + i * kLdOut + 8 * unit);
  }
}

// Kernel C: one block per (pair, head, tile of 64 keys), the tile fastest.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
attention_bwd_dkv_wgmma_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ key_valid,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, int g, int s, int nh,
                               int n_kt, long long valid_sb, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + kTileBytes;
  unsigned char* qs = smem + kDkvQ;    // stage i at qs + i * kTileBytes
  unsigned char* dos = smem + kDkvDo;  // likewise
  float* lse_s = reinterpret_cast<float*>(smem + kDkvStats);  // [kStages][kRows]
  float* delta_s = lse_s + kStages * kRows;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDkvBars);  // [kStages]
  uint64_t* kv_full = full + kStages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt = blockIdx.x % n_kt;
  const int bh = blockIdx.x / n_kt;
  const int h = bh % nh, b = bh / nh;
  const int key0 = kt * kRows;
  const int n_qt = (g + kRows - 1) / kRows;
  const int n_first = min(kStages, n_qt);  // query tiles loaded before the loop
  const float* lse_b = lse + (static_cast<size_t>(b) * nh + h) * g;
  const float* delta_b = delta + (static_cast<size_t>(b) * nh + h) * g;

  // query tile t's lse and D into stage st by cp.async (threads 0-63 lse,
  // 64-127 D), committed as one group; rows past g copy row g - 1, and the
  // consumer takes lse = +inf there (P = 0). No branch: see load_pair.
  auto load_stats = [&](int t, int st) {
    const int r = tid & (kRows - 1), row = min(t * kRows + r, g - 1);
    cp_async_4(smem_addr((tid < kRows ? lse_s : delta_s) + st * kRows + r), (tid < kRows ? lse_b : delta_b) + row);
    cp_async_commit();
  };

  // the barriers, then K, V and the first query tiles in flight while the
  // block reads the mask
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    mbar_init(kv_full, 1);
    mbar_init_fence();
    load_pair(ks, maps.k, vs, maps.v, kv_full, h, key0, b, true);
    for (int t = 0; t < n_first; ++t)
      load_pair(qs + t * kTileBytes, maps.q, dos + t * kTileBytes, maps.dout, full + t, h, t * kRows, b, true);
  }
#pragma unroll
  for (int t = 0; t < kStages; ++t) load_stats(t, t);
  // does the pair have a valid key, and this tile? (the first barrier also
  // publishes the mbarriers' init)
  const uint8_t* vrow = key_valid + b * valid_sb;
  int any = 0;
  for (int j = tid; j < s; j += kThreads) any |= vrow[j];
  const bool pair_any = __syncthreads_or(any);
  const bool tile_any = __syncthreads_or(tid < kRows && key0 + tid < s && vrow[key0 + tid]);
  if (pair_any && !tile_any) {
    // every P of the tile is exp(-1e9 + ...) = 0 in f32: dK = dV = 0
    // exactly; the loads in flight land before the block leaves
    mbar_wait(kv_full, 0);
    for (int t = 0; t < n_first; ++t) mbar_wait(full + t, 0);
    cp_async_wait<0>();
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int u = tid; u < kRows * 8; u += kThreads) {
      const int key = key0 + u / 8;
      if (key < s) {
        const size_t o = ((static_cast<size_t>(b) * s + key) * nh + h) * 64 + (u % 8) * 8;
        *reinterpret_cast<uint4*>(dk_out + o) = zero;
        *reinterpret_cast<uint4*>(dv_out + o) = zero;
      }
    }
    return;
  }
  const float shift = pair_any ? 0.0f : kMaskBias;

  // warp w's accumulator rows are keys 16w + r and 16w + r + 8
  const int r = lane >> 2, cq = 2 * (lane & 3);
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 16 * warp + r + 8 * i;
    bias[i] = key >= s ? -INFINITY : (vrow[key] ? 0.0f : kMaskBias);
  }
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  mbar_wait(kv_full, 0);

  for (int t = 0; t < n_qt; ++t) {
    const int st = t % kStages;
    const uint32_t q_addr = smem_u32(qs + st * kTileBytes), do_addr = smem_u32(dos + st * kTileBytes);
    cp_async_wait<kStages - 1>();  // this thread's lse and D of tile t
    __syncthreads();               // everyone's
    mbar_wait(full + st, (t / kStages) & 1);
    // S^T = K Q^T, then dP^T = V dO^T: keys x queries, hd reduced (K-major);
    // P^T is formed while dP^T is on the tensor cores
    float sT[32], dpT[32];  // the first k-step overwrites them
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(sT, desc_sw128(k_addr + 32 * kk), desc_sw128(q_addr + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(dpT, desc_sw128(v_addr + 32 * kk), desc_sw128(do_addr + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    keep(sT);
    // P^T and dS^T in f32: columns are queries 8j + cq, 8j + cq + 1
    const float* ls = lse_s + st * kRows;
    const float* ds = delta_s + st * kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = t * kRows + 8 * j + cq;
      const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
      const float l0 = row < g ? lq.x : INFINITY, l1 = row + 1 < g ? lq.y : INFINITY;  // P = 0 past g
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sT[4 * j + e] * scale + bias[e >> 1];
        sT[4 * j + e] = exp2f((x - shift - ((e & 1) ? l1 : l0)) * kLog2e);
      }
    }
    uint32_t pa[4][4], sa[4][4];
    to_a(pa, sT);
    wgmma_wait<0>();
    keep(dpT);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dq = *reinterpret_cast<const float2*>(ds + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) dpT[4 * j + e] = sT[4 * j + e] * (dpT[4 * j + e] - ((e & 1) ? dq.y : dq.x));
    }
    to_a(sa, dpT);
    // dV += P^T dO and dK += dS^T Q: queries reduced, dO and Q MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs_mn(dv, pa[kk], desc_sw128(do_addr + 2048 * kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs_mn(dk, sa[kk], desc_sw128(q_addr + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep(dv);
    keep(dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      keep(pa[kk]);
      keep(sa[kk]);
    }
    __syncthreads();  // every warp is done with the stage: refill it kStages tiles on
    load_pair(qs + st * kTileBytes, maps.q, dos + st * kTileBytes, maps.dout, full + st, h, (t + kStages) * kRows, b,
              tid == 0 && t + kStages < n_qt);
    load_stats(t + kStages, st);
  }
  cp_async_wait<0>();  // the copies past the last tile land before the block leaves

  // dK * scale and dV in bf16 through the ring's tiles (every product has read them)
  bf16* kst = reinterpret_cast<bf16*>(qs);
  bf16* vst = kst + kRows * kLdOut;
  const long long rs = static_cast<long long>(nh) * 64;
  bf16* dk_b = dk_out + (static_cast<size_t>(b) * s * nh + h) * 64;
  bf16* dv_b = dv_out + (static_cast<size_t>(b) * s * nh + h) * 64;
  store_acc(kst, dk, scale, dk_b, rs, key0, s, warp, lane);
  store_acc(vst, dv, 1.0f, dv_b, rs, key0, s, warp, lane);
}

// Kernel D: one block per (pair, head, tile of 64 query rows), the tile fastest.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ key_valid,
                              const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq_out,
                              int g, int s, int nh, int n_qt, long long valid_sb, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = smem + kTileBytes;
  unsigned char* os = smem + 2 * kTileBytes;
  unsigned char* ks = smem + kDqK;  // stage i at ks + i * kTileBytes
  unsigned char* vs = smem + kDqV;  // likewise
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDqBars);  // [kStages]
  uint64_t* q_full = full + kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt;
  const int bh = blockIdx.x / n_qt;
  const int h = bh % nh, b = bh / nh;
  const int row0 = qt * kRows;
  const int n_tiles = (s + kRows - 1) / kRows;
  uint64_t* tile_bits = reinterpret_cast<uint64_t*>(smem + kDqBits);
  int* run = reinterpret_cast<int*>(tile_bits + n_tiles);  // the running tiles, in order

  // the barriers, then Q, dO, O and the first kStages key tiles in flight
  // while the block reads the mask (the key tiles on the guess that none
  // is skipped)
  const int n_guess = min(kStages, n_tiles);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(full + i, 1);
    mbar_init(q_full, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(q_full, 3 * kTileBytes, true);
    load_tile(qs, maps.q, q_full, h, row0, b, true);
    load_tile(dos, maps.dout, q_full, h, row0, b, true);
    load_tile(os, maps.out, q_full, h, row0, b, true);
    for (int i = 0; i < n_guess; ++i)
      load_pair(ks + i * kTileBytes, maps.k, vs + i * kTileBytes, maps.v, full + i, h, i * kRows, b, true);
  }

  // warp w's accumulator rows are queries row0 + 16w + r and + 8
  const int r = lane >> 2, cq = 2 * (lane & 3);
  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + r + 8 * i;
    lse_r[i] = row < g ? lse[(static_cast<size_t>(b) * nh + h) * g + row] : INFINITY;  // P = 0 on padding rows
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
  // the key tiles that run: a tile without a valid key adds exactly 0 when
  // the pair has one; a pair with none attends every key
  int n_run = 0;
  for (int t = 0; t < n_tiles; ++t) {
    if (any_valid && tile_bits[t] == 0) continue;
    if (tid == 0) run[n_run] = t;
    ++n_run;
  }
  __syncthreads();  // publishes run
  bool guessed = true;
  for (int i = 0; i < n_guess; ++i) guessed &= i < n_run && run[i] == i;
  int lap = 0;  // rounds each stage's barrier ran ahead of the ring
  if (!guessed) {
    // a skipped tile among the first: let the guessed loads land, then
    // load the running tiles in their place
    for (int i = 0; i < n_guess; ++i) mbar_wait(full + i, 0);
    __syncthreads();  // every thread has seen those phases complete
    if (tid == 0)
      for (int i = 0; i < min(kStages, n_run); ++i)
        load_pair(ks + i * kTileBytes, maps.k, vs + i * kTileBytes, maps.v, full + i, h, run[i] * kRows, b, true);
    lap = 1;
  }
  const float shift = any_valid ? 0.0f : kMaskBias;
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.0f;
  const uint32_t q_addr = smem_u32(qs), do_addr = smem_u32(dos);
  mbar_wait(q_full, 0);
  // D of this thread's rows from the dO and O tiles (TMA zero-filled past
  // g), summed as quad_row_delta sums it: lane part p takes the 16-byte
  // units p and p + 4 of the row (unit u of tile row i sits at u ^ (i % 8))
  float delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * warp + r + 8 * i;
    float acc = 0.0f;
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
      const int off = row * 128 + (((lane & 3) + 4 * uu) ^ (row & 7)) * 16;
      const uint4 x = *reinterpret_cast<const uint4*>(dos + off);
      const uint4 y = *reinterpret_cast<const uint4*>(os + off);
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xs[e]), yf = __bfloat1622float2(ys[e]);
        acc = fmaf(xf.x, yf.x, acc);
        acc = fmaf(xf.y, yf.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta_r[i] = acc;
    if (row0 + row < g && (lane & 3) == 0) delta[(static_cast<size_t>(b) * nh + h) * g + row0 + row] = acc;
  }

  for (int i = 0; i < n_run; ++i) {
    const int t = run[i], st = i % kStages;
    const uint32_t k_addr = smem_u32(ks + st * kTileBytes), v_addr = smem_u32(vs + st * kTileBytes);
    mbar_wait(full + st, (i / kStages + lap) & 1);
    // S = Q K^T, then dP = dO V^T: queries x keys, hd reduced (K-major); P
    // is formed while dP is on the tensor cores
    float sc[32], dp[32];  // the first k-step overwrites them
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(sc, desc_sw128(q_addr + 32 * kk), desc_sw128(k_addr + 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(dp, desc_sw128(do_addr + 32 * kk), desc_sw128(v_addr + 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();
    keep(sc);
    // P, then dS = P * (dP - D) in f32; keys past s get bias -inf, so P = 0
    const uint64_t bits = tile_bits[t];
    const int n_keys = s - t * kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + cq + (e & 1);
        const float bias = col >= n_keys ? -INFINITY : (((bits >> col) & 1) ? 0.0f : kMaskBias);
        const float x = sc[4 * j + e] * scale + bias;
        sc[4 * j + e] = exp2f((x - shift - lse_r[e >> 1]) * kLog2e);
      }
    }
    wgmma_wait<0>();
    keep(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = sc[e] * (dp[e] - delta_r[(e >> 1) & 1]);
    uint32_t sa[4][4];
    to_a(sa, dp);
    // dQ += dS K: keys reduced, K MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs_mn(dq, sa[kk], desc_sw128(k_addr + 2048 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) keep(sa[kk]);
    __syncthreads();  // every warp is done with the stage: refill it kStages running tiles on
    const bool refill = i + kStages < n_run;
    load_pair(ks + st * kTileBytes, maps.k, vs + st * kTileBytes, maps.v, full + st, h,
              run[refill ? i + kStages : i] * kRows, b, tid == 0 && refill);
  }

  // dQ * scale in bf16 through the K ring (every product has read it)
  bf16* dq_b = dq_out + (static_cast<size_t>(b) * g * nh + h) * 64;
  store_acc(reinterpret_cast<bf16*>(ks), dq, scale, dq_b, static_cast<long long>(nh) * 64, row0, g, warp, lane);
}

}  // namespace hopper

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
                             long long valid_sb, long long do_sb, long long do_sr,
                             long long do_sh, float scale) {
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
  const float* dob = dout + b * do_sb + h * do_sh;
  const float* lse_b = lse + (static_cast<size_t>(b) * nh + h) * g;
  const float* delta_b = delta + (static_cast<size_t>(b) * nh + h) * g;
  for (int i0 = 0; i0 < g; i0 += kTile) {
    const int n = min(kTile, g - i0);
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD>(qs, qb, q_sr, i0, n);
    stage_rows<HD>(dos, dob, do_sr, i0, n);
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
                            const float* __restrict__ dout, const float* __restrict__ out,
                            const float* __restrict__ lse, float* __restrict__ delta,
                            float* __restrict__ dq_out, int g, int s, int nh, long long q_sb,
                            long long q_sr, long long q_sh, long long k_sb, long long k_sr,
                            long long k_sh, long long v_sb, long long v_sr, long long v_sh,
                            long long valid_sb, long long do_sb, long long do_sr, long long do_sh,
                            long long o_sb, long long o_sr, long long o_sh, float scale) {
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
  const float* dop = dout + b * do_sb + row_c * do_sr + h * do_sh;
  const float* op = out + b * o_sb + row_c * o_sr + h * o_sh;
  float odot = 0.0f;  // this lane's part of D = rowsum(dO * O)
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) {
    load_unit(qp + S::offset(part, t), qr + t * S::kUnit);
    load_unit(dop + S::offset(part, t), dor + t * S::kUnit);
    float ov[S::kUnit];
    load_unit(op + S::offset(part, t), ov);
#pragma unroll
    for (int e = 0; e < S::kUnit; ++e) odot = fmaf(dor[t * S::kUnit + e], ov[e], odot);
  }
#pragma unroll
  for (int d = 0; d < S::kDims; ++d) dq[d] = 0.0f;
  const size_t stat = (static_cast<size_t>(b) * nh + h) * g + row_c;
  const float lse_i = lse[stat];
  const float delta_i = S::reduce(odot);
  if (in_range && part == 0) delta[stat] = delta_i;

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
  const size_t io_row = ((static_cast<size_t>(b) * g + row_c) * nh + h) * HD;
#pragma unroll
  for (int t = 0; t < S::kUnits; ++t) {
    float o[S::kUnit];
#pragma unroll
    for (int e = 0; e < S::kUnit; ++e) o[e] = dq[t * S::kUnit + e] * scale;
    store_unit(dq_out + io_row + S::offset(part, t), o);
  }
}

// ------------------------------------------------------------------- wide

// The wide route's slice bodies (csrc/attention_wide.cuh): hd above 256,
// any multiple of 16, a runtime count, past the Hopper bodies' limits (the
// header note). The score products S and dP stream their operands in
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
                                   long long v_sr, long long v_sh, long long valid_sb, long long do_sb,
                                   long long do_sr, long long do_sh, float scale) {
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
  const bf16* dob = dout + b * do_sb + h * do_sh;
  const long long out_rs = static_cast<long long>(nh) * hd;  // dK and dV rows
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
  store_rows_bf16<kSliceB>(kc + wrow * kLdB, kLdB, dk, scale, scale, dk_b, out_rs, key0 + wrow, s, col0, hd, lane);
  store_rows_bf16<kSliceB>(vc + wrow * kLdB, kLdB, dv, 1.0f, 1.0f, dv_b, out_rs, key0 + wrow, s, col0, hd, lane);
}

// Kernel D wide: one block per (pair, head, slice, tile of 64 query rows),
// the tile fastest; four warps own 16 rows each. Per 64-key tile: S = Q K^T
// and dP = dO V^T over the chunks, dS in f32, then dQ += dS K over the
// slice's columns of K.
__global__ void __launch_bounds__(attn_wide::kThreads)
attention_bwd_dq_bf16_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const uint8_t* __restrict__ key_valid,
                                  const bf16* __restrict__ dout, const bf16* __restrict__ out,
                                  const float* __restrict__ lse, float* __restrict__ delta,
                                  bf16* __restrict__ dq_out, int g, int s, int nh, int hd, int n_qt,
                                  int n_sl, long long q_sb, long long q_sr, long long q_sh,
                                  long long k_sb, long long k_sr, long long k_sh, long long v_sb,
                                  long long v_sr, long long v_sh, long long valid_sb, long long do_sb,
                                  long long do_sr, long long do_sh, long long o_sb, long long o_sr,
                                  long long o_sh, float scale) {
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
  const bf16* dob = dout + b * do_sb + h * do_sh;
  const bf16* ob = out + b * o_sb + h * o_sh;
  const uint8_t* vrow = key_valid + b * valid_sb;
  const float shift = pair_has_valid_key(vrow, s) ? 0.0f : kMaskBias;

  // lse and D of this lane's rows: every slice sums D over whole rows of dO
  // and O, slice 0 writes it
  const int wrow = warp * 16, r = lane >> 2, kq = 2 * (lane & 3);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wrow + r + 8 * i;
    const bool ok = row < g;
    const size_t at = (static_cast<size_t>(b) * nh + h) * g + row;
    lse_r[i] = ok ? lse[at] : INFINITY;  // P = 0 on padding rows
    delta_r[i] = quad_row_delta(dob + (ok ? row : 0) * do_sr, ob + (ok ? row : 0) * o_sr, hd, ok, lane & 3);
    if (sl == 0 && ok && (lane & 3) == 0) delta[at] = delta_r[i];
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
                           static_cast<long long>(nh) * hd, row0 + wrow, g, col0, hd, lane);
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
                                  long long v_sr, long long v_sh, long long valid_sb, long long do_sb,
                                  long long do_sr, long long do_sh, float scale) {
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
  const float* dob = dout + b * do_sb + h * do_sh;
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
                                 const float* __restrict__ dout, const float* __restrict__ out,
                                 const float* __restrict__ lse, float* __restrict__ delta,
                                 float* __restrict__ dq_out, int g, int s, int nh, int hd, int n_qt,
                                 int n_sl, long long q_sb, long long q_sr, long long q_sh,
                                 long long k_sb, long long k_sr, long long k_sh, long long v_sb,
                                 long long v_sr, long long v_sh, long long valid_sb, long long do_sb,
                                 long long do_sr, long long do_sh, long long o_sb, long long o_sr,
                                 long long o_sh, float scale) {
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
  const float* dob = dout + b * do_sb + h * do_sh;
  const float* ob = out + b * o_sb + h * o_sh;
  const uint8_t* vrow = key_valid + b * valid_sb;
  const float shift = pair_has_valid_key(vrow, s) ? 0.0f : kMaskBias;
  // lse and D of this thread's rows: the 16 lanes of a row sum D over the
  // whole of dO * O (every slice), slice 0 writes it
  float lse_r[8], delta_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + 8 * ty + i;
    const bool ok = row < g;
    const size_t at = (static_cast<size_t>(b) * nh + h) * g + row;
    lse_r[i] = ok ? lse[at] : INFINITY;  // P = 0 on padding rows
    float acc = 0.0f;
    for (int c = 4 * tx; ok && c < hd; c += 64) {
      const float4 x = *reinterpret_cast<const float4*>(dob + row * do_sr + c);
      const float4 y = *reinterpret_cast<const float4*>(ob + row * o_sr + c);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
    delta_r[i] = row_sum16(acc);
    if (sl == 0 && ok && tx == 0) delta[at] = delta_r[i];
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

// ------------------------------------------------------- wide, Hopper bodies

// Head dims above 256 on wgmma + TMA (the header note): S and dP once per
// (query tile, key tile), every output column from them. The ring, its
// side warps and the products are csrc/wide_sm90.cuh's, shared with kernel
// A's wide body (bf16 D takes two slots, so that two blocks share an SM).
namespace wide {

using namespace wgmma_sm90;
using namespace wide_sm90;
// declared here, so that they hide the file's own kTile (64 keys) and the like
using wide_sm90::Cfg;
using wide_sm90::kMaxStages;
using wide_sm90::kRows;
using wide_sm90::kSmemMax;
using wide_sm90::kThreads;
using wide_sm90::kTile;
using hopper::Maps;

// P, then dS = P (dP - D), in place in x = S and y = dP, at e of this
// thread's accumulator entries: z = S scale + bias - shift - lse
template <typename T>
__device__ __forceinline__ void softmax_grad(float& x, float& y, float z, float d) {
  const float p = std::is_same<T, float>::value ? expf(z) : exp2f(z * kLog2e);
  x = p;
  y = p * (y - d);
}

// Kernel C, end of a query tile's chunks: P^T and dS^T from x = S^T and y =
// dP^T (rows keys, columns queries q0 + 8j + cq, + 1; lse = +inf past g, so
// P = 0 there), then stored for the phase-2 products (store_frags), P^T in
// the first half of the tile's store, dS^T in the second
template <typename T>
__device__ __forceinline__ void finish_c(float (&x)[32], float (&y)[32], unsigned char* st, const float (&bias)[2],
                                         const float* lse_b, const float* delta_b, int q0, int g, float shift,
                                         float scale, int tid) {
  const int cq = 2 * (tid & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = q0 + 8 * j + cq + u, qc = min(q, g - 1);
      const float l = q < g ? lse_b[qc] : INFINITY, d = q < g ? delta_b[qc] : 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = 4 * j + 2 * half + u;
        softmax_grad<T>(x[e], y[e], x[e] * scale + bias[half] - shift - l, d);
      }
    }
  store_frags<T>(st, x, tid);
  store_frags<T>(st + Cfg<T>::kStoreC / 2, y, tid);
}

// Kernel D, end of a key tile's chunks: dS from x = S and y = dP (rows
// queries, columns keys 8j + cq, + 1 of the tile: bias from its mask word,
// -inf past s), stored (store_frags)
template <typename T>
__device__ __forceinline__ void finish_d(float (&x)[32], float (&y)[32], unsigned char* st, uint64_t bits, int n_keys,
                                         const float (&lse_r)[2], const float (&delta_r)[2], float shift, float scale,
                                         int tid) {
  const int cq = 2 * (tid & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + cq + (e & 1);
      const float bias = col >= n_keys ? -INFINITY : (((bits >> col) & 1) ? 0.0f : kMaskBias);
      softmax_grad<T>(x[4 * j + e], y[4 * j + e], x[4 * j + e] * scale + bias - shift - lse_r[e >> 1],
                      delta_r[e >> 1]);
    }
  store_frags<T>(st, y, tid);
}

// Kernel C, phase 2, bf16, one query tile of one slice: dV (+)= P^T dO and
// dK (+)= dS^T Q over the tile's 64 rows, from its stored fragments, the
// slot's dO blocks at tiles 0, 1 and Q blocks at 2, 3 as MN-major B. acc:
// add to dv and dk (else overwrite them). A block past hd is zero-filled
// and gives columns that are not stored.
__device__ __forceinline__ void dkv_step(float (&dv)[2][32], float (&dk)[2][32], unsigned char* slot,
                                         const unsigned char* st, bool acc, int tid) {
  const uint32_t base = smem_u32(slot);
  const uint4* in = reinterpret_cast<const uint4*>(st);
  uint32_t pa[4][4], sa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint4 p = in[kk * kThreads + tid], s = in[(4 + kk) * kThreads + tid];
    pa[kk][0] = p.x, pa[kk][1] = p.y, pa[kk][2] = p.z, pa[kk][3] = p.w;
    sa[kk][0] = s.x, sa[kk][1] = s.y, sa[kk][2] = s.z, sa[kk][3] = s.w;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // the four accumulators in turns
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mma_rs_mn(dv[j], pa[kk], desc_sw128(base + j * kTile + 2048 * kk), acc || kk > 0);
      mma_rs_mn(dk[j], sa[kk], desc_sw128(base + (2 + j) * kTile + 2048 * kk), acc || kk > 0);
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wgmma_sm90::keep(dv[j]);
    wgmma_sm90::keep(dk[j]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_sm90::keep(pa[kk]);
    wgmma_sm90::keep(sa[kk]);
  }
}

// Kernel C: one block per (pair, head, tile of 64 keys), the tile fastest.
// Phase 1: per query tile, S^T = K Q^T and dP^T = V dO^T over the head dim,
// then P^T and dS^T of every query row stored; phase 2: per slice of
// columns, dV = P^T dO and dK = dS^T Q over the query tiles (f32: dV's and
// dK's products in ring steps of their own), then stored. A block whose 64
// keys are all masked, in a pair that has a valid key, writes zeros and
// returns.
template <typename T>
__global__ void __launch_bounds__(kThreads + Cfg<T>::kSide, 1)
attention_bwd_dkv_wide_wgmma_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ key_valid,
                                    const float* __restrict__ lse, const float* __restrict__ delta,
                                    T* __restrict__ dk_out, T* __restrict__ dv_out, int g, int s, int nh, int hd,
                                    int n_kt, int n_st, long long valid_sb, float scale) {
  using C = Cfg<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NB = kF32 ? 1 : 2;  // 64-column output blocks of a slice
  constexpr int kSteps = kF32 ? 2 : 1;  // phase 2's ring steps per query tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int n_qt = (g + kRows - 1) / kRows;
  unsigned char* stored = smem + n_st * C::kSlot;  // query tile t at t * kStoreC
  uint64_t* full = reinterpret_cast<uint64_t*>(stored + static_cast<size_t>(n_qt) * C::kStoreC);
  uint64_t* ready = full + kMaxStages;  // [n_st] each, as side_loop says
  uint64_t* empty = ready + kMaxStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kt = blockIdx.x % n_kt, bh = blockIdx.x / n_kt;
  const int h = bh % nh, b = bh / nh;
  const int key0 = kt * kRows;
  const int n_ch = (hd + C::kCols - 1) / C::kCols, n_sl = (hd + C::kSliceC - 1) / C::kSliceC;
  const int n1 = n_qt * n_ch, n_all = n1 + n_sl * n_qt * kSteps;  // steps of phase 1, of both
  const long long rs = static_cast<long long>(nh) * hd;
  T* dk_b = dk_out + (static_cast<size_t>(b) * s * nh + h) * hd;
  T* dv_b = dv_out + (static_cast<size_t>(b) * s * nh + h) * hd;

  if (tid == 0) {
    for (int i = 0; i < n_st; ++i) {
      mbar_init(full + i, 1);
      mbar_init(ready + i, C::kSide);
      mbar_init(empty + i, kThreads / 32);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  // does the pair have a valid key, and this tile? (the first barrier also
  // publishes the mbarriers' init)
  const uint8_t* vrow = key_valid + b * valid_sb;
  int any = 0;
  for (int j = tid; j < s; j += blockDim.x) any |= vrow[j];
  const bool pair_any = __syncthreads_or(any);
  const bool tile_any = __syncthreads_or(tid < kRows && key0 + tid < s && vrow[key0 + tid]);
  if (pair_any && !tile_any) {
    // every P of the tile is exp(-1e9 + ...) = 0 in f32: dK = dV = 0 exactly
    const int units = hd * static_cast<int>(sizeof(T)) / 16;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int u = tid; u < kRows * units; u += blockDim.x) {
      const int key = key0 + u / units;
      if (key < s) {
        const long long o = key * rs + (u % units) * static_cast<int>(16 / sizeof(T));
        *reinterpret_cast<uint4*>(dk_b + o) = zero;
        *reinterpret_cast<uint4*>(dv_b + o) = zero;
      }
    }
    return;
  }
  const float shift = pair_any ? 0.0f : kMaskBias;

  // step f's tiles into its slot, issued by the threads that pass `on`.
  // Phase 1 (f < n1), query tile f / n_ch over chunk f % n_ch: K, V of the
  // key tile, Q, dO of the query tile. Phase 2, of slice sl and query tile
  // t: bf16 the tile's dO and Q columns of the slice as two 64-column blocks
  // each (tiles 0, 1 and 2, 3); f32 its dO columns, then its Q columns, as
  // two 32-column boxes (tiles 0, 1).
  auto issue = [&](int f, int st, bool on) {
    const bool p1 = f < n1;
    const int f2 = f - n1, t = p1 ? f / n_ch : (f2 / kSteps) % n_qt;
    const int c0 = p1 ? (f % n_ch) * C::kCols : (f2 / (kSteps * n_qt)) * C::kSliceC;
    unsigned char* slot = smem + st * C::kSlot;
    uint64_t* bar = full + st;
    const bool four = !kF32 || p1;
    const RowMap& x2 = kF32 && f2 % 2 ? maps.q : maps.dout;  // phase 2's first two tiles
    const int col1 = p1 ? c0 : c0 + C::kCols;
    const int row_a = p1 ? key0 : t * kRows;
    mbar_arrive_expect_tx(bar, (four ? 4 : 2) * kTile, on);
    load_tile(slot, p1 ? maps.k : x2, bar, h, row_a, b, on, c0);
    load_tile(slot + kTile, p1 ? maps.v : x2, bar, h, row_a, b, on, col1);
    load_tile(slot + 2 * kTile, maps.q, bar, h, t * kRows, b, on && four, c0);
    load_tile(slot + 3 * kTile, p1 ? maps.dout : maps.q, bar, h, t * kRows, b, on && four, col1);
  };
  // the side warps (uniform in a warp, as the compiler is told)
  if (__shfl_sync(0xffffffffu, tid / kThreads, 0)) {
    side_loop<T, 2, C::kSlot>(issue, full, ready, empty, smem, n_st, n1, n_all, tid - kThreads);
    return;
  }
  // one ring step: wait for the step's slot (f32: its split operands),
  // work on it, then hand it back to the producer
  Ring ring{n_st};
  auto step = [&](auto&& work) {
    mbar_wait((kF32 ? ready : full) + ring.slot, ring.parity);
    work(smem + ring.slot * C::kSlot);
    mbar_arrive(empty + ring.slot, lane == 0);
    ring.next();
  };

  // this thread's accumulator rows are keys key0 + 16 warp + r and + 8
  const int r = lane >> 2;
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 16 * warp + r + 8 * i;
    bias[i] = key >= s ? -INFINITY : (vrow[min(key, s - 1)] ? 0.0f : kMaskBias);
  }
  const float* lse_b = lse + (static_cast<size_t>(b) * nh + h) * g;
  const float* delta_b = delta + (static_cast<size_t>(b) * nh + h) * g;

  float x[32], y[32];
  for (int t = 0; t < n_qt; ++t) {
    for (int c = 0; c < n_ch; ++c) step([&](unsigned char* slot) { chunk<T, 2>(x, y, slot, c == 0, tid); });
    finish_c<T>(x, y, stored + static_cast<size_t>(t) * C::kStoreC, bias, lse_b, delta_b, t * kRows, g, shift, scale,
                tid);
  }
  float dv[NB][32], dk[NB][32];
  for (int sl = 0; sl < n_sl; ++sl) {
    for (int t = 0; t < n_qt; ++t) {
      const unsigned char* st = stored + static_cast<size_t>(t) * C::kStoreC;
      if constexpr (kF32) {
        const float4* a = reinterpret_cast<const float4*>(st);
        step([&](unsigned char* slot) { f32_block_step(dv[0], slot, a, t > 0, tid); });  // P^T dO
        step([&](unsigned char* slot) { f32_block_step(dk[0], slot, a + 8 * kThreads, t > 0, tid); });  // dS^T Q
      } else {
        step([&](unsigned char* slot) { dkv_step(dv, dk, slot, st, t > 0, tid); });
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      store_block<T>(dk_b, rs, dk[j], scale, key0, s, sl * C::kSliceC + 64 * j, hd, tid);
      store_block<T>(dv_b, rs, dv[j], 1.0f, key0, s, sl * C::kSliceC + 64 * j, hd, tid);
    }
  }
}

// Kernel D: one block per (pair, head, tile of 64 query rows), the tile
// fastest. D = rowsum(dO * O) of its rows from device memory while the
// first loads land. Phase 1: per running key tile (one with a valid key; in
// a pair with none, every tile), S = Q K^T and dP = dO V^T over the head
// dim, then dS stored; phase 2: per slice of columns, dQ = dS K over the
// running key tiles, then stored.
template <typename T>
__global__ void __launch_bounds__(kThreads + Cfg<T>::kSide, Cfg<T>::kMinBlocksD)
attention_bwd_dq_wide_wgmma_kernel(const __grid_constant__ Maps maps, const T* __restrict__ dout,
                                   const T* __restrict__ out, const uint8_t* __restrict__ key_valid,
                                   const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dq_out,
                                   int g, int s, int nh, int hd, int n_qt, int n_st, long long valid_sb, long long do_sb,
                                   long long do_sr, long long do_sh, long long o_sb, long long o_sr, long long o_sh,
                                   float scale) {
  using C = Cfg<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NB = kF32 ? 1 : 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int n_kt = (s + kRows - 1) / kRows;
  unsigned char* stored = smem + n_st * C::kSlot;  // running tile i at i * kStoreD
  uint64_t* full = reinterpret_cast<uint64_t*>(stored + static_cast<size_t>(n_kt) * C::kStoreD);
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
  // the pair has one; a pair with none attends every key
  int n_run = 0;
  for (int t = 0; t < n_kt; ++t) {
    if (any_valid && tile_bits[t] == 0) continue;
    if (tid == 0) run[n_run] = t;
    ++n_run;
  }
  __syncthreads();  // publishes run
  const float shift = any_valid ? 0.0f : kMaskBias;
  const int n_ch = (hd + C::kCols - 1) / C::kCols, n_sl = (hd + C::kSliceD - 1) / C::kSliceD;
  const int n1 = n_run * n_ch, n_all = n1 + n_sl * n_run;

  // step f's tiles into its slot, issued by the threads that pass `on`.
  // Phase 1 (f < n1), running tile f / n_ch over chunk f % n_ch: Q, dO of
  // the block's rows, K, V of the key tile. Phase 2, slice (f - n1) / n_run
  // of running tile (f - n1) % n_run: its K columns as two tiles (bf16
  // 64-column blocks, f32 32-column boxes).
  auto issue = [&](int f, int st, bool on) {
    const bool p1 = f < n1;
    const int f2 = f - n1, key0 = run[p1 ? f / n_ch : f2 % n_run] * kRows;
    const int c0 = p1 ? (f % n_ch) * C::kCols : (f2 / n_run) * C::kSliceD;
    unsigned char* slot = smem + st * C::kSlot;
    uint64_t* bar = full + st;
    const int row_a = p1 ? row0 : key0;
    mbar_arrive_expect_tx(bar, (p1 ? 4 : 2) * kTile, on);
    load_tile(slot, p1 ? maps.q : maps.k, bar, h, row_a, b, on, c0);
    load_tile(slot + kTile, p1 ? maps.dout : maps.k, bar, h, row_a, b, on, p1 ? c0 : c0 + C::kCols);
    load_tile(slot + 2 * kTile, maps.k, bar, h, key0, b, on && p1, c0);
    load_tile(slot + 3 * kTile, maps.v, bar, h, key0, b, on && p1, c0);
  };
  // the side warps (uniform in a warp, as the compiler is told)
  if (__shfl_sync(0xffffffffu, tid / kThreads, 0)) {
    side_loop<T, 2, C::kSlot>(issue, full, ready, empty, smem, n_st, n1, n_all, tid - kThreads);
    return;
  }

  // lse and D of this thread's rows, row0 + 16 warp + r and + 8, while the
  // first loads land; D summed as quad_row_delta sums it, written for C
  const int r = lane >> 2;
  const T* dob = dout + b * do_sb + h * do_sh;
  const T* ob = out + b * o_sb + h * o_sh;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + r + 8 * i;
    const bool ok = row < g;
    const size_t at = (static_cast<size_t>(b) * nh + h) * g + (ok ? row : 0);
    lse_r[i] = ok ? lse[at] : INFINITY;  // P = 0 on padding rows
    delta_r[i] = quad_row_delta(dob + (ok ? row : 0) * do_sr, ob + (ok ? row : 0) * o_sr, hd, ok, lane & 3);
    if (ok && (lane & 3) == 0) delta[at] = delta_r[i];
  }

  // one ring step, as kernel C's
  Ring ring{n_st};
  auto step = [&](auto&& work) {
    mbar_wait((kF32 ? ready : full) + ring.slot, ring.parity);
    work(smem + ring.slot * C::kSlot);
    mbar_arrive(empty + ring.slot, lane == 0);
    ring.next();
  };
  float x[32], y[32];
  for (int i = 0; i < n_run; ++i) {
    for (int c = 0; c < n_ch; ++c) step([&](unsigned char* slot) { chunk<T, 2>(x, y, slot, c == 0, tid); });
    const int t = run[i];
    finish_d<T>(x, y, stored + static_cast<size_t>(i) * C::kStoreD, tile_bits[t], s - t * kRows, lse_r, delta_r,
                shift, scale, tid);
  }
  float dq[NB][32];
  T* dq_b = dq_out + (static_cast<size_t>(b) * g * nh + h) * hd;
  for (int sl = 0; sl < n_sl; ++sl) {
    for (int i = 0; i < n_run; ++i) {
      const unsigned char* st = stored + static_cast<size_t>(i) * C::kStoreD;
      step([&](unsigned char* slot) {
        if constexpr (kF32)
          f32_block_step(dq[0], slot, reinterpret_cast<const float4*>(st), i > 0, tid);
        else
          bf16_block_step(dq, slot, st, i > 0, tid);
      });
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
      store_block<T>(dq_b, static_cast<long long>(nh) * hd, dq[j], scale, row0, g, sl * C::kSliceD + 64 * j, hd, tid);
  }
}

}  // namespace wide

// ---------------------------------------------------------------- launches

struct Args {
  const void *q, *k, *v, *key_valid, *dout, *out, *lse;
  void* delta;        // written by kernel D, read by kernel C
  void *out0, *out1;  // dK, dV (kernel C) or dQ (kernel D)
  int b, g, s, nh;
  // q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb,
  // do_sb, do_sr, do_sh, o_sb, o_sr, o_sh
  long long st[16];
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// the Hopper bodies' tensor maps of q, k, v, dO and, for kernel D, O: rows
// of hd columns (64 unless given), bf16 or f32
cudaError_t make_maps(hopper::Maps* m, const Args& a, int hd = 64, bool f32 = false) {
  using wgmma_sm90::make_row_map;
  const long long* st = a.st;
  cudaError_t err = make_row_map(&m->q, a.q, a.b, a.g, a.nh, st[0], st[1], st[2], hd, f32);
  if (err == cudaSuccess) err = make_row_map(&m->k, a.k, a.b, a.s, a.nh, st[3], st[4], st[5], hd, f32);
  if (err == cudaSuccess) err = make_row_map(&m->v, a.v, a.b, a.s, a.nh, st[6], st[7], st[8], hd, f32);
  if (err == cudaSuccess) err = make_row_map(&m->dout, a.dout, a.b, a.g, a.nh, st[10], st[11], st[12], hd, f32);
  if (err == cudaSuccess && a.out != nullptr)
    err = make_row_map(&m->out, a.out, a.b, a.g, a.nh, st[13], st[14], st[15], hd, f32);
  return err;
}

cudaError_t launch_dkv_hopper(const Args& a) {
  hopper::Maps maps;
  cudaError_t err = make_maps(&maps, a);
  if (err != cudaSuccess) return err;
  auto kern = hopper::attention_bwd_dkv_wgmma_kernel;
  err = set_smem(kern, hopper::kDkvSmem);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.s + hopper::kRows - 1) / hopper::kRows;
  const long long blocks = static_cast<long long>(a.b) * a.nh * n_kt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), hopper::kThreads, hopper::kDkvSmem, a.stream>>>(
      maps, static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.g, a.s, a.nh,
      n_kt, a.st[9], a.scale);
  return cudaGetLastError();
}

cudaError_t launch_dq_hopper(const Args& a) {
  hopper::Maps maps;
  cudaError_t err = make_maps(&maps, a);
  if (err != cudaSuccess) return err;
  auto kern = hopper::attention_bwd_dq_wgmma_kernel;
  const int n_tiles = (a.s + hopper::kRows - 1) / hopper::kRows;
  const size_t smem = hopper::kDqBits + static_cast<size_t>(n_tiles) * (sizeof(uint64_t) + sizeof(int)) + 1024;
  err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.g + hopper::kRows - 1) / hopper::kRows;
  const long long blocks = static_cast<long long>(a.b) * a.nh * n_qt;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), hopper::kThreads, smem, a.stream>>>(
      maps, static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<bf16*>(a.out0), a.g, a.s, a.nh, n_qt, a.st[9], a.scale);
  return cudaGetLastError();
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
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], a.scale);
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
      static_cast<const bf16*>(a.out), static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<bf16*>(a.out0), a.g, a.s, a.nh, n_qt,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], st[15], a.scale);
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
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], a.scale);
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
      static_cast<const float*>(a.out), static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
      static_cast<float*>(a.out0), a.g, a.s, a.nh,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], st[15], a.scale);
  return cudaGetLastError();
}

// whether every axis a Hopper body maps with TMA (q, k, v, dO; O in D)
// has a positive stride (a broadcast view, stride 0, takes the mma.sync
// body)
bool tma_strides(const Args& a, bool dkv) {
  const int mapped[] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15};
  for (int i : mapped)
    if (a.st[i] <= 0 && (i < 13 || !dkv)) return false;
  return true;
}

// bf16: the Hopper bodies at hd = 64 for g > 16; tiles of 16 query rows
// (one warp in D) when g <= 16: the CLS-only final layer, so no warp
// computes only padding
template <int HD, bool kDkv>
cudaError_t launch(int is_bf16, const Args& a) {
  if (!is_bf16) return kDkv ? launch_dkv_f32<HD>(a) : launch_dq_f32<HD>(a);
  if (HD == 64 && a.g > 16 && tma_strides(a, kDkv)) return kDkv ? launch_dkv_hopper(a) : launch_dq_hopper(a);
  if (kDkv) return a.g <= 16 ? launch_dkv_bf16<HD, 16>(a) : launch_dkv_bf16<HD, 64>(a);
  return a.g <= 16 ? launch_dq_bf16<HD, 1>(a) : launch_dq_bf16<HD, 4>(a);
}

// the wide route's slice bodies: hd above 256, any multiple of 16
template <bool kDkv>
cudaError_t launch_wide_slices(int is_bf16, int hd, const Args& a) {
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
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], a.scale);
  } else if (is_bf16) {
    auto kern = attention_bwd_dq_bf16_wide_kernel;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const uint8_t*>(a.key_valid), static_cast<const bf16*>(a.dout), static_cast<const bf16*>(a.out),
        static_cast<const float*>(a.lse), static_cast<float*>(a.delta), static_cast<bf16*>(a.out0),
        a.g, a.s, a.nh, hd, n_tiles, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
        st[13], st[14], st[15], a.scale);
  } else if (kDkv) {
    auto kern = attention_bwd_dkv_f32_wide_kernel;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta), static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.g, a.s, a.nh, hd, n_tiles, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], a.scale);
  } else {
    auto kern = attention_bwd_dq_f32_wide_kernel;
    cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.out), static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
        static_cast<float*>(a.out0), a.g, a.s, a.nh, hd, n_tiles, n_sl,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
        st[13], st[14], st[15], a.scale);
  }
  return cudaGetLastError();
}

// the wide route's Hopper bodies (namespace wide)
template <typename T, bool kDkv>
cudaError_t launch_wide_hopper(int hd, const Args& a) {
  hopper::Maps maps;
  cudaError_t err = make_maps(&maps, a, hd, std::is_same<T, float>::value);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.s + wide::kRows - 1) / wide::kRows, n_qt = (a.g + wide::kRows - 1) / wide::kRows;
  // the ring's slots: the body's choice where they fit, else two
  const int n = kDkv ? n_qt : n_kt, pref = kDkv ? wide::Cfg<T>::kStagesC : wide::Cfg<T>::kStagesD;
  constexpr wide_sm90::Body kBody = kDkv ? wide_sm90::Body::C : wide_sm90::Body::D;
  const int n_st = wide_sm90::smem_bytes<T, kBody>(pref, n, n_kt) <= wide::kSmemMax ? pref : 2;
  const size_t smem = wide_sm90::smem_bytes<T, kBody>(n_st, n, n_kt);
  const long long blocks = static_cast<long long>(a.b) * a.nh * (kDkv ? n_kt : n_qt);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const long long* st = a.st;
  if constexpr (kDkv) {
    auto kern = wide::attention_bwd_dkv_wide_wgmma_kernel<T>;
    err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(blocks), wide::kThreads + wide::Cfg<T>::kSide, smem, a.stream>>>(
        maps, static_cast<const uint8_t*>(a.key_valid), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.g, a.s, a.nh, hd, n_kt,
        n_st, st[9], a.scale);
  } else {
    auto kern = wide::attention_bwd_dq_wide_wgmma_kernel<T>;
    err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(blocks), wide::kThreads + wide::Cfg<T>::kSide, smem, a.stream>>>(
        maps, static_cast<const T*>(a.dout), static_cast<const T*>(a.out), static_cast<const uint8_t*>(a.key_valid),
        static_cast<const float*>(a.lse), static_cast<float*>(a.delta), static_cast<T*>(a.out0), a.g, a.s, a.nh, hd,
        n_qt, n_st, st[9], st[10], st[11], st[12], st[13], st[14], st[15], a.scale);
  }
  return cudaGetLastError();
}

// the wide route, hd above 256: the Hopper bodies wherever TMA takes the
// strides and a block's stored tiles fit in shared memory (C: P^T and dS^T
// of every query row, bf16 g <= 640, f32 g <= 256; D: dS of every key, bf16
// s <= 1280, f32 s <= 512); the slice bodies, which recompute the scores
// for each 64-column output slice, past that
template <bool kDkv>
cudaError_t launch_wide(int is_bf16, int hd, const Args& a) {
  const int n_kt = (a.s + wide::kRows - 1) / wide::kRows;
  const int n = kDkv ? (a.g + wide::kRows - 1) / wide::kRows : n_kt;
  if (tma_strides(a, kDkv)) {
    constexpr wide_sm90::Body kBody = kDkv ? wide_sm90::Body::C : wide_sm90::Body::D;
    if (is_bf16 && wide_sm90::smem_bytes<bf16, kBody>(2, n, n_kt) <= wide::kSmemMax)
      return launch_wide_hopper<bf16, kDkv>(hd, a);
    if (!is_bf16 && wide_sm90::smem_bytes<float, kBody>(2, n, n_kt) <= wide::kSmemMax)
      return launch_wide_hopper<float, kDkv>(hd, a);
  }
  return launch_wide_slices<kDkv>(is_bf16, hd, a);
}

template <bool kDkv>
int run(const Args& a, int is_bf16, int hd, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
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

// Both entries take, after their pointers: is_bf16, b, g, s, nh, hd, then
// 16 strides in elements (q, k, v: batch, row, head; key_valid's batch;
// dO's and O's batch, row, head), the softmax scale, the device and the
// stream. Each returns cudaGetLastError() after its launch.

// Kernel D: dQ, (b, g, nh, hd) contiguous in q's dtype, and delta = rowsum(dO
// * O), (b, nh, g) f32, for kernel C. Launch it first.
extern "C" int attention_bwd_dq(const void* q, const void* k, const void* v, const void* key_valid,
                                const void* dout, const void* out, const void* lse, void* delta, void* dq,
                                int is_bf16, int b, int g, int s, int nh, int hd, long long q_sb,
                                long long q_sr, long long q_sh, long long k_sb, long long k_sr, long long k_sh,
                                long long v_sb, long long v_sr, long long v_sh, long long valid_sb,
                                long long do_sb, long long do_sr, long long do_sh, long long o_sb,
                                long long o_sr, long long o_sh, float scale, int device, void* stream) {
  const Args a{q, k, v, key_valid, dout, out, lse, delta, dq, nullptr, b, g, s, nh,
               {q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb, do_sb, do_sr, do_sh, o_sb, o_sr,
                o_sh},
               scale, static_cast<cudaStream_t>(stream)};
  return run<false>(a, is_bf16, hd, device);
}

// Kernel C: dK and dV, each (b, s, nh, hd) contiguous in q's dtype, from
// kernel D's delta (O's strides are not read).
extern "C" int attention_bwd_dkv(const void* q, const void* k, const void* v, const void* key_valid,
                                 const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                                 int is_bf16, int b, int g, int s, int nh, int hd, long long q_sb,
                                 long long q_sr, long long q_sh, long long k_sb, long long k_sr, long long k_sh,
                                 long long v_sb, long long v_sr, long long v_sh, long long valid_sb,
                                 long long do_sb, long long do_sr, long long do_sh, long long o_sb,
                                 long long o_sr, long long o_sh, float scale, int device, void* stream) {
  const Args a{q, k, v, key_valid, dout, nullptr, lse, const_cast<void*>(delta), dk, dv, b, g, s, nh,
               {q_sb, q_sr, q_sh, k_sb, k_sr, k_sh, v_sb, v_sr, v_sh, valid_sb, do_sb, do_sr, do_sh, o_sb, o_sr,
                o_sh},
               scale, static_cast<cudaStream_t>(stream)};
  return run<true>(a, is_bf16, hd, device);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
