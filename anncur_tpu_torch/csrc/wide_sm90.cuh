// The wide route's Hopper machinery (head dims above 256), shared by kernel
// A's body (csrc/attention.cu, namespace wide) and kernels C and D's
// (csrc/attention_bwd.cu, namespace wide): the ring of TMA-filled slots and
// its barrier walk, the side warps that keep it full (and, in f32, write
// the split operands), the products over a chunk of the head dim and over a
// tile of 64 reduced rows, and the fragment-order stores.
//
// A block is one consumer warpgroup, which runs the products, and side
// warps: one (bf16) or four (f32), whose first lane keeps TMA loads a ring
// of slots ahead (three where they fit in shared memory, else two). In f32
// the side warps also write each slot's split operands (phase 1's small
// parts, phase 2's transposes) while the consumers run the products of the
// slot before. Per slot, full completes when its tiles land, ready (f32)
// when its split operands are written, empty when the consumers are done
// with it. A block's steps, in ring order: phase 1 walks its pairs of tiles
// over the head dim in chunks, phase 2 its output columns in slices, so the
// loads run ahead across the two. (On the H100 the side warps took the f32
// backward at hd 768 from 4.05 to 3.63 ms against one warpgroup that loaded
// and split for itself, and a third slot from 3.14 to 2.82, each pair in one
// call of cli/time_attention_bwd.py; PERF.md.)
//
// bf16 runs wgmma m64n64k16; f32 three TF32 passes (m64n64k8: A split in
// registers, B's small part written beside it by the side warps, its raw
// tile the big part), each chunk or tile of 64 reduced rows summed apart and
// added in f32. TF32 takes K-major operands only, so phase 2's B is
// transposed in the pass that splits it, its reduced rows placed in the
// order of the stored A fragments. Columns past hd are zero-filled and
// computed: a wgmma skipped by a predicate made ptxas serialise every
// product (C7520).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace wide_sm90 {

using namespace wgmma_sm90;

constexpr int kRows = 64;         // rows of every tile: queries or keys
constexpr int kTile = 8192;       // a 64-row x 128-byte tile: 64 bf16 or 32 f32 columns
constexpr int kThreads = 128;     // the consumer warpgroup
constexpr int kMaxStages = 3;     // slots of the ring at most (a launch takes 2 or 3)
constexpr int kSmemMax = 232448;  // the dynamic shared memory a block may take

template <typename T>
struct Cfg {  // bf16
  static constexpr int kCols = 64;            // head-dim columns of a tile (a chunk)
  static constexpr int kSlot = 4 * kTile;     // a slot of C's and D's ring: four tiles
  static constexpr int kSlotA = 2 * kTile;    // of A's: two (Q and K chunks, or two V blocks)
  static constexpr int kSliceA = 128;         // output columns of a kernel A slice: two m64n64 blocks of O
  static constexpr int kSliceC = 128;         // of a kernel C slice: two m64n64 blocks of dK, of dV
  static constexpr int kSliceD = 128;         // of a kernel D slice: two of dQ
  static constexpr int kStoreA = kTile;       // P of a key tile, as bf16 A fragments
  static constexpr int kStoreC = 2 * kTile;   // P^T and dS^T of a query tile, as bf16 A fragments
  static constexpr int kStoreD = kTile;       // dS of a key tile
  static constexpr int kSide = 32;            // side threads: one warp, the producer
  static constexpr int kStagesA = 3, kStagesC = 3, kStagesD = 2;  // ring slots, where they fit
  static constexpr int kMinBlocksA = 2;       // A's blocks an SM
  static constexpr int kMinBlocksD = 2;       // D's blocks an SM (its shared memory allows two at g = s = 255)
};
template <>
struct Cfg<float> {
  static constexpr int kCols = 32;
  static constexpr int kSlot = 6 * kTile;     // four raw tiles and two small parts, or two raw and a split transpose
  static constexpr int kSlotA = 6 * kTile;    // two raw tiles and a small part, or two raw and a split transpose
  static constexpr int kSliceA = 64;          // one m64n64 block of O
  static constexpr int kSliceC = 64;          // one m64n64 block of dK and of dV (a ring step each)
  static constexpr int kSliceD = 64;          // one of dQ
  static constexpr int kStoreA = 2 * kTile;   // P of a key tile, f32 in A-fragment order
  static constexpr int kStoreC = 4 * kTile;   // P^T and dS^T of a query tile, f32 in A-fragment order
  static constexpr int kStoreD = 2 * kTile;
  static constexpr int kSide = 128;           // four warps: the producer and splitters
  static constexpr int kStagesA = 3, kStagesC = 3, kStagesD = 3;
  static constexpr int kMinBlocksA = 1;
  static constexpr int kMinBlocksD = 1;
};

enum class Body { A, C, D };

// a block's dynamic shared memory: a ring of n_st slots, n stored tiles (A,
// D: every key tile, of n_kt; C: every query tile), A's rescale factor of
// each row after each key tile, the barriers (full, ready, empty per slot),
// (A, D) a mask word and a running-tile index per key tile, room to align to
// 1024 bytes
template <typename T, Body K>
constexpr size_t smem_bytes(int n_st, int n, int n_kt) {
  using C = Cfg<T>;
  const size_t slot = K == Body::A ? C::kSlotA : C::kSlot;
  const size_t store = K == Body::A ? C::kStoreA + kRows * sizeof(float) : (K == Body::C ? C::kStoreC : C::kStoreD);
  return static_cast<size_t>(n_st) * slot + static_cast<size_t>(n) * store + 3 * kMaxStages * sizeof(uint64_t) +
         (K == Body::C ? 0 : static_cast<size_t>(n_kt) * (sizeof(uint64_t) + sizeof(int))) + 1024;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// one box of a row map at (head h, row, batch b, column col) into dst; its
// bytes complete on bar; issued by the threads that pass `issue`
__device__ __forceinline__ void load_tile(void* dst, const RowMap& m, uint64_t* bar, int h, int row, int b,
                                          bool issue, int col = 0) {
  int c[4];
  tile_coords(m.order, h, row, b, c, col);
  tma_load_4d(dst, &m.map, bar, c[0], c[1], c[2], c[3], issue);
}

// the bf16 A fragment of k-step kk from an accumulator (the layout note of
// csrc/wgmma_sm90.cuh): columns 16kk..16kk+15 rounded to bf16 pairs
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = mma_sm90::pack_bf16x2(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// byte offset of f32 (row, col) in a 128-byte-swizzled tile of 32-column rows
__device__ __forceinline__ int sw_f32(int row, int col) {
  return row * 128 + (((col >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// the tf32 A fragment of k-step kk (columns 8kk..8kk+7) of a raw f32 tile,
// split in registers: big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split_frag(uint32_t (&big)[4], uint32_t (&small)[4], const unsigned char* tile, int kk,
                                           int tid) {
  const int row = 16 * (tid >> 5) + ((tid & 31) >> 2), col = 8 * kk + (tid & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = *reinterpret_cast<const float*>(tile + sw_f32(row + 8 * (i & 1), col + 4 * (i >> 1)));
    big[i] = tf32_rna(x);
    small[i] = tf32_rna(x - __uint_as_float(big[i]));
  }
}

// the same of an A fragment stored in fragment order
__device__ __forceinline__ void split4(uint32_t (&big)[4], uint32_t (&small)[4], float4 v) {
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    big[i] = tf32_rna(x[i]);
    small[i] = tf32_rna(x[i] - __uint_as_float(big[i]));
  }
}

__device__ __forceinline__ void keep(uint32_t (&a)[2][4]) {
  wgmma_sm90::keep(a[0]);
  wgmma_sm90::keep(a[1]);
}

// Phase 1's NP products (1 or 2) over one chunk of the head dim, from a slot
// holding A0 (, A1), B0 (, B1) at tiles 0 .. 2 NP - 1 (rows, then the
// chunk's columns: every operand K-major): x (+)= A0 B0^T (and y (+)= A1
// B1^T); the first chunk overwrites x (and y). Columns past hd are
// zero-filled and add nothing. bf16: straight into x (and y). f32: the B
// tiles' small parts in tiles 2 NP .. 3 NP - 1 (the side warps'
// split_small; the raw tiles serve as their big parts), the chunk's three
// TF32 passes into sums of its own, added to x (and y) in f32. With NP = 1
// y is not touched.
template <typename T, int NP>
__device__ __forceinline__ void chunk(float (&x)[32], float (&y)[32], unsigned char* slot, bool first, int tid) {
  static_assert(NP == 1 || NP == 2, "one or two products a chunk");
  const uint32_t base = smem_u32(slot);
  if constexpr (!std::is_same<T, float>::value) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // x's and y's products in turns
      mma_ss(x, desc_sw128(base + 32 * kk), desc_sw128(base + NP * kTile + 32 * kk), !first || kk > 0);
      if constexpr (NP == 2)
        mma_ss(y, desc_sw128(base + kTile + 32 * kk), desc_sw128(base + 3 * kTile + 32 * kk), !first || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_sm90::keep(x);
    if constexpr (NP == 2) wgmma_sm90::keep(y);
  } else {
    float px[32], py[32];  // the first k-step overwrites them
    uint32_t fb[2][2][4], fs[2][2][4];  // [set][operand][register]: two k-steps' fragments live
    // per k-step: A0's (and A1's) fragments split in registers, then small
    // A x big B + big A x small B + big A x big B, x's and y's in turns,
    // committed as a group
    auto issue = [&](int kk, uint32_t (&b)[2][4], uint32_t (&s)[2][4]) {
      split_frag(b[0], s[0], slot, kk, tid);
      if constexpr (NP == 2) split_frag(b[1], s[1], slot + kTile, kk, tid);
      wgmma_fence();
      mma_tf32_n64(px, s[0], desc_sw128(base + NP * kTile + 32 * kk), kk > 0);
      if constexpr (NP == 2) mma_tf32_n64(py, s[1], desc_sw128(base + 3 * kTile + 32 * kk), kk > 0);
      mma_tf32_n64(px, b[0], desc_sw128(base + 2 * NP * kTile + 32 * kk), 1);
      if constexpr (NP == 2) mma_tf32_n64(py, b[1], desc_sw128(base + 5 * kTile + 32 * kk), 1);
      mma_tf32_n64(px, b[0], desc_sw128(base + NP * kTile + 32 * kk), 1);
      if constexpr (NP == 2) mma_tf32_n64(py, b[1], desc_sw128(base + 3 * kTile + 32 * kk), 1);
      wgmma_commit();
    };
    auto keep_set = [&](uint32_t (&a)[2][4]) {
      if constexpr (NP == 2)
        keep(a);
      else
        wgmma_sm90::keep(a[0]);
    };
    issue(0, fb[0], fs[0]);
#pragma unroll
    for (int kk = 1; kk < 4; ++kk) {
      issue(kk, fb[kk & 1], fs[kk & 1]);
      wgmma_wait<1>();  // k-step kk - 1 is done: its fragments may be rewritten
      keep_set(fb[(kk - 1) & 1]);
      keep_set(fs[(kk - 1) & 1]);
    }
    wgmma_wait<0>();
    wgmma_sm90::keep(px);
    if constexpr (NP == 2) wgmma_sm90::keep(py);
    keep_set(fb[1]);
    keep_set(fs[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = first ? px[i] : x[i] + px[i];
      if constexpr (NP == 2) y[i] = first ? py[i] : y[i] + py[i];
    }
  }
}

// the same with one product (kernel A's S = Q K^T)
template <typename T>
__device__ __forceinline__ void chunk(float (&x)[32], unsigned char* slot, bool first, int tid) {
  chunk<T, 1>(x, x, slot, first, tid);
}

// f32, phase 2: the two raw tiles of a slot (64 reduced rows x 32 columns
// each, at tiles 0 and 1: one 64-column block) as the K-major B operand of
// its columns: the big part in tiles 2 and 3 (reduced rows 0-31, 32-63),
// the small in 4 and 5. The reduced row q goes to place k = 8 (q / 8) + p,
// p = q % 8 / 2 (+ 4 if q is odd): the order of the A fragments that the
// kernels' phase 1 stores. So places 4m..4m+3 hold rows of one parity,
// 8 (m / 2) + (m % 2) + 0, 2, 4, 6: each thread gathers four of them from
// one column (a warp reads 32 neighbouring columns of a row) and writes
// them as one 16-byte unit (a quarter-warp's units fall in distinct banks).
// Run by the f32 side warps (side thread sid of kSide).
__device__ __forceinline__ void transpose_split(unsigned char* slot, int sid) {
  constexpr int kSide = Cfg<float>::kSide;
#pragma unroll 4
  for (int j = 0; j < 2 * 32 * (kRows / 4) / kSide; ++j) {
    const int i = sid + j * kSide, n = i & 31, m = (i >> 5) & 15, src = i >> 9;
    const int q0 = 8 * (m >> 1) + (m & 1), k = 4 * m;
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = *reinterpret_cast<const float*>(slot + src * kTile + sw_f32(q0 + 2 * c, n));
    const int off = (2 + (k >> 5)) * kTile + sw_f32(32 * src + n, k & 31);
    *reinterpret_cast<float4*>(slot + off) = make_float4(e[0], e[1], e[2], e[3]);
    *reinterpret_cast<float4*>(slot + off + 2 * kTile) =
        make_float4(tf32_small(e[0]), tf32_small(e[1]), tf32_small(e[2]), tf32_small(e[3]));
  }
}

// f32, phase 1: the small parts of the slot's NP B tiles (tiles NP ..
// 2 NP - 1) into tiles 2 NP .. 3 NP - 1, by the side warps
template <int NP>
__device__ __forceinline__ void split_small(unsigned char* slot, int sid) {
  constexpr int kSide = Cfg<float>::kSide;
  const float4* raw = reinterpret_cast<const float4*>(slot + NP * kTile);
  float4* small = reinterpret_cast<float4*>(slot + 2 * NP * kTile);
#pragma unroll 4
  for (int j = 0; j < NP * kTile / 16 / kSide; ++j) {
    const float4 v = raw[sid + j * kSide];
    small[sid + j * kSide] = make_float4(tf32_small(v.x), tf32_small(v.y), tf32_small(v.z), tf32_small(v.w));
  }
}

// f32, phase 2: out (+)= A X for one 64-column block over one tile of 64
// reduced rows. A: the stored f32 fragments at a (one float4 a thread per
// k-step of 8 rows), split in registers; X: the slot's block as the side
// warps' transpose_split left it. Per k-step small A x big X + big A x
// small X + big A x big X, each pass in a sum of its own, the small sums
// then the big added to out in f32. acc: add to out (else overwrite it).
__device__ __forceinline__ void f32_block_step(float (&out)[32], unsigned char* slot, const float4* a, bool acc,
                                               int tid) {
  const uint32_t base = smem_u32(slot);
  float part[3][32];  // the first k-step overwrites them
  uint32_t fb[2][4], fs[2][4];
  auto issue = [&](int j, uint32_t (&b)[4], uint32_t (&s)[4]) {
    split4(b, s, a[j * kThreads + tid]);
    const uint32_t kt = (j >> 2) * kTile + 32 * (j & 3);
    wgmma_fence();
    mma_tf32_n64(part[0], s, desc_sw128(base + 2 * kTile + kt), j > 0);
    mma_tf32_n64(part[1], b, desc_sw128(base + 4 * kTile + kt), j > 0);
    mma_tf32_n64(part[2], b, desc_sw128(base + 2 * kTile + kt), j > 0);
    wgmma_commit();
  };
  issue(0, fb[0], fs[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    issue(j, fb[j & 1], fs[j & 1]);
    wgmma_wait<1>();  // k-step j - 1 is done: its fragments may be rewritten
    wgmma_sm90::keep(fb[(j - 1) & 1]);
    wgmma_sm90::keep(fs[(j - 1) & 1]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < 3; ++p) wgmma_sm90::keep(part[p]);
  wgmma_sm90::keep(fb[1]);
  wgmma_sm90::keep(fs[1]);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float v = part[2][i] + (part[0][i] + part[1][i]);
    out[i] = acc ? out[i] + v : v;
  }
}

// bf16, phase 2, one tile of 64 reduced rows of one slice: d[j] (+)= A X_j
// over the tile's rows, A the stored bf16 fragments at st (kernel A: P;
// kernel D: dS), X_j the slot's tile j (j = 0, 1: two 64-column blocks: V
// in A, K in D) as MN-major B. acc: add to d (else overwrite it).
__device__ __forceinline__ void bf16_block_step(float (&d)[2][32], unsigned char* slot, const unsigned char* st,
                                                bool acc, int tid) {
  const uint32_t base = smem_u32(slot);
  const uint4* in = reinterpret_cast<const uint4*>(st);
  uint32_t sa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint4 s = in[kk * kThreads + tid];
    sa[kk][0] = s.x, sa[kk][1] = s.y, sa[kk][2] = s.z, sa[kk][3] = s.w;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)  // the two accumulators in turns
#pragma unroll
    for (int j = 0; j < 2; ++j) mma_rs_mn(d[j], sa[kk], desc_sw128(base + j * kTile + 2048 * kk), acc || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) wgmma_sm90::keep(d[j]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_sm90::keep(sa[kk]);
}

// An accumulator tile in the order phase 2 reads it back (its own thread's
// entries): bf16 as the A fragments of the next product, f32 as the
// fragments' f32 values in their order (a0..a3 = entries 0, 2, 1, 3 of each
// 8 columns; transpose_split places the reduced rows to match)
template <typename T>
__device__ __forceinline__ void store_frags(unsigned char* st, const float (&x)[32], int tid) {
  if constexpr (std::is_same<T, float>::value) {
    float4* out = reinterpret_cast<float4*>(st);
#pragma unroll
    for (int j = 0; j < 8; ++j) out[j * kThreads + tid] = make_float4(x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]);
  } else {
    uint32_t a[4][4];
    to_a(a, x);
    uint4* out = reinterpret_cast<uint4*>(st);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) out[kk * kThreads + tid] = make_uint4(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
  }
}

// two outputs at p, where on (a predicated store: no branch in the warpgroup)
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool on) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.b32 [%0], %1;\n}\n" ::"l"(p),
               "r"(mma_sm90::pack_bf16x2(a, b)), "r"(static_cast<int>(on))
               : "memory");
}
__device__ __forceinline__ void store2(float* p, float a, float b, bool on) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n@q st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(p), "f"(a),
               "f"(b), "r"(static_cast<int>(on))
               : "memory");
}

// this thread's entries of a 64-row output block (times mul): rows row0 + 16
// warp + r (+ 8) below n_rows of dst (row stride rs), columns col0 + 8jj +
// cq (+ 1) below hd
template <typename T, int NA>
__device__ __forceinline__ void store_block(T* dst, long long rs, const float (&d)[NA], float mul, int row0, int n_rows,
                                            int col0, int hd, int tid) {
  const int row = row0 + 16 * (tid >> 5) + ((tid & 31) >> 2), cq = 2 * (tid & 3);
#pragma unroll
  for (int jj = 0; jj < NA / 4; ++jj)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rr = row + 8 * half, col = col0 + 8 * jj + cq;
      const bool on = rr < n_rows && col < hd;
      store2(dst + (on ? rr * rs + col : 0), d[4 * jj + 2 * half] * mul, d[4 * jj + 2 * half + 1] * mul, on);
    }
}

// a step's slot of a ring of n slots, and the parity of the slot's phase
struct Ring {
  int n, slot = 0, parity = 0;
  __device__ __forceinline__ void next() {
    if (++slot == n) slot = 0, parity ^= 1;
  }
};

// The side warps' loop over a block's ring steps (side thread sid): lane 0
// keeps the loads n_st steps ahead, refilling a slot (kSlot bytes) once the
// consumers are done with it; in f32 the side warps first write each slot's
// split operands (steps below n1, phase 1: the small parts of its NP B
// tiles; phase 2: the transpose) and mark it ready.
template <typename T, int NP, int kSlot, typename Issue>
__device__ __forceinline__ void side_loop(const Issue& issue, uint64_t* full, uint64_t* ready, uint64_t* empty,
                                          unsigned char* smem, int n_st, int n1, int n_all, int sid) {
  for (int i = 0; i < n_st; ++i) issue(i, i, sid == 0 && i < n_all);
  Ring fs{n_st}, rs{n_st};  // the slots of steps f and r
  for (int f = 0; f < n_all; ++f, fs.next()) {
    if constexpr (std::is_same<T, float>::value) {
      unsigned char* slot = smem + fs.slot * kSlot;
      mbar_wait(full + fs.slot, fs.parity);
      if (f < n1)
        split_small<NP>(slot, sid);
      else
        transpose_split(slot, sid);
      fence_proxy_async();
      mbar_arrive(ready + fs.slot, true);
    }
    // the slot of step r, once the consumers are done with it, takes step r + n_st
    const int r = std::is_same<T, float>::value ? f - 1 : f;
    if (r >= 0) {
      if (r + n_st < n_all) {
        mbar_wait(empty + rs.slot, rs.parity);
        issue(r + n_st, rs.slot, sid == 0);
      }
      rs.next();
    }
  }
}

}  // namespace wide_sm90
