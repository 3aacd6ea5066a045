// The paged K/V walk of K6 and K7 (ragged_paged_attention.cu), K9
// (paged_decode_attention.cu) and K10 (grouped_paged_attention.cu), in all
// their pool lanes: one kernel, `ring_walk_kernel`, whose entries differ
// only in what they hand it.
//
// One online-softmax arithmetic serves all of them: `attend_row` folds one
// staged piece of a page into one query row's (m, l, acc), and every walk
// folds a row's pages in the same order, 0 .. last, each page in the same
// pieces (`piece_rows`). K10 splits that order at the group's shared span
// (phase 1 takes pages 0 .. cnt-1, phase 2 continues at cnt), and the
// partials cross between the phases as exact f32 values in device memory,
// so K10's output equals K6's bit for bit on the same operands; K6 is the
// walk with no groups, K9 the walk at q_len 1. At page size 16 and head
// dims 32-256 the walk folds two rows a warp with `attend_pair`, which
// gives every value attend_row's operations in the same order (its note
// says why), with or without a user mask.
//
// The feeder: a ring of kRingStages raw page stages in shared memory,
// filled by cp.async (`ring_issue`), each thread converting the chunks it
// copied itself into an f32 working tile (`ring_convert`), so neither the
// copy nor the conversion waits on another thread; where the ring does not
// fit shared memory, or a pool row is not a multiple of 4 bytes (cp.async
// copies 4, 8 or 16), each piece is loaded straight from the pools into
// one tile. The copies are the widest of 16, 8 or 4 bytes that divides a
// pool row (`copy_bytes`), else one element. Either way the converted
// values are the same bits.
//
// The pools hold q's dtype (the fp lane), int8 codes with f32 rowwise
// scale pools (the q8 lane: K7 and K10's q8 lane) or float8 e4m3 values
// (the fp8 lane). Only the conversion differs: it writes the same f32
// tiles from each, so every lane folds with the one `attend_row`.
//
// Layout shared with the Python wrappers: q, out [B, lq, H, D]; pools
// [num_pages, ps, Hkv, D]; scale pools [num_pages, ps, Hkv]; page_table
// [B, mp]; pos, q_len, group_id, group_leader, group_cnt [B] int32. An
// item (query block t of qblk <= 8 queries, row b) has, for kv head g,
// the rows r = 0 .. qblk*rep-1: query t*qblk + r/rep, head g*rep + r%rep.
// A block walks a contiguous run of at most ceil(qblk*rep / split) of
// them (`walk_split`: 1 wherever the whole item fits shared memory, so a
// block then owns all of them), reading the item's pages itself. The
// phase-1 partials are f32 m, l [Hkv, nqb, B*qblk*rep] and acc
// [Hkv, nqb, B*qblk*rep, D], row b*qblk*rep + r.
#pragma once

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace walk {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;     // the masked score, as on the TPU
constexpr int kQBlk = 8;              // queries per block
// raw page stages in flight ahead of the conversion
constexpr int kRingStages = 2;
// the most dynamic shared memory one block may take on the H100
constexpr size_t kSmemMax = 232448;
// launches with at most this many (query block, row) items schedule them
// longest walk first
constexpr int kSortMax = 512;
// the dynamic shared memory a block may take beside the static schedule
// keys (sKey, sItem: 2064 bytes as ptxas lays them out)
constexpr size_t kDynSmemMax = kSmemMax - sizeof(int) * (kSortMax + 4);
// the most keys one piece of a page holds (PJ 4: four keys a lane)
constexpr int kPieceMax = 128;
// With a compile-time head dim up to 64 a folding half-warp keeps its
// query row in registers (PTT_WALK_Q_REGS 1, K6/K7 and K10: blocks of up
// to 8 row pairs, where reading q once pays), or reads it from shared
// memory at each fold (0: K9's blocks of rep rows, whose registers are
// worth more to the rest of the walk). A library sets it before it
// includes this header; the bits are the same either way.
#ifndef PTT_WALK_Q_REGS
#define PTT_WALK_Q_REGS 1
#endif

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;     // the q8 lane only
  const float* v_scale;
  const int* page_table;
  const int* pos;
  const int* q_len;         // null: every row at q_len 1 (K9)
  const int* group_id;      // K10 only (null: no groups, K6 and K9)
  const int* group_leader;  // K10 phase 1 only
  const int* group_cnt;     // K10 only
  const float* mask;        // the user mask, additive f32: K9's
                            // [B, H, mp * ps], K6's and K7's
                            // [B, H, lq, mp * ps]
  float* pm;                // K10 partials
  float* pl;
  float* pacc;
  void* out;
  int B, lq, H, Hkv, D, ps, mp, num_pages, qblk, nqb;
  int pool;                 // Pool code
  float scale;
  int split;                // blocks an item's rows are split over
};

inline Args make_args(const void* q, const void* k, const void* v,
                      const void* k_scale, const void* v_scale,
                      const void* page_table, const void* pos,
                      const void* q_len, int B, int lq, int H, int Hkv,
                      int D, int ps, int mp, int num_pages, int pool) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.pool = pool;
  a.page_table = static_cast<const int*>(page_table);
  a.pos = static_cast<const int*>(pos);
  a.q_len = static_cast<const int*>(q_len);
  a.B = B;
  a.lq = lq;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.ps = ps;
  a.mp = mp;
  a.num_pages = num_pages;
  a.qblk = lq < kQBlk ? lq : kQBlk;
  a.nqb = (lq + a.qblk - 1) / a.qblk;
  a.scale = 1.0f / sqrtf((float)D);
  a.split = 1;
  return a;
}

// A pool code the loaders know, with scale pools exactly in the q8 lane.
inline bool pools_valid(const Args& a) {
  const bool scaled = a.k_scale != nullptr && a.v_scale != nullptr;
  const bool unscaled = a.k_scale == nullptr && a.v_scale == nullptr;
  switch (a.pool) {
    case kPoolQ:
    case kPoolE4M3:
      return unscaled;
    case kPoolI8:
      return scaled;
    default:
      return false;
  }
}

// Pages row b's query block [q0, q0 + qblk) reads: through the last live
// query's position, at most mp.
__device__ __forceinline__ int block_pages(int pos_b, int qlen_b, int q0,
                                           int qblk, int ps, int mp) {
  const int last_qi = min(q0 + qblk, qlen_b) - 1;
  return min(mp, (pos_b + last_qi) / ps + 1);
}

// The keys of one piece: a page is folded in pieces of at most
// kPieceMax rows, so a piece's scores fit four a lane (PJ 4). A whole page
// up to 128 keys where its f32 tile fits shared memory beside the state of
// kQBlk rows (every page size the walks took before pieces, so those folds
// are unchanged); at head dims over 256 a tile of at most 64 KB, leaving
// room for the rows' state. A longer page is cut into equal pieces (the
// last may be shorter). A function of D and ps only, so that every walk
// (K6, K7, K9, K10a, K10b) folds the same pieces in the same order, which
// keeps K10 = K6 and K9 = K6 bit for bit.
__host__ __device__ inline int piece_rows(int D, int ps) {
  const int tile = 2 * D + 1;  // floats a key takes: K [D + 1], V [D]
  const int budget = D <= 256
                         ? static_cast<int>(kSmemMax / 4) - kQBlk * (2 * D + 2)
                         : 16384;
  int cap = budget / tile;
  cap = cap < kPieceMax ? cap : kPieceMax;
  cap = cap > 1 ? cap : 1;
  if (ps <= cap) return ps;
  const int pieces = (ps + cap - 1) / cap;
  return (ps + pieces - 1) / pieces;
}

// Bytes of one copy: the widest of 16, 8 or 4 that divides a pool row of
// D elements of `elem` bytes, else one element (no cp.async: direct loads).
__host__ __device__ inline int copy_bytes(int D, int elem) {
  const int row = D * elem;
  if (row % 16 == 0) return 16;
  if (row % 8 == 0) return 8;
  if (row % 4 == 0) return 4;
  return elem;
}

// bytes of one pool element: q's dtype in the fp lane, else 1
template <typename T>
__host__ __device__ inline int pool_elem(int pool) {
  return pool == kPoolQ ? static_cast<int>(sizeof(T)) : 1;
}

// the shapes of the compile-time, two-rows-a-warp instantiations
__host__ __device__ inline bool ring_paired(int D, int ps) {
  return ps == 16 && (D == 32 || D == 64 || D == 128 || D == 256);
}

// Fold one staged piece (keys kbase .. kbase + ps - 1) into one query
// row's online softmax, by one warp: lane j scores key j (and j + 32, ...),
// the piece's max and sum are warp reductions, and lane d accumulates
// output column d (and d + 32, ...) with the probabilities broadcast by
// shuffles. Key kp is live iff the query is (qlive) and kp <= qmax
// (= pos + i). DV: output columns per lane and column piece; the columns
// are walked in pieces of 32 * DV (one piece unless D > 256), each column
// getting the same operations in the same order. PJ: keys per lane
// (ps <= 32 * PJ). kMasked (the user mask of K9, K6 and K7): the additive
// f32 mask row `mrow` (indexed by key position) is added to each key's
// score after the window mask, as the TPU kernel adds it; it is a
// template flag, so the unmasked instantiations are the code they were.
template <int DV, int PJ, bool kMasked = false>
__device__ __forceinline__ void attend_row(const float* qr, const float* sK,
                                           const float* sV, int D, int ps,
                                           int kbase, bool qlive, int qmax,
                                           float scale, float* m, float* l,
                                           float* acc, int lane,
                                           const float* mrow = nullptr) {
  const int kstride = D + 1;
  float s[PJ];
  float mcur = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < PJ; ++i) {
    const int j = lane + 32 * i;
    s[i] = -CUDART_INF_F;  // no such key: contributes nothing
    if (j < ps) {
      const float* kr = sK + j * kstride;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const bool live = qlive && (kbase + j <= qmax);
      s[i] = live ? dot * scale : kNegInf;
      // __fadd_rn: never contracted into an FMA with the product above
      if (kMasked) s[i] = __fadd_rn(s[i], __ldg(mrow + kbase + j));
      mcur = fmaxf(mcur, s[i]);
    }
  }
  mcur = warp_max(mcur);
  const float mprev = *m;
  const float mnew = fmaxf(mprev, mcur);
  const float alpha = expf(mprev - mnew);
  float pj[PJ];
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < PJ; ++i) {
    pj[i] = (lane + 32 * i < ps) ? expf(s[i] - mnew) : 0.f;
    psum += pj[i];
  }
  psum = warp_sum(psum);
  for (int c0 = 0; c0 < D; c0 += 32 * DV) {
    float a[DV];
#pragma unroll
    for (int u = 0; u < DV; ++u) {
      const int d = c0 + lane + 32 * u;
      a[u] = d < D ? acc[d] * alpha : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PJ; ++i) {
      for (int jj = 0; jj < 32; ++jj) {
        const int j = 32 * i + jj;
        if (j >= ps) break;  // uniform across the warp
        const float pv = __shfl_sync(kFullMask, pj[i], jj);
        const float* vr = sV + j * D;
#pragma unroll
        for (int u = 0; u < DV; ++u) {
          const int d = c0 + lane + 32 * u;
          if (d < D) a[u] = fmaf(pv, vr[d], a[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < DV; ++u) {
      const int d = c0 + lane + 32 * u;
      if (d < D) acc[d] = a[u];
    }
  }
  __syncwarp();  // every lane has read *m and *l
  if (lane == 0) {
    *m = mnew;
    *l = fmaf(alpha, *l, psum);
  }
}

// `attend_row` for two query rows at once, at page size 16 (kPS): lanes
// 0-15 fold the row whose (q, m, l, acc) this lane is given, lanes 16-31
// theirs, lane j of a half scoring key j. Every value gets the operations
// attend_row gives it, in the same order: key j's dot product is the same
// FMA chain over d = 0 .. D-1 (K read four floats at a time from the
// [kPS][kD + 4] tile), the page's max and sum are the 16-lane butterflies
// that attend_row's 32-lane ones reduce to when lanes 16-31 hold -inf and
// +0 (keys past the page), the output column c's chain is acc[c] * alpha
// followed by one FMA per key in key order (lane j of a half owning
// columns 4j .. 4j + 3 of each 64, read with 16-byte loads), and
// l = fmaf(alpha, l, psum). (NaN scores aside: fmaxf drops a NaN against
// the -inf of an absent lane, so with a NaN in q or K the two may differ;
// the pools and queries are finite.) `owner` false: this half computes on
// a copy of the other half's row and writes nothing. kQRegs: q holds the
// row in registers (kD <= 64), else it points at the row in shared memory.
// kMasked: the row's mask entry for key j is added to its score after the
// window mask with __fadd_rn, as attend_row adds it.
template <int kD, bool kQRegs, bool kMasked = false>
__device__ __forceinline__ void attend_pair(const float* q, const float* sK,
                                            const float* sV, int kbase,
                                            bool qlive, int qmax, float scale,
                                            float* m, float* l, float* acc,
                                            int lane, bool owner,
                                            const float* mrow = nullptr) {
  constexpr int kPS = 16;
  constexpr int kKStride = kD + 4;
  constexpr int U = kD >= 64 ? kD / 64 : 1;  // 64-column groups
  const int j = lane & 15;
  const int half0 = lane & 16;  // the half's first lane
  const float* kr = sK + j * kKStride;
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
    const float4 q4 = kQRegs ? make_float4(q[d], q[d + 1], q[d + 2], q[d + 3])
                             : *reinterpret_cast<const float4*>(q + d);
    dot = fmaf(q4.x, k4.x, dot);
    dot = fmaf(q4.y, k4.y, dot);
    dot = fmaf(q4.z, k4.z, dot);
    dot = fmaf(q4.w, k4.w, dot);
  }
  const bool live = qlive && (kbase + j <= qmax);
  float s = live ? dot * scale : kNegInf;
  // __fadd_rn: never contracted into an FMA with the product above
  if (kMasked) s = __fadd_rn(s, __ldg(mrow + kbase + j));
  float mcur = -CUDART_INF_F;
  mcur = fmaxf(mcur, s);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    mcur = fmaxf(mcur, __shfl_xor_sync(kFullMask, mcur, o));
  const float mprev = *m;
  const float mnew = fmaxf(mprev, mcur);
  const float alpha = expf(mprev - mnew);
  const float pj = expf(s - mnew);
  float psum = 0.f;
  psum += pj;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(kFullMask, psum, o);
  const int c0 = 4 * j;
  const bool cols = kD >= 64 || c0 < kD;  // head dim 32: lanes j < 8
  float a[4 * U];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      a[4 * u + k] = cols ? acc[64 * u + c0 + k] * alpha : 0.f;
#pragma unroll
  for (int jj = 0; jj < kPS; ++jj) {
    const float pv = __shfl_sync(kFullMask, pj, half0 + jj);
    const float* vr = sV + jj * kD + c0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (cols) {
        const float4 v4 = *reinterpret_cast<const float4*>(vr + 64 * u);
        a[4 * u] = fmaf(pv, v4.x, a[4 * u]);
        a[4 * u + 1] = fmaf(pv, v4.y, a[4 * u + 1]);
        a[4 * u + 2] = fmaf(pv, v4.z, a[4 * u + 2]);
        a[4 * u + 3] = fmaf(pv, v4.w, a[4 * u + 3]);
      }
    }
  }
  if (owner && cols) {
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[64 * u + c0 + k] = a[4 * u + k];
  }
  __syncwarp();  // every lane has read *m and *l
  if (owner && j == 0) {
    *m = mnew;
    *l = fmaf(alpha, *l, psum);
  }
}

// ---- the ring of asynchronous page copies ---------------------------------
__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte layout of a walk block's dynamic shared memory: `stages` raw
// stages, each one piece of a page of one kv head as the pool holds it —
// K's copy chunks, then V's, row by row — plus, in the q8 lane, one f32
// scale slot per chunk; `nbuf` f32 working tiles (K [rows][kstride],
// padded to 16 bytes, then V [rows][D]); the rows' queries and acc
// [nrows][D], m and l [nrows]. kstride is D + 1 for `attend_row`, D + 4
// for `attend_pair`. rows: the keys of a piece (`piece_rows`); width: the
// bytes of one copy (`copy_bytes`).
struct RingLayout {
  int stages, nbuf, rows, width;
  size_t stage;     // bytes of one stage
  size_t kfloats;   // floats of a tile's K part
  size_t tile;      // floats of one working tile
  size_t tiles, q, acc, m, l, total;  // byte offsets; bytes in all
};

__host__ __device__ inline RingLayout ring_layout(int elem, bool scaled,
                                                 int D, int rows, int width,
                                                 int kstride, int nrows,
                                                 int stages, int nbuf) {
  RingLayout L;
  L.stages = stages;
  L.nbuf = nbuf;
  L.rows = rows;
  L.width = width;
  const size_t nch = (size_t)rows * (D * elem / width);  // chunks of K
  L.stage = round16(2 * nch * width + (scaled ? 2 * nch * sizeof(float) : 0));
  L.kfloats = ((size_t)rows * kstride + 3) & ~static_cast<size_t>(3);
  L.tile = L.kfloats + (size_t)rows * D;
  L.tiles = (size_t)stages * L.stage;
  L.q = L.tiles + (size_t)nbuf * L.tile * sizeof(float);
  L.acc = L.q + (size_t)nrows * D * sizeof(float);
  L.m = L.acc + (size_t)nrows * D * sizeof(float);
  L.l = L.m + (size_t)nrows * sizeof(float);
  L.total = L.l + (size_t)nrows * sizeof(float);
  return L;
}

// A launch's feeder and shared memory: the ring (kRingStages stages, two
// f32 tiles) where a pool row takes cp.async copies and the ring fits
// kDynSmemMax beside the rows' state, else one tile that each piece is
// loaded into straight from the pools (stages 0); where even that does
// not fit, total exceeds kDynSmemMax. The kernel, its launcher and the
// plan entries all call this, so the launch and the report agree.
__host__ __device__ inline RingLayout walk_layout(int elem, bool scaled,
                                                 int D, int ps, int nrows,
                                                 bool paired) {
  const int kstride = paired ? D + 4 : D + 1;
  const int rows = piece_rows(D, ps);
  const int width = copy_bytes(D, elem);
  if (width >= 4) {
    const RingLayout L = ring_layout(elem, scaled, D, rows, width, kstride,
                                     nrows, kRingStages, 2);
    if (L.total <= kDynSmemMax) return L;
  }
  return ring_layout(elem, scaled, D, rows, width, kstride, nrows, 0, 1);
}

// The fewest blocks an item's nrows query rows can be split over, each
// block a contiguous run of at most ceil(nrows / split) of them, so that
// a block's `walk_layout` fits kDynSmemMax: 1 wherever the whole item
// fits (every launch that fitted before keeps its grid and its bits); 0
// where not even one row fits. A row's fold does not depend on the
// split, only which block owns it. With the smallest split no block is
// left without rows.
__host__ __device__ inline int walk_split(int elem, bool scaled, int D,
                                          int ps, int nrows, bool paired) {
  for (int s = 1; s <= nrows; ++s)
    if (walk_layout(elem, scaled, D, ps, (nrows + s - 1) / s, paired)
            .total <= kDynSmemMax)
      return s;
  return 0;
}

// the most query rows one block of the launch holds
__host__ __device__ inline int block_rows(const Args& a) {
  return (a.qblk * (a.H / a.Hkv) + a.split - 1) / a.split;
}

template <typename T>
__host__ __device__ inline RingLayout walk_layout(const Args& a, int D,
                                                 int ps, bool paired) {
  return walk_layout(pool_elem<T>(a.pool), a.pool == kPoolI8, D, ps,
                     block_rows(a), paired);
}

// One copy of W bytes, shared <- global: cp.async takes 16 (bypassing L1),
// 8 and 4.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(W)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the register type of one W-byte chunk
template <int W>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<4> {
  using type = unsigned;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};
template <>
struct RawOf<1> {
  using type = unsigned char;
};

// One pool lane's piece geometry: pool elements P, E of them in a W-byte
// chunk, nvec chunks a pool row, nch chunks a piece of K (and of V). Chunk
// c < nch is K's, c >= nch V's: the v-th chunk of the piece's row j
// (`at`). With a compile-time D the divisions are shifts.
template <typename P, int W>
struct RingChunks {
  static constexpr int E = W / static_cast<int>(sizeof(P));
  int nvec, nch;
  __device__ __forceinline__ RingChunks(int D, int rows)
      : nvec(D / E), nch(rows * (D / E)) {}
  __device__ __forceinline__ void at(int c, bool* isv, int* j,
                                     int* v) const {
    *isv = c >= nch;
    const int cc = *isv ? c - nch : c;
    *j = cc / nvec;
    *v = cc - *j * nvec;
  }
};

// Start copying keys row0 .. row0 + rows - 1 of page `page` of kv head g
// into `stage`: chunk c to bytes [Wc, Wc + W) and, in the q8 lane
// (kScaled), its row's scale to slot c, the slots after the chunks of a
// whole piece of `prows` keys (so a shorter last piece moves no slot onto
// another thread's chunks). Producer thread pt of nprod owns chunks pt,
// pt + nprod, ... here and in `ring_convert_lane`, so a thread only ever
// reads and overwrites copies it waited for itself.
template <typename P, bool kScaled, int W>
__device__ __forceinline__ void ring_issue_lane(const Args& a, int D, int ps,
                                                int page, int row0, int rows,
                                                int prows, int g,
                                                unsigned char* stage, int pt,
                                                int nprod) {
  const RingChunks<P, W> ch(D, rows);
  const P* __restrict__ kpool = static_cast<const P*>(a.k);
  const P* __restrict__ vpool = static_cast<const P*>(a.v);
  float* slots = reinterpret_cast<float*>(
      stage + 2 * (size_t)prows * ch.nvec * W);
  for (int c = pt; c < 2 * ch.nch; c += nprod) {
    bool isv;
    int j, v;
    ch.at(c, &isv, &j, &v);
    const size_t row = ((size_t)page * ps + row0 + j) * a.Hkv + g;
    cp_async<W>(stage + (size_t)c * W,
                (isv ? vpool : kpool) + row * D + v * ch.E);
    if (kScaled) cp_async<4>(slots + c, (isv ? a.v_scale : a.k_scale) + row);
  }
}

// Convert this thread's chunks of the piece (keys row0 .. row0 + rows - 1
// of page `page`, kv head g) into the f32 working tile: each element to
// f32 (exact from bf16, f16 and e4m3), times its row's scale in the q8
// lane (one f32 multiply, as the plain version dequantizes). The chunks
// come from a landed `stage`, or, with stage null, straight from the
// pools. K rows go to the padded [rows][kstride] part (16-byte stores
// when kstride is a multiple of 4: kVecK), V rows to [rows][D] (16-byte
// stores where a chunk is four floats and D a multiple of 4).
template <typename P, bool kScaled, bool kVecK, int W>
__device__ __forceinline__ void ring_convert_lane(
    const Args& a, const unsigned char* stage, int page, int row0, int rows,
    int prows, int g, int D, int ps, int kstride, float* sK, float* sV,
    int pt, int nprod) {
  using Raw = typename RawOf<W>::type;
  const RingChunks<P, W> ch(D, rows);
  constexpr int E = RingChunks<P, W>::E;
  const P* __restrict__ kpool = static_cast<const P*>(a.k);
  const P* __restrict__ vpool = static_cast<const P*>(a.v);
  // the scale slots' offset: after a whole piece's chunks
  const size_t slots = 2 * (size_t)prows * ch.nvec * W;
  const bool vec_v = E % 4 == 0 && D % 4 == 0;
  for (int c = pt; c < 2 * ch.nch; c += nprod) {
    bool isv;
    int j, v;
    ch.at(c, &isv, &j, &v);
    Raw raw;
    float s = 1.f;
    if (stage != nullptr) {
      raw = *reinterpret_cast<const Raw*>(stage + (size_t)c * W);
      if (kScaled) s = reinterpret_cast<const float*>(stage + slots)[c];
    } else {
      const size_t row = ((size_t)page * ps + row0 + j) * a.Hkv + g;
      raw = __ldg(reinterpret_cast<const Raw*>((isv ? vpool : kpool) +
                                               row * D + v * E));
      if (kScaled) s = __ldg((isv ? a.v_scale : a.k_scale) + row);
    }
    const P* e = reinterpret_cast<const P*>(&raw);
    float f[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      f[i] = to_f32<P>(e[i]);
      if (kScaled) f[i] *= s;
    }
    float* dst = isv ? sV + j * D + v * E : sK + j * kstride + v * E;
    if (E % 4 == 0 && (isv ? vec_v : kVecK)) {
#pragma unroll
      for (int i = 0; i < E / 4; ++i)
        reinterpret_cast<float4*>(dst)[i] = make_float4(
            f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) dst[i] = f[i];
    }
  }
}

// Call f(std::integral_constant<int, W>{}) for the copy width W (bytes)
// of pool elements P: 16, 8 or 4, or one element below 4. kW: a
// compile-time width (the compile-time head dims: always 16), or 0 to
// switch on W.
template <int W>
using Width = std::integral_constant<int, W>;

template <typename P, int kW, typename F>
__device__ __forceinline__ void with_width(int W, F&& f) {
  if constexpr (kW > 0) {
    f(Width<kW>{});
  } else {
    switch (W) {
      case 16:
        f(Width<16>{});
        break;
      case 8:
        f(Width<8>{});
        break;
      case 4:
        f(Width<4>{});
        break;
      default:
        if constexpr (sizeof(P) < 4) f(Width<static_cast<int>(sizeof(P))>{});
    }
  }
}

// The copy and the conversion of the launch's pool type: q's own T, int8
// with scales, or e4m3. The pool code and the width are the same for every
// block of a launch, so the switches cost uniform branches; making them
// template parameters instead would multiply the instantiations and their
// build time.
template <typename T, int kW>
__device__ __forceinline__ void ring_issue(const Args& a, int W, int D,
                                           int ps, int page, int row0,
                                           int rows, int prows, int g,
                                           unsigned char* stage, int pt,
                                           int nprod) {
  auto lane = [&](auto tag, auto scaled) {
    using P = decltype(tag);
    with_width<P, kW>(W, [&](auto width) {
      constexpr int kWidth = decltype(width)::value;
      if constexpr (kWidth >= 4)  // narrower rows never take the ring
        ring_issue_lane<P, std::decay_t<decltype(scaled)>::value, kWidth>(
            a, D, ps, page, row0, rows, prows, g, stage, pt, nprod);
    });
  };
  switch (a.pool) {
    case kPoolI8:
      lane(int8_t{}, std::true_type{});
      break;
    case kPoolE4M3:
      lane(__nv_fp8_e4m3{}, std::false_type{});
      break;
    default:
      lane(T{}, std::false_type{});
  }
}

template <typename T, bool kVecK, int kW>
__device__ __forceinline__ void ring_convert(const Args& a, int W,
                                             const unsigned char* stage,
                                             int page, int row0, int rows,
                                             int prows, int g, int D, int ps,
                                             int kstride, float* sK,
                                             float* sV, int pt, int nprod) {
  auto lane = [&](auto tag, auto scaled) {
    using P = decltype(tag);
    with_width<P, kW>(W, [&](auto width) {
      ring_convert_lane<P, std::decay_t<decltype(scaled)>::value, kVecK,
                        decltype(width)::value>(a, stage, page, row0, rows,
                                                prows, g, D, ps, kstride, sK,
                                                sV, pt, nprod);
    });
  };
  switch (a.pool) {
    case kPoolI8:
      lane(int8_t{}, std::true_type{});
      break;
    case kPoolE4M3:
      lane(__nv_fp8_e4m3{}, std::false_type{});
      break;
    default:
      lane(T{}, std::false_type{});
  }
}

// The work items of a launch are its (query block t, row b) pairs, item
// i = b * nqb + t, each walked once per kv head. `group_count`: the shared
// page count of row b's group (0 for a singleton, a group id outside
// [0, B), or a launch without groups).
__device__ __forceinline__ int group_count(const Args& a, int b) {
  if (a.group_id == nullptr) return 0;
  const int gid = a.group_id[b];
  return (gid >= 0 && gid < a.B) ? a.group_cnt[gid] : 0;
}

__device__ __forceinline__ int row_qlen(const Args& a, int b) {
  return a.q_len != nullptr ? a.q_len[b] : 1;
}

// An item's place in the schedule: 0 for an item with nothing to fold (a
// dead query block; in phase 1 also a row outside every sharing group),
// else 1 plus its walk's page count in this phase, so that longer walks
// start first.
template <bool kPhase1>
__device__ __forceinline__ int item_key(const Args& a, int i, int ps) {
  const int b = i / a.nqb, t = i - b * a.nqb;
  const int q0 = t * a.qblk;
  const int qlen_b = row_qlen(a, b);
  if (q0 >= qlen_b) return 0;
  const int n_pages = block_pages(a.pos[b], qlen_b, q0, a.qblk, ps, a.mp);
  const int cnt = group_count(a, b);
  const int span = cnt > 0 ? min(cnt, n_pages) : 0;
  if (kPhase1) return span > 0 ? span + 1 : 0;
  return n_pages - span + 1;
}

// The walk: K10a (kPhase1), and K10b, K6, K7 and K9 (phase 2). kD, kPS:
// the head dim and page size as compile-time constants, or 0 for the
// run-time a.D, a.ps. kMasked (phase 2): the user mask.
// One-dimensional grid of nqb * B * Hkv * split blocks: block x walks the
// (kv head, split) pair x % (Hkv * split) — kv head pair % Hkv, the
// pair / Hkv-th run of the item's rows — of the item ranked
// x / (Hkv * split) in the schedule. Below, "its rows" are the block's
// own run.
//   Phase 1: an item whose row is a member of a sharing group and whose
// query block is live walks the shared span, pages [0, min(cnt, last + 1))
// read through the leader's table, from (-1e30, 0, 0), and writes its
// rows' partials (m, l, acc); no other item folds anything.
//   Phase 2: every live item walks its row's pages [p0, last + 1), where
// p0 = min(cnt, last + 1) for a member (starting from its phase-1
// partials) and 0 for any other row (every row of K6, K7 and K9), and
// writes the output; a dead query block writes zeros. Under a mask query
// qi of head h adds the mask row [b, h, qi, :] to its scores, read
// straight from device memory by each lane for its key; a padding query
// past lq (dead) reads row lq - 1, so no read leaves the mask.
template <typename T, int DV, int PJ, int kD, int kPS, bool kPhase1,
          bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
    ring_walk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char sbuf[];
  __shared__ int sKey[kSortMax];
  __shared__ int sItem;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const int D = kD > 0 ? kD : a.D;
  const int ps = kPS > 0 ? kPS : a.ps;
  const int H = a.H, lq = a.lq;
  const int rep = H / a.Hkv;
  const int item_rows = a.qblk * rep;
  const int brows = block_rows(a);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pair = blockIdx.x % (a.Hkv * a.split);
  const int g = pair % a.Hkv;
  // this block's rows are the item's r0 .. r0 + nrows - 1: local row r is
  // the item's row r0 + r
  const int r0 = (pair / a.Hkv) * brows;
  const int nrows = min(brows, item_rows - r0);
  const int rank = blockIdx.x / (a.Hkv * a.split);

  // The schedule, built alike by every block: items by descending key,
  // ties by index (every rank is some item's). A launch with more than
  // kSortMax items walks them in index order.
  const int n_items = a.nqb * a.B;
  int item = rank;
  if (n_items <= kSortMax) {
    for (int i = tid; i < n_items; i += kThreads)
      sKey[i] = item_key<kPhase1>(a, i, ps);
    __syncthreads();
    for (int i = tid; i < n_items; i += kThreads) {
      const int ki = sKey[i];
      int r = 0;
      for (int j = 0; j < n_items; ++j) {
        const int kj = sKey[j];
        r += (kj > ki) || (kj == ki && j < i);
      }
      if (r == rank) sItem = i;
    }
    __syncthreads();
    item = sItem;
  }
  const int b = item / a.nqb;
  const int t = item - b * a.nqb;
  const int pos_b = a.pos[b];
  const int qlen_b = row_qlen(a, b);
  const int q0 = t * a.qblk;

  if (q0 >= qlen_b) {  // dead query block: no pages; phase 2 writes zeros
    if (!kPhase1) {
      T* __restrict__ out = static_cast<T*>(a.out);
      for (int idx = tid; idx < nrows * D; idx += kThreads) {
        const int r = r0 + idx / D, d = idx % D;
        const int qi = q0 + r / rep;
        if (qi < lq) {
          const int h = g * rep + r % rep;
          out[(((size_t)b * lq + qi) * H + h) * D + d] = from_f32<T>(0.f);
        }
      }
    }
    return;
  }
  const int n_pages = block_pages(pos_b, qlen_b, q0, a.qblk, ps, a.mp);
  const int cnt = group_count(a, b);
  const int span = cnt > 0 ? min(cnt, n_pages) : 0;
  if (kPhase1 && span == 0) return;  // not a member: nothing to fold
  const int p0 = kPhase1 ? 0 : span;
  const int trow =
      kPhase1 ? min(max(a.group_leader[a.group_id[b]], 0), a.B - 1) : b;
  const bool resume = !kPhase1 && span > 0;
  // The walk's units are the pieces of its pages, page by page: unit u is
  // piece u % npc of the walk's page u / npc (one piece a page at the
  // compile-time page size)
  const int pc = kPS > 0 ? kPS : piece_rows(D, ps);
  const int npc = kPS > 0 ? 1 : (ps + pc - 1) / pc;
  const int n = ((kPhase1 ? span : n_pages) - p0) * npc;
  // the page id of the walk's i-th page, from the walked row's table
  const int* __restrict__ table = a.page_table + (size_t)trow * a.mp + p0;
  auto page_id = [&](int i) {
    return min(max(table[i], 0), a.num_pages - 1);
  };

  // the compile-time page size 16 folds two rows a warp (`attend_pair`)
  constexpr bool kPair = kPS == 16;
  const int kstride = kPair ? D + 4 : D + 1;
  const RingLayout L = walk_layout<T>(a, D, ps, kPair);
  const bool ring = L.stages > 0;
  // the copy width: 16 bytes at every compile-time head dim
  constexpr int kW = kD > 0 ? 16 : 0;
  const int W = kW > 0 ? kW : L.width;
  float* tiles = reinterpret_cast<float*>(sbuf + L.tiles);
  float* sQ = reinterpret_cast<float*>(sbuf + L.q);      // [nrows][D]
  float* sAcc = reinterpret_cast<float*>(sbuf + L.acc);  // [nrows][D]
  float* sM = reinterpret_cast<float*>(sbuf + L.m);      // [nrows]
  float* sL = reinterpret_cast<float*>(sbuf + L.l);      // [nrows]
  // this block's rows in the partials
  const size_t part = ((size_t)g * a.nqb + t) * ((size_t)a.B * item_rows) +
                      (size_t)b * item_rows + r0;

  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = r0 + idx / D, d = idx % D;
    const int qi = q0 + r / rep;
    const int h = g * rep + r % rep;
    sQ[idx] = qi < lq ? to_f32<T>(q[(((size_t)b * lq + qi) * H + h) * D + d])
                      : 0.f;
    sAcc[idx] = resume ? a.pacc[part * D + idx] : 0.f;
  }
  for (int r = tid; r < nrows; r += kThreads) {
    sM[r] = resume ? a.pm[part + r] : kNegInf;
    sL[r] = resume ? a.pl[part + r] : 0.f;
  }

  // With a compile-time head dim up to 64 a half-warp's query row sits in
  // registers: read once for the walk when the warp has one pair of rows,
  // else before each fold.
  constexpr bool kQRegs = PTT_WALK_Q_REGS && kPair && kD <= 64;
  float qreg[kQRegs ? kD : 1];
  const bool one_pair = nrows <= 2 * kWarps;
  // Roles: the first `folders` warps fold (one warp per row pair, or per
  // row); on the ring, when that leaves warps over, those are the
  // producers that copy and convert the pieces, so converting unit i + 1
  // overlaps folding unit i; else every warp does both, folding first.
  const int units = kPair ? (nrows + 1) / 2 : nrows;
  const int folders = min(units, kWarps);
  const int first_prod = ring && folders < kWarps ? folders : 0;
  const bool producer = warp >= first_prod;
  const int pt = tid - first_prod * 32, nprod = kThreads - first_prod * 32;
  // unit u's page id, first key within its page and key count
  auto unit_page = [&](int u) { return page_id(npc == 1 ? u : u / npc); };
  auto unit_row0 = [&](int u) { return npc == 1 ? 0 : (u % npc) * pc; };
  auto unit_rows = [&](int u) {
    return npc == 1 ? ps : min(pc, ps - unit_row0(u));
  };
  // the ring's first kRingStages units, one commit group each; `next`:
  // the page id of the unit the ring takes next, read a unit ahead
  int next = 0;
  if (ring && producer) {
#pragma unroll
    for (int i = 0; i < kRingStages; ++i) {
      if (i < n)
        ring_issue<T, kW>(a, W, D, ps, unit_page(i), unit_row0(i),
                          unit_rows(i), pc, g, sbuf + (size_t)i * L.stage,
                          pt, nprod);
      cp_async_commit();
    }
    if (kRingStages < n) next = unit_page(kRingStages);
  }
  // Fill unit u's tile: on the ring, convert its stage (u % kRingStages;
  // this thread waited for its own chunks only), then refill the stage
  // with unit u + kRingStages; else load it from the pools.
  auto produce = [&](int u) {
    float* sK = tiles + (size_t)(u & (L.nbuf - 1)) * L.tile;
    if (!ring) {
      ring_convert<T, kPair, kW>(a, W, nullptr, unit_page(u), unit_row0(u),
                                 unit_rows(u), pc, g, D, ps, kstride, sK,
                                 sK + L.kfloats, pt, nprod);
      return;
    }
    unsigned char* stage = sbuf + (size_t)(u % kRingStages) * L.stage;
    cp_async_wait<kRingStages - 1>();
    ring_convert<T, kPair, kW>(a, W, stage, 0, 0, unit_rows(u), pc, g, D,
                               ps, kstride, sK, sK + L.kfloats, pt, nprod);
    const int un = u + kRingStages;
    if (un < n)
      ring_issue<T, kW>(a, W, D, ps, next, unit_row0(un), unit_rows(un), pc,
                        g, stage, pt, nprod);
    cp_async_commit();
    if (un + 1 < n) next = unit_page(un + 1);
  };
  if (producer && n > 0) produce(0);
  __syncthreads();  // unit 0's tile, the queries and the partials visible
  const size_t lmax = (size_t)a.mp * ps;
  for (int i = 0; i < n; ++i) {
    const float* sK = tiles + (size_t)(i & (L.nbuf - 1)) * L.tile;
    const float* sV = sK + L.kfloats;
    const int pi = npc == 1 ? i : i / npc;
    const int kbase = (p0 + pi) * ps + unit_row0(i);
    if (warp < folders) {
      if constexpr (kPair) {
        // warp w folds row pairs (2p, 2p + 1) for p = w, w + 8, ...
        for (int p = warp; 2 * p < nrows; p += kWarps) {
          const int r = 2 * p + (lane >> 4);
          const bool owner = r < nrows;
          const int rr = owner ? r : 2 * p;
          const int qi = q0 + (r0 + rr) / rep;
          const float* qrow = sQ + (size_t)rr * kD;
          if constexpr (kQRegs) {
            if (i == 0 || !one_pair) {
#pragma unroll
              for (int k = 0; k < kD / 4; ++k) {
                const float4 x = reinterpret_cast<const float4*>(qrow)[k];
                qreg[4 * k] = x.x;
                qreg[4 * k + 1] = x.y;
                qreg[4 * k + 2] = x.z;
                qreg[4 * k + 3] = x.w;
              }
            }
            qrow = qreg;
          }
          const float* mrow = nullptr;
          if (kMasked) {
            const int h = g * rep + (r0 + rr) % rep;
            mrow = a.mask + (((size_t)b * H + h) * lq + min(qi, lq - 1)) *
                                lmax;
          }
          attend_pair<kD, kQRegs, kMasked>(
              qrow, sK, sV, kbase, qi < qlen_b, pos_b + qi, a.scale, sM + rr,
              sL + rr, sAcc + (size_t)rr * kD, lane, owner, mrow);
        }
      } else {
        const int rows = unit_rows(i);
        for (int r = warp; r < nrows; r += kWarps) {
          const int qi = q0 + (r0 + r) / rep;
          const float* mrow = nullptr;
          if (kMasked) {
            const int h = g * rep + (r0 + r) % rep;
            mrow = a.mask + (((size_t)b * H + h) * lq + min(qi, lq - 1)) *
                                lmax;
          }
          attend_row<DV, PJ, kMasked>(sQ + (size_t)r * D, sK, sV, D, rows,
                                      kbase, qi < qlen_b, pos_b + qi,
                                      a.scale, sM + r, sL + r,
                                      sAcc + (size_t)r * D, lane, mrow);
        }
      }
    }
    if (i + 1 < n) {
      // two tiles: unit i + 1 goes to the other one while unit i is
      // folded; one tile: after every fold of unit i
      if (L.nbuf == 1) __syncthreads();
      if (producer) produce(i + 1);
    }
    __syncthreads();  // unit i + 1's tile is whole, unit i's folds done
  }
  if (kPhase1) {
    for (int idx = tid; idx < nrows * D; idx += kThreads)
      a.pacc[part * D + idx] = sAcc[idx];
    for (int r = tid; r < nrows; r += kThreads) {
      a.pm[part + r] = sM[r];
      a.pl[part + r] = sL[r];
    }
    return;
  }
  T* __restrict__ out = static_cast<T*>(a.out);
  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + (r0 + r) / rep;
    if (qi < lq) {
      const int h = g * rep + (r0 + r) % rep;
      const float l = fmaxf(sL[r], 1e-30f);
      out[(((size_t)b * lq + qi) * H + h) * D + d] =
          from_f32<T>(sAcc[idx] / l);
    }
  }
}

template <bool kPhase1, bool kMasked, int kD, int kPS>
struct RingWalk {
  template <typename T, int DV, int PJ>
  static int run(const Args& args, cudaStream_t stream) {
    Args a = args;
    a.split = walk_split(pool_elem<T>(a.pool), a.pool == kPoolI8, a.D, a.ps,
                         a.qblk * (a.H / a.Hkv), kPS == 16);
    if (a.split == 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = walk_layout<T>(a, a.D, a.ps, kPS == 16).total;
    auto kernel = ring_walk_kernel<T, DV, PJ, kD, kPS, kPhase1, kMasked>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<a.nqb * a.B * a.Hkv * a.split, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

// Instantiate launcher L for q's dtype code and the (DV, PJ) that D and
// the piece length need; the pool code rides in Args.
template <class L, typename T, int DV>
int dispatch_pj(const Args& a, cudaStream_t s) {
  const int pc = piece_rows(a.D, a.ps);
  if (pc <= 32) return L::template run<T, DV, 1>(a, s);
  if (pc <= 64) return L::template run<T, DV, 2>(a, s);
  return L::template run<T, DV, 4>(a, s);
}

template <class L, typename T>
int dispatch_dv(const Args& a, cudaStream_t s) {
  if (a.D <= 32) return dispatch_pj<L, T, 1>(a, s);
  if (a.D <= 64) return dispatch_pj<L, T, 2>(a, s);
  if (a.D <= 128) return dispatch_pj<L, T, 4>(a, s);
  return dispatch_pj<L, T, 8>(a, s);  // over 256: columns in pieces
}

// Page size 16 at head dims 32-256: the compile-time instantiations, two
// rows a warp; any other shape: run-time D and ps, a row a warp. One
// dtype of q's: 16 of the walk's kernels.
template <bool kPhase1, bool kMasked, typename T>
int ring_dispatch_t(const Args& a, cudaStream_t s) {
  if (ring_paired(a.D, a.ps)) {
    switch (a.D) {
      case 32:
        return RingWalk<kPhase1, kMasked, 32, 16>::template run<T, 1, 1>(a,
                                                                       s);
      case 64:
        return RingWalk<kPhase1, kMasked, 64, 16>::template run<T, 2, 1>(a,
                                                                       s);
      case 128:
        return RingWalk<kPhase1, kMasked, 128, 16>::template run<T, 4, 1>(a,
                                                                        s);
      case 256:
        return RingWalk<kPhase1, kMasked, 256, 16>::template run<T, 8, 1>(a,
                                                                        s);
      default:
        break;
    }
  }
  return dispatch_dv<RingWalk<kPhase1, kMasked, 0, 0>, T>(a, s);
}

template <bool kPhase1, bool kMasked>
int ring_dispatch(int dtype, const Args& a, cudaStream_t s) {
  if (!pools_valid(a) || a.D < 1 || a.ps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32:
      return ring_dispatch_t<kPhase1, kMasked, float>(a, s);
    case kBF16:
      return ring_dispatch_t<kPhase1, kMasked, __nv_bfloat16>(a, s);
    case kF16:
      return ring_dispatch_t<kPhase1, kMasked, __half>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `_build.build()` compiles each walk library's own file with
// PTT_WALK_EXTERN and the dispatch instantiations it calls, one for each
// dtype of q's (16 kernels each, most of a walk library's ptxas time),
// apart, one nvcc each, from walk_instance.cu with the library's
// PTT_WALK_* settings, then links them: libraries of the same settings
// share them, and they build in parallel. Compiled alone, without the
// macro, a file instantiates what it calls, as before.
#ifdef PTT_WALK_EXTERN
#define PTT_WALK_EXTERN_T(P, M)                                             \
  extern template int ring_dispatch_t<P, M, float>(const Args&,             \
                                                   cudaStream_t);           \
  extern template int ring_dispatch_t<P, M, __nv_bfloat16>(const Args&,     \
                                                           cudaStream_t);   \
  extern template int ring_dispatch_t<P, M, __half>(const Args&,            \
                                                    cudaStream_t);
PTT_WALK_EXTERN_T(false, false)
PTT_WALK_EXTERN_T(false, true)
PTT_WALK_EXTERN_T(true, false)
#undef PTT_WALK_EXTERN_T
#endif

// Entries of a walk's launch report (`walk_plan`).
constexpr int kPlanLen = 10;

// The launch a walk makes for these shapes, written to out[kPlanLen]: raw
// stages (kRingStages on the ring; 0: each piece loaded straight into one
// tile), f32 tiles, dynamic shared memory bytes, 1 if two rows share a
// warp (`attend_pair`), the grid's blocks, threads a block, query rows a
// block (at most), the keys of a piece (`piece_rows`), the bytes of one
// copy (`copy_bytes`) and the blocks an item's rows are split over
// (`walk_split`); a launch with a user mask takes the same plan. Returns
// cudaErrorInvalidValue, as the launch would, for a dtype or pool code the
// kernels do not take, or where not even one query row fits shared
// memory; then out[2] holds the bytes one row's block would need (0 for
// a bad code) and the rest is 0.
inline int walk_plan(int B, int lq, int H, int Hkv, int D, int ps, int dtype,
                     int pool, int* out) {
  for (int i = 0; i < kPlanLen; ++i) out[i] = 0;
  if (B < 1 || lq < 1 || Hkv < 1 || H < Hkv || H % Hkv || D < 1 ||
      ps < 1 || dtype < kF32 || dtype > kF16 || pool < kPoolQ ||
      pool > kPoolE4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem =
      pool != kPoolQ ? 1 : dtype == kF32 ? 4 : 2;  // bytes a pool element
  const bool scaled = pool == kPoolI8;
  const int qblk = lq < kQBlk ? lq : kQBlk;
  const int nrows = qblk * (H / Hkv);
  const bool paired = ring_paired(D, ps);
  const int split = walk_split(elem, scaled, D, ps, nrows, paired);
  if (split == 0) {
    out[2] = static_cast<int>(
        walk_layout(elem, scaled, D, ps, 1, paired).total);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = (nrows + split - 1) / split;
  const RingLayout L = walk_layout(elem, scaled, D, ps, rows, paired);
  const int vals[kPlanLen] = {L.stages,
                              L.nbuf,
                              static_cast<int>(L.total),
                              paired ? 1 : 0,
                              (lq + qblk - 1) / qblk * B * Hkv * split,
                              kThreads,
                              rows,
                              L.rows,
                              L.width,
                              split};
  for (int i = 0; i < kPlanLen; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace walk
}  // namespace ptt
