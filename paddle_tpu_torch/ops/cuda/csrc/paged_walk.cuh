// The paged K/V walk shared by K6 and K7 (ragged_paged_attention.cu), K10
// (grouped_paged_attention.cu) and K9 (paged_decode_attention.cu), in all
// their pool lanes.
//
// One online-softmax arithmetic serves all of them: `attend_row` folds one
// staged page into one query row's (m, l, acc), and every kernel walks a
// row's pages in the same order, 0 .. last. K10 splits that order at the
// group's shared span (phase 1 takes pages 0 .. cnt-1, phase 2 continues
// at cnt), and the partials cross between the phases as exact f32 values
// in device memory, so K10's output equals K6's bit for bit on the same
// operands.
//
// Two feeders stage the pages for the fold. K6, K7 and K9 walk with
// `row_walk_kernel` (and K9's decode walk): load a page with 16-byte
// vector loads, convert it into the f32 tile, fold it, one page at a time
// (`load_pool_page`). K10's two phases walk with the ring below
// (`ring_issue`, `ring_convert`): cp.async copies of the next pages into
// raw stages, each thread converting the chunks it copied itself, so
// neither the copy nor the conversion waits on another thread; where the
// ring does not fit shared memory, `ring_convert` loads each page straight
// from the pools, as `load_pool_page` does. Either way the converted
// values are the loader's, bit for bit. K10 folds with `attend_row` too,
// or, at page size 16, with `attend_pair`, which folds two rows a warp and
// gives every value attend_row's operations in the same order (its note
// says why).
//
// The pools hold q's dtype (the fp lane), int8 codes with f32 rowwise
// scale pools (the q8 lane: K7 and K10's q8 lane) or float8 e4m3 values
// (the fp8 lane). Only the page loader differs: it writes the same f32
// shared tiles from each, so every lane walks with the one `attend_row`,
// and K10's q8 and fp8 lanes equal K7 and K6's fp8 lane bit for bit.
//
// Layout shared with the Python wrappers: q, out [B, lq, H, D]; pools
// [num_pages, ps, Hkv, D]; scale pools [num_pages, ps, Hkv]; page_table
// [B, mp]; pos, q_len, group_id,
// group_leader, group_cnt [B] int32. A block owns (query block t of
// qblk <= 8 queries, kv head g): its rows r = 0 .. qblk*rep-1 are query
// t*qblk + r/rep, head g*rep + r%rep. The phase-1 partials are f32
// m, l [Hkv, nqb, B*qblk*rep] and acc [Hkv, nqb, B*qblk*rep, D], row
// b*qblk*rep + r.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace ptt {
namespace walk {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;     // the masked score, as on the TPU
constexpr int kQBlk = 8;              // queries per block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;     // the q8 lane only
  const float* v_scale;
  const int* page_table;
  const int* pos;
  const int* q_len;
  const int* group_id;      // K10 only
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

inline size_t tile_floats(int D, int ps) {
  return (size_t)ps * (D + 1) + (size_t)ps * D;
}

// Pages row b's query block [q0, q0 + qblk) reads: through the last live
// query's position, at most mp.
__device__ __forceinline__ int block_pages(int pos_b, int qlen_b, int q0,
                                           int qblk, int ps, int mp) {
  const int last_qi = min(q0 + qblk, qlen_b) - 1;
  return min(mp, (pos_b + last_qi) / ps + 1);
}

// Stage page `page` of kv head g into shared memory as f32: K [ps][D + 1]
// (padded by one float, so a warp's per-key dot products hit distinct
// banks) and V [ps][D], from 16-byte vector loads of pool elements P
// (D a multiple of 16 / sizeof(P)). kScaled (the q8 lane): each element
// is code x the f32 scale of its (position, kv head), one multiply, as in
// the plain version's dequantization; the other conversions are exact.
template <typename P, bool kScaled>
__device__ __forceinline__ void load_page(const void* kpool_,
                                          const void* vpool_,
                                          const float* __restrict__ kscale,
                                          const float* __restrict__ vscale,
                                          int page, int g, int Hkv, int D,
                                          int ps, float* sK, float* sV) {
  const P* __restrict__ kpool = static_cast<const P*>(kpool_);
  const P* __restrict__ vpool = static_cast<const P*>(vpool_);
  constexpr int E = 16 / sizeof(P);  // elements per 16-byte vector
  const int nvec = D / E;
  const int kstride = D + 1;
  for (int idx = threadIdx.x; idx < ps * nvec; idx += kThreads) {
    const int j = idx / nvec, c = idx - j * nvec;
    const size_t row = ((size_t)page * ps + j) * Hkv + g;
    const size_t src = row * D + c * E;
    const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kpool + src));
    const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vpool + src));
    const P* ke = reinterpret_cast<const P*>(&kr);
    const P* ve = reinterpret_cast<const P*>(&vr);
    float ks = 1.f, vs = 1.f;
    if (kScaled) {
      ks = __ldg(kscale + row);
      vs = __ldg(vscale + row);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float kf = to_f32<P>(ke[e]);
      float vf = to_f32<P>(ve[e]);
      if (kScaled) {
        kf *= ks;
        vf *= vs;
      }
      sK[j * kstride + c * E + e] = kf;
      sV[j * D + c * E + e] = vf;
    }
  }
}

// The loader of the launch's pool type: q's own T, int8 with scales, or
// e4m3. The pool code is the same for every block of a launch, so the
// switch costs one uniform branch a page; making it a template parameter
// instead would triple the kernels' instantiations and their build time.
template <typename T>
__device__ __forceinline__ void load_pool_page(const Args& a, int page,
                                               int g, float* sK, float* sV) {
  switch (a.pool) {
    case kPoolI8:
      load_page<int8_t, true>(a.k, a.v, a.k_scale, a.v_scale, page, g,
                              a.Hkv, a.D, a.ps, sK, sV);
      break;
    case kPoolE4M3:
      load_page<__nv_fp8_e4m3, false>(a.k, a.v, nullptr, nullptr, page, g,
                                      a.Hkv, a.D, a.ps, sK, sV);
      break;
    default:
      load_page<T, false>(a.k, a.v, nullptr, nullptr, page, g, a.Hkv, a.D,
                          a.ps, sK, sV);
  }
}

// Fold one staged page (keys kbase .. kbase + ps - 1) into one query row's
// online softmax, by one warp: lane j scores key j (and j + 32, ...), the
// page's max and sum are warp reductions, and lane d accumulates output
// column d (and d + 32, ...) with the probabilities broadcast by shuffles.
// Key kp is live iff the query is (qlive) and kp <= qmax (= pos + i).
// DV: output columns per lane (D <= 32 * DV); PJ: keys per lane
// (ps <= 32 * PJ). kMasked (the user mask of K9, K6 and K7): the additive
// f32 mask row `mrow` (indexed by key position) is added to each key's
// score after the window mask, as the TPU kernel adds it; it is a
// template flag, so the unmasked instantiations K6, K7 and K10 use are
// the code they were.
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
  float a[DV];
#pragma unroll
  for (int u = 0; u < DV; ++u) {
    const int d = lane + 32 * u;
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
        const int d = lane + 32 * u;
        if (d < D) a[u] = fmaf(pv, vr[d], a[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < DV; ++u) {
    const int d = lane + 32 * u;
    if (d < D) acc[d] = a[u];
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
template <int kD, bool kQRegs>
__device__ __forceinline__ void attend_pair(const float* q, const float* sK,
                                            const float* sV, int kbase,
                                            bool qlive, int qmax, float scale,
                                            float* m, float* l, float* acc,
                                            int lane, bool owner) {
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
  const float s = live ? dot * scale : kNegInf;
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

// The per-row walk: K6 and K7. Grid (nqb, Hkv, B). A dead query block
// writes zeros and reads nothing.
// kMasked (K6/K7 only; under a mask the grouped op takes K6, as the JAX
// op falls back to its ungrouped kernel): query qi of head h adds the
// mask row [b, h, qi, :] to its scores, read straight from device memory
// by each lane for its key; a padding query past lq (dead) reads row
// lq - 1, so no read leaves the mask.
template <typename T, int DV, int PJ, bool kMasked = false>
__global__ void __launch_bounds__(kThreads) row_walk_kernel(const Args a) {
  extern __shared__ float smem[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int D = a.D, ps = a.ps, H = a.H, lq = a.lq;
  const int rep = H / a.Hkv;
  const int nrows = a.qblk * rep;
  float* sK = smem;                   // [ps][D + 1]
  float* sV = sK + ps * (D + 1);      // [ps][D]
  float* sQ = sV + ps * D;            // [nrows][D]
  float* sAcc = sQ + nrows * D;       // [nrows][D]
  float* sM = sAcc + nrows * D;       // [nrows]
  float* sL = sM + nrows;             // [nrows]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos_b = a.pos[b];
  const int qlen_b = a.q_len[b];
  const int q0 = t * a.qblk;

  if (q0 >= qlen_b) {  // dead query block: zeros, no page traffic
    for (int idx = tid; idx < nrows * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const int qi = q0 + r / rep;
      if (qi < lq) {
        const int h = g * rep + r % rep;
        out[(((size_t)b * lq + qi) * H + h) * D + d] = from_f32<T>(0.f);
      }
    }
    return;
  }
  const int n_pages = block_pages(pos_b, qlen_b, q0, a.qblk, ps, a.mp);
  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r / rep;
    const int h = g * rep + r % rep;
    sQ[idx] = qi < lq ? to_f32<T>(q[(((size_t)b * lq + qi) * H + h) * D + d])
                      : 0.f;
    sAcc[idx] = 0.f;
  }
  for (int r = tid; r < nrows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  for (int p = 0; p < n_pages; ++p) {
    int page = a.page_table[(size_t)b * a.mp + p];
    page = min(max(page, 0), a.num_pages - 1);
    __syncthreads();  // previous tile fully consumed (and init visible)
    load_pool_page<T>(a, page, g, sK, sV);
    __syncthreads();
    for (int r = warp; r < nrows; r += kWarps) {
      const int qi = q0 + r / rep;
      const float* mrow = nullptr;
      if (kMasked) {
        const int h = g * rep + r % rep;
        mrow = a.mask + (((size_t)b * H + h) * lq + min(qi, lq - 1)) *
                            ((size_t)a.mp * ps);
      }
      attend_row<DV, PJ, kMasked>(sQ + r * D, sK, sV, D, ps, p * ps,
                                  qi < qlen_b, pos_b + qi, a.scale, sM + r,
                                  sL + r, sAcc + r * D, lane, mrow);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r / rep;
    if (qi < lq) {
      const int h = g * rep + r % rep;
      const float l = fmaxf(sL[r], 1e-30f);
      out[(((size_t)b * lq + qi) * H + h) * D + d] =
          from_f32<T>(sAcc[idx] / l);
    }
  }
}

inline size_t row_walk_smem(const Args& a) {
  const size_t nrows = (size_t)a.qblk * (a.H / a.Hkv);
  return sizeof(float) *
         (tile_floats(a.D, a.ps) + 2 * nrows * a.D + 2 * nrows);
}

template <bool kMasked = false>
struct RowWalk {
  template <typename T, int DV, int PJ>
  static int run(const Args& a, cudaStream_t stream) {
    const size_t smem = row_walk_smem(a);
    auto kernel = row_walk_kernel<T, DV, PJ, kMasked>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(a.nqb, a.Hkv, a.B), kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

// ---- K10's ring of asynchronous page copies -------------------------------
// raw page stages in flight ahead of the conversion
constexpr int kRingStages = 2;
// the most dynamic shared memory one block may take on the H100
constexpr size_t kSmemMax = 232448;

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Byte layout of a ring walk block's dynamic shared memory: `stages` raw
// stages, each one page of one kv head as the pool holds it — K's 16-byte
// chunks, then V's, row by row — plus, in the q8 lane, one f32 scale slot
// per chunk; `nbuf` f32 working tiles (K [ps][kstride], padded to 16
// bytes, then V [ps][D]); the rows' queries and acc [nrows][D], m and l
// [nrows]. kstride is D + 1 for `attend_row`, D + 4 for `attend_pair`.
struct RingLayout {
  int stages, nbuf;
  size_t stage;     // bytes of one stage
  size_t kfloats;   // floats of a tile's K part
  size_t tile;      // floats of one working tile
  size_t tiles, q, acc, m, l, total;  // byte offsets; bytes in all
};

__host__ __device__ inline RingLayout ring_layout(int elem, bool scaled,
                                                 int D, int ps, int kstride,
                                                 int nrows, int stages,
                                                 int nbuf) {
  RingLayout L;
  L.stages = stages;
  L.nbuf = nbuf;
  const size_t nch = (size_t)ps * (D * elem / 16);  // chunks of K (of V)
  L.stage = round16(2 * nch * 16 + (scaled ? 2 * nch * sizeof(float) : 0));
  L.kfloats = ((size_t)ps * kstride + 3) & ~static_cast<size_t>(3);
  L.tile = L.kfloats + (size_t)ps * D;
  L.tiles = (size_t)stages * L.stage;
  L.q = L.tiles + (size_t)nbuf * L.tile * sizeof(float);
  L.acc = L.q + (size_t)nrows * D * sizeof(float);
  L.m = L.acc + (size_t)nrows * D * sizeof(float);
  L.l = L.m + (size_t)nrows * sizeof(float);
  L.total = L.l + (size_t)nrows * sizeof(float);
  return L;
}

// bytes of one pool element: q's dtype in the fp lane, else 1
template <typename T>
__host__ __device__ inline int pool_elem(int pool) {
  return pool == kPoolQ ? static_cast<int>(sizeof(T)) : 1;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
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

// One pool lane's page geometry for the ring: pool elements P, E of them
// in a 16-byte chunk, nvec chunks a pool row, nch chunks a page of K (and
// of V). Chunk c < nch is K's, c >= nch V's: the v-th 16 bytes of row j
// (`at`). With a compile-time D the divisions are shifts.
template <typename P>
struct RingChunks {
  static constexpr int E = 16 / sizeof(P);
  int nvec, nch;
  __device__ __forceinline__ RingChunks(int D, int ps)
      : nvec(D / E), nch(ps * (D / E)) {}
  __device__ __forceinline__ void at(int c, bool* isv, int* j,
                                     int* v) const {
    *isv = c >= nch;
    const int cc = *isv ? c - nch : c;
    *j = cc / nvec;
    *v = cc - *j * nvec;
  }
};

// Start copying page `page` of kv head g into `stage`: chunk c to bytes
// [16c, 16c + 16) and, in the q8 lane (kScaled), its row's scale to slot
// c. Producer thread pt of nprod owns chunks pt, pt + nprod, ... here and
// in `ring_convert_lane`, so a thread only ever reads copies it waited
// for itself.
template <typename P, bool kScaled>
__device__ __forceinline__ void ring_issue_lane(const Args& a, int D, int ps,
                                                int page, int g,
                                                unsigned char* stage, int pt,
                                                int nprod) {
  const RingChunks<P> ch(D, ps);
  const P* __restrict__ kpool = static_cast<const P*>(a.k);
  const P* __restrict__ vpool = static_cast<const P*>(a.v);
  float* slots = reinterpret_cast<float*>(stage + 2 * (size_t)ch.nch * 16);
  for (int c = pt; c < 2 * ch.nch; c += nprod) {
    bool isv;
    int j, v;
    ch.at(c, &isv, &j, &v);
    const size_t row = ((size_t)page * ps + j) * a.Hkv + g;
    cp_async16(stage + (size_t)c * 16,
               (isv ? vpool : kpool) + row * D + v * ch.E);
    if (kScaled) cp_async4(slots + c, (isv ? a.v_scale : a.k_scale) + row);
  }
}

// Convert this thread's chunks of page `page` of kv head g into the f32
// working tile, exactly as `load_page` converts them: each element to f32
// (exact from bf16, f16 and e4m3), times its row's scale in the q8 lane
// (one f32 multiply). The chunks come from a landed `stage`, or, with
// stage null, straight from the pools (16-byte loads, as `load_page`
// reads them). K rows go to the padded [ps][kstride] part (16-byte stores
// when kstride is a multiple of 4: kVecK), V rows to [ps][D] with 16-byte
// stores.
template <typename P, bool kScaled, bool kVecK>
__device__ __forceinline__ void ring_convert_lane(
    const Args& a, const unsigned char* stage, int page, int g, int D,
    int ps, int kstride, float* sK, float* sV, int pt, int nprod) {
  const RingChunks<P> ch(D, ps);
  constexpr int E = RingChunks<P>::E;
  const P* __restrict__ kpool = static_cast<const P*>(a.k);
  const P* __restrict__ vpool = static_cast<const P*>(a.v);
  const size_t slots = 2 * (size_t)ch.nch * 16;  // the scale slots' offset
  for (int c = pt; c < 2 * ch.nch; c += nprod) {
    bool isv;
    int j, v;
    ch.at(c, &isv, &j, &v);
    uint4 raw;
    float s = 1.f;
    if (stage != nullptr) {
      raw = *reinterpret_cast<const uint4*>(stage + (size_t)c * 16);
      if (kScaled) s = reinterpret_cast<const float*>(stage + slots)[c];
    } else {
      const size_t row = ((size_t)page * ps + j) * a.Hkv + g;
      raw = __ldg(reinterpret_cast<const uint4*>((isv ? vpool : kpool) +
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
    if (!isv && !kVecK) {
      float* dst = sK + j * kstride + v * E;
#pragma unroll
      for (int i = 0; i < E; ++i) dst[i] = f[i];
    } else {
      float4* dst = reinterpret_cast<float4*>(
          isv ? sV + j * D + v * E : sK + j * kstride + v * E);
#pragma unroll
      for (int i = 0; i < E / 4; ++i)
        dst[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                             f[4 * i + 3]);
    }
  }
}

// The copy and the conversion of the launch's pool type: q's own T, int8
// with scales, or e4m3 (a uniform switch, as in `load_pool_page`).
template <typename T>
__device__ __forceinline__ void ring_issue(const Args& a, int D, int ps,
                                           int page, int g,
                                           unsigned char* stage, int pt,
                                           int nprod) {
  switch (a.pool) {
    case kPoolI8:
      ring_issue_lane<int8_t, true>(a, D, ps, page, g, stage, pt, nprod);
      break;
    case kPoolE4M3:
      ring_issue_lane<__nv_fp8_e4m3, false>(a, D, ps, page, g, stage, pt,
                                            nprod);
      break;
    default:
      ring_issue_lane<T, false>(a, D, ps, page, g, stage, pt, nprod);
  }
}

template <typename T, bool kVecK>
__device__ __forceinline__ void ring_convert(const Args& a,
                                             const unsigned char* stage,
                                             int page, int g, int D, int ps,
                                             int kstride, float* sK,
                                             float* sV, int pt, int nprod) {
  switch (a.pool) {
    case kPoolI8:
      ring_convert_lane<int8_t, true, kVecK>(a, stage, page, g, D, ps,
                                             kstride, sK, sV, pt, nprod);
      break;
    case kPoolE4M3:
      ring_convert_lane<__nv_fp8_e4m3, false, kVecK>(
          a, stage, page, g, D, ps, kstride, sK, sV, pt, nprod);
      break;
    default:
      ring_convert_lane<T, false, kVecK>(a, stage, page, g, D, ps, kstride,
                                         sK, sV, pt, nprod);
  }
}

// Instantiate launcher L for q's dtype code and the (DV, PJ) that D and
// ps need; the pool code rides in Args (`load_pool_page`).
template <class L, typename T, int DV>
int dispatch_pj(const Args& a, cudaStream_t s) {
  if (a.ps <= 32) return L::template run<T, DV, 1>(a, s);
  if (a.ps <= 64) return L::template run<T, DV, 2>(a, s);
  if (a.ps <= 128) return L::template run<T, DV, 4>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class L, typename T>
int dispatch_dv(const Args& a, cudaStream_t s) {
  if (a.D <= 32) return dispatch_pj<L, T, 1>(a, s);
  if (a.D <= 64) return dispatch_pj<L, T, 2>(a, s);
  if (a.D <= 128) return dispatch_pj<L, T, 4>(a, s);
  if (a.D <= 256) return dispatch_pj<L, T, 8>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class L>
int dispatch(int dtype, const Args& a, cudaStream_t s) {
  if (!pools_valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32:
      return dispatch_dv<L, float>(a, s);
    case kBF16:
      return dispatch_dv<L, __nv_bfloat16>(a, s);
    case kF16:
      return dispatch_dv<L, __half>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace walk
}  // namespace ptt
