// The paged K/V walk shared by K6 and K7 (ragged_paged_attention.cu), K10
// (grouped_paged_attention.cu) and K9 (paged_decode_attention.cu), in all
// their pool lanes.
//
// One online-softmax arithmetic serves all three kernels: `attend_row`
// folds one staged page into one query row's (m, l, acc), and every
// kernel walks a row's pages in the same order, 0 .. last. K10 splits
// that order at the group's shared span (phase 1 takes pages
// 0 .. cnt-1, phase 2 continues at cnt), and the partials cross between
// the phases as exact f32 values in device memory, so K10's output
// equals K6's bit for bit on the same operands.
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
// phase 1's dynamic shared memory: the page tile, the member list and as
// many members' query rows and partials as fit
constexpr size_t kPhase1SmemBudget = 200 * 1024;

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
  int B, lq, H, Hkv, D, ps, mp, num_pages, qblk, nqb, cap;
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

// The per-row walk: K6 (kGrouped false) and K10 phase 2 (kGrouped true).
// Grid (nqb, Hkv, B). A dead query block writes zeros and reads nothing.
// kMasked (K6/K7 only; under a mask the grouped op takes K6, as the JAX
// op falls back to its ungrouped kernel): query qi of head h adds the
// mask row [b, h, qi, :] to its scores, read straight from device memory
// by each lane for its key; a padding query past lq (dead) reads row
// lq - 1, so no read leaves the mask.
// Phase 2 differs in one place: a row whose group shares pages
// (group_cnt[group_id[b]] > 0) starts from its phase-1 partials at page
// min(cnt, last + 1) instead of from (-1e30, 0, 0) at page 0; phase 1 wrote
// exactly those rows' partials, so no unwritten entry is read.
template <typename T, int DV, int PJ, bool kGrouped, bool kMasked = false>
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
  int p0 = 0;
  bool resume = false;
  if (kGrouped) {
    // a group id outside [0, B) names no phase-1 block: walk as a singleton
    const int gid = a.group_id[b];
    const int cnt = (gid >= 0 && gid < a.B) ? a.group_cnt[gid] : 0;
    if (cnt > 0) {
      p0 = min(cnt, n_pages);
      resume = true;
    }
  }
  // this block's rows in the partials
  const size_t part =
      ((size_t)g * a.nqb + t) * ((size_t)a.B * nrows) + (size_t)b * nrows;

  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
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

  for (int p = p0; p < n_pages; ++p) {
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

template <bool kGrouped, bool kMasked = false>
struct RowWalk {
  template <typename T, int DV, int PJ>
  static int run(const Args& a, cudaStream_t stream) {
    const size_t smem = row_walk_smem(a);
    auto kernel = row_walk_kernel<T, DV, PJ, kGrouped, kMasked>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(a.nqb, a.Hkv, a.B), kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

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
