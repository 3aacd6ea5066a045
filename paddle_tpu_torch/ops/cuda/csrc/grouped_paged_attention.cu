// K10: the grouped (prefix-sharing) ragged paged attention walk for
// Hopper (sm_90a), in two phases.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_grouped_phase1_kernel
// (K10a) and ::_grouped_phase2_kernel (K10b), both launched from
// _grouped_attention_kernel (public ragged_paged_attention_grouped and, in
// the q8 lane — `has_scale`, scale specs ks1/ks2 — ragged_paged_attention_
// grouped_q8; the fp8 lane is the `fp8` flag), in all three pool lanes
// (paged_walk.cuh). It computes what K6 computes (ragged paged attention, see
// ragged_paged_attention.cu), for a batch whose rows declare prefix
// groups: rows of group g share the physical pages at table indices
// [0, group_cnt[g]); group_leader[g] names a member whose table phase 1
// walks; a singleton has group_cnt 0 and is exactly K6.
//
// Both phases are one kernel, `ring_walk_kernel`. Its work items are the
// launch's (query block t, row b) pairs, each walked once per kv head:
//   K10a (ptt_grouped_phase1): an item whose row is a member of a sharing
//     group (group_cnt[group_id[b]] > 0) and whose query block is live
//     walks the shared span, pages [0, min(cnt, last_b + 1)) read through
//     the leader's table, from (-1e30, 0, 0), and writes its rows'
//     partials (m, l, acc); no other item folds anything. The members of
//     one group walk the span side by side, each in its own block: the
//     first read brings the span into the 50 MB L2 and the others read it
//     there, so device memory serves each (group, kv head) span about
//     once, and no block waits for another.
//   K10b (ptt_grouped_phase2): every live item walks its row's pages
//     [p0, last + 1), where p0 = min(cnt, last + 1) for a member (starting
//     from its phase-1 partials) and 0 for any other row, and writes the
//     output; a dead query block writes zeros.
// Both fold with K6's arithmetic (below), walk each row's pages in K6's
// order, and the partials cross in f32, so K10's output equals K6's (K7's
// in the q8 lane) bit for bit on the same operands.
//
// What bounds it: on paper, bytes (each group's span once per kv head,
// each row's private tail once), some hundred times below its time; in
// practice the chain of page folds of the longest row, which must run one
// after another. The fold stays on the CUDA cores in f32: it is K6's
// arithmetic, and a tensor-core product would sum in another order and
// lose K10 = K6. At GPT-124M a page block is 16 keys x 64 dims meeting at
// most 8 queries x rep heads, a few flops a byte, far below where the
// tensor cores would set the pace. So the design keeps copies in flight,
// shortens each fold and keeps the SMs evenly busy:
// - The ring (`ring_issue`, `ring_convert` in paged_walk.cuh):
//   kRingStages (2) raw page stages in shared memory, filled by cp.async
//   (16 bytes a thread, one commit group per page, two pages ahead). Each
//   thread copies and later converts the same chunks, so it waits only on
//   its own groups (cp.async.wait_group), and no barrier stands between a
//   copy landing and its conversion. Page ids are read from the table as
//   the copies are issued, one page ahead in a register, so shared memory
//   does not grow with the table. cp.async was chosen over TMA: the q8
//   lane's f32 scales are one float per (position, kv head), strided in
//   the scale pool, too narrow for a tensor map's 16-byte box rows, and a
//   tensor map per pool per call would add host work to a step that is
//   host-bound. On the H100 2 stages ran fastest, 3-8 within 3 % of it and
//   1 about a third slower (`python -m
//   paddle_tpu_torch.ops.cuda.grouped_stage_sweep`, which compiles each
//   count).
// - Two f32 working tiles: warps with no rows to fold (at GPT-124M 4 of
//   the 8) copy and convert page i + 1 into one tile while the others
//   fold page i from the other, one __syncthreads a page; when every warp
//   has rows, each folds, then converts.
// - Where the ring and two tiles do not fit beside the rows' state (large
//   f32 or 16-bit pages, many rows a block), the block loads each page
//   straight from the pools into one tile, as K6 does, with a barrier
//   before and after (`grouped_layout`). So K10 takes every shape K6
//   takes, and `ptt_grouped_plan` reports which feeder a launch gets.
// - The fold: page size 16 at head dims 32, 64, 128 and 256 takes
//   instantiations with D and ps as compile-time constants, folding two
//   query rows a warp (`attend_pair`, a half-warp each, K rows padded to
//   D + 4 floats and read four at a time, q in registers up to head dim
//   64), which gives every value attend_row's operations in attend_row's
//   order; every other shape folds a row a warp with `attend_row` itself,
//   at run-time D and ps.
// - The schedule: every block ranks the launch's items by descending
//   walk length (`item_key`; up to 512 items, else index order), and
//   block x takes kv head x % Hkv of the item ranked x / Hkv, so the
//   longest walks start first on distinct SMs and the blocks of dead
//   items come last. Two blocks fit an SM (`__launch_bounds__(256, 2)`):
//   at one, the grid ran in waves and the dead items' blocks queued
//   behind the live ones.
#include "paged_walk.cuh"

namespace {

using namespace ptt;
using namespace ptt::walk;

// launches with at most this many (query block, row) items schedule them
// longest walk first
constexpr int kSortMax = 512;

// the shapes of the compile-time, two-rows-a-warp instantiations
__host__ __device__ inline bool ring_paired(int D, int ps) {
  return ps == 16 && (D == 32 || D == 64 || D == 128 || D == 256);
}

// The work items of a launch are its (query block t, row b) pairs, item
// i = b * nqb + t, each walked once per kv head. `item_key` is an item's
// place in the schedule: 0 for an item with nothing to fold (a dead query
// block; in phase 1 also a row outside every sharing group), else 1 plus
// its walk's page count in this phase, so that longer walks start first.
template <bool kPhase1>
__device__ __forceinline__ int item_key(const Args& a, int i, int ps) {
  const int b = i / a.nqb, t = i - b * a.nqb;
  const int q0 = t * a.qblk;
  const int qlen_b = a.q_len[b];
  if (q0 >= qlen_b) return 0;
  const int n_pages = block_pages(a.pos[b], qlen_b, q0, a.qblk, ps, a.mp);
  // a group id outside [0, B) names no group: the row walks as a singleton
  const int gid = a.group_id[b];
  const int cnt = (gid >= 0 && gid < a.B) ? a.group_cnt[gid] : 0;
  const int span = cnt > 0 ? min(cnt, n_pages) : 0;
  if (kPhase1) return span > 0 ? span + 1 : 0;
  return n_pages - span + 1;
}

// the dynamic shared memory a block may take beside the static schedule
// keys (sKey, sItem: 2064 bytes as ptxas lays them out)
constexpr size_t kDynSmemMax = kSmemMax - sizeof(int) * (kSortMax + 4);

// A launch's feeder and shared memory: the ring (kRingStages stages, two
// f32 tiles) where it fits kDynSmemMax beside the rows' state, else one
// tile that each page is loaded into straight from the pools (stages 0);
// where even that does not fit, total exceeds kDynSmemMax. The kernel and
// `ptt_grouped_plan` both call this, so the launch and the report agree.
__host__ __device__ inline RingLayout grouped_layout(int elem, bool scaled,
                                                    int D, int ps, int nrows) {
  const int kstride = ring_paired(D, ps) ? D + 4 : D + 1;
  const RingLayout L =
      ring_layout(elem, scaled, D, ps, kstride, nrows, kRingStages, 2);
  if (L.total <= kDynSmemMax) return L;
  return ring_layout(elem, scaled, D, ps, kstride, nrows, 0, 1);
}

template <typename T>
__host__ __device__ inline RingLayout grouped_layout(const Args& a, int D,
                                                    int ps) {
  return grouped_layout(pool_elem<T>(a.pool), a.pool == kPoolI8, D, ps,
                        a.qblk * (a.H / a.Hkv));
}

// K10a (kPhase1) and K10b. kD, kPS: the head dim and page size as
// compile-time constants, or 0 for the run-time a.D, a.ps. One-dimensional
// grid of nqb * B * Hkv blocks: block x walks kv head x % Hkv of the item
// ranked x / Hkv in the schedule.
template <typename T, int DV, int PJ, int kD, int kPS, bool kPhase1>
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
  const int nrows = a.qblk * rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = blockIdx.x % a.Hkv;
  const int rank = blockIdx.x / a.Hkv;

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
  const int qlen_b = a.q_len[b];
  const int q0 = t * a.qblk;

  if (q0 >= qlen_b) {  // dead query block: no pages; phase 2 writes zeros
    if (!kPhase1) {
      T* __restrict__ out = static_cast<T*>(a.out);
      for (int idx = tid; idx < nrows * D; idx += kThreads) {
        const int r = idx / D, d = idx - r * D;
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
  const int gid = a.group_id[b];
  const int cnt = (gid >= 0 && gid < a.B) ? a.group_cnt[gid] : 0;
  const int span = cnt > 0 ? min(cnt, n_pages) : 0;
  if (kPhase1 && span == 0) return;  // not a member: nothing to fold
  const int p0 = kPhase1 ? 0 : span;
  const int n = (kPhase1 ? span : n_pages) - p0;
  const int trow = kPhase1 ? min(max(a.group_leader[gid], 0), a.B - 1) : b;
  const bool resume = !kPhase1 && span > 0;
  // the page id of the walk's i-th page, from the walked row's table
  const int* __restrict__ table = a.page_table + (size_t)trow * a.mp + p0;
  auto page_id = [&](int i) {
    return min(max(table[i], 0), a.num_pages - 1);
  };

  // the compile-time page size 16 folds two rows a warp (`attend_pair`)
  constexpr bool kPair = kPS == 16;
  const int kstride = kPair ? D + 4 : D + 1;
  const RingLayout L = grouped_layout<T>(a, D, ps);
  const bool ring = L.stages > 0;
  float* tiles = reinterpret_cast<float*>(sbuf + L.tiles);
  float* sQ = reinterpret_cast<float*>(sbuf + L.q);      // [nrows][D]
  float* sAcc = reinterpret_cast<float*>(sbuf + L.acc);  // [nrows][D]
  float* sM = reinterpret_cast<float*>(sbuf + L.m);      // [nrows]
  float* sL = reinterpret_cast<float*>(sbuf + L.l);      // [nrows]
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

  // With a compile-time head dim up to 64 a half-warp's query row sits in
  // registers: read once for the walk when the warp has one pair of rows,
  // else before each fold.
  constexpr bool kQRegs = kPair && kD <= 64;
  float qreg[kQRegs ? kD : 1];
  const bool one_pair = nrows <= 2 * kWarps;
  // Roles: the first `folders` warps fold (one warp per row pair, or per
  // row); on the ring, when that leaves warps over, those are the
  // producers that copy and convert the pages, so converting page i + 1
  // overlaps folding page i; else every warp does both, folding first.
  const int units = kPair ? (nrows + 1) / 2 : nrows;
  const int folders = min(units, kWarps);
  const int first_prod = ring && folders < kWarps ? folders : 0;
  const bool producer = warp >= first_prod;
  const int pt = tid - first_prod * 32, nprod = kThreads - first_prod * 32;
  // the ring's first kRingStages pages, one commit group each; `next`:
  // the id of the page the ring takes next, read a page ahead
  int next = 0;
  if (ring && producer) {
#pragma unroll
    for (int i = 0; i < kRingStages; ++i) {
      if (i < n)
        ring_issue<T>(a, D, ps, page_id(i), g, sbuf + (size_t)i * L.stage,
                      pt, nprod);
      cp_async_commit();
    }
    if (kRingStages < n) next = page_id(kRingStages);
  }
  // Fill page p's tile: on the ring, convert its stage (p % kRingStages;
  // this thread waited for its own chunks only), then refill the stage
  // with page p + kRingStages; else load it from the pools.
  auto produce = [&](int p) {
    float* sK = tiles + (size_t)(p & (L.nbuf - 1)) * L.tile;
    if (!ring) {
      ring_convert<T, kPair>(a, nullptr, page_id(p), g, D, ps, kstride, sK,
                             sK + L.kfloats, pt, nprod);
      return;
    }
    unsigned char* stage = sbuf + (size_t)(p % kRingStages) * L.stage;
    cp_async_wait<kRingStages - 1>();
    ring_convert<T, kPair>(a, stage, 0, g, D, ps, kstride, sK,
                           sK + L.kfloats, pt, nprod);
    if (p + kRingStages < n)
      ring_issue<T>(a, D, ps, next, g, stage, pt, nprod);
    cp_async_commit();
    if (p + kRingStages + 1 < n) next = page_id(p + kRingStages + 1);
  };
  if (producer && n > 0) produce(0);
  __syncthreads();  // page 0's tile, the queries and the partials visible
  for (int i = 0; i < n; ++i) {
    const float* sK = tiles + (size_t)(i & (L.nbuf - 1)) * L.tile;
    const float* sV = sK + L.kfloats;
    const int kbase = (p0 + i) * ps;
    if (warp < folders) {
      if constexpr (kPair) {
        // warp w folds row pairs (2p, 2p + 1) for p = w, w + 8, ...
        for (int p = warp; 2 * p < nrows; p += kWarps) {
          const int r = 2 * p + (lane >> 4);
          const bool owner = r < nrows;
          const int rr = owner ? r : 2 * p;
          const int qi = q0 + rr / rep;
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
          attend_pair<kD, kQRegs>(qrow, sK, sV, kbase, qi < qlen_b,
                                  pos_b + qi, a.scale, sM + rr, sL + rr,
                                  sAcc + (size_t)rr * kD, lane, owner);
        }
      } else {
        for (int r = warp; r < nrows; r += kWarps) {
          const int qi = q0 + r / rep;
          attend_row<DV, PJ>(sQ + (size_t)r * D, sK, sV, D, ps, kbase,
                             qi < qlen_b, pos_b + qi, a.scale, sM + r, sL + r,
                             sAcc + (size_t)r * D, lane);
        }
      }
    }
    if (i + 1 < n) {
      // two tiles: page i + 1 goes to the other one while page i is
      // folded; one tile: after every fold of page i
      if (L.nbuf == 1) __syncthreads();
      if (producer) produce(i + 1);
    }
    __syncthreads();  // page i + 1's tile is whole, page i's folds done
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

template <bool kPhase1, int kD, int kPS>
struct RingWalk {
  template <typename T, int DV, int PJ>
  static int run(const Args& a, cudaStream_t stream) {
    const size_t smem = grouped_layout<T>(a, a.D, a.ps).total;
    if (smem > kDynSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = ring_walk_kernel<T, DV, PJ, kD, kPS, kPhase1>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<a.nqb * a.B * a.Hkv, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

template <class L, int DV>
int dispatch_exact(int dtype, const Args& a, cudaStream_t s) {
  switch (dtype) {
    case kF32:
      return L::template run<float, DV, 1>(a, s);
    case kBF16:
      return L::template run<__nv_bfloat16, DV, 1>(a, s);
    case kF16:
      return L::template run<__half, DV, 1>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Page size 16 at head dims 32-256: the compile-time instantiations, two
// rows a warp; any other shape: run-time D and ps, a row a warp.
template <bool kPhase1>
int ring_dispatch(int dtype, const Args& a, cudaStream_t s) {
  if (!pools_valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (ring_paired(a.D, a.ps)) {
    switch (a.D) {
      case 32:
        return dispatch_exact<RingWalk<kPhase1, 32, 16>, 1>(dtype, a, s);
      case 64:
        return dispatch_exact<RingWalk<kPhase1, 64, 16>, 2>(dtype, a, s);
      case 128:
        return dispatch_exact<RingWalk<kPhase1, 128, 16>, 4>(dtype, a, s);
      case 256:
        return dispatch_exact<RingWalk<kPhase1, 256, 16>, 8>(dtype, a, s);
      default:
        break;
    }
  }
  return dispatch<RingWalk<kPhase1, 0, 0>>(dtype, a, s);
}

Args grouped_args(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* page_table, const void* pos, const void* q_len,
                  const void* group_id, const void* group_cnt, const void* m,
                  const void* l, const void* acc, int B, int lq, int H,
                  int Hkv, int D, int ps, int mp, int num_pages, int pool) {
  Args a = make_args(q, k, v, k_scale, v_scale, page_table, pos, q_len, B,
                     lq, H, Hkv, D, ps, mp, num_pages, pool);
  a.group_id = static_cast<const int*>(group_id);
  a.group_cnt = static_cast<const int*>(group_cnt);
  a.pm = static_cast<float*>(const_cast<void*>(m));
  a.pl = static_cast<float*>(const_cast<void*>(l));
  a.pacc = static_cast<float*>(const_cast<void*>(acc));
  return a;
}

}  // namespace

// The launch both K10 entries make for these shapes, written to out[7]:
// raw stages (kRingStages on the ring; 0: each page loaded straight into
// one tile), f32 tiles, dynamic shared memory bytes, 1 if two rows share
// a warp (`attend_pair`), the grid's blocks, threads a block, query rows
// a block. Returns cudaErrorInvalidValue, as the launch would, for a
// dtype or pool code the kernels do not take, an unsupported head dim or
// page size, or shared memory over the limit.
extern "C" int ptt_grouped_plan(int B, int lq, int H, int Hkv, int D, int ps,
                                int dtype, int pool, int* out) {
  if (B < 1 || lq < 1 || Hkv < 1 || H % Hkv || D < 1 || D > 256 ||
      ps < 1 || ps > 128 || dtype < kF32 || dtype > kF16 || pool < kPoolQ ||
      pool > kPoolE4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem =
      pool != kPoolQ ? 1 : dtype == kF32 ? 4 : 2;  // bytes a pool element
  const int qblk = lq < kQBlk ? lq : kQBlk;
  const int nrows = qblk * (H / Hkv);
  const RingLayout L = grouped_layout(elem, pool == kPoolI8, D, ps, nrows);
  if (L.total > kDynSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int vals[7] = {L.stages, L.nbuf, static_cast<int>(L.total),
                       ring_paired(D, ps) ? 1 : 0,
                       (lq + qblk - 1) / qblk * B * Hkv, kThreads, nrows};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// K10a. q: [B, lq, H, D]; k, v: [num_pages, ps, Hkv, D] of the pool code
// `pool`; k_scale, v_scale: f32 [num_pages, ps, Hkv] for the int8 pool,
// else null; page_table [B, mp]; pos, q_len, group_id, group_leader,
// group_cnt [B] int32; m, l: f32 [Hkv, nqb, B * qblk * rep]; acc: f32
// [.., D], with qblk = min(lq, 8), nqb = ceil(lq / qblk), rep = H / Hkv.
// Writes the partials of member rows of sharing groups only.
extern "C" int ptt_grouped_phase1(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* pos,
    const void* q_len, const void* group_id, const void* group_leader,
    const void* group_cnt, void* m, void* l, void* acc, int B, int lq, int H,
    int Hkv, int D, int ps, int mp, int num_pages, int dtype, int pool,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = grouped_args(q, k, v, k_scale, v_scale, page_table, pos, q_len,
                        group_id, group_cnt, m, l, acc, B, lq, H, Hkv, D, ps,
                        mp, num_pages, pool);
  a.group_leader = static_cast<const int*>(group_leader);
  return ring_dispatch<true>(dtype, a, static_cast<cudaStream_t>(stream));
}

// K10b. The operands of K10a (without group_leader) plus out
// [B, lq, H, D]; reads the partials K10a wrote.
extern "C" int ptt_grouped_phase2(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* pos,
    const void* q_len, const void* group_id, const void* group_cnt,
    const void* m, const void* l, const void* acc, void* out, int B, int lq,
    int H, int Hkv, int D, int ps, int mp, int num_pages, int dtype,
    int pool, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = grouped_args(q, k, v, k_scale, v_scale, page_table, pos, q_len,
                        group_id, group_cnt, m, l, acc, B, lq, H, Hkv, D, ps,
                        mp, num_pages, pool);
  a.out = out;
  return ring_dispatch<false>(dtype, a, static_cast<cudaStream_t>(stream));
}
