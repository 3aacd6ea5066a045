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
//   K10a (ptt_grouped_phase1): grid (query block t, kv head g, group slot).
//     A group with no shared span returns at once. The block scans
//     group_id for its members whose query block t is live, then streams
//     each shared page ONCE through the leader's table and folds it into
//     the online-softmax partials (m, l, acc) of every member row, and
//     writes those partials. Member b folds pages [0, min(cnt, last_b + 1))
//     where last_b is the last page its query block reads, so a row never
//     sees a page K6 would not have read for it. Rows of other groups are
//     never touched.
//   K10b (ptt_grouped_phase2): K6's per-row walk (`row_walk_kernel` in
//     paged_walk.cuh), except that a member of a sharing group starts from
//     its phase-1 partials at page min(cnt, last + 1).
//
// Both phases call the same `attend_row` as K6 and walk each row's pages
// in K6's order, and the partials cross in f32, so K10's output equals
// K6's bit for bit on the same operands.
//
// What bounds it: bytes. Phase 1 reads each group's shared span once per
// (group, kv head, query block) instead of once per member row; phase 2
// reads each row's private tail. On a TPU that cut is the point; on the
// H100 a span of a few MB per layer may already sit in the 50 MB L2 when
// K6's rows re-read it, which is the open question the timings answer.
//
// Design. The TPU carried the partials along a sequential (group x page)
// grid axis in VMEM; here one thread block owns one group's whole shared
// walk for one (kv head, query block) and keeps the member rows' queries
// and partials in shared memory for the span, staging one page tile at a
// time. Shared memory holds at most `cap` members' rows: cap is the
// largest count whose rows (qblk * rep of them, each D floats of query,
// D of acc, m and l) fit beside the page tile and the member list in
// kPhase1SmemBudget (200 KB), at most B. A group with more members than
// cap is walked in chunks of cap members, and each chunk re-reads the
// span. GPT-124M (rep 1, D 64): a member costs 4.2 KB, so all 16 slots
// fit; rep 4, D 128: 33 KB, five members a chunk. The partials are
// allocated by the wrapper with torch.empty and only member rows are
// written; phase 2 reads a row's partials only when its group shares
// pages, so no pass fills them first.
#include "paged_walk.cuh"

namespace {

using namespace ptt::walk;

template <typename T, int DV, int PJ>
__global__ void __launch_bounds__(kThreads) phase1_kernel(const Args a) {
  extern __shared__ float smem[];
  __shared__ int s_nmem;
  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int grp = blockIdx.z;
  const int cnt = a.group_cnt[grp];
  if (cnt <= 0) return;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const int D = a.D, ps = a.ps, H = a.H, lq = a.lq, cap = a.cap;
  const int rep = H / a.Hkv;
  const int nrows = a.qblk * rep;
  float* sK = smem;                        // [ps][D + 1]
  float* sV = sK + ps * (D + 1);           // [ps][D]
  float* sQ = sV + ps * D;                 // [cap * nrows][D]
  float* sAcc = sQ + (size_t)cap * nrows * D;      // [cap * nrows][D]
  float* sM = sAcc + (size_t)cap * nrows * D;      // [cap * nrows]
  float* sL = sM + cap * nrows;                    // [cap * nrows]
  int* sMem = reinterpret_cast<int*>(sL + cap * nrows);  // [B] member rows
  int* sLim = sMem + a.B;  // [B] pages each member folds here
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = t * a.qblk;
  const int leader = min(max(a.group_leader[grp], 0), a.B - 1);

  if (tid == 0) {
    int n = 0;
    for (int b = 0; b < a.B; ++b) {
      if (a.group_id[b] != grp) continue;
      const int qlen_b = a.q_len[b];
      if (q0 >= qlen_b) continue;  // dead block: phase 2 reads nothing
      sMem[n] = b;
      sLim[n] = min(cnt, block_pages(a.pos[b], qlen_b, q0, a.qblk, ps, a.mp));
      ++n;
    }
    s_nmem = n;
  }
  __syncthreads();
  const int nmem = s_nmem;
  const size_t part0 = ((size_t)g * a.nqb + t) * ((size_t)a.B * nrows);

  for (int c0 = 0; c0 < nmem; c0 += cap) {
    const int nc = min(cap, nmem - c0);
    const int rows = nc * nrows;
    int span = 0;
    for (int m = 0; m < nc; ++m) span = max(span, sLim[c0 + m]);
    for (int idx = tid; idx < rows * D; idx += kThreads) {
      const int R = idx / D, d = idx - R * D;
      const int m = R / nrows, r = R - m * nrows;
      const int b = sMem[c0 + m];
      const int qi = q0 + r / rep;
      const int h = g * rep + r % rep;
      sQ[idx] = qi < lq
                    ? ptt::to_f32<T>(q[(((size_t)b * lq + qi) * H + h) * D + d])
                    : 0.f;
      sAcc[idx] = 0.f;
    }
    for (int R = tid; R < rows; R += kThreads) {
      sM[R] = kNegInf;
      sL[R] = 0.f;
    }
    for (int sp = 0; sp < span; ++sp) {
      int page = a.page_table[(size_t)leader * a.mp + sp];
      page = min(max(page, 0), a.num_pages - 1);
      __syncthreads();  // previous tile fully consumed (and init visible)
      load_pool_page<T>(a, page, g, sK, sV);
      __syncthreads();
      for (int R = warp; R < rows; R += kWarps) {
        const int m = R / nrows;
        if (sp >= sLim[c0 + m]) continue;  // uniform across the warp
        const int b = sMem[c0 + m];
        const int qi = q0 + (R - m * nrows) / rep;
        attend_row<DV, PJ>(sQ + (size_t)R * D, sK, sV, D, ps, sp * ps,
                           qi < a.q_len[b], a.pos[b] + qi, a.scale, sM + R,
                           sL + R, sAcc + (size_t)R * D, lane);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < rows * D; idx += kThreads) {
      const int R = idx / D, d = idx - R * D;
      const int m = R / nrows, r = R - m * nrows;
      const size_t row = part0 + (size_t)sMem[c0 + m] * nrows + r;
      a.pacc[row * D + d] = sAcc[idx];
    }
    for (int R = tid; R < rows; R += kThreads) {
      const int m = R / nrows, r = R - m * nrows;
      const size_t row = part0 + (size_t)sMem[c0 + m] * nrows + r;
      a.pm[row] = sM[R];
      a.pl[row] = sL[R];
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
}

inline size_t phase1_member_bytes(const Args& a) {
  const size_t nrows = (size_t)a.qblk * (a.H / a.Hkv);
  return sizeof(float) * nrows * (2 * (size_t)a.D + 2);
}

inline size_t phase1_fixed_bytes(const Args& a) {
  return sizeof(float) * tile_floats(a.D, a.ps) + 2 * sizeof(int) * a.B;
}

struct Phase1 {
  template <typename T, int DV, int PJ>
  static int run(const Args& a, cudaStream_t stream) {
    const size_t smem = phase1_fixed_bytes(a) + a.cap * phase1_member_bytes(a);
    auto kernel = phase1_kernel<T, DV, PJ>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(a.nqb, a.Hkv, a.B), kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

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
  using namespace ptt::walk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = make_args(q, k, v, k_scale, v_scale, page_table, pos, q_len, B,
                     lq, H, Hkv, D, ps, mp, num_pages, pool);
  a.group_id = static_cast<const int*>(group_id);
  a.group_leader = static_cast<const int*>(group_leader);
  a.group_cnt = static_cast<const int*>(group_cnt);
  a.pm = static_cast<float*>(m);
  a.pl = static_cast<float*>(l);
  a.pacc = static_cast<float*>(acc);
  const size_t fixed = phase1_fixed_bytes(a);
  if (fixed >= kPhase1SmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  const size_t fit = (kPhase1SmemBudget - fixed) / phase1_member_bytes(a);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.cap = static_cast<int>(fit < (size_t)B ? fit : (size_t)B);
  return dispatch<Phase1>(dtype, a, static_cast<cudaStream_t>(stream));
}

// K10b. The operands of K10a plus out [B, lq, H, D]; reads the partials
// K10a wrote.
extern "C" int ptt_grouped_phase2(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* pos,
    const void* q_len, const void* group_id, const void* group_cnt,
    const void* m, const void* l, const void* acc, void* out, int B, int lq,
    int H, int Hkv, int D, int ps, int mp, int num_pages, int dtype,
    int pool, int device, void* stream) {
  using namespace ptt::walk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = make_args(q, k, v, k_scale, v_scale, page_table, pos, q_len, B,
                     lq, H, Hkv, D, ps, mp, num_pages, pool);
  a.group_id = static_cast<const int*>(group_id);
  a.group_cnt = static_cast<const int*>(group_cnt);
  a.pm = static_cast<float*>(const_cast<void*>(m));
  a.pl = static_cast<float*>(const_cast<void*>(l));
  a.pacc = static_cast<float*>(const_cast<void*>(acc));
  a.out = out;
  return dispatch<RowWalk<true>>(dtype, a, static_cast<cudaStream_t>(stream));
}
