// K6: ragged paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_ragged_kernel
// (fp lane; launched from _ragged_attention_kernel, public
// ragged_paged_attention). One call serves a mixed batch of decode rows
// (q_len 1) and mid-prefill rows (q_len up to the step width) against a
// shared paged KV pool:
//
//   q [B, lq, H, D]; k/v pools [P, ps, H_kv, D]; page_table [B, mp] int32;
//   pos, q_len [B] int32. Query i of row b sits at position pos[b] + i and
//   attends keys j <= pos[b] + i; queries at i >= q_len[b] are dead (their
//   output is only finite). rep = H / H_kv query heads share one K/V
//   stream (GQA). Pages past ceil((pos + live queries) / ps) are never
//   read. Masked scores are -1e30 before an online softmax in f32, and the
//   output is acc / max(l, 1e-30), as in the TPU kernel.
//
// What bounds it: at serving shapes, bytes. Every live K/V page is
// streamed from device memory and meets only the few queries of one row,
// so the work per byte is a few flops per element for a decode row and
// at most 2 * qblk * rep flops per element for a prefill block.
//
// Design. The TPU kernel carried (m, l, acc) from one grid step to the
// next along a sequential page axis; blocks here run in no order, so
// there is no grid-order carry. Each CUDA block owns (row b, kv head g,
// query block of <= 8 queries x rep heads), reads its own pos, q_len and
// page-table entries, and loops over its live pages itself. Each loop
// step stages one page's K and V tile [ps, D] in shared memory (16-byte
// vector loads, converted to f32; K rows padded by one float so the
// per-key dot products of a warp hit distinct banks), then each warp
// takes whole query rows: lane j scores key j of the page, the page's
// max and sum are warp reductions, and lane d accumulates output column
// d (and d + 32, ...) with the probabilities broadcast by shuffles.
// m, l and acc live in shared memory in f32 for the whole walk. Dead
// query blocks write zeros and read nothing. Page ids are clamped into
// the pool, so a bad table reads the wrong page instead of faulting.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

// DV: output columns per lane (D <= 32 * DV); PJ: keys per lane
// (ps <= 32 * PJ).
template <typename T, int DV, int PJ>
__global__ void __launch_bounds__(kThreads) ragged_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ page_table,
    const int* __restrict__ pos, const int* __restrict__ q_len,
    T* __restrict__ out, int lq, int H, int Hkv, int D, int ps, int mp,
    int num_pages, int qblk, float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = H / Hkv;
  const int nrows = qblk * rep;  // block row r: query q0 + r / rep, head g * rep + r % rep
  const int kstride = D + 1;
  float* sK = smem;                  // [ps][D + 1]
  float* sV = sK + ps * kstride;     // [ps][D]
  float* sQ = sV + ps * D;           // [nrows][D]
  float* sAcc = sQ + nrows * D;      // [nrows][D]
  float* sM = sAcc + nrows * D;      // [nrows]
  float* sL = sM + nrows;            // [nrows]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos_b = pos[b];
  const int qlen_b = q_len[b];
  const int q0 = t * qblk;

  if (q0 >= qlen_b) {  // dead query block: zeros, no page traffic
    for (int idx = tid; idx < nrows * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const int qi = q0 + r / rep;
      if (qi < lq) {
        const int h = g * rep + r % rep;
        out[(((size_t)b * lq + qi) * H + h) * D + d] = ptt::from_f32<T>(0.f);
      }
    }
    return;
  }
  const int last_qi = min(q0 + qblk, qlen_b) - 1;
  const int n_pages = min(mp, (pos_b + last_qi) / ps + 1);

  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r / rep;
    const int h = g * rep + r % rep;
    sQ[idx] = qi < lq ? ptt::to_f32<T>(q[(((size_t)b * lq + qi) * H + h) * D + d])
                      : 0.f;
    sAcc[idx] = 0.f;
  }
  for (int r = tid; r < nrows; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  const int nvec = D / E;            // vectors per key row
  for (int p = 0; p < n_pages; ++p) {
    int page = page_table[(size_t)b * mp + p];
    page = min(max(page, 0), num_pages - 1);
    __syncthreads();  // previous tile fully consumed (and init visible)
    for (int idx = tid; idx < ps * nvec; idx += kThreads) {
      const int j = idx / nvec, c = idx - j * nvec;
      const size_t src = (((size_t)page * ps + j) * Hkv + g) * D + c * E;
      const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kpool + src));
      const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vpool + src));
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sK[j * kstride + c * E + e] = ptt::to_f32<T>(ke[e]);
        sV[j * D + c * E + e] = ptt::to_f32<T>(ve[e]);
      }
    }
    __syncthreads();
    for (int r = warp; r < nrows; r += kWarps) {
      const int qi = q0 + r / rep;
      const float* qr = sQ + r * D;
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
          const int kp = p * ps + j;
          const bool live = (qi < qlen_b) && (kp <= pos_b + qi);
          s[i] = live ? dot * scale : kNegInf;
          mcur = fmaxf(mcur, s[i]);
        }
      }
      mcur = ptt::warp_max(mcur);
      const float mprev = sM[r];
      const float mnew = fmaxf(mprev, mcur);
      const float alpha = expf(mprev - mnew);
      float pj[PJ];
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < PJ; ++i) {
        pj[i] = (lane + 32 * i < ps) ? expf(s[i] - mnew) : 0.f;
        psum += pj[i];
      }
      psum = ptt::warp_sum(psum);
      float a[DV];
#pragma unroll
      for (int u = 0; u < DV; ++u) {
        const int d = lane + 32 * u;
        a[u] = d < D ? sAcc[r * D + d] * alpha : 0.f;
      }
#pragma unroll
      for (int i = 0; i < PJ; ++i) {
        for (int jj = 0; jj < 32; ++jj) {
          const int j = 32 * i + jj;
          if (j >= ps) break;  // uniform across the warp
          const float pv = __shfl_sync(ptt::kFullMask, pj[i], jj);
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
        if (d < D) sAcc[r * D + d] = a[u];
      }
      __syncwarp();  // every lane has read sM[r] / sL[r]
      if (lane == 0) {
        sM[r] = mnew;
        sL[r] = alpha * sL[r] + psum;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qi = q0 + r / rep;
    if (qi < lq) {
      const int h = g * rep + r % rep;
      const float l = fmaxf(sL[r], 1e-30f);
      out[(((size_t)b * lq + qi) * H + h) * D + d] = ptt::from_f32<T>(sAcc[idx] / l);
    }
  }
}

size_t smem_bytes(int D, int ps, int nrows) {
  return sizeof(float) *
         ((size_t)ps * (D + 1) + (size_t)ps * D + 2 * (size_t)nrows * D +
          2 * (size_t)nrows);
}

template <typename T, int DV, int PJ>
int launch_one(const void* q, const void* k, const void* v, const int* pt,
               const int* pos, const int* qlen, void* out, int B, int lq,
               int H, int Hkv, int D, int ps, int mp, int num_pages,
               cudaStream_t stream) {
  const int qblk = lq < 8 ? lq : 8;
  const int nqb = (lq + qblk - 1) / qblk;
  const int nrows = qblk * (H / Hkv);
  const size_t smem = smem_bytes(D, ps, nrows);
  auto kernel = ragged_kernel<T, DV, PJ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid(nqb, Hkv, B), block(kThreads);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, pos, qlen, static_cast<T*>(out), lq, H,
      Hkv, D, ps, mp, num_pages, qblk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DV>
int launch_pj(const void* q, const void* k, const void* v, const int* pt,
              const int* pos, const int* qlen, void* out, int B, int lq,
              int H, int Hkv, int D, int ps, int mp, int num_pages,
              cudaStream_t s) {
  if (ps <= 32)
    return launch_one<T, DV, 1>(q, k, v, pt, pos, qlen, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
  if (ps <= 64)
    return launch_one<T, DV, 2>(q, k, v, pt, pos, qlen, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
  if (ps <= 128)
    return launch_one<T, DV, 4>(q, k, v, pt, pos, qlen, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pt,
           const int* pos, const int* qlen, void* out, int B, int lq, int H,
           int Hkv, int D, int ps, int mp, int num_pages, cudaStream_t s) {
  if (D <= 32)
    return launch_pj<T, 1>(q, k, v, pt, pos, qlen, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
  if (D <= 64)
    return launch_pj<T, 2>(q, k, v, pt, pos, qlen, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
  if (D <= 128)
    return launch_pj<T, 4>(q, k, v, pt, pos, qlen, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
  if (D <= 256)
    return launch_pj<T, 8>(q, k, v, pt, pos, qlen, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: [B, lq, H, D]; k, v: [num_pages, ps, Hkv, D]; page_table
// [B, mp]; pos, q_len [B]. All contiguous; q, k, v, out of one dtype;
// D a multiple of the 16-byte vector width; H a multiple of Hkv.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* pos, const void* q_len, void* out, int B, int lq, int H,
    int Hkv, int D, int ps, int mp, int num_pages, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* ps_ = static_cast<const int*>(pos);
  const int* ql = static_cast<const int*>(q_len);
  switch (dtype) {
    case ptt::kF32:
      return launch<float>(q, k, v, pt, ps_, ql, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
    case ptt::kBF16:
      return launch<__nv_bfloat16>(q, k, v, pt, ps_, ql, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
    case ptt::kF16:
      return launch<__half>(q, k, v, pt, ps_, ql, out, B, lq, H, Hkv, D, ps, mp, num_pages, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
