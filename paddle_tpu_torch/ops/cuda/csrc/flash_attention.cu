// K3, K4, K5: flash attention forward, dq and dk/dv for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:
//   K3 _fa_kernel     (forward + per-row logsumexp, launched from
//                      _flash_fwd_bhld),
//   K4 _fa_dq_kernel  (dq by recompute, launched from _flash_bwd_bhld),
//   K5 _fa_dkv_kernel (dk, dv by recompute, launched from
//                      _flash_bwd_bhld).
//
// Semantics, shared with the plain versions in ops/cuda/flash_attention.py:
// q [B, Lq, H, D], k/v [B, Lk, H, D] (any strides with a unit last one),
// bh = b * H + h. s = (q . k) * scale + bias[bi, hi, i, j] + kvec[bi, j];
// causal masking is aligned bottom-right: query i sees key j iff
// j <= i + (Lk - Lq). A masked entry has p = 0 exactly; a query that sees
// no key at all gets o = 0 and lse = -inf (its gradients are 0). Dropout
// comes after the softmax: the normaliser l is the undropped row sum, a
// kept weight is scaled by inv_keep = 1 / (1 - p_drop), and the keep mask
// is the position hash dropout_keep(seed0, seed1, bh, i, j) of the TPU
// kernel, bit for bit. lse = m + log(max(l, 1e-30)) is stored [BH, Lq]
// in f32. The backward takes di = rowsum(o * dO) [BH, Lq] from the host.
//
// What bounds them: at GPT-124M's training shapes (B 16, L 1024, H 12,
// D 64, causal) the three are bound by operations (4 L^2 D / 2 per head
// for the forward, 6 and 8 for dq and dk/dv) on the tensor cores; this
// first version does its products on the CUDA cores in f32, so it sits
// far above that bound. Design (simple and right first): each block of
// 256 threads owns one 64-row tile — (bh, q-block) for K3 and K4,
// (bh, k-block) for K5 — holds it in shared memory as f32 and loops
// sequentially over the other axis, staging 64-row K/V (or Q/dO) tiles
// with plain 16-byte loads. Each thread computes a 4 x 4 patch of the
// 64 x 64 logit tile (rows ty + 16 i, columns tx + 16 j), so the row
// reductions of the online softmax are shuffles inside a half-warp.
// Blocks walk their own axis, so no kernel needs atomics. k-blocks past
// the causal diagonal are skipped. Shared rows are padded to D + 1 floats
// so the strided reads hit distinct banks.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kTile = 64;     // rows of every Q/K/V/dO tile
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr int kPS = kTile + 1;  // padded row of a 64 x 64 f32 tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // K4/K5: dO, strided like q
  const float* lse;     // K4/K5: [BH, Lq]
  const float* di;      // K4/K5: [BH, Lq]
  const float* bias;    // optional f32, strides below
  const float* kvec;    // optional f32 [Bk, Lk]
  const int* seeds;     // optional int32[2] on the device
  void* out0;           // K3: o [B, Lq, H, D]; K4: dq; K5: dk [B, Lk, H, D]
  void* out1;           // K3: lse [BH, Lq] f32; K5: dv
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long do_sb, do_sl, do_sh;
  long long bias_sb, bias_sh, bias_sl;  // 0 on a broadcast axis
  long long kvec_sb;                    // 0 when kvec is [1, Lk]
  int B, H, Lq, Lk, D;
  int causal;
  int dropout;         // 1 when seeds and thresh apply
  unsigned int thresh;  // drop iff hash < thresh
  float inv_keep;
  float scale;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the two separable rounds of dropout_keep: one per query, one per key
__device__ __forceinline__ uint32_t hash_q(uint32_t seed0, int q) {
  return fmix32(seed0 + static_cast<uint32_t>(q) * 2654435761u);
}
__device__ __forceinline__ uint32_t hash_k(uint32_t seed1, int k) {
  return fmix32(seed1 + static_cast<uint32_t>(k) * 0x27D4EB2Fu);
}
__device__ __forceinline__ bool keep(uint32_t hq, uint32_t hk, uint32_t bhm,
                                     uint32_t thresh) {
  return fmix32(hq + hk + bhm) >= thresh;
}

// Reduce over the 16 lanes of a half-warp (the 16 threads of one row).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(ptt::kFullMask, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(ptt::kFullMask, v, o);
  return v;
}

// Stage rows [row0, row0 + 64) of a strided [B, L, H, D] operand at (b, h)
// into shared f32 [64][D + 1]; rows past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int h, int row0, int L,
                                          long long sb, long long sl,
                                          long long sh) {
  constexpr int E = 16 / sizeof(T);
  constexpr int VPR = D / E;  // 16-byte vectors per row
  const T* base = src + b * sb + h * sh;
  for (int i = threadIdx.x; i < kTile * VPR; i += kThreads) {
    const int r = i / VPR, c = (i - r * VPR) * E;
    float* out = dst + r * (D + 1) + c;
    if (row0 + r < L) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(base + (row0 + r) * sl + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < E; ++k) out[k] = ptt::to_f32<T>(e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) out[k] = 0.f;
    }
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] over shared
// [64][D + 1] tiles: one 4 x 4 patch of A . B^T.
template <int D>
__device__ __forceinline__ void patch_abt(float (&acc)[4][4], const float* A,
                                          const float* Bm, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// The logits of the thread's patch, with bias/kvec added and mask applied:
// valid[i][j] says whether (query q0 + ty + 16 i, key k0 + tx + 16 j) is
// seen. s[i][j] holds q . k on entry.
__device__ __forceinline__ void finish_logits(float (&s)[4][4],
                                              bool (&valid)[4][4],
                                              const Params& p, int b, int h,
                                              int q0, int k0, int ty,
                                              int tx) {
  const int offset = p.Lk - p.Lq;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const float* kv = p.kvec ? p.kvec + b * p.kvec_sb : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      bool ok = q < p.Lq && k < p.Lk;
      if (p.causal) ok = ok && k <= q + offset;
      valid[i][j] = ok;
      float x = s[i][j] * p.scale;
      if (ok) {
        if (brow) x += __ldg(brow + q * p.bias_sl + k);
        if (kv) x += __ldg(kv + k);
      }
      s[i][j] = x;
    }
  }
}

// number of k-blocks a q-block [q0, q0 + 64) has to visit
__device__ __forceinline__ int kblocks_for(const Params& p, int q0) {
  int nk = p.Lk;
  if (p.causal) {
    const int q_last = min(q0 + kTile, p.Lq) - 1;
    nk = min(nk, q_last + (p.Lk - p.Lq) + 1);
  }
  return nk <= 0 ? 0 : (nk + kTile - 1) / kTile;
}

// ---------------------------------------------------------------- K3
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(Params p) {
  constexpr int DP = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sP = sV + kTile * DP;  // [64][kPS]
  const int nq = (p.Lq + kTile - 1) / kTile;
  const int bh = blockIdx.x / nq;
  const int qb = nq - 1 - (blockIdx.x - bh * nq);  // longest rows first
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = qb * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  uint32_t s0 = 0, s1 = 0, hq[4];
  if (p.dropout) {
    s0 = static_cast<uint32_t>(p.seeds[0]);
    s1 = static_cast<uint32_t>(p.seeds[1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) hq[i] = hash_q(s0, q0 + ty + 16 * i);
  const uint32_t bhm = static_cast<uint32_t>(bh) * 0x9E3779B9u;

  load_tile<T, D>(sQ, q, b, h, q0, p.Lq, p.q_sb, p.q_sl, p.q_sh);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int nkb = kblocks_for(p, q0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, k, b, h, k0, p.Lk, p.k_sb, p.k_sl, p.k_sh);
    load_tile<T, D>(sV, v, b, h, k0, p.Lk, p.v_sb, p.v_sl, p.v_sh);
    __syncthreads();
    float s[4][4] = {};
    bool valid[4][4];
    patch_abt<D>(s, sQ, sK, ty, tx);
    finish_logits(s, valid, p, b, h, q0, k0, ty, tx);
    uint32_t hk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) hk[j] = hash_k(s1, k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (valid[i][j]) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], half_max(mx));
      // m_new = -inf: no key seen yet, nothing to rescale or add
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = valid[i][j] ? expf(s[i][j] - m_new) : 0.f;
        rs += pr;
        float pe = pr;
        if (p.dropout)
          pe = keep(hq[i], hk[j], bhm, p.thresh) ? pr * p.inv_keep : 0.f;
        sP[(ty + 16 * i) * kPS + tx + 16 * j] = pe;
      }
      l[i] = alpha * l[i] + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc = sP[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
  }
  T* o = static_cast<T*>(p.out0);
  float* lse = static_cast<float*>(p.out1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Lq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * p.Lq + qi) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tx + 16 * j] = ptt::from_f32<T>(acc[i][j] * inv);
    if (tx == 0)
      lse[(long long)bh * p.Lq + qi] =
          m[i] == -INFINITY ? -INFINITY : m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------- K4
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_dq_kernel(Params p) {
  constexpr int DP = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * DP;
  float* sK = sDO + kTile * DP;
  float* sV = sK + kTile * DP;
  float* sDS = sV + kTile * DP;  // [64][kPS]
  const int nq = (p.Lq + kTile - 1) / kTile;
  const int bh = blockIdx.x / nq;
  const int qb = nq - 1 - (blockIdx.x - bh * nq);
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = qb * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  uint32_t s0 = 0, s1 = 0, hq[4];
  if (p.dropout) {
    s0 = static_cast<uint32_t>(p.seeds[0]);
    s1 = static_cast<uint32_t>(p.seeds[1]);
  }
  float lse[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    hq[i] = hash_q(s0, qi);
    lse[i] = qi < p.Lq ? p.lse[(long long)bh * p.Lq + qi] : 0.f;
    di[i] = qi < p.Lq ? p.di[(long long)bh * p.Lq + qi] : 0.f;
  }
  const uint32_t bhm = static_cast<uint32_t>(bh) * 0x9E3779B9u;
  load_tile<T, D>(sQ, static_cast<const T*>(p.q), b, h, q0, p.Lq, p.q_sb,
                  p.q_sl, p.q_sh);
  load_tile<T, D>(sDO, static_cast<const T*>(p.dout), b, h, q0, p.Lq,
                  p.do_sb, p.do_sl, p.do_sh);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const int nkb = kblocks_for(p, q0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();
    load_tile<T, D>(sK, static_cast<const T*>(p.k), b, h, k0, p.Lk, p.k_sb,
                    p.k_sl, p.k_sh);
    load_tile<T, D>(sV, static_cast<const T*>(p.v), b, h, k0, p.Lk, p.v_sb,
                    p.v_sl, p.v_sh);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    bool valid[4][4];
    patch_abt<D>(s, sQ, sK, ty, tx);
    patch_abt<D>(dp, sDO, sV, ty, tx);
    finish_logits(s, valid, p, b, h, q0, k0, ty, tx);
    uint32_t hk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) hk[j] = hash_k(s1, k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = valid[i][j] ? expf(s[i][j] - lse[i]) : 0.f;
        float d = dp[i][j];
        if (p.dropout)
          d = keep(hq[i], hk[j], bhm, p.thresh) ? d * p.inv_keep : 0.f;
        sDS[(ty + 16 * i) * kPS + tx + 16 * j] = pr * (d - di[i]) * p.scale;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kk[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = sK[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsc = sDS[(ty + 16 * i) * kPS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsc, kk[j], acc[i][j]);
      }
    }
  }
  T* dq = static_cast<T*>(p.out0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Lq) continue;
    T* row = dq + (((long long)b * p.Lq + qi) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = ptt::from_f32<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------- K5
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_dkv_kernel(Params p) {
  constexpr int DP = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * DP;
  float* sQ = sV + kTile * DP;
  float* sDO = sQ + kTile * DP;
  float* sP = sDO + kTile * DP;  // p_eff [q][k], [64][kPS]
  float* sDS = sP + kTile * kPS;  // ds [q][k]
  const int nk = (p.Lk + kTile - 1) / kTile;
  const int nq = (p.Lq + kTile - 1) / kTile;
  const int bh = blockIdx.x / nk;
  const int kb = blockIdx.x - bh * nk;  // in causal, low k-blocks do most
  const int b = bh / p.H, h = bh - b * p.H;
  const int k0 = kb * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  uint32_t s0 = 0, s1 = 0, hk[4];
  if (p.dropout) {
    s0 = static_cast<uint32_t>(p.seeds[0]);
    s1 = static_cast<uint32_t>(p.seeds[1]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) hk[j] = hash_k(s1, k0 + tx + 16 * j);
  const uint32_t bhm = static_cast<uint32_t>(bh) * 0x9E3779B9u;
  load_tile<T, D>(sK, static_cast<const T*>(p.k), b, h, k0, p.Lk, p.k_sb,
                  p.k_sl, p.k_sh);
  load_tile<T, D>(sV, static_cast<const T*>(p.v), b, h, k0, p.Lk, p.v_sb,
                  p.v_sl, p.v_sh);
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  // first q-block with a query that sees key k0: q + (Lk - Lq) >= k0
  int qb0 = 0;
  if (p.causal) {
    const int first_q = k0 - (p.Lk - p.Lq);
    qb0 = first_q <= 0 ? 0 : first_q / kTile;
  }
  for (int qb = qb0; qb < nq; ++qb) {
    const int q0 = qb * kTile;
    __syncthreads();
    load_tile<T, D>(sQ, static_cast<const T*>(p.q), b, h, q0, p.Lq, p.q_sb,
                    p.q_sl, p.q_sh);
    load_tile<T, D>(sDO, static_cast<const T*>(p.dout), b, h, q0, p.Lq,
                    p.do_sb, p.do_sl, p.do_sh);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    bool valid[4][4];
    patch_abt<D>(s, sQ, sK, ty, tx);   // rows: queries, columns: keys
    patch_abt<D>(dp, sDO, sV, ty, tx);
    finish_logits(s, valid, p, b, h, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      const bool live = qi < p.Lq;
      const float lse = live ? p.lse[(long long)bh * p.Lq + qi] : 0.f;
      const float di = live ? p.di[(long long)bh * p.Lq + qi] : 0.f;
      const uint32_t hq = hash_q(s0, qi);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = valid[i][j] ? expf(s[i][j] - lse) : 0.f;
        float pe = pr, d = dp[i][j];
        if (p.dropout) {
          const bool kp = keep(hq, hk[j], bhm, p.thresh);
          pe = kp ? pr * p.inv_keep : 0.f;
          d = kp ? d * p.inv_keep : 0.f;
        }
        sP[(ty + 16 * i) * kPS + tx + 16 * j] = pe;
        sDS[(ty + 16 * i) * kPS + tx + 16 * j] = pr * (d - di) * p.scale;
      }
    }
    __syncthreads();
    // thread now owns keys ty + 16 i and head columns tx + 16 j
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float dov[NJ], qv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dov[j] = sDO[r * DP + tx + 16 * j];
        qv[j] = sQ[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pe = sP[r * kPS + ty + 16 * i];
        const float ds = sDS[r * kPS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv[i][j] = fmaf(pe, dov[j], dv[i][j]);
          dk[i][j] = fmaf(ds, qv[j], dk[i][j]);
        }
      }
    }
  }
  T* dkp = static_cast<T*>(p.out0);
  T* dvp = static_cast<T*>(p.out1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.Lk) continue;
    const long long off = (((long long)b * p.Lk + kj) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkp[off + tx + 16 * j] = ptt::from_f32<T>(dk[i][j]);
      dvp[off + tx + 16 * j] = ptt::from_f32<T>(dv[i][j]);
    }
  }
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(const Params& p, int which, cudaStream_t stream) {
  constexpr int DP = D + 1;
  const int nq = (p.Lq + kTile - 1) / kTile;
  const int nk = (p.Lk + kTile - 1) / kTile;
  const long long bh = (long long)p.B * p.H;
  void (*kern)(Params);
  size_t smem;
  long long blocks;
  if (which == kFwd) {
    kern = fa_fwd_kernel<T, D>;
    smem = (3 * kTile * DP + kTile * kPS) * sizeof(float);
    blocks = bh * nq;
  } else if (which == kDq) {
    kern = fa_dq_kernel<T, D>;
    smem = (4 * kTile * DP + kTile * kPS) * sizeof(float);
    blocks = bh * nq;
  } else {
    kern = fa_dkv_kernel<T, D>;
    smem = (4 * kTile * DP + 2 * kTile * kPS) * sizeof(float);
    blocks = bh * nk;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int which, cudaStream_t s) {
  switch (p.D) {
    case 64: return launch<T, 64>(p, which, s);
    case 128: return launch<T, 128>(p, which, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(const void* params, int which, int dtype, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params& p = *static_cast<const Params*>(params);
  switch (dtype) {
    case ptt::kF32: return dispatch_d<float>(p, which, s);
    case ptt::kBF16: return dispatch_d<__nv_bfloat16>(p, which, s);
    case ptt::kF16: return dispatch_d<__half>(p, which, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The three entries take a pointer to one Params (mirrored by a ctypes
// Structure in ops/cuda/flash_attention.py); every output is contiguous.
extern "C" int ptt_flash_fwd(const void* p, int dtype, int device,
                             void* stream) {
  return run(p, kFwd, dtype, device, stream);
}

extern "C" int ptt_flash_dq(const void* p, int dtype, int device,
                            void* stream) {
  return run(p, kDq, dtype, device, stream);
}

extern "C" int ptt_flash_dkv(const void* p, int dtype, int device,
                             void* stream) {
  return run(p, kDkv, dtype, device, stream);
}
