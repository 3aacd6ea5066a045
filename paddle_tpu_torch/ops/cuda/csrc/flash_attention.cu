// K3, K4, K5: flash attention forward, dq and dk/dv for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:
//   K3 _fa_kernel     (forward + per-row logsumexp, launched from
//                      _flash_fwd_bhld, :495),
//   K4 _fa_dq_kernel  (dq by recompute, launched from _flash_bwd_bhld,
//                      :570),
//   K5 _fa_dkv_kernel (dk, dv by recompute, launched from
//                      _flash_bwd_bhld, :605).
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
// D 64, causal) all three are bound by operations on the tensor cores:
// 4 d per visible (query, key) pair for the forward (0.026 ms at 989
// TFLOP/s), 6 d and 8 d for dq and dk/dv; their bytes (q, k, v, o, dO
// once) take about a third of that at 3.35 TB/s. Two designs, chosen by
// the wrapper (`kernel_design`, passed as Params::design): bf16 and f16
// take the tensor-core design in all three kernels at every head dim,
// f32 the CUDA-core design. The library refuses any other pairing: a
// (dtype, head dim, kernel, design) without an instantiation returns
// cudaErrorInvalidValue, and nothing is rerouted.
//
// The tensor-core design (bf16 and f16). Every product is a wgmma with
// f32 accumulators in registers, on tiles that TMA copies into
// 128-byte-swizzled shared memory and completes on mbarriers; one thread
// of a producer warpgroup keeps the copies in flight while the consumer
// warpgroups (64 rows each) compute, so the copies overlap the products
// and the softmax. With two consumer warpgroups the producer hands most
// of its registers to them (setmaxnreg: 24 and 240 a thread); a block of
// one consumer warpgroup (256 threads) has 255 a thread without it. The
// per-element code is branch-free: a branch per element (masks, bias,
// dropout) cost more than the products, so the masks run only on a tile
// that crosses an edge or carries a bias or kvec, and dropout in a pass
// of its own, each chosen once per tile. Tile sizes follow from the
// registers of the accumulators (a 64 x N f32 accumulator takes N / 2
// registers a thread) and from the 227 KB of shared memory a block may
// use:
// - K3: a block owns 128 query rows of one (b, h) (64 when Lq <= 64, one
//   warpgroup: the serving shapes) and walks the key tiles (128 keys; 64
//   at head dim 256, where o takes 128 registers a thread) through a
//   ring of 4, 3 or 2 K/V tiles (head dims 64, 128, 256); k-tiles past
//   the diagonal skipped. The q tiles of one (b, h) are neighbours in
//   the grid, longest rows first, so they run together and read its K/V
//   from L2: with the heads spread over the grid instead, each K/V tile
//   came from device memory once per q tile and the copies, not the
//   products, set the pace. S = Q K^T from shared memory (Q and K
//   K-major); the online softmax in registers, in natural units as the
//   plain version, each exp taken as exp2((x - m) log2 e). log2 e is not
//   folded into the logits: a -1e30 mask must cancel exactly against the
//   row max and lse (a row that sees only masked keys weighs them
//   evenly), and the folded products round the two sides apart. P_eff
//   rounded to q's dtype in registers is the register A operand of O +=
//   P_eff V, V the MN-major B operand read in place. Masks (causal, ragged
//   edges, bias, kvec by __ldg at each accumulator element) only on
//   tiles that cross an edge. o is staged through the warpgroup's own
//   rows of the Q tile and leaves in 16-byte stores.
// - K4: K3's walk and grid order with three products a tile. Q and dO of
//   the block's rows are loaded once and stay; lse and di of a thread's
//   two rows sit in registers. S = Q K^T and dP = dO V^T from shared
//   memory, committed as two groups so P = exp2((s - lse) log2 e) is
//   formed while dP is in flight; dS = P (dP_eff - di) scale, rounded to
//   the operand dtype, is the register A operand of dQ += dS K, the K
//   tile already in shared memory read in place as the MN-major B
//   operand. dQ stays in registers to the epilogue: no atomics, so the
//   result is bit-reproducible. Tiles: head dim 64, 128 rows a block
//   (two warpgroups) x 128 keys, a ring of 4 (dQ + S + dP: 32 + 64 + 64
//   accumulator registers); 128, 128 rows x 64 keys, a ring of 4 (64 +
//   32 + 32: 128 keys would leave 48 of the 240 for everything else); 256,
//   64 rows a block (one warpgroup) x 64 keys, a ring of 2 (128 + 32 +
//   32 of 255): 128 rows would leave room for one K/V stage beside Q and
//   dO (128 KB) and give [2, 1024, 4, 256] 64 blocks for 132 SMs; 64
//   rows give it 128.
// - K5: a block owns 128 keys of one (b, h) (a warpgroup of 64 keys
//   each), K and V loaded once, and walks the query tiles (64 queries;
//   32 at head dim 128) from the first one the causal mask lets see its
//   keys, through a 4-stage ring of Q/dO tiles (the key tiles of one
//   (b, h) neighbours in the grid, low tiles first, as K3's q tiles); the
//   lanes of the producer's first warp put each tile's lse and di into
//   shared memory.
//   S^T = K Q^T and dP^T = V dO^T from shared memory; P^T, P_eff^T and
//   dS^T = P^T (dP_eff^T - di) scale in registers; dV += P_eff^T dO and
//   dK += dS^T Q with P_eff^T and dS^T rounded to the operand dtype as
//   register A operands and dO, Q as MN-major B operands. dK and dV stay
//   in registers to the epilogue; no atomics, so the result is
//   bit-reproducible. At head dim 256 dK and dV of 64 keys take 128 + 128
//   registers a thread, past the 240: the split lane gives a block 64
//   keys and its two consumer warpgroups one accumulator each. Warpgroup
//   0 computes S^T = K Q^T and P^T, hands P^T (f32, before dropout) to
//   warpgroup 1 through one of two 8 KB shared-memory buffers behind
//   named barriers, and computes dV += P_eff^T dO; warpgroup 1 computes
//   dP^T = V dO^T, dS^T from the P^T it reads, and dK += dS^T Q. No
//   product is repeated; a ring of 4 Q/dO tiles of 32 queries.
// Rounding P_eff and dS to the operand dtype before the second product
// is what the TPU kernel does (`p_eff.astype(v.dtype)` :218,
// `ds.astype(k.dtype)` :304, `p_eff.astype(do.dtype)` :383,
// `ds.astype(q.dtype)` :394); K3 rounds P relative to the running max.
// The card checks allow one such rounding per element, carried through
// the second product.
//
// The CUDA-core design (f32 at every head dim: on the tensor cores f32
// would be TF32, not the "highest" f32 the checks hold): each block of
// 256 threads owns one tile of TM rows — (bh, q-block) for K3 and K4,
// (bh, k-block) for K5 — holds it in shared memory as f32 and loops
// sequentially over the other axis, staging TM-row K/V (or Q/dO) tiles
// with plain 16-byte loads, every product a scalar FMA. TM is 64 at head
// dims 64 and 128, and 32 at head dim 256, where four 64-row f32 tiles
// of 257 floats a row (dq, dk/dv: about 280 and 296 KB) exceed the
// 227 KB a block may use. Each thread computes a P x P patch (P = TM /
// 16) of the TM x TM logit tile (rows ty + 16 i, columns tx + 16 j), so
// the row reductions of the online softmax are shuffles inside a
// half-warp. Blocks walk their own axis, so no kernel needs atomics.
// k-blocks past the causal diagonal are skipped. Shared rows are padded
// to D + 1 floats so the strided reads hit distinct banks.
//
// The TMA maps are built on the host in each C entry with the driver's
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no
// -lcuda): a 4-D map over the strided [B, L, H, D] view, whose strides
// the wrapper keeps to multiples of 16 bytes, passed as a
// __grid_constant__ parameter.
#include "common.cuh"
#include "wgmma.cuh"

#include <cuda.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, a P x P patch each

// Rows of every Q/K/V/dO tile at head dim D (see the design note), the
// patch side P of each thread, and the padded row of a TM x TM f32 tile.
template <int D>
struct Tile {
  static constexpr int TM = D > 128 ? 32 : 64;
  static constexpr int P = TM / 16;
  static constexpr int PS = TM + 1;
};

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
  int design;           // Design below: kCudaCores or kTensorCores
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

// Stage rows [row0, row0 + TM) of a strided [B, L, H, D] operand at
// (b, h) into shared f32 [TM][D + 1]; rows past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int h, int row0, int L,
                                          long long sb, long long sl,
                                          long long sh) {
  constexpr int E = 16 / sizeof(T);
  constexpr int VPR = D / E;  // 16-byte vectors per row
  constexpr int TM = Tile<D>::TM;
  const T* base = src + b * sb + h * sh;
  for (int i = threadIdx.x; i < TM * VPR; i += kThreads) {
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
// [TM][D + 1] tiles: one P x P patch of A . B^T.
template <int D, int P>
__device__ __forceinline__ void patch_abt(float (&acc)[P][P], const float* A,
                                          const float* Bm, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[P], bv[P];
#pragma unroll
    for (int i = 0; i < P; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < P; ++j) bv[j] = Bm[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// The logits of the thread's patch, with bias/kvec added and mask applied:
// valid[i][j] says whether (query q0 + ty + 16 i, key k0 + tx + 16 j) is
// seen. s[i][j] holds q . k on entry.
template <int P>
__device__ __forceinline__ void finish_logits(float (&s)[P][P],
                                              bool (&valid)[P][P],
                                              const Params& p, int b, int h,
                                              int q0, int k0, int ty,
                                              int tx) {
  const int offset = p.Lk - p.Lq;
  const float* brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh
                             : nullptr;
  const float* kv = p.kvec ? p.kvec + b * p.kvec_sb : nullptr;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int q = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < P; ++j) {
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

// number of key tiles of `bn` keys that queries [q0, q0 + rows) visit
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int rows,
                                         int bn) {
  int nk = p.Lk;
  if (p.causal) {
    const int q_last = min(q0 + rows, p.Lq) - 1;
    nk = min(nk, q_last + (p.Lk - p.Lq) + 1);
  }
  return nk <= 0 ? 0 : (nk + bn - 1) / bn;
}

// ---------------------------------------------------------------- K3
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(Params p) {
  constexpr int DP = D + 1, NJ = D / 16;
  constexpr int TM = Tile<D>::TM, P = Tile<D>::P, PS = Tile<D>::PS;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + TM * DP;
  float* sV = sK + TM * DP;
  float* sP = sV + TM * DP;  // [TM][PS]
  const int nq = (p.Lq + TM - 1) / TM;
  const int bh = blockIdx.x / nq;
  const int qb = nq - 1 - (blockIdx.x - bh * nq);  // longest rows first
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = qb * TM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  uint32_t s0 = 0, s1 = 0, hq[P];
  if (p.dropout) {
    s0 = static_cast<uint32_t>(p.seeds[0]);
    s1 = static_cast<uint32_t>(p.seeds[1]);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) hq[i] = hash_q(s0, q0 + ty + 16 * i);
  const uint32_t bhm = static_cast<uint32_t>(bh) * 0x9E3779B9u;

  load_tile<T, D>(sQ, q, b, h, q0, p.Lq, p.q_sb, p.q_sl, p.q_sh);
  float m[P], l[P], acc[P][NJ];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int nkb = key_tiles(p, q0, TM, TM);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * TM;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, k, b, h, k0, p.Lk, p.k_sb, p.k_sl, p.k_sh);
    load_tile<T, D>(sV, v, b, h, k0, p.Lk, p.v_sb, p.v_sl, p.v_sh);
    __syncthreads();
    float s[P][P] = {};
    bool valid[P][P];
    patch_abt<D>(s, sQ, sK, ty, tx);
    finish_logits(s, valid, p, b, h, q0, k0, ty, tx);
    uint32_t hk[P];
#pragma unroll
    for (int j = 0; j < P; ++j) hk[j] = hash_k(s1, k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (valid[i][j]) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], half_max(mx));
      // m_new = -inf: no key seen yet, nothing to rescale or add
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float pr = valid[i][j] ? expf(s[i][j] - m_new) : 0.f;
        rs += pr;
        float pe = pr;
        if (p.dropout)
          pe = keep(hq[i], hk[j], bhm, p.thresh) ? pr * p.inv_keep : 0.f;
        sP[(ty + 16 * i) * PS + tx + 16 * j] = pe;
      }
      l[i] = alpha * l[i] + half_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TM; ++c) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float pc = sP[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
  }
  T* o = static_cast<T*>(p.out0);
  float* lse = static_cast<float*>(p.out1);
#pragma unroll
  for (int i = 0; i < P; ++i) {
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
  constexpr int TM = Tile<D>::TM, P = Tile<D>::P, PS = Tile<D>::PS;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + TM * DP;
  float* sK = sDO + TM * DP;
  float* sV = sK + TM * DP;
  float* sDS = sV + TM * DP;  // [TM][PS]
  const int nq = (p.Lq + TM - 1) / TM;
  const int bh = blockIdx.x / nq;
  const int qb = nq - 1 - (blockIdx.x - bh * nq);
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = qb * TM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  uint32_t s0 = 0, s1 = 0, hq[P];
  if (p.dropout) {
    s0 = static_cast<uint32_t>(p.seeds[0]);
    s1 = static_cast<uint32_t>(p.seeds[1]);
  }
  float lse[P], di[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
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
  float acc[P][NJ];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const int nkb = key_tiles(p, q0, TM, TM);
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * TM;
    __syncthreads();
    load_tile<T, D>(sK, static_cast<const T*>(p.k), b, h, k0, p.Lk, p.k_sb,
                    p.k_sl, p.k_sh);
    load_tile<T, D>(sV, static_cast<const T*>(p.v), b, h, k0, p.Lk, p.v_sb,
                    p.v_sl, p.v_sh);
    __syncthreads();
    float s[P][P] = {}, dp[P][P] = {};
    bool valid[P][P];
    patch_abt<D>(s, sQ, sK, ty, tx);
    patch_abt<D>(dp, sDO, sV, ty, tx);
    finish_logits(s, valid, p, b, h, q0, k0, ty, tx);
    uint32_t hk[P];
#pragma unroll
    for (int j = 0; j < P; ++j) hk[j] = hash_k(s1, k0 + tx + 16 * j);
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float pr = valid[i][j] ? expf(s[i][j] - lse[i]) : 0.f;
        float d = dp[i][j];
        if (p.dropout)
          d = keep(hq[i], hk[j], bhm, p.thresh) ? d * p.inv_keep : 0.f;
        sDS[(ty + 16 * i) * PS + tx + 16 * j] = pr * (d - di[i]) * p.scale;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TM; ++c) {
      float kk[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = sK[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float dsc = sDS[(ty + 16 * i) * PS + c];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dsc, kk[j], acc[i][j]);
      }
    }
  }
  T* dq = static_cast<T*>(p.out0);
#pragma unroll
  for (int i = 0; i < P; ++i) {
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
  constexpr int TM = Tile<D>::TM, P = Tile<D>::P, PS = Tile<D>::PS;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + TM * DP;
  float* sQ = sV + TM * DP;
  float* sDO = sQ + TM * DP;
  float* sP = sDO + TM * DP;  // p_eff [q][k], [TM][PS]
  float* sDS = sP + TM * PS;  // ds [q][k]
  const int nk = (p.Lk + TM - 1) / TM;
  const int nq = (p.Lq + TM - 1) / TM;
  const int bh = blockIdx.x / nk;
  const int kb = blockIdx.x - bh * nk;  // in causal, low k-blocks do most
  const int b = bh / p.H, h = bh - b * p.H;
  const int k0 = kb * TM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  uint32_t s0 = 0, s1 = 0, hk[P];
  if (p.dropout) {
    s0 = static_cast<uint32_t>(p.seeds[0]);
    s1 = static_cast<uint32_t>(p.seeds[1]);
  }
#pragma unroll
  for (int j = 0; j < P; ++j) hk[j] = hash_k(s1, k0 + tx + 16 * j);
  const uint32_t bhm = static_cast<uint32_t>(bh) * 0x9E3779B9u;
  load_tile<T, D>(sK, static_cast<const T*>(p.k), b, h, k0, p.Lk, p.k_sb,
                  p.k_sl, p.k_sh);
  load_tile<T, D>(sV, static_cast<const T*>(p.v), b, h, k0, p.Lk, p.v_sb,
                  p.v_sl, p.v_sh);
  float dk[P][NJ], dv[P][NJ];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  // first q-block with a query that sees key k0: q + (Lk - Lq) >= k0
  int qb0 = 0;
  if (p.causal) {
    const int first_q = k0 - (p.Lk - p.Lq);
    qb0 = first_q <= 0 ? 0 : first_q / TM;
  }
  for (int qb = qb0; qb < nq; ++qb) {
    const int q0 = qb * TM;
    __syncthreads();
    load_tile<T, D>(sQ, static_cast<const T*>(p.q), b, h, q0, p.Lq, p.q_sb,
                    p.q_sl, p.q_sh);
    load_tile<T, D>(sDO, static_cast<const T*>(p.dout), b, h, q0, p.Lq,
                    p.do_sb, p.do_sl, p.do_sh);
    __syncthreads();
    float s[P][P] = {}, dp[P][P] = {};
    bool valid[P][P];
    patch_abt<D>(s, sQ, sK, ty, tx);   // rows: queries, columns: keys
    patch_abt<D>(dp, sDO, sV, ty, tx);
    finish_logits(s, valid, p, b, h, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int qi = q0 + ty + 16 * i;
      const bool live = qi < p.Lq;
      const float lse = live ? p.lse[(long long)bh * p.Lq + qi] : 0.f;
      const float di = live ? p.di[(long long)bh * p.Lq + qi] : 0.f;
      const uint32_t hq = hash_q(s0, qi);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float pr = valid[i][j] ? expf(s[i][j] - lse) : 0.f;
        float pe = pr, d = dp[i][j];
        if (p.dropout) {
          const bool kp = keep(hq, hk[j], bhm, p.thresh);
          pe = kp ? pr * p.inv_keep : 0.f;
          d = kp ? d * p.inv_keep : 0.f;
        }
        sP[(ty + 16 * i) * PS + tx + 16 * j] = pe;
        sDS[(ty + 16 * i) * PS + tx + 16 * j] = pr * (d - di) * p.scale;
      }
    }
    __syncthreads();
    // thread now owns keys ty + 16 i and head columns tx + 16 j
#pragma unroll 4
    for (int r = 0; r < TM; ++r) {
      float dov[NJ], qv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        dov[j] = sDO[r * DP + tx + 16 * j];
        qv[j] = sQ[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float pe = sP[r * PS + ty + 16 * i];
        const float ds = sDS[r * PS + ty + 16 * i];
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
  for (int i = 0; i < P; ++i) {
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

// ============================== the tensor-core design (K3, K4, K5)
// bf16 and f16 only: wgmma on tiles that TMA brings into a ring of
// 128-byte-swizzled shared-memory tiles (see the header note).
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one box of a 4-D tensor map, coordinates innermost first
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// rows [row0, row0 + rows) of (b, h) of a [B, L, H, D] map into a tile
// of D / 64 chunks of rows x 128 bytes, completing on `bar`
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int row0,
                                          int h, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(dst + c * rows * 128, map, bar, 64 * c, h, row0, b);
}

// wgmma matrix descriptor of a 128-byte-swizzled tile at `ptr`: lbo and
// sbo in bytes (K-major: sbo = 1024, the stride of 8-row groups, lbo
// unused; MN-major: lbo = the stride of 64-column chunks, sbo = 1024)
__device__ __forceinline__ uint64_t desc(const void* ptr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(ptr) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads of wgmma registers across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Registers a thread of a warpgroup may hold: a block of two consumer
// warpgroups and a producer warpgroup starts at 168 (65536 / 384); the
// producer gives most of its share to the consumers' accumulators.
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
template <bool INC, int N>
__device__ __forceinline__ void set_max_regs() {
  if (INC)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barriers: 0 is __syncthreads; 1 + wg a consumer warpgroup's
// epilogue; K5's split lane hands P^T over through two buffers, each with
// a full and an empty barrier.
constexpr int kExchangeFull = 3, kExchangeEmpty = 5;
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-bit element (row, col) in a tile of `rows` rows kept
// as D / 64 chunks of rows x 128 bytes, 128-byte swizzled: the layout
// CU_TENSOR_MAP_SWIZZLE_128B gives each TMA box
__device__ __forceinline__ uint32_t sw128(int row, int col, int rows) {
  return (col >> 6) * rows * 128 + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// Element i of an m64nN f32 accumulator of thread t (0..127) of a
// warpgroup sits at row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (t % 4) + i % 2. Two consecutive elements (i
// even) are one row's neighbours, and the eight elements 8c..8c+7 are
// the m64k16 register fragment of columns 16c..16c+15 when packed in
// pairs (pack2): P and dS feed the next product straight from registers.
__device__ __forceinline__ int acc_row(int i, int t) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// acc[64 x N] = A[64 x D] . B[N x D]^T, both K-major tiles in shared
// memory: `a` at the warpgroup's first row of a tile of `a_rows` rows,
// `bm` a tile of N rows. Issued, not committed.
template <typename T, int D, int N>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2],
                                           const uint8_t* a, int a_rows,
                                           const uint8_t* bm) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk >> 2, ob = (kk & 3) * 32;
    ptt::wg::SS<T, N, 0>::run(acc, desc(a + c * a_rows * 128 + ob, 16, 1024),
                              desc(bm + c * N * 128 + ob, 16, 1024), kk);
  }
}

// acc[64 x D] += frag[64 x K] . B[K x D]: frag the register A operand,
// B the MN-major tile of K rows at `bm` read in place. Issued, not
// committed.
template <typename T, int D, int K>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                           const uint32_t (&frag)[K / 16][4],
                                           const uint8_t* bm) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc)
    ptt::wg::RS<T, D, 1>::run(acc, frag[kc],
                              desc(bm + kc * 16 * 128, K * 128, 1024), 1);
}

// an m64nN f32 accumulator rounded to T as N / 16 register A fragments
template <typename T, int N>
__device__ __forceinline__ void to_frag(uint32_t (&frag)[N / 16][4],
                                        const float (&acc)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    frag[i >> 3][(i >> 1) & 3] = pack2<T>(acc[i], acc[i + 1]);
}

// A warpgroup's 64 x D accumulator, row r scaled by mul[(r / 8) % 2], as
// T into rows [r0, r0 + 64) of a swizzled tile of `rows` rows, then
// those rows out to rows [g0, g0 + 64) of the contiguous [B, L, H, D]
// tensor `out` (rows past L are not written), 16 bytes a thread.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const float (&mul)[2],
                                           uint8_t* tile, int rows, int r0,
                                           int wg, T* out, int b, int g0,
                                           int L, int H, int h) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = r0 + acc_row(i, t);
    const float s = mul[(i >> 1) & 1];
    *reinterpret_cast<uint32_t*>(tile + sw128(r, acc_col(i, t), rows)) =
        pack2<T>(acc[i] * s, acc[i + 1] * s);
  }
  named_sync(1 + wg, 128);
  constexpr int CPR = D / 8;  // 16-byte chunks in a row
  for (int idx = t; idx < 64 * CPR; idx += 128) {
    const int r = idx / CPR, c = (idx - r * CPR) * 8;
    if (g0 + r >= L) break;  // rows ascend with idx
    const uint4 v =
        *reinterpret_cast<const uint4*>(tile + sw128(r0 + r, c, rows));
    *reinterpret_cast<uint4*>(out + (((long long)b * L + g0 + r) * H + h) *
                                        D + c) = v;
  }
}

// The producer of K3 and K4: one thread keeps a ring of S stages of K and
// V tiles of BN rows in flight, stage s refilled once every consumer has
// arrived on empty[s].
template <int D, int BN, int S>
__device__ __forceinline__ void produce_kv_ring(uint8_t* sKV,
                                                const CUtensorMap* tm_k,
                                                const CUtensorMap* tm_v,
                                                uint64_t* full,
                                                uint64_t* empty, int nkt,
                                                int h, int b) {
  constexpr int KV_BYTES = BN * D * 2;  // one of K, V
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % S;
    mbar_wait(empty + s, ((kt / S) & 1) ^ 1);
    mbar_expect_tx(full + s, 2 * KV_BYTES);
    uint8_t* sk = sKV + s * 2 * KV_BYTES;
    load_rows<D>(sk, tm_k, full + s, BN, kt * BN, h, b);
    load_rows<D>(sk + KV_BYTES, tm_v, full + s, BN, kt * BN, h, b);
  }
}

// The logits of a warpgroup's 64 x BN tile of S = Q K^T (queries from qw,
// the thread's rows row_a and row_a + 8; keys from k0) in place: scaled,
// plus bias and kvec, -inf where masked. The per-element code is
// branch-free (a branch per element costs more than the rest); the masks
// run only on a tile that crosses an edge or carries a bias or kvec, a
// condition uniform over the warpgroup. An edge tile without bias or
// kvec (the causal diagonal) compares each column with its row's last
// visible key, one compare an element: the full mask's index arithmetic
// beside K4's in-flight dP spilled registers.
template <int BN>
__device__ __forceinline__ void tile_logits(float (&acc)[BN / 2],
                                            const Params& p,
                                            const float* brow,
                                            const float* kv, int qw,
                                            int row_a, int k0, int t) {
  const int off = p.Lk - p.Lq;
  const bool edge = k0 + BN > p.Lk || qw + 64 > p.Lq ||
                    (p.causal && k0 + BN - 1 > qw + off);
  if (edge && !brow && !kv) {
    // element i sits at column c0 + 8 (i / 4) + i % 2: seen iff that is
    // at most lim of its row (-1: a row past Lq sees nothing)
    const int c0 = k0 + 2 * (t & 3);
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row_a + 8 * r;
      const int last = p.causal ? min(q + off, p.Lk - 1) : p.Lk - 1;
      lim[r] = q < p.Lq ? max(last - c0, -1) : -1;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      acc[i] = 8 * (i >> 2) + (i & 1) <= lim[(i >> 1) & 1]
                   ? acc[i] * p.scale : -INFINITY;
  } else if (edge || brow || kv) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int q = row_a + 8 * ((i >> 1) & 1);
      const int k = k0 + acc_col(i, t);
      const bool ok = q < p.Lq && k < p.Lk && (!p.causal || k <= q + off);
      // clamped indices: every load is in bounds, masked ones unused
      const int qc = min(q, p.Lq - 1), kc = min(k, p.Lk - 1);
      float x = acc[i] * p.scale;
      if (brow) x += __ldg(brow + qc * p.bias_sl + kc);
      if (kv) x += __ldg(kv + kc);
      acc[i] = ok ? x : -INFINITY;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] *= p.scale;
  }
}

// What every K3/K4 consumer thread knows of its two query rows (row_a
// and row_a + 8): the bias row and kvec of (b, h), the rows' dropout
// hashes and the seeds.
struct QueryRows {
  const float* brow;
  const float* kv;
  uint32_t hq[2];
  uint32_t s1 = 0, bhm;
  __device__ QueryRows(const Params& p, int b, int h, int bh, int row_a) {
    brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
    kv = p.kvec ? p.kvec + b * p.kvec_sb : nullptr;
    uint32_t s0 = 0;
    if (p.dropout) {
      s0 = static_cast<uint32_t>(p.seeds[0]);
      s1 = static_cast<uint32_t>(p.seeds[1]);
    }
    hq[0] = hash_q(s0, row_a);
    hq[1] = hash_q(s0, row_a + 8);
    bhm = static_cast<uint32_t>(bh) * 0x9E3779B9u;
  }
  // whether the weight at (the thread's row r, key k) survives dropout
  __device__ __forceinline__ bool kept(const Params& p, int r, int k) const {
    return keep(hq[r], hash_k(s1, k), bhm, p.thresh);
  }
};

// ------------------------------------------------------- K3, forward
// BM = 64 NWG query rows a block (a warpgroup of 64 rows each), BN keys
// a tile (128; 64 at head dim 256), a ring of STAGES K/V tiles: as many
// as shared memory holds (4, 3, 2 at head dims 64, 128, 256), so the
// copies run ahead of a tile's products by more than a copy's latency.
template <int D, int NWG>
struct Fwd {
  static constexpr int BM = 64 * NWG;
  static constexpr int BN = D > 128 ? 64 : 128;
  static constexpr int STAGES = D == 64 ? 4 : D == 128 ? 3 : 2;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // one of K, V
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <typename T, int D, int NWG>
__global__ void __launch_bounds__(Fwd<D, NWG>::THREADS, 1)
    fa_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  using C = Fwd<D, NWG>;
  constexpr int BM = C::BM, BN = C::BN, S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sKV = sQ + C::Q_BYTES;  // stage s: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + S * 2 * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  // the q tiles of one (b, h) are neighbours in the grid, longest rows
  // first: they run together and read its K/V tiles from L2
  const int nq = (p.Lq + BM - 1) / BM;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x - bh * nq)) * BM;
  const int b = bh / p.H, h = bh - b * p.H;
  const int nkt = key_tiles(p, q0, BM, BN);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == NWG) {  // the producer warpgroup: one thread issues every copy
    if (NWG == 2) set_max_regs<false, kProducerRegs>();
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      load_rows<D>(sQ, &tm_q, q_full, BM, q0, h, b);
      produce_kv_ring<D, BN, S>(sKV, &tm_k, &tm_v, full, empty, nkt, h, b);
    }
    return;
  }
  if (NWG == 2) set_max_regs<true, kConsumerRegs>();
  const int t = threadIdx.x & 127;
  const int qw = q0 + 64 * wg;  // the warpgroup's first query
  const int row_a = qw + acc_row(0, t);  // the thread's rows: +0 and +8
  const int nkt_wg = qw < p.Lq ? key_tiles(p, qw, 64, BN) : 0;
  const QueryRows qr(p, b, h, bh, row_a);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % S;
    mbar_wait(full + s, (kt / S) & 1);
    if (kt < nkt_wg) {
      const uint8_t* sk = sKV + s * 2 * C::KV_BYTES;
      const uint8_t* sv = sk + C::KV_BYTES;
      float acc[BN / 2];
      wg_fence();
      ss_product<T, D, BN>(acc, sQ + wg * 64 * 128, BM, sk);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      const int k0 = kt * BN;
      tile_logits<BN>(acc, p, qr.brow, qr.kv, qw, row_a, k0, t);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i]);
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(ptt::kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(ptt::kFullMask, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        mu[r] = mn == -INFINITY ? 0.f : mn;  // no key seen yet: p = 0
        alpha[r] = exp2f((m[r] - mu[r]) * kLog2e);
        m[r] = mn;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = exp2f((acc[i] - mu[(i >> 1) & 1]) * kLog2e);
        rs[(i >> 1) & 1] += acc[i];
      }
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          acc[i] = qr.kept(p, (i >> 1) & 1, k0 + acc_col(i, t))
                       ? acc[i] * p.inv_keep : 0.f;
        }
      }
      uint32_t pa[BN / 16][4];  // P_eff rounded to T
      to_frag<T, BN>(pa, acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      wg_fence();
      rs_product<T, D, BN>(o, pa, sv);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }
    mbar_arrive(empty + s);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // l was summed over the thread's columns
    l[r] += __shfl_xor_sync(ptt::kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(ptt::kFullMask, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  if ((t & 3) == 0) {
    float* lse = static_cast<float*>(p.out1) + (long long)bh * p.Lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row_a + 8 * r;
      if (q < p.Lq)
        lse[q] = m[r] == -INFINITY ? -INFINITY
                                   : m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
  // sQ's rows of this warpgroup are read by no one now: stage o there
  store_rows<T, D>(o, inv, sQ, BM, 64 * wg, wg, static_cast<T*>(p.out0), b,
                   qw, p.Lq, p.H, h);
}

// ------------------------------------------------------------ K4, dq
// BM = 64 NWG query rows a block, Q and dO loaded once; BN keys a tile
// through a ring of STAGES K/V tiles (see the header note for the sizes
// per head dim and why). flash_tile_sweep.py timed the alternatives on
// the H100: 128-row blocks at head dim 256 took 1.7x as long; 128-key
// tiles at head dim 128 (two stages, 192 accumulator registers) came
// within 2 % of 64-key tiles, which keep four stages and 64 registers
// more room. Registers a thread and spill stores as ptxas -v reports
// them (chip_smoke.py's phase 1 prints them; bf16 and f16 alike), and
// the dynamic shared memory a block asks for (Dq::SMEM):
// - head dim 64:  168 at launch, 240 a consumer after setmaxnreg;
//                 164936 bytes; 88 bytes of spill stores;
// - head dim 128: 168 / 240; 197704 bytes; 48 bytes of spill stores;
// - head dim 256: 255 (one consumer warpgroup, no setmaxnreg); 197672
//                 bytes; 44 bytes of spill stores.
// The spills are not 0: the accumulators hold 160-208 of the registers,
// and the SASS shows the stores around the bias/kvec mask path (its 64
// per-element loads beside the in-flight dP) and a few loop-carried
// scalars reloaded from L1 once per key tile. K3 spills alike (80-112
// bytes); removing them is left open.
template <int D>
struct Dq {
  static constexpr int NWG = D > 128 ? 1 : 2;
  static constexpr int BM = 64 * NWG;
  static constexpr int BN = D == 64 ? 128 : 64;
  static constexpr int STAGES = D > 128 ? 2 : 4;
  static constexpr int Q_BYTES = BM * D * 2;   // one of Q, dO
  static constexpr int KV_BYTES = BN * D * 2;  // one of K, V
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <typename T, int D>
__global__ void __launch_bounds__(Dq<D>::THREADS, 1)
    fa_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const Params p) {
  using C = Dq<D>;
  constexpr int NWG = C::NWG, BM = C::BM, BN = C::BN, S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sDO = sQ + C::Q_BYTES;
  uint8_t* sKV = sDO + C::Q_BYTES;  // stage s: K, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + S * 2 * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  // the grid order of K3: the q tiles of one (b, h) neighbours, longest
  // rows first, so they read its K/V tiles from L2
  const int nq = (p.Lq + BM - 1) / BM;
  const int bh = blockIdx.x / nq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x - bh * nq)) * BM;
  const int b = bh / p.H, h = bh - b * p.H;
  const int nkt = key_tiles(p, q0, BM, BN);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == NWG) {  // the producer warpgroup: one thread issues every copy
    if (NWG == 2) set_max_regs<false, kProducerRegs>();
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
      load_rows<D>(sQ, &tm_q, q_full, BM, q0, h, b);
      load_rows<D>(sDO, &tm_do, q_full, BM, q0, h, b);
      produce_kv_ring<D, BN, S>(sKV, &tm_k, &tm_v, full, empty, nkt, h, b);
    }
    return;
  }
  if (NWG == 2) set_max_regs<true, kConsumerRegs>();
  const int t = threadIdx.x & 127;
  const int qw = q0 + 64 * wg;  // the warpgroup's first query
  const int row_a = qw + acc_row(0, t);  // the thread's rows: +0 and +8
  const int nkt_wg = qw < p.Lq ? key_tiles(p, qw, 64, BN) : 0;
  const QueryRows qr(p, b, h, bh, row_a);
  // lse (-inf, a query that sees no key, as 0: its p is 0 through the
  // mask, as in the plain version) and di of the thread's two rows
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row_a + 8 * r;
    const long long at = (long long)bh * p.Lq + min(q, p.Lq - 1);
    const float x = q < p.Lq ? p.lse[at] : 0.f;
    lse[r] = isfinite(x) ? x : 0.f;
    di[r] = q < p.Lq ? p.di[at] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % S;
    mbar_wait(full + s, (kt / S) & 1);
    if (kt < nkt_wg) {
      const uint8_t* sk = sKV + s * 2 * C::KV_BYTES;
      const uint8_t* sv = sk + C::KV_BYTES;
      // S = Q K^T and dP = dO V^T, two groups: P is formed while dP
      // is still in flight
      float st[BN / 2], dp[BN / 2];
      wg_fence();
      ss_product<T, D, BN>(st, sQ + wg * 64 * 128, BM, sk);
      wg_commit();
      ss_product<T, D, BN>(dp, sDO + wg * 64 * 128, BM, sv);
      wg_commit();
      wg_wait<1>();
      fence_regs(st);
      const int k0 = kt * BN;
      tile_logits<BN>(st, p, qr.brow, qr.kv, qw, row_a, k0, t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)  // a masked -inf gives p = 0
        st[i] = exp2f((st[i] - lse[(i >> 1) & 1]) * kLog2e);
      wg_wait<0>();
      fence_regs(dp);
      // dS = P (dP_eff - di) scale into dp
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i >> 1) & 1;
          const float d = qr.kept(p, r, k0 + acc_col(i, t))
                              ? dp[i] * p.inv_keep : 0.f;
          dp[i] = st[i] * (d - di[r]) * p.scale;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          dp[i] = st[i] * (dp[i] - di[(i >> 1) & 1]) * p.scale;
      }
      uint32_t da[BN / 16][4];  // dS rounded to T, the A operand of dQ
      to_frag<T, BN>(da, dp);
      wg_fence();
      rs_product<T, D, BN>(dq, da, sk);  // K read in place, MN-major
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
      fence_regs(da);
    }
    mbar_arrive(empty + s);
  }
  // sQ's rows of this warpgroup are read by no one now: stage dq there
  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(dq, one, sQ, BM, 64 * wg, wg, static_cast<T*>(p.out0), b,
                   qw, p.Lq, p.H, h);
}

// ------------------------------------------------------ K5, dk and dv
// BK = 128 keys a block (two warpgroups of 64), BQ queries a tile (64;
// 32 at head dim 128, where dK and dV take 128 registers a thread), a
// ring of STAGES Q/dO tiles with their lse and di. At head dim 256 dK
// and dV of 64 keys take 256 registers a thread: the split lane below.
template <int D>
struct Dkv {
  static constexpr int BK = 128;
  static constexpr int BQ = D > 64 ? 32 : 64;
  static constexpr int STAGES = 4;
  static constexpr int KV_BYTES = BK * D * 2;  // one of K, V
  static constexpr int QD_BYTES = BQ * D * 2;  // one of Q, dO
  static constexpr int THREADS = 3 * 128;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES +
                              STAGES * (2 * QD_BYTES + 2 * BQ * 4) +
                              8 * (1 + 2 * STAGES);
};

// The split lane of K5 (head dim 256): BK = 64 keys a block, both
// consumer warpgroups on the same keys, one holding dV and one dK (128
// registers a thread each); P^T crosses between them through two
// exchange buffers of BK x BQ f32. 64 keys give [2, 1024, 4, 256] 128
// blocks, one wave of 132 SMs; 32 queries a tile keep 4 Q/dO stages in
// shared memory. ptxas -v (chip_smoke.py's phase 1): 168 registers at
// launch, 240 a consumer after setmaxnreg, 0 bytes of spill stores (bf16
// and f16); 215112 bytes of dynamic shared memory (DkvSplit::SMEM).
template <int D>
struct DkvSplit {
  static constexpr int BK = 64;
  static constexpr int BQ = 32;
  static constexpr int STAGES = 4;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int QD_BYTES = BQ * D * 2;
  static constexpr int X_FLOATS = BK * BQ;  // one exchange buffer
  static constexpr int THREADS = 3 * 128;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES +
                              STAGES * (2 * QD_BYTES + 2 * BQ * 4) +
                              2 * X_FLOATS * 4 + 8 * (1 + 2 * STAGES);
};

// The producer of K5, the first warp of the producer warpgroup: K and V
// of the block's BK keys once, then a ring of S stages of Q/dO tiles of
// BQ rows from q tile qt_first on, with their lse (-inf as 0, as in the
// plain version) and di written by the lanes; one lane issues the copies.
template <int D, int BK, int BQ, int S>
__device__ __forceinline__ void produce_qdo_ring(
    uint8_t* sK, uint8_t* sV, uint8_t* sQD, float* sL, float* sDi,
    const CUtensorMap* tm_q, const CUtensorMap* tm_k,
    const CUtensorMap* tm_v, const CUtensorMap* tm_do, uint64_t* kv_full,
    uint64_t* full, uint64_t* empty, const Params& p, int bh, int k0,
    int qt_first, int nqt, int h, int b) {
  constexpr int KV_BYTES = BK * D * 2, QD_BYTES = BQ * D * 2;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_expect_tx(kv_full, 2 * KV_BYTES);
    load_rows<D>(sK, tm_k, kv_full, BK, k0, h, b);
    load_rows<D>(sV, tm_v, kv_full, BK, k0, h, b);
  }
  for (int it = 0, qt = qt_first; qt < nqt; ++it, ++qt) {
    const int s = it % S, q0 = qt * BQ;
    mbar_wait(empty + s, ((it / S) & 1) ^ 1);
    for (int j = lane; j < BQ; j += 32) {
      const bool live = q0 + j < p.Lq;
      const long long at = (long long)bh * p.Lq + q0 + j;
      const float x = live ? p.lse[at] : 0.f;
      sL[s * BQ + j] = isfinite(x) ? x : 0.f;
      sDi[s * BQ + j] = live ? p.di[at] : 0.f;
    }
    if (lane == 0) {
      mbar_expect_tx(full + s, 2 * QD_BYTES);
      uint8_t* sq = sQD + s * 2 * QD_BYTES;
      load_rows<D>(sq, tm_q, full + s, BQ, q0, h, b);
      load_rows<D>(sq + QD_BYTES, tm_do, full + s, BQ, q0, h, b);
    } else {
      mbar_arrive(full + s);
    }
  }
}

// S^T -> P^T in place for a warpgroup's 64 keys from kw (the thread's
// keys key_a and key_a + 8, their kvec kvk) x BQ queries from q0,
// branch-free per element; the masks only on a tile that crosses an
// edge or carries a bias (see tile_logits). lse: the tile's, in shared
// memory.
template <int BQ>
__device__ __forceinline__ void probs_t(float (&st)[BQ / 2], const Params& p,
                                        const float* brow,
                                        const float (&kvk)[2],
                                        const float* lse, int kw, int key_a,
                                        int q0, int t) {
  const int off = p.Lk - p.Lq;
  const bool edge = kw + 64 > p.Lk || q0 + BQ > p.Lq ||
                    (p.causal && kw + 63 > q0 + off);
  if (edge || brow) {
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int r = (i >> 1) & 1, key = key_a + 8 * r;
      const int j = acc_col(i, t), q = q0 + j;
      const bool ok = q < p.Lq && key < p.Lk &&
                      (!p.causal || key <= q + off);
      const int qc = min(q, p.Lq - 1), kc = min(key, p.Lk - 1);
      float x = st[i] * p.scale + kvk[r];
      if (brow) x += __ldg(brow + qc * p.bias_sl + kc);
      st[i] = ok ? exp2f((x - lse[j]) * kLog2e) : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      st[i] = exp2f((st[i] * p.scale + kvk[(i >> 1) & 1] -
                     lse[acc_col(i, t)]) * kLog2e);
  }
}

// What every K5 consumer thread knows of its two keys (key_a and key_a +
// 8): the bias row of (b, h), the keys' kvec and dropout hashes, and the
// seeds (QueryRows' counterpart).
struct KeyRows {
  const float* brow;
  float kvk[2] = {0.f, 0.f};
  uint32_t hk[2];
  uint32_t s0 = 0, bhm;
  __device__ KeyRows(const Params& p, int b, int h, int bh, int key_a) {
    brow = p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
    const float* kv = p.kvec ? p.kvec + b * p.kvec_sb : nullptr;
    uint32_t s1 = 0;
    if (p.dropout) {
      s0 = static_cast<uint32_t>(p.seeds[0]);
      s1 = static_cast<uint32_t>(p.seeds[1]);
    }
    hk[0] = hash_k(s1, key_a);
    hk[1] = hash_k(s1, key_a + 8);
    bhm = static_cast<uint32_t>(bh) * 0x9E3779B9u;
    if (kv) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        kvk[r] = key_a + 8 * r < p.Lk ? __ldg(kv + key_a + 8 * r) : 0.f;
    }
  }
  // whether the weight at (query q, the thread's key r) survives dropout
  __device__ __forceinline__ bool kept(const Params& p, int q, int r) const {
    return keep(hash_q(s0, q), hk[r], bhm, p.thresh);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Dkv<D>::THREADS, 1)
    fa_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const Params p) {
  using C = Dkv<D>;
  constexpr int BK = C::BK, BQ = C::BQ, S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + C::KV_BYTES;
  uint8_t* sQD = sV + C::KV_BYTES;  // stage s: Q, then dO
  float* sL = reinterpret_cast<float*>(sQD + S * 2 * C::QD_BYTES);  // [S][BQ]
  float* sDi = sL + S * BQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sDi + S * BQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  // the key tiles of one (b, h) are neighbours in the grid, low tiles
  // (the most q tiles) first: they read its Q/dO tiles from L2
  const int nkb = (p.Lk + BK - 1) / BK;
  const int bh = blockIdx.x / nkb;
  const int k0 = static_cast<int>(blockIdx.x - bh * nkb) * BK;
  const int b = bh / p.H, h = bh - b * p.H;
  const int nqt = (p.Lq + BQ - 1) / BQ;
  const int off = p.Lk - p.Lq;
  // the first q tile with a query that sees key k0: q + off >= k0
  const int qt_first = p.causal && k0 - off > 0 ? (k0 - off) / BQ : 0;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    set_max_regs<false, kProducerRegs>();
    if (threadIdx.x < 2 * 128 + 32)
      produce_qdo_ring<D, BK, BQ, S>(sK, sV, sQD, sL, sDi, &tm_q, &tm_k,
                                     &tm_v, &tm_do, kv_full, full, empty, p,
                                     bh, k0, qt_first, nqt, h, b);
    return;
  }
  set_max_regs<true, kConsumerRegs>();
  const int t = threadIdx.x & 127;
  const int kw = k0 + 64 * wg;  // the warpgroup's first key
  const int key_a = kw + acc_row(0, t);  // the thread's keys: +0 and +8
  // the first q tile that sees key kw; none when kw is past the keys
  const int qt_wg = kw >= p.Lk ? nqt
                               : (p.causal && kw - off > 0 ? (kw - off) / BQ
                                                           : 0);
  const KeyRows kr(p, b, h, bh, key_a);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  for (int it = 0, qt = qt_first; qt < nqt; ++it, ++qt) {
    const int s = it % S;
    mbar_wait(full + s, (it / S) & 1);
    if (qt >= qt_wg) {
      const uint8_t* sq = sQD + s * 2 * C::QD_BYTES;
      const uint8_t* sdo = sq + C::QD_BYTES;
      float st[BQ / 2], dp[BQ / 2];  // S^T, dP^T: rows keys, columns queries
      wg_fence();
      ss_product<T, D, BQ>(st, sK + wg * 64 * 128, BK, sq);
      ss_product<T, D, BQ>(dp, sV + wg * 64 * 128, BK, sdo);
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dp);
      const int q0 = qt * BQ;
      const float* di = sDi + s * BQ;
      probs_t<BQ>(st, p, kr.brow, kr.kvk, sL + s * BQ, kw, key_a, q0, t);
      // dS^T = P^T (dP_eff^T - di) scale into dp, P_eff^T into st
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int j = acc_col(i, t);
          const bool kp = kr.kept(p, q0 + j, (i >> 1) & 1);
          const float d = kp ? dp[i] * p.inv_keep : 0.f;
          dp[i] = st[i] * (d - di[j]) * p.scale;
          st[i] = kp ? st[i] * p.inv_keep : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          dp[i] = st[i] * (dp[i] - di[acc_col(i, t)]) * p.scale;
      }
      // P_eff^T and dS^T rounded to T, the A operands of dV and dK
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_frag<T, BQ>(pa, st);
      to_frag<T, BQ>(da, dp);
      wg_fence();
      rs_product<T, D, BQ>(dv, pa, sdo);
      rs_product<T, D, BQ>(dk, da, sq);
      wg_commit();
      wg_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
    }
    mbar_arrive(empty + s);
  }
  // this warpgroup's rows of sK and sV are read by no one now
  const float one[2] = {1.f, 1.f};
  store_rows<T, D>(dk, one, sK, BK, 64 * wg, wg, static_cast<T*>(p.out0), b,
                   kw, p.Lk, p.H, h);
  store_rows<T, D>(dv, one, sV, BK, 64 * wg, wg, static_cast<T*>(p.out1), b,
                   kw, p.Lk, p.H, h);
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvSplit<D>::THREADS, 1)
    fa_dkv_split_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const Params p) {
  using C = DkvSplit<D>;
  constexpr int BK = C::BK, BQ = C::BQ, S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + C::KV_BYTES;
  uint8_t* sQD = sV + C::KV_BYTES;  // stage s: Q, then dO
  float* sL = reinterpret_cast<float*>(sQD + S * 2 * C::QD_BYTES);  // [S][BQ]
  float* sDi = sL + S * BQ;
  float* sX = sDi + S * BQ;  // two P^T buffers, [BQ / 2][128] a thread column
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + 2 * C::X_FLOATS);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  const int nkb = (p.Lk + BK - 1) / BK;  // the grid order of K5
  const int bh = blockIdx.x / nkb;
  const int k0 = static_cast<int>(blockIdx.x - bh * nkb) * BK;
  const int b = bh / p.H, h = bh - b * p.H;
  const int nqt = (p.Lq + BQ - 1) / BQ;
  const int off = p.Lk - p.Lq;
  const int qt_first = p.causal && k0 - off > 0 ? (k0 - off) / BQ : 0;
  const int n_it = nqt - qt_first;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    set_max_regs<false, kProducerRegs>();
    if (threadIdx.x < 2 * 128 + 32)
      produce_qdo_ring<D, BK, BQ, S>(sK, sV, sQD, sL, sDi, &tm_q, &tm_k,
                                     &tm_v, &tm_do, kv_full, full, empty, p,
                                     bh, k0, qt_first, nqt, h, b);
    return;
  }
  set_max_regs<true, kConsumerRegs>();
  const int t = threadIdx.x & 127;
  const int key_a = k0 + acc_row(0, t);  // the thread's keys: +0 and +8
  const KeyRows kr(p, b, h, bh, key_a);
  const float one[2] = {1.f, 1.f};
  float acc[D / 2];  // dV in warpgroup 0, dK in warpgroup 1
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);
  if (wg == 0) {
    // S^T = K Q^T, P^T, handed to warpgroup 1; dV += P_eff^T dO
    for (int it = 0, qt = qt_first; qt < nqt; ++it, ++qt) {
      const int s = it % S, q0 = qt * BQ;
      mbar_wait(full + s, (it / S) & 1);
      const uint8_t* sq = sQD + s * 2 * C::QD_BYTES;
      float st[BQ / 2];
      wg_fence();
      ss_product<T, D, BQ>(st, sK, BK, sq);
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      probs_t<BQ>(st, p, kr.brow, kr.kvk, sL + s * BQ, k0, key_a, q0, t);
      float* x = sX + (it & 1) * C::X_FLOATS;
      if (it >= 2) named_sync(kExchangeEmpty + (it & 1), 256);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) x[i * 128 + t] = st[i];
      named_arrive(kExchangeFull + (it & 1), 256);
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          st[i] = kr.kept(p, q0 + acc_col(i, t), (i >> 1) & 1)
                      ? st[i] * p.inv_keep : 0.f;
      }
      uint32_t pa[BQ / 16][4];  // P_eff^T rounded to T
      to_frag<T, BQ>(pa, st);
      wg_fence();
      rs_product<T, D, BQ>(acc, pa, sq + C::QD_BYTES);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty + s);
    }
    // sK is read by this warpgroup alone: stage dV there
    store_rows<T, D>(acc, one, sK, BK, 0, 0, static_cast<T*>(p.out1), b, k0,
                     p.Lk, p.H, h);
  } else {
    // dP^T = V dO^T; dS^T = P^T (dP_eff^T - di) scale; dK += dS^T Q
    for (int it = 0, qt = qt_first; qt < nqt; ++it, ++qt) {
      const int s = it % S, q0 = qt * BQ;
      mbar_wait(full + s, (it / S) & 1);
      const uint8_t* sq = sQD + s * 2 * C::QD_BYTES;
      float dp[BQ / 2], pt[BQ / 2];
      wg_fence();
      ss_product<T, D, BQ>(dp, sV, BK, sq + C::QD_BYTES);
      wg_commit();
      wg_wait<0>();
      fence_regs(dp);
      const float* x = sX + (it & 1) * C::X_FLOATS;
      named_sync(kExchangeFull + (it & 1), 256);
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) pt[i] = x[i * 128 + t];
      if (it + 2 < n_it) named_arrive(kExchangeEmpty + (it & 1), 256);
      const float* di = sDi + s * BQ;
      if (p.dropout) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int j = acc_col(i, t);
          const float d = kr.kept(p, q0 + j, (i >> 1) & 1)
                              ? dp[i] * p.inv_keep : 0.f;
          dp[i] = pt[i] * (d - di[j]) * p.scale;
        }
      } else {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i)
          dp[i] = pt[i] * (dp[i] - di[acc_col(i, t)]) * p.scale;
      }
      uint32_t da[BQ / 16][4];  // dS^T rounded to T
      to_frag<T, BQ>(da, dp);
      wg_fence();
      rs_product<T, D, BQ>(acc, da, sq);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(empty + s);
    }
    // sV is read by this warpgroup alone: stage dK there
    store_rows<T, D>(acc, one, sV, BK, 0, 1, static_cast<T*>(p.out0), b, k0,
                     p.Lk, p.H, h);
  }
}

// ------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <typename T>
CUtensorMapDataType map_type();
template <>
CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
template <>
CUtensorMapDataType map_type<__half>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// A 4-D map over the strided [B, L, H, D] operand at `ptr` (dims
// innermost first: D, H, L, B), boxes of 64 columns x `rows` rows of one
// (b, h), 128-byte swizzled; rows past L read as zeros. The stride of an
// axis of size 1 is never used and is replaced by a valid one.
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
             long long sb, long long sl, long long sh, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  L = L > 0 ? L : 1;  // an empty operand is never read
  if (H == 1) sh = D;
  if (L == 1) sl = (long long)H * sh;
  if (B == 1) sb = (long long)L * sl;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh * 2),
                                 static_cast<cuuint64_t>(sl * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, map_type<T>(), 4, const_cast<void*>(ptr), dims, strides, box,
         unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename K>
int prepare(K kern, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// blocks = B H ceil(L / rows), L the axis the blocks own; 0 launches
// nothing, and more than a grid takes is refused
inline long long grid_of(const Params& p, int L, int rows) {
  return (long long)p.B * p.H * ((L + rows - 1) / rows);
}

template <typename T, int D, int NWG>
int launch_fwd(const Params& p, cudaStream_t stream) {
  using C = Fwd<D, NWG>;
  const long long blocks = grid_of(p, p.Lq, C::BM);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = make_map<T>(&mq, p.q, p.B, p.Lq, p.H, D, p.q_sb, p.q_sl, p.q_sh,
                        C::BM);
  if (!err)
    err = make_map<T>(&mk, p.k, p.B, p.Lk, p.H, D, p.k_sb, p.k_sl, p.k_sh,
                      C::BN);
  if (!err)
    err = make_map<T>(&mv, p.v, p.B, p.Lk, p.H, D, p.v_sb, p.v_sl, p.v_sh,
                      C::BN);
  if (!err) err = prepare(fa_fwd_tc_kernel<T, D, NWG>, C::SMEM);
  if (err) return err;
  fa_fwd_tc_kernel<T, D, NWG>
      <<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
          mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

// K4 and K5: maps of Q and dO in boxes of q_rows rows, K and V in
// boxes of k_rows, and `blocks` blocks of C::THREADS threads
template <typename T, int D, typename C, typename K>
int launch_bwd(K kern, const Params& p, long long blocks, int q_rows,
               int k_rows, cudaStream_t stream) {
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mdo;
  int err = make_map<T>(&mq, p.q, p.B, p.Lq, p.H, D, p.q_sb, p.q_sl, p.q_sh,
                        q_rows);
  if (!err)
    err = make_map<T>(&mdo, p.dout, p.B, p.Lq, p.H, D, p.do_sb, p.do_sl,
                      p.do_sh, q_rows);
  if (!err)
    err = make_map<T>(&mk, p.k, p.B, p.Lk, p.H, D, p.k_sb, p.k_sl, p.k_sh,
                      k_rows);
  if (!err)
    err = make_map<T>(&mv, p.v, p.B, p.Lk, p.H, D, p.v_sb, p.v_sl, p.v_sh,
                      k_rows);
  if (!err) err = prepare(kern, C::SMEM);
  if (err) return err;
  kern<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, mdo, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  using C = Dq<D>;
  return launch_bwd<T, D, C>(fa_dq_tc_kernel<T, D>, p,
                             grid_of(p, p.Lq, C::BM), C::BM, C::BN, stream);
}

template <typename T, int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  using C = Dkv<D>;
  return launch_bwd<T, D, C>(fa_dkv_tc_kernel<T, D>, p,
                             grid_of(p, p.Lk, C::BK), C::BQ, C::BK, stream);
}

template <typename T, int D>
int launch_dkv_split(const Params& p, cudaStream_t stream) {
  using C = DkvSplit<D>;
  return launch_bwd<T, D, C>(fa_dkv_split_tc_kernel<T, D>, p,
                             grid_of(p, p.Lk, C::BK), C::BQ, C::BK, stream);
}

}  // namespace tc

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };
// Params::design (the wrapper's `kernel_design`)
enum Design { kCudaCores = 0, kTensorCores = 1 };

// the CUDA-core design: f32 at every head dim
template <int D, int W>
int launch_cc(const Params& p, cudaStream_t stream) {
  using T = float;
  constexpr int DP = D + 1;
  constexpr int TM = Tile<D>::TM, PS = Tile<D>::PS;
  const int nq = (p.Lq + TM - 1) / TM;
  const int nk = (p.Lk + TM - 1) / TM;
  const long long bh = (long long)p.B * p.H;
  void (*kern)(Params);
  size_t smem;
  long long blocks;
  if (W == kFwd) {
    kern = fa_fwd_kernel<T, D>;
    smem = (3 * TM * DP + TM * PS) * sizeof(float);
    blocks = bh * nq;
  } else if (W == kDq) {
    kern = fa_dq_kernel<T, D>;
    smem = (4 * TM * DP + TM * PS) * sizeof(float);
    blocks = bh * nq;
  } else {
    kern = fa_dkv_kernel<T, D>;
    smem = (4 * TM * DP + 2 * TM * PS) * sizeof(float);
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

template <int W>
int cc_f32(const Params& p, cudaStream_t s) {
  switch (p.D) {
    case 64: return launch_cc<64, W>(p, s);
    case 128: return launch_cc<128, W>(p, s);
    case 256: return launch_cc<256, W>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16/f16 on the tensor cores: K3 at head dims 64, 128, 256 (64-row
// blocks when Lq <= 64), K4 at 64, 128, 256, K5 at 64 and 128 and its
// split lane at 256
template <typename T>
int tc_16(const Params& p, int which, cudaStream_t s) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  if (which == kFwd) {
    const bool one = p.Lq <= 64;
    switch (p.D) {
      case 64: return one ? tc::launch_fwd<T, 64, 1>(p, s)
                          : tc::launch_fwd<T, 64, 2>(p, s);
      case 128: return one ? tc::launch_fwd<T, 128, 1>(p, s)
                           : tc::launch_fwd<T, 128, 2>(p, s);
      case 256: return one ? tc::launch_fwd<T, 256, 1>(p, s)
                           : tc::launch_fwd<T, 256, 2>(p, s);
      default: return kBad;
    }
  }
  if (which == kDq) {
    switch (p.D) {
      case 64: return tc::launch_dq<T, 64>(p, s);
      case 128: return tc::launch_dq<T, 128>(p, s);
      case 256: return tc::launch_dq<T, 256>(p, s);
      default: return kBad;
    }
  }
  switch (p.D) {
    case 64: return tc::launch_dkv<T, 64>(p, s);
    case 128: return tc::launch_dkv<T, 128>(p, s);
    case 256: return tc::launch_dkv_split<T, 256>(p, s);
    default: return kBad;
  }
}

// f32 runs only the CUDA-core design and bf16/f16 only the tensor-core
// one: any other (dtype, design) is refused, never rerouted
int run(const void* params, int which, int dtype, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params& p = *static_cast<const Params*>(params);
  const bool tensor = p.design == kTensorCores;
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case ptt::kF32:
      if (tensor) return kBad;
      return which == kFwd  ? cc_f32<kFwd>(p, s)
             : which == kDq ? cc_f32<kDq>(p, s)
                            : cc_f32<kDkv>(p, s);
    case ptt::kBF16:
      return tensor ? tc_16<__nv_bfloat16>(p, which, s) : kBad;
    case ptt::kF16:
      return tensor ? tc_16<__half>(p, which, s) : kBad;
    default: return kBad;
  }
}

}  // namespace

// The three entries take a pointer to one Params (mirrored by a ctypes
// Structure in ops/cuda/flash_attention.py); every output is contiguous.
// A (dtype, head dim, kernel, design) that is not instantiated returns
// cudaErrorInvalidValue.
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
