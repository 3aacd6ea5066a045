// K9: single-token paged decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_pa_kernel, launched
// from _paged_attention_kernel (public paged_decode_attention), in its fp
// lane (pools of q's dtype) and its fp8 lane (e4m3 pools, upconverted
// exactly). The legacy alternating serving step attends through it once
// per layer per decode step, and so does generate()'s paged cache:
//
//   q [B, 1, H, D]; k/v pools [P, ps, H_kv, D]; page_table [B, mp] int32;
//   pos [B] int32; mask null or additive f32 [B, H, mp * ps]. Row b's rep
//   = H / H_kv query heads of kv head g attend keys j <= pos[b], read in
//   place from pages page_table[b, p] for p <= min(pos[b] / ps, mp - 1),
//   walked in order with an f32 online softmax. Masked scores are -1e30;
//   the user mask is added after that window mask. The output is
//   acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: on paper, bytes. A decode row's live K/V pages meet one
// query each (rep queries per kv head), a few flops per element; the
// mask, when given, adds 4 bytes per live key and head. In practice the
// chain of page folds of the longest row, which must run one after
// another: K9 equals K6 at q_len 1 bit for bit, so its fold is K6's f32
// online softmax (`attend_row`, paged_walk.cuh) in K6's page order, and a
// tensor-core fold or a split of a row's pages over blocks would sum in
// another order. The design keeps every copy off that chain and the SMs
// evenly busy, with the parts K10 walks with (paged_walk.cuh):
// - One block owns (kv head g, row b) and its rep query rows. The TPU
//   kernel carried (m, l, acc) in VMEM scratch along a sequential page
//   axis of its grid; here the block loops over the row's live pages.
// - The ring (`ring_issue`, `ring_convert`): kRingStages cp.async page
//   stages, two pages ahead, each thread converting the chunks it copied
//   itself, into two f32 working tiles. Warps with no rows to fold (at
//   rep 1 seven of the eight) copy and convert page i + 1 while page i
//   is folded, one __syncthreads a page. Page ids are read from the table
//   a page ahead, so shared memory does not grow with mp.
// - Where the ring and two tiles do not fit shared memory beside the
//   rows' state (f32 at head dim 256 with pages of 64, pages of 128, many
//   rows), each page is loaded straight from the pools into one tile, as
//   K6 does, with a barrier before and after. So K9 takes every shape it
//   took before the ring; `ptt_decode_plan` reports the feeder a launch
//   gets.
// - The fold: page size 16 at head dims 32-256 takes instantiations with
//   D and ps as compile-time constants; without a mask they fold two rows
//   a warp (`attend_pair`, which gives every value attend_row's
//   operations in attend_row's order). Every other shape, and the mask
//   lane, folds a row a warp with `attend_row` itself (its masked
//   instantiation adds the mask row, read from device memory by each
//   lane, after the window).
// - The schedule: every block ranks the rows by descending page count,
//   ties by index (up to kSortMax rows, else index order), and block x
//   takes kv head x % H_kv of the row ranked x / H_kv, so the longest
//   walks start first; two blocks fit an SM (`__launch_bounds__(256,
//   2)`), so the legacy step's 192 blocks run as one wave.
// Page ids are clamped into the pool.
#include "paged_walk.cuh"

namespace {

using namespace ptt;
using namespace ptt::walk;

// launches with at most this many rows schedule them longest walk first
constexpr int kSortMax = 512;

// the shapes of the compile-time instantiations: two rows a warp
// without a mask
__host__ __device__ inline bool decode_exact(int D, int ps) {
  return ps == 16 && (D == 32 || D == 64 || D == 128 || D == 256);
}

// A launch's feeder and shared memory: the ring (kRingStages stages, two
// f32 tiles) where it fits beside the rows' state, else one tile that
// each page is loaded into straight from the pools (stages 0). The
// schedule's keys share the start of the same buffer before the walk
// begins. The kernel and `ptt_decode_plan` both call this.
__host__ __device__ inline RingLayout decode_layout(int elem, int D, int ps,
                                                   int rep, bool paired) {
  const int kstride = paired ? D + 4 : D + 1;
  const RingLayout L =
      ring_layout(elem, false, D, ps, kstride, rep, kRingStages, 2);
  if (L.total <= kSmemMax) return L;
  return ring_layout(elem, false, D, ps, kstride, rep, 0, 1);
}

// dynamic shared memory of a launch: the layout, and room for the
// schedule's keys and chosen row
__host__ __device__ inline size_t decode_smem(const RingLayout& L, int B) {
  const size_t keys = sizeof(int) * ((B < kSortMax ? B : kSortMax) + 1);
  return L.total > keys ? L.total : keys;
}

template <typename T, int DV, int PJ, int kD, int kPS, bool kMasked>
__global__ void __launch_bounds__(kThreads, 2)
    decode_ring_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char sbuf[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const int D = kD > 0 ? kD : a.D;
  const int ps = kPS > 0 ? kPS : a.ps;
  const int H = a.H;
  const int rep = H / a.Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = blockIdx.x % a.Hkv;
  const int rank = blockIdx.x / a.Hkv;

  // The schedule, built alike by every block: rows by descending page
  // count, ties by index. More than kSortMax rows: index order.
  int b = rank;
  if (a.B <= kSortMax) {
    int* sKey = reinterpret_cast<int*>(sbuf);
    for (int i = tid; i < a.B; i += kThreads)
      sKey[i] = block_pages(a.pos[i], 1, 0, 1, ps, a.mp);
    __syncthreads();
    for (int i = tid; i < a.B; i += kThreads) {
      const int ki = sKey[i];
      int r = 0;
      for (int j = 0; j < a.B; ++j) {
        const int kj = sKey[j];
        r += (kj > ki) || (kj == ki && j < i);
      }
      if (r == rank) sKey[a.B] = i;
    }
    __syncthreads();
    b = sKey[a.B];
    __syncthreads();  // the keys' room is the walk's from here on
  }
  const int pos_b = a.pos[b];
  // K6's page count at q_len 1: pages through position pos, at most mp
  const int n = block_pages(pos_b, 1, 0, 1, ps, a.mp);
  const int* __restrict__ table = a.page_table + (size_t)b * a.mp;
  auto page_id = [&](int i) {
    return min(max(table[i], 0), a.num_pages - 1);
  };

  constexpr bool kPair = kPS == 16 && !kMasked;
  const int kstride = kPair ? D + 4 : D + 1;
  const RingLayout L = decode_layout(pool_elem<T>(a.pool), D, ps, rep, kPair);
  const bool ring = L.stages > 0;
  float* tiles = reinterpret_cast<float*>(sbuf + L.tiles);
  float* sQ = reinterpret_cast<float*>(sbuf + L.q);      // [rep][D]
  float* sAcc = reinterpret_cast<float*>(sbuf + L.acc);  // [rep][D]
  float* sM = reinterpret_cast<float*>(sbuf + L.m);      // [rep]
  float* sL = reinterpret_cast<float*>(sbuf + L.l);      // [rep]
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    sQ[idx] = to_f32<T>(q[((size_t)b * H + g * rep + r) * D + d]);
    sAcc[idx] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  // with a compile-time head dim up to 64 a half-warp's query row sits in
  // registers: read once when the warp has one pair of rows
  constexpr bool kQRegs = kPair && kD <= 64;
  float qreg[kQRegs ? kD : 1];
  const bool one_pair = rep <= 2 * kWarps;
  // Roles, as in K10: the first `folders` warps fold (a row pair, or a
  // row, each); on the ring the warps left over copy and convert, so
  // converting page i + 1 overlaps folding page i; else every warp does
  // both, folding first.
  const int units = kPair ? (rep + 1) / 2 : rep;
  const int folders = min(units, kWarps);
  const int first_prod = ring && folders < kWarps ? folders : 0;
  const bool producer = warp >= first_prod;
  const int pt = tid - first_prod * 32, nprod = kThreads - first_prod * 32;
  int next = 0;  // the id of the page the ring takes next
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
  // Fill page p's tile: on the ring, convert its stage (this thread
  // waited for its own chunks only), then refill the stage with page
  // p + kRingStages; else load it from the pools.
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
  __syncthreads();  // page 0's tile and the queries visible
  const size_t lmax = (size_t)a.mp * ps;
  for (int i = 0; i < n; ++i) {
    const float* sK = tiles + (size_t)(i & (L.nbuf - 1)) * L.tile;
    const float* sV = sK + L.kfloats;
    const int kbase = i * ps;
    if (warp < folders) {
      if constexpr (kPair) {
        // warp w folds row pairs (2p, 2p + 1) for p = w, w + 8, ...
        for (int p = warp; 2 * p < rep; p += kWarps) {
          const int r = 2 * p + (lane >> 4);
          const bool owner = r < rep;
          const int rr = owner ? r : 2 * p;
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
          attend_pair<kD, kQRegs>(qrow, sK, sV, kbase, true, pos_b, a.scale,
                                  sM + rr, sL + rr, sAcc + (size_t)rr * kD,
                                  lane, owner);
        }
      } else {
        for (int r = warp; r < rep; r += kWarps) {
          const float* mrow =
              kMasked ? a.mask + ((size_t)b * H + g * rep + r) * lmax
                      : nullptr;
          attend_row<DV, PJ, kMasked>(sQ + (size_t)r * D, sK, sV, D, ps,
                                      kbase, true, pos_b, a.scale, sM + r,
                                      sL + r, sAcc + (size_t)r * D, lane,
                                      mrow);
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
  T* __restrict__ out = static_cast<T*>(a.out);
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const float l = fmaxf(sL[r], 1e-30f);
    out[((size_t)b * H + g * rep + r) * D + d] = from_f32<T>(sAcc[idx] / l);
  }
}

template <int kD, int kPS, bool kMasked>
struct DecodeRing {
  template <typename T, int DV, int PJ>
  static int run(const Args& a, cudaStream_t stream) {
    const RingLayout L = decode_layout(pool_elem<T>(a.pool), a.D, a.ps,
                                       a.H / a.Hkv, kPS == 16 && !kMasked);
    const size_t smem = decode_smem(L, a.B);
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = decode_ring_kernel<T, DV, PJ, kD, kPS, kMasked>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<a.B * a.Hkv, kThreads, smem, stream>>>(a);
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

// Page size 16 at head dims 32-256: the compile-time instantiations (two
// rows a warp without a mask, a row a warp with one); any other shape:
// run-time D and ps, a row a warp.
template <bool kMasked>
int decode_dispatch(int dtype, const Args& a, cudaStream_t s) {
  if (!pools_valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (decode_exact(a.D, a.ps)) {
    switch (a.D) {
      case 32:
        return dispatch_exact<DecodeRing<32, 16, kMasked>, 1>(dtype, a, s);
      case 64:
        return dispatch_exact<DecodeRing<64, 16, kMasked>, 2>(dtype, a, s);
      case 128:
        return dispatch_exact<DecodeRing<128, 16, kMasked>, 4>(dtype, a, s);
      case 256:
        return dispatch_exact<DecodeRing<256, 16, kMasked>, 8>(dtype, a, s);
      default:
        break;
    }
  }
  return dispatch<DecodeRing<0, 0, kMasked>>(dtype, a, s);
}

}  // namespace

// The launch K9 makes for these shapes, written to out[7]: raw stages
// (kRingStages on the ring; 0: each page loaded straight into one tile),
// f32 tiles, dynamic shared memory bytes (for B rows), 1 if two rows
// share a warp (`attend_pair`), the grid's blocks, threads a block, query
// rows a block. Returns cudaErrorInvalidValue, as the launch would, for a
// dtype or pool code K9 does not take (int8 pools take K7), an
// unsupported head dim or page size, or shared memory over the limit.
extern "C" int ptt_decode_plan(int B, int H, int Hkv, int D, int ps,
                               int dtype, int pool, int masked, int* out) {
  if (B < 1 || Hkv < 1 || H % Hkv || D < 1 || D > 256 || ps < 1 ||
      ps > 128 || dtype < kF32 || dtype > kF16 ||
      (pool != kPoolQ && pool != kPoolE4M3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = pool != kPoolQ ? 1 : dtype == kF32 ? 4 : 2;
  const bool paired = decode_exact(D, ps) && !masked;
  const RingLayout L = decode_layout(elem, D, ps, H / Hkv, paired);
  const size_t smem = decode_smem(L, B);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int vals[7] = {L.stages, L.nbuf, static_cast<int>(smem),
                       paired ? 1 : 0, B * Hkv, kThreads, H / Hkv};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// q, out: [B, 1, H, D]; k, v: [num_pages, ps, Hkv, D] of q's dtype (pool
// code 0) or e4m3 (2); page_table [B, mp]; pos [B]; mask: null or f32
// [B, H, mp * ps]. All contiguous; D a multiple of the pool's 16-byte
// vector width; H a multiple of Hkv. int8 pools have no K9 lane (they
// take K7 at q_len 1) and are refused.
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* pos, const void* mask, void* out, int B, int H, int Hkv,
    int D, int ps, int mp, int num_pages, int dtype, int pool, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  Args a = make_args(q, k, v, nullptr, nullptr, page_table, pos, nullptr, B,
                     1, H, Hkv, D, ps, mp, num_pages, pool);
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr) return decode_dispatch<true>(dtype, a, s);
  return decode_dispatch<false>(dtype, a, s);
}
