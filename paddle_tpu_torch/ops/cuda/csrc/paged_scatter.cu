// K8 and K8-q8: the paged KV write, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_scatter_write_kernel
// (K8, launched from _paged_scatter_kernel: the megakernel's write stage,
// the public paged_scatter's kernel form) in its float lane and its fp8
// lane, and ::_scatter_q8_write_kernel (K8-q8, launched from
// _paged_scatter_q8_kernel; public paged_scatter_q8). The new K/V
// upd [B, l, Hkv, D] (f32, bf16 or f16) of row b's token t lands at
// logical position p = pos[b] + t, i.e. pool slot
// page_table[b, p / ps] * ps + p % ps — `_paged_flat_slots`' map. A
// position past the row's window (p >= mp * ps) goes to slot p % ps of
// the trash page 0, so the write never branches around a live page.
//
//   K8, float lane (ptt_paged_scatter_float): each value is cast to the
//     pool's dtype (f32, bf16 or f16; round to nearest even), as
//     `upd.astype(pool.dtype)` does; into a pool of upd's own dtype the
//     write is a copy, so the pool equals `index_copy_`'s bit for bit.
//   K8, fp8 lane (ptt_paged_scatter_e4m3): each value is clipped to +-448 and
//     converted to float8 e4m3 with round-to-nearest-even (saturating),
//     as the JAX write does before XLA's convert (which gives NaN past the
//     range).
//   K8-q8 (ptt_paged_scatter_q8): each (token, kv head) row of D values is
//     quantized as `quantize_kv_rowwise` does it: amax = max |u|,
//     scale = max(amax, eps) * recip (eps = f32(1e-8), recip = f32(1/127),
//     both passed in as the plain version's bit patterns), codes =
//     clamp(rint(u / scale), -127, 127) with IEEE division and
//     round-half-to-even; the codes go to the int8 pool and the scale to
//     the same slot of the f32 scale pool [num_pages, ps, Hkv].
//
// What bounds it: bytes (a few operations per element): each value is
// read once and written once, at GPT-124M's serving step 1.5 MB for K
// and V in bf16, so the call is a few microseconds and its fixed costs
// (the launch, the slot lookups, the first loads' latency) are most of
// it.
//
// Design of K8 (both lanes): in the contiguous pool [num_pages, ps, Hkv,
// D] one token's [Hkv, D] tile is one contiguous run, in upd and in its
// pool slot alike (1,536 bytes in bf16 and 768 in e4m3 at 12 x 64). So a
// thread moves one chunk of E elements of a token's tile: the narrower
// side's 16 bytes (8 bf16 values into a bf16 pool, 16 e4m3 codes from
// two 16-byte bf16 loads), or the widest smaller power of two that
// divides the tile and the pointers' alignment, down to one element, so
// every shape is taken. A block owns a run of kThreads consecutive
// chunks: each thread issues its upd loads first, then the first threads
// look up the block's tokens' slots once each (a token's pos[b] and its
// table entry) into shared memory, and after one barrier every thread
// converts in registers and stores its chunk with the same wide words.
// `ptt_paged_scatter_float` and `ptt_paged_scatter_e4m3` write K and V in
// one launch where both are given (the megakernel's write stage and the
// fp8 cache's write: one lookup per token serves both), or one of them.
// The grid covers the whole write in one wave (at most 8 blocks an SM,
// then a block walks further runs). The float lane into a pool of upd's
// own dtype moves the bits as they are.
//
// K8-q8: one warp per (token, kv head) row; lane i takes elements i,
// i + 32, ... (so a warp's loads and stores are contiguous), the row's
// amax is a warp reduction, and lane 0 writes the scale.
//
// Several tokens may write the same trash slot; which one stays is
// unspecified, and a trash slot's codes and scale may come from
// different tokens (trash keys are masked, and every value written is
// finite for finite input). A page id outside [0, num_pages) is sent to
// the trash page instead of faulting.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// The pool slot of row b's token t (see above).
__device__ __forceinline__ size_t flat_slot(const int* __restrict__ table,
                                            const int* __restrict__ pos,
                                            int b, int t, int ps, int mp,
                                            int num_pages) {
  const long long p = (long long)pos[b] + t;
  const int off = (int)(((p % ps) + ps) % ps);
  if (p < 0 || p >= (long long)mp * ps) return (size_t)off;
  const int page = table[(size_t)b * mp + p / ps];
  if (page < 0 || page >= num_pages) return (size_t)off;
  return (size_t)page * ps + off;
}

struct Geometry {
  int B, l, Hkv, D, ps, mp, num_pages;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_q8_kernel(const T* __restrict__ upd, int8_t* __restrict__ codes,
                      float* __restrict__ scales,
                      const int* __restrict__ table,
                      const int* __restrict__ pos, const Geometry geo,
                      float eps, float recip) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (b, t, g)
  const int lane = threadIdx.x & 31;
  if (row >= geo.B * geo.l * geo.Hkv) return;  // uniform across the warp
  const int g = row % geo.Hkv;
  const int bt = row / geo.Hkv;
  const size_t slot = flat_slot(table, pos, bt / geo.l, bt % geo.l, geo.ps,
                                geo.mp, geo.num_pages);
  const T* src = upd + (size_t)row * geo.D;
  float amax = 0.f;
  for (int d = lane; d < geo.D; d += 32)
    amax = fmaxf(amax, fabsf(ptt::to_f32<T>(src[d])));
  amax = ptt::warp_max(amax);
  const float scale = fmaxf(amax, eps) * recip;
  int8_t* dst = codes + (slot * geo.Hkv + g) * geo.D;
  for (int d = lane; d < geo.D; d += 32) {
    const float q = rintf(ptt::to_f32<T>(src[d]) / scale);
    dst[d] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
  if (lane == 0) scales[slot * geo.Hkv + g] = scale;
}

// ---- K8: a token's [Hkv, D] tile in chunks of E elements ----------------
// the pool element of the e4m3 lane (its bytes)
using E4M3 = __nv_fp8_storage_t;

// the register word of W bytes
template <int W>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned;
};
template <>
struct Word<2> {
  using type = unsigned short;
};
template <>
struct Word<1> {
  using type = unsigned char;
};

// N bytes in registers, as words of min(N, 16) bytes
template <int N>
struct Chunk {
  static constexpr int W = N < 16 ? N : 16;
  using Type = typename Word<W>::type;
  Type w[N / W];

  __device__ __forceinline__ void load(const void* src) {
#pragma unroll
    for (int i = 0; i < N / W; ++i)
      w[i] = __ldg(static_cast<const Type*>(src) + i);
  }
  __device__ __forceinline__ void store(void* dst) const {
#pragma unroll
    for (int i = 0; i < N / W; ++i) static_cast<Type*>(dst)[i] = w[i];
  }
};

// One element into the pool's type: the float lane casts through f32
// (exact from bf16 and f16, one rounding to nearest even into the pool);
// the e4m3 lane clips to +-448 (a NaN passes unclipped — fminf/fmaxf
// would make it +-448 — and converts to NaN, as clip then convert does in
// torch and XLA) and converts with saturating round-to-nearest-even.
template <typename T, typename P>
__device__ __forceinline__ P convert(T x) {
  const float f = ptt::to_f32<T>(x);
  if constexpr (std::is_same<P, E4M3>::value) {
    const float c = f != f ? f : fminf(fmaxf(f, -448.f), 448.f);
    return __nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3);
  } else {
    return ptt::from_f32<P>(f);
  }
}

// one write of K8: upd [B, l, Hkv, D] into pool [num_pages, ps, Hkv, D]
struct Write {
  const void* upd;
  void* pool;
};

template <typename T, typename P, int E>
__global__ void __launch_bounds__(kThreads)
    scatter_tile_kernel(const Write k, const Write v,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, const Geometry geo) {
  constexpr int LB = E * static_cast<int>(sizeof(T));
  constexpr int SB = E * static_cast<int>(sizeof(P));
  __shared__ size_t sSlot[kThreads];  // the slots of a run's tokens
  const int tile = geo.Hkv * geo.D;   // elements of a token's tile
  const int nch = tile / E;           // chunks of a tile
  const int total = geo.B * geo.l * nch;
  const bool pair = v.upd != nullptr;
  const int tid = threadIdx.x;
  for (int base = blockIdx.x * kThreads; base < total;
       base += gridDim.x * kThreads) {
    const int c = base + tid;
    const bool live = c < total;
    const int tok = live ? c / nch : 0;  // token b * l + t
    const size_t at = (size_t)tok * tile + (size_t)(c - tok * nch) * E;
    // the loads first, so that they are in flight through the lookup
    Chunk<LB> kin, vin;
    if (live) {
      kin.load(static_cast<const T*>(k.upd) + at);
      if (pair) vin.load(static_cast<const T*>(v.upd) + at);
    }
    // one lookup per token of this run
    const int tok0 = base / nch;
    const int ntok = (min(total, base + kThreads) - 1) / nch - tok0 + 1;
    if (tid < ntok) {
      const int bt = tok0 + tid;
      sSlot[tid] = flat_slot(table, pos, bt / geo.l, bt % geo.l, geo.ps,
                             geo.mp, geo.num_pages);
    }
    __syncthreads();
    if (live) {
      // the chunk's place in the pool: its slot's tile, at its offset
      const size_t dst =
          sSlot[tok - tok0] * tile + (at - (size_t)tok * tile);
      auto put = [&](const Chunk<LB>& in, void* pool) {
        Chunk<SB> out;
        if constexpr (std::is_same<T, P>::value) {
          out = in;  // a pool of upd's own dtype: the bits as they are
        } else {
          const T* e = reinterpret_cast<const T*>(in.w);
          P* o = reinterpret_cast<P*>(out.w);
#pragma unroll
          for (int i = 0; i < E; ++i) o[i] = convert<T, P>(e[i]);
        }
        out.store(static_cast<P*>(pool) + dst);
      };
      put(kin, k.pool);
      if (pair) put(vin, v.pool);
    }
    __syncthreads();  // every sSlot read before the next run writes it
  }
}

// Elements a chunk: the narrower side's 16 bytes, halved until the chunk
// divides the tile and both pointers are aligned to its words (min(16,
// its bytes)).
template <typename T, typename P>
int chunk_elems(int tile, const Write& k, const Write& v) {
  int e = 16 / static_cast<int>(sizeof(T) < sizeof(P) ? sizeof(T)
                                                       : sizeof(P));
  auto aligned = [&](const void* p, int bytes) {
    const int w = bytes < 16 ? bytes : 16;
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % w == 0;
  };
  while (e > 1 &&
         (tile % e || !aligned(k.upd, e * sizeof(T)) ||
          !aligned(v.upd, e * sizeof(T)) ||
          !aligned(k.pool, e * sizeof(P)) || !aligned(v.pool, e * sizeof(P))))
    e /= 2;
  return e;
}

template <typename T, typename P, int E>
int launch_tile_e(const Write& k, const Write& v, const int* table,
                  const int* pos, const Geometry& geo, int device,
                  cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = geo.B * geo.l * (geo.Hkv * geo.D / E);
  const int need = (chunks + kThreads - 1) / kThreads;
  // one wave: at most 8 blocks of kThreads an SM (2,048 threads)
  const int blocks = need < 8 * sms ? need : 8 * sms;
  scatter_tile_kernel<T, P, E><<<blocks, kThreads, 0, stream>>>(k, v, table,
                                                               pos, geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_tile(const Write& k, const Write& v, const int* table,
                const int* pos, const Geometry& geo, int device,
                cudaStream_t s) {
  switch (chunk_elems<T, P>(geo.Hkv * geo.D, k, v)) {
    case 16:
      return launch_tile_e<T, P, 16>(k, v, table, pos, geo, device, s);
    case 8:
      return launch_tile_e<T, P, 8>(k, v, table, pos, geo, device, s);
    case 4:
      return launch_tile_e<T, P, 4>(k, v, table, pos, geo, device, s);
    case 2:
      return launch_tile_e<T, P, 2>(k, v, table, pos, geo, device, s);
    default:
      return launch_tile_e<T, P, 1>(k, v, table, pos, geo, device, s);
  }
}

// K8 from upd's dtype into the pool element P.
template <typename P>
int launch_from(int dtype, const Write& k, const Write& v, const int* table,
                const int* pos, const Geometry& geo, int device,
                cudaStream_t s) {
  switch (dtype) {
    case ptt::kF32:
      return launch_tile<float, P>(k, v, table, pos, geo, device, s);
    case ptt::kBF16:
      return launch_tile<__nv_bfloat16, P>(k, v, table, pos, geo, device, s);
    case ptt::kF16:
      return launch_tile<__half, P>(k, v, table, pos, geo, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_q8(const void* upd, void* codes, void* scales, const int* table,
              const int* pos, const Geometry& geo, float eps, float recip,
              cudaStream_t stream) {
  const int rows = geo.B * geo.l * geo.Hkv;
  scatter_q8_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                         stream>>>(
      static_cast<const T*>(upd), static_cast<int8_t*>(codes),
      static_cast<float*>(scales), table, pos, geo, eps, recip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8, float lane. k_upd (and v_upd, or null): [B, l, Hkv, D] of `dtype`;
// k_pool (and v_pool, null with v_upd): [num_pages, ps, Hkv, D] of
// `pool_dtype` (f32, bf16 or f16), written in place; page_table [B, mp];
// pos [B] int32. All contiguous; K and V share their dtypes and shapes.
extern "C" int ptt_paged_scatter_float(const void* k_upd, void* k_pool,
                                       const void* v_upd, void* v_pool,
                                       const void* page_table,
                                       const void* pos, int B, int l,
                                       int Hkv, int D, int ps, int mp,
                                       int num_pages, int dtype,
                                       int pool_dtype, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((v_upd == nullptr) != (v_pool == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || l == 0 || Hkv == 0 || D == 0) return 0;
  if ((long long)B * l * Hkv * D > INT_MAX)  // the chunks count in int
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{B, l, Hkv, D, ps, mp, num_pages};
  const Write k{k_upd, k_pool}, v{v_upd, v_pool};
  const int* tab = static_cast<const int*>(page_table);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pool_dtype) {
    case ptt::kF32:
      return launch_from<float>(dtype, k, v, tab, p, geo, device, s);
    case ptt::kBF16:
      return launch_from<__nv_bfloat16>(dtype, k, v, tab, p, geo, device, s);
    case ptt::kF16:
      return launch_from<__half>(dtype, k, v, tab, p, geo, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8, fp8 lane. k_upd (and v_upd, or null): [B, l, Hkv, D] of `dtype`;
// k_pool (and v_pool, null with v_upd): e4m3 [num_pages, ps, Hkv, D],
// written in place; page_table [B, mp]; pos [B] int32. All contiguous.
extern "C" int ptt_paged_scatter_e4m3(const void* k_upd, void* k_pool,
                                      const void* v_upd, void* v_pool,
                                      const void* page_table,
                                      const void* pos, int B, int l, int Hkv,
                                      int D, int ps, int mp, int num_pages,
                                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((v_upd == nullptr) != (v_pool == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || l == 0 || Hkv == 0 || D == 0) return 0;
  if ((long long)B * l * Hkv * D > INT_MAX)  // the chunks count in int
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{B, l, Hkv, D, ps, mp, num_pages};
  return launch_from<E4M3>(dtype, Write{k_upd, k_pool},
                           Write{v_upd, v_pool},
                           static_cast<const int*>(page_table),
                           static_cast<const int*>(pos), geo, device,
                           static_cast<cudaStream_t>(stream));
}

// K8-q8. upd as K8's; codes: int8 [num_pages, ps, Hkv, D] and scales: f32
// [num_pages, ps, Hkv], both written in place; eps and recip as above.
extern "C" int ptt_paged_scatter_q8(const void* upd, void* codes,
                                    void* scales, const void* page_table,
                                    const void* pos, int B, int l, int Hkv,
                                    int D, int ps, int mp, int num_pages,
                                    float eps, float recip, int dtype,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || l == 0 || Hkv == 0) return 0;
  const Geometry geo{B, l, Hkv, D, ps, mp, num_pages};
  const int* tab = static_cast<const int*>(page_table);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_q8<float>(upd, codes, scales, tab, p, geo, eps, recip, s);
    case ptt::kBF16:
      return launch_q8<__nv_bfloat16>(upd, codes, scales, tab, p, geo, eps,
                                      recip, s);
    case ptt::kF16:
      return launch_q8<__half>(upd, codes, scales, tab, p, geo, eps, recip,
                               s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
