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
//   K8-q8 (ptt_paged_scatter_q8[_pair]): each (token, kv head) row of D
//     values is quantized as `quantize_kv_rowwise` does it: amax = max |u|,
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
// Design of K8-q8 (K8's, carried over to a row's amax): a (token, kv
// head) row of D values goes to a group of lanes, one 16-byte vector of
// upd a lane (8 lanes at D 64 in bf16, 16 at D 64 in f32; up to four
// vectors a lane past 32 lanes, and wider rows read twice from L1/L2),
// so the row is read once into registers. The row's amax is a shuffle
// within the group (a max is exact in any order, so the scale keeps its
// bits), each lane packs its codes into one store (8 bytes from 8 bf16
// values) and the group's first lane writes the scale. A row that is not
// a multiple of 16 bytes, or a pointer off their boundary, takes the
// widest vector that divides both, down to one element. As in K8, each
// thread issues its loads first, the block's first threads load its
// tokens' positions, every lane computes its codes while those are in
// flight, and then the first threads look up the tokens' pages once
// each into shared memory; the stores follow one barrier.
// `ptt_paged_scatter_q8_pair` writes K and V in one launch (one lookup a
// token serves both: the unified and legacy steps' and the megakernel's
// int8 write), or one of them (`ptt_paged_scatter_q8`). The codes stay
// clamp(rint(u / scale), -127, 127) with IEEE division (`__fdiv_rn`) and
// round-half-to-even, and the scale fmaxf(amax, eps) * recip, so every
// code and scale is the plain version's bits. On an H100 a launch that
// does nothing takes 0.0019 ms back to back, K8 0.0034 and K8-q8 0.0042
// at the serving step's write: the launch, the slot lookup's two
// dependent loads and the row's division chain are the call.
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

// The pool slot of row b's logical position p (see above).
__device__ __forceinline__ size_t slot_at(const int* __restrict__ table,
                                          long long p, int b, int ps, int mp,
                                          int num_pages) {
  const int off = (int)(((p % ps) + ps) % ps);
  if (p < 0 || p >= (long long)mp * ps) return (size_t)off;
  const int page = table[(size_t)b * mp + p / ps];
  if (page < 0 || page >= num_pages) return (size_t)off;
  return (size_t)page * ps + off;
}

// The pool slot of row b's token t.
__device__ __forceinline__ size_t flat_slot(const int* __restrict__ table,
                                            const int* __restrict__ pos,
                                            int b, int t, int ps, int mp,
                                            int num_pages) {
  return slot_at(table, (long long)pos[b] + t, b, ps, mp, num_pages);
}

struct Geometry {
  int B, l, Hkv, D, ps, mp, num_pages;
};

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

// ---- K8-q8: a (token, kv head) row in a group of lanes -------------------
// one quantizing write: upd [B, l, Hkv, D] into codes [num_pages, ps, Hkv,
// D] and scales [num_pages, ps, Hkv]
struct Q8Write {
  const void* upd;
  int8_t* codes;
  float* scales;
};

// the max of v over the L lanes of this lane's group (L a power of two
// up to 32, groups aligned within the warp); every lane of the warp calls
__device__ __forceinline__ float group_max(float v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(ptt::kFullMask, v, o));
  return v;
}

// A lane's share of one row: vectors j = g, g + L, ... of E values, NV of
// them held in registers (NV 0: any number, read twice).
template <typename T, int E, int NV>
struct Q8Row {
  static constexpr int kHeld = NV > 0 ? NV : 1;
  Chunk<E * static_cast<int>(sizeof(T))> v[kHeld];
  const T* src;  // the row in upd
  int g, L, nvec;
  bool live;

  __device__ __forceinline__ void load() {
    if constexpr (NV > 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (live && g + L * i < nvec) v[i].load(src + (g + L * i) * E);
    }
  }
  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
    if constexpr (NV > 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (live && g + L * i < nvec) f(g + L * i, v[i]);
    } else {
      for (int j = g; live && j < nvec; j += L) {
        Chunk<E * static_cast<int>(sizeof(T))> c;
        c.load(src + j * E);
        f(j, c);
      }
    }
  }
  float scale;
  typename Word<E>::type q[kHeld];  // a held row's codes, packed

  // E values' codes at this row's scale, packed into one word
  __device__ __forceinline__ typename Word<E>::type codes_of(
      const Chunk<E * static_cast<int>(sizeof(T))>& c) const {
    const T* e = reinterpret_cast<const T*>(c.w);
    typename Word<E>::type out;
    int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float f = rintf(__fdiv_rn(ptt::to_f32<T>(e[k]), scale));
      o[k] = static_cast<int8_t>(fminf(fmaxf(f, -127.f), 127.f));
    }
    return out;
  }
  // the row's scale and, where it is held, its codes, before its slot is
  // known (every lane of the warp calls)
  __device__ __forceinline__ void quantize(float eps, float recip) {
    using Vec = Chunk<E * static_cast<int>(sizeof(T))>;
    float amax = 0.f;
    each([&](int, const Vec& c) {
      const T* e = reinterpret_cast<const T*>(c.w);
#pragma unroll
      for (int k = 0; k < E; ++k)
        amax = fmaxf(amax, fabsf(ptt::to_f32<T>(e[k])));
    });
    scale = fmaxf(group_max(amax, L), eps) * recip;
    if constexpr (NV > 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (live && g + L * i < nvec) q[i] = codes_of(v[i]);
    }
  }
  // the codes and the scale into the row's place `at` in w
  __device__ __forceinline__ void store(const Q8Write& w, size_t at) const {
    using Vec = Chunk<E * static_cast<int>(sizeof(T))>;
    auto* dst = reinterpret_cast<typename Word<E>::type*>(
        w.codes + at * nvec * E);
    if constexpr (NV > 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (live && g + L * i < nvec) dst[g + L * i] = q[i];
    } else {
      each([&](int j, const Vec& c) { dst[j] = codes_of(c); });
    }
    if (live && g == 0) w.scales[at] = scale;
  }
};

template <typename T, int E, int NV>
__global__ void __launch_bounds__(kThreads)
    scatter_q8_kernel(const Q8Write k, const Q8Write v,
                      const int* __restrict__ table,
                      const int* __restrict__ pos, const Geometry geo, int L,
                      float eps, float recip) {
  __shared__ size_t sSlot[kThreads];  // the slots of a run's tokens
  const int per_block = kThreads / L;  // rows (token, kv head) a block
  const int rows = geo.B * geo.l * geo.Hkv;
  const bool pair = v.upd != nullptr;
  const int tid = threadIdx.x;
  for (int base = blockIdx.x * per_block; base < rows;
       base += gridDim.x * per_block) {
    const int row = base + tid / L;
    Q8Row<T, E, NV> kr{{}, static_cast<const T*>(k.upd) + (size_t)row * geo.D,
                       tid % L, L, geo.D / E, row < rows, 0.f, {}};
    Q8Row<T, E, NV> vr = kr;
    // the loads first, so that they are in flight through the lookup
    kr.load();
    if (pair) {
      vr.src = static_cast<const T*>(v.upd) + (size_t)row * geo.D;
      vr.load();
    }
    // one lookup per token of this run: its position now, so that the
    // codes are computed while the load is in flight, then its page
    const int tok0 = base / geo.Hkv;
    const int ntok = (min(rows, base + per_block) - 1) / geo.Hkv - tok0 + 1;
    const int bt = tok0 + tid;
    const long long p =
        tid < ntok ? (long long)pos[bt / geo.l] + bt % geo.l : 0;
    kr.quantize(eps, recip);
    if (pair) vr.quantize(eps, recip);
    if (tid < ntok)
      sSlot[tid] = slot_at(table, p, bt / geo.l, geo.ps, geo.mp,
                           geo.num_pages);
    __syncthreads();
    // the row's place: its token's slot, its kv head
    const int tok = row / geo.Hkv;
    const size_t at = kr.live ? sSlot[tok - tok0] * geo.Hkv +
                                    (row - tok * geo.Hkv)
                              : 0;
    kr.store(k, at);
    if (pair) vr.store(v, at);
    __syncthreads();  // every sSlot read before the next run writes it
  }
}

// K8-q8's vector: E elements of T, the widest (up to 16 bytes) that
// divides the row and keeps every upd pointer aligned to its bytes and
// every codes pointer to E
template <typename T>
int q8_elems(int D, const Q8Write& k, const Q8Write& v) {
  int e = 16 / static_cast<int>(sizeof(T));
  auto aligned = [](const void* p, int bytes) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  while (e > 1 && (D % e || !aligned(k.upd, e * sizeof(T)) ||
                   !aligned(v.upd, e * sizeof(T)) || !aligned(k.codes, e) ||
                   !aligned(v.codes, e)))
    e /= 2;
  return e;
}

template <typename T, int E, int NV>
int launch_q8_nv(const Q8Write& k, const Q8Write& v, const int* table,
                 const int* pos, const Geometry& geo, int L, float eps,
                 float recip, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kThreads / L;
  const int rows = geo.B * geo.l * geo.Hkv;
  const int need = (rows + per_block - 1) / per_block;
  // one wave: at most 8 blocks of kThreads an SM (2,048 threads)
  const int blocks = need < 8 * sms ? need : 8 * sms;
  scatter_q8_kernel<T, E, NV><<<blocks, kThreads, 0, stream>>>(
      k, v, table, pos, geo, L, eps, recip);
  return static_cast<int>(cudaGetLastError());
}

// the group size L (lanes a row) and the vectors a lane holds for rows of
// nvec vectors: one vector a lane up to 32 vectors, then 2 and 4 in 32
// lanes, past 128 vectors re-read
template <typename T, int E>
int launch_q8_e(const Q8Write& k, const Q8Write& v, const int* table,
                const int* pos, const Geometry& geo, float eps, float recip,
                int device, cudaStream_t s) {
  const int nvec = geo.D / E;
  int L = 1;
  while (L < nvec && L < 32) L *= 2;
  const auto go = [&](auto nv) {
    return launch_q8_nv<T, E, decltype(nv)::value>(k, v, table, pos, geo, L,
                                                   eps, recip, device, s);
  };
  if (nvec <= 32) return go(std::integral_constant<int, 1>{});
  if (nvec <= 64) return go(std::integral_constant<int, 2>{});
  if (nvec <= 128) return go(std::integral_constant<int, 4>{});
  return go(std::integral_constant<int, 0>{});
}

template <typename T>
int launch_q8(const Q8Write& k, const Q8Write& v, const int* table,
              const int* pos, const Geometry& geo, float eps, float recip,
              int device, cudaStream_t s) {
  switch (q8_elems<T>(geo.D, k, v)) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_q8_e<T, 8>(k, v, table, pos, geo, eps, recip, device,
                                 s);
      break;
    case 4:
      return launch_q8_e<T, 4>(k, v, table, pos, geo, eps, recip, device, s);
    case 2:
      return launch_q8_e<T, 2>(k, v, table, pos, geo, eps, recip, device, s);
    default:
      return launch_q8_e<T, 1>(k, v, table, pos, geo, eps, recip, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// K8-q8. k_upd (and v_upd, or null): [B, l, Hkv, D] of `dtype`; k_codes
// (and v_codes, null with v_upd): int8 [num_pages, ps, Hkv, D] and
// k_scales (v_scales): f32 [num_pages, ps, Hkv], all written in place;
// page_table [B, mp]; pos [B] int32; eps and recip as above. All
// contiguous; K and V share their shapes and dtypes.
extern "C" int ptt_paged_scatter_q8_pair(
    const void* k_upd, void* k_codes, void* k_scales, const void* v_upd,
    void* v_codes, void* v_scales, const void* page_table, const void* pos,
    int B, int l, int Hkv, int D, int ps, int mp, int num_pages, float eps,
    float recip, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((v_upd == nullptr) != (v_codes == nullptr) ||
      (v_codes == nullptr) != (v_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || l == 0 || Hkv == 0 || D == 0) return 0;
  if ((long long)B * l * Hkv > INT_MAX / 2)  // rows count in int
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry geo{B, l, Hkv, D, ps, mp, num_pages};
  const Q8Write k{k_upd, static_cast<int8_t*>(k_codes),
                  static_cast<float*>(k_scales)};
  const Q8Write v{v_upd, static_cast<int8_t*>(v_codes),
                  static_cast<float*>(v_scales)};
  const int* tab = static_cast<const int*>(page_table);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_q8<float>(k, v, tab, p, geo, eps, recip, device, s);
    case ptt::kBF16:
      return launch_q8<__nv_bfloat16>(k, v, tab, p, geo, eps, recip, device,
                                      s);
    case ptt::kF16:
      return launch_q8<__half>(k, v, tab, p, geo, eps, recip, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8-q8, one write (the entry's signature since K8-q8 was ported): upd
// as K8's; codes: int8 [num_pages, ps, Hkv, D] and scales: f32
// [num_pages, ps, Hkv], both written in place; eps and recip as above.
extern "C" int ptt_paged_scatter_q8(const void* upd, void* codes,
                                    void* scales, const void* page_table,
                                    const void* pos, int B, int l, int Hkv,
                                    int D, int ps, int mp, int num_pages,
                                    float eps, float recip, int dtype,
                                    int device, void* stream) {
  return ptt_paged_scatter_q8_pair(upd, codes, scales, nullptr, nullptr,
                                   nullptr, page_table, pos, B, l, Hkv, D,
                                   ps, mp, num_pages, eps, recip, dtype,
                                   device, stream);
}
