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
// What bounds it: bytes (a few operations per element). Design: one warp
// per (token, kv head) row, in every lane; lane i takes elements i, i + 32, ... (so a
// warp's loads and stores are contiguous), the row's amax is a warp
// reduction, and lane 0 writes the scale. Several tokens may write the
// same trash slot; which one stays is unspecified, and a trash slot's
// codes and scale may come from different tokens (trash keys are masked,
// and every value written is finite for finite input). A page id outside
// [0, num_pages) is sent to the trash page instead of faulting.
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
    scatter_e4m3_kernel(const T* __restrict__ upd,
                        __nv_fp8_storage_t* __restrict__ pool,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, const Geometry geo) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (b, t, g)
  const int lane = threadIdx.x & 31;
  if (row >= geo.B * geo.l * geo.Hkv) return;
  const int g = row % geo.Hkv;
  const int bt = row / geo.Hkv;
  const size_t slot = flat_slot(table, pos, bt / geo.l, bt % geo.l, geo.ps,
                                geo.mp, geo.num_pages);
  const T* src = upd + (size_t)row * geo.D;
  __nv_fp8_storage_t* dst = pool + (slot * geo.Hkv + g) * geo.D;
  for (int d = lane; d < geo.D; d += 32) {
    const float x = ptt::to_f32<T>(src[d]);
    // the clip; a NaN passes unclipped (fminf/fmaxf would make it +-448)
    // and converts to NaN, as clip then convert does in torch and XLA
    const float c = x != x ? x : fminf(fmaxf(x, -448.f), 448.f);
    dst[d] = __nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3);
  }
}

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

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    scatter_cast_kernel(const T* __restrict__ upd, P* __restrict__ pool,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, const Geometry geo) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (b, t, g)
  const int lane = threadIdx.x & 31;
  if (row >= geo.B * geo.l * geo.Hkv) return;
  const int g = row % geo.Hkv;
  const int bt = row / geo.Hkv;
  const size_t slot = flat_slot(table, pos, bt / geo.l, bt % geo.l, geo.ps,
                                geo.mp, geo.num_pages);
  const T* src = upd + (size_t)row * geo.D;
  P* dst = pool + (slot * geo.Hkv + g) * geo.D;
  // through f32: exact from bf16 and f16, one rounding into the pool
  for (int d = lane; d < geo.D; d += 32)
    dst[d] = ptt::from_f32<P>(ptt::to_f32<T>(src[d]));
}

template <typename T, typename P>
int launch_cast(const void* upd, void* pool, const int* table, const int* pos,
                const Geometry& geo, cudaStream_t stream) {
  const int rows = geo.B * geo.l * geo.Hkv;
  scatter_cast_kernel<T, P><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                              stream>>>(static_cast<const T*>(upd),
                                        static_cast<P*>(pool), table, pos,
                                        geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cast_to(const void* upd, void* pool, const int* table,
                   const int* pos, const Geometry& geo, int pool_dtype,
                   cudaStream_t s) {
  switch (pool_dtype) {
    case ptt::kF32:
      return launch_cast<T, float>(upd, pool, table, pos, geo, s);
    case ptt::kBF16:
      return launch_cast<T, __nv_bfloat16>(upd, pool, table, pos, geo, s);
    case ptt::kF16:
      return launch_cast<T, __half>(upd, pool, table, pos, geo, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_e4m3(const void* upd, void* pool, const int* table,
                const int* pos, const Geometry& geo, cudaStream_t stream) {
  const int rows = geo.B * geo.l * geo.Hkv;
  scatter_e4m3_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                           stream>>>(
      static_cast<const T*>(upd), static_cast<__nv_fp8_storage_t*>(pool),
      table, pos, geo);
  return static_cast<int>(cudaGetLastError());
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

// K8, float lane. upd: [B, l, Hkv, D] of `dtype`; pool: [num_pages, ps,
// Hkv, D] of `pool_dtype` (f32, bf16 or f16), written in place;
// page_table [B, mp]; pos [B] int32. All contiguous.
extern "C" int ptt_paged_scatter_float(const void* upd, void* pool,
                                       const void* page_table,
                                       const void* pos, int B, int l,
                                       int Hkv, int D, int ps, int mp,
                                       int num_pages, int dtype,
                                       int pool_dtype, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || l == 0 || Hkv == 0) return 0;
  const Geometry geo{B, l, Hkv, D, ps, mp, num_pages};
  const int* tab = static_cast<const int*>(page_table);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_cast_to<float>(upd, pool, tab, p, geo, pool_dtype, s);
    case ptt::kBF16:
      return launch_cast_to<__nv_bfloat16>(upd, pool, tab, p, geo,
                                           pool_dtype, s);
    case ptt::kF16:
      return launch_cast_to<__half>(upd, pool, tab, p, geo, pool_dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8, fp8 lane. upd: [B, l, Hkv, D] of `dtype`; pool: e4m3 [num_pages, ps, Hkv, D],
// written in place; page_table [B, mp]; pos [B] int32. All contiguous.
extern "C" int ptt_paged_scatter_e4m3(const void* upd, void* pool,
                                      const void* page_table,
                                      const void* pos, int B, int l, int Hkv,
                                      int D, int ps, int mp, int num_pages,
                                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || l == 0 || Hkv == 0) return 0;
  const Geometry geo{B, l, Hkv, D, ps, mp, num_pages};
  const int* tab = static_cast<const int*>(page_table);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_e4m3<float>(upd, pool, tab, p, geo, s);
    case ptt::kBF16:
      return launch_e4m3<__nv_bfloat16>(upd, pool, tab, p, geo, s);
    case ptt::kF16:
      return launch_e4m3<__half>(upd, pool, tab, p, geo, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
