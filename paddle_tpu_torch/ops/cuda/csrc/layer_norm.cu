// K1 and K2: fused LayerNorm forward and backward for Hopper (sm_90a).
//
// Both take x (and dy) of type T and w, b of type W, T or f32: w and b
// are read and converted to f32 in the kernel, as the TPU kernels cast
// them in their bodies (the wrapper converts weights of any other dtype
// to f32 first, which is exact). y and dx come out in T, dw and db in
// W. Rows are `cols` wide, a multiple of
// the 16-byte vector of T, up to 65536 columns (the JAX package's
// limit); the wrapper routes every other width to plain torch, as the
// JAX package routes it to jnp.
//
// K1 (forward):
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel (launched
// from _fwd_call): y = (x - mean) * rstd * w + b over the last axis,
// with f32 statistics whatever the IO dtype, taken in two passes as the
// TPU kernel's _stats does: the mean, then the mean of the centred
// squares.
//
// What bounds it: bytes. Each row is read once and written once
// (2 * R * C * itemsize bytes, plus w and b), against a handful of
// flops per element, far below the card's flops-per-byte balance. At
// the serving step's [512, 768] in bf16 that is 0.00047 ms, so the
// call's fixed costs, its chain of dependent waits, are most of it.
// Design (the register lane, up to 16 vectors a lane): one warp per
// row. The row is read straight into registers as 16-byte vector loads
// (lane i takes vectors i, i + 32, ...), so both statistics come from
// registers through two warp-shuffle reductions and the row crosses
// device memory exactly once each way. Where the grid is at most two
// blocks an SM (the serving steps: [512, 768] is 128 blocks) and a
// lane's x, w and b fit 128 registers (`early_fits`: up to 8 vectors a
// lane, 4 with f32 weights under 16-bit x), the lane's w and b vectors
// are loaded with the row's, before the first reduction, so one trip to
// memory feeds the whole row (0.00294 against 0.00355 ms at [512, 768]
// bf16 in turns on an H100); on a larger grid (the training step's 4096
// blocks) or a wider row they load after the statistics: held through
// the row's loads they cost the occupancy the stream needs (0.0218
// against 0.0194 ms at [16384, 768]) or spill. Each vector count a lane
// (NV) up to 16 has its instantiation where a common width lands (3 at
// 768 columns in bf16, 6 in f32), so no dead iteration holds registers.
// Four rows (four warps) per block. On an H100 a launch that does
// nothing takes 0.0019 ms back to back and K1 at [16, 768] 0.0026, so at
// serving sizes the launch and one trip to memory are the call. Blocks
// of one warp, a grid capped at one wave with a warp looping over rows,
// the next row's loads issued before a row folds, and x held as raw
// vectors (72 registers; 3 % slower at the training shape) were each
// timed against these in turns and were no faster (`ln_scatter_turns`).
// The per-lane sum order and the shuffle tree are those of every
// earlier version, so y keeps its bits at every width the kernel took.
// The wide lane (rows past 16 vectors a lane, up to 65536 columns): a
// block of 512 threads a row, thread t taking vectors t, t + 512, ...;
// the row is staged in shared memory where it fits (65536 bf16 columns
// are 128 KB) and re-read from L2 where it does not; each statistic is
// every warp's shuffle tree, then the warps in order.
//
// K2 (backward):
// Replaces paddle_tpu/ops/pallas/layer_norm.py::_ln_bwd_kernel (launched
// from _bwd_call; its per-block partials of dw/db are summed outside the
// kernel there). From (dy, x, w) it recomputes the row statistics in
// f32, two-pass, then with xhat = (x - mean) * rstd and a = dy * w:
//   dx = rstd * (a - mean(a) - xhat * mean(a * xhat))   (x's dtype)
//   dw = sum over rows of dy * xhat, db = sum over rows of dy (w's dtype)
// What bounds it: bytes: dy and x are read once and dx written once
// (3 * R * C * itemsize; 75.5 MB at GPT-124M's [16384, 768] in bf16,
// 0.0225 ms at 3.35 TB/s); streaming at that rate needs some 20 KB in
// flight on every SM all the time.
// Design: one warp per row, its dy and x held in registers as their raw
// 16-byte vectors, the four row reductions warp shuffles in a fixed
// order (dx needs no sum across warps or blocks, so its bits do not
// depend on the grid). Persistent blocks of 8 warps fill the SMs (as many as the
// occupancy calculator fits, in whole clusters); warp k of the grid
// takes rows k, k + warps, ... and, up to six vectors a lane (768 columns
// in f32), each lane copies its own vectors of the warp's next two rows
// into a ring in shared memory with cp.async while the current row folds,
// so every warp keeps two rows of loads in flight without holding them in
// registers (a register double buffer spilled at the 128 registers two
// blocks an SM allow). w sits in registers, loaded once per block, and
// each lane keeps dw/db for its columns in f32 registers. On an H100 at
// [16384, 768] bf16 the row walk alone takes 0.030 ms of the 0.040 (the
// bound is 0.0225); the fold, the cluster stage and the last blocks' sums
// the rest. The column sums then cross the card in a
// fixed order, without atomics on values, so dw and db are the same bits
// on every run:
//   - a block folds its warps' sums into shared memory one warp after
//     the other, in warp order;
//   - blocks form clusters of 8 (`__cluster_dims__`): block r of a
//     cluster sums slice r of the 2 x cols columns over the 8 blocks'
//     shared memory (distributed shared memory), in rank order, and
//     writes the cluster's partial of that slice;
//   - the last block to finish slice r (a ticket per slice, the only
//     atomic, reset by that block for the next launch) sums the
//     clusters' partials of the slice in cluster order and rounds once
//     to w's dtype.
// The wide lane (rows past 16 vectors a lane): two launches. First,
// persistent blocks of 512 threads (at most two an SM), a block a row at
// a time (block k takes rows k, k + blocks, ...), x and dy staged in
// shared memory where both fit; the row statistics are two block sums
// in a fixed order (each warp's shuffle tree, then the warps in order):
// the sums of x and of a = dy * w, then those of (x - mean)^2 and of
// a * (x - mean), so mean(a * xhat) is rstd times the latter's mean and
// a row waits on two block sums, not three; a thread's first two vectors
// of the block's next row load while they run (`preload`; K1's wide lane
// likewise). Thread t owns the columns of vectors t, t + 512, ... and
// adds each row's dy * xhat and dy to the block's f32 partials of them,
// in shared memory where they fit beside the row (18944 bf16 columns)
// and in device memory past that, row after row, so they hold no
// registers. Second, a grid of 2 x cols / 32
// blocks sums the blocks' partials column by column, each warp a run of
// blocks in block order and then the warps in order, and rounds once to
// w's dtype, so dw and db are the same bits on every run here too.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

// ---- shared pieces ----------------------------------------------------------

// the register word of N bytes (N = 8 or 16)
template <int N>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};

// E values of w (or b) of type W in registers, as raw words: a lane's
// share beside one 16-byte vector of E values of x. With W = T this is
// one 16-byte vector; f32 weights beside bf16 x take two, bf16 weights
// beside f32 x one of 8 bytes.
template <typename W, int E>
struct WVec {
  static constexpr int kBytes = E * static_cast<int>(sizeof(W));
  static constexpr int kWord = kBytes < 16 ? kBytes : 16;
  using Type = typename Word<kWord>::type;
  Type w[kBytes / kWord];

  // from p, aligned to kWord bytes (the vector's place in w or b)
  __device__ __forceinline__ void load(const W* p) {
#pragma unroll
    for (int i = 0; i < kBytes / kWord; ++i)
      w[i] = __ldg(reinterpret_cast<const Type*>(p) + i);
  }
  __device__ __forceinline__ float at(int k) const {
    return ptt::to_f32<W>(reinterpret_cast<const W*>(w)[k]);
  }
};

// the dtype code (ptt::DType) of T
template <typename T>
constexpr int dtype_code() {
  return std::is_same<T, float>::value           ? ptt::kF32
         : std::is_same<T, __nv_bfloat16>::value ? ptt::kBF16
                                                 : ptt::kF16;
}

// the wide lanes' block size
constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
// and runs at most this many blocks an SM: its partials, nb x 2 x cols
// f32, are written once and read once by the second launch
constexpr int kWideBlocksPerSm = 2;

// the block's sums of a[0..N) (every thread gets them), in a fixed order:
// each warp's shuffle tree, then the warps in order. red: [N][kWideWarps]
// f32 in shared memory, free when called and free again on return.
template <int N>
__device__ __forceinline__ void block_sums(float (&a)[N], float* red) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) a[n] = ptt::warp_sum(a[n]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[n * kWideWarps + warp] = a[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    for (int k = 0; k < kWideWarps; ++k) s += red[n * kWideWarps + k];
    a[n] = s;
  }
  __syncthreads();  // red is free for the next call
}

// the largest dynamic shared memory a block may opt into on `device`,
// less the wide kernels' static shared memory
inline int wide_smem_limit(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return optin - 1024;
}

// the wide lanes' first kPre vectors of a thread's share of a row (t,
// t + kWideThreads, ...): each block loads its next row's into registers
// as soon as the current row's first pass has consumed them, so the next
// row's trip to memory overlaps the current row's block sums
constexpr int kPre = 2;

template <typename T>
__device__ __forceinline__ void preload(uint4 (&v)[kPre],
                                        const T* __restrict__ p, int row,
                                        int rows, int cols, int nvec) {
  if (row >= rows) return;
  const uint4* r = reinterpret_cast<const uint4*>(p + (size_t)row * cols);
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int c = threadIdx.x + i * kWideThreads;
    if (c < nvec) v[i] = __ldg(r + c);
  }
}

// ---- K1 ---------------------------------------------------------------------

constexpr int kWarps = 4;  // the register lane's warps a block, at most

// K1's register lane: NV 16-byte vectors of x a lane. kEarly: w and b
// are loaded with x, before the statistics (the latency of a small
// grid); else after them, holding fewer registers through the loads
// (the throughput of a large one)
template <typename T, typename W, int NV, bool kEarly>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                  const W* __restrict__ b, T* __restrict__ y, int rows,
                  int cols, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = cols / E;
  WVec<W, E> wv[kEarly ? NV : 1], bv[kEarly ? NV : 1];
  if constexpr (kEarly) {  // issued before x's: one trip to memory
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        wv[i].load(w + (size_t)c * E);
        bv[i].load(b + (size_t)c * E);
      }
    }
  }
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * cols);
  float v[NV][E];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      const uint4 raw = __ldg(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        v[i][k] = ptt::to_f32<T>(e[k]);
        sum += v[i][k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) v[i][k] = 0.f;
    }
  }
  const float mean = ptt::warp_sum(sum) / cols;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float d = v[i][k] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(ptt::warp_sum(sq) / cols + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * cols);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      WVec<W, E> wl, bl;  // after the statistics: fewer registers held
      if constexpr (!kEarly) {
        wl.load(w + (size_t)c * E);
        bl.load(b + (size_t)c * E);
      }
      const WVec<W, E>& wi = kEarly ? wv[i] : wl;
      const WVec<W, E>& bi = kEarly ? bv[i] : bl;
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float yv = (v[i][k] - mean) * rstd * wi.at(k) + bi.at(k);
        oe[k] = ptt::from_f32<T>(yv);
      }
      yr[c] = out;
    }
  }
}

// K1's wide lane: a block a row; `stage`: the row is kept in dynamic
// shared memory between its passes (else re-read, from L2)
template <typename T, typename W>
__global__ void __launch_bounds__(kWideThreads)
    ln_fwd_wide_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const W* __restrict__ b, T* __restrict__ y, int rows,
                       int cols, float eps, int stage) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* srow = reinterpret_cast<uint4*>(smem);
  __shared__ float red[kWideWarps];
  const int nvec = cols / E;
  uint4 px[kPre];
  preload(px, x, blockIdx.x, rows, cols, nvec);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * cols);
    // each thread re-reads only the vectors it staged: no barrier needed
    auto vec = [&](int c) { return stage ? srow[c] : __ldg(xr + c); };
    float s[1] = {0.f};
    auto load_pass = [&](int c, const uint4& raw) {
      if (stage) srow[c] = raw;
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < E; ++k) s[0] += ptt::to_f32<T>(e[k]);
    };
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int c = threadIdx.x + i * kWideThreads;
      if (c < nvec) load_pass(c, px[i]);
    }
    for (int c = threadIdx.x + kPre * kWideThreads; c < nvec;
         c += kWideThreads)
      load_pass(c, __ldg(xr + c));
    preload(px, x, row + gridDim.x, rows, cols, nvec);
    block_sums(s, red);
    const float mean = s[0] / cols;
    s[0] = 0.f;
    for (int c = threadIdx.x; c < nvec; c += kWideThreads) {
      const uint4 raw = vec(c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float d = ptt::to_f32<T>(e[k]) - mean;
        s[0] += d * d;
      }
    }
    block_sums(s, red);
    const float rstd = rsqrtf(s[0] / cols + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * cols);
    for (int c = threadIdx.x; c < nvec; c += kWideThreads) {
      const uint4 raw = vec(c);
      WVec<W, E> wv, bv;
      wv.load(w + (size_t)c * E);
      bv.load(b + (size_t)c * E);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float yv =
            (ptt::to_f32<T>(e[k]) - mean) * rstd * wv.at(k) + bv.at(k);
        oe[k] = ptt::from_f32<T>(yv);
      }
      yr[c] = out;
    }
  }
}

// K1's launch for [rows, cols] of T with weights of W on `device`: the
// kernel and its grid
struct FwdLaunch {
  const void* fn;
  int grid, threads, per_lane, wide, early, smem;
  cudaError_t err;
};

// blocks of `threads` (with `smem` dynamic bytes) of fn an SM holds
inline cudaError_t resident_blocks(const void* fn, int threads, int smem,
                                   int device, int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// w and b load early where the grid is at most this many blocks an SM,
// and where x, w and b of a lane fit this many registers (the kEarly
// instantiations: NV up to 8 with weights of x's dtype, 4 with f32
// weights under bf16 or f16 x)
constexpr int kEarlyBlocksPerSm = 2;
constexpr int kEarlyRegs = 128;

template <typename T, typename W, int NV>
constexpr bool early_fits() {
  constexpr int E = 16 / sizeof(T);
  return NV * (E + 2 * static_cast<int>(sizeof(WVec<W, E>)) / 4) <=
         kEarlyRegs;
}

template <typename T, typename W, int NV>
FwdLaunch fwd_launch_nv(int rows, int device) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = (rows + kWarps - 1) / kWarps;
  const void* fn =
      reinterpret_cast<const void*>(ln_fwd_kernel<T, W, NV, false>);
  bool early = false;
  if constexpr (early_fits<T, W, NV>()) {
    early = blocks <= kEarlyBlocksPerSm * sms;
    if (early)
      fn = reinterpret_cast<const void*>(ln_fwd_kernel<T, W, NV, true>);
  }
  return FwdLaunch{fn, blocks > 0 ? blocks : 1, kWarps * 32, NV, 0,
                   early ? 1 : 0, 0, err};
}

template <typename T, typename W>
FwdLaunch fwd_launch_wide(int rows, int cols, int device) {
  const void* fn = reinterpret_cast<const void*>(ln_fwd_wide_kernel<T, W>);
  const int limit = wide_smem_limit(device);
  // the most any row takes: raise the limit once
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (attr != cudaSuccess) return FwdLaunch{fn, 0, 0, 0, 1, 0, 0, attr};
  const int bytes = cols * static_cast<int>(sizeof(T));
  const int smem = bytes <= limit ? bytes : 0;
  int resident = 0;
  const cudaError_t err =
      resident_blocks(fn, kWideThreads, smem, device, &resident);
  const int grid = rows < resident ? rows : resident;
  return FwdLaunch{fn, grid > 0 ? grid : 1, kWideThreads, 0, 1, 0, smem,
                   err};
}

template <typename T, typename W>
FwdLaunch fwd_launch(int rows, int cols, int device) {
  constexpr int E = 16 / sizeof(T);
  const int per_lane = (cols / E + 31) / 32;
  if (per_lane <= 1) return fwd_launch_nv<T, W, 1>(rows, device);
  if (per_lane <= 2) return fwd_launch_nv<T, W, 2>(rows, device);
  if (per_lane <= 3) return fwd_launch_nv<T, W, 3>(rows, device);
  if (per_lane <= 4) return fwd_launch_nv<T, W, 4>(rows, device);
  if (per_lane <= 6) return fwd_launch_nv<T, W, 6>(rows, device);
  if (per_lane <= 8) return fwd_launch_nv<T, W, 8>(rows, device);
  if (per_lane <= 12) return fwd_launch_nv<T, W, 12>(rows, device);
  if (per_lane <= 16) return fwd_launch_nv<T, W, 16>(rows, device);
  return fwd_launch_wide<T, W>(rows, cols, device);
}

// the launch of x's dtype T against its weights' dtype: T or f32
template <typename T>
FwdLaunch fwd_launch_w(int wdtype, int rows, int cols, int device) {
  if (wdtype == ptt::kF32) return fwd_launch<T, float>(rows, cols, device);
  if (wdtype == dtype_code<T>()) return fwd_launch<T, T>(rows, cols, device);
  return FwdLaunch{nullptr, 0, 0, 0, 0, 0, 0, cudaErrorInvalidValue};
}

FwdLaunch fwd_launch_of(int dtype, int wdtype, int rows, int cols,
                        int device) {
  switch (dtype) {
    case ptt::kF32:
      return fwd_launch_w<float>(wdtype, rows, cols, device);
    case ptt::kBF16:
      return fwd_launch_w<__nv_bfloat16>(wdtype, rows, cols, device);
    case ptt::kF16:
      return fwd_launch_w<__half>(wdtype, rows, cols, device);
    default:
      return FwdLaunch{nullptr, 0, 0, 0, 0, 0, 0, cudaErrorInvalidValue};
  }
}

// ---- K2 ---------------------------------------------------------------------

constexpr int kBwdWarps = 8;
// blocks of a cluster: the first cross-block stage of the column sums
constexpr int kCluster = 8;

// stages of a warp's ring (K2's kRing instantiations): the row it folds
// and the next two, in flight
constexpr int kRingRows = 3;

// this thread's cp.async of 16 bytes, shared <- global (bypassing L1)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K2's dynamic shared memory: red[2 * cols] f32, then with the ring
// kRingRows stages of [kBwdWarps][x, dy][NV][32 lanes] 16-byte vectors
__host__ __device__ inline size_t bwd_red_bytes(int cols) {
  return (2 * (size_t)cols * sizeof(float) + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t bwd_smem(int cols, int nv, bool ring) {
  return bwd_red_bytes(cols) +
         (ring ? (size_t)kRingRows * kBwdWarps * 2 * nv * 32 * 16 : 0);
}

// K2 with NV 16-byte vectors a lane. kRing: each lane copies its own
// vectors of its warp's next rows into a ring of kRingRows stages in
// shared memory (cp.async, a commit group a row), so two rows' loads are
// in flight while a row folds and no register holds them; it reads back
// only what it copied, so no barrier stands between a copy and its use
// (up to six vectors: a 768-wide row in f32; wider rows load straight
// into registers). kMinBlocks: blocks an SM the registers must allow.
template <typename T, typename W, int NV, bool kRing, int kMinBlocks>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kBwdWarps * 32, kMinBlocks)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const W* __restrict__ w, T* __restrict__ dx,
                  W* __restrict__ dw, W* __restrict__ db,
                  float* __restrict__ part, int* __restrict__ tickets,
                  int rows, int cols, float eps) {
  namespace cg = cooperative_groups;
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // dw then db of this block
  uint4* ring = reinterpret_cast<uint4*>(smem + bwd_red_bytes(cols));
  __shared__ bool last;
  for (int c = threadIdx.x; c < 2 * cols; c += blockDim.x) red[c] = 0.f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = cols / E;
  WVec<W, E> wv[NV];  // this lane's w beside its x vectors
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) wv[i].load(w + (size_t)c * E);
  }
  float dwacc[NV][E], dbacc[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < E; ++k) dwacc[i][k] = dbacc[i][k] = 0.f;

  // this lane's ring slot for vector i of x (a = 0) or dy (a = 1), stage s
  auto slot = [&](int s, int a, int i) {
    return ring + ((((size_t)s * kBwdWarps + warp) * 2 + a) * NV + i) * 32 +
           lane;
  };
  // start copying this lane's vectors of `row` (if any) into stage s: one
  // commit group either way, so the group count stays in step
  auto issue = [&](int row, int s) {
    if (row < rows) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * cols);
      const uint4* dyr =
          reinterpret_cast<const uint4*>(dy + (size_t)row * cols);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < nvec) {
          cp_async16(slot(s, 0, i), xr + c);
          cp_async16(slot(s, 1, i), dyr + c);
        }
      }
    }
    cp_async_commit();
  };
  const int stride = gridDim.x * kBwdWarps;
  int row = blockIdx.x * kBwdWarps + warp;
  if constexpr (kRing) {
#pragma unroll
    for (int k = 0; k < kRingRows - 1; ++k) issue(row + k * stride, k);
  }
  for (int it = 0; row < rows; ++it, row += stride) {
    uint4 xv[NV], dyv[NV];
    if constexpr (kRing) {
      issue(row + (kRingRows - 1) * stride, (it + kRingRows - 1) % kRingRows);
      cp_async_wait<kRingRows - 1>();  // this row's group has landed
      const int s = it % kRingRows;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (lane + 32 * i < nvec) {
          xv[i] = *slot(s, 0, i);
          dyv[i] = *slot(s, 1, i);
        }
      }
    } else {
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * cols);
      const uint4* dyr =
          reinterpret_cast<const uint4*>(dy + (size_t)row * cols);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < nvec) {
          xv[i] = __ldg(xr + c);
          dyv[i] = __ldg(dyr + c);
        }
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        const T* e = reinterpret_cast<const T*>(&xv[i]);
#pragma unroll
        for (int k = 0; k < E; ++k) sum += ptt::to_f32<T>(e[k]);
      }
    }
    const float mean = ptt::warp_sum(sum) / cols;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        const T* e = reinterpret_cast<const T*>(&xv[i]);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float d = ptt::to_f32<T>(e[k]) - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(ptt::warp_sum(sq) / cols + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < nvec) {
        const T* xe = reinterpret_cast<const T*>(&xv[i]);
        const T* de = reinterpret_cast<const T*>(&dyv[i]);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float g = ptt::to_f32<T>(de[k]);
          const float xhat = (ptt::to_f32<T>(xe[k]) - mean) * rstd;
          const float a = g * wv[i].at(k);
          s1 += a;
          s2 += a * xhat;
          dwacc[i][k] += g * xhat;
          dbacc[i][k] += g;
        }
      }
    }
    const float m1 = ptt::warp_sum(s1) / cols;
    const float m2 = ptt::warp_sum(s2) / cols;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * cols);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        const T* xe = reinterpret_cast<const T*>(&xv[i]);
        const T* de = reinterpret_cast<const T*>(&dyv[i]);
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float xhat = (ptt::to_f32<T>(xe[k]) - mean) * rstd;
          const float a = ptt::to_f32<T>(de[k]) * wv[i].at(k);
          oe[k] = ptt::from_f32<T>(rstd * (a - m1 - xhat * m2));
        }
        dxr[c] = out;
      }
    }
  }
  if constexpr (kRing) cp_async_wait<0>();  // no copy outlives the block
  // fold the warps' sums into red[] one warp at a time, in warp order
  // (each lane owns its columns, so a warp's adds do not collide), a
  // vector's sums read as float4s before any is written back (scalar
  // read-modify-writes, which the compiler must keep in order, took 12 us
  // of a [16384, 768] call on an H100)
  for (int turn = 0; turn < kBwdWarps; ++turn) {
    __syncthreads();  // red[] is zeroed, or the previous warp is done
    if (warp == turn) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < nvec) {
          float4* rw = reinterpret_cast<float4*>(red + c * E);
          float4* rb = reinterpret_cast<float4*>(red + cols + c * E);
          float4 sw[E / 4], sb[E / 4];
#pragma unroll
          for (int f = 0; f < E / 4; ++f) {
            sw[f] = rw[f];
            sb[f] = rb[f];
          }
#pragma unroll
          for (int f = 0; f < E / 4; ++f) {
            sw[f].x += dwacc[i][4 * f];
            sw[f].y += dwacc[i][4 * f + 1];
            sw[f].z += dwacc[i][4 * f + 2];
            sw[f].w += dwacc[i][4 * f + 3];
            sb[f].x += dbacc[i][4 * f];
            sb[f].y += dbacc[i][4 * f + 1];
            sb[f].z += dbacc[i][4 * f + 2];
            sb[f].w += dbacc[i][4 * f + 3];
            rw[f] = sw[f];
            rb[f] = sb[f];
          }
        }
      }
    }
  }
  // the cluster's partial of slice r (of the 2 x cols sums): block r adds
  // the 8 blocks' red[] slices in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's red[] is whole
  const int r = static_cast<int>(cluster.block_rank());
  const int per = 2 * cols / kCluster;  // cols is a multiple of 4
  const int lo = r * per;
  const int nc = gridDim.x / kCluster;
  float* mine = part + (size_t)(blockIdx.x / kCluster) * 2 * cols + lo;
  for (int j = threadIdx.x; j < per; j += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kCluster; ++k)
      s += cluster.map_shared_rank(red, k)[lo + j];
    mine[j] = s;
  }
  cluster.sync();  // no block leaves while another reads its red[]
  // the last block to finish slice r sums the clusters' partials of it
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + r, 1) == nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < per; j += blockDim.x) {
    const float* p = part + lo + j;
    float s = 0.f;
    // 32 clusters' partials loaded together, then added in cluster order
    // (a loop of one load an add waited out each load's latency in turn)
    for (int k0 = 0; k0 < nc; k0 += 32) {
      float v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        v[u] = k0 + u < nc ? __ldcg(p + (size_t)(k0 + u) * 2 * cols) : 0.f;
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (k0 + u < nc) s += v[u];
    }
    const int c = lo + j;
    (c < cols ? dw[c] : db[c - cols]) = ptt::from_f32<W>(s);
  }
  if (threadIdx.x == 0) tickets[r] = 0;  // ready for the next launch
}

// K2's wide lane, its first launch: a block a row (see the top). The
// dynamic shared memory holds x's and dy's row where `stage` (else they
// are re-read), then this block's f32 partials of dw and db where
// `spart` (else they live in `part` only). part: [gridDim.x][2 * cols]
// f32, this block's dw then db partials, summed by ln_bwd_colsum_kernel.
// Two block sums a row: (sum x, sum a) with a = dy * w, then
// (sum (x - mean)^2, sum a * (x - mean)), so mean(a * xhat) is rstd
// times the second's mean.
template <typename T, typename W>
__global__ void __launch_bounds__(kWideThreads)
    ln_bwd_wide_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                       const W* __restrict__ w, T* __restrict__ dx,
                       float* __restrict__ part, int rows, int cols,
                       float eps, int stage, int spart) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kWideWarps];
  const int nvec = cols / E;
  uint4* sx = reinterpret_cast<uint4*>(smem);
  uint4* sdy = sx + nvec;
  float* mine = part + (size_t)blockIdx.x * 2 * cols;
  // the partials this block adds its rows into: thread t owns the
  // columns of its vectors there, so no barrier guards them
  float* acc =
      spart ? reinterpret_cast<float*>(smem + 2 * 16 * (size_t)nvec) : mine;
  uint4 px[kPre], pd[kPre];
  preload(px, x, blockIdx.x, rows, cols, nvec);
  preload(pd, dy, blockIdx.x, rows, cols, nvec);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * cols);
    const uint4* dyr =
        reinterpret_cast<const uint4*>(dy + (size_t)row * cols);
    // each thread re-reads only the vectors it staged: no barrier needed
    auto xvec = [&](int c) { return stage ? sx[c] : __ldg(xr + c); };
    auto dyvec = [&](int c) { return stage ? sdy[c] : __ldg(dyr + c); };
    float s[2] = {0.f, 0.f};
    auto load_pass = [&](int c, const uint4& xraw, const uint4& draw) {
      if (stage) {
        sx[c] = xraw;
        sdy[c] = draw;
      }
      WVec<W, E> wv;
      wv.load(w + (size_t)c * E);
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* de = reinterpret_cast<const T*>(&draw);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        s[0] += ptt::to_f32<T>(xe[k]);
        s[1] += ptt::to_f32<T>(de[k]) * wv.at(k);
      }
    };
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int c = threadIdx.x + i * kWideThreads;
      if (c < nvec) load_pass(c, px[i], pd[i]);
    }
    for (int c = threadIdx.x + kPre * kWideThreads; c < nvec;
         c += kWideThreads)
      load_pass(c, __ldg(xr + c), __ldg(dyr + c));
    preload(px, x, row + gridDim.x, rows, cols, nvec);
    preload(pd, dy, row + gridDim.x, rows, cols, nvec);
    block_sums(s, red);
    const float mean = s[0] / cols;
    const float m1 = s[1] / cols;
    s[0] = s[1] = 0.f;
    for (int c = threadIdx.x; c < nvec; c += kWideThreads) {
      const uint4 xraw = xvec(c), draw = dyvec(c);
      WVec<W, E> wv;
      wv.load(w + (size_t)c * E);
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* de = reinterpret_cast<const T*>(&draw);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float d = ptt::to_f32<T>(xe[k]) - mean;
        s[0] += d * d;
        s[1] += ptt::to_f32<T>(de[k]) * wv.at(k) * d;
      }
    }
    block_sums(s, red);
    const float rstd = rsqrtf(s[0] / cols + eps);
    const float m2 = rstd * s[1] / cols;
    const bool first = row == static_cast<int>(blockIdx.x);
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * cols);
    for (int c = threadIdx.x; c < nvec; c += kWideThreads) {
      const uint4 xraw = xvec(c), draw = dyvec(c);
      WVec<W, E> wv;
      wv.load(w + (size_t)c * E);
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* de = reinterpret_cast<const T*>(&draw);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
      float pw[E], pb[E];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float g = ptt::to_f32<T>(de[k]);
        const float xhat = (ptt::to_f32<T>(xe[k]) - mean) * rstd;
        oe[k] = ptt::from_f32<T>(rstd * (g * wv.at(k) - m1 - xhat * m2));
        pw[k] = g * xhat;
        pb[k] = g;
      }
      dxr[c] = out;
      // the vector's columns' partials: this block's rows in order
      float4* rw = reinterpret_cast<float4*>(acc + (size_t)c * E);
      float4* rb = reinterpret_cast<float4*>(acc + cols + (size_t)c * E);
#pragma unroll
      for (int f = 0; f < E / 4; ++f) {
        float4 sw = make_float4(0.f, 0.f, 0.f, 0.f), sb = sw;
        if (!first) {
          sw = rw[f];
          sb = rb[f];
        }
        sw.x += pw[4 * f];
        sw.y += pw[4 * f + 1];
        sw.z += pw[4 * f + 2];
        sw.w += pw[4 * f + 3];
        sb.x += pb[4 * f];
        sb.y += pb[4 * f + 1];
        sb.z += pb[4 * f + 2];
        sb.w += pb[4 * f + 3];
        rw[f] = sw;
        rb[f] = sb;
      }
    }
  }
  if (static_cast<int>(blockIdx.x) >= rows) {  // a block without rows
    for (int j = threadIdx.x; j < 2 * cols; j += kWideThreads) mine[j] = 0.f;
  } else if (spart) {  // each thread copies the columns it owns
    for (int c = threadIdx.x; c < nvec; c += kWideThreads) {
#pragma unroll
      for (int f = 0; f < E / 4; ++f) {
        reinterpret_cast<float4*>(mine + (size_t)c * E)[f] =
            reinterpret_cast<const float4*>(acc + (size_t)c * E)[f];
        reinterpret_cast<float4*>(mine + cols + (size_t)c * E)[f] =
            reinterpret_cast<const float4*>(acc + cols + (size_t)c * E)[f];
      }
    }
  }
}

// K2's wide lane, its second launch: dw then db (column j of 2 * cols)
// are the nb blocks' partials summed over the blocks in a fixed order
// and rounded once to W. A block takes 32 columns: warp g sums blocks
// [g * per, (g + 1) * per) in block order, then the warps' sums are
// added in warp order, so the sums are spread over 2 * cols / 32 blocks
// and are the same bits on every run.
constexpr int kSumWarps = 8;

template <typename W>
__global__ void __launch_bounds__(kSumWarps * 32)
    ln_bwd_colsum_kernel(const float* __restrict__ part, int nb, int cols,
                         W* __restrict__ dw, W* __restrict__ db) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int n2 = 2 * cols;
  const int j = blockIdx.x * 32 + lane;
  const int per = (nb + kSumWarps - 1) / kSumWarps;
  const int lo = g * per;
  const int hi = lo + per < nb ? lo + per : nb;
  float s = 0.f;
  if (j < n2) {
    const float* p = part + j;
    // 16 blocks' partials loaded together, then added in block order
    for (int k0 = lo; k0 < hi; k0 += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        v[u] = k0 + u < hi ? p[(size_t)(k0 + u) * n2] : 0.f;
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (k0 + u < hi) s += v[u];
    }
  }
  red[g][lane] = s;
  __syncthreads();
  if (g == 0 && j < n2) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kSumWarps; ++q) t += red[q][lane];
    (j < cols ? dw[j] : db[j - cols]) = ptt::from_f32<W>(t);
  }
}

// the kernel for rows of cols elements of T with weights of W, and what
// its launch needs
struct BwdKernel {
  const void* fn;
  int per_lane, ring, wide;
  cudaError_t attr;  // of raising its dynamic shared memory limit
  const void* colsum;  // the wide lane's second launch
};

template <typename T, typename W, int NV>
BwdKernel bwd_kernel_nv() {
  constexpr int E = 16 / sizeof(T);
  constexpr bool kRing = NV <= 6;
  // 32-bit registers the row walk holds: dy and x, w and the f32 sums;
  // two blocks an SM where that leaves room
  constexpr int regs =
      NV * (4 * 2 + static_cast<int>(sizeof(WVec<W, E>)) / 4) + 2 * NV * E;
  constexpr int kMin = regs <= 112 ? 2 : 1;
  const void* fn =
      reinterpret_cast<const void*>(ln_bwd_kernel<T, W, NV, kRing, kMin>);
  // the most this instantiation takes: its widest row (32 NV vectors)
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bwd_smem(32 * NV * E, NV, kRing)));
  return BwdKernel{fn, NV, kRing, 0, attr, nullptr};
}

template <typename T, typename W>
BwdKernel bwd_kernel_wide(int device) {
  const void* fn = reinterpret_cast<const void*>(ln_bwd_wide_kernel<T, W>);
  static const cudaError_t attr =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           wide_smem_limit(device));
  return BwdKernel{fn, 0, 0, 1, attr,
                   reinterpret_cast<const void*>(ln_bwd_colsum_kernel<W>)};
}

template <typename T, typename W>
BwdKernel bwd_kernel(int cols, int device) {
  constexpr int E = 16 / sizeof(T);
  const int per_lane = (cols / E + 31) / 32;
  // 3 and 6: a 768-wide row in bf16 and f32 (GPT-124M) without
  // registers for vectors it never loads
  if (per_lane <= 1) return bwd_kernel_nv<T, W, 1>();
  if (per_lane <= 2) return bwd_kernel_nv<T, W, 2>();
  if (per_lane <= 3) return bwd_kernel_nv<T, W, 3>();
  if (per_lane <= 4) return bwd_kernel_nv<T, W, 4>();
  if (per_lane <= 6) return bwd_kernel_nv<T, W, 6>();
  if (per_lane <= 8) return bwd_kernel_nv<T, W, 8>();
  if (per_lane <= 16) return bwd_kernel_nv<T, W, 16>();
  return bwd_kernel_wide<T, W>(device);
}

// the kernel of x's dtype T against its weights' dtype: T or f32
template <typename T>
BwdKernel bwd_kernel_w(int wdtype, int cols, int device) {
  if (wdtype == ptt::kF32) return bwd_kernel<T, float>(cols, device);
  if (wdtype == dtype_code<T>()) return bwd_kernel<T, T>(cols, device);
  return BwdKernel{nullptr, 0, 0, 0, cudaSuccess, nullptr};
}

BwdKernel bwd_kernel_of(int dtype, int wdtype, int cols, int device) {
  switch (dtype) {
    case ptt::kF32:
      return bwd_kernel_w<float>(wdtype, cols, device);
    case ptt::kBF16:
      return bwd_kernel_w<__nv_bfloat16>(wdtype, cols, device);
    case ptt::kF16:
      return bwd_kernel_w<__half>(wdtype, cols, device);
    default:
      return BwdKernel{nullptr, 0, 0, 0, cudaSuccess, nullptr};
  }
}

// K2's wide lane's dynamic shared memory: x's and dy's row where they
// fit, then the block's f32 partials of dw and db where those fit too
struct WideSmem {
  int bytes, stage, spart;
};

WideSmem bwd_wide_smem(int cols, int itemsize, int device) {
  const long long limit = wide_smem_limit(device);
  const long long row = 2LL * cols * itemsize, sums = 8LL * cols;
  if (row + sums <= limit)
    return WideSmem{static_cast<int>(row + sums), 1, 1};
  if (row <= limit) return WideSmem{static_cast<int>(row), 1, 0};
  return WideSmem{0, 0, 0};
}

int itemsize_of(int dtype) { return dtype == ptt::kF32 ? 4 : 2; }

}  // namespace

// K1's launch for [rows, cols] of `dtype` with weights of `wdtype` on
// `device`, written to out[6]: the grid's blocks, threads a block, 16-byte
// vectors a lane (the register lane's instantiation; 0 in the wide lane),
// 1 for the wide lane, 1 where w and b load with x (the register lane at
// up to kEarlyBlocksPerSm blocks an SM, where early_fits), and the wide
// lane's dynamic shared memory (the staged row, 0 where the row is
// re-read). Returns cudaErrorInvalidValue
// for a dtype the kernel does not take (`wdtype` must be `dtype` or f32).
extern "C" int ptt_layer_norm_fwd_plan(int rows, int cols, int dtype,
                                       int wdtype, int device, int* out) {
  if (cols < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FwdLaunch l = fwd_launch_of(dtype, wdtype, rows, cols, device);
  if (l.fn == nullptr || l.err != cudaSuccess)
    return static_cast<int>(l.fn == nullptr ? cudaErrorInvalidValue : l.err);
  const int vals[6] = {l.grid, l.threads, l.per_lane, l.wide, l.early,
                       l.smem};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

// x, y: [rows, cols] contiguous of `dtype`; w, b: [cols] of `wdtype`
// (`dtype` or f32). cols must be a multiple of the 16-byte vector of
// `dtype` and at most 65536 (the wrapper checks both); every pointer
// 16-byte aligned.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, int rows, int cols, float eps,
                                  int dtype, int wdtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const FwdLaunch l = fwd_launch_of(dtype, wdtype, rows, cols, device);
  if (l.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (l.err != cudaSuccess) return static_cast<int>(l.err);
  int stage = l.smem > 0;
  void* args[] = {&x, &w, &b, &y, &rows, &cols, &eps, &stage};
  err = cudaLaunchKernel(l.fn, dim3(l.grid), dim3(l.threads), args, l.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2's launch for [rows, cols] rows of `dtype` with weights of `wdtype`
// on `device`, written to out[7]: the grid's blocks (whole clusters in
// the register lane), blocks a cluster (1 in the wide lane), the
// clusters (wide lane: blocks) the card holds at once (the occupancy
// calculator's), 16-byte vectors a lane (in the wide lane: a thread's
// vectors whose partials it holds in registers, 0 where they go to device
// memory row by row), 1 if rows come through the cp.async ring, the f32
// partials the launch needs, and 1 for the wide lane. Returns
// cudaErrorInvalidValue for a dtype the kernel does not take (`wdtype`
// must be `dtype` or f32).
extern "C" int ptt_layer_norm_bwd_plan(int rows, int cols, int dtype,
                                       int wdtype, int device, int* out) {
  if (cols < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdKernel k = bwd_kernel_of(dtype, wdtype, cols, device);
  if (k.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (k.attr != cudaSuccess) return static_cast<int>(k.attr);
  int vals[7];
  if (k.wide) {
    int resident = 0;
    const int smem = bwd_wide_smem(cols, itemsize_of(dtype), device).bytes;
    err = resident_blocks(k.fn, kWideThreads, smem, device, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int nb = rows < resident ? rows : resident;
    if (nb > kWideBlocksPerSm * sms) nb = kWideBlocksPerSm * sms;
    if (nb < 1) nb = 1;
    const int v[7] = {nb, 1, resident, k.per_lane, 0, nb * 2 * cols, 1};
    for (int i = 0; i < 7; ++i) vals[i] = v[i];
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kBwdWarps * 32);
    cfg.dynamicSmemBytes = bwd_smem(cols, k.per_lane, k.ring);
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(&resident, k.fn, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    // persistent blocks: the clusters the card holds at once, no more
    // than the rows need
    const long long need =
        ((long long)rows + kBwdWarps * kCluster - 1) / (kBwdWarps * kCluster);
    long long clusters = resident > 0 ? resident : 1;
    if (need < clusters) clusters = need > 0 ? need : 1;
    const int nc = static_cast<int>(clusters);
    const int r[7] = {nc * kCluster, kCluster, resident, k.per_lane,
                      k.ring, nc * 2 * cols, 0};
    for (int i = 0; i < 7; ++i) vals[i] = r[i];
  }
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

// dy, x, dx: [rows, cols] contiguous of `dtype`; w, dw, db: [cols] of
// `wdtype`; cols as for the forward. grid: the plan's blocks (a multiple
// of kCluster in the register lane); part: f32 scratch of the plan's
// partials; tickets: kCluster int32 counters, zero before the first launch
// and left zero by every launch (K2 launches on one stream at a time
// share them; the wide lane uses none). The wide lane is two launches:
// the rows, then the column sums.
extern "C" int ptt_layer_norm_bwd(const void* dy, const void* x,
                                  const void* w, void* dx, void* dw,
                                  void* db, void* part, void* tickets,
                                  int rows, int cols, int grid, float eps,
                                  int dtype, int wdtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdKernel k = bwd_kernel_of(dtype, wdtype, cols, device);
  if (k.fn == nullptr || rows < 0 || grid < 1 ||
      (!k.wide && (grid < kCluster || grid % kCluster)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k.attr != cudaSuccess) return static_cast<int>(k.attr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k.wide) {
    WideSmem m = bwd_wide_smem(cols, itemsize_of(dtype), device);
    void* args[] = {&dy, &x, &w, &dx, &part, &rows, &cols, &eps, &m.stage,
                    &m.spart};
    err = cudaLaunchKernel(k.fn, dim3(grid), dim3(kWideThreads), args,
                           m.bytes, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* sum_args[] = {&part, &grid, &cols, &dw, &db};
    err = cudaLaunchKernel(k.colsum, dim3((2 * cols + 31) / 32),
                           dim3(kSumWarps * 32), sum_args, 0, s);
  } else {
    const size_t smem = bwd_smem(cols, k.per_lane, k.ring);
    void* args[] = {&dy, &x, &w, &dx, &dw, &db, &part, &tickets, &rows,
                    &cols, &eps};
    err = cudaLaunchKernel(k.fn, dim3(grid), dim3(kBwdWarps * 32), args, smem,
                           s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
