// K1 and K2: fused LayerNorm forward and backward for Hopper (sm_90a).
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
// flops per element, far below the card's flops-per-byte balance.
// Design: one warp per row. The row is read straight into registers as
// 16-byte vector loads (lane i takes vectors i, i + 32, ...), so both
// statistics come from registers through two warp-shuffle reductions
// and the row crosses device memory exactly once each way. Four rows
// (four warps) per block keep blocks small so a [512, 768] input
// already spreads over 128 SMs.
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
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ b, T* __restrict__ y, int rows,
                  int cols, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = cols / E;
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
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const uint4* br = reinterpret_cast<const uint4*>(b);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * cols);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      const uint4 wraw = __ldg(wr + c);
      const uint4 braw = __ldg(br + c);
      const T* we = reinterpret_cast<const T*>(&wraw);
      const T* be = reinterpret_cast<const T*>(&braw);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float yv = (v[i][k] - mean) * rstd * ptt::to_f32<T>(we[k]) +
                         ptt::to_f32<T>(be[k]);
        oe[k] = ptt::from_f32<T>(yv);
      }
      yr[c] = out;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int cols, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int per_lane = (cols / E + 31) / 32;
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(b);
  T* yp = static_cast<T*>(y);
  if (per_lane <= 1)
    ln_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, cols, eps);
  else if (per_lane <= 2)
    ln_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, cols, eps);
  else if (per_lane <= 4)
    ln_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, cols, eps);
  else if (per_lane <= 8)
    ln_fwd_kernel<T, 8><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, cols, eps);
  else if (per_lane <= 16)
    ln_fwd_kernel<T, 16><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, cols, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

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
template <typename T, int NV, bool kRing, int kMinBlocks>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kBwdWarps * 32, kMinBlocks)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const T* __restrict__ w, T* __restrict__ dx,
                  T* __restrict__ dw, T* __restrict__ db,
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
  uint4 wv[NV];  // this lane's w vectors
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) wv[i] = __ldg(reinterpret_cast<const uint4*>(w) + c);
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
        const T* we = reinterpret_cast<const T*>(&wv[i]);
        const T* xe = reinterpret_cast<const T*>(&xv[i]);
        const T* de = reinterpret_cast<const T*>(&dyv[i]);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float g = ptt::to_f32<T>(de[k]);
          const float xhat = (ptt::to_f32<T>(xe[k]) - mean) * rstd;
          const float a = g * ptt::to_f32<T>(we[k]);
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
        const T* we = reinterpret_cast<const T*>(&wv[i]);
        const T* xe = reinterpret_cast<const T*>(&xv[i]);
        const T* de = reinterpret_cast<const T*>(&dyv[i]);
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float xhat = (ptt::to_f32<T>(xe[k]) - mean) * rstd;
          const float a = ptt::to_f32<T>(de[k]) * ptt::to_f32<T>(we[k]);
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
    (c < cols ? dw[c] : db[c - cols]) = ptt::from_f32<T>(s);
  }
  if (threadIdx.x == 0) tickets[r] = 0;  // ready for the next launch
}

// the kernel for rows of cols elements of T, and what its launch needs
struct BwdKernel {
  const void* fn;
  int per_lane, ring;
  cudaError_t attr;  // of raising its dynamic shared memory limit
};

template <typename T, int NV>
BwdKernel bwd_kernel_nv() {
  constexpr int E = 16 / sizeof(T);
  constexpr bool kRing = NV <= 6;
  // 32-bit registers the row walk holds: w, dy and x and the f32 sums;
  // two blocks an SM where that leaves room
  constexpr int regs = NV * 4 * 3 + 2 * NV * E;
  constexpr int kMin = regs <= 112 ? 2 : 1;
  const void* fn =
      reinterpret_cast<const void*>(ln_bwd_kernel<T, NV, kRing, kMin>);
  // the most this instantiation takes: its widest row (32 NV vectors)
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bwd_smem(32 * NV * E, NV, kRing)));
  return BwdKernel{fn, NV, kRing, attr};
}

template <typename T>
BwdKernel bwd_kernel(int cols) {
  constexpr int E = 16 / sizeof(T);
  const int per_lane = (cols / E + 31) / 32;
  // 3 and 6: a 768-wide row in bf16 and f32 (GPT-124M) without
  // registers for vectors it never loads
  if (per_lane <= 1) return bwd_kernel_nv<T, 1>();
  if (per_lane <= 2) return bwd_kernel_nv<T, 2>();
  if (per_lane <= 3) return bwd_kernel_nv<T, 3>();
  if (per_lane <= 4) return bwd_kernel_nv<T, 4>();
  if (per_lane <= 6) return bwd_kernel_nv<T, 6>();
  if (per_lane <= 8) return bwd_kernel_nv<T, 8>();
  if (per_lane <= 16) return bwd_kernel_nv<T, 16>();
  return BwdKernel{nullptr, 0, 0, cudaSuccess};
}

BwdKernel bwd_kernel_of(int dtype, int cols) {
  switch (dtype) {
    case ptt::kF32:
      return bwd_kernel<float>(cols);
    case ptt::kBF16:
      return bwd_kernel<__nv_bfloat16>(cols);
    case ptt::kF16:
      return bwd_kernel<__half>(cols);
    default:
      return BwdKernel{nullptr, 0, 0, cudaSuccess};
  }
}

}  // namespace

// x, y: [rows, cols] contiguous; w, b: [cols]; all of one dtype.
// cols must be a multiple of the 16-byte vector width (the wrapper
// checks this and the maximum width).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, int rows, int cols, float eps,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch<float>(x, w, b, y, rows, cols, eps, s);
    case ptt::kBF16:
      return launch<__nv_bfloat16>(x, w, b, y, rows, cols, eps, s);
    case ptt::kF16:
      return launch<__half>(x, w, b, y, rows, cols, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2's launch for [rows, cols] rows of `dtype` on `device`, written to
// out[6]: the grid's blocks (whole clusters), blocks a cluster, the
// clusters the card holds at once (the occupancy calculator's), 16-byte
// vectors a lane, 1 if rows come through the cp.async ring, and the f32
// partials the launch needs (2 * cols a cluster). Returns
// cudaErrorInvalidValue for a dtype or width the kernel does not take.
extern "C" int ptt_layer_norm_bwd_plan(int rows, int cols, int dtype,
                                       int device, int* out) {
  const BwdKernel k = bwd_kernel_of(dtype, cols);
  if (k.fn == nullptr || cols < 1 || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k.attr != cudaSuccess) return static_cast<int>(k.attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kBwdWarps * 32);
  cfg.dynamicSmemBytes = bwd_smem(cols, k.per_lane, k.ring);
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, k.fn, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: the clusters the card holds at once, no more than
  // the rows need
  const long long need =
      ((long long)rows + kBwdWarps * kCluster - 1) / (kBwdWarps * kCluster);
  long long clusters = resident > 0 ? resident : 1;
  if (need < clusters) clusters = need > 0 ? need : 1;
  const int nc = static_cast<int>(clusters);
  const int vals[6] = {nc * kCluster, kCluster, resident, k.per_lane,
                       k.ring, nc * 2 * cols};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

// dy, x, dx: [rows, cols] contiguous; w, dw, db: [cols]; all of one
// dtype; cols as for the forward. grid: the plan's blocks (a multiple of
// kCluster); part: f32 scratch of grid / kCluster * 2 * cols; tickets:
// kCluster int32 counters, zero before the first launch and left zero by
// every launch (K2 launches on one stream at a time share them).
extern "C" int ptt_layer_norm_bwd(const void* dy, const void* x,
                                  const void* w, void* dx, void* dw,
                                  void* db, void* part, void* tickets,
                                  int rows, int cols, int grid, float eps,
                                  int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdKernel k = bwd_kernel_of(dtype, cols);
  if (k.fn == nullptr || grid < kCluster || grid % kCluster || rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k.attr != cudaSuccess) return static_cast<int>(k.attr);
  const size_t smem = bwd_smem(cols, k.per_lane, k.ring);
  void* args[] = {&dy, &x, &w, &dx, &dw, &db, &part, &tickets, &rows,
                  &cols, &eps};
  err = cudaLaunchKernel(k.fn, dim3(grid), dim3(kBwdWarps * 32), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
