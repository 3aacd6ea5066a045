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
// from _bwd_call). From (dy, x, w) it recomputes the row statistics in
// f32, two-pass, then with xhat = (x - mean) * rstd and a = dy * w:
//   dx = rstd * (a - mean(a) - xhat * mean(a * xhat))   (x's dtype)
//   dw = sum over rows of dy * xhat, db = sum over rows of dy (w's dtype)
// What bounds it: bytes again: dy and x are read once and dx written
// once (3 * R * C * itemsize), the f32 partials are small.
// Design: one warp per row, as K1, with dy and x held in registers as
// their raw 16-byte vectors; a block's warps walk rows in a grid-stride
// loop and keep dw/db for their lane's columns in f32 registers. At the
// end the block's warps add their sums into shared memory, one warp
// after the other in warp order, and the block writes one f32 partial
// row each for dw and db. A second small kernel sums the partial rows
// in a fixed order and rounds once to w's dtype — the TPU kernel's
// per-block partials summed outside. No atomics anywhere: dw and db are
// the same bits from run to run.
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

template <typename T, int NV>
__global__ void __launch_bounds__(kBwdWarps * 32)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const T* __restrict__ w, T* __restrict__ dx,
                  float* __restrict__ part, int rows, int cols, float eps) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ float red[];  // [2 * cols]: dw then db of this block
  for (int c = threadIdx.x; c < 2 * cols; c += blockDim.x) red[c] = 0.f;
  const int lane = threadIdx.x & 31;
  const int nvec = cols / E;
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  float dwacc[NV][E], dbacc[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < E; ++k) dwacc[i][k] = dbacc[i][k] = 0.f;

  for (int row = blockIdx.x * kBwdWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kBwdWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * cols);
    const uint4* dyr =
        reinterpret_cast<const uint4*>(dy + (size_t)row * cols);
    uint4 xv[NV], dyv[NV];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + 32 * i;
      if (c < nvec) {
        xv[i] = __ldg(xr + c);
        dyv[i] = __ldg(dyr + c);
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
      const int c = lane + 32 * i;
      if (c < nvec) {
        const uint4 wraw = __ldg(wr + c);
        const T* we = reinterpret_cast<const T*>(&wraw);
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
        const uint4 wraw = __ldg(wr + c);
        const T* we = reinterpret_cast<const T*>(&wraw);
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
  // fold the warps' sums into red[] one warp at a time, in warp order
  // (each lane owns its columns, so a warp's adds do not collide): the
  // same inputs give the same bits on every run
  const int warp = threadIdx.x >> 5;
  for (int turn = 0; turn < kBwdWarps; ++turn) {
    __syncthreads();  // red[] is zeroed, or the previous warp is done
    if (warp == turn) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + 32 * i;
        if (c < nvec) {
#pragma unroll
          for (int k = 0; k < E; ++k) {
            red[c * E + k] += dwacc[i][k];
            red[cols + c * E + k] += dbacc[i][k];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    part[(size_t)blockIdx.x * cols + c] = red[c];
    part[((size_t)gridDim.x + blockIdx.x) * cols + c] = red[cols + c];
  }
}

// dw, db [cols] = the column sums of part [2][G][cols], in a fixed order
template <typename T>
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part,
                                     T* __restrict__ dw, T* __restrict__ db,
                                     int groups, int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * cols) return;
  const int which = i / cols, c = i - which * cols;
  const float* p = part + (size_t)which * groups * cols + c;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += p[(size_t)g * cols];
  (which ? db : dw)[c] = ptt::from_f32<T>(s);
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const void* w, void* dx,
               void* dw, void* db, void* part, int rows, int cols,
               int groups, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int per_lane = (cols / E + 31) / 32;
  const size_t smem = 2 * cols * sizeof(float);
  const dim3 grid(groups), block(kBwdWarps * 32);
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
#define PTT_LN_BWD(NV)                                               \
  ln_bwd_kernel<T, NV><<<grid, block, smem, stream>>>(dyp, xp, wp, dxp, \
                                                      pp, rows, cols, eps)
  // 3 and 6: a 768-wide row in bf16 and f32 (GPT-124M) without
  // registers for vectors it never loads
  if (per_lane <= 1)
    PTT_LN_BWD(1);
  else if (per_lane <= 2)
    PTT_LN_BWD(2);
  else if (per_lane <= 3)
    PTT_LN_BWD(3);
  else if (per_lane <= 4)
    PTT_LN_BWD(4);
  else if (per_lane <= 6)
    PTT_LN_BWD(6);
  else if (per_lane <= 8)
    PTT_LN_BWD(8);
  else if (per_lane <= 16)
    PTT_LN_BWD(16);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef PTT_LN_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_bwd_reduce_kernel<T><<<(2 * cols + 255) / 256, 256, 0, stream>>>(
      pp, static_cast<T*>(dw), static_cast<T*>(db), groups, cols);
  return static_cast<int>(cudaGetLastError());
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

// dy, x, dx: [rows, cols] contiguous; w, dw, db: [cols]; all of one
// dtype. part: f32 scratch of [2, groups, cols]; groups (>= 1) blocks
// walk the rows. cols as for the forward.
extern "C" int ptt_layer_norm_bwd(const void* dy, const void* x,
                                  const void* w, void* dx, void* dw,
                                  void* db, void* part, int rows, int cols,
                                  int groups, float eps, int dtype,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_bwd<float>(dy, x, w, dx, dw, db, part, rows, cols,
                               groups, eps, s);
    case ptt::kBF16:
      return launch_bwd<__nv_bfloat16>(dy, x, w, dx, dw, db, part, rows,
                                       cols, groups, eps, s);
    case ptt::kF16:
      return launch_bwd<__half>(dy, x, w, dx, dw, db, part, rows, cols,
                                groups, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
