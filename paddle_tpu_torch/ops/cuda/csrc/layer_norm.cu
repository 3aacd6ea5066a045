// K1: fused LayerNorm forward for Hopper (sm_90a).
//
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
