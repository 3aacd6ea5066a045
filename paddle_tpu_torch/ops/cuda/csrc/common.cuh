// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes
// by ops/cuda/_build.py): pointers and the stream arrive as void*, each
// entry returns cudaGetLastError() right after its launch, and the
// Python wrapper raises when that is not 0. Kernels launch on the
// caller's stream, never synchronise and allocate nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// dtype codes shared with the Python wrappers (ops/cuda/_build.py)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };
// paged KV pool codes (_build.POOL_CODES): pools of q's own dtype, int8
// codes with f32 rowwise scale pools, or float8 e4m3 values
enum Pool : int { kPoolQ = 0, kPoolI8 = 1, kPoolE4M3 = 2 };

constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
// the 1-byte pool elements; both conversions are exact
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

}  // namespace ptt

// Human-readable text of a CUDA error code, for the wrappers' messages.
// Defined once a library: the files compiled beside a library's own
// (walk_instance.cu) define PTT_WALK_INSTANCE and leave it out.
#ifndef PTT_WALK_INSTANCE
extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
