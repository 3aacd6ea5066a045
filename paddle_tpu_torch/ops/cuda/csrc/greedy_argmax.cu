// K12: the greedy argmax over a row of logits, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_argmax_epilogue_kernel,
// launched from decode_greedy_argmax (the decode megakernel's greedy
// sampling epilogue, under spec_verify_accept too):
//
//   logits [B, V] f32 -> int32 [B], row b's first-occurrence argmax.
//
// It equals torch.argmax and jnp.argmax bit for bit: the larger value
// wins, a NaN beats every number (the first NaN is the answer, as both
// libraries give), and equal values (0.0 and -0.0 included) go to the
// smaller index. That rule is a total order on (value, index) pairs, so a
// tree reduction gives the same answer whatever order its threads run in.
// The TPU kernel's [B, 128] lane-broadcast output tile is a layout
// artefact; this writes the [B] int32 its caller slices out.
//
// What bounds it: bytes (one compare per element of V f32 values). Design:
// one block of 1024 threads per row; each thread scans its strided share
// of the row in increasing index order (so within a thread a tie keeps
// the first), then the (value, index) pairs reduce by shuffles inside each
// warp and once more across the block's warps.
#include "common.cuh"

#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 1024;

// (v1, i1) wins over (v2, i2)
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  const bool n1 = v1 != v1, n2 = v2 != v2;
  if (n1 != n2) return n1;
  if (!n1 && v1 != v2) return v1 > v2;
  return i1 < i2;
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(ptt::kFullMask, v, o);
    const int oi = __shfl_xor_sync(ptt::kFullMask, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    argmax_kernel(const float* __restrict__ logits, int* __restrict__ out,
                  int V) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const float* row = logits + (size_t)blockIdx.x * V;
  // an empty slot: loses to every element (its index is past the row)
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float v = __ldg(row + i);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  warp_best(bv, bi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = sv[lane];  // kThreads / 32 == 32 warps: one per lane
    bi = si[lane];
    warp_best(bv, bi);
    if (lane == 0) out[blockIdx.x] = bi;
  }
}

}  // namespace

// logits [B, V] f32 contiguous; out [B] int32. V >= 1.
extern "C" int ptt_greedy_argmax(const void* logits, void* out, int B, int V,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
  argmax_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(out), V);
  return static_cast<int>(cudaGetLastError());
}
