// K11: the paged LoRA delta for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_lora_paged_kernel,
// launched from lora_delta_paged (the decode megakernel's LoRA prologue
// for the q, k and v projections, and the o-projection's delta after
// attention). Each row gathers its own adapter page from the shared pools:
//
//   x [B, W, IN]; a_pool [P, IN, R]; b_pool [P, R, OUT] (all of x's dtype
//   T: f32, bf16 or f16); apage [B] int32 (page 0 is the all-zero base
//   page); ascale [B] f32. out[b] = ((x[b] . A[p]) . B[p]) * scale[b],
//   p = apage[b], in T, rounded at the TPU kernel's points: t = x . A
//   (f32 sums) rounded to T; d = t . B (f32 sums) rounded to T; then
//   d * T(scale[b]) rounded to T. Page 0 or scale 0 gives exactly 0.
//
// What bounds it: bytes. At the serving step (B 16, W 32, IN = OUT = 768,
// R 8) it reads x and writes out (about 0.8 MB each in bf16) and one
// 24 KB A/B page pair per row, for 2 * W * R * (IN + OUT) flops a row:
// a few flops a byte.
//
// Design. The TPU kernel streamed row b's page through VMEM once, chasing
// apage by scalar prefetch. Here a block owns (row b, a tile of 128
// output columns): it stages the row's A page in shared memory as f32,
// computes t for every position of the row (one warp per position: each
// lane sums its strided share of IN for all R ranks, then the R sums are
// butterfly warp reductions, so the order is fixed and the result is the
// same on every run), rounds t to T, and then each thread owns one
// output column: its R B-values in registers, a fixed-order f32 dot per
// position, and the two explicit roundings (__float2bfloat16 for bf16,
// as layer_norm.cu rounds), so no FMA contracts across a rounding point.
// Every tile recomputes the row's t (W * R values) rather than passing it
// between blocks. The page id is clamped into the pool.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;  // output columns per block

// a value rounded to T and back: the TPU kernel's `.astype(x.dtype)`
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return ptt::to_f32<T>(ptt::from_f32<T>(v));
}

template <typename T, int RMAX>
__global__ void __launch_bounds__(kThreads)
    lora_paged_kernel(const T* __restrict__ x, const T* __restrict__ a_pool,
                      const T* __restrict__ b_pool,
                      const int* __restrict__ apage,
                      const float* __restrict__ ascale, T* __restrict__ out,
                      int W, int IN, int R, int OUT, int num_pages) {
  extern __shared__ float smem[];
  float* sA = smem;           // [IN][R]
  float* sT = sA + IN * R;    // [W][R], t rounded to T
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int page = min(max(apage[b], 0), num_pages - 1);
  const T* A = a_pool + (size_t)page * IN * R;
  const T* Bm = b_pool + (size_t)page * R * OUT;
  for (int i = tid; i < IN * R; i += kThreads) sA[i] = ptt::to_f32<T>(A[i]);
  __syncthreads();

  // t[w][r] = sum_i x[b, w, i] * A[i, r]: warp per position
  for (int w = warp; w < W; w += kWarps) {
    const T* xr = x + ((size_t)b * W + w) * IN;
    float acc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
    for (int i = lane; i < IN; i += 32) {
      const float xv = ptt::to_f32<T>(xr[i]);
      const float* arow = sA + i * R;
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R) acc[r] = fmaf(xv, arow[r], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        const float v = ptt::warp_sum(acc[r]);
        if (lane == 0) sT[w * R + r] = round_to<T>(v);
      }
    }
  }
  __syncthreads();

  const int c = blockIdx.x * kCols + (tid % kCols);
  if (c >= OUT) return;
  float bcol[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    bcol[r] = r < R ? ptt::to_f32<T>(Bm[(size_t)r * OUT + c]) : 0.f;
  const float s = round_to<T>(ascale[b]);
  for (int w = tid / kCols; w < W; w += kThreads / kCols) {
    float d = 0.f;
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) d = fmaf(sT[w * R + r], bcol[r], d);
    // d rounded to T, times the scale in T, the product rounded to T
    const float prod = __fmul_rn(round_to<T>(d), s);
    out[((size_t)b * W + w) * OUT + c] = ptt::from_f32<T>(prod);
  }
}

template <typename T, int RMAX>
int launch(const void* x, const void* a_pool, const void* b_pool,
           const int* apage, const float* ascale, void* out, int B, int W,
           int IN, int R, int OUT, int num_pages, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)IN * R + (size_t)W * R);
  auto kernel = lora_paged_kernel<T, RMAX>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((OUT + kCols - 1) / kCols, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_pool),
      static_cast<const T*>(b_pool), apage, ascale, static_cast<T*>(out), W,
      IN, R, OUT, num_pages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rank(const void* x, const void* a_pool, const void* b_pool,
                const int* apage, const float* ascale, void* out, int B,
                int W, int IN, int R, int OUT, int num_pages,
                cudaStream_t s) {
  if (R <= 8)
    return launch<T, 8>(x, a_pool, b_pool, apage, ascale, out, B, W, IN, R,
                        OUT, num_pages, s);
  if (R <= 16)
    return launch<T, 16>(x, a_pool, b_pool, apage, ascale, out, B, W, IN, R,
                         OUT, num_pages, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [B, W, IN], a_pool [P, IN, R], b_pool [P, R, OUT], out [B, W, OUT], all
// of `dtype` and contiguous; apage [B] int32; ascale [B] f32; 1 <= R <= 16.
extern "C" int ptt_lora_delta_paged(const void* x, const void* a_pool,
                                    const void* b_pool, const void* apage,
                                    const void* ascale, void* out, int B,
                                    int W, int IN, int R, int OUT,
                                    int num_pages, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || W == 0 || OUT == 0) return 0;
  if (R < 1 || num_pages < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int* ap = static_cast<const int*>(apage);
  const float* sc = static_cast<const float*>(ascale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kF32:
      return launch_rank<float>(x, a_pool, b_pool, ap, sc, out, B, W, IN, R,
                                OUT, num_pages, s);
    case ptt::kBF16:
      return launch_rank<__nv_bfloat16>(x, a_pool, b_pool, ap, sc, out, B, W,
                                        IN, R, OUT, num_pages, s);
    case ptt::kF16:
      return launch_rank<__half>(x, a_pool, b_pool, ap, sc, out, B, W, IN, R,
                                 OUT, num_pages, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
