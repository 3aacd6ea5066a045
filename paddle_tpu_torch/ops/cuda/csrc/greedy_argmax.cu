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
// reduction gives the same answer whatever order it merges in. (The TPU
// body compares x == max, which never holds for a NaN, and so gives V for
// a row holding one; the port keeps the function's contract, jnp.argmax.)
// The TPU kernel's [B, 128] lane-broadcast output tile is a layout
// artefact; this writes the [B] int32 its caller slices out.
//
// What bounds it: bytes (one compare per element of V f32 values: 201 KB
// a row at V = 50304). A megakernel step has 16 rows, too few to fill 132
// SMs with a block a row, and one SM streams a row slowly. Design:
// - a row is split over a thread-block cluster of S blocks (S <= 8, the
//   portable cluster size; the grid is B x S blocks, block x = row x S +
//   rank). `_argmax_plan` in ops/cuda/paged_attention.py chooses S (so that
//   B x S is about one wave of the SMs, 1 where B alone fills the card)
//   and the threads a block, and passes both here;
// - the row's elements from its first 16-byte aligned address on are read
//   as whole float4 vectors through the read-only path, kLoads of them in
//   flight a thread before the first compare; rank r takes the contiguous
//   vectors [r nv / S, (r + 1) nv / S). The scalar head before the first
//   aligned address and the tail after the last whole vector (a row whose
//   start is not 16-byte aligned: V % 4 != 0, or an offset view) go to
//   rank 0's first threads, the head before its vectors and the tail
//   after them, so a thread meets its elements in increasing index order;
// - an element's value becomes a 32-bit key whose unsigned order is the
//   rule's order on values (`key_of`: NaN on top, -0.0 = 0.0), so a
//   thread keeps the first element of the largest key it met, and a
//   warp's best is two reductions (`redux.sync`): the largest key, then
//   the smallest index holding it. The block's warps reduce the same way
//   in warp 0;
// - across the cluster, every block but rank 0 stores its pair into rank
//   0's shared memory and arrives on rank 0's mbarrier (release, cluster
//   scope), then leaves; rank 0 waits on the mbarrier, reduces the S
//   pairs and writes the answer. The cluster barrier that makes rank 0's
//   mbarrier initialised before any block stores into it is arrived at
//   before the loads and waited on after them, so its latency hides
//   behind the loads.
// One launch, no global scratch, no atomics. (A first version reduced a
// block by (value, index) shuffles and the cluster by two cluster.sync()
// around rank 0's reads, both on the critical path after the loads, and
// was slower.) `python -m paddle_tpu_torch.ops.cuda.argmax_turns` times
// this build against another checkout's, and at every cluster size.
#include "common.cuh"

#include <cooperative_groups.h>

#include <climits>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kLoads = 4;       // float4 loads in flight a thread

// v's place in the rule's order on values, as an unsigned key: a NaN
// above everything (all NaNs equal), -0.0 equal to 0.0, else the IEEE
// order (negatives' bits flipped, positives' sign bit set). Every element
// has a key > 0, so key 0 is the empty slot.
__device__ __forceinline__ unsigned key_of(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// element i of value v, met after every element of smaller index
__device__ __forceinline__ void take(float v, int i, unsigned& bk, int& bi) {
  const unsigned k = key_of(v);
  if (k > bk) {
    bk = k;
    bi = i;
  }
}

// the warp's best (key, index): the largest key, the smallest index
// holding it
__device__ __forceinline__ void warp_best(unsigned& k, int& i) {
  const unsigned m = __reduce_max_sync(ptt::kFullMask, k);
  i = static_cast<int>(__reduce_min_sync(
      ptt::kFullMask, k == m ? static_cast<unsigned>(i) : 0xffffffffu));
  k = m;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kMaxThreads)
    argmax_kernel(const float* __restrict__ logits, int* __restrict__ out,
                  int V, int S) {
  __shared__ unsigned sk[kMaxThreads / 32];
  __shared__ int si[kMaxThreads / 32];
  // rank 0's: the cluster's pairs, and the mbarrier the others arrive on
  __shared__ unsigned ck[kMaxCluster];
  __shared__ int ci[kMaxCluster];
  __shared__ alignas(8) unsigned long long bar;
  const int b = blockIdx.x / S, rank = blockIdx.x % S;
  const int t = threadIdx.x, nt = blockDim.x;
  if (S > 1) {
    if (rank == 0 && t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_addr(&bar)),
                   "r"(S - 1)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
  const float* row = logits + (size_t)b * V;
  // the scalar head up to the first 16-byte aligned address (row is
  // 4-byte aligned), the whole vectors after it, and the scalar tail
  const int head = min(
      V, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) &
                           15) >> 2));
  const int nv = (V - head) >> 2;
  const int tail0 = head + 4 * nv;
  unsigned bk = 0;  // the empty slot: loses to every element
  int bi = INT_MAX;
  if (rank == 0 && t < head) take(__ldg(row + t), t, bk, bi);
  const float4* vec = reinterpret_cast<const float4*>(row + head);
  const int lo = static_cast<int>((long long)rank * nv / S);
  const int hi = static_cast<int>((long long)(rank + 1) * nv / S);
  for (int j0 = lo + t; j0 < hi; j0 += kLoads * nt) {
    float4 x[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (j0 + u * nt < hi) x[u] = __ldg(vec + j0 + u * nt);
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * nt;
      if (j < hi) {
        const int i = head + 4 * j;
        take(x[u].x, i, bk, bi);
        take(x[u].y, i + 1, bk, bi);
        take(x[u].z, i + 2, bk, bi);
        take(x[u].w, i + 3, bk, bi);
      }
    }
  }
  if (rank == 0 && t < V - tail0)
    take(__ldg(row + tail0 + t), tail0 + t, bk, bi);
  warp_best(bk, bi);
  const int warp = t >> 5, lane = t & 31;
  if (lane == 0) {
    sk[warp] = bk;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bk = 0;
    bi = INT_MAX;
    if (lane < (nt >> 5)) {
      bk = sk[lane];
      bi = si[lane];
    }
    warp_best(bk, bi);
  }
  if (S == 1) {
    if (t == 0) out[b] = bi;
    return;
  }
  // rank 0's mbarrier is initialised, and every block of the cluster runs
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (rank != 0) {
    if (t == 0) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.map_shared_rank(ck, 0)[rank] = bk;
      cluster.map_shared_rank(ci, 0)[rank] = bi;
      unsigned remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                   : "=r"(remote)
                   : "r"(smem_addr(&bar)));
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
              remote)
          : "memory");
    }
    return;
  }
  if (warp == 0) {
    // each lane acquires the other blocks' stores itself
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
          "[%1], 0;\n selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(smem_addr(&bar))
          : "memory");
    if (lane > 0) {  // lane 0 holds rank 0's own pair
      bk = 0;
      bi = INT_MAX;
      if (lane < S) {
        bk = ck[lane];
        bi = ci[lane];
      }
    }
    warp_best(bk, bi);
    if (lane == 0) out[b] = bi;
  }
}

}  // namespace

// logits [B, V] f32, rows contiguous (any 4-byte aligned start); out [B]
// int32. V >= 1; S blocks a row (1-8, a cluster), `threads` a block (a
// multiple of 32, 32-1024): `_argmax_plan`'s launch.
extern "C" int ptt_greedy_argmax(const void* logits, void* out, int B, int V,
                                 int S, int threads, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  if (V < 1 || S < 1 || S > kMaxCluster || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (long long)B * S > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * S);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;  // a block a row: a plain launch
  err = cudaLaunchKernelEx(&cfg, argmax_kernel,
                           static_cast<const float*>(logits),
                           static_cast<int*>(out), V, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
