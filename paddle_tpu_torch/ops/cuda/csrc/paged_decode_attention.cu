// K9: single-token paged decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_pa_kernel, launched
// from _paged_attention_kernel (public paged_decode_attention), in its fp
// lane (pools of q's dtype) and its fp8 lane (e4m3 pools, upconverted
// exactly). The legacy alternating serving step attends through it once
// per layer per decode step:
//
//   q [B, 1, H, D]; k/v pools [P, ps, H_kv, D]; page_table [B, mp] int32;
//   pos [B] int32; mask null or additive f32 [B, H, mp * ps]. Row b's rep
//   = H / H_kv query heads of kv head g attend keys j <= pos[b], read in
//   place from pages page_table[b, p] for p <= min(pos[b] / ps, mp - 1),
//   walked in order with an f32 online softmax. Masked scores are -1e30;
//   the user mask is added after that window mask. The output is
//   acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: bytes. A decode row's live K/V pages meet one query
// each (rep queries per kv head), a few flops per element; the mask, when
// given, adds 4 bytes per live key and head.
//
// Design. The TPU kernel carried (m, l, acc) in VMEM scratch along a
// sequential page axis of its grid; here one block owns (kv head g, row
// b), its rep query heads are its rows, and it loops over the row's live
// pages itself. Each page is staged into shared memory as f32 by the same
// loader K6 uses (`load_pool_page`, 16-byte vector loads, e4m3 converted
// on the way) and folded into each row with K6's per-page update
// (`attend_row`), so without a mask K9's output equals K6's at q_len 1 bit
// for bit, lane for lane. With a mask the same walk runs in its masked
// instantiation: each lane reads its key's mask entry straight from device
// memory (one coalesced row segment per page and head) and adds it to the
// score. Page ids are clamped into the pool. Making it fast (flash-decoding
// splits over pages, TMA page loads, wgmma) is later work.
#include "paged_walk.cuh"

namespace ptt {
namespace walk {

template <typename T, int DV, int PJ, bool kMasked>
__global__ void __launch_bounds__(kThreads) decode_walk_kernel(const Args a) {
  extern __shared__ float smem[];
  const T* __restrict__ q = static_cast<const T*>(a.q);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int D = a.D, ps = a.ps, H = a.H;
  const int rep = H / a.Hkv;
  float* sK = smem;                   // [ps][D + 1]
  float* sV = sK + ps * (D + 1);      // [ps][D]
  float* sQ = sV + ps * D;            // [rep][D]
  float* sAcc = sQ + rep * D;         // [rep][D]
  float* sM = sAcc + rep * D;         // [rep]
  float* sL = sM + rep;               // [rep]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pos_b = a.pos[b];
  // K6's page count at q_len 1: pages through position pos, at most mp
  const int n_pages = block_pages(pos_b, 1, 0, 1, ps, a.mp);
  const size_t lmax = (size_t)a.mp * ps;

  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    sQ[idx] = to_f32<T>(q[((size_t)b * H + g * rep + r) * D + d]);
    sAcc[idx] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }

  for (int p = 0; p < n_pages; ++p) {
    int page = a.page_table[(size_t)b * a.mp + p];
    page = min(max(page, 0), a.num_pages - 1);
    __syncthreads();  // previous tile fully consumed (and init visible)
    load_pool_page<T>(a, page, g, sK, sV);
    __syncthreads();
    for (int r = warp; r < rep; r += kWarps) {
      const float* mrow =
          kMasked ? a.mask + ((size_t)b * H + g * rep + r) * lmax : nullptr;
      attend_row<DV, PJ, kMasked>(sQ + r * D, sK, sV, D, ps, p * ps, true,
                                  pos_b, a.scale, sM + r, sL + r,
                                  sAcc + r * D, lane, mrow);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const float l = fmaxf(sL[r], 1e-30f);
    out[((size_t)b * H + g * rep + r) * D + d] = from_f32<T>(sAcc[idx] / l);
  }
}

template <bool kMasked>
struct DecodeWalk {
  template <typename T, int DV, int PJ>
  static int run(const Args& a, cudaStream_t stream) {
    const size_t rep = a.H / a.Hkv;
    const size_t smem =
        sizeof(float) * (tile_floats(a.D, a.ps) + 2 * rep * a.D + 2 * rep);
    auto kernel = decode_walk_kernel<T, DV, PJ, kMasked>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<dim3(a.Hkv, a.B), kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace walk
}  // namespace ptt

// q, out: [B, 1, H, D]; k, v: [num_pages, ps, Hkv, D] of q's dtype (pool
// code 0) or e4m3 (2); page_table [B, mp]; pos [B]; mask: null or f32
// [B, H, mp * ps]. All contiguous; D a multiple of the pool's 16-byte
// vector width; H a multiple of Hkv. int8 pools have no K9 lane (they
// take K7 at q_len 1) and are refused.
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* pos, const void* mask, void* out, int B, int H, int Hkv,
    int D, int ps, int mp, int num_pages, int dtype, int pool, int device,
    void* stream) {
  using namespace ptt::walk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  Args a = make_args(q, k, v, nullptr, nullptr, page_table, pos, nullptr, B,
                     1, H, Hkv, D, ps, mp, num_pages, pool);
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr) return dispatch<DecodeWalk<true>>(dtype, a, s);
  return dispatch<DecodeWalk<false>>(dtype, a, s);
}
