// K6 and K7: ragged paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_ragged_kernel,
// launched from _ragged_attention_kernel, in its three pool lanes: the fp
// lane (K6, public ragged_paged_attention), the fp8 lane (`fp8=True`: e4m3
// pools upconverted, the same public op) and the q8 lane (K7,
// `has_scale`: int8 code pools times f32 rowwise scale pools, public
// ragged_paged_attention_q8). One call serves a mixed batch of decode rows
// (q_len 1) and mid-prefill rows (q_len up to the step width) against a
// shared paged KV pool:
//
//   q [B, lq, H, D]; k/v pools [P, ps, H_kv, D]; page_table [B, mp] int32;
//   pos, q_len [B] int32. Query i of row b sits at position pos[b] + i and
//   attends keys j <= pos[b] + i; queries at i >= q_len[b] are dead (their
//   output is only finite). rep = H / H_kv query heads share one K/V
//   stream (GQA). Pages past ceil((pos + live queries) / ps) are never
//   read. Masked scores are -1e30 before an online softmax in f32, and the
//   output is acc / max(l, 1e-30), as in the TPU kernel.
//
// What bounds it: at serving shapes, bytes. Every live K/V page is
// streamed from device memory and meets only the few queries of one row,
// so the work per byte is a few flops per element for a decode row and
// at most 2 * qblk * rep flops per element for a prefill block. The 1-byte
// lanes halve those bytes (plus 4 bytes of scale per key and head for
// int8); the walk itself, which the measurements show is what the time
// goes to, is the same in every lane.
//
// Design. The TPU kernel carried (m, l, acc) from one grid step to the
// next along a sequential page axis; blocks here run in no order, so
// there is no grid-order carry. Each CUDA block owns (row b, kv head g,
// query block of <= 8 queries x rep heads), reads its own pos, q_len and
// page-table entries, and loops over its live pages itself
// (`row_walk_kernel` in paged_walk.cuh). Each
// loop step stages one page's K and V tile [ps, D] in shared memory (16-byte
// vector loads, converted to f32; K rows padded by one float so the
// per-key dot products of a warp hit distinct banks), then each warp
// takes whole query rows (`attend_row`): lane j scores key j of the page,
// the page's max and sum are warp reductions, and lane d accumulates output
// column d (and d + 32, ...) with the probabilities broadcast by shuffles.
// m, l and acc live in shared memory in f32 for the whole walk. Dead
// query blocks write zeros and read nothing. Page ids are clamped into
// the pool, so a bad table reads the wrong page instead of faulting. The
// quantized lanes differ only in the page loader (`load_pool_page`), which
// dequantizes into the same f32 tiles: the TPU kernel's in-VMEM dequant.
//
// The user-mask lane (the TPU kernel's `has_mask`): an additive f32 mask
// [B, H, lq, mp * ps] (the wrapper turns a bool mask into 0 / -1e30 and
// broadcasts) is added to each key's score after the window mask, inside
// the same online softmax, in the masked instantiation of the same walk
// (`attend_row`'s kMasked, with __fadd_rn so the add never contracts into
// an FMA). The TPU kernel pads the mask to its query block and splits it
// per kv head; here each row indexes [b, h = g * rep + r, qi, key]
// directly. The unmasked launches run the instantiations they ran
// before, so their bits, and K10 = K6, are unchanged.
#include "paged_walk.cuh"

// q, out: [B, lq, H, D]; k, v: [num_pages, ps, Hkv, D], of q's dtype
// (pool code 0), int8 (1) or e4m3 (2); k_scale, v_scale: f32
// [num_pages, ps, Hkv] for int8, else null; page_table [B, mp]; pos,
// q_len [B]; mask null or additive f32 [B, H, lq, mp * ps]. All
// contiguous; D a multiple of the pool's 16-byte vector width; H a
// multiple of Hkv.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* pos,
    const void* q_len, const void* mask, void* out, int B, int lq, int H,
    int Hkv, int D, int ps, int mp, int num_pages, int dtype, int pool,
    int device, void* stream) {
  using namespace ptt::walk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = make_args(q, k, v, k_scale, v_scale, page_table, pos, q_len, B,
                     lq, H, Hkv, D, ps, mp, num_pages, pool);
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr) return dispatch<RowWalk<true>>(dtype, a, s);
  return dispatch<RowWalk<>>(dtype, a, s);
}
