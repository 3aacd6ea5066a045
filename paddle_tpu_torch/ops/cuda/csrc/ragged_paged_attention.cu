// K6: ragged paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_ragged_kernel
// (fp lane; launched from _ragged_attention_kernel, public
// ragged_paged_attention). One call serves a mixed batch of decode rows
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
// at most 2 * qblk * rep flops per element for a prefill block.
//
// Design. The TPU kernel carried (m, l, acc) from one grid step to the
// next along a sequential page axis; blocks here run in no order, so
// there is no grid-order carry. Each CUDA block owns (row b, kv head g,
// query block of <= 8 queries x rep heads), reads its own pos, q_len and
// page-table entries, and loops over its live pages itself
// (`row_walk_kernel` in paged_walk.cuh, which K10's phase 2 shares). Each
// loop step stages one page's K and V tile [ps, D] in shared memory (16-byte
// vector loads, converted to f32; K rows padded by one float so the
// per-key dot products of a warp hit distinct banks), then each warp
// takes whole query rows (`attend_row`): lane j scores key j of the page,
// the page's max and sum are warp reductions, and lane d accumulates output
// column d (and d + 32, ...) with the probabilities broadcast by shuffles.
// m, l and acc live in shared memory in f32 for the whole walk. Dead
// query blocks write zeros and read nothing. Page ids are clamped into
// the pool, so a bad table reads the wrong page instead of faulting.
#include "paged_walk.cuh"

// q, out: [B, lq, H, D]; k, v: [num_pages, ps, Hkv, D]; page_table
// [B, mp]; pos, q_len [B]. All contiguous; q, k, v, out of one dtype;
// D a multiple of the 16-byte vector width; H a multiple of Hkv.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* pos, const void* q_len, void* out, int B, int lq, int H,
    int Hkv, int D, int ps, int mp, int num_pages, int dtype, int device,
    void* stream) {
  using namespace ptt::walk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = make_args(q, k, v, page_table, pos, q_len, B, lq, H, Hkv, D, ps,
                     mp, num_pages);
  a.out = out;
  return dispatch<RowWalk<false>>(dtype, a, static_cast<cudaStream_t>(stream));
}
