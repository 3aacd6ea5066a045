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
// What bounds it: on paper, bytes. Every live K/V page is streamed from
// device memory and meets only the few queries of one row, so the work
// per byte is a few flops per element for a decode row and at most
// 2 * qblk * rep flops per element for a prefill block. The 1-byte lanes
// halve those bytes (plus 4 bytes of scale per key and head for int8). In
// practice the chain of page folds of the longest row, which must run one
// after another: K6's fold is the f32 online softmax that K9 and K10
// share (`attend_row`, paged_walk.cuh), so K10 = K6 and K9 = K6 at q_len
// 1 bit for bit, and a tensor-core fold or a split of a row's pages over
// blocks would sum in another order.
//
// Design: K6 is the walk K10's second phase runs (`ring_walk_kernel` in
// paged_walk.cuh) with no groups, so every row walks its pages from the
// first. The TPU kernel carried (m, l, acc) from one grid step to the
// next along a sequential page axis; here a block owns (query block of
// <= 8 queries x rep heads, row b, kv head g), loops over the row's live
// pages itself and keeps m, l and acc in shared memory in f32 for the
// whole walk. Where those 8 x rep rows do not fit shared memory beside
// the tiles (rep 32 at head dim 128, 71 heads of 64 on one kv head), the
// rows are split over the fewest blocks that fit (`walk_split`), each
// reading the row's pages itself; every row folds as before, so the
// split moves no bit. The parts the ring gives it:
// - kRingStages cp.async page stages, two pages ahead, each thread
//   converting the chunks it copied itself into f32 (the 1-byte lanes
//   dequantize there: the TPU kernel's in-VMEM dequant), into two f32
//   working tiles: warps with no rows to fold copy and convert page i + 1
//   while page i is folded, one __syncthreads a page. Page ids are read
//   from the table a page ahead. Where the ring does not fit shared memory
//   beside the rows' state, or a pool row is not a multiple of 4 bytes,
//   each page is loaded straight from the pools into one tile.
// - Pages over 128 keys (and at head dims over 256 pages whose f32 tile
//   passes 64 KB) are folded in equal pieces (`piece_rows`), the same in
//   every walk. Head dims over 256 walk acc's columns in pieces of 256.
//   Copies are the widest of 16, 8 or 4 bytes that divides a pool row,
//   else single elements, so any head dim is read.
// - The fold: page size 16 at head dims 32-256 takes instantiations with
//   D and ps as compile-time constants, folding two query rows a warp
//   (`attend_pair`, attend_row's operations in attend_row's order); every
//   other shape folds a row a warp with `attend_row` itself.
// - The schedule: every block ranks the (query block, row) items by
//   descending page count on the device, and the longest walks start
//   first; two blocks fit an SM (`__launch_bounds__(256, 2)`).
// Dead query blocks write zeros and read nothing. Page ids are clamped
// into the pool, so a bad table reads the wrong page instead of faulting.
// `ptt_ragged_plan` reports the launch a batch gets.
//
// The user-mask lane (the TPU kernel's `has_mask`): an additive f32 mask
// [B, H, lq, mp * ps] (the wrapper turns a bool mask into 0 / -1e30 and
// broadcasts) is added to each key's score after the window mask, inside
// the same online softmax, in the masked instantiations of the same walk
// (`attend_row`'s and `attend_pair`'s kMasked, with __fadd_rn so the add
// never contracts into an FMA; each lane reads its key's mask entry from
// device memory). The TPU kernel pads the mask to its query block and
// splits it per kv head; here each row indexes [b, h = g * rep + r, qi,
// key] directly.
#include "paged_walk.cuh"

using namespace ptt;
using namespace ptt::walk;

// q, out: [B, lq, H, D]; k, v: [num_pages, ps, Hkv, D], of q's dtype
// (pool code 0), int8 (1) or e4m3 (2); k_scale, v_scale: f32
// [num_pages, ps, Hkv] for int8, else null; page_table [B, mp]; pos,
// q_len [B]; mask null or additive f32 [B, H, lq, mp * ps]. All
// contiguous, the pools 16-byte aligned; H a multiple of Hkv.
extern "C" int ptt_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* pos,
    const void* q_len, const void* mask, void* out, int B, int lq, int H,
    int Hkv, int D, int ps, int mp, int num_pages, int dtype, int pool,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = make_args(q, k, v, k_scale, v_scale, page_table, pos, q_len, B,
                     lq, H, Hkv, D, ps, mp, num_pages, pool);
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr) return ring_dispatch<false, true>(dtype, a, s);
  return ring_dispatch<false, false>(dtype, a, s);
}

// The launch K6 (K7) makes for these shapes, with or without a user mask,
// written to out[kPlanLen] (`walk_plan`: raw stages, f32 tiles, dynamic
// shared memory bytes, two rows a warp, grid blocks, threads a block,
// query rows a block, the keys of a piece, the bytes of one copy, the
// split of an item's rows over blocks). Returns cudaErrorInvalidValue, as
// the launch would, where not even one query row fits (out[2]: the bytes
// it would need).
extern "C" int ptt_ragged_plan(int B, int lq, int H, int Hkv, int D, int ps,
                               int dtype, int pool, int* out) {
  return walk_plan(B, lq, H, Hkv, D, ps, dtype, pool, out);
}
