// K10: the grouped (prefix-sharing) ragged paged attention walk for
// Hopper (sm_90a), in two phases.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_grouped_phase1_kernel
// (K10a) and ::_grouped_phase2_kernel (K10b), both launched from
// _grouped_attention_kernel (public ragged_paged_attention_grouped and, in
// the q8 lane — `has_scale`, scale specs ks1/ks2 — ragged_paged_attention_
// grouped_q8; the fp8 lane is the `fp8` flag), in all three pool lanes
// (paged_walk.cuh). It computes what K6 computes (ragged paged attention, see
// ragged_paged_attention.cu), for a batch whose rows declare prefix
// groups: rows of group g share the physical pages at table indices
// [0, group_cnt[g]); group_leader[g] names a member whose table phase 1
// walks; a singleton has group_cnt 0 and is exactly K6.
//
// Both phases are the walk of paged_walk.cuh (`ring_walk_kernel`, which
// K6, K7 and K9 run too). Its work items are the launch's (query block t,
// row b) pairs, each walked once per kv head:
//   K10a (ptt_grouped_phase1): an item whose row is a member of a sharing
//     group (group_cnt[group_id[b]] > 0) and whose query block is live
//     walks the shared span, pages [0, min(cnt, last_b + 1)) read through
//     the leader's table, from (-1e30, 0, 0), and writes its rows'
//     partials (m, l, acc); no other item folds anything. The members of
//     one group walk the span side by side, each in its own block: the
//     first read brings the span into the 50 MB L2 and the others read it
//     there, so device memory serves each (group, kv head) span about
//     once, and no block waits for another.
//   K10b (ptt_grouped_phase2): every live item walks its row's pages
//     [p0, last + 1), where p0 = min(cnt, last + 1) for a member (starting
//     from its phase-1 partials) and 0 for any other row, and writes the
//     output; a dead query block writes zeros.
// Both fold with K6's arithmetic, walk each row's pages in K6's order and
// in the same pieces (a page over 128 keys in pieces of `piece_rows`),
// and the partials cross in f32, so K10's output equals K6's (K7's in the
// q8 lane) bit for bit on the same operands.
//
// What bounds it: on paper, bytes (each group's span once per kv head,
// each row's private tail once), some hundred times below its time; in
// practice the chain of page folds of the longest row, which must run one
// after another. The fold stays on the CUDA cores in f32: it is K6's
// arithmetic, and a tensor-core product would sum in another order and
// lose K10 = K6. At GPT-124M a page block is 16 keys x 64 dims meeting at
// most 8 queries x rep heads, a few flops a byte, far below where the
// tensor cores would set the pace. So the walk keeps copies in flight,
// shortens each fold and keeps the SMs evenly busy (paged_walk.cuh):
// - The ring (`ring_issue`, `ring_convert`): kRingStages (2) raw page
//   stages in shared memory, filled by cp.async (the widest of 16, 8 or 4
//   bytes that divides a pool row, one commit group per page, two pages
//   ahead). Each thread copies and later converts the same chunks, so it
//   waits only on its own groups (cp.async.wait_group), and no barrier
//   stands between a copy landing and its conversion. Page ids are read
//   from the table as the copies are issued, one page ahead in a
//   register, so shared memory does not grow with the table. cp.async was
//   chosen over TMA: the q8 lane's f32 scales are one float per
//   (position, kv head), strided in the scale pool, too narrow for a
//   tensor map's 16-byte box rows, and a tensor map per pool per call
//   would add host work to a step that is host-bound. On the H100 2
//   stages ran fastest, 3-8 within 3 % of it and 1 about a third slower
//   (`python -m paddle_tpu_torch.ops.cuda.grouped_stage_sweep`, which
//   compiles each count).
// - Two f32 working tiles: warps with no rows to fold (at GPT-124M 4 of
//   the 8) copy and convert page i + 1 into one tile while the others
//   fold page i from the other, one __syncthreads a page; when every warp
//   has rows, each folds, then converts.
// - Where the ring and two tiles do not fit beside the rows' state (large
//   f32 or 16-bit pages, many rows a block), or a pool row is not a
//   multiple of 4 bytes, the block loads each page straight from the
//   pools into one tile, with a barrier before and after (`walk_layout`);
//   `ptt_grouped_plan` reports which feeder a launch gets.
// - The fold: page size 16 at head dims 32, 64, 128 and 256 takes
//   instantiations with D and ps as compile-time constants, folding two
//   query rows a warp (`attend_pair`, a half-warp each, K rows padded to
//   D + 4 floats and read four at a time, q in registers up to head dim
//   64), which gives every value attend_row's operations in attend_row's
//   order; every other shape folds a row a warp with `attend_row` itself,
//   at run-time D and ps.
// - The schedule: every block ranks the launch's items by descending
//   walk length (`item_key`; up to 512 items, else index order), and
//   block x takes kv head x % Hkv of the item ranked x / Hkv (with the
//   rows split over s blocks, `walk_split`: the (kv head, run of rows)
//   pair x % (Hkv * s) of the item ranked x / (Hkv * s)), so the longest
//   walks start first on distinct SMs and the blocks of dead items come
//   last. Two blocks fit an SM (`__launch_bounds__(256, 2)`):
//   at one, the grid ran in waves and the dead items' blocks queued
//   behind the live ones.
#include "paged_walk.cuh"

namespace {

using namespace ptt;
using namespace ptt::walk;

Args grouped_args(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* page_table, const void* pos, const void* q_len,
                  const void* group_id, const void* group_cnt, const void* m,
                  const void* l, const void* acc, int B, int lq, int H,
                  int Hkv, int D, int ps, int mp, int num_pages, int pool) {
  Args a = make_args(q, k, v, k_scale, v_scale, page_table, pos, q_len, B,
                     lq, H, Hkv, D, ps, mp, num_pages, pool);
  a.group_id = static_cast<const int*>(group_id);
  a.group_cnt = static_cast<const int*>(group_cnt);
  a.pm = static_cast<float*>(const_cast<void*>(m));
  a.pl = static_cast<float*>(const_cast<void*>(l));
  a.pacc = static_cast<float*>(const_cast<void*>(acc));
  return a;
}

}  // namespace

// The launch both K10 entries make for these shapes, written to
// out[kPlanLen] (`walk_plan`: the feeder, shared memory, grid, rows,
// piece length, copy width and the split of an item's rows). Returns
// cudaErrorInvalidValue, as the launch would, for a dtype or pool code the
// kernels do not take, or where not even one query row fits shared
// memory (out[2]: the bytes it would need).
extern "C" int ptt_grouped_plan(int B, int lq, int H, int Hkv, int D, int ps,
                                int dtype, int pool, int* out) {
  return walk_plan(B, lq, H, Hkv, D, ps, dtype, pool, out);
}

// K10a. q: [B, lq, H, D]; k, v: [num_pages, ps, Hkv, D] of the pool code
// `pool`; k_scale, v_scale: f32 [num_pages, ps, Hkv] for the int8 pool,
// else null; page_table [B, mp]; pos, q_len, group_id, group_leader,
// group_cnt [B] int32; m, l: f32 [Hkv, nqb, B * qblk * rep]; acc: f32
// [.., D], with qblk = min(lq, 8), nqb = ceil(lq / qblk), rep = H / Hkv.
// Writes the partials of member rows of sharing groups only.
extern "C" int ptt_grouped_phase1(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* pos,
    const void* q_len, const void* group_id, const void* group_leader,
    const void* group_cnt, void* m, void* l, void* acc, int B, int lq, int H,
    int Hkv, int D, int ps, int mp, int num_pages, int dtype, int pool,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = grouped_args(q, k, v, k_scale, v_scale, page_table, pos, q_len,
                        group_id, group_cnt, m, l, acc, B, lq, H, Hkv, D, ps,
                        mp, num_pages, pool);
  a.group_leader = static_cast<const int*>(group_leader);
  return ring_dispatch<true, false>(dtype, a,
                                    static_cast<cudaStream_t>(stream));
}

// K10b. The operands of K10a (without group_leader) plus out
// [B, lq, H, D]; reads the partials K10a wrote.
extern "C" int ptt_grouped_phase2(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_table, const void* pos,
    const void* q_len, const void* group_id, const void* group_cnt,
    const void* m, const void* l, const void* acc, void* out, int B, int lq,
    int H, int Hkv, int D, int ps, int mp, int num_pages, int dtype,
    int pool, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || lq == 0) return 0;
  Args a = grouped_args(q, k, v, k_scale, v_scale, page_table, pos, q_len,
                        group_id, group_cnt, m, l, acc, B, lq, H, Hkv, D, ps,
                        mp, num_pages, pool);
  a.out = out;
  return ring_dispatch<false, false>(dtype, a,
                                     static_cast<cudaStream_t>(stream));
}
