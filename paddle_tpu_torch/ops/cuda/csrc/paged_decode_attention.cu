// K9: single-token paged decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::_pa_kernel, launched
// from _paged_attention_kernel (public paged_decode_attention), in its fp
// lane (pools of q's dtype) and its fp8 lane (e4m3 pools, upconverted
// exactly). The legacy alternating serving step attends through it once
// per layer per decode step, and so does generate()'s paged cache:
//
//   q [B, 1, H, D]; k/v pools [P, ps, H_kv, D]; page_table [B, mp] int32;
//   pos [B] int32; mask null or additive f32 [B, H, mp * ps]. Row b's rep
//   = H / H_kv query heads of kv head g attend keys j <= pos[b], read in
//   place from pages page_table[b, p] for p <= min(pos[b] / ps, mp - 1),
//   walked in order with an f32 online softmax. Masked scores are -1e30;
//   the user mask is added after that window mask. The output is
//   acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: on paper, bytes. A decode row's live K/V pages meet one
// query each (rep queries per kv head), a few flops per element; the
// mask, when given, adds 4 bytes per live key and head. In practice the
// chain of page folds of the longest row, which must run one after
// another.
//
// Design: K9 is K6 at q_len 1 — the walk of paged_walk.cuh
// (`ring_walk_kernel`, phase 2 with no groups) launched with lq 1 and
// no q_len operand (every row at q_len 1), so its output equals K6's at
// q_len 1 bit for bit by construction, at every shape. One block owns
// (kv head g, row b) and its rep query rows (split over blocks only where
// rep rows pass shared memory, as in every walk), two blocks an SM, rows
// ranked by page count on the device; the ring of cp.async page stages
// with spare warps converting page i + 1 while page i folds; page size 16
// at head dims 32-256 folds two rows a warp (`attend_pair`), with or
// without a mask; pages over 128 keys fold in pieces, head
// dims over 256 and rows that are not a multiple of 16 bytes are read as
// ragged_paged_attention.cu says. The mask [B, H, mp * ps] is K6's
// [B, H, 1, mp * ps]. Page ids are clamped into the pool. Unlike K6's and
// K10's launches, K9's reads each query row from shared memory at every
// fold (PTT_WALK_Q_REGS 0): a block folds one or two row pairs, and the
// registers q would hold make the rest of the walk spill (on an H100 at
// the legacy decode step: 0.0395 against 0.0365 ms, the same bits).
#define PTT_WALK_Q_REGS 0
#include "paged_walk.cuh"

using namespace ptt;
using namespace ptt::walk;

// The launch K9 makes for these shapes, with or without a user mask,
// written to out[kPlanLen] (`walk_plan`: raw stages, f32 tiles, dynamic
// shared memory bytes, two rows a warp, grid blocks, threads a block,
// query rows a block, the keys of a piece, the bytes of one copy, the
// split of a row's heads over blocks). Returns cudaErrorInvalidValue, as
// the launch would, for a dtype or pool code K9 does not take (int8 pools
// take K7) or where not even one query row fits (out[2]: its bytes).
extern "C" int ptt_decode_plan(int B, int H, int Hkv, int D, int ps,
                               int dtype, int pool, int* out) {
  if (pool != kPoolQ && pool != kPoolE4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  return walk_plan(B, 1, H, Hkv, D, ps, dtype, pool, out);
}

// q, out: [B, 1, H, D]; k, v: [num_pages, ps, Hkv, D] of q's dtype (pool
// code 0) or e4m3 (2); page_table [B, mp]; pos [B]; mask: null or f32
// [B, H, mp * ps]. All contiguous, the pools 16-byte aligned; H a
// multiple of Hkv. int8 pools have no K9 lane (they take K7 at q_len 1)
// and are refused.
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* page_table,
    const void* pos, const void* mask, void* out, int B, int H, int Hkv,
    int D, int ps, int mp, int num_pages, int dtype, int pool, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  if (pool != kPoolQ && pool != kPoolE4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, nullptr, nullptr, page_table, pos, nullptr, B,
                     1, H, Hkv, D, ps, mp, num_pages, pool);
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr) return ring_dispatch<false, true>(dtype, a, s);
  return ring_dispatch<false, false>(dtype, a, s);
}
