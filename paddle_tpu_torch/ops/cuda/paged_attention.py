"""K6, K7, K9 and K10: ragged paged attention, its int8 lane, the
single-token paged decode attention and the grouped two-phase walk —
CUDA kernels, plain versions, wrappers — plus the paged KV writes they
read from (K8, K8-q8), the host model of their page reads, and the
decode megakernel's parts: the paged LoRA delta (K11), the greedy
argmax (K12) and their composition `megakernel_decode[_q8]` (K13).

Counterpart of `paddle_tpu/ops/pallas/paged_attention.py`:
`ragged_paged_attention` (public, :1069) and
`ragged_paged_attention_q8` (:1101), whose TPU kernel `_ragged_kernel`
(:375, launched from `_ragged_attention_kernel`) has three lanes — the
fp lane (K6), the fp8 lane (`fp8=True`, e4m3 pools upconverted) and the
q8 lane (K7, `has_scale`: int8 code pools times f32 rowwise scale
pools) — all in `csrc/ragged_paged_attention.cu`;
`ragged_paged_attention_grouped` (:1147) and
`ragged_paged_attention_grouped_q8` (:1175), whose two TPU kernels
`_grouped_phase1_kernel` (:562) and `_grouped_phase2_kernel` (:663),
launched from `_grouped_attention_kernel`, are
`csrc/grouped_paged_attention.cu` in the same three lanes;
`quantize_kv_rowwise` (:1208), `paged_scatter` (:1251) and
`paged_scatter_q8` (:1272), whose TPU kernels `_scatter_write_kernel`
(:1294, K8) and `_scatter_q8_write_kernel` (:1343, K8-q8) are
`csrc/paged_scatter.cu`; `paged_decode_attention` (:971), whose TPU
kernel `_pa_kernel` (:243, launched from `_paged_attention_kernel`
:310) is `csrc/paged_decode_attention.cu` (K9) in its fp and fp8 lanes,
with `paged_attention_reference` (:943) and `_mask_to_additive` (:232);
`dequantize_paged_q8` (:1040) and the references (:1018, :1057);
`count_page_block_reads` (:1621); `resolve_megakernel_flag` (:213),
`lora_delta` (:1400), `lora_delta_paged` (:1429, whose TPU kernel
`_lora_paged_kernel` :1414 is K11, `csrc/lora_paged.cu`),
`megakernel_decode` (:1491) and `megakernel_decode_q8` (:1525),
`decode_greedy_argmax` (:1575, whose TPU kernel
`_argmax_epilogue_kernel` :1561 is K12, `csrc/greedy_argmax.cu`) and
`spec_verify_accept` (:1599).

Semantics (shared by the kernels and the plain versions): q
[B, lq, H, D]; pools [P, ps, H_kv, D] of q's dtype, of float8 e4m3
(FP8_DTYPE: each value is the number), or of int8 codes with f32 scale
pools [P, ps, H_kv] (a key's value is code x the scale of its
(position, kv head)); page_table [B, mp]; pos, q_len [B] int32. Query i
of row b sits at position pos[b] + i and attends keys j <= pos[b] + i,
read through page_table[b, j // ps]; a query at i >= q_len[b] is dead
and its output is only finite. rep = H / H_kv query heads share one K/V
stream. Masked keys get probability exactly 0, so stale slots in a page
are harmless as long as they are finite — the serving engine
zero-initialises its pools and scale pools.

An optional user mask (bool, or additive float, broadcastable to
[B, H, lq, mp * ps]) becomes an additive f32 mask (`_mask_to_additive`:
0 / -1e30 for a bool mask) added to the scores after the window mask,
inside the same online softmax: K6's and K7's mask lane. Under a mask
the grouped op runs K6/K7, as the JAX op falls back to its ungrouped
kernel. K9 is the q_len 1 case with its mask [B, H, mp * ps]: without a
mask its output equals K6's at q_len 1 (on the card bit for bit, as it
is K6's walk launched at q_len 1; the plain versions are one function).
int8 pools have no K9 lane: the decode step sends them to K7 at q_len 1.

The grouped op computes the same output. Rows whose page tables share a
physical-page prefix declare it: `group_id` [B] (row -> group),
`group_leader` [B] (group -> a member whose table holds the span) and
`group_cnt` [B] (group -> shared page count, 0 for a singleton). Phase 1
(K10a) folds each group's shared pages, read once through the leader's
table, into the online-softmax partials (m, l, acc) of every member row;
phase 2 (K10b) continues each row from its partials over its private
tail. Both walk a row's pages in K6's order with K6's arithmetic, so on
the card K10's output equals K6's bit for bit, lane for lane.

On the card K6, K7, K9 and both phases of K10 are one kernel (the walk
of `csrc/paged_walk.cuh`): a ring of cp.async page copies (or, where the
ring does not fit shared memory, each page loaded straight into one
tile), one block per (query block, row, kv head) in an order the kernel
ranks on the device, longest walk first; where a block's 8 x rep query
rows do not fit shared memory (rep 32 at head dim 128, 71 heads of 64
over one kv head), they are split over the fewest blocks that fit, each
reading the pages itself, with the same bits. Pages over 128 keys are
folded in pieces, the same in every walk; any head dim and page size is
taken.
`ragged_plan`, `decode_plan` and `grouped_plan` report the launch the
library chooses for a batch's shapes.

The KV write goes to the slots `_paged_flat_slots` gives (past a row's
window: the trash page 0). On the unfused path (`paged_scatter`), into a
pool of q's dtype it is an in-place `index_copy_` on the flattened pool
(XLA's scatter in the JAX package); into an e4m3 pool it is K8 (clip to
+-448, round to nearest even), into an int8 pool K8-q8 (rowwise
quantize, then codes and scales to the same slots). The megakernel's
write stage (`paged_scatter_kernel`) is K8 for every float and e4m3
pool, as the JAX megakernel runs its Pallas scatter: a float pool's
write through K8 equals `index_copy_`'s bit for bit. K and V at the
same positions go through K8 in one launch (`paged_scatter_pair`,
`paged_scatter_kernel_pair`), and into int8 pools through K8-q8 in one
launch (`paged_scatter_q8_pair`), where the JAX package makes two
scatters. Moves of e4m3
bytes go through `view(torch.uint8)`: PyTorch's float8 coverage of
indexing and copies is patchy, and the bytes are the value.

The megakernel (`megakernel_decode[_q8]`, gate `resolve_megakernel_flag`
/ PADDLE_TPU_MEGAKERNEL, default off) composes the decode layer as the
JAX op does: the LoRA prologue (K11 for q, k and v, from the rows'
adapter pages), the write (K8 or K8-q8), then the ragged or grouped walk
(K6, K7, K10) over the updated pools; the o-projection's delta is K11
outside it. On the card K11 computes t = x . A once per row over a
thread-block cluster (`lora_plan` reports the launch). It is no launch of its own: one fused launch is later work.
Greedy sampling under the gate takes K12 (`decode_greedy_argmax`).
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import numpy as np
import torch

from . import _build
from .cost import kernel_cost, nbytes

__all__ = ["ragged_paged_attention", "ragged_paged_attention_q8",
           "ragged_attention_reference", "ragged_attention_reference_q8",
           "dequantize_paged_q8", "ragged_paged_attention_grouped",
           "ragged_paged_attention_grouped_q8",
           "grouped_attention_reference", "grouped_phase1", "grouped_phase2",
           "grouped_plan",
           "count_page_block_reads", "quantize_kv_rowwise", "paged_scatter",
           "paged_scatter_reference", "paged_scatter_q8",
           "paged_scatter_pair", "paged_scatter_kernel_pair",
           "paged_scatter_q8_reference", "paged_scatter_q8_pair",
           "_paged_flat_slots", "FP8_DTYPE",
           "paged_decode_attention", "paged_attention_reference",
           "decode_plan", "ragged_plan", "lora_plan", "piece_rows",
           "_mask_to_additive", "LAUNCHES", "GROUPED_LAUNCHES",
           "QUANT_LAUNCHES", "DECODE_LAUNCHES", "MEGA_LAUNCHES",
           "reset_launches", "NEG_INF", "paged_scatter_kernel",
           "lora_delta", "lora_delta_paged", "lora_delta_paged_reference",
           "decode_greedy_argmax", "spec_verify_accept",
           "resolve_megakernel_flag", "MEGAKERNEL_ENV", "megakernel_decode",
           "megakernel_decode_q8"]

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0    # the largest finite e4m3 value: the write's clip
# quantize_kv_rowwise's constants as f32 (the JAX package's
# jnp.float32(1e-8) and jnp.float32(1.0 / 127.0)); K8-q8 is handed the
# same bit patterns
Q8_EPS = np.float32(1e-8)
Q8_RECIP = np.float32(1.0 / 127.0)

LAUNCHES = 0                                   # K6
GROUPED_LAUNCHES = {"phase1": 0, "phase2": 0}  # K10a, K10b
# the 1-byte pool lanes, by kernel: K6 and K10 over e4m3 pools (fp8), K7
# and K10 over int8 code + f32 scale pools (q8), and their writes
QUANT_LAUNCHES = {"K6-fp8": 0, "K7": 0, "K10a-fp8": 0, "K10b-fp8": 0,
                  "K10a-q8": 0, "K10b-q8": 0, "K8": 0, "K8-q8": 0}
# K9, the single-token decode walk, over pools of q's dtype and e4m3 pools
DECODE_LAUNCHES = {"K9": 0, "K9-fp8": 0}
# the megakernel's own kernels: K8's float lane (its write stage into a
# pool of a float dtype), K11 (the paged LoRA delta) and K12 (the greedy
# argmax)
MEGA_LAUNCHES = {"K8-float": 0, "K11": 0, "K12": 0}
NEG_INF = -1e30    # the masked score, as in the TPU kernel
QBLK = 8           # queries per kernel block (the partials' row blocks)
# (walk kernel, pool lane) -> its QUANT_LAUNCHES key
_LANE_KERNEL = {("K6", "fp8"): "K6-fp8", ("K6", "q8"): "K7",
                ("K10a", "fp8"): "K10a-fp8", ("K10b", "fp8"): "K10b-fp8",
                ("K10a", "q8"): "K10a-q8", ("K10b", "q8"): "K10b-q8"}
_POOL_CODE = {"fp": _build.POOL_CODES["q"], "fp8": _build.POOL_CODES["e4m3"],
              "q8": _build.POOL_CODES["int8"]}


# -- the cost census's reckoning of each kernel (`cost.kernel_cost`) ----------
def _walk_work(kernel, q, k_pool, page_table, k_scale=None):
    """A paged walk at its table's full capacity: every query row against
    mp * ps keys, QK and AV (4 FLOPs a key a head element); q read and
    the output written once, each row's pages (and scales) read once."""
    b, w, h, d = q.shape
    keys = page_table.shape[1] * k_pool.shape[1]
    hkv = k_pool.shape[2]
    lane = _lane(k_pool)
    name = kernel if lane == "fp" else f"{kernel}-{lane}"
    pages = 2 * b * keys * hkv * (d * k_pool.element_size()
                                  + (4 if k_scale is not None else 0))
    return (name, 4 * b * w * h * d * keys,
            2 * nbytes(q) + pages + nbytes(page_table) + 8 * b)


def _ragged_work(q, k_pool, v_pool, page_table, *rest, **kw):
    return _walk_work("K6", q, k_pool, page_table)


def _ragged_q8_work(q, k_pool, v_pool, k_scale, v_scale, page_table, *rest,
                    **kw):
    return _walk_work("K6", q, k_pool, page_table, k_scale)


def _grouped_work(q, k_pool, v_pool, page_table, *rest, **kw):
    return _walk_work("K10", q, k_pool, page_table)


def _grouped_q8_work(q, k_pool, v_pool, k_scale, v_scale, page_table, *rest,
                     **kw):
    return _walk_work("K10", q, k_pool, page_table, k_scale)


def _decode_work(q, k_pool, v_pool, page_table, *rest, **kw):
    return _walk_work("K9", q, k_pool, page_table)


def _write_work(name, pools, upds, flops_each, scales=False):
    """A paged write: each update read once and written once in the
    pool's element size (plus an f32 scale a (token, head) row)."""
    n = sum(u.numel() for u in upds)
    rows = sum(u.numel() // u.shape[-1] for u in upds)
    return (name, flops_each * n,
            nbytes(*upds) + n * pools[0].element_size()
            + (4 * rows if scales else 0))


def _scatter_work(pool, upd, pos, page_table):
    return (None if pool.dtype != FP8_DTYPE
            else _write_work("K8", [pool], [upd], 4))


def _scatter_pair_work(k_pool, v_pool, k_upd, v_upd, pos, page_table):
    return (None if k_pool.dtype != FP8_DTYPE
            else _write_work("K8", [k_pool], [k_upd, v_upd], 4))


def _scatter_kernel_work(pool, upd, pos, page_table):
    return _write_work("K8", [pool], [upd],
                       4 if pool.dtype == FP8_DTYPE else 1)


def _scatter_kernel_pair_work(k_pool, v_pool, k_upd, v_upd, pos,
                              page_table):
    return _write_work("K8", [k_pool], [k_upd, v_upd],
                       4 if k_pool.dtype == FP8_DTYPE else 1)


def _scatter_q8_work(pool, scale_pool, upd, pos, page_table):
    return _write_work("K8-q8", [pool], [upd], 6, scales=True)


def _scatter_q8_pair_work(k_pool, v_pool, k_scale_pool, v_scale_pool, k_upd,
                          v_upd, pos, page_table):
    return _write_work("K8-q8", [k_pool], [k_upd, v_upd], 6, scales=True)


def _lora_work(x, a_pool, b_pool, apage, ascale):
    """K11: each row's A then B product over its W tokens; x read, the
    delta written, each row's adapter pair read once."""
    b, w, hid = x.shape
    r, out = b_pool.shape[1], b_pool.shape[2]
    return ("K11", 2 * b * w * r * (hid + out),
            nbytes(x) + b * w * out * x.element_size()
            + b * (hid * r + r * out) * a_pool.element_size()
            + nbytes(apage, ascale))


def _argmax_work(logits):
    return ("K12", logits.numel(), nbytes(logits) + 4 * logits.shape[0])


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0
    for counts in (GROUPED_LAUNCHES, QUANT_LAUNCHES, DECODE_LAUNCHES,
                   MEGA_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _lane(pool: torch.Tensor) -> str:
    """The pool lane of a K/V pool: "q8" (int8 codes), "fp8" (e4m3) or
    "fp" (a float pool of q's dtype)."""
    if pool.dtype == torch.int8:
        return "q8"
    return "fp8" if pool.dtype == FP8_DTYPE else "fp"


def _count_walk(kernel: str, lane: str):
    """One launch of walk kernel "K6", "K10a" or "K10b" in `lane`."""
    global LAUNCHES
    if lane != "fp":
        QUANT_LAUNCHES[_LANE_KERNEL[kernel, lane]] += 1
    elif kernel == "K6":
        LAUNCHES += 1
    else:
        GROUPED_LAUNCHES["phase1" if kernel == "K10a" else "phase2"] += 1


def _paged_flat_slots(ps: int, pos: torch.Tensor, page_table: torch.Tensor,
                      l: int) -> torch.Tensor:
    """Flat pool-slot index [B, l] (int64) of row b's token t: logical
    position p = pos[b] + t lives in slot page_table[b, p // ps] * ps +
    p % ps. Positions past the row's addressable window
    (mp * ps) go to page 0 — the reserved trash page — at slot p % ps,
    so the write never branches and never clobbers a live page."""
    mp = page_table.shape[1]
    p = pos.to(torch.int64)[:, None] + torch.arange(
        l, dtype=torch.int64, device=pos.device)[None, :]
    pidx = torch.clamp(p // ps, 0, mp - 1)
    ids = torch.gather(page_table.to(torch.int64), 1, pidx)
    flat = ids * ps + p % ps
    return torch.where(p < mp * ps, flat, p % ps)


# -- the writes: K8, K8-q8 and their plain versions ---------------------------
def quantize_kv_rowwise(u: torch.Tensor):
    """Rowwise int8 quantization of K/V values [..., D] (the JAX
    function): scale = max(max |u|, 1e-8) * f32(1/127) per leading row,
    written as a multiply as there, and codes = clamp(round(u / scale),
    -127, 127), `torch.round` rounding half to even as `jnp.round` does.
    Returns (codes int8 of u's shape, scales f32 u.shape[:-1])."""
    uf = u.float()
    amax = uf.abs().amax(dim=-1)
    # f32 tensor x Python float multiplies in f32, by the float's f32 value
    scale = torch.clamp(amax, min=float(Q8_EPS)) * float(Q8_RECIP)
    codes = torch.clamp(torch.round(uf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 tensor as its bytes (a view); any other tensor as is."""
    return t.view(torch.uint8) if t.dtype == FP8_DTYPE else t


def paged_scatter_reference(pool: torch.Tensor, upd: torch.Tensor,
                            pos: torch.Tensor, page_table: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version of the paged write (the JAX `paged_scatter`): upd
    [B, l, H, D] goes IN PLACE into pool [P, ps, H, D] at the slots
    `_paged_flat_slots` gives, one `index_copy_` on the flattened pool,
    converted to the pool's dtype — into an e4m3 pool clipped to +-448
    first and rounded to nearest even, written through the pool's bytes.
    Returns the pool. Several writes may land on one trash slot; which
    of them stays there is unspecified (trash keys are always masked)."""
    ps, l = pool.shape[1], upd.shape[1]
    flat = _paged_flat_slots(ps, pos, page_table, l).reshape(-1)
    rows = upd.reshape(-1, *upd.shape[2:])
    if pool.dtype == FP8_DTYPE:
        rows = rows.float().clamp(-FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    else:
        rows = rows.to(pool.dtype)
    _as_bytes(pool).view(-1, *pool.shape[2:]).index_copy_(
        0, flat, _as_bytes(rows))
    return pool


def paged_scatter_q8_reference(pool: torch.Tensor, scale_pool: torch.Tensor,
                               upd: torch.Tensor, pos: torch.Tensor,
                               page_table: torch.Tensor):
    """Plain version of the quantized write (the JAX `paged_scatter_q8`):
    upd [B, l, H, D] is quantized by `quantize_kv_rowwise`; its codes go
    IN PLACE into the int8 pool [P, ps, H, D] and its scales into the
    same slots of scale_pool [P, ps, H]. Returns (pool, scale_pool)."""
    ps, l = pool.shape[1], upd.shape[1]
    flat = _paged_flat_slots(ps, pos, page_table, l).reshape(-1)
    codes, scales = quantize_kv_rowwise(upd)
    pool.view(-1, *pool.shape[2:]).index_copy_(
        0, flat, codes.reshape(-1, *codes.shape[2:]))
    scale_pool.view(-1, scale_pool.shape[2]).index_copy_(
        0, flat, scales.reshape(-1, scales.shape[2]))
    return pool, scale_pool


def _scatter_check(name, pool, upd, pos, page_table, scale_pool=None):
    if upd.dim() != 4 or pool.dim() != 4 or pool.shape[2:] != upd.shape[2:]:
        raise ValueError(f"{name}: upd [B, l, H_kv, D] must fit the pool "
                         f"[P, ps, H_kv, D], got {tuple(upd.shape)} and "
                         f"{tuple(pool.shape)}")
    b = upd.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            pos.shape != (b,):
        raise ValueError(f"{name}: page_table [B, mp] and pos [B] must "
                         f"match upd's batch")
    for what, t in (("page_table", page_table), ("pos", pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    if scale_pool is not None and (scale_pool.shape != pool.shape[:3]
                                   or scale_pool.dtype != torch.float32):
        raise TypeError(f"{name}: the scale pool must be f32 "
                        f"{tuple(pool.shape[:3])}, got {scale_pool.dtype} "
                        f"{tuple(scale_pool.shape)}")
    ts = (pool, upd, pos, page_table) + (
        () if scale_pool is None else (scale_pool,))
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on {devs}")
    return tuple(t.contiguous() for t in (upd, pos, page_table))


def _scatter_geometry(pool, upd, page_table):
    b, l, hkv, d = upd.shape
    return (b, l, hkv, d, pool.shape[1], page_table.shape[1], pool.shape[0])


def _k8(name, writes, pos, page_table):
    """Launch K8 on the card for `writes`, one (pool, upd) pair or two
    (K and V: one launch, one slot lookup per token for both), into
    float pools (the float lane, counted in MEGA_LAUNCHES["K8-float"]) or
    e4m3 pools (the fp8 lane, QUANT_LAUNCHES["K8"]). The pools must be
    contiguous and share their dtype, the updates their dtype and
    shape."""
    checked = []
    for pool, upd in writes:
        upd, pos_c, table = _scatter_check(name, pool, upd, pos, page_table)
        if not pool.is_contiguous():
            raise ValueError(f"{name}: the pool must be contiguous")
        checked.append((pool, upd))
    (k_pool, k_upd), *rest = checked
    v_pool, v_upd = rest[0] if rest else (None, None)
    if rest and (v_pool.dtype != k_pool.dtype or v_upd.dtype != k_upd.dtype
                 or v_upd.shape != k_upd.shape
                 or v_pool.shape != k_pool.shape
                 or v_pool.device != k_pool.device):
        raise ValueError(f"{name}: K and V must share their pools' and "
                         "updates' dtypes, shapes and device")
    lib = _build.load("paged_scatter")
    ptrs = (k_upd.data_ptr(), k_pool.data_ptr(), _ptr(v_upd), _ptr(v_pool),
            table.data_ptr(), pos_c.data_ptr(),
            *_scatter_geometry(k_pool, k_upd, table),
            _build.dtype_code(k_upd.dtype))
    where = (k_pool.device.index, _build.stream_ptr(k_pool.device))
    if k_pool.dtype == FP8_DTYPE:
        err = lib.ptt_paged_scatter_e4m3(*ptrs, *where)
        _build.check(lib, err, "paged scatter (e4m3) kernel launch")
        QUANT_LAUNCHES["K8"] += 1
    else:
        err = lib.ptt_paged_scatter_float(
            *ptrs, _build.dtype_code(k_pool.dtype), *where)
        _build.check(lib, err, "paged scatter (float) kernel launch")
        MEGA_LAUNCHES["K8-float"] += 1


@kernel_cost(_scatter_work)
def paged_scatter(pool: torch.Tensor, upd: torch.Tensor, pos: torch.Tensor,
                  page_table: torch.Tensor) -> torch.Tensor:
    """The paged KV write, IN PLACE, returning the pool (see
    `paged_scatter_reference` for what it writes). An e4m3 pool on the
    card is written by K8; any other pool, and every pool on the CPU,
    by the plain version (for a float pool that is the JAX main path's
    scatter: an `index_copy_`). The pool must be contiguous."""
    if pool.dtype != FP8_DTYPE or pool.device.type == "cpu":
        return paged_scatter_reference(pool, upd, pos, page_table)
    if pool.device.type != "cuda":
        raise ValueError(f"paged_scatter: no kernel for device {pool.device}")
    _k8("paged_scatter", [(pool, upd)], pos, page_table)
    return pool


@kernel_cost(_scatter_pair_work)
def paged_scatter_pair(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       k_upd: torch.Tensor, v_upd: torch.Tensor,
                       pos: torch.Tensor, page_table: torch.Tensor):
    """`paged_scatter` of K and V at the same positions, IN PLACE,
    returning (k_pool, v_pool): e4m3 pools on the card in one K8 launch
    (the JAX package makes two scatters; one launch computes the same
    two writes), any other pool, and every pool on the CPU, by the plain
    version, one write each."""
    if k_pool.dtype != FP8_DTYPE or k_pool.device.type == "cpu":
        return (paged_scatter_reference(k_pool, k_upd, pos, page_table),
                paged_scatter_reference(v_pool, v_upd, pos, page_table))
    if k_pool.device.type != "cuda":
        raise ValueError(
            f"paged_scatter_pair: no kernel for device {k_pool.device}")
    _k8("paged_scatter_pair", [(k_pool, k_upd), (v_pool, v_upd)], pos,
        page_table)
    return k_pool, v_pool


@kernel_cost(_scatter_kernel_work)
def paged_scatter_kernel(pool: torch.Tensor, upd: torch.Tensor,
                         pos: torch.Tensor, page_table: torch.Tensor
                         ) -> torch.Tensor:
    """The megakernel's write stage (the JAX `_paged_scatter_kernel`):
    what `paged_scatter` writes, IN PLACE, returning the pool — on the
    card K8 for every pool it takes, a float pool (the float lane: each
    value cast to the pool's dtype, so a pool of upd's dtype equals
    `index_copy_`'s bits) or an e4m3 pool; on the CPU the plain version.
    The pool must be contiguous."""
    if pool.device.type == "cpu":
        return paged_scatter_reference(pool, upd, pos, page_table)
    if pool.device.type != "cuda":
        raise ValueError(
            f"paged_scatter_kernel: no kernel for device {pool.device}")
    _k8("paged_scatter_kernel", [(pool, upd)], pos, page_table)
    return pool


@kernel_cost(_scatter_kernel_pair_work)
def paged_scatter_kernel_pair(k_pool: torch.Tensor, v_pool: torch.Tensor,
                              k_upd: torch.Tensor, v_upd: torch.Tensor,
                              pos: torch.Tensor, page_table: torch.Tensor):
    """`paged_scatter_kernel` of K and V at the same positions in ONE K8
    launch on the card (float or e4m3 pools; the JAX megakernel runs its
    scatter twice, and one launch computes the same two writes), IN
    PLACE, returning (k_pool, v_pool); on the CPU the plain version, one
    write each."""
    if k_pool.device.type == "cpu":
        return (paged_scatter_reference(k_pool, k_upd, pos, page_table),
                paged_scatter_reference(v_pool, v_upd, pos, page_table))
    if k_pool.device.type != "cuda":
        raise ValueError(f"paged_scatter_kernel_pair: no kernel for device "
                         f"{k_pool.device}")
    _k8("paged_scatter_kernel_pair", [(k_pool, k_upd), (v_pool, v_upd)],
        pos, page_table)
    return k_pool, v_pool


def _k8q8(name, writes, pos, page_table):
    """Launch K8-q8 on the card for `writes`, one (pool, scale_pool, upd)
    triple or two (K and V: one launch, one slot lookup per token for
    both), counted in QUANT_LAUNCHES["K8-q8"]. The pools must be int8
    and f32 and contiguous, the updates share their dtype and shape."""
    checked = []
    for pool, scale_pool, upd in writes:
        if pool.dtype != torch.int8:
            raise TypeError(f"{name}: the pool must be int8, got "
                            f"{pool.dtype}")
        upd, pos_c, table = _scatter_check(name, pool, upd, pos, page_table,
                                           scale_pool)
        if not (pool.is_contiguous() and scale_pool.is_contiguous()):
            raise ValueError(f"{name}: the pools must be contiguous")
        checked.append((pool, scale_pool, upd))
    (k_pool, k_scale, k_upd), *rest = checked
    v_pool, v_scale, v_upd = rest[0] if rest else (None, None, None)
    if rest and (v_upd.dtype != k_upd.dtype or v_upd.shape != k_upd.shape
                 or v_pool.shape != k_pool.shape
                 or v_pool.device != k_pool.device):
        raise ValueError(f"{name}: K and V must share their pools' and "
                         "updates' shapes, dtypes and device")
    lib = _build.load("paged_scatter")
    err = lib.ptt_paged_scatter_q8_pair(
        k_upd.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(),
        _ptr(v_upd), _ptr(v_pool), _ptr(v_scale), table.data_ptr(),
        pos_c.data_ptr(), *_scatter_geometry(k_pool, k_upd, table),
        float(Q8_EPS), float(Q8_RECIP), _build.dtype_code(k_upd.dtype),
        k_pool.device.index, _build.stream_ptr(k_pool.device))
    _build.check(lib, err, "paged scatter (int8) kernel launch")
    QUANT_LAUNCHES["K8-q8"] += 1


@kernel_cost(_scatter_q8_work)
def paged_scatter_q8(pool: torch.Tensor, scale_pool: torch.Tensor,
                     upd: torch.Tensor, pos: torch.Tensor,
                     page_table: torch.Tensor):
    """The quantized paged KV write, IN PLACE, returning (pool,
    scale_pool) (see `paged_scatter_q8_reference`): K8-q8 on the card,
    the plain version on the CPU. Both pools must be contiguous."""
    if pool.device.type == "cpu":
        return paged_scatter_q8_reference(pool, scale_pool, upd, pos,
                                          page_table)
    if pool.device.type != "cuda":
        raise ValueError(
            f"paged_scatter_q8: no kernel for device {pool.device}")
    _k8q8("paged_scatter_q8", [(pool, scale_pool, upd)], pos, page_table)
    return pool, scale_pool


@kernel_cost(_scatter_q8_pair_work)
def paged_scatter_q8_pair(k_pool: torch.Tensor, v_pool: torch.Tensor,
                          k_scale_pool: torch.Tensor,
                          v_scale_pool: torch.Tensor, k_upd: torch.Tensor,
                          v_upd: torch.Tensor, pos: torch.Tensor,
                          page_table: torch.Tensor):
    """`paged_scatter_q8` of K and V at the same positions, IN PLACE,
    returning (k_pool, v_pool, k_scale_pool, v_scale_pool): on the card
    one K8-q8 launch (the JAX package makes two quantized scatters; one
    launch computes the same two writes), on the CPU the plain version,
    one write each."""
    if k_pool.device.type == "cpu":
        paged_scatter_q8_reference(k_pool, k_scale_pool, k_upd, pos,
                                   page_table)
        paged_scatter_q8_reference(v_pool, v_scale_pool, v_upd, pos,
                                   page_table)
        return k_pool, v_pool, k_scale_pool, v_scale_pool
    if k_pool.device.type != "cuda":
        raise ValueError(
            f"paged_scatter_q8_pair: no kernel for device {k_pool.device}")
    _k8q8("paged_scatter_q8_pair", [(k_pool, k_scale_pool, k_upd),
                                    (v_pool, v_scale_pool, v_upd)],
          pos, page_table)
    return k_pool, v_pool, k_scale_pool, v_scale_pool


def _pages_f32(pool: torch.Tensor, scale_pool: Optional[torch.Tensor],
               idx: torch.Tensor) -> torch.Tensor:
    """Pages `idx` (int64, any shape) of a pool as f32
    [*idx.shape, ps, H_kv, D]: an e4m3 pool upconverted (gathered
    through its bytes), an int8 pool times its scales (the JAX
    `dequantize_paged_q8` expression), a float pool as is."""
    if pool.dtype == FP8_DTYPE:
        return pool.view(torch.uint8)[idx].view(FP8_DTYPE).float()
    if scale_pool is not None:
        return pool[idx].float() * scale_pool[idx][..., None]
    return pool[idx].float()


def dequantize_paged_q8(pool: torch.Tensor, scale_pool: torch.Tensor,
                        page_table: torch.Tensor) -> torch.Tensor:
    """int8 code pool [P, ps, H_kv, D] and scale pool [P, ps, H_kv] ->
    each row's dequantized f32 logical view [B, mp * ps, H_kv, D] (the
    JAX function)."""
    b, mp = page_table.shape
    _, ps, hkv, d = pool.shape
    return _pages_f32(pool, scale_pool, page_table.to(torch.int64)).reshape(
        b, mp * ps, hkv, d)


def _ragged_attend(q, kf, vf, pos, q_len, mask=None):
    """The references' shared tail (the JAX `_ragged_mask_attend` →
    `gqa_attend_reference`): a grouped softmax in f32 over the dense f32
    logical views kf, vf [B, lmax, H_kv, D] under the ragged causal
    window, plus the additive f32 `mask` [B, H, lq, lmax] when given
    (added after the window mask, as the kernels add it)."""
    b, lq, h, d = q.shape
    lmax, hkv = kf.shape[1], kf.shape[2]
    rep = h // hkv
    i = torch.arange(lq, device=q.device)[None, :, None]
    j = torch.arange(lmax, device=q.device)[None, None, :]
    live = (i < q_len.to(torch.int64)[:, None, None]) & \
        (j <= pos.to(torch.int64)[:, None, None] + i)        # [B, lq, lmax]
    qg = q.float().reshape(b, lq, hkv, rep, d)
    s = torch.einsum("blgrd,bmgd->bgrlm", qg, kf) * (1.0 / math.sqrt(d))
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
    if mask is not None:                     # heads h = g * rep + r
        s = s + mask.float().reshape(b, hkv, rep, lq, lmax)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrlm,bmgd->blgrd", a, vf)
    return out.reshape(b, lq, h, d).to(q.dtype)


def ragged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_table: torch.Tensor, pos: torch.Tensor,
                               q_len: torch.Tensor,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of K6 and its fp8 lane: gather every row's
    pages into the dense logical view (e4m3 pools upconverted) and run a
    grouped softmax in f32 under the ragged causal window, plus the
    additive f32 `mask` [B, H, lq, lmax] when given (the JAX package's
    `ragged_attention_reference` through `_ragged_mask_attend`)."""
    b, _, _, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    lmax = page_table.shape[1] * ps
    tab = page_table.to(torch.int64)
    kf = _pages_f32(k_pool, None, tab).reshape(b, lmax, hkv, d)
    vf = _pages_f32(v_pool, None, tab).reshape(b, lmax, hkv, d)
    return _ragged_attend(q, kf, vf, pos, q_len, mask)


def ragged_attention_reference_q8(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  k_scale: torch.Tensor,
                                  v_scale: torch.Tensor,
                                  page_table: torch.Tensor,
                                  pos: torch.Tensor,
                                  q_len: torch.Tensor,
                                  mask: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of K7 (the JAX
    `ragged_attention_reference_q8`): dequantize the rows' code and
    scale pages (`dequantize_paged_q8`) and attend as the fp reference
    does, the additive `mask` included."""
    kf = dequantize_paged_q8(k_pool, k_scale, page_table)
    vf = dequantize_paged_q8(v_pool, v_scale, page_table)
    return _ragged_attend(q, kf, vf, pos, q_len, mask)


def piece_rows(d: int, ps: int) -> int:
    """The keys a walk folds at a time at head dim `d` and page size `ps`
    (`piece_rows` in csrc/paged_walk.cuh, mirrored for the plain
    emulations and the tests): the whole page up to 128 keys where its
    f32 tile fits shared memory beside 8 rows' state (at head dims over
    256, where it fits 64 KB), else equal pieces of at most that many
    keys (the last may be shorter)."""
    budget = (232448 // 4 - 8 * (2 * d + 2)) if d <= 256 else 16384
    cap = max(1, min(128, budget // (2 * d + 1)))
    if ps <= cap:
        return ps
    pieces = -(-ps // cap)
    return -(-ps // pieces)


def _check(q, k_pool, v_pool, page_table, pos, q_len, k_scale=None,
           v_scale=None, name="ragged_paged_attention"):
    b, lq, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: k/v pools must both be "
                         f"[P, ps, H_kv, D], got {tuple(k_pool.shape)} "
                         f"and {tuple(v_pool.shape)}")
    _, ps, hkv, dk = k_pool.shape
    if dk != d or h % hkv:
        raise ValueError(f"{name}: q heads {h} x dim {d} "
                         f"do not fit pools of {hkv} heads x dim {dk}")
    if page_table.shape[0] != b or pos.shape != (b,) or q_len.shape != (b,):
        raise ValueError(f"{name}: page_table [B, mp], pos "
                         "and q_len [B] must match q's batch")
    lane = _lane(k_pool)
    if v_pool.dtype != k_pool.dtype or (lane == "fp"
                                        and q.dtype != k_pool.dtype):
        raise TypeError(f"{name} kernel: the pools must "
                        "share q's dtype, or both be int8 (with scale "
                        f"pools) or float8_e4m3fn; got q {q.dtype}, pools "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    _build.dtype_code(q.dtype)     # q: f32, bf16 or f16 in every lane
    scales = [t for t in (k_scale, v_scale) if t is not None]
    if lane == "q8":
        if len(scales) != 2 or any(t.shape != k_pool.shape[:3]
                                   or t.dtype != torch.float32
                                   for t in scales):
            raise TypeError(f"{name} kernel: int8 pools "
                            "need f32 scale pools [P, ps, H_kv]")
    elif scales:
        raise TypeError(f"{name} kernel: scale pools ride "
                        "int8 pools only")
    for what, t in (("page_table", page_table), ("pos", pos),
                    ("q_len", q_len)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {what} must be int32, got {t.dtype}")
    devs = {t.device for t in (q, k_pool, v_pool, page_table, pos, q_len,
                               *scales)}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on {devs}")


def _contiguous(*ts):
    return tuple(None if t is None else t.contiguous() for t in ts)


def _check_aligned(k_pool, v_pool):
    """The kernels read pool rows with copies of up to 16 bytes."""
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("ragged_paged_attention kernel: the pools must "
                         "start on a 16-byte boundary")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _geometry(q, k_pool, page_table):
    b, lq, h, d = q.shape
    n_pages, ps, hkv, _ = k_pool.shape
    return (b, lq, h, hkv, d, ps, page_table.shape[1], n_pages,
            _build.dtype_code(q.dtype), _POOL_CODE[_lane(k_pool)],
            q.device.index, _build.stream_ptr(q.device))


def _not_int8(k_pool, name):
    if k_pool.dtype == torch.int8:
        raise TypeError(f"{name}: int8 pools need their scale pools: use "
                        f"{name}_q8")


def _ragged_operands(q, k_pool, page_table, pos, q_len, mask):
    """pos and q_len as int32 [B] (a 0-dim one broadcast) and the user
    mask as the additive f32 [B, H, lq, lmax] the walks take (None
    stays None)."""
    b, lq, h, _ = q.shape
    out = []
    for v in (pos, q_len):
        v = v.to(torch.int32)
        out.append(v.reshape(1).expand(b).contiguous() if v.dim() == 0
                   else v)
    if mask is not None:
        lmax = page_table.shape[1] * k_pool.shape[1]
        mask = _mask_to_additive(mask, b, h, lmax, lq)
        if lq == 1:
            mask = mask.reshape(b, h, 1, lmax)
    return out[0], out[1], mask


def _ragged(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, q_len,
            mask=None):
    pos, q_len, mask = _ragged_operands(q, k_pool, page_table, pos, q_len,
                                        mask)
    if q.device.type == "cpu":
        if k_scale is None:
            return ragged_attention_reference(q, k_pool, v_pool, page_table,
                                              pos, q_len, mask)
        return ragged_attention_reference_q8(q, k_pool, v_pool, k_scale,
                                             v_scale, page_table, pos, q_len,
                                             mask)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: no kernel for device {q.device}")
    _check(q, k_pool, v_pool, page_table, pos, q_len, k_scale, v_scale)
    if mask is not None and mask.device != q.device:
        raise ValueError(f"ragged_paged_attention: mask on {mask.device}, "
                         f"q on {q.device}")
    q, k_pool, v_pool, k_scale, v_scale, page_table, pos, q_len, mask = \
        _contiguous(q, k_pool, v_pool, k_scale, v_scale, page_table, pos,
                    q_len, mask)
    _check_aligned(k_pool, v_pool)
    out = torch.empty_like(q)
    lib = _build.load("ragged_paged_attention")
    err = lib.ptt_ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), page_table.data_ptr(), pos.data_ptr(),
        q_len.data_ptr(), _ptr(mask), out.data_ptr(),
        *_geometry(q, k_pool, page_table))
    _check_walk(lib, err, "ragged_paged_attention kernel launch",
                lambda: ragged_plan(q, k_pool))
    _count_walk("K6", _lane(k_pool))
    return out


@kernel_cost(_ragged_work)
def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, q_len: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Ragged paged attention (see the module doc) over pools of q's
    dtype (K6) or e4m3 pools (K6's fp8 lane). pos and q_len are [B] (a
    scalar is broadcast). `mask`, optional: a user attention mask, bool
    or additive float, broadcastable to [B, H, lq, mp * ps], composed
    with the ragged window in the kernel (its mask lane)."""
    _not_int8(k_pool, "ragged_paged_attention")
    return _ragged(q, k_pool, v_pool, None, None, page_table, pos, q_len,
                   mask)


@kernel_cost(_ragged_q8_work)
def ragged_paged_attention_q8(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor,
                              page_table: torch.Tensor, pos: torch.Tensor,
                              q_len: torch.Tensor,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Ragged paged attention over int8 code pools with their f32 scale
    pools [P, ps, H_kv] (K7): the output of `ragged_paged_attention` over
    the dequantized pools, the user mask as there."""
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError("ragged_paged_attention_q8: the pools must be int8, "
                        f"got {k_pool.dtype}, {v_pool.dtype}")
    return _ragged(q, k_pool, v_pool, k_scale.float(), v_scale.float(),
                   page_table, pos, q_len, mask)


# -- K9: the single-token decode walk ----------------------------------------
def _mask_to_additive(mask: torch.Tensor, b: int, h: int, lmax: int,
                      lq: int = 1) -> torch.Tensor:
    """User attn_mask (bool, or additive float), broadcastable to
    [B, H, lq, lmax] -> additive f32 [B, H, lq, lmax], contiguous
    (squeezed to [B, H, lmax] for the single-token kernel, lq 1): a bool
    mask becomes 0 where True and -1e30 where False (the JAX
    function)."""
    if mask.dtype == torch.bool:
        mask = torch.where(mask, torch.zeros((), device=mask.device),
                           torch.full((), NEG_INF, device=mask.device))
    out = torch.broadcast_to(mask.float(), (b, h, lq, lmax))
    return (out.reshape(b, h, lmax) if lq == 1 else out).contiguous()


def paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              pos: torch.Tensor,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of K9 (the JAX function): gather every row's
    pages into the dense logical view (e4m3 pools upconverted), then a
    grouped softmax in f32 over keys j <= pos[b] with the additive f32
    `mask` [B, H, mp * ps] added after the window mask. It is
    `ragged_attention_reference` at q_len 1, mask added; the output is in
    q's dtype."""
    b, _, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    lmax = page_table.shape[1] * ps
    tab = page_table.to(torch.int64)
    kf = _pages_f32(k_pool, None, tab).reshape(b, lmax, hkv, d)
    vf = _pages_f32(v_pool, None, tab).reshape(b, lmax, hkv, d)
    ones = torch.ones(b, dtype=torch.int32, device=q.device)
    return _ragged_attend(q, kf, vf, pos, ones,
                          None if mask is None else mask.reshape(b, h, 1,
                                                                 lmax))


@kernel_cost(_decode_work)
def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token paged decode attention (the JAX op): q [B, 1, H, D]
    over pools [P, ps, H_kv, D] of q's dtype or float8 e4m3; row b
    attends positions 0 .. pos[b] (pos [B], or a scalar for every row:
    the new token's K/V was just written at pos). `mask`, optional: a
    user attention mask, bool or additive float, broadcastable to
    [B, H, 1, mp * ps], composed with the window in the kernel. On the
    card this is K9 (counted in DECODE_LAUNCHES: "K9", or "K9-fp8" for
    e4m3 pools); int8 pools, or tensors on several devices, raise there.
    On the CPU it is
    `paged_attention_reference`."""
    b, l, h, d = q.shape
    if l != 1:
        raise ValueError(
            f"paged_decode_attention is a single-token decode kernel; got "
            f"l={l} (chunked prefill stays on the gather path)")
    lmax = page_table.shape[1] * k_pool.shape[1]
    posv = pos.to(torch.int32) if torch.is_tensor(pos) else torch.tensor(
        pos, dtype=torch.int32, device=q.device)
    if posv.dim() == 0:
        posv = posv.reshape(1).expand(b)
    if mask is not None:
        mask = _mask_to_additive(mask, b, h, lmax)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, page_table,
                                         posv, mask)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: no kernel for device {q.device}")
    if k_pool.dtype == torch.int8:
        raise TypeError("paged_decode_attention kernel: int8 pools have no "
                        "K9 lane; attend them with ragged_paged_attention_q8"
                        " at q_len 1 (K7)")
    posv = posv.contiguous()
    _check(q, k_pool, v_pool, page_table, posv, posv,
           name="paged_decode_attention")
    if mask is not None and mask.device != q.device:
        raise ValueError(f"paged_decode_attention: mask on {mask.device}, "
                         f"q on {q.device}")
    q, k_pool, v_pool, page_table = _contiguous(q, k_pool, v_pool,
                                                page_table)
    _check_aligned(k_pool, v_pool)
    out = torch.empty_like(q)
    n_pages, ps, hkv, _ = k_pool.shape
    lane = _lane(k_pool)
    lib = _build.load("paged_decode_attention")
    err = lib.ptt_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), posv.data_ptr(), _ptr(mask), out.data_ptr(),
        b, h, hkv, d, ps, page_table.shape[1], n_pages,
        _build.dtype_code(q.dtype), _POOL_CODE[lane], q.device.index,
        _build.stream_ptr(q.device))
    _check_walk(lib, err, "paged_decode_attention kernel launch",
                lambda: decode_plan(q, k_pool))
    DECODE_LAUNCHES["K9" if lane == "fp" else "K9-fp8"] += 1
    return out


# the keys of a walk's launch report (`walk_plan` in csrc/paged_walk.cuh)
_WALK_PLAN = ("stages", "tiles", "smem", "paired", "grid", "threads",
              "rows", "piece", "copy", "split")
# the dynamic shared memory a walk block may take (kDynSmemMax there)
_WALK_SMEM = 232448 - 4 * (512 + 4)


def _walk_plan(lib, entry, args, what):
    out = (ctypes.c_int * len(_WALK_PLAN))()
    if getattr(lib, entry)(*args, out):
        need = int(out[2])
        if need:
            raise ValueError(
                f"{what} kernel: no launch for these shapes: a block of "
                f"one query row needs {need} bytes of shared memory, over "
                f"the {_WALK_SMEM} a walk block may take")
        raise ValueError(f"{what} kernel: no launch for these shapes")
    return dict(zip(_WALK_PLAN, (int(x) for x in out)))


def _check_walk(lib, err, what, plan):
    """Raise if a walk's C entry failed: where not even one query row
    fits a block, with the bytes it needs (`plan()` raises that), else
    with the CUDA error."""
    if err:
        plan()
    _build.check(lib, err, what)


def decode_plan(q: torch.Tensor, k_pool: torch.Tensor) -> dict:
    """The launch K9 makes for q [B, 1, H, D] over pools like `k_pool`
    (any device: only shapes and dtypes are read), with or without a user
    mask, as the library chooses it (`ptt_decode_plan`): "stages" (raw
    page stages of the cp.async ring; 0 where the ring does not fit, or a
    pool row is not a multiple of 4 bytes, and each page is loaded
    straight into one tile), "tiles" (f32 working tiles), "smem" (dynamic
    shared memory bytes a block), "paired" (two query rows a warp),
    "grid" (blocks), "threads" (a block), "rows" (query rows a block, at
    most), "piece" (the keys a page is folded in at a time: the page size
    up to 128), "copy" (the bytes of one copy: 16, 8 or 4, or one
    element) and "split" (the blocks a row's query rows are split over:
    1 unless they pass shared memory beside the tiles). Raises ValueError
    where K9 takes no launch: a pool lane it does not take, or a shape
    where not even one query row fits a block (the message gives the
    bytes)."""
    b, _, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    return _walk_plan(_build.load("paged_decode_attention"),
                      "ptt_decode_plan",
                      (b, h, hkv, d, ps, _build.dtype_code(q.dtype),
                       _POOL_CODE[_lane(k_pool)]),
                      f"paged_decode_attention (q {tuple(q.shape)} "
                      f"{q.dtype} over {k_pool.dtype} pools of page size "
                      f"{ps})")


def ragged_plan(q: torch.Tensor, k_pool: torch.Tensor) -> dict:
    """The launch K6 (K7 over int8 pools) makes for q [B, lq, H, D] over
    pools like `k_pool`, with or without a user mask, as the library
    chooses it (`ptt_ragged_plan`); the keys as `decode_plan`'s. Raises
    ValueError where the kernel takes no launch."""
    b, lq, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    return _walk_plan(_build.load("ragged_paged_attention"),
                      "ptt_ragged_plan",
                      (b, lq, h, hkv, d, ps, _build.dtype_code(q.dtype),
                       _POOL_CODE[_lane(k_pool)]),
                      f"ragged_paged_attention (q {tuple(q.shape)} "
                      f"{q.dtype} over {_lane(k_pool)} pools of page size "
                      f"{ps})")


# -- K10: the grouped walk ----------------------------------------------------
def count_page_block_reads(page_table, pos, q_len, group_id=None,
                           group_cnt=None, *, page_size, n_kv=1, mp=1,
                           fused=None):
    """Host-side (numpy) model of the page-block reads of ONE
    (kv head, layer) walk: the number the serving metrics report. Per
    live row (q_len > 0) the per-row walk reads its pages
    0 .. (pos + q_len - 1) // page_size; the grouped walk reads each
    group's shared span once plus each member's private tail. Returns
    (flat_reads, grouped_reads, group_sizes), group_sizes listing the
    member count of every group that shares (>= 2 live members); without
    group operands grouped_reads == flat_reads.

    Tensor-parallel serving (serving/tp.py): with the model's `n_kv` and
    the mesh's `mp` the counts are what ONE shard issues a layer — its
    n_kv / mp local heads' walks, each block a 1/mp slice of a page — so
    a shard's reads, and the reads the grouped walk saves it, drop by mp.
    The defaults (n_kv 1, mp 1) give the single walk's numbers.

    `fused=` (the megakernel's referee, the cost census's page-walk
    record): {"head_dim": D, "kv_elt": bytes a KV element, "scale_elt":
    bytes of a (token, head) scale (4 with int8 scales, else 0),
    "lora_bytes": one projection's adapter-page bytes for the step}, and
    a fourth value comes back: the walk's modeled bytes under both
    pipelines, {"unfused": ..., "fused": ...}. Both pay the grouped
    walk's K and V stream and the new tokens' write; the unfused one
    also pays their f32 K/V staged between the projection and the
    scatter, and gathers the adapter page per projection (3 x
    lora_bytes) where the fused prologue streams it once."""
    pos = np.asarray(pos, np.int64)
    q_len = np.asarray(q_len, np.int64)
    ps = int(page_size)
    live = q_len > 0
    row_pages = np.where(live, (pos + np.maximum(q_len, 1) - 1) // ps + 1,
                         0)
    local_heads = max(1, int(n_kv) // max(1, int(mp)))
    flat = int(row_pages.sum())
    grouped = flat
    sizes = []
    if group_id is not None and group_cnt is not None:
        group_id = np.asarray(group_id, np.int64)
        group_cnt = np.asarray(group_cnt, np.int64)
        grouped = 0
        for g in np.unique(group_id[live]):
            members = np.nonzero(live & (group_id == g))[0]
            cnt = int(group_cnt[g])
            shared = min(cnt, int(row_pages[members].min())) \
                if members.size else 0
            # the shared span streams once; each member walks its tail
            grouped += shared
            grouped += int((row_pages[members] - shared).sum())
            if members.size >= 2 and shared > 0:
                sizes.append(int(members.size))
    flat *= local_heads
    grouped *= local_heads
    if fused is None:
        return flat, grouped, sizes
    d = int(fused["head_dim"])
    kv_elt = int(fused.get("kv_elt", 4))
    scale_elt = int(fused.get("scale_elt", 0))
    lora_bytes = int(fused.get("lora_bytes", 0))
    attn = grouped * ps * (d * kv_elt + scale_elt) * 2
    new_tokens = int(q_len[live].sum())
    write = new_tokens * local_heads * (d * kv_elt + scale_elt) * 2
    stage = new_tokens * local_heads * d * 4 * 2
    return flat, grouped, sizes, {
        "unfused": attn + write + stage + 3 * lora_bytes,
        "fused": attn + write + lora_bytes}


def _grouped_operands(b: int, pos, q_len, group_id, group_leader,
                      group_cnt):
    """The grouped op's scalar operands as int32 [B] tensors (a 0-dim
    operand is broadcast)."""
    out = []
    for v in (pos, q_len, group_id, group_leader, group_cnt):
        v = v.to(torch.int32)
        if v.dim() == 0:
            v = v.reshape(1).expand(b)
        out.append(v.contiguous())
    return out


def grouped_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                page_table: torch.Tensor, pos: torch.Tensor,
                                q_len: torch.Tensor, group_id: torch.Tensor,
                                group_leader: torch.Tensor,
                                group_cnt: torch.Tensor,
                                return_partials: bool = False,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K10: the two-phase online softmax in f32,
    one page at a time, with the kernels' blocking (queries in blocks of
    QBLK; a block reads pages through its last live query's position).
    A page is read as the kernels stage it: e4m3 upconverted, int8 times
    `k_scale`/`v_scale` (the q8 lane), a float pool as is.

    Phase 1 folds each sharing group's pages [0, group_cnt) — read
    through the leader's table — into the partials (m, l, acc) of its
    member rows; member b's query block folds pages
    [0, min(cnt, its last page + 1)). Phase 2 continues every row from
    its partials (or from (-1e30, 0, 0) for a row whose group shares
    nothing) over the rest of its block's pages, and the output is
    acc / max(l, 1e-30); a query block past q_len gives zeros. A group
    id outside [0, B) walks as a singleton.

    With `return_partials` it also returns the phase-1 partials in the
    kernel's layout — m, l [H_kv, nqb, B*QBLK*rep], acc [.., D] — and
    `written` [H_kv, nqb, B*QBLK*rep], the rows phase 1 folds (member
    rows of live query blocks). The other rows keep (-1e30, 0, 0); the
    kernel leaves them unwritten."""
    b, lq, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    mp = page_table.shape[1]
    rep = h // hkv
    qblk = min(lq, QBLK)
    nqb = -(-lq // qblk)
    lqp = nqb * qblk
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    qf = torch.zeros(b, lqp, hkv, rep, d, dtype=torch.float32, device=dev)
    qf[:, :lq] = q.float().reshape(b, lq, hkv, rep, d)
    tab = page_table.to(torch.int64)
    pos64, ql = pos.to(torch.int64), q_len.to(torch.int64)
    i = torch.arange(lqp, device=dev)
    q0 = (i // qblk) * qblk
    blk_live = q0[None, :] < ql[:, None]                       # [B, lqp]
    last_qi = torch.minimum(q0[None, :] + qblk, ql[:, None]) - 1
    npg = torch.clamp((pos64[:, None] + last_qi) // ps + 1, max=mp)
    gid = group_id.to(torch.int64)
    valid = (gid >= 0) & (gid < b)
    gidc = gid.clamp(0, b - 1)
    cnt = torch.where(valid, group_cnt.to(torch.int64)[gidc],
                      torch.zeros_like(gid))
    leader = group_leader.to(torch.int64)[gidc].clamp(0, b - 1)
    shared = torch.where(blk_live & (cnt[:, None] > 0),
                         torch.minimum(cnt[:, None], npg),
                         torch.zeros_like(npg))                # [B, lqp]
    qlive = i[None, :] < ql[:, None]
    qmax = pos64[:, None] + i[None, :]
    kpos = torch.arange(ps, device=dev)
    rows = torch.arange(b, device=dev)
    m = torch.full((b, lqp, hkv, rep), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)

    def fold(p, page_ids, active):
        nonlocal m, l, acc
        page_ids = page_ids.clamp(0, k_pool.shape[0] - 1)
        kk = _pages_f32(k_pool, k_scale, page_ids)         # [B, ps, hkv, d]
        vv = _pages_f32(v_pool, v_scale, page_ids)
        s = torch.einsum("bigrd,bjgd->bigrj", qf, kk) * scale
        live = qlive[..., None] & (p * ps + kpos <= qmax[..., None])
        s = torch.where(live[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        mnew = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mnew)
        pexp = torch.exp(s - mnew[..., None])
        lnew = alpha * l + pexp.sum(-1)
        accnew = acc * alpha[..., None] + torch.einsum(
            "bigrj,bjgd->bigrd", pexp, vv)
        a = active[:, :, None, None]
        m = torch.where(a, mnew, m)
        l = torch.where(a, lnew, l)
        acc = torch.where(a[..., None], accnew, acc)

    # every page index is folded where it is active (no host sync, so
    # the card can time this version)
    for p in range(mp):                     # phase 1: the shared spans
        fold(p, tab[leader, p], p < shared)
    partials = (m, l, acc)
    for p in range(mp):                     # phase 2: the private tails
        fold(p, tab[rows, p], blk_live & (p >= shared) & (p < npg))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where(blk_live[:, :, None, None, None], out,
                      torch.zeros_like(out))
    out = out.reshape(b, lqp, h, d)[:, :lq].to(q.dtype)
    if not return_partials:
        return out

    def kernel_layout(x):                   # [B, lqp, hkv, rep, ...]
        x = x.reshape(b, nqb, qblk, hkv, rep, *x.shape[4:])
        x = x.permute(3, 1, 0, 2, 4, *range(5, x.dim()))
        return x.reshape(hkv, nqb, b * qblk * rep, *x.shape[5:])

    m1, l1, acc1 = partials
    written = (shared > 0)[:, :, None, None].expand(b, lqp, hkv, rep)
    return out, (kernel_layout(m1), kernel_layout(l1), kernel_layout(acc1),
                 kernel_layout(written))


def _grouped(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, q_len,
             group_id, group_leader, group_cnt):
    b = q.shape[0]
    ops = (q, k_pool, v_pool, page_table, *_grouped_operands(
        b, pos, q_len, group_id, group_leader, group_cnt))
    scales = dict(k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cpu":
        return grouped_attention_reference(*ops, **scales)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention_grouped: no kernel for device "
            f"{q.device}")
    ops = _grouped_check(*ops, **scales)
    return grouped_phase2(*ops, grouped_phase1(*ops, **scales), **scales)


@kernel_cost(_grouped_work)
def ragged_paged_attention_grouped(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   page_table: torch.Tensor,
                                   pos: torch.Tensor, q_len: torch.Tensor,
                                   group_id: torch.Tensor,
                                   group_leader: torch.Tensor,
                                   group_cnt: torch.Tensor,
                                   mask: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Prefix-sharing-aware ragged paged attention (see the module doc):
    the output of `ragged_paged_attention`, with each group's shared
    pages read once per group, over pools of q's dtype or e4m3 pools.
    Operand contract (the serving engine's `shared_prefix_groups` keeps
    it): rows of one group carry identical page-table entries for
    indices [0, group_cnt), and those pages hold committed KV at or below
    every member's pos. On the card both phases launch on every call
    (`grouped_phase1`, `grouped_phase2`), each counted in
    GROUPED_LAUNCHES (QUANT_LAUNCHES for e4m3 pools). Under a user mask
    the op runs `ragged_paged_attention` with it (K6's mask lane), as the
    JAX op falls back to its ungrouped kernel: the output is the same,
    only the walk differs."""
    _not_int8(k_pool, "ragged_paged_attention_grouped")
    if mask is not None:
        return ragged_paged_attention(q, k_pool, v_pool, page_table, pos,
                                      q_len, mask)
    return _grouped(q, k_pool, v_pool, None, None, page_table, pos, q_len,
                    group_id, group_leader, group_cnt)


@kernel_cost(_grouped_q8_work)
def ragged_paged_attention_grouped_q8(q: torch.Tensor, k_pool: torch.Tensor,
                                      v_pool: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      page_table: torch.Tensor,
                                      pos: torch.Tensor, q_len: torch.Tensor,
                                      group_id: torch.Tensor,
                                      group_leader: torch.Tensor,
                                      group_cnt: torch.Tensor,
                                      mask: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """K10's q8 lane: the grouped walk over int8 code pools, each page's
    scales staged with its codes, with the output of
    `ragged_paged_attention_q8` (on the card, the same bits); under a
    user mask, `ragged_paged_attention_q8` with it (K7's mask lane)."""
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError("ragged_paged_attention_grouped_q8: the pools must "
                        f"be int8, got {k_pool.dtype}, {v_pool.dtype}")
    if mask is not None:
        return ragged_paged_attention_q8(q, k_pool, v_pool, k_scale,
                                         v_scale, page_table, pos, q_len,
                                         mask)
    return _grouped(q, k_pool, v_pool, k_scale.float(), v_scale.float(),
                    page_table, pos, q_len, group_id, group_leader,
                    group_cnt)


def _grouped_check(q, k_pool, v_pool, page_table, pos, q_len, group_id,
                   group_leader, group_cnt, k_scale=None, v_scale=None):
    """Check the grouped op's operands for the kernels and return the
    first nine contiguous (the scale pools are made contiguous where
    they are passed)."""
    _check(q, k_pool, v_pool, page_table, pos, q_len, k_scale, v_scale)
    b = q.shape[0]
    for name, t in (("group_id", group_id), ("group_leader", group_leader),
                    ("group_cnt", group_cnt)):
        if t.shape != (b,) or t.dtype != torch.int32 or \
                t.device != q.device:
            raise ValueError(f"ragged_paged_attention_grouped: {name} must "
                             f"be int32 [B] on {q.device}")
    ops = _contiguous(q, k_pool, v_pool, page_table, pos, q_len, group_id,
                      group_leader, group_cnt)
    _check_aligned(ops[1], ops[2])
    return ops


def grouped_plan(q, k_pool) -> dict:
    """The launch both K10 entries make for q [B, lq, H, D] over pools
    like `k_pool` (any device: only shapes and dtypes are read), as the
    library chooses it (`ptt_grouped_plan`); the keys as `decode_plan`'s.
    Raises ValueError where the kernels take no launch: the wrappers'
    launch would fail there."""
    b, lq, h, d = q.shape
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    return _walk_plan(_build.load("grouped_paged_attention"),
                      "ptt_grouped_plan",
                      (b, lq, h, hkv, d, ps, _build.dtype_code(q.dtype),
                       _POOL_CODE[_lane(k_pool)]),
                      f"ragged_paged_attention_grouped (q {tuple(q.shape)} "
                      f"{q.dtype} over {_lane(k_pool)} pools of page size "
                      f"{ps})")


def grouped_phase1(q, k_pool, v_pool, page_table, pos, q_len, group_id,
                   group_leader, group_cnt, k_scale=None, v_scale=None):
    """K10a alone, on checked contiguous CUDA operands (and the scale
    pools of an int8 pool): launch phase 1 and return the partials
    (m, l, acc), f32 [H_kv, nqb, B*QBLK*rep] (acc with a last axis D),
    allocated here with torch.empty; only the rows phase 1 folds are
    written."""
    b, lq, h, d = q.shape
    hkv = k_pool.shape[2]
    qblk = min(lq, QBLK)
    nrows = b * qblk * (h // hkv)
    m = torch.empty((hkv, -(-lq // qblk), nrows), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((*m.shape, d), dtype=torch.float32, device=q.device)
    k_scale, v_scale = _contiguous(k_scale, v_scale)
    lib = _build.load("grouped_paged_attention")
    err = lib.ptt_grouped_phase1(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale),
        *(t.data_ptr() for t in (page_table, pos, q_len, group_id,
                                 group_leader, group_cnt, m, l, acc)),
        *_geometry(q, k_pool, page_table))
    _check_walk(lib, err, "grouped paged attention phase 1 launch",
                lambda: grouped_plan(q, k_pool))
    _count_walk("K10a", _lane(k_pool))
    return m, l, acc


def grouped_phase2(q, k_pool, v_pool, page_table, pos, q_len, group_id,
                   group_leader, group_cnt, partials, k_scale=None,
                   v_scale=None):
    """K10b alone: launch phase 2 from phase 1's `partials` and return
    the output [B, lq, H, D]."""
    out = torch.empty_like(q)
    k_scale, v_scale = _contiguous(k_scale, v_scale)
    lib = _build.load("grouped_paged_attention")
    err = lib.ptt_grouped_phase2(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _ptr(k_scale),
        _ptr(v_scale),
        *(t.data_ptr() for t in (page_table, pos, q_len, group_id,
                                 group_cnt, *partials, out)),
        *_geometry(q, k_pool, page_table))
    _check_walk(lib, err, "grouped paged attention phase 2 launch",
                lambda: grouped_plan(q, k_pool))
    _count_walk("K10b", _lane(k_pool))
    return out


# -- the decode megakernel: K11, K12 and their composition (K13) --------------
MEGAKERNEL_ENV = "PADDLE_TPU_MEGAKERNEL"


def resolve_megakernel_flag(override=None) -> bool:
    """The decode-megakernel gate (the JAX function): an explicit
    override wins, else PADDLE_TPU_MEGAKERNEL (on|off and their spellings
    1/true/yes, 0/false/no; default off). Anything else raises
    ValueError."""
    if override is not None:
        if isinstance(override, bool):
            return override
        flag = str(override)
    else:
        flag = os.environ.get(MEGAKERNEL_ENV, "off")
    low = flag.strip().lower()
    if low in ("on", "1", "true", "yes"):
        return True
    if low in ("off", "0", "false", "no"):
        return False
    raise ValueError(
        f"{MEGAKERNEL_ENV} / megakernel must be on|off, got {flag!r}")


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta (the JAX `lora_delta`): x [B, W, in], a
    [B, in, R] and b [B, R, out] the rows' own low-rank pairs, scale [B]
    the rows' LoRA scaling -> (x . a) . b * scale in x's dtype, rounded
    to x's dtype where the JAX function rounds: after each product and
    after the scale (in x's dtype). The products are f32 batched matmuls
    (the JAX package leaves this op to XLA, outside any kernel). A zero
    page or a zero scale gives exactly 0."""
    dt = x.dtype
    t = torch.bmm(x.float(), a.float()).to(dt)
    d = torch.bmm(t.float(), b.float()).to(dt)
    s = scale.to(dt).float()[:, None, None]
    return (d.float() * s).to(dt)


def lora_delta_paged_reference(x: torch.Tensor, a_pool: torch.Tensor,
                               b_pool: torch.Tensor, apage: torch.Tensor,
                               ascale: torch.Tensor) -> torch.Tensor:
    """Plain version of K11 (the JAX `lora_delta_paged` off the TPU):
    gather each row's adapter page from the pools, then `lora_delta`."""
    ap = apage.to(torch.int64)
    return lora_delta(x, a_pool[ap], b_pool[ap],
                      ascale.to(torch.float32))


def lora_plan(x: torch.Tensor, a_pool: torch.Tensor,
              b_pool: torch.Tensor) -> dict:
    """The launch K11 makes for x [B, W, in] over pools like `a_pool`
    [P, in, R] and `b_pool` [P, R, out] (any device: only shapes and the
    dtype are read), as the library chooses it (`ptt_lora_plan`):
    "cluster" (blocks of one thread-block cluster, which share a row's
    t = x . A over distributed shared memory), "clusters_per_row" (each
    over up to 64 positions), "in_slice" and "out_tile" (the IN slice a
    block sums t over, the OUT columns it writes), "smem" (dynamic shared
    memory bytes a block), "grid" (blocks), "threads" (a block),
    "tensor_cores" (1 where both products run on mma.sync: bf16, f16),
    "positions" (a cluster's positions, fewer where a large rank's tiles
    would not fit shared memory) and "rank_group" (the ranks of t summed
    at a time; d sums over all of R in k-steps of 16). Raises ValueError
    for a dtype the kernel does not take, or a rank so large that no
    plan fits shared memory."""
    bsz, w, cin = x.shape
    r, cout = a_pool.shape[2], b_pool.shape[2]
    lib = _build.load("lora_paged")
    out = (ctypes.c_int * 10)()
    if lib.ptt_lora_plan(bsz, w, cin, r, cout, _build.dtype_code(x.dtype),
                         out):
        raise ValueError(f"lora_delta_paged kernel: no launch for x "
                         f"{tuple(x.shape)} {x.dtype} at rank {r}")
    return dict(zip(("cluster", "clusters_per_row", "in_slice", "out_tile",
                     "smem", "grid", "threads", "tensor_cores", "positions",
                     "rank_group"), (int(v) for v in out)))


@kernel_cost(_lora_work)
def lora_delta_paged(x: torch.Tensor, a_pool: torch.Tensor,
                     b_pool: torch.Tensor, apage: torch.Tensor,
                     ascale: torch.Tensor) -> torch.Tensor:
    """Per-row PAGED LoRA delta: `lora_delta` with each row's A/B pair
    taken from the whole pools a_pool [P, in, R] / b_pool [P, R, out] at
    page apage[b] (int32 [B]; page 0 is the all-zero base page), scaled
    by ascale[b] (f32 [B]). On the card K11 (counted in MEGA_LAUNCHES),
    the pools of x's dtype and every tensor on x's device; on the CPU
    `lora_delta_paged_reference`."""
    if x.device.type == "cpu":
        return lora_delta_paged_reference(x, a_pool, b_pool, apage, ascale)
    if x.device.type != "cuda":
        raise ValueError(f"lora_delta_paged: no kernel for device {x.device}")
    if x.dim() != 3 or a_pool.dim() != 3 or b_pool.dim() != 3:
        raise ValueError("lora_delta_paged: x [B, W, in], a_pool [P, in, R] "
                         "and b_pool [P, R, out]")
    bsz, w, cin = x.shape
    n_pages, _, r = a_pool.shape
    cout = b_pool.shape[2]
    if a_pool.shape[1] != cin or tuple(b_pool.shape[:2]) != (n_pages, r):
        raise ValueError(f"lora_delta_paged: pools {tuple(a_pool.shape)}, "
                         f"{tuple(b_pool.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if not (a_pool.dtype == b_pool.dtype == x.dtype):
        raise TypeError(f"lora_delta_paged kernel: the pools must share x's "
                        f"dtype, got {x.dtype}, {a_pool.dtype}, "
                        f"{b_pool.dtype}")
    if r < 1:
        raise ValueError(f"lora_delta_paged kernel: rank {r} must be >= 1")
    apage = apage.to(torch.int32).contiguous()
    ascale = ascale.to(torch.float32).contiguous()
    if apage.shape != (bsz,) or ascale.shape != (bsz,):
        raise ValueError("lora_delta_paged: apage and ascale must be [B]")
    devs = {t.device for t in (x, a_pool, b_pool, apage, ascale)}
    if len(devs) != 1:
        raise ValueError(f"lora_delta_paged: tensors on {devs}")
    x, a_pool, b_pool = _contiguous(x, a_pool, b_pool)
    out = torch.empty((bsz, w, cout), dtype=x.dtype, device=x.device)
    lib = _build.load("lora_paged")
    err = lib.ptt_lora_delta_paged(
        x.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(), apage.data_ptr(),
        ascale.data_ptr(), out.data_ptr(), bsz, w, cin, r, cout, n_pages,
        _build.dtype_code(x.dtype), x.device.index,
        _build.stream_ptr(x.device))
    _build.check(lib, err, "lora_delta_paged kernel launch")
    MEGA_LAUNCHES["K11"] += 1
    return out


# K12's launch: at most this many blocks a row (the portable cluster
# size), and float4 loads in flight a thread (`kLoads` in
# csrc/greedy_argmax.cu)
ARGMAX_MAX_CLUSTER = 8
ARGMAX_LOADS = 4


def _argmax_plan(b: int, v: int, sms: int) -> tuple:
    """K12's launch for logits [b, v] f32 on a card of `sms` SMs: (S, the
    blocks of one row's thread-block cluster, threads a block). S fills
    about one wave of the SMs with b x S blocks (1 where b alone fills
    the card, never more than ARGMAX_MAX_CLUSTER); the threads are the
    power of two, 32-1024, that gives each about ARGMAX_LOADS of its
    block's 16-byte vectors, at most 512 in a cluster or where rows
    outnumber the SMs: two blocks an SM then fit, and on the H100 such
    launches of 1024-thread blocks ran slower (`argmax_turns` times every
    cluster size and block size)."""
    s = max(1, min(ARGMAX_MAX_CLUSTER, sms // max(1, b)))
    per_block = -(-(v // 4) // s)
    want = -(-per_block // ARGMAX_LOADS)
    cap = 1024 if s == 1 and b <= sms else 512
    threads = 32
    while threads < want and threads < cap:
        threads *= 2
    return s, threads


def _argmax_slices(v: int, s: int, offset: int = 0) -> list:
    """The elements each of K12's S blocks reads in a row of v f32 values
    whose first element sits `offset` elements past a 16-byte boundary
    (the C kernel's partition): rank r takes the whole vectors [r nv / S,
    (r + 1) nv / S) after the scalar head that reaches the first aligned
    address; rank 0 also takes the head and the tail after the last whole
    vector. Returns, per rank, (scalar indices, [(start, stop) of each
    vector run])."""
    head = min(v, (4 - offset % 4) % 4)
    nv = (v - head) // 4
    tail0 = head + 4 * nv
    out = []
    for r in range(s):
        lo, hi = r * nv // s, (r + 1) * nv // s
        scalars = (list(range(head)) + list(range(tail0, v))) if r == 0 \
            else []
        out.append((scalars, [(head + 4 * j, head + 4 * j + 4)
                              for j in range(lo, hi)]))
    return out


@kernel_cost(_argmax_work)
def decode_greedy_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling over logits [B, V] -> int32 [B], the first-
    occurrence argmax of each row (a NaN counts as the largest value, as
    in torch.argmax and jnp.argmax). On the card K12 over the f32 logits
    (counted in MEGA_LAUNCHES), each row split over a thread-block
    cluster of `_argmax_plan`'s blocks; on the CPU its plain version,
    torch.argmax."""
    if logits.device.type == "cpu":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if logits.device.type != "cuda":
        raise ValueError(
            f"decode_greedy_argmax: no kernel for device {logits.device}")
    if logits.dim() != 2 or logits.shape[1] < 1:
        raise ValueError(f"decode_greedy_argmax: logits [B, V], got "
                         f"{tuple(logits.shape)}")
    x = logits.to(torch.float32).contiguous()
    b, v = x.shape
    out = torch.empty(b, dtype=torch.int32, device=x.device)
    s, threads = _argmax_plan(b, v, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    lib = _build.load("greedy_argmax")
    err = lib.ptt_greedy_argmax(x.data_ptr(), out.data_ptr(), b, v, s,
                                threads, x.device.index,
                                _build.stream_ptr(x.device))
    _build.check(lib, err, "decode_greedy_argmax kernel launch")
    MEGA_LAUNCHES["K12"] += 1
    return out


def spec_verify_accept(logits_v: torch.Tensor, toks: torch.Tensor,
                       q_len: torch.Tensor, is_decode: torch.Tensor
                       ) -> torch.Tensor:
    """Speculative decoding's greedy acceptance (the JAX function):
    logits_v [B, W, V] of the verify columns, toks [B, W] the packed
    draft tokens, q_len [B], is_decode [B] bool -> int32 [B], the length
    of the longest prefix of draft columns 1 .. q_len - 1 that matches
    the argmax chain (column i's argmax, by `decode_greedy_argmax`, is
    the token decoding would commit after column i); 0 for rows that do
    not decode."""
    b, w, v = logits_v.shape
    preds = decode_greedy_argmax(logits_v.reshape(b * w, v)).reshape(b, w)
    match = toks[:, 1:] == preds[:, :-1].to(toks.dtype)
    dcol = torch.arange(w - 1, device=toks.device)[None, :]
    valid = dcol < (q_len.to(torch.int64) - 1)[:, None]
    accept = torch.cumprod((match & valid).to(torch.int32), dim=1).sum(
        dim=1).to(torch.int32)
    return torch.where(is_decode, accept, torch.zeros_like(accept))


def _megakernel_lora_prologue(q, k_new, v_new, rest):
    """Add the rows' paged q/k/v LoRA deltas to the base projections (the
    JAX prologue): each delta on the flat [B, W, out] view, reshaped —
    an elementwise add commutes with the reshape, so this equals the
    unfused path that adds before the head split."""
    x, aq, bq, ak, bk, av, bv, apage, ascale = rest
    q = q + lora_delta_paged(x, aq, bq, apage, ascale).reshape(q.shape)
    k_new = k_new + lora_delta_paged(x, ak, bk, apage,
                                     ascale).reshape(k_new.shape)
    v_new = v_new + lora_delta_paged(x, av, bv, apage,
                                     ascale).reshape(v_new.shape)
    return q, k_new, v_new


def _megakernel_split(rest, grouped, lora):
    rest = list(rest)
    group = None
    if grouped:
        group, rest = rest[:3], rest[3:]
    if lora and len(rest) != 9:
        raise ValueError("megakernel_decode(lora=True) needs (x, aq, bq, ak, "
                         "bk, av, bv, apage, ascale) after the groups")
    return group, rest


def megakernel_decode(q, k_new, v_new, k_pool, v_pool, page_table, pos,
                      q_len, *rest, grouped: bool = False,
                      lora: bool = False):
    """The decode layer of the unified step over float or e4m3 pools (the
    JAX op, K13 as a composition): with `lora`, the LoRA prologue (K11
    for q, k and v; `rest` carries (x, aq, bq, ak, bk, av, bv, apage,
    ascale) after the group triple); the write of k_new/v_new
    [B, W, H_kv, D] at pos (`paged_scatter_kernel_pair`: one K8 launch
    in the pools' lane); then the ragged walk over the updated pools (K6), or with
    `grouped` the grouped walk (K10; `rest` leads with (group_id,
    group_leader, group_cnt)). The pools are written IN PLACE. Returns
    (out, k_pool, v_pool). On the CPU every stage is the unfused ops'
    plain version, so the gate changes no output."""
    group, rest = _megakernel_split(rest, grouped, lora)
    if lora:
        q, k_new, v_new = _megakernel_lora_prologue(q, k_new, v_new, rest)
    paged_scatter_kernel_pair(k_pool, v_pool, k_new, v_new, pos, page_table)
    if grouped:
        out = ragged_paged_attention_grouped(q, k_pool, v_pool, page_table,
                                             pos, q_len, *group)
    else:
        out = ragged_paged_attention(q, k_pool, v_pool, page_table, pos,
                                     q_len)
    return out, k_pool, v_pool


def megakernel_decode_q8(q, k_new, v_new, k_pool, v_pool, k_scale_pool,
                         v_scale_pool, page_table, pos, q_len, *rest,
                         grouped: bool = False, lora: bool = False):
    """The int8 lane of `megakernel_decode`: the LoRA prologue, the
    quantizing write of K and V (`paged_scatter_q8_pair`: one K8-q8
    launch, codes and rowwise scales), then K7 or K10's
    q8 lane. `rest` as there. Returns (out, k_pool, v_pool, k_scale_pool,
    v_scale_pool), the pools written IN PLACE."""
    group, rest = _megakernel_split(rest, grouped, lora)
    if lora:
        q, k_new, v_new = _megakernel_lora_prologue(q, k_new, v_new, rest)
    paged_scatter_q8_pair(k_pool, v_pool, k_scale_pool, v_scale_pool, k_new,
                          v_new, pos, page_table)
    args = (q, k_pool, v_pool, k_scale_pool, v_scale_pool, page_table, pos,
            q_len)
    if grouped:
        out = ragged_paged_attention_grouped_q8(*args, *group)
    else:
        out = ragged_paged_attention_q8(*args)
    return out, k_pool, v_pool, k_scale_pool, v_scale_pool
