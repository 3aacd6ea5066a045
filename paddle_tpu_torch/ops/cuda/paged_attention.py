"""K6 and K10: ragged paged attention and its grouped two-phase walk —
CUDA kernels, plain versions, wrappers — plus the paged KV write they
read from and the host model of their page reads.

Counterpart of `paddle_tpu/ops/pallas/paged_attention.py`:
`ragged_paged_attention` (public, :1069) and its TPU kernel
`_ragged_kernel` (:375, fp lane, launched from
`_ragged_attention_kernel`), whose kernel here is
`csrc/ragged_paged_attention.cu`; `ragged_paged_attention_grouped`
(:1147) and its two TPU kernels `_grouped_phase1_kernel` (:562) and
`_grouped_phase2_kernel` (:663), launched from
`_grouped_attention_kernel`, whose kernels here are
`csrc/grouped_paged_attention.cu`; `count_page_block_reads` (:1621).

Semantics (shared by the kernel and `ragged_attention_reference`):
q [B, lq, H, D]; pools [P, ps, H_kv, D]; page_table [B, mp] int32;
pos, q_len [B] int32. Query i of row b sits at position pos[b] + i and
attends keys j <= pos[b] + i, read through page_table[b, j // ps]; a
query at i >= q_len[b] is dead and its output is only finite.
rep = H / H_kv query heads share one K/V stream. Masked keys get
probability exactly 0, so stale slots in a page are harmless as long as
they are finite — the serving engine zero-initialises its pools.

The grouped op computes the same output. Rows whose page tables share a
physical-page prefix declare it: `group_id` [B] (row -> group),
`group_leader` [B] (group -> a member whose table holds the span) and
`group_cnt` [B] (group -> shared page count, 0 for a singleton). Phase 1
(K10a) folds each group's shared pages, read once through the leader's
table, into the online-softmax partials (m, l, acc) of every member row;
phase 2 (K10b) continues each row from its partials over its private
tail. Both walk a row's pages in K6's order with K6's arithmetic, so on
the card K10's output equals K6's bit for bit.

The KV write is `paged_scatter`: XLA's scatter in the JAX package
(`paged_scatter` :1251, address map `_paged_flat_slots` :1232), here an
in-place `index_copy_` on the flattened pool.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_attention_reference",
           "ragged_paged_attention_grouped", "grouped_attention_reference",
           "grouped_phase1", "grouped_phase2",
           "count_page_block_reads", "paged_scatter", "_paged_flat_slots",
           "LAUNCHES", "GROUPED_LAUNCHES", "reset_launches", "NEG_INF"]

LAUNCHES = 0                                   # K6
GROUPED_LAUNCHES = {"phase1": 0, "phase2": 0}  # K10a, K10b
NEG_INF = -1e30    # the masked score, as in the TPU kernel
QBLK = 8           # queries per kernel block (the partials' row blocks)


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0
    for phase in GROUPED_LAUNCHES:
        GROUPED_LAUNCHES[phase] = 0


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


def paged_scatter(pool: torch.Tensor, upd: torch.Tensor, pos: torch.Tensor,
                  page_table: torch.Tensor) -> torch.Tensor:
    """Write upd [B, l, H, D] into pool [P, ps, H, D] IN PLACE at the
    slots `_paged_flat_slots` gives, and return the pool. Several writes
    may land on one trash slot; which of them stays there is
    unspecified (trash keys are always masked)."""
    ps, l = pool.shape[1], upd.shape[1]
    flat = _paged_flat_slots(ps, pos, page_table, l).reshape(-1)
    pool.view(-1, *pool.shape[2:]).index_copy_(
        0, flat, upd.reshape(-1, *upd.shape[2:]).to(pool.dtype))
    return pool


def ragged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_table: torch.Tensor, pos: torch.Tensor,
                               q_len: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather every row's pages into the dense
    logical view and run a grouped softmax in f32 under the ragged
    causal window (the JAX package's `ragged_attention_reference` →
    `_ragged_mask_attend` → `gqa_attend_reference`)."""
    b, lq, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    mp = page_table.shape[1]
    lmax = mp * ps
    rep = h // hkv
    tab = page_table.to(torch.int64)
    kf = k_pool[tab].reshape(b, lmax, hkv, d).float()
    vf = v_pool[tab].reshape(b, lmax, hkv, d).float()
    i = torch.arange(lq, device=q.device)[None, :, None]
    j = torch.arange(lmax, device=q.device)[None, None, :]
    live = (i < q_len.to(torch.int64)[:, None, None]) & \
        (j <= pos.to(torch.int64)[:, None, None] + i)        # [B, lq, lmax]
    qg = q.float().reshape(b, lq, hkv, rep, d)
    s = torch.einsum("blgrd,bmgd->bgrlm", qg, kf) * (1.0 / math.sqrt(d))
    s = torch.where(live[:, None, None], s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrlm,bmgd->blgrd", a, vf)
    return out.reshape(b, lq, h, d).to(q.dtype)


def _check(q, k_pool, v_pool, page_table, pos, q_len):
    b, lq, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("ragged_paged_attention: k/v pools must both be "
                         f"[P, ps, H_kv, D], got {tuple(k_pool.shape)} "
                         f"and {tuple(v_pool.shape)}")
    _, ps, hkv, dk = k_pool.shape
    if dk != d or h % hkv:
        raise ValueError(f"ragged_paged_attention: q heads {h} x dim {d} "
                         f"do not fit pools of {hkv} heads x dim {dk}")
    if page_table.shape[0] != b or pos.shape != (b,) or q_len.shape != (b,):
        raise ValueError("ragged_paged_attention: page_table [B, mp], pos "
                         "and q_len [B] must match q's batch")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError("ragged_paged_attention kernel: q and the pools "
                        f"must share a dtype, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    for name, t in (("page_table", page_table), ("pos", pos),
                    ("q_len", q_len)):
        if t.dtype != torch.int32:
            raise TypeError(f"ragged_paged_attention: {name} must be "
                            f"int32, got {t.dtype}")
    devs = {t.device for t in (q, k_pool, v_pool, page_table, pos, q_len)}
    if len(devs) != 1:
        raise ValueError(f"ragged_paged_attention: tensors on {devs}")
    vec = 16 // q.element_size()
    if d % vec or d > 256 or ps > 128:
        raise ValueError(f"ragged_paged_attention kernel: head dim {d} "
                         f"must be a multiple of {vec} and <= 256, page "
                         f"size {ps} <= 128")


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           pos: torch.Tensor, q_len: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Ragged paged attention (see the module doc). The optional
    additive user mask of the JAX op is not ported: the serving engine
    never passes one, and a mask raises here."""
    if mask is not None:
        raise NotImplementedError(
            "ragged_paged_attention: the user attention mask is not ported "
            "(ROADMAP.md, queue 2, K6)")
    if q.device.type == "cpu":
        return ragged_attention_reference(q, k_pool, v_pool, page_table,
                                          pos, q_len)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: no kernel for device {q.device}")
    global LAUNCHES
    _check(q, k_pool, v_pool, page_table, pos, q_len)
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    page_table = page_table.contiguous()
    pos, q_len = pos.contiguous(), q_len.contiguous()
    b, lq, h, d = q.shape
    n_pages, ps, hkv, _ = k_pool.shape
    out = torch.empty_like(q)
    lib = _build.load("ragged_paged_attention")
    err = lib.ptt_ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), pos.data_ptr(), q_len.data_ptr(),
        out.data_ptr(), b, lq, h, hkv, d, ps, page_table.shape[1], n_pages,
        _build.dtype_code(q.dtype), q.device.index,
        _build.stream_ptr(q.device))
    _build.check(lib, err, "ragged_paged_attention kernel launch")
    LAUNCHES += 1
    return out


# -- K10: the grouped walk ----------------------------------------------------
def count_page_block_reads(page_table, pos, q_len, group_id=None,
                           group_cnt=None, *, page_size):
    """Host-side (numpy) model of the page-block reads of ONE
    (kv head, layer) walk: the number the serving metrics report. Per
    live row (q_len > 0) the per-row walk reads its pages
    0 .. (pos + q_len - 1) // page_size; the grouped walk reads each
    group's shared span once plus each member's private tail. Returns
    (flat_reads, grouped_reads, group_sizes), group_sizes listing the
    member count of every group that shares (>= 2 live members); without
    group operands grouped_reads == flat_reads. (The JAX function's
    `n_kv`/`mp`/`fused=` arguments belong to tensor parallelism and the
    megakernel, which are not ported.)"""
    pos = np.asarray(pos, np.int64)
    q_len = np.asarray(q_len, np.int64)
    ps = int(page_size)
    live = q_len > 0
    row_pages = np.where(live, (pos + np.maximum(q_len, 1) - 1) // ps + 1,
                         0)
    flat = int(row_pages.sum())
    if group_id is None or group_cnt is None:
        return flat, flat, []
    group_id = np.asarray(group_id, np.int64)
    group_cnt = np.asarray(group_cnt, np.int64)
    grouped = 0
    sizes = []
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
    return flat, grouped, sizes


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
                                return_partials: bool = False):
    """Plain PyTorch version of K10: the two-phase online softmax in f32,
    one page at a time, with the kernels' blocking (queries in blocks of
    QBLK; a block reads pages through its last live query's position).

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
        kk = k_pool[page_ids].float()                      # [B, ps, hkv, d]
        vv = v_pool[page_ids].float()
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
    pages read once per group. Operand contract (the serving engine's
    `shared_prefix_groups` keeps it): rows of one group carry identical
    page-table entries for indices [0, group_cnt), and those pages hold
    committed KV at or below every member's pos. On the card both phases
    launch on every call (`grouped_phase1`, `grouped_phase2`), each
    counted in GROUPED_LAUNCHES. A user mask raises, as K6's wrapper
    does."""
    if mask is not None:
        raise NotImplementedError(
            "ragged_paged_attention_grouped: the user attention mask is "
            "not ported (ROADMAP.md, queue 2, K6)")
    b = q.shape[0]
    ops = (q, k_pool, v_pool, page_table, *_grouped_operands(
        b, pos, q_len, group_id, group_leader, group_cnt))
    if q.device.type == "cpu":
        return grouped_attention_reference(*ops)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention_grouped: no kernel for device "
            f"{q.device}")
    ops = _grouped_check(*ops)
    return grouped_phase2(*ops, grouped_phase1(*ops))


def _grouped_check(q, k_pool, v_pool, page_table, pos, q_len, group_id,
                   group_leader, group_cnt):
    _check(q, k_pool, v_pool, page_table, pos, q_len)
    b = q.shape[0]
    for name, t in (("group_id", group_id), ("group_leader", group_leader),
                    ("group_cnt", group_cnt)):
        if t.shape != (b,) or t.dtype != torch.int32 or \
                t.device != q.device:
            raise ValueError(f"ragged_paged_attention_grouped: {name} must "
                             f"be int32 [B] on {q.device}")
    return tuple(t.contiguous() for t in (
        q, k_pool, v_pool, page_table, pos, q_len, group_id, group_leader,
        group_cnt))


def _geometry(q, k_pool, page_table):
    b, lq, h, d = q.shape
    n_pages, ps, hkv, _ = k_pool.shape
    return (b, lq, h, hkv, d, ps, page_table.shape[1], n_pages,
            _build.dtype_code(q.dtype), q.device.index,
            _build.stream_ptr(q.device))


def grouped_phase1(q, k_pool, v_pool, page_table, pos, q_len, group_id,
                   group_leader, group_cnt):
    """K10a alone, on checked contiguous CUDA operands: launch phase 1
    and return the partials (m, l, acc), f32 [H_kv, nqb, B*QBLK*rep]
    (acc with a last axis D), allocated here with torch.empty; only the
    rows phase 1 folds are written."""
    b, lq, h, d = q.shape
    hkv = k_pool.shape[2]
    qblk = min(lq, QBLK)
    nrows = b * qblk * (h // hkv)
    m = torch.empty((hkv, -(-lq // qblk), nrows), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((*m.shape, d), dtype=torch.float32, device=q.device)
    lib = _build.load("grouped_paged_attention")
    err = lib.ptt_grouped_phase1(
        *(t.data_ptr() for t in (q, k_pool, v_pool, page_table, pos, q_len,
                                 group_id, group_leader, group_cnt, m, l,
                                 acc)),
        *_geometry(q, k_pool, page_table))
    _build.check(lib, err, "grouped paged attention phase 1 launch")
    GROUPED_LAUNCHES["phase1"] += 1
    return m, l, acc


def grouped_phase2(q, k_pool, v_pool, page_table, pos, q_len, group_id,
                   group_leader, group_cnt, partials):
    """K10b alone: launch phase 2 from phase 1's `partials` and return
    the output [B, lq, H, D]."""
    out = torch.empty_like(q)
    lib = _build.load("grouped_paged_attention")
    err = lib.ptt_grouped_phase2(
        *(t.data_ptr() for t in (q, k_pool, v_pool, page_table, pos, q_len,
                                 group_id, group_cnt, *partials, out)),
        *_geometry(q, k_pool, page_table))
    _build.check(lib, err, "grouped paged attention phase 2 launch")
    GROUPED_LAUNCHES["phase2"] += 1
    return out
