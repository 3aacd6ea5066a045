"""K6: ragged paged attention — CUDA kernel, plain version, wrapper —
plus the paged KV write it reads from.

Counterpart of `paddle_tpu/ops/pallas/paged_attention.py`:
`ragged_paged_attention` (public, :1069) and its TPU kernel
`_ragged_kernel` (:375, fp lane, launched from
`_ragged_attention_kernel`). The kernel is
`csrc/ragged_paged_attention.cu`.

Semantics (shared by the kernel and `ragged_attention_reference`):
q [B, lq, H, D]; pools [P, ps, H_kv, D]; page_table [B, mp] int32;
pos, q_len [B] int32. Query i of row b sits at position pos[b] + i and
attends keys j <= pos[b] + i, read through page_table[b, j // ps]; a
query at i >= q_len[b] is dead and its output is only finite.
rep = H / H_kv query heads share one K/V stream. Masked keys get
probability exactly 0, so stale slots in a page are harmless as long as
they are finite — the serving engine zero-initialises its pools.

The KV write is `paged_scatter`: XLA's scatter in the JAX package
(`paged_scatter` :1251, address map `_paged_flat_slots` :1232), here an
in-place `index_copy_` on the flattened pool.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

__all__ = ["ragged_paged_attention", "ragged_attention_reference",
           "paged_scatter", "_paged_flat_slots", "LAUNCHES",
           "reset_launches", "NEG_INF"]

LAUNCHES = 0
NEG_INF = -1e30    # the masked score, as in the TPU kernel


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


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
