"""Paged decode cache and its attend step.

Counterpart of `paddle_tpu/nlp/generation.py`, cut to the serving
engine's unified ragged branch: `DecodeCache` in paged ragged mode, the
branch of `update_and_attend` that scatters the new K/V into the shared
pool and attends through ragged paged attention (K6), its paged int8
branch (quantize-then-scatter through K8-q8, attend through K7),
`_unpack_caches`, and `_top_p_filter`. With prefix-sharing groups
attached (`DecodeCache.group`, the serving engine's grouped walk) the
attend goes through the grouped op (K10) instead, in the same lane. An
e4m3 pool (the fp8 lane) takes the fp branch: its write is K8 and its
walks are K6's and K10's fp8 lanes, all chosen by the pool's dtype. The
dense caches, LoRA and the megakernel are not ported yet (ROADMAP.md,
queue 1).

PyTorch runs eagerly, so the pools are updated IN PLACE: a
`DecodeCache` holds the engine's pools, and the cache that
`update_and_attend` returns shares them. The JAX package's
`_pack_caches`, which handed the updated pools back out of a jitted
step, has no counterpart: the engine keeps its per-layer pools and they
are already up to date.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..ops.cuda.paged_attention import (paged_scatter, paged_scatter_q8,
                                        ragged_paged_attention,
                                        ragged_paged_attention_grouped,
                                        ragged_paged_attention_grouped_q8,
                                        ragged_paged_attention_q8)

__all__ = ["DecodeCache", "update_and_attend", "_unpack_caches",
           "_top_p_filter"]


@dataclass
class DecodeCache:
    """One attention layer's paged ragged cache: shared pools k/v
    [num_pages, page_size, H_kv, D], per-row write position `pos` [B]
    int32, page table [B, max_pages] int32 and live query count `q_len`
    [B] int32 — row b's tokens occupy positions pos[b] ..
    pos[b] + q_len[b] - 1 of a width-l padded batch. Page 0 is the
    trash page: free rows point every entry at it and writes past a
    row's window land there. `group`, when set, is the
    (group_id, group_leader, group_cnt) triple of [B] int32 tensors
    declaring which rows share a physical-page prefix (the JAX
    `DecodeCache.group`): the attend then takes the grouped walk, with
    the same output. `k_scale`/`v_scale`, when set, are the f32 rowwise
    scale pools [num_pages, page_size, H_kv] of int8 code pools k/v (the
    q8 lane): a page and its scales are one unit."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    page_table: torch.Tensor
    q_len: torch.Tensor
    group: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def update_and_attend(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, cache: DecodeCache
                      ) -> Tuple[torch.Tensor, DecodeCache]:
    """Write k_new/v_new [B, l, H_kv, D] at pos[b] + t (every column,
    padding included: a dead column's K/V lands past pos + q_len, where
    it is masked until overwritten), then attend q [B, l, H, D] through
    ragged paged attention — the grouped walk (K10) when the cache
    carries groups, K6 otherwise. Over int8 pools (the cache carries
    scale pools) the write quantizes (K8-q8) and the attend takes the q8
    ops (K7, K10's q8 lane), as the JAX branch at generation.py:544-563
    and :649-653 does. Returns (out [B, l, H, D], the cache with pos
    advanced by q_len)."""
    c = cache
    if c.k_scale is not None:
        paged_scatter_q8(c.k, c.k_scale, k_new, c.pos, c.page_table)
        paged_scatter_q8(c.v, c.v_scale, v_new, c.pos, c.page_table)
        args = (q, c.k, c.v, c.k_scale, c.v_scale, c.page_table, c.pos,
                c.q_len)
        if c.group is not None:
            out = ragged_paged_attention_grouped_q8(*args, *c.group)
        else:
            out = ragged_paged_attention_q8(*args)
    else:
        paged_scatter(c.k, k_new, c.pos, c.page_table)
        paged_scatter(c.v, v_new, c.pos, c.page_table)
        args = (q, c.k, c.v, c.page_table, c.pos, c.q_len)
        if c.group is not None:
            out = ragged_paged_attention_grouped(*args, *c.group)
        else:
            out = ragged_paged_attention(*args)
    return out, DecodeCache(c.k, c.v, c.pos + c.q_len, c.page_table,
                            c.q_len, c.group, c.k_scale, c.v_scale)


def _unpack_caches(pools, pos: torch.Tensor, page_table: torch.Tensor,
                   q_len: torch.Tensor, group=None) -> List[DecodeCache]:
    """Per-layer (k, v, k_scale | None, v_scale | None) pools (the JAX
    engine's `_ct`) -> DecodeCache list sharing one pos/page_table/q_len
    and, optionally, one (group_id, group_leader, group_cnt) triple (a
    page id addresses the same page in every layer's pool)."""
    return [DecodeCache(k, v, pos, page_table, q_len, group, ks, vs)
            for k, v, ks, vs in pools]


def _top_p_filter(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted vocab
    whose probability mass reaches p (a float or a [B, 1] tensor); mask
    the rest to -1e30. The first token is always kept."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    inf = torch.tensor(float("inf"), device=logits.device,
                       dtype=logits.dtype)
    thresh = torch.where(keep, sorted_desc, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh,
                       torch.full_like(logits, -1e30), logits)
