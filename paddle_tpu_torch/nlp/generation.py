"""Paged decode cache and its attend step.

Counterpart of `paddle_tpu/nlp/generation.py`, cut to the serving
engine's unified ragged branch: `DecodeCache` in paged ragged mode, the
branch of `update_and_attend` that scatters the new K/V into the shared
pool and attends through ragged paged attention (K6),
`_unpack_caches`, and `_top_p_filter`. With prefix-sharing groups
attached (`DecodeCache.group`, the serving engine's grouped walk) the
attend goes through the grouped op (K10) instead of K6. The dense
caches, the int8/fp8 lanes, LoRA and the megakernel are not ported yet
(ROADMAP.md, queue 1).

PyTorch runs eagerly, so the pools are updated IN PLACE: a
`DecodeCache` holds the engine's pools, and the cache that
`update_and_attend` returns shares them. The JAX package's
`_pack_caches`, which handed the updated pools back out of a jitted
step, has no counterpart: the engine keeps its (k, v) pairs and they
are already up to date.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..ops.cuda.paged_attention import (paged_scatter,
                                        ragged_paged_attention,
                                        ragged_paged_attention_grouped)

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
    the same output."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    page_table: torch.Tensor
    q_len: torch.Tensor
    group: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def update_and_attend(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, cache: DecodeCache
                      ) -> Tuple[torch.Tensor, DecodeCache]:
    """Write k_new/v_new [B, l, H_kv, D] at pos[b] + t (every column,
    padding included: a dead column's K/V lands past pos + q_len, where
    it is masked until overwritten), then attend q [B, l, H, D] through
    ragged paged attention — the grouped walk (K10) when the cache
    carries groups, K6 otherwise. Returns (out [B, l, H, D], the cache
    with pos advanced by q_len)."""
    paged_scatter(cache.k, k_new, cache.pos, cache.page_table)
    paged_scatter(cache.v, v_new, cache.pos, cache.page_table)
    if cache.group is not None:
        out = ragged_paged_attention_grouped(
            q, cache.k, cache.v, cache.page_table, cache.pos, cache.q_len,
            *cache.group)
    else:
        out = ragged_paged_attention(q, cache.k, cache.v, cache.page_table,
                                     cache.pos, cache.q_len)
    return out, DecodeCache(cache.k, cache.v, cache.pos + cache.q_len,
                            cache.page_table, cache.q_len, cache.group)


def _unpack_caches(pools, pos: torch.Tensor, page_table: torch.Tensor,
                   q_len: torch.Tensor, group=None) -> List[DecodeCache]:
    """Per-layer (k, v) pool pairs -> DecodeCache list sharing one
    pos/page_table/q_len and, optionally, one (group_id, group_leader,
    group_cnt) triple (a page id addresses the same page in every
    layer's pool)."""
    return [DecodeCache(k, v, pos, page_table, q_len, group)
            for k, v in pools]


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
