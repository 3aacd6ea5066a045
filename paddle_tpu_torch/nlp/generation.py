"""Decode caches, their attend step, sampling and `CompiledGenerator`.

Counterpart of `paddle_tpu/nlp/generation.py`. A `DecodeCache` is one
attention layer's cache in one of three modes, and `update_and_attend`
writes the new K/V and attends in the mode's way:

- dense (`page_table` None): k/v [B, max_len, H_kv, D] with a scalar
  `pos` (`init_decode_caches`, the cache of `generate()`). The write is
  `kv_cache_update`; attention is the window-causal mask plus
  `F.scaled_dot_product_attention`, flash attention K3 on the card (the
  grouped `gqa_decode_attend` at one token with GQA). The dense int8
  form (`kv_scales`: calibrated per-head constants in k_scale/v_scale)
  keeps int8 codes in the same layout (the JAX package lays them out
  [B, H_kv, L, D]; the values are the same): `kv_cache_update_q8`
  quantizes the write, a single token attends through `kv8_attend`, and
  the one multi-token write allowed, the prefill at pos 0, attends over
  its own float K/V through K3. Plain torch, as the JAX package's jnp.
- paged (`page_table` set, `q_len` None): shared pools
  [num_pages, page_size, H_kv, D], a per-row `pos` [B] (a scalar is
  broadcast), the serving engine's legacy alternating step. The write
  goes to the pool (`index_copy_`; K8 into e4m3 pools, K8-q8 into int8
  pools with their f32 scale pools, K and V in one launch). A single
  token attends through paged decode attention K9 (float and e4m3
  pools) or, over int8 pools, K7 at q_len 1; a multi-token chunk, and
  every call under
  `attn_impl="gather"`, gathers the rows' pages into the dense view
  (`paged_kv_gather[_q8]`) and attends as the dense mode does.
- ragged (`q_len` set), the unified step: per-row live query counts;
  ragged paged attention K6 (K7 for int8 pools), or with prefix-sharing
  groups attached (`DecodeCache.group`) the grouped walk K10, in the
  pool's lane. Under `attn_impl="gather"` it takes the gather branch.

`attn_impl` ("kernel" | "gather", `resolve_paged_attn_impl`) chooses
between the kernel branches and the gather branch. An optional user
`attn_mask` over the cache axis composes with the window: into K9's
mask operand, into the mask lane of K6/K7 (the ragged branch and the
int8 single-token branch; the grouped walk falls back to K6/K7 under a
mask, as the JAX op does), or into the gather branch's additive mask.

Tensor-parallel serving (serving/tp.py): with `DecodeCache.shards` set
(a `ShardRoute`, built each step by `ShardedPools.caches`) the model's
paged branch runs per shard through `attend_shards`: the layer's input
goes to each shard's device, the shard's heads are projected, written
and walked over the shard's own pools with the step's operands on its
device, and the outputs are concatenated over the head axis on the lead
device before the replicated output projection.

The unified step's megakernel (`DecodeCache.megakernel`, the engine's
PADDLE_TPU_MEGAKERNEL gate): with q_len set, the kernel impl and no user
mask, the write and the walk go through `megakernel_decode[_q8]` (K8 or
K8-q8, then K6, K7 or K10) as one op, the JAX branch's composition;
with `lora_paged` set it also adds the rows' paged q/k/v LoRA deltas
from `lora_x` (K11) before the write. The unfused LoRA path
(`DecodeCache.lora`, per-row gathered pairs) is applied by the model
around `update_and_attend` (nlp/gpt.py).

PyTorch runs eagerly, so caches are updated IN PLACE: the cache that
`update_and_attend` returns shares the buffers it was given. The JAX
package's `_pack_caches`, which carried the buffers through a jitted
loop, has no counterpart.

Mixed types in the gather branch: e4m3 and int8 pages gather to f32
while q may be bf16. The JAX reference promotes inside its einsums and
returns f32 there, and so does the port: the chunk attends with q
upconverted to f32 (the logits the JAX einsum forms) and the output is
f32. Downstream the model follows jnp's promotion (nlp/gpt.py): a bf16
layer fed f32 computes in f32 with its weights upcast.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch

from ..nn.functional import scaled_dot_product_attention
from ..ops.cuda.paged_attention import (FP8_DTYPE, NEG_INF,
                                        dequantize_paged_q8,
                                        megakernel_decode,
                                        megakernel_decode_q8,
                                        paged_decode_attention,
                                        paged_scatter_pair,
                                        paged_scatter_q8_pair,
                                        ragged_paged_attention,
                                        ragged_paged_attention_grouped,
                                        ragged_paged_attention_grouped_q8,
                                        ragged_paged_attention_q8)

__all__ = ["DecodeCache", "init_decode_caches", "update_and_attend",
           "ShardRoute", "ShardedPools", "attend_shards",
           "kv_cache_update", "kv_cache_update_q8", "kv8_attend",
           "paged_kv_gather", "paged_kv_gather_q8", "generate",
           "window_causal_mask", "decode_merge_mask", "gqa_decode_attend",
           "decode_model_step", "sample_logits", "CompiledGenerator",
           "resolve_paged_attn_impl", "PAGED_ATTN_IMPLS", "_unpack_caches",
           "_top_p_filter", "_categorical"]

PAGED_ATTN_IMPLS = ("kernel", "gather")


def resolve_paged_attn_impl(override=None) -> str:
    """Which implementation the paged attend uses: "kernel" (default: K9
    for one token, K6/K7/K10 for ragged rows) or "gather" (gather the
    rows' pages into the dense view and attend through flash attention,
    the A/B cross-check path). An explicit override wins; otherwise
    PADDLE_TPU_PAGED_ATTN. Anything else raises ValueError."""
    impl = override or os.environ.get("PADDLE_TPU_PAGED_ATTN", "kernel")
    if impl not in PAGED_ATTN_IMPLS:
        raise ValueError(
            f"paged attention impl must be one of {PAGED_ATTN_IMPLS} "
            f"(PADDLE_TPU_PAGED_ATTN / attn_impl), got {impl!r}")
    return impl


@dataclass
class DecodeCache:
    """One attention layer's cache (see the module doc for the modes).
    k/v: dense buffers [B, max_len, H_kv, D] or shared pools
    [num_pages, page_size, H_kv, D]; `pos`: the positions already
    written — a Python int or 0-dim tensor (dense, or one position for
    every paged row) or an int32 [B] tensor; `page_table` [B, max_pages]
    int32 (paged modes; page 0 is the trash page: free rows point every
    entry at it and writes past a row's window land there); `q_len` [B]
    int32 (ragged mode: row b's tokens occupy positions pos[b] ..
    pos[b] + q_len[b] - 1 of a width-l padded batch). `group`, when set,
    is the (group_id, group_leader, group_cnt) triple of [B] int32
    tensors declaring which rows share a physical-page prefix (the
    grouped walk). `k_scale`/`v_scale`, when set, are the f32 rowwise
    scale pools [num_pages, page_size, H_kv] of int8 code pools (the q8
    lane: a page and its scales are one unit), or in the dense mode the
    per-head f32 constants [H_kv] of the int8 cache. `attn_impl` pins
    "kernel" or "gather" (None: `resolve_paged_attn_impl`).

    Multi-tenant LoRA (serving/adapters.py): `lora`, this layer's
    per-row gathered pairs (Aq [B, h, R], Bq [B, R, Hq*D], Ak, Bk, Av,
    Bv, Ao [B, Hq*D, R], Bo [B, R, h], scale [B]), which the attention
    module adds to its projections through `lora_delta`; or, in
    megakernel mode, `lora_paged`, the layer's whole adapter pools (Aq
    [P, h, R], ... Bo [P, R, h]) plus the rows' page ids apage [B] int32
    and scales ascale [B] f32, gathered inside the fused op (K11). A row
    at page 0 / scale 0 sees an exactly-zero delta. `megakernel` routes
    the unified step's write and walk through `megakernel_decode[_q8]`
    (see the module doc).

    Tensor-parallel serving: `shards`, a `ShardRoute`, carries each
    shard's own cache and projection runs; the model's paged branch then
    runs `attend_shards`, and this (lead) cache's k and v are None."""

    k: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    pos: Union[int, torch.Tensor]
    page_table: Optional[torch.Tensor] = None
    q_len: Optional[torch.Tensor] = None
    group: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    attn_impl: Optional[str] = None
    lora: Optional[tuple] = None
    lora_paged: Optional[tuple] = None
    megakernel: bool = False
    shards: Optional["ShardRoute"] = None


def init_decode_caches(n_layers: int, batch_size: int, max_len: int,
                       n_kv_heads: int, head_dim: int,
                       dtype: torch.dtype = torch.float32,
                       device=None, kv_scales=None) -> List[DecodeCache]:
    """Fresh zeroed dense caches, one per layer, at pos 0. With
    `kv_scales`, per layer a (k_scale [H_kv], v_scale [H_kv]) pair of
    calibrated constants, the caches hold int8 codes and carry the
    scales as f32 tensors."""
    shape = (batch_size, max_len, n_kv_heads, head_dim)
    if kv_scales is None:
        return [DecodeCache(torch.zeros(shape, dtype=dtype, device=device),
                            torch.zeros(shape, dtype=dtype, device=device),
                            0)
                for _ in range(n_layers)]
    f32 = lambda s: torch.as_tensor(s, dtype=torch.float32, device=device)
    return [DecodeCache(torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.zeros(shape, dtype=torch.int8, device=device),
                        0, k_scale=f32(kv_scales[i][0]),
                        v_scale=f32(kv_scales[i][1]))
            for i in range(n_layers)]


def _as_int(pos) -> int:
    return int(pos.item()) if torch.is_tensor(pos) else int(pos)


def kv_cache_update(buf: torch.Tensor, upd: torch.Tensor, pos
                    ) -> torch.Tensor:
    """Write upd [B, l, H, D] into the dense buffer [B, max_len, H, D]
    IN PLACE at position pos (a scalar: every row; an int32 [B] tensor:
    row b at pos[b]) and return it. As the JAX `dynamic_update_slice`
    does, a start is clamped to [0, max_len - l]."""
    b, l = upd.shape[:2]
    top = buf.shape[1] - l
    if torch.is_tensor(pos) and pos.dim() == 1:
        start = torch.clamp(pos.to(torch.int64), 0, top)
        idx = start[:, None] + torch.arange(l, device=buf.device)[None, :]
        rows = torch.arange(b, device=buf.device)[:, None]
        buf[rows, idx] = upd.to(buf.dtype)
        return buf
    p = min(max(_as_int(pos), 0), top)
    buf[:, p:p + l] = upd.to(buf.dtype)
    return buf


def kv_cache_update_q8(buf: torch.Tensor, upd: torch.Tensor, pos,
                      scale: torch.Tensor) -> torch.Tensor:
    """Quantize upd [B, l, H, D] with the per-head constant scales [H]
    (round half to even, clip to +-127) and write the codes into the
    int8 buffer [B, max_len, H, D] IN PLACE at pos, as
    `kv_cache_update` writes (the JAX `_kv_update_q8_fwd`)."""
    codes = torch.clamp(torch.round(upd.float() / scale[None, None, :, None]),
                        -127, 127).to(torch.int8)
    return kv_cache_update(buf, codes, pos)


def kv8_attend(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
               k_scale: torch.Tensor, v_scale: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Attention over the dense int8 cache (the JAX `_kv8_attend_fwd`):
    q [B, l, H, D] against codes [B, L, H_kv, D] dequantized by the
    per-head scales, query heads grouped over the kv heads; mask bool
    or additive f32 broadcastable to [B, 1, l, L]. f32 throughout, the
    output in q's dtype."""
    b, l, h, d = q.shape
    hkv = k8.shape[2]
    rep = h // hkv
    if mask.dtype == torch.bool:
        mask = torch.where(mask, torch.zeros((), device=mask.device),
                           torch.full((), NEG_INF, device=mask.device))
    qf = q.float().permute(0, 2, 1, 3).reshape(b, hkv, rep * l, d)
    kf = k8.float() * k_scale[None, None, :, None]
    s = torch.einsum("bgqd,bkgd->bgqk", qf, kf) / math.sqrt(d)
    s = s.reshape(b, h, l, -1) + mask
    a = torch.softmax(s, dim=-1).reshape(b, hkv, rep * l, -1)
    vf = v8.float() * v_scale[None, None, :, None]
    o = torch.einsum("bgqk,bkgd->bgqd", a, vf)
    return o.reshape(b, h, l, d).permute(0, 2, 1, 3).to(q.dtype)


def paged_kv_gather(pool: torch.Tensor, page_table: torch.Tensor
                    ) -> torch.Tensor:
    """Each row's pages in its dense logical view: pool
    [P, ps, H, D] + page_table [B, mp] -> [B, mp * ps, H, D] (the JAX
    `_paged_gather_fwd`). An e4m3 pool's view is upconverted to f32 (the
    gather is its dequantization); rows of the view past a row's window
    show trash, which the window mask hides."""
    b, mp = page_table.shape
    tab = page_table.to(torch.int64)
    if pool.dtype == FP8_DTYPE:
        g = pool.view(torch.uint8)[tab].view(FP8_DTYPE).float()
    else:
        g = pool[tab]
    return g.reshape(b, mp * pool.shape[1], *pool.shape[2:])


def paged_kv_gather_q8(pool: torch.Tensor, scale_pool: torch.Tensor,
                       page_table: torch.Tensor) -> torch.Tensor:
    """The dequantizing gather of an int8 code pool and its f32 scale
    pool: the dense f32 logical view [B, mp * ps, H_kv, D]."""
    return dequantize_paged_q8(pool, scale_pool, page_table)


def window_causal_mask(pos, l: int, lmax: int, device=None) -> torch.Tensor:
    """Bool mask: key j visible to query i iff j <= pos + i. A scalar
    pos gives [1, 1, l, lmax]; a per-row pos [B] gives [B, 1, l, lmax].
    The mask lies on pos's device, or on `device` for a Python int."""
    if torch.is_tensor(pos) and pos.dim() == 1:
        dev = pos.device
        i = torch.arange(l, device=dev)[:, None]
        j = torch.arange(lmax, device=dev)[None, :]
        return (j[None] <= i[None] + pos.to(torch.int64)[:, None, None]
                )[:, None]
    dev = pos.device if torch.is_tensor(pos) else device
    i = torch.arange(l, device=dev)[:, None]
    j = torch.arange(lmax, device=dev)[None, :]
    return (j <= i + _as_int(pos))[None, None]


def decode_merge_mask(window: torch.Tensor, user: torch.Tensor
                      ) -> torch.Tensor:
    """A bool window mask and a user mask (bool, or additive float, its
    last axis the cache axis) -> one additive f32 mask: 0 / -1e30 for
    the window plus the user mask's additive form."""
    add = torch.where(window, torch.zeros((), device=window.device),
                      torch.full((), NEG_INF, device=window.device))
    if user.dtype == torch.bool:
        return add + torch.where(user, torch.zeros((), device=user.device),
                                 torch.full((), NEG_INF,
                                            device=user.device))
    return add + user.float()


def gqa_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention over un-repeated K/V (the JAX
    `gqa_attend_reference`): q [B, l, H, D] against k/v
    [B, lmax, H_kv, D], mask bool or additive float broadcastable to
    [B|1, 1|H, l, lmax]. Unrolled over the rep = H / H_kv members of a
    group, each an einsum of the repeated path's shape; the logits are
    f32, the probabilities are cast to q's dtype, and the output takes
    the promoted dtype of q and v, as in the JAX function."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    ct = torch.promote_types(q.dtype, k.dtype)
    qg = q.to(ct).reshape(b, l, hkv, rep, d)
    scale = 1.0 / math.sqrt(d)
    outs = []
    for r in range(rep):
        mh = mask if mask.shape[1] == 1 else mask[:, r::rep]
        s = (torch.einsum("blgd,bmgd->bglm", qg[:, :, :, r], k.to(ct))
             * scale).float()
        if mask.dtype == torch.bool:
            s = torch.where(mh, s, torch.full((), NEG_INF, device=s.device))
        else:
            s = s + mh.float()
        a = torch.softmax(s, dim=-1).to(q.dtype)
        pt = torch.promote_types(a.dtype, v.dtype)
        outs.append(torch.einsum("bglm,bmgd->blgd", a.to(pt), v.to(pt)))
    return torch.stack(outs, dim=3).reshape(b, l, h, d)


def _row_pos(pos, b: int, device) -> torch.Tensor:
    """A paged cache's positions as an int32 [B] tensor (a scalar is
    broadcast to every row)."""
    p = pos if torch.is_tensor(pos) else torch.tensor(pos, device=device)
    p = p.to(device=device, dtype=torch.int32)
    return p.reshape(1).expand(b).contiguous() if p.dim() == 0 else p


def _user_mask(attn_mask, lmax: int, c: DecodeCache) -> torch.Tensor:
    """The user mask with the JAX package's checks, as a 4-axis tensor."""
    if attn_mask.shape[-1] != lmax:
        if c.page_table is not None:
            raise ValueError(
                f"decode attn_mask last dim {attn_mask.shape[-1]} does not "
                f"match the PAGED cache's logical view: page_table width "
                f"{c.page_table.shape[1]} pages x page_size "
                f"{c.k.shape[1]} = {lmax} slots. A mask sized for the "
                "dense max_len must be padded to the page-aligned width "
                "(padding positions are hidden by the positional window "
                "anyway)")
        raise ValueError(
            f"decode attn_mask last dim {attn_mask.shape[-1]} must equal "
            f"the cache max_len {lmax} (mask indexes cache slots)")
    m = attn_mask
    while m.dim() < 4:
        m = m.unsqueeze(0)
    return m


def update_and_attend(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, cache: DecodeCache,
                      attn_mask: Optional[torch.Tensor] = None,
                      lora_x: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, DecodeCache]:
    """Write k_new/v_new [B, l, H_kv, D] at the cache's positions (every
    column, padding included: a dead column's K/V lands past the live
    window, where it is masked until overwritten), then attend q
    [B, l, H, D] over each row's valid prefix — the branch the cache's
    mode and `attn_impl` choose (module doc). Returns (out [B, l, H, D],
    the cache with pos advanced by q_len, or by l). The output is in q's
    dtype, except on the gather branch over 1-byte pools, where it is
    f32 as in the JAX package. `lora_x`, the attention input [B, l, h],
    feeds the megakernel's LoRA prologue when `cache.lora_paged` is set
    (q/k_new/v_new then carry the base projections only)."""
    c = cache
    b, l = q.shape[:2]
    quant = c.k_scale is not None
    paged = c.page_table is not None
    impl = resolve_paged_attn_impl(c.attn_impl)
    if (paged and c.megakernel and c.q_len is not None
            and attn_mask is None and impl == "kernel"):
        pos_rows = _row_pos(c.pos, b, q.device)
        rest = list(c.group) if c.group is not None else []
        lora = c.lora_paged is not None and lora_x is not None
        if lora:
            aq, bq, ak, bk, av, bv = c.lora_paged[:6]
            rest += [lora_x, aq, bq, ak, bk, av, bv, c.lora_paged[8],
                     c.lora_paged[9]]
        opts = dict(grouped=c.group is not None, lora=lora)
        if quant:
            out = megakernel_decode_q8(q, k_new, v_new, c.k, c.v, c.k_scale,
                                       c.v_scale, c.page_table, pos_rows,
                                       c.q_len, *rest, **opts)[0]
        else:
            out = megakernel_decode(q, k_new, v_new, c.k, c.v, c.page_table,
                                    pos_rows, c.q_len, *rest, **opts)[0]
        return out, dataclasses.replace(c, pos=c.pos + c.q_len)
    if paged:
        pos_rows = _row_pos(c.pos, b, q.device)
        if quant and c.k_scale.dim() != 3:
            raise ValueError(
                "int8 paged KV pool needs rowwise scale pools "
                "[num_pages, page_size, n_kv_heads] in "
                "k_scale/v_scale, one scale per (position, kv head); "
                "got the dense cache's calibrated per-head constants "
                "— the dense int8 mode and the paged pool cannot mix "
                "(build pools via ServingEngine(kv_dtype='int8'))")
        if quant:
            paged_scatter_q8_pair(c.k, c.v, c.k_scale, c.v_scale, k_new,
                                  v_new, pos_rows, c.page_table)
        else:
            paged_scatter_pair(c.k, c.v, k_new, v_new, pos_rows,
                               c.page_table)
        lmax = c.page_table.shape[1] * c.k.shape[1]
    elif quant:
        _check_dense_q8_write(c.pos, l)
        kv_cache_update_q8(c.k, k_new, c.pos, c.k_scale)
        kv_cache_update_q8(c.v, v_new, c.pos, c.v_scale)
        lmax = c.k.shape[1]
    else:
        kv_cache_update(c.k, k_new, c.pos)
        kv_cache_update(c.v, v_new, c.pos)
        lmax = c.k.shape[1]
    user_m = None if attn_mask is None else _user_mask(attn_mask, lmax, c)
    new_cache = dataclasses.replace(
        c, pos=c.pos + (c.q_len if c.q_len is not None else l))
    if paged and impl == "kernel" and c.q_len is None and l == 1:
        if quant:
            # the q8 lane of the ragged walk at q_len 1 (K7): the same
            # window, query 0 sees keys j <= pos
            ones = torch.ones(b, dtype=torch.int32, device=q.device)
            out = ragged_paged_attention_q8(q, c.k, c.v, c.k_scale,
                                            c.v_scale, c.page_table,
                                            pos_rows, ones, mask=user_m)
        else:
            out = paged_decode_attention(q, c.k, c.v, c.page_table,
                                         pos_rows, user_m)
        return out, new_cache
    if paged and impl == "kernel" and c.q_len is not None:
        if quant:
            args = (q, c.k, c.v, c.k_scale, c.v_scale, c.page_table,
                    pos_rows, c.q_len)
            if c.group is not None:
                out = ragged_paged_attention_grouped_q8(*args, *c.group,
                                                        mask=user_m)
            else:
                out = ragged_paged_attention_q8(*args, mask=user_m)
        else:
            args = (q, c.k, c.v, c.page_table, pos_rows, c.q_len)
            if c.group is not None:
                out = ragged_paged_attention_grouped(*args, *c.group,
                                                     mask=user_m)
            else:
                out = ragged_paged_attention(*args, mask=user_m)
        return out, new_cache
    # the gather branch (paged chunks, attn_impl="gather") and the dense
    # cache: window mask (+ user mask) over the dense logical view. A
    # ragged row's dead queries get outputs the engine drops
    mask = window_causal_mask(pos_rows if paged else c.pos, l, lmax,
                              q.device)
    if user_m is not None:
        mask = decode_merge_mask(mask, user_m)
    if paged and quant:
        kf = paged_kv_gather_q8(c.k, c.k_scale, c.page_table)
        vf = paged_kv_gather_q8(c.v, c.v_scale, c.page_table)
    elif paged:
        kf = paged_kv_gather(c.k, c.page_table)
        vf = paged_kv_gather(c.v, c.page_table)
    elif quant and l == 1:
        return kv8_attend(q, c.k, c.v, c.k_scale, c.v_scale, mask), new_cache
    elif quant:
        # the prefill at pos 0 over the dense int8 cache: the cache holds
        # nothing before this chunk, so it attends over the chunk's own
        # float K/V (its first l slots) as the JAX package does
        kf, vf = k_new, v_new
        mask = mask[..., :l]
    else:
        kf, vf = c.k, c.v
    n_rep = q.shape[2] // kf.shape[2]
    if n_rep > 1 and l == 1:
        return gqa_decode_attend(q, kf, vf, mask), new_cache
    if n_rep > 1:
        kf = kf.repeat_interleave(n_rep, dim=2)
        vf = vf.repeat_interleave(n_rep, dim=2)
    # 1-byte pools gather to f32: attend in the promoted dtype and
    # return it, as the JAX einsums do
    ct = torch.promote_types(q.dtype, kf.dtype)
    out = scaled_dot_product_attention(q.to(ct), kf.to(ct), vf.to(ct),
                                       attn_mask=mask, is_causal=False,
                                       training=False)
    return out, new_cache


def _check_dense_q8_write(pos, l: int):
    """The JAX package's limits on the dense int8 cache's writes: a
    per-row pos takes single tokens only, and a multi-token write only
    lands on an empty cache (pos 0). Checked before the in-place write."""
    if torch.is_tensor(pos) and pos.dim() == 1:
        if l != 1:
            raise NotImplementedError(
                "int8 KV cache: per-row position vectors support "
                "single-token (decode) writes only; multi-token "
                "chunks need the dequantized read path — use the "
                "bf16/f32 cache (or the int8 PAGED pool, which "
                "dequantizes multi-token reads) for chunked prefill")
    elif l != 1 and _as_int(pos) != 0:
        raise NotImplementedError(
            "dense int8 KV cache: multi-token writes are only "
            "supported at pos==0 (single prefill). Chunked "
            "prefill / multi-token continuation needs the "
            "dequantized read path — use the bf16 cache or the "
            "int8 PAGED pool for that call pattern.")


def _unpack_caches(pools, pos, page_table: Optional[torch.Tensor] = None,
                   q_len: Optional[torch.Tensor] = None, group=None,
                   attn_impl: Optional[str] = None, lora=None,
                   lora_paged=None, megakernel: bool = False
                   ) -> List[DecodeCache]:
    """Per-layer (k, v, k_scale | None, v_scale | None) pools (the JAX
    engine's `_ct`) -> DecodeCache list sharing one pos, page_table and
    q_len, optionally one (group_id, group_leader, group_cnt) triple,
    and the attend implementation (a page id addresses the same page in
    every layer's pool). `lora` / `lora_paged`, one entry per layer (see
    DecodeCache), attach the layers' adapter operands; `megakernel`
    routes every layer's unified attend through the fused op."""
    if isinstance(pools, ShardedPools):
        return pools.caches(pos, page_table, q_len, group, attn_impl)
    n = len(pools)
    lora = [None] * n if lora is None else list(lora)
    lora_paged = [None] * n if lora_paged is None else list(lora_paged)
    return [DecodeCache(k, v, pos, page_table, q_len, group, ks, vs,
                        attn_impl, lo, lp, megakernel)
            for (k, v, ks, vs), lo, lp in zip(pools, lora, lora_paged)]


@dataclass
class ShardRoute:
    """One layer's tensor-parallel route (serving/tp.py). `caches[s]` is
    shard s's own cache: its pools [num_pages, page_size, H_kv / mp, D]
    (and scale pools) on its device, the step's operands sent there, and
    with adapters its rows' LoRA pairs (Aq, Bq, Ak, Bk, Av, Bv, None,
    None, scale) holding its columns of each B. `weights[s]` are its runs
    of the attention input projections, {projection name: (weight rows,
    bias)}. `counts` is the step's transfer record, shared by every layer
    (`serving.tp.new_transfer_counts`)."""

    caches: tuple
    weights: tuple
    counts: dict


def attend_shards(x: torch.Tensor, cache: DecodeCache, project
                  ) -> Tuple[torch.Tensor, DecodeCache]:
    """The paged branch over a sharded cache: for each shard, send x
    [b, l, h] to its device, take (q, k, v) of its heads from
    `project(xs, weights, shard_cache)`, write and walk its pools through
    `update_and_attend`; then concatenate the outputs over the head axis
    on x's device (the layer's one all-gather). Returns (out [b, l, H, D],
    the cache with pos advanced as `update_and_attend` advances it)."""
    route = cache.shards
    outs = []
    for c, w in zip(route.caches, route.weights):
        q, k, v = project(x.to(c.k.device), w, c)
        outs.append(update_and_attend(q, k, v, c)[0])
    route.counts["broadcast"] += 1
    route.counts["all_gather"] += 1
    out = torch.cat([o.to(x.device) for o in outs], dim=2)
    step = cache.q_len if cache.q_len is not None else x.shape[1]
    return out, dataclasses.replace(cache, pos=cache.pos + step)


def _to(t, dev):
    """A step operand on `dev` (None and Python scalars pass through)."""
    return t.to(dev) if torch.is_tensor(t) else t


class ShardedPools:
    """A tensor-parallel engine's per-layer pools and projection runs
    (serving/tp.py), in place of the (k, v, k_scale, v_scale) list:
    `pools[s][i]` is layer i's tuple of shard s, on `devices[s]`;
    `weights[s][i]` shard s's {projection name: (weight rows, bias)} of
    layer i; `adapter_cols[s][i]`, with adapters, shard s's (Aq, Bq, Ak,
    Bk, Av, Bv) of layer i (A replicated, B its columns); `counts` the
    step's transfer record."""

    def __init__(self, devices, pools, weights, counts: dict,
                 adapter_cols=None):
        self.devices = list(devices)
        self.pools = pools
        self.weights = weights
        self.counts = counts
        self.adapter_cols = adapter_cols

    def __len__(self) -> int:
        return len(self.pools[0])

    def caches(self, pos, page_table: Optional[torch.Tensor] = None,
               q_len: Optional[torch.Tensor] = None, group=None,
               attn_impl: Optional[str] = None, lora=None
               ) -> List[DecodeCache]:
        """The step's per-layer lead caches, each carrying its
        `ShardRoute`; the operands (positions, page table, query counts,
        group triple) are sent to each shard's device once for every
        layer. `lora`, (the lead's adapter pools, apage [S] int32, ascale
        [S] f32), gathers each layer's o-projection pair on the lead and
        each shard's q/k/v pairs on its device."""
        n = len(self)
        lead_lora = [None] * n
        shard_ops = []
        for s, dev in enumerate(self.devices):
            ops = [_to(pos, dev), _to(page_table, dev), _to(q_len, dev),
                   None if group is None else tuple(_to(g, dev)
                                                    for g in group)]
            lo = [None] * n
            if lora is not None:
                idx = _to(lora[1].to(torch.int64), dev)
                sc = _to(lora[2], dev)
                lo = [tuple(t[idx] for t in cols) + (None, None, sc)
                      for cols in self.adapter_cols[s]]
            shard_ops.append((ops, lo))
        if lora is not None:
            idx = lora[1].to(torch.int64)
            lead_lora = [(None,) * 6 + (layer[6][idx], layer[7][idx],
                                        lora[2])
                         for layer in lora[0]]
        out = []
        for i in range(n):
            route = ShardRoute(
                tuple(DecodeCache(k, v, ops[0], ops[1], ops[2], ops[3], ks,
                                  vs, attn_impl, lo[i])
                      for (k, v, ks, vs), (ops, lo) in zip(
                          (p[i] for p in self.pools), shard_ops)),
                tuple(w[i] for w in self.weights), self.counts)
            out.append(DecodeCache(None, None, pos, page_table, q_len,
                                   group, None, None, attn_impl,
                                   lead_lora[i], shards=route))
        return out


def decode_model_step(model, tokens: torch.Tensor, caches):
    """One decode step, shared by `CompiledGenerator`'s loop and the
    serving engine's legacy step: feed tokens [B, l] through the model
    against the caches and return (the last position's logits as f32
    [B, V], the advanced caches)."""
    logits, caches = model(tokens, caches=caches)
    return logits[:, -1, :].float(), caches


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


def _categorical(logits: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick on
    uniforms from `generator` (also the serving engine's draw)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=1e-20)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float = 1.0, top_k=None, top_p=None,
                  strategy=None) -> torch.Tensor:
    """Next-token selection over f32 logits [B, V] (the JAX function,
    with an explicit generator in place of its key). "greedy" is the
    first-occurrence argmax; otherwise the logits are divided by the
    temperature, top-k and top-p filter them (-1e30 outside), and the
    token is drawn when the strategy is "sampling" or a filter is set,
    else taken by argmax (None keeps the legacy rule)."""
    if strategy == "greedy":
        return torch.argmax(logits, dim=-1)
    if temperature != 1.0:
        logits = logits / temperature
    stochastic = (strategy == "sampling") or top_k or top_p
    if top_k:
        kth = torch.topk(logits, int(top_k), dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    if top_p:
        logits = _top_p_filter(logits, float(top_p))
    if stochastic:
        return _categorical(logits, generator)
    return torch.argmax(logits, dim=-1)


def _top_k_stable(x: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, the
    lower index first among equal values (the order of
    `jax.lax.top_k`, which `torch.topk` does not promise)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class CompiledGenerator:
    """`generate()` over a static dense cache (the JAX class of the
    same name). The JAX package traces prefill and the token loop into
    one XLA program; PyTorch runs eagerly, so here they are a Python loop
    over one dense cache of prompt_len + max_new positions per layer,
    and the name is kept for the API. Each decode step feeds one token
    per row through the model: flash attention K3 over the cache with
    the window mask as its key-vector operand (and, in GPT, K1 for every
    LayerNorm).

    decode_strategy: None (argmax, or sampling as soon as top_k/top_p is
    set), "greedy" ("greedy_search" accepted), "sampling" or
    "beam_search" (the JAX `_build_beam`: `num_beams` beams a row, the
    prefill at B * num_beams with all but beam 0 muted, finished beams
    frozen on pad, caches reordered by parent each step, and the top
    `num_return_sequences` beams a row by score / len ** length_penalty,
    best first). With `eos_token_id`, a row (or beam) that emitted it
    emits `pad_token_id` from then on, and the loop stops when every row
    has. Sampling draws from `generator` when a call passes one, else
    from the generator's own, seeded at construction.

    kv_cache_dtype="int8" decodes over the dense int8 cache: per-(layer,
    kv head) scales calibrated by one prefill of the first prompt over a
    float cache (`_calibrate_kv_scales`), measured again when the
    model's weights change."""

    def __init__(self, model, cache_spec, temperature=1.0, top_k=None,
                 eos_token_id=None, pad_token_id=0, top_p=None,
                 decode_strategy=None, num_beams=4, length_penalty=0.0,
                 num_return_sequences=1, kv_cache_dtype=None, seed=0):
        self.model = model
        self.n_layers, self.n_kv, self.head_dim = cache_spec
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_cache_dtype must be None (model dtype) or 'int8', "
                f"got {kv_cache_dtype!r}")
        self.kv_int8 = kv_cache_dtype == "int8"
        self._kv_scales = None      # per layer (k [H_kv], v [H_kv])
        self._state_key = None      # the weights the scales were taken on
        if decode_strategy == "greedy_search":  # reference spelling
            decode_strategy = "greedy"
        if decode_strategy not in (None, "greedy", "sampling",
                                   "beam_search"):
            raise ValueError(
                f"unknown decode_strategy {decode_strategy!r}; expected "
                "'greedy'/'greedy_search', 'sampling' or 'beam_search'")
        self.decode_strategy = decode_strategy
        self.num_beams = int(num_beams)
        self.length_penalty = float(length_penalty)
        self.num_return_sequences = int(num_return_sequences)
        if decode_strategy == "beam_search" and \
                self.num_return_sequences > self.num_beams:
            raise ValueError(
                f"num_return_sequences {self.num_return_sequences} > "
                f"num_beams {self.num_beams}")
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.eos_token_id = eos_token_id
        self.pad_token_id = int(pad_token_id)
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(int(seed))

    def _sample(self, logits, generator):
        return sample_logits(logits, generator, self.temperature,
                             self.top_k, self.top_p, self.decode_strategy)

    def _caches(self, batch: int, max_len: int) -> List[DecodeCache]:
        model = self.model
        return init_decode_caches(
            self.n_layers, batch, max_len, self.n_kv, self.head_dim,
            dtype=model.dtype, device=model.device,
            kv_scales=self._kv_scales if self.kv_int8 else None)

    def _weights_key(self) -> tuple:
        """What identifies the model's weights: each parameter's and
        buffer's storage and in-place version."""
        return tuple((t.data_ptr(), t._version) for t in
                     [*self.model.parameters(), *self.model.buffers()])

    @torch.no_grad()
    def _calibrate_kv_scales(self, ids: torch.Tensor) -> list:
        """One prefill of `ids` over a float cache of the model's dtype
        measures each (layer, kv head)'s K and V absmax; the scale is
        max(absmax * 1.27, 1e-6) / 127 (headroom for later tokens), the
        JAX package's rule."""
        model = self.model
        caches = init_decode_caches(self.n_layers, ids.shape[0],
                                    ids.shape[1], self.n_kv, self.head_dim,
                                    dtype=model.dtype, device=model.device)
        model(ids, caches=caches)           # the caches fill in place
        scale = lambda t: torch.clamp(
            t.float().abs().amax(dim=(0, 1, 3)) * 1.27, min=1e-6) / 127.0
        return [(scale(c.k), scale(c.v)) for c in caches]

    @torch.no_grad()
    def __call__(self, input_ids, max_new_tokens: int = 16,
                 return_scores: bool = False,
                 generator: Optional[torch.Generator] = None):
        """input_ids [B, L] -> [B * n, L + max_new_tokens]: the prompt
        and the new tokens (n = num_return_sequences: rows that sample
        independently, or a row's best beams, best first). With
        `return_scores` (beam search only), also the [B * n] scores."""
        beam = self.decode_strategy == "beam_search"
        if return_scores and not beam:
            raise ValueError("return_scores is only available with "
                             "decode_strategy='beam_search'")
        model = self.model
        ids = torch.as_tensor(input_ids, device=model.device)
        if ids.dim() == 1:
            ids = ids[None]
        ids = ids.to(torch.int64)
        nret = self.num_return_sequences
        if nret > 1 and not beam:
            if self.decode_strategy == "greedy" or not (
                    self.decode_strategy == "sampling" or self.top_k
                    or self.top_p):
                raise ValueError(
                    "num_return_sequences > 1 needs a stochastic "
                    "strategy (sampling/top_k/top_p) or beam_search")
            ids = ids.repeat_interleave(nret, dim=0)
        gen = self.generator if generator is None else generator
        was_training = model.training
        model.eval()
        try:
            key = self._weights_key()
            if key != self._state_key:
                self._state_key, self._kv_scales = key, None
            if self.kv_int8 and self._kv_scales is None:
                self._kv_scales = self._calibrate_kv_scales(ids)
            if beam:
                new, scores = self._beam(ids, int(max_new_tokens))
            else:
                new = self._decode(ids, int(max_new_tokens), gen)
        finally:
            model.train(was_training)
        if beam and nret > 1:
            # rows are [b0 seq0..seq(n-1), b1 ...]: repeat each prompt
            ids = ids.repeat_interleave(nret, dim=0)
        out = torch.cat([ids, new], dim=1)
        return (out, scores) if return_scores else out

    def _decode(self, ids: torch.Tensor, max_new: int,
                gen: torch.Generator) -> torch.Tensor:
        """Greedy or sampled decoding: the [B, max_new] new tokens."""
        batch, prompt_len = ids.shape
        eos, pad = self.eos_token_id, self.pad_token_id
        caches = self._caches(batch, prompt_len + max_new)
        last, caches = decode_model_step(self.model, ids, caches)
        out = torch.full((batch, max_new), pad, dtype=ids.dtype,
                         device=ids.device)
        done = torch.zeros(batch, dtype=torch.bool, device=ids.device)
        for i in range(max_new):
            nxt = self._sample(last, gen).to(ids.dtype)
            if eos is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
                done = done | (nxt == eos)
            out[:, i] = nxt
            if i + 1 == max_new or (eos is not None and bool(done.all())):
                break       # the next logits would go unused
            last, caches = decode_model_step(self.model, nxt[:, None],
                                             caches)
        return out

    def _beam(self, ids: torch.Tensor, max_new: int):
        """Beam search (the JAX `_build_beam`): the [B * n, max_new] new
        tokens of each row's n best beams and their [B * n] scores."""
        model = self.model
        batch, prompt_len = ids.shape
        k = self.num_beams
        eos, pad = self.eos_token_id, self.pad_token_id
        dev = ids.device
        caches = self._caches(batch * k, prompt_len + max_new)
        last, caches = decode_model_step(
            model, ids.repeat_interleave(k, dim=0), caches)
        vocab = last.shape[-1]
        # beam 0 live, beams 1..k-1 muted so that step 1 spreads over the
        # top k tokens of the (identical) distributions
        scores = torch.full((batch, k), -1e30, dtype=torch.float32,
                            device=dev)
        scores[:, 0] = 0.0
        tokens = torch.full((batch, k, max_new), pad, dtype=ids.dtype,
                            device=dev)
        done = torch.zeros((batch, k), dtype=torch.bool, device=dev)
        lens = torch.zeros((batch, k), dtype=torch.int32, device=dev)
        # a finished beam's row: pad at log-probability 0, the rest
        # impossible
        pad_row = torch.full((vocab,), -math.inf, dtype=torch.float32,
                             device=dev)
        if 0 <= pad < vocab:
            pad_row[pad] = 0.0
        first_row = (torch.arange(batch, device=dev) * k)[:, None]
        for i in range(max_new):
            logp = torch.log_softmax(last.reshape(batch, k, vocab), dim=-1)
            logp = torch.where(done[:, :, None], pad_row, logp)
            total = scores[:, :, None] + logp
            scores, top = _top_k_stable(total.reshape(batch, k * vocab), k)
            parent = top // vocab
            tok = (top % vocab).to(tokens.dtype)
            tokens = tokens.gather(1, parent[:, :, None].expand(-1, -1,
                                                                max_new))
            tokens[:, :, i] = tok
            done = done.gather(1, parent)
            lens = lens.gather(1, parent) + (~done).to(torch.int32)
            if eos is not None:
                done = done | (tok == eos)
            if i + 1 == max_new or (eos is not None and bool(done.all())):
                break       # the next logits would go unused
            # reorder every layer's cache by parent (the int8 scales are
            # per head and stay)
            flat = (first_row + parent).reshape(-1)
            caches = [dataclasses.replace(c, k=c.k.index_select(0, flat),
                                          v=c.v.index_select(0, flat))
                      for c in caches]
            last, caches = decode_model_step(
                model, tok.reshape(batch * k, 1), caches)
        norm = scores / torch.clamp(lens.float(), min=1.0) \
            ** self.length_penalty
        nret = self.num_return_sequences
        best_scores, best = _top_k_stable(norm, nret)
        out = tokens.gather(1, best[:, :, None].expand(-1, -1, max_new))
        return (out.reshape(batch * nret, max_new),
                best_scores.reshape(batch * nret))


def generate(model, input_ids, max_new_tokens: int = 16,
             temperature: float = 1.0, top_k=None, top_p=None,
             eos_token_id=None, pad_token_id: int = 0,
             decode_strategy=None, num_beams: int = 4,
             length_penalty: float = 0.0, num_return_sequences: int = 1,
             use_compiled: bool = True, kv_cache_dtype=None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The `generate()` of the port's causal LMs (GPT's JAX method's
    arguments and errors): autoregressive decoding over a static dense
    KV cache (`CompiledGenerator`), input_ids [B, L] -> [B * n, L +
    max_new_tokens]. use_compiled=False, the JAX package's eager debug
    loop, runs the same loop here with that loop's argument checks and
    its rule for eos: it never stops early and never pads, every row
    decodes max_new_tokens tokens. Sampling draws from `generator` when
    given, else from the model's own (`model.generator`)."""
    if decode_strategy == "greedy_search":   # reference spelling
        decode_strategy = "greedy"
    if not use_compiled and (decode_strategy not in (None, "greedy")
                             or int(num_return_sequences) != 1
                             or top_p is not None):
        raise NotImplementedError(
            "the eager debug loop supports greedy/top-k decoding "
            "only; beam_search/sampling/top_p/num_return_sequences "
            "need the compiled path (use_compiled=True)")
    gen = CompiledGenerator(
        model, model._decode_cache_spec(), temperature=temperature,
        top_k=top_k, top_p=top_p,
        eos_token_id=eos_token_id if use_compiled else None,
        pad_token_id=pad_token_id, decode_strategy=decode_strategy,
        num_beams=num_beams, length_penalty=length_penalty,
        num_return_sequences=num_return_sequences,
        kv_cache_dtype=kv_cache_dtype)
    return gen(input_ids, max_new_tokens,
               generator=model.generator if generator is None
               else generator)
