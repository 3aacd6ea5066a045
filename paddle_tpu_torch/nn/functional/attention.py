"""Scaled dot-product attention (counterpart of
`paddle_tpu/nn/functional/attention.py`: `scaled_dot_product_attention`,
`_sdpa_impl`, `_sdpa_ref` and `_mask_to_kernel_operands`).

Inputs are [batch, seq, heads, head_dim] (paddle's layout). The route
mirrors `_sdpa_impl`: everything goes to the flash attention op
(`ops.cuda.flash_attention.flash_attention_blhd`, K3-K5 on the card,
their plain versions on the CPU) — padding masks and additive biases as
its kvec/bias operands, dropout as its position hash seeded from an
int32[2] drawn from `generator` — except a trainable mask, which takes
the plain `_sdpa_ref` (the kernels give no bias gradient). Unlike the
TPU kernel's block-padded bias, the kernels here broadcast a per-head
key mask [*, H, 1, Lk] over the queries, so it rides the bias operand.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...ops.cuda.flash_attention import flash_attention_blhd

__all__ = ["scaled_dot_product_attention"]

_NEG = -1e30


def _sdpa_ref(q, k, v, mask, causal, scale, dropout_p, generator):
    """Plain attention in [B, L, H, D], f32 softmax; dropout from
    `generator` (the JAX reference draws it with jax.random instead)."""
    logits = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
    logits = logits.float()
    if causal:
        lq, lk = logits.shape[-2], logits.shape[-1]
        cm = torch.tril(torch.ones(lq, lk, dtype=torch.bool,
                                   device=q.device), lk - lq)
        logits = logits.masked_fill(~cm, _NEG)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, _NEG)
        else:
            logits = logits + mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = 1.0 - dropout_p
        m = torch.empty(probs.shape, device=probs.device).bernoulli_(
            keep, generator=generator).bool()
        probs = torch.where(m, probs / keep, torch.zeros_like(probs))
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


def _mask_to_kernel_operands(mask, b, h, lq, lk):
    """Map an attn_mask that broadcasts to [B, H, Lq, Lk] onto the
    kernels' operands: ("kvec", [B, Lk]) for a key mask [B|1, 1, 1, Lk],
    else ("bias", [B|1, H|1, Lq|1, Lk]). Both are additive f32; a boolean
    mask becomes 0 / -1e30. A mask with fewer than 4 axes gains leading
    ones; one that does not broadcast raises."""
    if mask.dim() > 4:
        raise ValueError(f"attn_mask has {mask.dim()} axes, at most 4")
    mask = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
    mb, mh, ml, mk = mask.shape
    if mb not in (1, b) or mh not in (1, h) or ml not in (1, lq) \
            or mk != lk:
        raise ValueError(f"attn_mask {tuple(mask.shape)} does not broadcast "
                         f"to [{b}, {h}, {lq}, {lk}]")
    if mask.dtype == torch.bool:
        add = torch.where(mask, torch.zeros((), device=mask.device),
                          torch.full((), _NEG, device=mask.device))
    else:
        add = mask.float()
    if ml == 1 and mh == 1:
        kv = add.reshape(mb, mk)
        if mb == 1 and b > 1:
            kv = kv.expand(b, mk)
        return ("kvec", kv)
    return ("bias", add)


def _dropout_seeds(generator, device):
    """int32[2] seeds for the kernels' hash, drawn on `device` from
    `generator` (the default generator of the device when None)."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), dtype=torch.int32,
                         device=device, generator=generator)


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Attention over [B, L, H, D] inputs; the scale is 1/sqrt(D)."""
    b, lq, h, d = query.shape
    lk = key.shape[1]
    scale = 1.0 / math.sqrt(d)
    p = float(dropout_p) if training else 0.0
    bias = kvec = None
    if attn_mask is not None:
        if attn_mask.requires_grad:
            return _sdpa_ref(query, key, value, attn_mask, is_causal, scale,
                             p, generator)
        mapped = _mask_to_kernel_operands(attn_mask, b, h, lq, lk)
        if mapped[0] == "kvec":
            kvec = mapped[1]
        else:
            bias = mapped[1]
    seeds = _dropout_seeds(generator, query.device) if p > 0.0 else None
    return flash_attention_blhd(query, key, value, bias, kvec, seeds,
                                causal=is_causal, scale=scale, dropout_p=p)
