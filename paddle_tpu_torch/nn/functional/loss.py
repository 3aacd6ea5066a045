"""Cross entropy (counterpart of `paddle_tpu/nn/functional/loss.py`,
the hard-label path `_ce_hard_fwd`).

log_softmax runs in f32 whatever the logits' dtype; labels equal to
`ignore_index` contribute 0, and the mean divides by the number of valid
labels (at least 1). The loss comes back in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  ignore_index: int = -100, reduction: str = "mean",
                  soft_label: bool = False, axis: int = -1,
                  use_softmax: bool = True, label_smoothing: float = 0.0
                  ) -> torch.Tensor:
    if weight is not None or soft_label or label_smoothing or \
            not use_softmax:
        raise NotImplementedError(
            "cross_entropy: class weights, soft labels, label smoothing "
            "and use_softmax=False are not ported (ROADMAP.md, queue 1, "
            "item 3)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    axis = axis % input.dim()
    logp = torch.log_softmax(input.float(), dim=axis)
    lbl = label
    if lbl.dim() == logp.dim():          # a trailing dim of 1
        lbl = lbl.squeeze(axis)
    lbl = lbl.to(torch.int64)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss
