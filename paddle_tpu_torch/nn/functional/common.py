"""Dropout (counterpart of `paddle_tpu/nn/functional/common.py::dropout`
in its default mode, upscale_in_train, the mode GPT uses; the other
mode and axis masks are not ported). The keep mask is drawn from
an explicit `torch.Generator`; torch's streams never match JAX's, so the
tests hold the two packages against each other with dropout 0."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dropout"]


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Zero each element with probability p; kept elements are scaled by
    1/(1-p) (upscale_in_train). Identity when not training or p == 0."""
    p = float(p)
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator)
    return torch.where(mask.bool(), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))
