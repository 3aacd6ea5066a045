"""LayerNorm layer (counterpart of `paddle_tpu/nn/layer/norm.py`
LayerNorm, whose affine last-axis case routes to the fused kernel K1
through `nn/functional/norm.py::_ln_fwd`)."""
from __future__ import annotations

import torch
from torch import nn

from ...ops.cuda.layer_norm import layer_norm

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last axis through K1's wrapper: the
    plain version for a CPU tensor, the CUDA kernel for a CUDA one.
    Paddle spells the epsilon `epsilon`; weight starts at 1, bias at 0."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.epsilon)
