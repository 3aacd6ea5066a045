"""LayerNorm and RMSNorm layers (counterpart of
`paddle_tpu/nn/layer/norm.py` LayerNorm, whose affine last-axis case
routes to the fused kernel pair K1/K2 through `nn/functional/norm.py`,
and RMSNorm)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import layer_norm, rms_norm

__all__ = ["LayerNorm", "RMSNorm"]


class LayerNorm(nn.Module):
    """Affine LayerNorm over the last axis through `F.layer_norm`: K1
    forward and K2 backward for a CUDA tensor, their plain versions for
    a CPU one. Paddle spells the epsilon `epsilon`; weight starts at 1,
    bias at 0. An input of another dtype than the weights normalises
    with the weights converted to f32 and returns the input's dtype, the
    weights' gradients in theirs (the JAX layer, which hands both to
    `_ln_fwd` as they are)."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        self.normalized_shape = int(normalized_shape)
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis (`F.rms_norm`, plain torch): a weight
    that starts at 1 and no bias."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.epsilon)
