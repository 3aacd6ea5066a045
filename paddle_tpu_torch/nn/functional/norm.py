"""LayerNorm as a function (counterpart of
`paddle_tpu/nn/functional/norm.py::layer_norm` and `_ln_fwd`).

The affine last-axis case goes through `LayerNormFunction` (K1 forward,
K2 backward on the card, where the kernels' wrappers raise for what they
cannot take; their plain versions on the CPU), as the JAX package
routes it to its fused Pallas pair. The case without affine parameters,
or over several axes, is plain torch with f32 statistics, as the JAX
package leaves it to jnp (`pln.supported` rejects it).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ...ops.cuda.layer_norm import LayerNormFunction

__all__ = ["layer_norm"]


def layer_norm(x: torch.Tensor, normalized_shape: Union[int, Sequence[int]],
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """Normalise x over its last len(normalized_shape) axes."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_axes = len(tuple(normalized_shape))
    if (weight is None) != (bias is None):
        raise ValueError("layer_norm needs both or neither of weight/bias")
    if n_axes == 1 and weight is not None:
        return LayerNormFunction.apply(x, weight, bias, float(epsilon))
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        y = y * weight.to(y.dtype) + bias.to(y.dtype)
    return y.to(x.dtype)
