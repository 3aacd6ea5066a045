"""LayerNorm and RMSNorm as functions (counterpart of
`paddle_tpu/nn/functional/norm.py::layer_norm` and `_ln_fwd`, and of
`rms_norm` and `_rms_fwd`).

The route is the JAX package's, decided by shape and dtype before any
launch: an affine last-axis LayerNorm the kernels take (`tln.supported`:
the JAX `supported`, which also keeps on the kernels the widths that are
a multiple of 16 bytes but not of 128) goes through `LayerNormFunction`
(K1 forward, K2 backward on the card; their plain versions on the CPU),
as the JAX package routes it to its fused Pallas pair. Every other case
(no affine parameters, several axes, a width the kernels do not take,
another dtype) is `_ln_jnp`, a plain-torch port of the JAX package's jnp
branch (shifted one-pass statistics), differentiated by autograd.

RMSNorm is jnp in the JAX package (no Pallas kernel), so it is plain
torch here, on the card too.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ...ops.cuda import layer_norm as tln
from ...ops.cuda.layer_norm import LayerNormFunction

__all__ = ["layer_norm", "rms_norm"]


def _one_pass_stats(xf: torch.Tensor, axes):
    """Shifted one-pass mean and variance over `axes` (keepdims): with s
    the slice at index 0 of each reduced axis, E[x - s] + s and
    max(E[(x - s)^2] - E[x - s]^2, 0) (the JAX `_one_pass_stats`)."""
    idx = tuple(slice(0, 1) if i in axes else slice(None)
                for i in range(xf.dim()))
    s = xf[idx]
    xs = xf - s
    m = xs.mean(dim=axes, keepdim=True)
    var = torch.clamp(xs.square().mean(dim=axes, keepdim=True) - m.square(),
                      min=0.0)
    return m + s, var


def _ln_jnp(x: torch.Tensor, w: Optional[torch.Tensor],
            b: Optional[torch.Tensor], n_axes: int, eps: float):
    """The JAX `_ln_fwd`'s jnp branch: f32 statistics for bf16/f16 input
    (an f32 or f64 input keeps its own dtype), w and b cast to the
    statistics' dtype, the result in x's dtype."""
    axes = tuple(range(x.dim() - n_axes, x.dim()))
    dt = x.dtype
    xf = x.float() if dt in (torch.bfloat16, torch.float16) else x
    mean, var = _one_pass_stats(xf, axes)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.to(y.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(dt)


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
    if tln.supported(x, weight, bias, n_axes):
        return LayerNormFunction.apply(x, weight, bias, float(epsilon))
    return _ln_jnp(x, weight, bias, n_axes, float(epsilon))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight over the last axis, in the
    JAX `_rms_fwd`'s order: bf16/f16 input upcast to f32 (other dtypes
    keep theirs), the weight cast to that dtype and multiplied before
    the one cast back to x's dtype."""
    dt = x.dtype
    xf = x.float() if dt in (torch.bfloat16, torch.float16) else x
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + epsilon)
    return (y * weight.to(y.dtype)).to(dt)
