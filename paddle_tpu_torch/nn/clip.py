"""Gradient clipping (counterpart of `paddle_tpu/nn/clip.py`).

The optimizer calls its `grad_clip` on (parameter, gradient) pairs
before the update (`Optimizer.step`); the train step calls
`apply_grad_clip_values` on the gradients alone, as the JAX compiled
step does. Each class keeps its own formula:

- `ClipGradByValue`: clamp to [min, max] (min defaults to -max);
- `ClipGradByNorm`: each gradient scaled by min(c / max(|g|, 1e-12), 1);
- `ClipGradByGlobalNorm`: every gradient scaled by c / max(|G|, c), |G|
  the norm over all of them (not `clip_grad_norm_`'s min(1, ...)).

Norms are taken in f32 and the scale is cast to each gradient's dtype
before the product. The classes skip a parameter whose `need_clip` is
False (and a None gradient); `apply_grad_clip_values`, like its JAX
counterpart, sees no parameters and clips every gradient.
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_", "apply_grad_clip_values",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm"]


def _clipped(p, g) -> bool:
    return g is not None and getattr(p, "need_clip", True)


def _norm(g: torch.Tensor) -> torch.Tensor:
    """The f32 2-norm of g (the JAX sqrt(sum(square(g.astype(f32)))))."""
    return torch.linalg.vector_norm(g, dtype=torch.float32)


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([_norm(g).square() for g in grads]).sum().sqrt()


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return g * scale.to(g.dtype)


class ClipGradBase:
    """Subclasses define `_clip(g)`, one gradient's clip, or override
    `_dygraph_clip` (the pairs)."""

    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _clip(self, g: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _dygraph_clip(self, params_grads):
        return [(p, self._clip(g) if _clipped(p, g) else g)
                for p, g in params_grads]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, g: torch.Tensor) -> torch.Tensor:
        return torch.clamp(g, self.min, self.max)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, g: torch.Tensor) -> torch.Tensor:
        scale = torch.clamp(self.clip_norm / torch.clamp(_norm(g),
                                                         min=1e-12),
                            max=1.0)
        return _scaled(g, scale)


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by clip_norm / max(global norm, clip_norm).
    `group_name` and `auto_skip_clip` are kept, as the JAX class keeps
    them, and not used."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = auto_skip_clip

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return _global_norm(grads)

    def _scale(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.clip_norm / torch.clamp(self.global_norm(grads),
                                            min=self.clip_norm)

    def _dygraph_clip(self, params_grads):
        clippable = [g for p, g in params_grads if _clipped(p, g)]
        if not clippable:
            return params_grads
        scale = self._scale(clippable)
        return [(p, _scaled(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False) -> torch.Tensor:
    """Scale every `.grad` in place by min(max_norm / max(total, 1e-6),
    1) and return the total norm (f32 for a finite norm_type, the
    gradients' dtype for inf)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        dt = functools.reduce(torch.promote_types, [g.dtype for g in grads])
        total = torch.stack([g.abs().max().to(dt) for g in grads]).max()
    else:
        total = torch.stack(
            [g.float().abs().pow(norm_type).sum() for g in grads]
        ).sum().pow(1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p in parameters:
        if p.grad is not None:
            p.grad.mul_(scale.to(p.grad.dtype))
    return total


def clip_grad_value_(parameters, clip_value):
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)


# legacy aliases (fluid.clip)
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


def apply_grad_clip_values(clip, grads: List[torch.Tensor]
                           ) -> List[torch.Tensor]:
    """The clip classes' formulas on bare gradients (the train step's
    path; no `need_clip`, as in the JAX counterpart)."""
    if clip is None:
        return grads
    if isinstance(clip, (ClipGradByValue, ClipGradByNorm)):
        return [clip._clip(g) for g in grads]
    if isinstance(clip, ClipGradByGlobalNorm):
        scale = clip._scale(grads)
        return [_scaled(g, scale) for g in grads]
    raise NotImplementedError(
        f"grad_clip {type(clip).__name__} is not supported on the "
        "compiled train-step path")
