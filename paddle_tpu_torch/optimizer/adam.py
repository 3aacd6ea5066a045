"""Adam and AdamW with the JAX package's rule (counterpart of
`paddle_tpu/optimizer/adam.py`), not `torch.optim`'s: its epsilon
placement and bias correction differ in detail.

For every parameter p with gradient g (adam.py:80-93):

    m = b1 m + (1 - b1) g32,  v = b2 v + (1 - b2) g32^2      (f32)
    step = lr (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps)
    p = (p32 (1 - lr d) - step) rounded to p's dtype          (AdamW)
    p = (p32 - step) rounded to p's dtype                     (Adam)

b1p and b2p are f32 running powers of the betas, advanced after the
sweep; the scalar factors are formed in f32 as the JAX package forms
them. Moments are f32 from the first step and there is no master
weight: bf16 parameters are updated in f32 and rounded back. The sweep
runs on torch's multi-tensor `_foreach_*` ops.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]

_F = np.float32


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _accumulator_specs(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _global_state_spec(self):
        return {"beta1_pow": _F(1.0), "beta2_pow": _F(1.0)}

    def _advance_global(self, gstate):
        return {"beta1_pow": _F(gstate["beta1_pow"] * _F(self._beta1)),
                "beta2_pow": _F(gstate["beta2_pow"] * _F(self._beta2))}

    def _decay_factors(self, params):
        """Per-parameter multiplier of p32 before the step (1 for Adam)."""
        return [1.0] * len(params)

    def _update(self, params, grads, states, lr):
        b1, b2 = self._beta1, self._beta2
        g32 = [g.float() for g in grads]
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=1.0 - b2)
        g = self._gstate
        b1p = _F(g["beta1_pow"] * _F(b1))
        b2p = _F(g["beta2_pow"] * _F(b2))
        lr32 = _F(lr)
        denom = torch._foreach_div(v, float(_F(1.0) - b2p))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        step = torch._foreach_div(m, float(_F(1.0) - b1p))
        torch._foreach_mul_(step, float(lr32))
        torch._foreach_div_(step, denom)
        # out of place: for f32 parameters p.float() is p itself
        new = torch._foreach_mul([p.float() for p in params],
                                 self._decay_factors(params))
        torch._foreach_sub_(new, step)
        torch._foreach_copy_(params, new)


class AdamW(Adam):
    """Decoupled weight decay: p32 (1 - lr d) before the step, with d the
    weight_decay coefficient, or 0 for a parameter whose name
    `apply_decay_param_fun` rejects (names come from `parameters` given
    as (name, tensor) pairs, e.g. `model.named_parameters()`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None):
        self._apply_decay_param_fun = apply_decay_param_fun
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)

    def _decay_factors(self, params):
        lr32 = _F(self.get_lr())
        out = []
        for p in params:
            d = self._decay
            if self._apply_decay_param_fun is not None and \
                    not self._apply_decay_param_fun(self._name(p)):
                d = 0.0
            out.append(float(_F(1.0) - lr32 * _F(d)))
        return out
