"""Adam and AdamW with the JAX package's rule (counterpart of
`paddle_tpu/optimizer/adam.py`), not `torch.optim`'s: its epsilon
placement and bias correction differ in detail.

For every parameter p with gradient g (adam.py:80-93):

    m = b1 m + (1 - b1) g32,  v = b2 v + (1 - b2) g32^2      (f32)
    step = lr (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps)
    p = (p32 (1 - lr d) - step) rounded to p's dtype          (AdamW)
    p = (p32 - step) rounded to p's dtype                     (Adam)

b1p and b2p are f32 running powers of the betas, advanced after the
sweep. The f32 roundings are those of the JAX rule's XLA program on the
CPU, which fuses a product into the sum after it: 1 - b1p, 1 - b2p and
1 - lr d round once, as do b m + (1 - b) g (after the second product)
and p32 (1 - lr d) - step. g is the gradient after the clip and, for
Adam, after the L2 fold g + d p (`Optimizer.step`). Moments are f32
from the first step.
Without `multi_precision`, bf16 parameters are updated in f32 and
rounded back; with it, p32 is the f32 master weight, which keeps the
result, and the parameter is the master rounded (adam.py:20-29, 65-70
and `_apply_rule`). The sweep runs on torch's multi-tensor `_foreach_*`
ops.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]

_F = np.float32


def _one_minus(a, b) -> float:
    """1 - a b in f32 with one rounding (the fused multiply-add XLA makes
    of the bias corrections 1 - b1p and AdamW's 1 - lr d): the f64
    product of two f32 values is exact."""
    return float(_F(1.0 - float(_F(a)) * float(_F(b))))


def _advance_moment(states, key: str, b: float, new):
    """states[i][key] = new[i] + b * states[i][key], `new` holding the
    (1 - b) term: the second product rounded, then one fused multiply-add
    of the first (torch's add with alpha), as the JAX rule's XLA program
    rounds b m + (1 - b) g on the CPU. The sums replace the old moments,
    so one f32 list beside the state lives at a time."""
    torch._foreach_add_(new, [s[key] for s in states], alpha=b)
    for s, x in zip(states, new):
        s[key] = x


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _accumulator_specs(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _global_state_spec(self):
        return {"beta1_pow": _F(1.0), "beta2_pow": _F(1.0)}

    def _advance_global(self, gstate):
        return {"beta1_pow": _F(gstate["beta1_pow"] * _F(self._beta1)),
                "beta2_pow": _F(gstate["beta2_pow"] * _F(self._beta2))}

    def _decay_factors(self, params):
        """Per-parameter multiplier of p32 before the step (1 for Adam,
        whose decay is the L2 fold into g)."""
        return [1.0] * len(params)

    def _update(self, params, grads, states, lr):
        b1, b2 = self._beta1, self._beta2
        g32 = [g.float() for g in grads]
        _advance_moment(states, "moment1", b1,
                        torch._foreach_mul(g32, 1.0 - b1))
        sq = torch._foreach_mul(g32, g32)
        del g32
        torch._foreach_mul_(sq, 1.0 - b2)
        _advance_moment(states, "moment2", b2, sq)
        del sq
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        g = self._gstate
        lr32 = _F(lr)
        denom = torch._foreach_div(v, _one_minus(g["beta2_pow"], b2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._epsilon)
        step = torch._foreach_div(m, _one_minus(g["beta1_pow"], b1))
        torch._foreach_mul_(step, float(lr32))
        torch._foreach_div_(step, denom)
        del denom
        torch._foreach_neg_(step)
        # p32 (1 - lr d) - step, the product fused with the difference as
        # XLA fuses it; into the master weight where there is one (for
        # f32 parameters p.float() is p itself, read before the copy)
        for p, s, st, f in zip(params, states, step,
                               self._decay_factors(params)):
            t = s.get("master_weight", p)
            t.copy_(st.add_(t.float(), alpha=f))


class AdamW(Adam):
    """Decoupled weight decay: p32 (1 - lr d) before the step, with d the
    weight_decay coefficient, or 0 for a parameter whose name
    `apply_decay_param_fun` rejects (names come from `parameters` given
    as (name, tensor) pairs, e.g. `model.named_parameters()`); no L2
    fold into the gradient."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        self._apply_decay_param_fun = apply_decay_param_fun
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)

    def _decay_factors(self, params):
        lr32 = _F(self.get_lr())
        out = []
        for p in params:
            d = self._decay
            if self._apply_decay_param_fun is not None and \
                    not self._apply_decay_param_fun(self._name(p)):
                d = 0.0
            out.append(_one_minus(lr32, d))
        return out
