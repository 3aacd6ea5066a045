"""Optimizer base (counterpart of `paddle_tpu/optimizer/optimizer.py`).

Holds the parameter list, the learning rate (a float, or an
`lr.LRScheduler` read once a step), the weight decay coefficient (a
float, or an `L2Decay`/`L1Decay`-like object with `_coeff` or
`_regularization_coeff`), the gradient clip and the per-parameter and
global state. `step()` takes the gradients of every parameter that has
one, clips them (`grad_clip`), folds the L2 term decay * p into them
unless the optimizer is decoupled (`AdamW`), then updates every
parameter with one multi-tensor sweep of the subclass's rule (the JAX
eager step, optimizer.py:182-194, and compiled step, trainer.py:146-156,
in that order).

With `multi_precision`, a bf16 or f16 parameter gets an f32 master
weight (`master_weight`, copied from the parameter at its first step):
the rule updates the master, and the parameter is the master rounded.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple, Union

import numpy as np
import torch

from ..nn.clip import apply_grad_clip_values
from .lr import LRScheduler

__all__ = ["Optimizer"]

ParamsLike = Iterable[Union[torch.Tensor, Tuple[str, torch.Tensor]]]
_HALF = (torch.float16, torch.bfloat16)


def _decay_coeff(weight_decay) -> float:
    """The JAX `_decay_coeff`: None -> 0, a number, or the object's
    `_coeff` (else `_regularization_coeff`, else 0)."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    coeff = getattr(weight_decay, "_coeff", None)
    if coeff is None:
        coeff = getattr(weight_decay, "_regularization_coeff", 0.0)
    return float(coeff)


class Optimizer:
    """Subclasses define `_accumulator_specs(p)`, `_global_state_spec()`,
    `_advance_global(gstate)` and `_update(params, grads, states, lr)`;
    the rule updates each parameter's `master_weight` where its state
    has one, and `step` then rounds the master into the parameter."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, parameters: ParamsLike = None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("the port's optimizers need `parameters`")
        self._lr_scheduler = None
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            self._learning_rate = learning_rate()
        else:
            self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self._decay = _decay_coeff(weight_decay)
        self._multi_precision = bool(multi_precision)
        self._parameter_list: List[torch.Tensor] = []
        self._names: Dict[int, str] = {}
        for i, item in enumerate(parameters):
            name, p = item if isinstance(item, tuple) else (f"param_{i}",
                                                           item)
            self._parameter_list.append(p)
            self._names[id(p)] = name
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._gstate = dict(self._global_state_spec())

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._learning_rate

    def set_lr(self, value: float):
        if self._lr_scheduler is not None:
            raise RuntimeError(
                "cannot set_lr when a LRScheduler drives this optimizer")
        self._learning_rate = float(value)

    # -- state ------------------------------------------------------------
    def _accumulator_specs(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _global_state_spec(self) -> dict:
        return {}

    def _advance_global(self, gstate: dict) -> dict:
        return gstate

    def _state_for(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        st = self._accumulators.get(id(p))
        if st is None:
            st = self._accumulators[id(p)] = self._accumulator_specs(p)
            if self._multi_precision and p.dtype in _HALF:
                st["master_weight"] = p.detach().float()
        return st

    def _name(self, p: torch.Tensor) -> str:
        return self._names[id(p)]

    def state_dict(self) -> dict:
        """Copies of the state, keyed as the JAX package keys them:
        `<param>_<accumulator>_0` (the master weight too), `global_<name>`
        and, under a scheduler, `LR_Scheduler`."""
        sd = {}
        for p in self._parameter_list:
            for acc, v in self._accumulators.get(id(p), {}).items():
                sd[f"{self._name(p)}_{acc}_0"] = v.detach().clone()
        for k, v in self._gstate.items():
            sd[f"global_{k}"] = v
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict: dict):
        """Restore what `state_dict` wrote (also the JAX package's round-1
        keys `<param>_<accumulator>`, without the `_0`)."""
        for p in self._parameter_list:
            names = list(self._accumulator_specs(p)) + ["master_weight"]
            found = {}
            for acc in names:
                for key in (f"{self._name(p)}_{acc}_0",
                            f"{self._name(p)}_{acc}"):
                    if key in state_dict:
                        found[acc] = torch.as_tensor(state_dict[key]).to(
                            p.device)
                        break
            if found:
                self._state_for(p).update(found)
        for k in list(self._gstate):
            if f"global_{k}" in state_dict:
                self._gstate[k] = np.float32(state_dict[f"global_{k}"])
        if self._lr_scheduler is not None and "LR_Scheduler" in state_dict:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])

    # -- the update -------------------------------------------------------
    def _active_params(self) -> List[torch.Tensor]:
        return [p for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    def step(self):
        self._step(compiled=False)

    @torch.no_grad()
    def _step(self, compiled: bool):
        """The update. `compiled` (the train step's) clips with
        `apply_grad_clip_values` on the gradients alone, as the JAX
        compiled step does, and folds decay * p with one rounding, as its
        XLA program fuses it; else (the eager `step()`) the clip class
        runs on (parameter, gradient) pairs, honouring `need_clip`, and
        the product rounds before the sum, as JAX's eager ops do."""
        params = self._active_params()
        if params:
            grads = [p.grad for p in params]
            if self._grad_clip is not None:
                grads = apply_grad_clip_values(self._grad_clip, grads) \
                    if compiled else [g for _, g in self._grad_clip(
                        list(zip(params, grads)))]
            if self._decay and not self._decoupled:
                grads = torch._foreach_add(grads, params, alpha=self._decay) \
                    if compiled else torch._foreach_add(
                        grads, torch._foreach_mul(params, self._decay))
            states = [self._state_for(p) for p in params]
            self._update(params, grads, states, self.get_lr())
            for p, s in zip(params, states):
                if "master_weight" in s:
                    p.copy_(s["master_weight"])
        self._gstate = self._advance_global(self._gstate)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    def _update(self, params, grads, states, lr):
        raise NotImplementedError
