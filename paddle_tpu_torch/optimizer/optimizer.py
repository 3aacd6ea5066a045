"""Optimizer base (counterpart of `paddle_tpu/optimizer/optimizer.py`).

Holds the parameter list, a float learning rate, the weight decay
coefficient and the per-parameter and global state; `step()` updates
every parameter that has a gradient with one multi-tensor sweep of the
subclass's rule. A learning-rate scheduler and grad_clip are not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

__all__ = ["Optimizer"]

ParamsLike = Iterable[Union[torch.Tensor, Tuple[str, torch.Tensor]]]


class Optimizer:
    """Subclasses define `_accumulator_specs(p)`, `_global_state_spec()`,
    `_advance_global(gstate)` and `_update(params, grads, states, lr)`."""

    def __init__(self, learning_rate=0.001, parameters: ParamsLike = None,
                 weight_decay: float = None, grad_clip=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "learning-rate schedulers are not ported (ROADMAP.md, "
                "queue 1, item 6)")
        if parameters is None:
            raise ValueError("the port's optimizers need `parameters`")
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self._decay = float(weight_decay or 0.0)
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
        return self._learning_rate

    def set_lr(self, value: float):
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
        return st

    def _name(self, p: torch.Tensor) -> str:
        return self._names[id(p)]

    def state_dict(self) -> dict:
        """Copies of the state, keyed as the JAX package keys them:
        `<param>_<accumulator>_0` and `global_<name>`."""
        sd = {}
        for p in self._parameter_list:
            for acc, v in self._accumulators.get(id(p), {}).items():
                sd[f"{self._name(p)}_{acc}_0"] = v.detach().clone()
        for k, v in self._gstate.items():
            sd[f"global_{k}"] = v
        return sd

    # -- the update -------------------------------------------------------
    def _active_params(self) -> List[torch.Tensor]:
        return [p for p in self._parameter_list
                if p.requires_grad and p.grad is not None]

    @torch.no_grad()
    def step(self):
        if self._grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported (ROADMAP.md, queue 1, item 6)")
        params = self._active_params()
        if params:
            self._update(params, [p.grad for p in params],
                         [self._state_for(p) for p in params],
                         self.get_lr())
        self._gstate = self._advance_global(self._gstate)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    def _update(self, params, grads, states, lr):
        raise NotImplementedError
