"""The training step (counterpart of `paddle_tpu/jit/trainer.py`).

`compile_train_step(loss_fn, model, optimizer)` returns a callable
`step(*batch) -> loss` that runs the forward, the backward and the
optimizer's update, then clears the gradients. The JAX package compiles
that into one XLA program with donated buffers; here it runs eagerly on
the CPU and on the card alike. Capturing the step in a CUDA graph is
later performance work (ROADMAP.md), as are gradient merge
(`accumulate_steps > 1`) and gradient clipping.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["compile_train_step", "CompiledTrainStep"]


class CompiledTrainStep:
    """step(*batch) -> the f32 loss (a 0-d tensor on the model's device,
    not synchronised). Batch items may be tensors or numpy arrays; they
    are moved to the model's device."""

    def __init__(self, loss_fn: Callable, model: torch.nn.Module, optimizer,
                 accumulate_steps: Optional[int] = None):
        if accumulate_steps is not None and int(accumulate_steps) > 1:
            raise NotImplementedError(
                "accumulate_steps > 1 (gradient merge) is not ported "
                "(ROADMAP.md, queue 1, item 6)")
        if optimizer._grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported (ROADMAP.md, queue 1, item 6)")
        self.loss_fn = loss_fn
        self.model = model
        self.optimizer = optimizer
        self.device = next(model.parameters()).device

    def _to_device(self, b):
        if isinstance(b, np.ndarray):
            b = torch.from_numpy(b)
        return b.to(self.device) if isinstance(b, torch.Tensor) else b

    def __call__(self, *batch) -> torch.Tensor:
        loss = self.loss_fn(*(self._to_device(b) for b in batch)).float()
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()


def compile_train_step(loss_fn: Callable, model: torch.nn.Module, optimizer,
                       accumulate_steps: Optional[int] = None
                       ) -> CompiledTrainStep:
    """loss_fn(*batch) -> scalar loss, closing over `model`. Returns a
    callable step(*batch) -> loss (forward + backward + update)."""
    return CompiledTrainStep(loss_fn, model, optimizer,
                             accumulate_steps=accumulate_steps)
