"""The training step (counterpart of `paddle_tpu/jit/trainer.py`).

`compile_train_step(loss_fn, model, optimizer)` returns a callable
`step(*batch) -> loss` that runs the forward, the backward and the
optimizer's update, then clears the gradients. The JAX package compiles
that into one XLA program with donated buffers; here it runs eagerly on
the CPU and on the card alike. Capturing the step in a CUDA graph is
later performance work (ROADMAP.md).

The order is the JAX step's (trainer.py:96-156): the gradients (merged
over micro-batches when `accumulate_steps` > 1), then the optimizer's
clip by `apply_grad_clip_values`, then the L2 fold decay * p for an
optimizer that is not decoupled, then one update. The learning rate is
read once a call (`optimizer.get_lr()`); the step never steps a
scheduler: that stays the caller's.

Gradient merge: `accumulate_steps=k` (or the optimizer's
`_gradient_merge_k`, with `_gradient_merge_avg`, default True) splits
every batch item with a leading dim k ways (0-d items go to each
micro-batch whole) and runs forward and backward on each. Each
micro-batch's gradients are added into f32 buffers (not into `.grad`,
which torch would accumulate in the parameter's dtype), divided by k
when averaging and cast to each parameter's dtype; the loss is the mean
of the micro-batch losses (`micro_losses` keeps them).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

__all__ = ["compile_train_step", "CompiledTrainStep"]


class CompiledTrainStep:
    """step(*batch) -> the f32 loss (a 0-d tensor on the model's device,
    not synchronised). Batch items may be tensors or numpy arrays; they
    are moved to the model's device."""

    def __init__(self, loss_fn: Callable, model: torch.nn.Module, optimizer,
                 accumulate_steps: Optional[int] = None):
        self.loss_fn = loss_fn
        self.model = model
        self.optimizer = optimizer
        self.device = next(model.parameters()).device
        self.accumulate_steps = int(
            accumulate_steps if accumulate_steps is not None
            else getattr(optimizer, "_gradient_merge_k", 1) or 1)
        self.accumulate_avg = bool(
            getattr(optimizer, "_gradient_merge_avg", True))
        self.micro_losses: List[torch.Tensor] = []

    def _to_device(self, b):
        if isinstance(b, np.ndarray):
            b = torch.from_numpy(b)
        return b.to(self.device) if isinstance(b, torch.Tensor) else b

    def _micro_batches(self, batch: list) -> List[list]:
        k = self.accumulate_steps
        split = []
        for i, b in enumerate(batch):
            if not isinstance(b, torch.Tensor) or b.dim() == 0:
                split.append([b] * k)
                continue
            if b.shape[0] % k:
                raise ValueError(
                    f"batch arg {i}: leading dim {b.shape[0]} not "
                    f"divisible by accumulate_steps={k}")
            split.append(b.chunk(k))
        return [list(mb) for mb in zip(*split)]

    def _merged_backward(self, batch: list) -> torch.Tensor:
        """Forward and backward over the micro-batches; leaves the merged
        gradients in `.grad` and returns the mean loss."""
        params = [p for p in self.optimizer._parameter_list
                  if p.requires_grad]
        acc = [None] * len(params)
        self.micro_losses = []
        for mb in self._micro_batches(batch):
            loss = self.loss_fn(*mb).float()
            loss.backward()
            self.micro_losses.append(loss.detach())
            with torch.no_grad():
                for i, p in enumerate(params):
                    if p.grad is None:
                        continue
                    # for an f32 parameter g is .grad itself, which the
                    # buffer then owns: .grad is cleared below
                    g = p.grad.float()
                    acc[i] = g if acc[i] is None else acc[i].add_(g)
                    p.grad = None
        with torch.no_grad():
            for p, a in zip(params, acc):
                if a is not None:
                    if self.accumulate_avg:
                        a.div_(self.accumulate_steps)
                    p.grad = a.to(p.dtype)
        return torch.stack(self.micro_losses).mean()

    def __call__(self, *batch) -> torch.Tensor:
        batch = [self._to_device(b) for b in batch]
        if self.accumulate_steps > 1:
            loss = self._merged_backward(batch)
        else:
            loss = self.loss_fn(*batch).float()
            loss.backward()
        self.optimizer._step(compiled=True)
        self.optimizer.clear_grad()
        return loss.detach()


def compile_train_step(loss_fn: Callable, model: torch.nn.Module, optimizer,
                       accumulate_steps: Optional[int] = None
                       ) -> CompiledTrainStep:
    """loss_fn(*batch) -> scalar loss, closing over `model`. Returns a
    callable step(*batch) -> loss (forward + backward + update);
    `accumulate_steps=k` merges the gradients of k micro-batches."""
    return CompiledTrainStep(loss_fn, model, optimizer,
                             accumulate_steps=accumulate_steps)
