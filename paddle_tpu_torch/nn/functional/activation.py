"""Activations (counterpart of `paddle_tpu/nn/functional/activation.py`):
so far what Llama's SwiGLU needs."""
from __future__ import annotations

import torch

__all__ = ["silu"]


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (the JAX package's `jax.nn.silu`)."""
    return torch.nn.functional.silu(x)
