"""Optimizers of the port (counterpart of `paddle_tpu/optimizer/`): so
far Adam and AdamW with the JAX package's update rule, and the
learning-rate schedulers of `lr`."""
from . import lr
from .adam import Adam, AdamW
from .optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
