"""Optimizers of the port (counterpart of `paddle_tpu/optimizer/`): so
far Adam and AdamW with the JAX package's update rule."""
from .adam import Adam, AdamW
from .optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]
