"""fleet (counterpart of `paddle_tpu/distributed/fleet/`): so far the
activation checkpointing of `utils`."""
from . import utils
from .utils import recompute, recompute_sequential

__all__ = ["utils", "recompute", "recompute_sequential"]
