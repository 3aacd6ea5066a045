"""The training step of the port (counterpart of `paddle_tpu/jit/`)."""
from .trainer import CompiledTrainStep, compile_train_step

__all__ = ["compile_train_step", "CompiledTrainStep"]
