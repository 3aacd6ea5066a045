"""Layers of the port (counterpart of `paddle_tpu/nn/layer/`)."""
from .norm import LayerNorm, RMSNorm

__all__ = ["LayerNorm", "RMSNorm"]
