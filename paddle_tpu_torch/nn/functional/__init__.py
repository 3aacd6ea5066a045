"""Functional ops of the port (counterpart of `paddle_tpu/nn/functional/`):
so far what GPT training and Llama inference need."""
from .activation import silu
from .attention import scaled_dot_product_attention
from .common import dropout
from .loss import cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["scaled_dot_product_attention", "dropout", "cross_entropy",
           "layer_norm", "rms_norm", "silu"]
