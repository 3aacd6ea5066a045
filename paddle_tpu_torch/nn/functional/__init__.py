"""Functional ops of the port (counterpart of `paddle_tpu/nn/functional/`):
so far what GPT training needs."""
from .attention import scaled_dot_product_attention
from .common import dropout
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["scaled_dot_product_attention", "dropout", "cross_entropy",
           "layer_norm"]
