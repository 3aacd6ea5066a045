"""nn counterparts GPT and Llama need; Linear, Embedding and GELU are
torch's own."""
from . import functional
from .layer.norm import LayerNorm, RMSNorm

__all__ = ["LayerNorm", "RMSNorm", "functional"]
