"""nn counterparts GPT needs; Linear, Embedding and GELU are torch's own."""
from .layer.norm import LayerNorm

__all__ = ["LayerNorm"]
