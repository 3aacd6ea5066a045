"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package grows
beside it slice by slice, and imports neither JAX nor anything of
`paddle_tpu`. The first slice is GPT serving: `nlp.gpt` (the model),
`nlp.generation` (the paged decode cache), `serving` (the continuous-
batching engine with its unified ragged step, paged KV pool and radix
prefix cache) and the two hand-written Hopper kernels that path runs,
`ops.cuda.layer_norm` (K1) and `ops.cuda.paged_attention` (K6).

Entry points run on the GPU unless the caller passes device="cpu".
"""
from .core import make_generator, resolve_device

__version__ = "0.1.0"

__all__ = ["make_generator", "resolve_device", "__version__"]
