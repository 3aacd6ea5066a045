"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- `layer_norm` — K1, the fused LayerNorm forward
  (`paddle_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel`);
- `paged_attention` — K6, ragged paged attention
  (`paddle_tpu/ops/pallas/paged_attention.py::_ragged_kernel`).

A wrapper takes its plain version only for a CPU tensor; on a CUDA
tensor it launches the kernel (built on first use by `_build`) or
raises. Each wrapper module counts its launches in `LAUNCHES`.
"""
from . import layer_norm, paged_attention

__all__ = ["layer_norm", "paged_attention"]
