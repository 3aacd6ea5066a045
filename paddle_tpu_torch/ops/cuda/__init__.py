"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- `layer_norm` — K1 and K2, the fused LayerNorm forward and backward
  (`paddle_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel`,
  `_ln_bwd_kernel`), joined by `LayerNormFunction`;
- `flash_attention` — K3, K4 and K5, flash attention forward, dq and
  dk/dv (`paddle_tpu/ops/pallas/flash_attention.py::_fa_kernel`,
  `_fa_dq_kernel`, `_fa_dkv_kernel`), joined by `flash_attention_blhd`;
- `paged_attention` — K6, ragged paged attention
  (`paddle_tpu/ops/pallas/paged_attention.py::_ragged_kernel`).

A wrapper takes its plain version only for a CPU tensor; on a CUDA
tensor it launches the kernel (built on first use by `_build`) or
raises. Each wrapper module counts its launches in `LAUNCHES`.
"""
from . import flash_attention, layer_norm, paged_attention

__all__ = ["flash_attention", "layer_norm", "paged_attention"]
