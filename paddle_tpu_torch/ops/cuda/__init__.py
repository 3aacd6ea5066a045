"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- `layer_norm` — K1 and K2, the fused LayerNorm forward and backward
  (`paddle_tpu/ops/pallas/layer_norm.py::_ln_fwd_kernel`,
  `_ln_bwd_kernel`), joined by `LayerNormFunction`;
- `flash_attention` — K3, K4 and K5, flash attention forward, dq and
  dk/dv (`paddle_tpu/ops/pallas/flash_attention.py::_fa_kernel`,
  `_fa_dq_kernel`, `_fa_dkv_kernel`), joined by `flash_attention_blhd`;
- `paged_attention` — K6, ragged paged attention
  (`paddle_tpu/ops/pallas/paged_attention.py::_ragged_kernel`), with its
  fp8 lane, its q8 lane K7 and their user-mask lane, and K10, its
  grouped two-phase walk (`_grouped_phase1_kernel`,
  `_grouped_phase2_kernel`) in the same three lanes; K9, the
  single-token decode walk (`_pa_kernel`); K8 and K8-q8, the paged KV
  writes into float, e4m3 and int8 pools (`_scatter_write_kernel`,
  `_scatter_q8_write_kernel`); and the decode megakernel's K11, the
  paged LoRA delta (`_lora_paged_kernel`), and K12, the greedy argmax
  (`_argmax_epilogue_kernel`), with their composition
  `megakernel_decode[_q8]`.

A wrapper takes its plain version only for a CPU tensor; on a CUDA
tensor it launches the kernel (built on first use by `_build`) or
raises. Each wrapper module counts its launches (`LAUNCHES`, and
`GROUPED_LAUNCHES` for K10's two phases, `QUANT_LAUNCHES` for the
quantized lanes and the writes, `DECODE_LAUNCHES` for K9,
`MEGA_LAUNCHES` for K8's float lane, K11 and K12).
"""
from . import flash_attention, layer_norm, paged_attention

__all__ = ["flash_attention", "layer_norm", "paged_attention"]
