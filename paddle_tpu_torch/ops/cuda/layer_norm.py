"""K1: fused LayerNorm forward — CUDA kernel, plain version, wrapper.

Counterpart of `paddle_tpu/ops/pallas/layer_norm.py` (`_ln_fwd_kernel`,
launched from `_fwd_call`), reached there from
`paddle_tpu/nn/functional/norm.py::_ln_fwd`. The kernel is
`csrc/layer_norm.cu`; the backward (K2) comes with training.

`layer_norm(x, w, b, eps)` normalises over the last axis with f32
statistics (two passes: the mean, then the mean of the centred
squares) and returns x's dtype. A CPU tensor takes the plain version
`layer_norm_reference`; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_reference", "LAUNCHES",
           "reset_launches", "MAX_COLS"]

# kernel launches since the last reset_launches() (the main path's
# proof that it went through the kernel)
LAUNCHES = 0
# widest row the kernel holds in registers: 16 vectors of 16 bytes per lane
MAX_COLS = {torch.float32: 2048, torch.bfloat16: 4096, torch.float16: 4096}


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def layer_norm_reference(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * w.float() + b.float()
    return y.to(x.dtype)


def _check(x, w, b):
    c = x.shape[-1]
    if w.shape != (c,) or b.shape != (c,):
        raise ValueError(f"layer_norm: w and b must be [{c}], got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if not (w.dtype == b.dtype == x.dtype):
        raise TypeError(f"layer_norm kernel: x, w, b must share a dtype, "
                        f"got {x.dtype}, {w.dtype}, {b.dtype}")
    if not (w.device == b.device == x.device):
        raise ValueError("layer_norm: x, w, b on different devices")
    vec = 16 // x.element_size()
    if c % vec or c > MAX_COLS.get(x.dtype, 0):
        raise ValueError(
            f"layer_norm kernel: last dim {c} must be a multiple of {vec} "
            f"and at most {MAX_COLS.get(x.dtype)} for {x.dtype}")


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    if x.device.type == "cpu":
        return layer_norm_reference(x, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    global LAUNCHES
    _check(x, w, b)
    x2 = x.contiguous()
    w, b = w.contiguous(), b.contiguous()
    y = torch.empty_like(x2)
    rows = x2.numel() // x2.shape[-1]
    lib = _build.load("layer_norm")
    err = lib.ptt_layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), rows,
        x2.shape[-1], float(eps), _build.dtype_code(x2.dtype),
        x2.device.index, _build.stream_ptr(x2.device))
    _build.check(lib, err, "layer_norm kernel launch")
    LAUNCHES += 1
    return y
