"""K1 and K2: fused LayerNorm forward and backward — CUDA kernels, plain
versions, wrappers and the autograd function that joins them.

Counterpart of `paddle_tpu/ops/pallas/layer_norm.py`: `_ln_fwd_kernel`
(K1, launched from `_fwd_call`) and `_ln_bwd_kernel` (K2, launched from
`_bwd_call`), tied together there by the `custom_vjp`
`layer_norm_fused`, reached from `paddle_tpu/nn/functional/norm.py`.
Both kernels are in `csrc/layer_norm.cu`.

`layer_norm(x, w, b, eps)` normalises over the last axis with f32
statistics (two passes: the mean, then the mean of the centred
squares) and returns x's dtype. `layer_norm_bwd(dy, x, w, eps)` returns
(dx, dw, db): dx in x's dtype, dw and db in w's. A CPU tensor takes the
plain versions; a CUDA tensor launches the kernels or raises.
`LayerNormFunction` is the differentiable op: forward through K1,
backward through K2, saving (x, w) as the JAX VJP does.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["layer_norm", "layer_norm_reference", "layer_norm_bwd",
           "layer_norm_bwd_reference", "LayerNormFunction", "LAUNCHES",
           "BWD_LAUNCHES", "reset_launches", "MAX_COLS"]

# kernel launches since the last reset_launches() (the main path's
# proof that it went through the kernels): K1 and K2
LAUNCHES = 0
BWD_LAUNCHES = 0
# widest row the kernels hold in registers: 16 vectors of 16 bytes per lane
MAX_COLS = {torch.float32: 2048, torch.bfloat16: 4096, torch.float16: 4096}
# K2: rows per block (kBwdWarps in csrc/layer_norm.cu), and blocks per
# SM of its grid-stride row walk; they size the grid and its f32
# partials, and any values are correct
_BWD_WARPS = 8
_BWD_BLOCKS_PER_SM = 2


def reset_launches():
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    BWD_LAUNCHES = 0


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for every IO dtype the kernels take; f64 stays f64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _stats(xf: torch.Tensor, eps: float):
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc, torch.rsqrt(var + eps)


def layer_norm_reference(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version of K1's arithmetic."""
    ct = _compute_dtype(x.dtype)
    xc, rstd = _stats(x.to(ct), eps)
    y = xc * rstd * w.to(ct) + b.to(ct)
    return y.to(x.dtype)


def layer_norm_bwd_reference(dy: torch.Tensor, x: torch.Tensor,
                             w: torch.Tensor, eps: float):
    """Plain PyTorch version of K2's arithmetic: (dx, dw, db) with the
    statistics recomputed from x, as `_ln_bwd_kernel` does."""
    ct = _compute_dtype(x.dtype)
    xc, rstd = _stats(x.to(ct), eps)
    xhat = xc * rstd
    g = dy.to(ct)
    a = g * w.to(ct)
    m1 = a.mean(dim=-1, keepdim=True)
    m2 = (a * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (a - m1 - xhat * m2)
    c = x.shape[-1]
    dw = (g * xhat).reshape(-1, c).sum(dim=0)
    db = g.reshape(-1, c).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype), db.to(w.dtype)


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


def _no_kernel(name, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """K1. Not differentiable on CUDA: use `LayerNormFunction`."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, w, b, eps)
    _no_kernel("layer_norm", x.device)
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


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-5):
    """K2: (dx, dw, db) of `layer_norm` at (x, w) for the output
    gradient dy. dy may arrive expanded or strided; it is made
    contiguous."""
    if x.device.type == "cpu":
        return layer_norm_bwd_reference(dy, x, w, eps)
    _no_kernel("layer_norm_bwd", x.device)
    global BWD_LAUNCHES
    _check(x, w, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"layer_norm_bwd: dy {tuple(dy.shape)} {dy.dtype} "
                         f"must match x {tuple(x.shape)} {x.dtype}")
    x2, dy2, w = x.contiguous(), dy.contiguous(), w.contiguous()
    cols = x2.shape[-1]
    rows = x2.numel() // cols
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    groups = max(1, min(-(-rows // _BWD_WARPS), _BWD_BLOCKS_PER_SM * sms))
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    part = torch.empty((2, groups, cols), dtype=torch.float32,
                       device=x2.device)
    lib = _build.load("layer_norm")
    err = lib.ptt_layer_norm_bwd(
        dy2.data_ptr(), x2.data_ptr(), w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), part.data_ptr(), rows, cols, groups,
        float(eps), _build.dtype_code(x2.dtype), x2.device.index,
        _build.stream_ptr(x2.device))
    _build.check(lib, err, "layer_norm_bwd kernel launch")
    BWD_LAUNCHES += 1
    return dx, dw, db


class LayerNormFunction(torch.autograd.Function):
    """Affine LayerNorm over the last axis: forward K1, backward K2 (the
    plain versions for CPU tensors). Mirrors the JAX `custom_vjp`
    `layer_norm_fused` (`layer_norm.py:166-181`): the residuals are
    (x, w), and dw, db come back in w's dtype."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = float(eps)
        return layer_norm(x, w, b, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(dy.contiguous(), x, w, ctx.eps)
        return dx, dw, db, None
