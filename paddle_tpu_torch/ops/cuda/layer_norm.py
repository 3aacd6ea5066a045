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
(dx, dw, db): dx in x's dtype, dw and db in w's. x and w may differ in
dtype (f32, bf16 or f16 each, w and b alike or not): the kernels read w
and b in x's dtype or in f32 and convert them to f32, as the TPU kernels
cast them; the wrappers convert any other weights to f32 first, which
is exact. `supported` says which LayerNorms the kernels take
(`nn/functional/norm.py` routes the rest to plain torch, as the JAX
package routes them to jnp): rows whose width is a multiple of 16
bytes, up to the JAX package's 65536 columns; rows past `REGISTER_COLS`
take each kernel's wide lane (a block a row; K2's with a second launch
that sums dw and db). On the card K2 sums dw and db across its blocks
in a fixed order (`layer_norm_bwd_plan` reports the launch,
`layer_norm_plan` K1's), so they are the same bits on every run. A CPU
tensor takes the plain versions; a CUDA tensor launches the kernels or
raises.
`LayerNormFunction` is the differentiable op: forward through K1,
backward through K2, saving (x, w) as the JAX VJP does.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .cost import kernel_cost, nbytes

__all__ = ["layer_norm", "layer_norm_reference", "layer_norm_bwd",
           "layer_norm_bwd_reference", "layer_norm_plan",
           "layer_norm_bwd_plan", "supported", "LayerNormFunction",
           "LAUNCHES", "BWD_LAUNCHES", "reset_launches", "MAX_COLS",
           "REGISTER_COLS"]

# kernel launches since the last reset_launches() (the main path's
# proof that it went through the kernels): K1 and K2
LAUNCHES = 0
BWD_LAUNCHES = 0
# the dtypes the kernels take, for x and for w and b alike
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the widest row the kernels take: the JAX package's limit for its Pallas
# pair (`supported`: _BWD_BUFFERS * 4 * 8 * c within its 12 MiB budget)
MAX_COLS = 65536
# the widest row of the kernels' register lanes (16 vectors of 16 bytes a
# lane); wider rows take the wide lanes
REGISTER_COLS = {torch.float32: 2048, torch.bfloat16: 4096,
                 torch.float16: 4096}
# K1's and K2's launches by (rows, cols, dtype, wdtype, device): the
# library's plans
_PLANS = {}
_BWD_PLANS = {}
# K2's tickets by device: int32 counters, zero between launches
_BWD_TICKETS = {}
_N_TICKETS = 8
_PLAN = ("grid", "threads", "per_lane", "wide", "early", "smem")
_BWD_PLAN = ("grid", "cluster", "resident", "per_lane", "ring",
             "partials", "wide")


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


def supported(x: torch.Tensor, w, b, n_norm_axes: int = 1) -> bool:
    """Whether the kernels take this LayerNorm (the port's copy of the
    JAX `supported`): over the last axis only of an x of two axes or
    more, with w and b of shape [c], every dtype f32, bf16 or f16 (w and
    b alike or not), and c a multiple of the 16-byte vector of x's
    dtype, up to MAX_COLS. JAX's rule asks for a multiple of 128
    columns; the kernels also take the 16-byte multiples between (K1
    always has), which JAX leaves to jnp. Decided by shape and dtype
    alone, before any launch."""
    if n_norm_axes != 1 or w is None or b is None or x.dim() < 2:
        return False
    c = x.shape[-1]
    if tuple(w.shape) != (c,) or tuple(b.shape) != (c,):
        return False
    if not all(t.dtype in DTYPES for t in (x, w, b)):
        return False
    return c % (16 // x.element_size()) == 0 and 0 < c <= MAX_COLS


def _check(x, w, b):
    c = x.shape[-1]
    if w.shape != (c,) or b.shape != (c,):
        raise ValueError(f"layer_norm: w and b must be [{c}], got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if not all(t.dtype in DTYPES for t in (x, w, b)):
        raise TypeError(f"layer_norm kernel: x, w and b must be f32, bf16 "
                        f"or f16, got {x.dtype}, {w.dtype}, {b.dtype}")
    if not (w.device == b.device == x.device):
        raise ValueError("layer_norm: x, w, b on different devices")
    vec = 16 // x.element_size()
    if c % vec or c > MAX_COLS:
        raise ValueError(
            f"layer_norm kernel: last dim {c} must be a multiple of {vec} "
            f"and at most {MAX_COLS} for {x.dtype}")


def _weights(x: torch.Tensor, *ts):
    """w (and b) as the kernels take them: both in x's dtype or both in
    f32; any other weights are converted to f32 (exact from bf16 and
    f16)."""
    if len({t.dtype for t in ts}) == 1 and ts[0].dtype in (x.dtype,
                                                           torch.float32):
        return ts
    return tuple(t.float() for t in ts)


def _no_kernel(name, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, on a 16-byte boundary (the kernels' vector loads): a
    view that starts off one is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _plan(cache, entry, names, rows, cols, dtype, wdtype, device):
    device = torch.device(device)
    # the weights' dtype the kernel is given (`_weights`)
    wdtype = dtype if wdtype is None else wdtype
    if wdtype not in (dtype, torch.float32):
        wdtype = torch.float32
    key = (rows, cols, dtype, wdtype, device.index)
    plan = cache.get(key)
    if plan is None:
        out = (ctypes.c_int * len(names))()
        lib = _build.load("layer_norm")
        err = getattr(lib, entry)(rows, cols, _build.dtype_code(dtype),
                                  _build.dtype_code(wdtype), device.index,
                                  out)
        _build.check(lib, err, entry)
        plan = cache[key] = dict(zip(names, map(int, out)))
    return plan


def layer_norm_plan(rows: int, cols: int, dtype: torch.dtype, device,
                    wdtype: torch.dtype = None) -> dict:
    """The launch K1 makes for [rows, cols] of `dtype` with weights of
    `wdtype` (default: `dtype`) on CUDA `device`, as the library chooses
    it (`ptt_layer_norm_fwd_plan`): "grid" (blocks), "threads" (a
    block's: 128 in the register lane, a warp a row; 512 in the wide
    lane, a block a row), "per_lane" (the register
    lane's 16-byte vectors a lane; 0 in the wide lane), "wide" (1 for
    the wide lane), "early" (1 where the register lane loads w and b
    with x: grids of up to two blocks an SM, where a lane's x, w and b
    fit 128 registers) and "smem" (the wide lane's staged row in bytes;
    0 where it is re-read)."""
    return _plan(_PLANS, "ptt_layer_norm_fwd_plan", _PLAN, rows, cols, dtype,
                 wdtype, device)


def _ln_work(x, w, b, eps=1e-5):
    """K1: x read and y written once, w and b read once; 8 FLOPs an
    element (the two statistics passes and the affine)."""
    return ("K1", 8 * x.numel(), 2 * nbytes(x) + nbytes(w, b))


@kernel_cost(_ln_work)
def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """K1. Not differentiable on CUDA: use `LayerNormFunction`."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, w, b, eps)
    _no_kernel("layer_norm", x.device)
    global LAUNCHES
    _check(x, w, b)
    x2, (w, b) = _aligned(x), map(_aligned, _weights(x, w, b))
    y = torch.empty_like(x2)
    rows = x2.numel() // x2.shape[-1]
    lib = _build.load("layer_norm")
    err = lib.ptt_layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), rows,
        x2.shape[-1], float(eps), _build.dtype_code(x2.dtype),
        _build.dtype_code(w.dtype), x2.device.index,
        _build.stream_ptr(x2.device))
    _build.check(lib, err, "layer_norm kernel launch")
    LAUNCHES += 1
    return y


def layer_norm_bwd_plan(rows: int, cols: int, dtype: torch.dtype,
                        device, wdtype: torch.dtype = None) -> dict:
    """The launch K2 makes for [rows, cols] of `dtype` with weights of
    `wdtype` (default: `dtype`) on CUDA `device`, as the library chooses
    it (`ptt_layer_norm_bwd_plan`): "grid" (blocks: whole clusters in the
    register lane), "cluster" (blocks a cluster; 1 in the wide lane),
    "resident" (the clusters, in the wide lane the blocks, the card holds
    at once, by the occupancy calculator), "per_lane" (16-byte vectors of
    a row a lane; 0 in the wide lane), "ring" (1: each warp's next rows
    come through a ring of cp.async copies in shared memory), "partials"
    (the f32 partials of dw and db) and "wide" (1 for the wide lane: a
    block a row, then a second launch that sums the blocks' partials). A
    `wdtype` other than `dtype` and f32 counts as f32."""
    return _plan(_BWD_PLANS, "ptt_layer_norm_bwd_plan", _BWD_PLAN, rows,
                 cols, dtype, wdtype, device)


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
    wdtype = w.dtype
    x2, dy2, w = _aligned(x), _aligned(dy), _aligned(_weights(x, w)[0])
    cols = x2.shape[-1]
    rows = x2.numel() // cols
    plan = layer_norm_bwd_plan(rows, cols, x2.dtype, x2.device, w.dtype)
    tickets = _BWD_TICKETS.get(x2.device.index)
    if tickets is None:
        tickets = _BWD_TICKETS[x2.device.index] = torch.zeros(
            _N_TICKETS, dtype=torch.int32, device=x2.device)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    part = torch.empty(plan["partials"], dtype=torch.float32,
                       device=x2.device)
    lib = _build.load("layer_norm")
    err = lib.ptt_layer_norm_bwd(
        dy2.data_ptr(), x2.data_ptr(), w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        rows, cols, plan["grid"], float(eps), _build.dtype_code(x2.dtype),
        _build.dtype_code(w.dtype), x2.device.index,
        _build.stream_ptr(x2.device))
    _build.check(lib, err, "layer_norm_bwd kernel launch")
    BWD_LAUNCHES += 1
    return dx, dw.to(wdtype), db.to(wdtype)


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
