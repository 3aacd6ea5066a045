"""K3, K4, K5: flash attention forward, dq and dk/dv — CUDA kernels,
plain versions, wrappers and the autograd function.

Counterpart of `paddle_tpu/ops/pallas/flash_attention.py`: `_fa_kernel`
(K3, launched from `_flash_fwd_bhld`), `_fa_dq_kernel` and
`_fa_dkv_kernel` (K4 and K5, launched from `_flash_bwd_bhld`), tied
together by the `custom_vjp` `flash_attention_blhd`. The kernels are in
`csrc/flash_attention.cu`.

Semantics, shared by the kernels and the plain versions:

- q [B, Lq, H, D], k/v [B, Lk, H, D] in and o [B, Lq, H, D] out;
  bh = b * H + h, as `_to_bhld` orders it. The kernels read any strides
  with a unit last one (GPT's per-head interleaved q/k/v views cross
  without a copy).
- logits s = (q . k) * scale + bias + kvec in f32, scale 1/sqrt(D) by
  default. bias is additive [Bb, Hb, Lb, Lk] with Bb in {1, B}, Hb in
  {1, H} and Lb in {1, Lq}; kvec is additive [B or 1, Lk] (the JAX
  `_mask_specs` index rules, and a bias broadcast over the queries).
- causal masking is aligned bottom-right: query i sees key j iff
  j <= i + (Lk - Lq). A masked entry has p = 0 exactly, and k-blocks
  past the diagonal are skipped. A query that sees no key (only when
  causal with Lq > Lk) gets o = 0 and lse = -inf, and no gradient; the
  TPU kernel leaves such rows to its block layout.
- dropout comes after the softmax: the normaliser uses the undropped
  row sum, kept weights are scaled by 1/(1-p), and the keep mask is
  `dropout_keep`, the TPU kernel's position hash, bit for bit. The
  seeds are an int32[2] tensor on the inputs' device.
- lse = m + log(max(l, 1e-30)) per row, f32 [BH, Lq] (the TPU kernel's
  128-lane broadcast is a layout artefact and is not kept).
- f32 arithmetic throughout; o, dq, dk, dv come back in the inputs'
  dtype.

A CPU tensor takes the plain versions; a CUDA tensor launches the
kernels or raises. Each kernel counts its launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["flash_attention_blhd", "FlashAttentionBLHD",
           "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_bwd", "flash_attention_reference",
           "flash_dq_reference", "flash_dkv_reference", "flash_bwd_reference",
           "dropout_keep", "drop_threshold", "LAUNCHES", "reset_launches",
           "HEAD_DIMS"]

# launches since the last reset_launches(), per kernel
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
# head dims the kernels are instantiated for
HEAD_DIMS = (64, 128)
_M32 = 0xFFFFFFFF


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- the dropout hash -------------------------------------------------------
def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for uint32 values held in int64, in two 16-bit
    halves of c so no product leaves the int64 range."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finaliser on uint32 values held in int64 (torch's uint32
    arithmetic on the CPU is patchy)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_keep(seed0, seed1, bh, q_pos, k_pos, thresh: int
                 ) -> torch.Tensor:
    """True where the weight at (bh, q_pos, k_pos) survives dropout: the
    JAX `dropout_keep` (`flash_attention.py:81-91`) bit for bit. The
    seeds are int32 bit patterns (wrapped to uint32); positions are
    absolute in the unpadded sequence; arguments broadcast."""
    u32 = lambda t: torch.as_tensor(t).to(torch.int64) & _M32
    hq = _fmix32((u32(seed0) + _mul32(u32(q_pos), 2654435761)) & _M32)
    hk = _fmix32((u32(seed1) + _mul32(u32(k_pos), 0x27D4EB2F)) & _M32)
    h = _fmix32((hq + hk + _mul32(u32(bh), 0x9E3779B9)) & _M32)
    return h >= int(thresh)


def drop_threshold(p: float) -> int:
    """uint32 threshold: hash < thresh <=> dropped (probability p)."""
    return min(int(p * 4294967296.0), 4294967295)


# -- plain versions ----------------------------------------------------------
def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _logits(q, k, bias, kvec, causal, scale):
    """Logits [B, H, Lq, Lk] in f32 (f64 for f64 inputs), -inf where
    masked."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("blhd,bmhd->bhlm", q.to(ct), k.to(ct)) * scale
    if bias is not None:
        s = s + bias.to(ct)
    if kvec is not None:
        s = s + kvec.to(ct)[:, None, None, :]
    lq, lk = q.shape[1], k.shape[1]
    valid = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.tril(valid, lk - lq)
    return s.masked_fill(~valid, -math.inf)


def _finite_or_zero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(t), t, torch.zeros_like(t))


def _dropped(x, seeds, dropout_p):
    """x [B, H, Lq, Lk] with dropout's keep mask and 1/(1-p) applied."""
    if dropout_p <= 0.0:
        return x
    b, h, lq, lk = x.shape
    dev = x.device
    keep = dropout_keep(seeds[0], seeds[1],
                        torch.arange(b * h, device=dev).view(b, h, 1, 1),
                        torch.arange(lq, device=dev).view(1, 1, lq, 1),
                        torch.arange(lk, device=dev).view(1, 1, 1, lk),
                        drop_threshold(dropout_p))
    return torch.where(keep, x * (1.0 / (1.0 - dropout_p)),
                       torch.zeros((), dtype=x.dtype, device=dev))


def flash_attention_reference(q, k, v, bias=None, kvec=None, seeds=None,
                              causal=False, scale=None, dropout_p=0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: (o [B, Lq, H, D] in q's dtype, lse [BH, Lq]
    in f32)."""
    b, lq, h, d = q.shape
    scale = _scale(q, scale)
    s = _logits(q, k, bias, kvec, causal, scale)
    m = _finite_or_zero(s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m)                       # masked: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    pe = _dropped(p, seeds, dropout_p)
    l1 = torch.clamp(l, min=1e-30)
    o = torch.einsum("bhlm,bmhd->blhd", pe / l1, v.to(p.dtype))
    lse = torch.where(l > 0, m + torch.log(l1),
                      torch.full_like(m, -math.inf))
    return o.to(q.dtype), lse.reshape(b * h, lq)


def _row_dot(o, do):
    """di = rowsum(o * dO) [BH, Lq] in f32 (f64 for f64 inputs)."""
    b, lq, h, _ = o.shape
    ct = torch.promote_types(o.dtype, torch.float32)
    return (o.to(ct) * do.to(ct)).sum(dim=-1).transpose(1, 2).reshape(
        b * h, lq)


def _recompute(q, k, v, lse, di, do, bias, kvec, seeds, causal, scale,
               dropout_p):
    """(p, ds, dO) [B, H, Lq, Lk] of the backward, from lse and di."""
    b, lq, h, d = q.shape
    scale = _scale(q, scale)
    s = _logits(q, k, bias, kvec, causal, scale)
    ct = s.dtype
    p = torch.exp(s - _finite_or_zero(lse.to(ct).view(b, h, lq, 1)))
    dof = do.to(ct)
    dp = _dropped(torch.einsum("blhd,bmhd->bhlm", dof, v.to(ct)), seeds,
                  dropout_p)
    ds = p * (dp - di.to(ct).view(b, h, lq, 1)) * scale
    return p, ds, dof


def flash_dq_reference(q, k, v, lse, di, do, bias=None, kvec=None,
                       seeds=None, causal=False, scale=None, dropout_p=0.0):
    """Plain version of K4: dq = sum_k ds . K, in q's dtype."""
    _, ds, _ = _recompute(q, k, v, lse, di, do, bias, kvec, seeds, causal,
                          scale, dropout_p)
    return torch.einsum("bhlm,bmhd->blhd", ds, k.to(ds.dtype)).to(q.dtype)


def flash_dkv_reference(q, k, v, lse, di, do, bias=None, kvec=None,
                        seeds=None, causal=False, scale=None,
                        dropout_p=0.0):
    """Plain version of K5: (dk = sum_q ds^T . Q, dv = sum_q p_eff^T .
    dO), in k's and v's dtypes."""
    p, ds, dof = _recompute(q, k, v, lse, di, do, bias, kvec, seeds, causal,
                            scale, dropout_p)
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.to(ds.dtype))
    dv = torch.einsum("bhlm,blhd->bmhd", _dropped(p, seeds, dropout_p), dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_reference(q, k, v, o, lse, do, bias=None, kvec=None,
                        seeds=None, causal=False, scale=None,
                        dropout_p=0.0):
    """Plain version of K4 and K5: (dq, dk, dv) by recompute from lse,
    with di = rowsum(o * dO), in the inputs' dtypes."""
    di = _row_dot(o, do)
    args = (q, k, v, lse, di, do, bias, kvec, seeds, causal, scale,
            dropout_p)
    return (flash_dq_reference(*args), *flash_dkv_reference(*args))


# -- the kernels --------------------------------------------------------------
class _Params(ctypes.Structure):
    """Mirror of `Params` in csrc/flash_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "dout", "lse", "di", "bias", "kvec", "seeds",
        "out0", "out1")]
        + [(n, ctypes.c_longlong) for n in (
            "q_sb", "q_sl", "q_sh", "k_sb", "k_sl", "k_sh", "v_sb", "v_sl",
            "v_sh", "do_sb", "do_sl", "do_sh", "bias_sb", "bias_sh",
            "bias_sl", "kvec_sb")]
        + [(n, ctypes.c_int) for n in (
            "B", "H", "Lq", "Lk", "D", "causal", "dropout")]
        + [("thresh", ctypes.c_uint), ("inv_keep", ctypes.c_float),
           ("scale", ctypes.c_float)])


def _strided(t: torch.Tensor) -> torch.Tensor:
    """t itself if the kernel can read it in place (unit last stride,
    16-byte aligned rows), else a contiguous copy."""
    vec = 16 // t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % vec == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def _check(q, k, v, bias, kvec, seeds, dropout_p):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash attention: q [B, Lq, H, D] and k, v "
                         f"[B, Lk, H, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash attention: q, k, v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head dim {d} not in "
                         f"{HEAD_DIMS}")
    lk = k.shape[1]
    if bias is not None:
        if bias.dim() != 4 or bias.shape[0] not in (1, b) \
                or bias.shape[1] not in (1, h) \
                or bias.shape[2] not in (1, lq) or bias.shape[3] != lk:
            raise ValueError(f"flash attention: bias {tuple(bias.shape)} "
                             f"must be [1|{b}, 1|{h}, 1|{lq}, {lk}]")
    if kvec is not None and (kvec.dim() != 2 or kvec.shape[0] not in (1, b)
                             or kvec.shape[1] != lk):
        raise ValueError(f"flash attention: kvec {tuple(kvec.shape)} must "
                         f"be [1|{b}, {lk}]")
    if dropout_p > 0.0 and (seeds is None or seeds.numel() != 2):
        raise ValueError("flash attention: dropout needs int32[2] seeds")
    devs = {t.device for t in (q, k, v, bias, kvec, seeds) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"flash attention: tensors on {devs}")


def _params(q, k, v, bias, kvec, seeds, causal, scale, dropout_p):
    """(Params, the tensors it points into — kept alive by the caller)."""
    b, lq, h, d = q.shape
    p = _Params()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.q_sb, p.q_sl, p.q_sh = q.stride()[:3]
    p.k_sb, p.k_sl, p.k_sh = k.stride()[:3]
    p.v_sb, p.v_sl, p.v_sh = v.stride()[:3]
    keep = []
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        keep.append(bias)
        p.bias = bias.data_ptr()
        p.bias_sb = 0 if bias.shape[0] == 1 else bias.stride(0)
        p.bias_sh = 0 if bias.shape[1] == 1 else bias.stride(1)
        p.bias_sl = 0 if bias.shape[2] == 1 else bias.stride(2)
    if kvec is not None:
        kvec = kvec.to(torch.float32).contiguous()
        keep.append(kvec)
        p.kvec = kvec.data_ptr()
        p.kvec_sb = 0 if kvec.shape[0] == 1 else kvec.stride(0)
    if dropout_p > 0.0:
        seeds = seeds.to(torch.int32).contiguous()
        keep.append(seeds)
        p.seeds = seeds.data_ptr()
        p.dropout = 1
        p.thresh = drop_threshold(dropout_p)
        p.inv_keep = 1.0 / (1.0 - dropout_p)
    p.B, p.H, p.Lq, p.Lk, p.D = b, h, lq, k.shape[1], d
    p.causal = int(bool(causal))
    p.scale = scale
    return p, keep


def _launch(entry: str, p: _Params, dev: torch.device, dtype):
    lib = _build.load("flash_attention")
    err = getattr(lib, entry)(ctypes.addressof(p), _build.dtype_code(dtype),
                              dev.index, _build.stream_ptr(dev))
    _build.check(lib, err, f"{entry} kernel launch")


def _no_kernel(q):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")


def flash_attention_fwd(q, k, v, bias=None, kvec=None, seeds=None,
                        causal=False, scale=None, dropout_p=0.0):
    """K3: (o, lse). Not differentiable: use `flash_attention_blhd`."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, kvec, seeds, causal,
                                         scale, dropout_p)
    _no_kernel(q)
    _check(q, k, v, bias, kvec, seeds, dropout_p)
    q, k, v = (_strided(t) for t in (q, k, v))
    b, lq, h, d = q.shape
    p, keep = _params(q, k, v, bias, kvec, seeds, causal, scale, dropout_p)
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    p.out0, p.out1 = o.data_ptr(), lse.data_ptr()
    _launch("ptt_flash_fwd", p, q.device, q.dtype)
    LAUNCHES["fwd"] += 1
    del keep
    return o, lse


def _bwd_params(q, k, v, lse, di, do, bias, kvec, seeds, causal, scale,
                dropout_p):
    _check(q, k, v, bias, kvec, seeds, dropout_p)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash attention: dO {tuple(do.shape)} "
                         f"{do.dtype} must match q {tuple(q.shape)}")
    q, k, v, do = (_strided(t) for t in (q, k, v, do))
    lse, di = lse.contiguous(), di.to(torch.float32).contiguous()
    p, keep = _params(q, k, v, bias, kvec, seeds, causal, scale, dropout_p)
    p.dout, p.lse, p.di = do.data_ptr(), lse.data_ptr(), di.data_ptr()
    p.do_sb, p.do_sl, p.do_sh = do.stride()[:3]
    return p, keep + [q, k, v, do, lse, di]


def flash_attention_dq(q, k, v, lse, di, do, bias=None, kvec=None,
                       seeds=None, causal=False, scale=None, dropout_p=0.0):
    """K4: dq [B, Lq, H, D] in q's dtype, from lse and di [BH, Lq]."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, lse, di, do, bias, kvec, seeds,
                                  causal, scale, dropout_p)
    _no_kernel(q)
    p, keep = _bwd_params(q, k, v, lse, di, do, bias, kvec, seeds, causal,
                          scale, dropout_p)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    p.out0 = dq.data_ptr()
    _launch("ptt_flash_dq", p, q.device, q.dtype)
    LAUNCHES["dq"] += 1
    del keep
    return dq


def flash_attention_dkv(q, k, v, lse, di, do, bias=None, kvec=None,
                        seeds=None, causal=False, scale=None, dropout_p=0.0):
    """K5: (dk, dv) [B, Lk, H, D] in k's and v's dtypes."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, lse, di, do, bias, kvec, seeds,
                                   causal, scale, dropout_p)
    _no_kernel(q)
    p, keep = _bwd_params(q, k, v, lse, di, do, bias, kvec, seeds, causal,
                          scale, dropout_p)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    p.out0, p.out1 = dk.data_ptr(), dv.data_ptr()
    _launch("ptt_flash_dkv", p, q.device, q.dtype)
    LAUNCHES["dkv"] += 1
    del keep
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, bias=None, kvec=None,
                        seeds=None, causal=False, scale=None,
                        dropout_p=0.0):
    """(dq, dk, dv): di = rowsum(o * dO), a torch op as in the JAX
    package (`flash_attention.py:547`), then K4 and K5."""
    di = _row_dot(o, do)
    args = (q, k, v, lse, di, do, bias, kvec, seeds, causal, scale,
            dropout_p)
    return (flash_attention_dq(*args), *flash_attention_dkv(*args))


class FlashAttentionBLHD(torch.autograd.Function):
    """Mirror of the JAX `custom_vjp` `flash_attention_blhd`
    (`flash_attention.py:651-695`): the forward saves (q, k, v, o, lse,
    seeds) — and the mask operands — the backward recomputes through K4
    and K5; bias, kvec and seeds get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kvec, seeds, causal, scale, dropout_p):
        o, lse = flash_attention_fwd(q, k, v, bias, kvec, seeds, causal,
                                     scale, dropout_p)
        ctx.save_for_backward(q, k, v, o, lse, bias, kvec, seeds)
        ctx.opts = (causal, scale, dropout_p)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, bias, kvec, seeds = ctx.saved_tensors
        causal, scale, dropout_p = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         bias, kvec, seeds, causal, scale,
                                         dropout_p)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         kvec: Optional[torch.Tensor] = None,
                         seeds: Optional[torch.Tensor] = None,
                         causal: bool = False, scale: Optional[float] = None,
                         dropout_p: float = 0.0) -> torch.Tensor:
    """Differentiable flash attention over [B, L, H, D] (see the module
    doc). seeds: int32[2] on q's device, needed when dropout_p > 0."""
    scale = _scale(q, scale)
    dropout_p = float(dropout_p) if seeds is not None else 0.0
    return FlashAttentionBLHD.apply(q, k, v, bias, kvec, seeds,
                                    bool(causal), scale, dropout_p)
