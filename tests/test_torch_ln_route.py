"""The port's LayerNorm route and its two new inputs (F11), held on the
CPU against the JAX package.

The JAX package sends an affine last-axis LayerNorm to its fused Pallas
pair when `paddle_tpu/ops/pallas/layer_norm.py::supported` takes it
(widths that are a multiple of 128, up to 65536 columns), and every
other one to jnp (`paddle_tpu/nn/functional/norm.py::_ln_fwd`, shifted
one-pass statistics). Its kernels cast w and b to f32 whatever x's
dtype, and its VJP returns dw and db in w's dtype. The port decides by
shape and dtype too (`layer_norm.supported`): every width the JAX rule
takes, and the 16-byte multiples between, which its kernels already
took; the rest goes to `_ln_jnp`, the port of the jnp branch. Here: the
two predicates over every width from 64 to 65536 in each x dtype (and at
a sample of them in each w dtype); `_ln_jnp` against the JAX `_ln_fwd`
with PADDLE_TPU_FUSED_LN=0 (forward and gradients) at widths that are
not a multiple of 16 bytes; the functional LayerNorm's route; and f32
weights under bf16 (and f16) activations against the JAX
`layer_norm_fused`, run in interpret mode under a working stand-in for
`jax.experimental.disable_x64` (jax releases without the name fail the
module's import), removed at teardown.

Tolerances are the kernels' rules (`PERF.md` §2): f32 1e-5 x
(1 + max|ref|); bf16 2 ulps + 1e-5 x max|ref|; f16 2 f16 ulps + 1e-5 x
(1 + max|ref|), element by element (the two frameworks sum in other
orders, and bf16 rounds their f32 results).
"""
import contextlib
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional import norm as tnorm
from paddle_tpu_torch.ops.cuda import layer_norm as tln

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
ULPS, F32_TOL = 2, 1e-5
_DT = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
       torch.float16: np.float16}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


@contextlib.contextmanager
def _disable_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def jln():
    """The JAX Pallas LayerNorm module in interpret mode and the JAX
    functional norm module, importable under a working stand-in for
    `jax.experimental.disable_x64`; both undone, and the Pallas module
    dropped, at teardown."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64", _disable_x64, raising=False)
    try:
        from paddle_tpu.nn.functional import norm as jnorm
        from paddle_tpu.ops.pallas import layer_norm as mod
        mp.setattr(mod, "_INTERPRET", True)
        yield mod, jnorm
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def _ulp(x, dtype):
    _, e = torch.frexp(x.abs())
    ulp = torch.ldexp(torch.ones_like(x), e - (8 if dtype == torch.bfloat16
                                               else 11))
    if dtype == torch.float16:
        ulp = torch.clamp(ulp, min=2.0 ** -24)
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def _within_rule(got, want):
    dtype = got.dtype
    got, want = got.float(), want.float()
    ref_max = want.abs().max().item()
    if dtype == torch.bfloat16:
        allowed = ULPS * _ulp(want, dtype) + F32_TOL * ref_max
    elif dtype == torch.float16:
        allowed = ULPS * _ulp(want, dtype) + F32_TOL * (1 + ref_max)
    else:
        allowed = torch.full_like(want, F32_TOL * (1 + ref_max))
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert (diff <= allowed).all(), (diff / allowed).max().item()


def _case(shape, dtype, wdtype=None, seed=0):
    rs = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    c = shape[-1]
    wdtype = dtype if wdtype is None else wdtype
    return ((mk(*shape) * 2 + 1).to(dtype), mk(c).to(wdtype),
            mk(c).to(wdtype), mk(*shape).to(dtype))


def _jax(t):
    return jnp.asarray(t.float().numpy().astype(_DT[t.dtype]))


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)


_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", _DTYPES)
def test_route_is_the_jax_rule_plus_the_16_byte_widths(jln, dtype):
    """At every width from 64 to 65536 (and a few past it), the port's
    kernels take what the JAX rule takes, and besides exactly the widths
    that are a multiple of 16 bytes but not of 128 (which K1 has always
    taken); at every 61st width the weights' dtype (f32, bf16 or f16)
    changes neither rule."""
    pln = jln[0]
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    widths = list(range(64, 65537)) + [65537, 65544, 65664, 131072]
    for c in widths:
        x = torch.empty((2, c), dtype=dtype, device="meta")
        w = torch.empty((c,), dtype=dtype, device="meta")
        jx = jax.ShapeDtypeStruct((2, c), _JDT[dtype])
        jw = jax.ShapeDtypeStruct((c,), _JDT[dtype])
        jax_rule = bool(pln.supported(jx, jw, jw, 1))
        assert tln.supported(x, w, w, 1) == (
            jax_rule or (c % vec == 0 and c <= 65536)), c
        # neither rule reads w's dtype beyond the three the kernels take
        if c % 61 == 0:
            for wdtype in _DTYPES:
                jw2 = jax.ShapeDtypeStruct((c,), _JDT[wdtype])
                w2 = torch.empty((c,), dtype=wdtype, device="meta")
                assert bool(pln.supported(jx, jw2, jw2, 1)) == jax_rule
                assert tln.supported(x, w2, w2, 1) == tln.supported(
                    x, w, w, 1)
    x = torch.empty((2, 256), dtype=dtype, device="meta")
    w = torch.empty((256,), dtype=dtype, device="meta")
    assert not tln.supported(x, w, w, 2) and not tln.supported(x, None,
                                                                None, 1)
    # w and b of two dtypes: both rules take them (the kernels convert
    # both to f32, as the JAX kernels cast each)
    jx = jax.ShapeDtypeStruct((2, 256), _JDT[dtype])
    for wdtype, bdtype in ((torch.float32, torch.bfloat16),
                           (torch.float16, torch.float32)):
        w2 = torch.empty((256,), dtype=wdtype, device="meta")
        b2 = torch.empty((256,), dtype=bdtype, device="meta")
        assert tln.supported(x, w2, b2, 1)
        assert pln.supported(jx, jax.ShapeDtypeStruct((256,), _JDT[wdtype]),
                             jax.ShapeDtypeStruct((256,), _JDT[bdtype]), 1)
    # a 1-D x: neither rule takes it
    x1 = torch.empty((256,), dtype=dtype, device="meta")
    assert not tln.supported(x1, w, w, 1)
    assert not pln.supported(jax.ShapeDtypeStruct((256,), _JDT[dtype]), w,
                             w, 1)
    x64 = torch.empty((2, 256), dtype=torch.float64, device="meta")
    assert not tln.supported(x64, w, w, 1)
    assert not pln.supported(jax.ShapeDtypeStruct((2, 256), jnp.float64),
                             w, w, 1)


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (3, 5, 100)), (torch.bfloat16, (4, 36)),
    (torch.float16, (6, 100)), (torch.float32, (3, 98)),
    (torch.float32, (2, 3, 37))])
def test_jnp_branch_port_equals_the_jax_jnp_branch(jln, monkeypatch, dtype,
                                                   shape):
    """At widths that are not a multiple of 16 bytes the functional
    LayerNorm is `_ln_jnp`, and it equals the JAX `_ln_fwd` on its jnp
    branch (PADDLE_TPU_FUSED_LN=0): y and the gradients of x, w and b."""
    jnorm = jln[1]
    monkeypatch.setenv("PADDLE_TPU_FUSED_LN", "0")
    x, w, b, dy = _case(shape, dtype, seed=len(shape) + shape[-1])
    assert not tln.supported(x, w, b, 1)
    y, vjp = jax.vjp(lambda x_, w_, b_: jnorm._ln_fwd(x_, w_, b_, 1, 1e-5),
                     _jax(x), _jax(w), _jax(b))
    want = [_torch(a, dtype) for a in (y, *vjp(_jax(dy)))]
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    got = PF.layer_norm(xg, shape[-1], wg, bg)
    got.backward(dy)
    assert got.dtype == dtype
    for g, r in zip((got.detach(), xg.grad, wg.grad, bg.grad), want):
        assert g.dtype == dtype
        _within_rule(g, r)


def test_functional_layer_norm_routes_by_shape(monkeypatch):
    """A width the kernels take goes through LayerNormFunction, one they
    do not take (or f64, or without affine parameters) through
    `_ln_jnp`; either way before anything launches."""
    calls = []
    real = tnorm._ln_jnp
    monkeypatch.setattr(tnorm, "_ln_jnp",
                        lambda *a: calls.append("jnp") or real(*a))
    monkeypatch.setattr(
        tnorm.LayerNormFunction, "apply",
        staticmethod(lambda *a: calls.append("kernels")
                     or tln.layer_norm_reference(*a)))
    for dtype, c, route in ((torch.bfloat16, 104, "kernels"),
                            (torch.bfloat16, 100, "jnp"),
                            (torch.float32, 100, "kernels"),
                            (torch.float32, 98, "jnp"),
                            (torch.float64, 128, "jnp")):
        x, w, b, _ = _case((3, c), dtype)
        calls.clear()
        PF.layer_norm(x, c, w, b)
        assert calls == [route], (dtype, c)
    calls.clear()
    PF.layer_norm(x, c)
    assert calls == ["jnp"]


@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.float32),
                                          (torch.float16, torch.float32),
                                          (torch.float32, torch.bfloat16)])
def test_weights_of_another_dtype_equal_the_jax_fused_path(jln, dtype,
                                                           wdtype):
    """w and b of another dtype than x: the port's LayerNorm (the layer
    and the function) against the JAX `layer_norm_fused` forward and VJP
    in interpret mode, y and dx in x's dtype, dw and db in w's."""
    from paddle_tpu_torch.nn import LayerNorm
    pln = jln[0]
    x, w, b, dy = _case((40, 256), dtype, wdtype, seed=7)
    y, vjp = jax.vjp(lambda x_, w_, b_: pln.layer_norm_fused(
        x_, w_, b_, 1e-5, 16), _jax(x), _jax(w), _jax(b))
    grads = vjp(_jax(dy))
    want = [_torch(y, dtype), _torch(grads[0], dtype),
            *(_torch(g, wdtype) for g in grads[1:])]
    assert [np.asarray(a).dtype for a in (y, *grads)] == \
        [_DT[dtype], _DT[dtype], _DT[wdtype], _DT[wdtype]]
    layer = LayerNorm(256, dtype=wdtype)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    xg = x.clone().requires_grad_(True)
    out = layer(xg)
    out.backward(dy)
    got = (out.detach(), xg.grad, layer.weight.grad, layer.bias.grad)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype
        _within_rule(g, r)


@pytest.mark.parametrize("dtype,wdtype,bdtype", [
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float16)])
def test_w_and_b_of_two_dtypes_equal_the_jax_fused_forward(jln, dtype,
                                                           wdtype, bdtype):
    """w and b of two dtypes take the kernels' route: the port's
    LayerNorm equals the JAX `layer_norm_fused` forward (interpret mode,
    which casts w and b to f32 each) within the rule, y in x's dtype, and
    each parameter's gradient comes back in its own dtype."""
    pln = jln[0]
    x, w, _, dy = _case((24, 256), dtype, wdtype, seed=11)
    b = torch.from_numpy(np.random.RandomState(12).randn(256).astype(
        np.float32)).to(bdtype)
    assert tln.supported(x, w, b, 1)
    want = _torch(pln.layer_norm_fused(_jax(x), _jax(w), _jax(b), 1e-5, 8),
                  dtype)
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = PF.layer_norm(xg, 256, wg, bg)
    y.backward(dy)
    assert y.dtype == xg.grad.dtype == dtype
    assert (wg.grad.dtype, bg.grad.dtype) == (wdtype, bdtype)
    _within_rule(y.detach(), want)


def test_one_axis_x_takes_the_jnp_branch(jln, monkeypatch):
    """A 1-D x goes to `_ln_jnp`, as the JAX rule (x.ndim >= 2) sends it
    to jnp, and equals the JAX `_ln_fwd` there."""
    jnorm = jln[1]
    monkeypatch.setenv("PADDLE_TPU_FUSED_LN", "0")
    x, w, b, _ = _case((256,), torch.float32, seed=13)
    assert not tln.supported(x, w, b, 1)
    calls = []
    real = tnorm._ln_jnp
    monkeypatch.setattr(tnorm, "_ln_jnp",
                        lambda *a: calls.append("jnp") or real(*a))
    got = PF.layer_norm(x, 256, w, b)
    assert calls == ["jnp"]
    want = _torch(jnorm._ln_fwd(_jax(x), _jax(w), _jax(b), 1, 1e-5),
                  torch.float32)
    _within_rule(got, want)
