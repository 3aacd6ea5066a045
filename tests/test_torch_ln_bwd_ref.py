"""The port's plain LayerNorm backward (K2) held against the JAX package.

`layer_norm_bwd_reference` against `jax.vjp` of the JAX `_ln_fwd` on
its jnp path, and an f64 `gradcheck` of `LayerNormFunction` (K1 forward,
K2 backward; their plain versions on the CPU).
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import norm as jnorm
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.cuda import layer_norm as tln

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def jax_ln_importable():
    """A stand-in `jax.experimental.disable_x64` that raises if entered
    (jax releases without the name fail every JAX LayerNorm), with
    `PADDLE_TPU_FUSED_LN=0` holding the JAX side on its jnp path; both
    are removed at teardown, with the module imported under them."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    try:
        yield
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def _case(shape, seed=0):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    return (x, rs.randn(c).astype(np.float32), rs.randn(c).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(4, 6, 256), (5, 768), (3, 7, 96)])
def test_ln_bwd_reference_matches_jax_vjp(jax_ln_importable, shape):
    x, w, b, dy = _case(shape)
    _, vjp = jax.vjp(lambda x, w, b: jnorm._ln_fwd(x, w, b, 1, 1e-5),
                     *(jnp.asarray(a) for a in (x, w, b)))
    want = vjp(jnp.asarray(dy))
    got = tln.layer_norm_bwd_reference(*(torch.from_numpy(a)
                                         for a in (dy, x, w)), 1e-5)
    # both f32: the JAX side takes one-pass shifted statistics and
    # autodiff, the port two-pass statistics and the closed form; dw and
    # db sum over up to 24 rows
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5)


def test_layer_norm_function_gradcheck_f64():
    rs = np.random.RandomState(1)
    mk = lambda *s: torch.from_numpy(rs.randn(*s)).requires_grad_(True)
    x, w, b = mk(3, 5, 24), mk(24), mk(24)
    assert torch.autograd.gradcheck(
        lambda x, w, b: tln.LayerNormFunction.apply(x, w, b, 1e-5),
        (x, w, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_layer_backward_is_k2s_plain_version(dtype):
    """The layer goes through LayerNormFunction: its gradients are
    exactly `layer_norm_bwd_reference`'s, dw and db in w's dtype."""
    x, w, b, dy = (torch.from_numpy(a).to(dtype)
                   for a in _case((2, 9, 128), seed=2))
    layer = LayerNorm(128, dtype=dtype)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
    xg = x.clone().requires_grad_(True)
    y = layer(xg)
    assert y.grad_fn is not None and y.dtype == dtype
    y.backward(dy)
    dx, dw, db = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)
    for got, want in ((xg.grad, dx), (layer.weight.grad, dw),
                      (layer.bias.grad, db)):
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_functional_layer_norm_without_affine_or_over_two_axes():
    """Cases the kernels do not take stay plain torch, as the JAX
    package leaves them to jnp."""
    x = torch.from_numpy(_case((3, 4, 8), seed=3)[0]).requires_grad_(True)
    y = PF.layer_norm(x, 8)
    want = torch.nn.functional.layer_norm(x, (8,), eps=1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    w = torch.ones(4, 8)
    y2 = PF.layer_norm(x, (4, 8), w, torch.zeros(4, 8))
    want2 = torch.nn.functional.layer_norm(x, (4, 8), eps=1e-5)
    torch.testing.assert_close(y2, want2, rtol=1e-5, atol=1e-5)
    y2.sum().backward()
    assert x.grad is not None
    with pytest.raises(ValueError, match="both or neither"):
        PF.layer_norm(x, 8, w[0])
