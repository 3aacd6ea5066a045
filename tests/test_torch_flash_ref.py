"""The port's plain flash attention versions held against the JAX package.

`flash_attention_reference` / `flash_bwd_reference` (the plain versions
of K3-K5) against the JAX `_ref_blhd` and `_sdpa_ref` and their
`jax.vjp`, in f32, and `dropout_keep` against the JAX `dropout_keep` bit
for bit. Inputs are made with numpy from a seed and handed to both
frameworks.
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.functional import attention as jattn
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

_PALLAS_FA = "paddle_tpu.ops.pallas.flash_attention"
# both sides f32; only the summation order differs
TOL = 1e-5


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("a Pallas kernel ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def jfa():
    """The JAX flash attention module, imported under a stand-in
    `jax.experimental.disable_x64` (jax releases without the name fail
    the import) that raises if entered: only its plain functions run
    here. The stand-in and the module imported under it are removed at
    teardown."""
    had_module = _PALLAS_FA in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    try:
        import importlib
        yield importlib.import_module(_PALLAS_FA)
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_FA, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "flash_attention" in vars(pkg):
                delattr(pkg, "flash_attention")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * (1.0 + np.abs(want).max()), err


def _case(lq, lk, b=2, h=3, d=16, seed=0):
    rs = np.random.RandomState(seed)
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    return mk(b, lq, h, d), mk(b, lk, h, d), mk(b, lk, h, d), mk(b, lq, h, d)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk", [(24, 24), (37, 53), (20, 37)])
def test_flash_reference_matches_ref_blhd_and_its_vjp(jfa, causal, lq, lk):
    q, k, v, do = _case(lq, lk)
    scale = float(1.0 / np.sqrt(q.shape[-1]))

    def ref(q, k, v):
        return jfa._ref_blhd(q, k, v, causal, scale)

    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = tfa.flash_attention_reference(tq, tk, tv, causal=causal)
    assert lse.shape == (q.shape[0] * q.shape[2], lq)
    assert lse.dtype == torch.float32
    _close(o.numpy(), want)
    grads = tfa.flash_bwd_reference(tq, tk, tv, o, lse, tdo, causal=causal)
    for got, w in zip(grads, want_grads):
        _close(got.numpy(), w)


def test_causal_rows_that_see_no_key_are_zero(jfa):
    """Lq > Lk, causal: query i sees keys j <= i - (Lq - Lk). The rows
    that see at least one key match the JAX reference; the first
    Lq - Lk rows see none and are 0, with lse -inf and no gradient."""
    lq, lk = 30, 18
    q, k, v, do = _case(lq, lk, seed=1)
    want = jfa._ref_blhd(*(jnp.asarray(a) for a in (q, k, v)), True,
                         1.0 / np.sqrt(q.shape[-1]))
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = tfa.flash_attention_reference(tq, tk, tv, causal=True)
    dead = lq - lk
    _close(o.numpy()[:, dead:], np.asarray(want)[:, dead:])
    assert not o[:, :dead].any()
    assert torch.isneginf(lse.view(2, 3, lq)[:, :, :dead]).all()
    dq, dk, dv = tfa.flash_bwd_reference(tq, tk, tv, o, lse, tdo,
                                         causal=True)
    assert torch.isfinite(dq).all() and not dq[:, :dead].any()


@pytest.mark.parametrize("operand", ["bias", "kvec", "head_keys",
                                     "two_axes"])
@pytest.mark.parametrize("causal", [False, True])
def test_mask_operands_match_sdpa_ref(operand, causal):
    lq, lk, b, h = 21, 29, 2, 3
    q, k, v, do = _case(lq, lk, b=b, h=h, seed=2)
    rs = np.random.RandomState(3)
    if operand == "bias":          # per-head additive bias [1, H, Lq, Lk]
        mask = rs.randn(1, h, lq, lk).astype(np.float32)
    elif operand == "kvec":         # padding mask [B, 1, 1, Lk]
        mask = np.where(rs.rand(b, 1, 1, lk) < 0.3, -1e30, 0.0).astype(
            np.float32)
    elif operand == "head_keys":    # per-head key mask [B, H, 1, Lk]
        mask = np.where(rs.rand(b, h, 1, lk) < 0.3, -1e30, 0.0).astype(
            np.float32)
    else:                           # one bias for every row [Lq, Lk]
        mask = rs.randn(lq, lk).astype(np.float32)
    scale = float(1.0 / np.sqrt(q.shape[-1]))

    def ref(q, k, v):
        return jattn._sdpa_ref(q, k, v, jnp.asarray(mask), causal, scale,
                               0.0, None)

    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    kind, op = PF.attention._mask_to_kernel_operands(
        torch.from_numpy(mask), b, h, lq, lk)
    assert kind == ("kvec" if operand == "kvec" else "bias")
    ops = dict(bias=op if kind == "bias" else None,
               kvec=op if kind == "kvec" else None)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = tfa.flash_attention_reference(tq, tk, tv, causal=causal, **ops)
    _close(o.numpy(), want)
    grads = tfa.flash_bwd_reference(tq, tk, tv, o, lse, tdo, causal=causal,
                                    **ops)
    for got, w in zip(grads, want_grads):
        _close(got.numpy(), w)


SEEDS = [(0, 0), (1, 2), (-1, 7), (-2 ** 31, 2 ** 31 - 1),
         (123456789, -987654321)]


@pytest.mark.parametrize("seed0,seed1", SEEDS)
def test_dropout_keep_is_the_jax_hash_bit_for_bit(jfa, seed0, seed1):
    rs = np.random.RandomState(4)
    bh = np.array([0, 1, 5, 191, 1000, 65535], np.int32)[:, None, None]
    q_pos = rs.randint(0, 4096, size=(1, 40, 1)).astype(np.int32)
    k_pos = rs.randint(0, 4096, size=(1, 1, 50)).astype(np.int32)
    for p in (0.1, 0.5, 0.9):
        thresh = tfa.drop_threshold(p)
        assert thresh == jfa._drop_thresh(p)
        want = np.asarray(jfa.dropout_keep(
            jnp.int32(seed0), jnp.int32(seed1), jnp.asarray(bh),
            jnp.asarray(q_pos), jnp.asarray(k_pos), thresh))
        got = tfa.dropout_keep(seed0, seed1, *_t(bh, q_pos, k_pos), thresh)
        np.testing.assert_array_equal(got.numpy(), want)
        assert abs(want.mean() - (1 - p)) < 0.02


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_forward_and_backward_match_jnp_from_the_mask(jfa, causal):
    """Softmax, then the hash's keep mask scaled by 1/(1-p); the
    normaliser is the undropped row sum."""
    lq, lk, b, h, p = 19, 23, 2, 3, 0.3
    q, k, v, do = _case(lq, lk, b=b, h=h, seed=5)
    seeds = np.array([-5, 77], np.int32)
    scale = float(1.0 / np.sqrt(q.shape[-1]))
    keep = jfa.dropout_keep(
        jnp.int32(seeds[0]), jnp.int32(seeds[1]),
        jnp.arange(b * h, dtype=jnp.int32).reshape(b, h, 1, 1),
        jnp.arange(lq, dtype=jnp.int32).reshape(1, 1, lq, 1),
        jnp.arange(lk, dtype=jnp.int32).reshape(1, 1, 1, lk),
        jfa._drop_thresh(p))

    def ref(q, k, v):
        s = jnp.einsum("blhd,bmhd->bhlm", q, k) * scale
        if causal:
            s = jnp.where(jnp.tril(jnp.ones((lq, lk), bool), lk - lq), s,
                          -1e30)
        probs = jax.nn.softmax(s, axis=-1)
        probs = jnp.where(keep, probs * (1.0 / (1.0 - p)), 0.0)
        return jnp.einsum("bhlm,bmhd->blhd", probs, v)

    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo, ts = _t(q, k, v, do, seeds)
    o, lse = tfa.flash_attention_reference(tq, tk, tv, seeds=ts,
                                           causal=causal, dropout_p=p)
    _close(o.numpy(), want)
    grads = tfa.flash_bwd_reference(tq, tk, tv, o, lse, tdo, seeds=ts,
                                    causal=causal, dropout_p=p)
    for got, w in zip(grads, want_grads):
        _close(got.numpy(), w)


@pytest.mark.parametrize("dropout_p", [0.0, 0.25])
def test_flash_attention_blhd_gradcheck_f64(dropout_p):
    """The autograd function's backward (the plain K4/K5) is the
    derivative of its forward (the plain K3), in f64."""
    rs = np.random.RandomState(6)
    mk = lambda *s: torch.from_numpy(rs.randn(*s)).requires_grad_(True)
    q, k, v = mk(2, 5, 2, 8), mk(2, 7, 2, 8), mk(2, 7, 2, 8)
    bias = torch.from_numpy(rs.randn(2, 1, 5, 7))
    seeds = torch.tensor([3, -4], dtype=torch.int32)
    fn = lambda q, k, v: tfa.flash_attention_blhd(
        q, k, v, bias, None, seeds, True, None, dropout_p)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_sdpa_routes_and_raises_like_the_jax_package():
    """At a head dim the kernels take (64 here), a frozen mask goes to
    the flash op's operands, whatever its broadcast shape; a trainable
    one to the plain `_sdpa_ref` (the kernels give no bias gradient);
    dropout outside training is off. (Other head dims take `_sdpa_ref`:
    test_torch_head_dims.py.)"""
    q, k, v, _ = _case(6, 6, d=64, seed=7)
    tq, tk, tv = _t(q, k, v)
    calls = []
    orig = PF.attention.flash_attention_blhd

    def spy(*args, **kw):
        calls.append(kw)
        return orig(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(PF.attention, "flash_attention_blhd", spy)
    try:
        mask = torch.zeros(2, 1, 1, 6)
        PF.scaled_dot_product_attention(tq, tk, tv, mask, dropout_p=0.5,
                                        training=False)
        assert len(calls) == 1 and calls[0]["dropout_p"] == 0.0
        out = PF.scaled_dot_product_attention(
            tq, tk, tv, mask.clone().requires_grad_(True))
        assert len(calls) == 1
        out.sum().backward()
        # a per-head key mask rides the bias operand, broadcast over the
        # queries; a mask that does not broadcast raises
        PF.scaled_dot_product_attention(tq, tk, tv, torch.zeros(2, 3, 1, 6))
        assert len(calls) == 2
        with pytest.raises(ValueError, match="does not broadcast"):
            PF.scaled_dot_product_attention(tq, tk, tv,
                                            torch.zeros(2, 2, 1, 6))
        gen = torch.Generator().manual_seed(0)
        PF.scaled_dot_product_attention(tq, tk, tv, dropout_p=0.1,
                                        is_causal=True, generator=gen)
        assert calls[-1]["dropout_p"] == 0.1 and calls[-1]["causal"]
    finally:
        mp.undo()
