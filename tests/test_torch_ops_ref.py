"""The port's plain kernel versions held against the JAX package.

K1 (`layer_norm_reference`) against the JAX `F.layer_norm`, K6
(`ragged_attention_reference`) against the JAX
`ragged_attention_reference`, and the paged KV write
(`_paged_flat_slots` / `paged_scatter`) against the JAX scatter. Inputs
are made with numpy from a seed and handed to both frameworks.
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.cuda import layer_norm as tln
from paddle_tpu_torch.ops.cuda import paged_attention as tpa

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def jax_ln_importable():
    """Let the JAX LayerNorm be called on this jax.

    `paddle_tpu/ops/pallas/layer_norm.py` imports
    `jax.experimental.disable_x64` at module level, and `_ln_fwd` imports
    that module before it checks the platform; jax releases without the
    name fail every JAX LayerNorm with ImportError. This fixture puts a
    stand-in there that raises if it is ever entered (on the CPU the
    Pallas path must not run; `PADDLE_TPU_FUSED_LN=0` keeps the JAX
    LayerNorm on its jnp path), and at teardown removes the stand-in and
    the module imported under it, so other test files in the same
    process see the package exactly as before."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    # the jnp path is the oracle even where another test module has set
    # PADDLE_TPU_PALLAS_INTERPRET=1 for the whole process
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


# -- K1 ------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_reference_matches_jax(jax_ln_importable, dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 6, 256) * 3.0 + 1.5).astype(np.float32)
    w = rs.randn(256).astype(np.float32)
    b = rs.randn(256).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = paddle.nn.functional.layer_norm(
        paddle.to_tensor(jnp.asarray(x, jdt)), 256,
        paddle.to_tensor(jnp.asarray(w, jdt)),
        paddle.to_tensor(jnp.asarray(b, jdt)), epsilon=1e-5)
    want = np.asarray(jnp.asarray(want._value, jnp.float32))
    got = tln.layer_norm(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt),
                         torch.from_numpy(b).to(tdt), 1e-5)
    assert got.dtype == tdt
    # f32: the JAX CPU path takes shifted one-pass statistics, the
    # kernel's plain version two-pass ones — both f32, so they differ
    # by f32 rounding only. bf16: one bf16 ulp of the output (|y| < 16).
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=1e-2, atol=6e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


# -- K6 ------------------------------------------------------------------
def _ragged_case(h, hkv, seed=0):
    rs = np.random.RandomState(seed)
    b, lq, d, ps, mp = 5, 6, 16, 8, 4
    n_pages = 1 + b * mp
    # page tables in non-monotone page order; row 0 idle on the trash page
    perm = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = perm.reshape(b, mp)
    table[0] = 0
    pos = np.array([0, 7, 15, 0, 20], np.int32)       # near 0, page ends
    q_len = np.array([0, 1, 3, 6, 6], np.int32)       # idle .. full chunk
    q = rs.randn(b, lq, h, d).astype(np.float32)
    k = rs.randn(n_pages, ps, hkv, d).astype(np.float32)
    v = rs.randn(n_pages, ps, hkv, d).astype(np.float32)
    return q, k, v, table, pos, q_len


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_ragged_attention_reference_matches_jax(h, hkv):
    q, k, v, table, pos, q_len = _ragged_case(h, hkv)
    want = np.asarray(jpa.ragged_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(pos), jnp.asarray(q_len)))
    got = tpa.ragged_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, table, pos, q_len)))
    got = got.numpy()
    assert np.isfinite(got).all()
    live = np.arange(q.shape[1])[None, :] < q_len[:, None]     # [B, lq]
    # both f32 softmax attention; only the summation order differs
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-6)


def test_ragged_attention_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _ragged_case(4, 2)]
    before = tpa.LAUNCHES
    out = tpa.ragged_paged_attention(*args)
    assert tpa.LAUNCHES == before
    torch.testing.assert_close(out, tpa.ragged_attention_reference(*args),
                               rtol=0, atol=0)
    # a zero additive mask changes nothing; the mask lane is the plain
    # version's too, on the CPU
    torch.testing.assert_close(
        tpa.ragged_paged_attention(*args, mask=torch.zeros(1)), out, rtol=0,
        atol=0)
    assert tpa.LAUNCHES == before


# -- the paged KV write ----------------------------------------------------
def test_paged_scatter_matches_jax_including_trash_redirects():
    rs = np.random.RandomState(1)
    ps, mp, h, d, l = 8, 3, 2, 4, 6
    n_pages = 6
    pool = rs.randn(n_pages, ps, h, d).astype(np.float32)
    # row 0 in its window; row 1 runs past its addressable window
    # (positions 24, 25 -> trash slots 0, 1); row 2 is idle on the
    # trash page (trash slots 2..7) — no two writes share a slot
    table = np.array([[3, 1, 4], [5, 2, 1], [0, 0, 0]], np.int32)
    pos = np.array([2, 20, 2], np.int32)
    upd = rs.randn(3, l, h, d).astype(np.float32)
    want_slots = np.asarray(jpa._paged_flat_slots(
        ps, jnp.asarray(pos), jnp.asarray(table), l))
    got_slots = tpa._paged_flat_slots(ps, torch.from_numpy(pos),
                                      torch.from_numpy(table), l)
    np.testing.assert_array_equal(got_slots.numpy(), want_slots)
    assert set(want_slots[1, 4:]) == {0, 1}
    want = np.asarray(jpa.paged_scatter(jnp.asarray(pool), jnp.asarray(upd),
                                        jnp.asarray(pos),
                                        jnp.asarray(table)))
    tpool = torch.from_numpy(pool.copy())
    out = tpa.paged_scatter(tpool, torch.from_numpy(upd),
                            torch.from_numpy(pos), torch.from_numpy(table))
    assert out is tpool                      # written in place
    np.testing.assert_array_equal(tpool.numpy(), want)
