"""The user-mask lane of ragged paged attention (K6/K7) and the mask on
every paged branch of `update_and_attend`, against the JAX package.

A user mask (bool, or additive f32, broadcastable to [B, H, lq, lmax])
becomes the additive [B, H, lq, lmax] mask of `_mask_to_additive` (its
`lq` argument) and is added to the scores after the ragged window, in
K6's plain version (`ragged_attention_reference(mask=)`), in K7's
(`ragged_attention_reference_q8(mask=)`) and under the grouped op,
which falls back to the ungrouped one as the JAX op does. Then
`update_and_attend(attn_mask=)` on the ragged (`q_len`) branch, with
and without prefix groups, and on the int8 single-token branch — the
two branches that raised before (ROADMAP queue 3, F5) — against the JAX
function: output and written pools. f32 at rep 1 and rep 2; the JAX
side runs its jnp paths.
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.nlp import generation as tgen
from paddle_tpu_torch.ops.cuda import paged_attention as tpa

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# f32: the JAX test's own tolerance (tests/test_paged_attention.py)
RTOL, ATOL = 2e-5, 2e-6


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("a Pallas kernel ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def jax_jnp():
    """The JAX generation module with the jnp paths held on."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setattr(jpa, "_INTERPRET", False)
    try:
        from paddle_tpu.nlp import generation as jgen
        yield jgen
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def _batch(seed, rep, lq=5, b=4, hkv=2, d=16, ps=8, mp=4, q8=False):
    """q [b, lq, hkv*rep, d]; pools of b*mp + 1 pages of ps (int8 codes
    with f32 scales for q8); shuffled full tables; rows idle (q_len 0),
    decoding (1), partial and full-width prefill."""
    rs = np.random.RandomState(seed)
    h = hkv * rep
    n_pages = b * mp + 1
    q = rs.randn(b, lq, h, d).astype(np.float32)
    if q8:
        k = rs.randint(-127, 128, (n_pages, ps, hkv, d)).astype(np.int8)
        v = rs.randint(-127, 128, (n_pages, ps, hkv, d)).astype(np.int8)
        scales = tuple((rs.rand(n_pages, ps, hkv) * 0.02).astype(np.float32)
                       for _ in range(2))
    else:
        k, v = (rs.randn(n_pages, ps, hkv, d).astype(np.float32)
                for _ in range(2))
        scales = None
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        b, mp)
    pos = np.array([0, 7, 3, 20], np.int32)[:b]
    q_len = np.array([0, 1, 3, lq], np.int32)[:b]
    return q, k, v, scales, table, pos, q_len


def _mask(kind, shape, seed):
    rs = np.random.RandomState(seed)
    if kind == "bool":
        m = rs.rand(*shape) < 0.7
        m[..., 0] = True
        return m
    return rs.randn(*shape).astype(np.float32)


def _live(q_len, lq):
    return np.arange(lq)[None, :] < q_len[:, None]


@pytest.mark.parametrize("lq", [1, 5])
@pytest.mark.parametrize("shape", [(4, 4, 5, 32), (1, 4, 1, 32),
                                   (4, 1, 5, 32), (32,)])
def test_mask_to_additive_matches_jax(shape, lq):
    shape = tuple(1 if (s == 5 and lq == 1) else s for s in shape)
    for kind in ("bool", "additive"):
        m = _mask(kind, shape, 3)
        got = tpa._mask_to_additive(torch.from_numpy(m), 4, 4, 32, lq)
        want = jpa._mask_to_additive(jnp.asarray(m), 4, 4, 32, lq)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("q8", [False, True])
def test_ragged_mask_lane_matches_jax(q8, rep, kind):
    """K6's (K7's) plain version with a user mask against the JAX op, in
    each broadcast form; the grouped op under a mask is the ungrouped
    op, bit for bit (the JAX fallback)."""
    q, k, v, scales, table, pos, q_len = _batch(5, rep, q8=q8)
    b, lq, h, _ = q.shape
    lmax = table.shape[1] * k.shape[1]
    live = _live(q_len, lq)
    gid = np.zeros(b, np.int32)
    gld, gcn = np.zeros(b, np.int32), np.array([1, 0, 0, 0], np.int32)
    for shape in ((b, h, lq, lmax), (1, h, 1, lmax), (b, 1, lq, lmax)):
        m = _mask(kind, shape, 7)
        t = [torch.from_numpy(a) for a in (q, k, v, table, pos, q_len)]
        j = [jnp.asarray(a) for a in (q, k, v, table, pos, q_len)]
        if q8:
            ts = [torch.from_numpy(s) for s in scales]
            js = [jnp.asarray(s) for s in scales]
            got = tpa.ragged_paged_attention_q8(t[0], t[1], t[2], *ts,
                                                *t[3:], torch.from_numpy(m))
            want = jpa.ragged_paged_attention_q8(j[0], j[1], j[2], *js,
                                                 *j[3:], jnp.asarray(m))
            grouped = tpa.ragged_paged_attention_grouped_q8(
                t[0], t[1], t[2], *ts, *t[3:],
                *(torch.from_numpy(a) for a in (gid, gld, gcn)),
                mask=torch.from_numpy(m))
        else:
            got = tpa.ragged_paged_attention(*t, torch.from_numpy(m))
            want = jpa.ragged_paged_attention(*j, jnp.asarray(m))
            grouped = tpa.ragged_paged_attention_grouped(
                *t, *(torch.from_numpy(a) for a in (gid, gld, gcn)),
                mask=torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], rtol=RTOL,
                                   atol=ATOL)
        assert torch.equal(grouped, got)
        assert torch.isfinite(got).all()


def test_a_mask_that_hides_all_but_key_0_returns_value_0():
    q, k, v, _, table, pos, q_len = _batch(9, 2)
    b, lq, h, _ = q.shape
    lmax = table.shape[1] * k.shape[1]
    m = np.zeros((b, 1, 1, lmax), bool)
    m[..., 0] = True
    out = tpa.ragged_paged_attention(
        *(torch.from_numpy(a) for a in (q, k, v, table, pos, q_len)),
        mask=torch.from_numpy(m))
    v0 = v[table[:, 0], 0]                      # [b, hkv, d]
    want = np.repeat(v0, 2, axis=1)[:, None].repeat(lq, 1)
    live = _live(q_len, lq)
    np.testing.assert_allclose(out.numpy()[live], want[live], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("branch", ["ragged", "ragged_grouped",
                                    "ragged_q8", "q8_single_token"])
def test_update_and_attend_with_a_user_mask_matches_jax(jax_jnp, branch,
                                                        kind):
    """The two branches ROADMAP queue 3's F5 names (the ragged branch,
    here with and without groups, over float and int8 pools; the int8
    single-token branch) take a user mask over the cache axis as the
    JAX function does."""
    from paddle_tpu.core.tensor import Tensor as JT
    q8 = "q8" in branch
    single = branch == "q8_single_token"
    lq = 1 if single else 5
    q, k, v, scales, table, pos, q_len = _batch(11, 2, lq=lq, q8=q8)
    b, _, h, d = q.shape
    rs = np.random.RandomState(12)
    kn, vn = (rs.randn(b, lq, k.shape[2], d).astype(np.float32)
              for _ in range(2))
    lmax = table.shape[1] * k.shape[1]
    m = _mask(kind, (b, 1, 1, lmax), 13)
    group = None
    if branch == "ragged_grouped":
        group = (np.zeros(b, np.int32), np.zeros(b, np.int32),
                 np.array([1, 0, 0, 0], np.int32))
    jkw = dict(page_table=JT(jnp.asarray(table)), attn_impl="kernel")
    tkw = dict(page_table=torch.from_numpy(table), attn_impl="kernel")
    if not single:
        jkw["q_len"] = JT(jnp.asarray(q_len))
        tkw["q_len"] = torch.from_numpy(q_len)
    if group is not None:
        jkw["group"] = tuple(JT(jnp.asarray(g)) for g in group)
        tkw["group"] = tuple(torch.from_numpy(g) for g in group)
    if q8:
        jkw.update(k_scale=JT(jnp.asarray(scales[0])),
                   v_scale=JT(jnp.asarray(scales[1])))
        tkw.update(k_scale=torch.from_numpy(scales[0].copy()),
                   v_scale=torch.from_numpy(scales[1].copy()))
    jc = jax_jnp.DecodeCache(JT(jnp.asarray(k)), JT(jnp.asarray(v)),
                             JT(jnp.asarray(pos)), **jkw)
    jout, jnew = jax_jnp.update_and_attend(
        JT(jnp.asarray(q)), JT(jnp.asarray(kn)), JT(jnp.asarray(vn)), jc,
        attn_mask=JT(jnp.asarray(m)))
    tc = tgen.DecodeCache(torch.from_numpy(k.copy()),
                          torch.from_numpy(v.copy()),
                          torch.from_numpy(pos), **tkw)
    tout, tnew = tgen.update_and_attend(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tc,
        attn_mask=torch.from_numpy(m))
    live = np.ones((b, lq), bool) if single else _live(q_len, lq)
    np.testing.assert_allclose(tout.numpy()[live],
                               np.asarray(jout._value)[live], rtol=RTOL,
                               atol=ATOL)
    for got, want in ((tnew.k, jnew.k), (tnew.v, jnew.v)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
    if q8:
        for got, want in ((tnew.k_scale, jnew.k_scale),
                          (tnew.v_scale, jnew.v_scale)):
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(want._value))
