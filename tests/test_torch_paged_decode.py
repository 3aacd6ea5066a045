"""The legacy step's ops against the JAX package, on the same numpy inputs.

K9's plain version (`paged_decode_attention` on the CPU, and
`paged_attention_reference`) against the JAX op and reference at rep
1/2/4 and page 8/16, over a partial tail page, an exact page boundary,
pos 0 and a full table, in f32 and bf16, with bool and additive user
masks in every broadcast form of `_mask_to_additive`, and over e4m3
pools; trash rows are finite and isolated. Then the gather branch's
pieces (`paged_kv_gather[_q8]`, `window_causal_mask`,
`decode_merge_mask`, `gqa_decode_attend`), `kv_cache_update`,
`chunk_bucket` and `sample_logits`. The JAX side runs its jnp paths (the
Pallas interpret switch held off).
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving.paging import chunk_bucket as jax_chunk_bucket
from paddle_tpu_torch.nlp import generation as tgen
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving.paging import chunk_bucket

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# f32: the JAX test's own tolerance (tests/test_paged_attention.py)
RTOL, ATOL = 2e-5, 2e-6
# bf16 q and pools: the JAX reference casts the probabilities to bf16
# before the value product and rounds its output to bf16; the port keeps
# the probabilities in f32 (as the kernels do) — a few bf16 ulps of
# outputs of magnitude ~1
BF16_TOL = 3e-2
FP8 = tpa.FP8_DTYPE


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("a Pallas kernel ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def jax_jnp():
    """The JAX generation module, imported with the jnp paths held on:
    the Pallas interpret switch off, and a stand-in
    `jax.experimental.disable_x64` that raises if a Pallas path runs
    (this jax has no such name)."""
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


def _pair(a, dtype="f32"):
    """numpy f32 -> (JAX array, torch tensor) in one dtype."""
    if dtype == "bf16":
        return (jnp.asarray(a.astype(ml_dtypes.bfloat16)),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, pos, rep=1, ps=8, mp=4, hkv=2, d=16):
    """Pools of B * mp + 1 pages (page tables in shuffled order), q
    [B, 1, hkv * rep, d]; every row's table is full, so pages past pos
    hold real values the window must hide."""
    rs = np.random.RandomState(seed)
    b = len(pos)
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    return (rs, rs.randn(b, 1, hkv * rep, d).astype(np.float32),
            rs.randn(n_pages, ps, hkv, d).astype(np.float32),
            rs.randn(n_pages, ps, hkv, d).astype(np.float32),
            table.reshape(b, mp), np.asarray(pos, np.int32))


def _positions(ps, mp):
    """pos 0, a partial tail page, the last slot of a page, the first of
    the next page, and the full table."""
    return [0, ps + 2, ps - 1, 2 * ps, mp * ps - 1]


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_paged_decode_attention_matches_jax(jax_jnp, rep, ps, dtype):
    mp = 4
    _, q, kp, vp, table, pos = _case(rep * 10 + ps, _positions(ps, mp),
                                     rep=rep, ps=ps, mp=mp)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(kp, dtype)
    jv, tv = _pair(vp, dtype)
    want = jpa.paged_decode_attention(jq, jk, jv, jnp.asarray(table),
                                      jnp.asarray(pos))
    got = tpa.paged_decode_attention(tq, tk, tv, torch.from_numpy(table),
                                     torch.from_numpy(pos))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)
    ref = tpa.paged_attention_reference(tq, tk, tv, torch.from_numpy(table),
                                        torch.from_numpy(pos))
    assert torch.equal(ref, got)
    jref = jpa.paged_attention_reference(jq, jk, jv, jnp.asarray(table),
                                         jnp.asarray(pos))
    _close(ref, jref, dtype)


def test_plain_k9_is_k6_at_q_len_1():
    """Without a mask K9's plain version is K6's at q_len 1 (on the card
    the kernels are held to the same, bit for bit)."""
    _, q, kp, vp, table, pos = _case(3, _positions(8, 4), rep=2)
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    ones = torch.ones(len(pos), dtype=torch.int32)
    assert torch.equal(tpa.paged_decode_attention(*args),
                       tpa.ragged_attention_reference(*args, ones))


def test_scalar_pos_is_broadcast(jax_jnp):
    _, q, kp, vp, table, _ = _case(4, [0, 0, 0], rep=2)
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(np.int32(13)))
    got = tpa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table)),
        torch.tensor(13, dtype=torch.int32))
    _close(got, want, "f32")


# every broadcast form of a user mask over [B, H, 1, lmax]
_MASK_SHAPES = {"B11L": lambda b, h, l: (b, 1, 1, l),
                "1H1L": lambda b, h, l: (1, h, 1, l),
                "BH1L": lambda b, h, l: (b, h, 1, l),
                "111L": lambda b, h, l: (1, 1, 1, l),
                "L": lambda b, h, l: (l,),
                "1L": lambda b, h, l: (1, l)}


@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("shape", list(_MASK_SHAPES))
def test_user_mask_matches_jax(jax_jnp, shape, kind):
    rep, ps, mp = 2, 8, 4
    rs, q, kp, vp, table, pos = _case(7, _positions(ps, mp), rep=rep,
                                      ps=ps, mp=mp)
    b, _, h, _ = q.shape
    mshape = _MASK_SHAPES[shape](b, h, mp * ps)
    if kind == "bool":
        m = rs.rand(*mshape) < 0.7
        m[..., 0] = True          # every row keeps a visible key
    else:
        m = (rs.randn(*mshape) * 2.0).astype(np.float32)
    add_j = jpa._mask_to_additive(jnp.asarray(m), b, h, mp * ps)
    add_t = tpa._mask_to_additive(torch.from_numpy(m), b, h, mp * ps)
    assert add_t.shape == (b, h, mp * ps) and add_t.dtype == torch.float32
    np.testing.assert_array_equal(add_t.numpy(), np.asarray(add_j))
    want = jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos)), jnp.asarray(m))
    got = tpa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, pos)),
        torch.from_numpy(m))
    _close(got, want, "f32")


def test_mask_that_hides_all_but_key_0_returns_value_0():
    _, q, kp, vp, table, pos = _case(8, [5, 17, 31], rep=2)
    b, _, h, _ = q.shape
    m = torch.zeros(b, 1, 1, 32, dtype=torch.bool)
    m[..., 0] = True
    got = tpa.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, pos)), m)
    v0 = torch.from_numpy(vp)[torch.from_numpy(table[:, 0]).long(), 0]
    want = v0.repeat_interleave(2, dim=1)[:, None]     # [B, 1, H, D]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_fp8_pools_match_jax(jax_jnp):
    _, q, kp, vp, table, pos = _case(9, _positions(16, 4), rep=2, ps=16)
    k8, v8 = (np.clip(a * 40, -448, 448).astype(ml_dtypes.float8_e4m3fn)
              for a in (kp, vp))
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(table), jnp.asarray(pos))
    tk, tv = (torch.from_numpy(a.view(np.uint8)).view(FP8)
              for a in (k8, v8))
    got = tpa.paged_decode_attention(torch.from_numpy(q), tk, tv,
                                     torch.from_numpy(table),
                                     torch.from_numpy(pos))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_trash_rows_are_finite_and_isolated():
    """A free row (all-trash table, any frozen pos) gives finite output,
    and a poisoned page changes only the row that owns it (the JAX
    test_trash_rows_are_isolated_and_finite)."""
    _, q, kp, vp, table, pos = _case(4, [10, 700, 5], rep=2)
    table[1, :] = 0
    args = lambda k: [torch.from_numpy(a) for a in (q, k, vp, table, pos)]
    base = tpa.paged_decode_attention(*args(kp))
    assert torch.isfinite(base).all()
    poisoned = kp.copy()
    poisoned[table[2, 0]] = 1e6
    got = tpa.paged_decode_attention(*args(poisoned))
    assert torch.equal(base[0], got[0]) and torch.equal(base[1], got[1])
    assert not torch.equal(base[2], got[2])


# the card tests' shapes where K9 loads each page straight into one tile
# (f32 at head dim 256 with pages of 64, pages of 128, rep 8) and a
# 300-entry table: (heads, kv heads, head dim, page size, table entries)
_CARD_SHAPES = {"d256_ps64_rep1": (4, 4, 256, 64, 6),
                "d256_ps64_rep4": (16, 4, 256, 64, 6),
                "d128_ps128_rep1": (2, 2, 128, 128, 6),
                "d128_ps128_rep8": (16, 2, 128, 128, 6),
                "d256_ps16_rep8_mp300": (16, 2, 256, 16, 300),
                "d256_ps64_rep2": (8, 4, 256, 64, 6)}


@pytest.mark.parametrize("mask", [None, "additive", "bool"])
@pytest.mark.parametrize("shape", list(_CARD_SHAPES))
def test_reference_matches_jax_at_the_card_shapes(jax_jnp, shape, mask):
    """K9's plain version against the JAX op (jnp path) at the shapes the
    card tests hold K9 to K6 on, with and without a user mask: three rows
    whose pos lands on a partial page, on the last table entry, and on a
    trash row's frozen window."""
    h, hkv, d, ps, mp = _CARD_SHAPES[shape]
    rs = np.random.RandomState(sum(_CARD_SHAPES[shape]))
    b, n_pages = 3, 3 * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[2] = 0                      # an idle row on the trash page
    pos = np.array([ps + 3, mp * ps - 1, mp * ps - 3], np.int32)
    q = rs.randn(b, 1, h, d).astype(np.float32)
    kp, vp = (rs.randn(n_pages, ps, hkv, d).astype(np.float32)
              for _ in range(2))
    m = None
    if mask == "additive":
        m = (rs.randn(b, h, 1, mp * ps) * 2).astype(np.float32)
    elif mask == "bool":
        m = rs.rand(b, 1, 1, mp * ps) < 0.7
        m[..., 0] = True
    want = jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos)),
        None if m is None else jnp.asarray(m))
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, pos)]
    got = tpa.paged_decode_attention(
        *args, None if m is None else torch.from_numpy(m))
    # f32 on both sides, the softmax summed in other orders over windows
    # of up to 4800 keys: the kernels' f32 rule, 1e-5 x (1 + max|ref|)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()))
    if m is None:
        ones = torch.ones(b, dtype=torch.int32)
        assert torch.equal(got, tpa.ragged_attention_reference(*args, ones))


def test_decode_attention_refuses_a_chunk():
    _, q, kp, vp, table, pos = _case(1, [3, 4])
    q2 = torch.from_numpy(np.concatenate([q, q], 1))
    with pytest.raises(ValueError, match="single-token"):
        tpa.paged_decode_attention(q2, *(torch.from_numpy(a)
                                         for a in (kp, vp, table, pos)))


# -- the gather branch's pieces ---------------------------------------------
@pytest.mark.parametrize("fp8", [False, True])
def test_paged_kv_gather_matches_jax(jax_jnp, fp8):
    _, _, kp, _, table, _ = _case(11, [1, 2, 3])
    if fp8:
        k8 = np.clip(kp * 40, -448, 448).astype(ml_dtypes.float8_e4m3fn)
        jk, tk = jnp.asarray(k8), torch.from_numpy(k8.view(np.uint8)).view(
            FP8)
    else:
        jk, tk = jnp.asarray(kp), torch.from_numpy(kp)
    want = np.asarray(jax_jnp._paged_gather_fwd(jk, jnp.asarray(table)))
    got = tgen.paged_kv_gather(tk, torch.from_numpy(table))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_kv_gather_q8_matches_jax(jax_jnp):
    rs, _, kp, _, table, _ = _case(12, [1, 2, 3])
    codes, scales = jpa.quantize_kv_rowwise(jnp.asarray(kp))
    want = np.asarray(jpa.dequantize_paged_q8(codes, scales,
                                              jnp.asarray(table)))
    got = tgen.paged_kv_gather_q8(torch.from_numpy(np.array(codes)),
                                  torch.from_numpy(np.array(scales)),
                                  torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos", [np.int32(5), np.array([0, 7, 30],
                                                       np.int32)],
                         ids=["scalar", "per_row"])
@pytest.mark.parametrize("l", [1, 8])
def test_window_causal_mask_matches_jax(jax_jnp, pos, l):
    want = np.asarray(jax_jnp._window_mask_fwd(jnp.asarray(pos), l, 40))
    got = tgen.window_causal_mask(torch.from_numpy(np.asarray(pos)), l, 40)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if np.ndim(pos) == 0:           # a Python int, the dense cache's pos
        np.testing.assert_array_equal(
            tgen.window_causal_mask(int(pos), l, 40).numpy(), want)


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_decode_merge_mask_matches_jax(jax_jnp, kind):
    rs = np.random.RandomState(13)
    window = np.array(jax_jnp._window_mask_fwd(
        jnp.asarray(np.array([3, 9], np.int32)), 4, 16))
    user = (rs.rand(2, 1, 1, 16) < 0.6 if kind == "bool"
            else rs.randn(2, 1, 1, 16).astype(np.float32))
    want = np.asarray(jax_jnp._merge_mask_fwd(jnp.asarray(window),
                                              jnp.asarray(user)))
    got = tgen.decode_merge_mask(torch.from_numpy(window),
                                 torch.from_numpy(user))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mask", ["bool", "additive"])
@pytest.mark.parametrize("rep", [2, 4])
def test_gqa_decode_attend_matches_jax(jax_jnp, rep, mask, dtype):
    rs = np.random.RandomState(rep)
    b, l, hkv, d, lmax = 3, 1, 2, 16, 24
    q = rs.randn(b, l, hkv * rep, d).astype(np.float32)
    k, v = (rs.randn(b, lmax, hkv, d).astype(np.float32) for _ in range(2))
    win = np.asarray(jax_jnp._window_mask_fwd(
        jnp.asarray(np.array([0, 11, 23], np.int32)), l, lmax))
    m = win if mask == "bool" else np.where(win, 0.0, -1e30).astype(
        np.float32) + rs.randn(b, 1, l, lmax).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jpa.gqa_attend_reference(jq, jk, jv, jnp.asarray(m))
    got = tgen.gqa_decode_attend(tq, tk, tv, torch.from_numpy(m))
    assert got.dtype == tq.dtype
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    else:    # the same roundings on both sides: probabilities to bf16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want).astype(np.float32),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("per_row", [False, True])
def test_kv_cache_update_matches_jax(jax_jnp, per_row):
    rs = np.random.RandomState(14)
    buf = rs.randn(3, 10, 2, 4).astype(np.float32)
    upd = rs.randn(3, 4, 2, 4).astype(np.float32)
    # 8 runs past the end: the JAX dynamic_update_slice clamps the start
    pos = np.array([0, 3, 8], np.int32) if per_row else np.int32(8)
    want = np.asarray(jax_jnp._kv_update_fwd(jnp.asarray(buf),
                                             jnp.asarray(upd),
                                             jnp.asarray(pos)))
    got = tgen.kv_cache_update(torch.from_numpy(buf.copy()),
                               torch.from_numpy(upd),
                               torch.from_numpy(np.asarray(pos)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunk_bucket_matches_jax():
    for chunk in (8, 16, 32, 48):
        for rem in range(1, 70):
            assert chunk_bucket(rem, chunk, 8) == \
                jax_chunk_bucket(rem, chunk, 8)
    with pytest.raises(ValueError):
        chunk_bucket(0, 32)


def test_sample_logits_greedy_and_filters(jax_jnp):
    rs = np.random.RandomState(15)
    logits = rs.randn(6, 50).astype(np.float32) * 3
    tl = torch.from_numpy(logits)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_jnp.sample_logits(jnp.asarray(logits), key,
                                            strategy="greedy"))
    np.testing.assert_array_equal(
        tgen.sample_logits(tl, gen, strategy="greedy").numpy(), want)
    # None with no filter is argmax, temperature aside
    np.testing.assert_array_equal(
        tgen.sample_logits(tl, gen, temperature=0.5).numpy(), want)
    # the top-p filter equals the JAX one
    np.testing.assert_array_equal(
        tgen._top_p_filter(tl, 0.8).numpy(),
        np.asarray(jax_jnp._top_p_filter(jnp.asarray(logits), 0.8)))
    # draws stay inside the top-k set, and inside the nucleus
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    probs = torch.softmax(tl, -1).numpy()
    order = np.argsort(-probs, axis=-1)
    for _ in range(20):
        s = tgen.sample_logits(tl, gen, top_k=5, strategy="sampling").numpy()
        assert all(s[i] in top5[i] for i in range(6))
        s = tgen.sample_logits(tl, gen, top_p=0.6).numpy()
        for i in range(6):
            cum = np.cumsum(probs[i, order[i]])
            nucleus = order[i, :int(np.searchsorted(cum, 0.6)) + 1]
            assert s[i] in nucleus
    a = tgen.sample_logits(tl, torch.Generator().manual_seed(5), top_k=10)
    b = tgen.sample_logits(tl, torch.Generator().manual_seed(5), top_k=10)
    assert torch.equal(a, b)


# -- update_and_attend beyond the ragged branch -------------------------------
def _attend_case(seed, paged, l):
    """q, k_new, v_new [3, l, 4, 16] (rep 2 over 2 kv heads) and a cache:
    pools of 13 pages of 8 with full, shuffled tables and per-row pos,
    or a dense [3, 32, 2, 16] buffer at scalar pos 9."""
    rs = np.random.RandomState(seed)
    q = rs.randn(3, l, 4, 16).astype(np.float32)
    kn, vn = (rs.randn(3, l, 2, 16).astype(np.float32) for _ in range(2))
    if paged:
        k, v = (rs.randn(13, 8, 2, 16).astype(np.float32) for _ in range(2))
        table = rs.permutation(np.arange(1, 13)).astype(np.int32).reshape(
            3, 4)
        return q, kn, vn, k, v, table, np.array([3, 17, 30 - l], np.int32)
    k, v = (rs.randn(3, 32, 2, 16).astype(np.float32) for _ in range(2))
    return q, kn, vn, k, v, None, np.int32(9)


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("mode", ["paged_decode", "paged_chunk", "dense"])
def test_update_and_attend_matches_jax(jax_jnp, mode, impl, mask):
    """The paged single-token branch (K9's plain version, or the gather
    branch), a paged chunk and the dense cache, with a user mask over
    the cache axis composed into the window: output and written buffers
    equal the JAX function's."""
    from paddle_tpu.core.tensor import Tensor as JT
    paged, l = mode != "dense", (1 if mode == "paged_decode" else 5)
    q, kn, vn, k, v, table, pos = _attend_case(21, paged, l)
    lmax = 32
    rs = np.random.RandomState(22)
    m = None
    if mask == "bool":
        m = rs.rand(3, 1, 1, lmax) < 0.7
        m[..., 0] = True
    elif mask == "additive":
        m = rs.randn(1, 4, 1, lmax).astype(np.float32)
    jc = jax_jnp.DecodeCache(
        JT(jnp.asarray(k)), JT(jnp.asarray(v)), JT(jnp.asarray(pos)),
        page_table=None if table is None else JT(jnp.asarray(table)),
        attn_impl=impl)
    jout, jnew = jax_jnp.update_and_attend(
        JT(jnp.asarray(q)), JT(jnp.asarray(kn)), JT(jnp.asarray(vn)), jc,
        attn_mask=None if m is None else JT(jnp.asarray(m)))
    tc = tgen.DecodeCache(
        torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
        torch.from_numpy(np.asarray(pos)) if paged else int(pos),
        page_table=None if table is None else torch.from_numpy(table),
        attn_impl=impl)
    tout, tnew = tgen.update_and_attend(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tc,
        attn_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout._value),
                               rtol=RTOL, atol=ATOL)
    for got, want in ((tnew.k, jnew.k), (tnew.v, jnew.v)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
    np.testing.assert_array_equal(np.asarray(tnew.pos),
                                  np.asarray(jnew.pos._value))


def test_update_and_attend_mask_errors(jax_jnp):
    """A mask whose last axis is not the cache axis raises the JAX
    package's ValueError; on the ragged kernel branch a mask of the cache
    axis composes with the window as on the gather branch (K6's mask
    lane, test_torch_paged_mask.py holds it against the JAX package)."""
    from paddle_tpu.core.tensor import Tensor as JT
    q, kn, vn, k, v, table, pos = _attend_case(23, True, 1)
    bad = np.ones((3, 1, 1, 30), bool)
    with pytest.raises(ValueError) as want:
        jax_jnp.update_and_attend(
            JT(jnp.asarray(q)), JT(jnp.asarray(kn)), JT(jnp.asarray(vn)),
            jax_jnp.DecodeCache(JT(jnp.asarray(k)), JT(jnp.asarray(v)),
                                JT(jnp.asarray(pos)),
                                page_table=JT(jnp.asarray(table))),
            attn_mask=JT(jnp.asarray(bad)))
    args = [torch.from_numpy(a) for a in (q, kn, vn)]
    cache = lambda **kw: tgen.DecodeCache(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        page_table=torch.from_numpy(table), **kw)
    with pytest.raises(ValueError) as got:
        tgen.update_and_attend(*args, cache(),
                               attn_mask=torch.from_numpy(bad))
    assert str(got.value) == str(want.value)
    keep = torch.ones(3, 1, 1, 32, dtype=torch.bool)
    keep[..., 1] = False
    outs = [tgen.update_and_attend(
        *args, cache(q_len=torch.ones(3, dtype=torch.int32),
                     attn_impl=impl), attn_mask=keep)[0]
        for impl in ("kernel", "gather")]
    torch.testing.assert_close(outs[0], outs[1], rtol=RTOL, atol=ATOL)
