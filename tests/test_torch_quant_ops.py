"""The quantized KV lanes' plain versions against the JAX package.

The writes — `quantize_kv_rowwise`, `paged_scatter_q8` and `paged_scatter`
into a float8 e4m3 pool (values beyond +-448 included) — equal the JAX
functions bit for bit outside the trash page 0 (e4m3 compared through
its bytes). `dequantize_paged_q8` is bit for bit too. The attention
references of the q8 and fp8 lanes match JAX's `ragged_attention_reference_q8`
and `ragged_attention_reference` in f32; the port's grouped plain
versions match its ungrouped ones; and the kernels' operand checks
accept bf16 or f32 q over int8 pools with f32 scale pools and over e4m3
pools, and refuse what the kernels cannot take.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.cuda import paged_attention as tpa

# f32 on both sides; the frameworks sum in other orders, and the grouped
# plain version's page-by-page online softmax rounds otherwise than one
# full softmax
TOL = 1e-5
FP8 = tpa.FP8_DTYPE


def _scales_like(rs, shape):
    """Rows of K/V values at magnitudes from 1e-3 to 1e3, some all zero
    (their scale is the 1e-8 floor)."""
    u = rs.randn(*shape).astype(np.float32)
    u *= rs.choice([1e-3, 0.1, 1.0, 30.0, 1e3], size=shape[:-1] + (1,))
    u[rs.rand(*shape[:-1]) < 0.05] = 0.0
    return u


def _bits(a):
    return np.asarray(a).view(np.uint8 if np.asarray(a).itemsize == 1
                              else np.uint32)


def _to_jax(a, dtype):
    """numpy f32 -> (the JAX array, the torch tensor) of one dtype."""
    if dtype == "bf16":
        return (jnp.asarray(a.astype(ml_dtypes.bfloat16)),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_kv_rowwise_matches_jax_bit_for_bit(dtype, seed):
    u = _scales_like(np.random.RandomState(seed), (4, 7, 3, 64))
    ju, tu = _to_jax(u, dtype)
    jc, js = jpa.quantize_kv_rowwise(ju)
    tc, ts = tpa.quantize_kv_rowwise(tu)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    assert int(tc.abs().max()) == 127


def _write_case(seed, b=4, l=6, hkv=3, d=32, ps=4, mp=3):
    """Pools of b * mp + 1 pages, tables in shuffled order, and positions
    whose last tokens run past the rows' windows into the trash page."""
    rs = np.random.RandomState(seed)
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    pos = np.array([0, 3, mp * ps - 2, 5][:b], np.int32)
    return rs, (n_pages, ps, hkv, d), table, pos, (b, l, hkv, d)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_scatter_q8_matches_jax_outside_the_trash_page(dtype):
    rs, shape, table, pos, ushape = _write_case(3)
    u = _scales_like(rs, ushape)
    ju, tu = _to_jax(u, dtype)
    jp, js = jpa.paged_scatter_q8(
        jnp.zeros(shape, jnp.int8), jnp.zeros(shape[:3], jnp.float32), ju,
        jnp.asarray(pos), jnp.asarray(table))
    tp = torch.zeros(shape, dtype=torch.int8)
    ts = torch.zeros(shape[:3])
    got = tpa.paged_scatter_q8(tp, ts, tu, torch.from_numpy(pos),
                               torch.from_numpy(table))
    assert got[0] is tp and got[1] is ts          # written in place
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    np.testing.assert_array_equal(_bits(ts.numpy()[1:]),
                                  _bits(np.asarray(js)[1:]))
    # the window's last tokens went to the trash page, nothing else did
    assert (ts.numpy()[0] > 0).any()
    assert int((ts.numpy()[1:] > 0).sum()) < ushape[0] * ushape[1] * \
        ushape[2]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_paged_scatter_matches_jax_outside_the_trash_page(dtype):
    rs, shape, table, pos, ushape = _write_case(4)
    u = _scales_like(rs, ushape)
    every7 = u.reshape(-1)[::7]          # a view: beyond the e4m3 range
    every7[:] = rs.choice([449.0, -449.0, 470.0, -1e4, 1e6], every7.size)
    ju, tu = _to_jax(u, dtype)
    jp = jpa.paged_scatter(jnp.zeros(shape, jpa.FP8_DTYPE), ju,
                           jnp.asarray(pos), jnp.asarray(table))
    tp = torch.zeros(shape, dtype=torch.uint8).view(FP8)
    assert tpa.paged_scatter(tp, tu, torch.from_numpy(pos),
                             torch.from_numpy(table)) is tp
    got = tp.view(torch.uint8).numpy()[1:]
    np.testing.assert_array_equal(got, _bits(jp)[1:])
    vals = tp.float()
    assert torch.isfinite(vals).all() and vals.abs().max() == tpa.FP8_MAX


def test_float_pools_keep_their_index_copy_write():
    rs, shape, table, pos, ushape = _write_case(5)
    u = rs.randn(*ushape).astype(np.float32)
    jp = jpa.paged_scatter(jnp.zeros(shape, jnp.float32), jnp.asarray(u),
                           jnp.asarray(pos), jnp.asarray(table))
    tp = torch.zeros(shape)
    tpa.paged_scatter(tp, torch.from_numpy(u), torch.from_numpy(pos),
                      torch.from_numpy(table))
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])


def _attn_case(rep, ps, seed, lane):
    """A mixed ragged batch (idle, decode, partial and full prefill rows)
    over int8 pools with scales (quantized from f32 values by the JAX
    quantizer) or e4m3 pools, as numpy arrays."""
    rs = np.random.RandomState(seed)
    b, lq, hkv, d, mp = 5, ps + 1, 2, 32, 4
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[0] = 0
    q_len = np.array([0, 1, 3, ps + 1, 1], np.int32)
    pos = np.array([0, 0, ps - 1, 5, mp * ps - 1], np.int32)
    q = rs.randn(b, lq, hkv * rep, d).astype(np.float32)
    kv = [_scales_like(rs, (n_pages, ps, hkv, d)) for _ in range(2)]
    if lane == "q8":
        pools = []
        for x in kv:
            c, s = jpa.quantize_kv_rowwise(jnp.asarray(x))
            pools += [np.asarray(c), np.asarray(s)]
        return q, pools, table, pos, q_len
    pools = [np.asarray(jnp.asarray(np.clip(x, -448, 448))
                        .astype(jpa.FP8_DTYPE)) for x in kv]
    return q, pools, table, pos, q_len


def _torch(a):
    """A numpy array (JAX's output, read-only) as a torch tensor of its
    own; e4m3 crosses as its bytes."""
    if a.dtype == np.dtype(ml_dtypes.float8_e4m3fn):
        return torch.from_numpy(a.view(np.uint8).copy()).view(FP8)
    return torch.from_numpy(a.copy())


def _close(got, want, live):
    ref = want[live]
    np.testing.assert_allclose(got[live], ref, rtol=0,
                               atol=TOL * (1 + np.abs(ref).max()))


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("ps", [8, 16])
def test_q8_reference_matches_jax(rep, ps):
    q, (kc, ks, vc, vs), table, pos, q_len = _attn_case(rep, ps, rep + ps,
                                                        "q8")
    want = np.asarray(jpa.ragged_attention_reference_q8(
        *(jnp.asarray(a) for a in (q, kc, vc, ks, vs, table, pos, q_len))))
    t = [_torch(a) for a in (q, kc, vc, ks, vs, table, pos, q_len)]
    got = tpa.ragged_attention_reference_q8(*t).numpy()
    live = np.arange(q.shape[1])[None, :] < q_len[:, None]
    _close(got, want, live)
    # the wrapper takes it on the CPU
    assert torch.equal(tpa.ragged_paged_attention_q8(*t),
                       tpa.ragged_attention_reference_q8(*t))
    np.testing.assert_array_equal(
        tpa.dequantize_paged_q8(t[1], t[3], t[5]).numpy(),
        np.asarray(jpa.dequantize_paged_q8(jnp.asarray(kc), jnp.asarray(ks),
                                           jnp.asarray(table))))


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("ps", [8, 16])
def test_fp8_reference_matches_jax(rep, ps):
    q, (kp, vp), table, pos, q_len = _attn_case(rep, ps, 7 * rep + ps,
                                                "fp8")
    want = np.asarray(jpa.ragged_attention_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, table, pos, q_len))))
    t = [_torch(a) for a in (q, kp, vp, table, pos, q_len)]
    got = tpa.ragged_attention_reference(*t).numpy()
    live = np.arange(q.shape[1])[None, :] < q_len[:, None]
    _close(got, want, live)
    assert torch.equal(tpa.ragged_paged_attention(*t),
                       tpa.ragged_attention_reference(*t))


def _groups(table, q_len):
    """Rows 1-3 share their first two pages (row 3 also its third)."""
    table[2:4, :2] = table[1, :2]
    table[3, 2] = table[2, 2]
    from paddle_tpu_torch.serving import shared_prefix_groups
    return shared_prefix_groups(table, q_len)


@pytest.mark.parametrize("lane", ["q8", "fp8"])
@pytest.mark.parametrize("rep", [1, 2])
def test_grouped_plain_versions_equal_the_ungrouped(lane, rep):
    q, pools, table, pos, q_len = _attn_case(rep, 8, 30 + rep, lane)
    pos[1:4] = np.maximum(pos[1:4], 16)     # past the shared span
    grp = [torch.from_numpy(g) for g in _groups(table, q_len)]
    assert int(grp[2].max()) >= 2
    t = [_torch(a) for a in (q, *pools, table, pos, q_len)]
    live = np.arange(q.shape[1])[None, :] < q_len[:, None]
    if lane == "q8":
        qq, kc, ks, vc, vs, tab, p, ql = t
        flat = tpa.ragged_paged_attention_q8(qq, kc, vc, ks, vs, tab, p, ql)
        grouped = tpa.ragged_paged_attention_grouped_q8(
            qq, kc, vc, ks, vs, tab, p, ql, *grp)
        plain = tpa.grouped_attention_reference(
            qq, kc, vc, tab, p, ql, *grp, k_scale=ks, v_scale=vs)
    else:
        flat = tpa.ragged_paged_attention(*t)
        grouped = tpa.ragged_paged_attention_grouped(*t, *grp)
        plain = tpa.grouped_attention_reference(*t, *grp)
    assert torch.equal(grouped, plain)
    _close(grouped.numpy(), flat.numpy(), live)


def _meta_case(pool_dtype, d=32):
    q = torch.zeros(2, 3, 4, d, dtype=torch.bfloat16)
    pool = torch.zeros(5, 8, 2, d, dtype=pool_dtype)
    scale = torch.zeros(5, 8, 2)
    i = torch.zeros(2, dtype=torch.int32)
    return q, pool, scale, i.view(2, 1).expand(2, 3).contiguous(), i


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_kernel_checks_accept_the_quantized_lanes(qdtype):
    q, pool, scale, table, i = _meta_case(torch.int8)
    q = q.to(qdtype)
    tpa._check(q, pool, pool, table, i, i, scale, scale)
    fp8 = torch.zeros(pool.shape, dtype=torch.uint8).view(FP8)
    tpa._check(q, fp8, fp8, table, i, i)


def test_kernel_checks_refuse_what_the_kernels_cannot_take():
    q, pool, scale, table, i = _meta_case(torch.int8)
    fp8 = torch.zeros(pool.shape, dtype=torch.uint8).view(FP8)
    with pytest.raises(TypeError, match="scale pools"):
        tpa._check(q, pool, pool, table, i, i)             # no scales
    with pytest.raises(TypeError, match="scale pools"):
        tpa._check(q, pool, pool, table, i, i, scale.double(),
                   scale.double())
    with pytest.raises(TypeError, match="int8 pools only"):
        tpa._check(q, fp8, fp8, table, i, i, scale, scale)
    with pytest.raises(TypeError, match="share q's dtype"):
        tpa._check(q, pool.float(), pool.float(), table, i, i)
    with pytest.raises(TypeError, match="share q's dtype"):
        tpa._check(q, pool, fp8, table, i, i, scale, scale)
    # head dim 40 over int8 pools: rows of 40 bytes, which the walks copy
    # 8 bytes at a time, so the checks pass them
    q, pool, scale, table, i = _meta_case(torch.int8, d=40)
    tpa._check(q, pool, pool, table, i, i, scale, scale)
    # the fp wrappers refuse int8 pools: those need their scales
    with pytest.raises(TypeError, match="_q8"):
        tpa.ragged_paged_attention(q, pool, pool, table, i, i)
    with pytest.raises(TypeError, match="_q8"):
        tpa.ragged_paged_attention_grouped(q, pool, pool, table, i, i, i, i,
                                           i)


def test_quantized_wrappers_never_fall_back_off_the_cpu():
    q = torch.zeros(1, 1, 2, 16, device="meta")
    codes = torch.zeros(2, 4, 2, 16, dtype=torch.int8, device="meta")
    scale = torch.zeros(2, 4, 2, device="meta")
    fp8 = torch.zeros(2, 4, 2, 16, dtype=FP8, device="meta")
    i = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpa.ragged_paged_attention_q8(q, codes, codes, scale, scale,
                                      i.view(1, 1), i, i)
    with pytest.raises(ValueError, match="no kernel"):
        tpa.ragged_paged_attention_grouped_q8(q, codes, codes, scale, scale,
                                              i.view(1, 1), i, i, i, i, i)
    with pytest.raises(ValueError, match="no kernel"):
        tpa.ragged_paged_attention(q, fp8, fp8, i.view(1, 1), i, i)
    upd = torch.zeros(1, 1, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_scatter(fp8, upd, i, i.view(1, 1))
    with pytest.raises(ValueError, match="no kernel"):
        tpa.paged_scatter_q8(codes, scale, upd, i, i.view(1, 1))
