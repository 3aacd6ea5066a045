"""The walks' piecewise fold and K11's rank steps, held on the CPU before
the card runs them.

- The walks (K6, K7, K9, K10; `csrc/paged_walk.cuh`) fold a page of more
  than 128 keys in pieces (`tpa.piece_rows`: a 256-key page at head dim
  64 in two pieces of 128; at head dim 512 pages of 16 in two of 8),
  each piece one step of the online softmax. `emulate_pieces` runs that
  fold in plain PyTorch, in f32, step by step, and is held to f32
  1e-5 x (1 + max|ref|) against the plain version
  (`ragged_attention_reference[_q8]`, one softmax over the gathered view)
  and the JAX package's `ragged_paged_attention[_q8]` on its jnp path,
  in the fp and q8 lanes.
- K11 (`csrc/lora_paged.cu`) at ranks over 16: t's columns are summed a
  group of ranks at a time (each column's sums in the order they had),
  and d = t . B sums over R in k-steps of 16, one mma.sync k-step after
  another into an f32 accumulator. `emulate_k11` does that in plain
  PyTorch (the cluster and slices of `make_plan`: `plan` below) at
  ranks 24, 32 and 64 in bf16 and f16, held to K11's unchanged rule (2
  ulps + 1e-5 x max|ref| + one ulp of t carried through B and the
  scale) against `lora_delta_paged_reference` and the JAX op. One jitted
  JAX call per dtype.
"""
import math
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.cuda import paged_attention as tpa

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# the f32 rule of the walks against their plain versions (summation order)
TOL = 1e-5
# K11's rule: 2 ulps of the output's dtype + 1e-5 x max|ref| (f16:
# x (1 + max|ref|)) + one ulp of t through B and the scale
ULPS, F32_TOL = 2, 1e-5
_DT = {"bf16": (torch.bfloat16, ml_dtypes.bfloat16),
       "f16": (torch.float16, np.float16)}


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("a Pallas kernel ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def jnp_paths():
    """The JAX ops on their jnp paths (the Pallas interpret switch off,
    a stand-in `disable_x64` that raises if a Pallas path runs)."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setattr(jpa, "_INTERPRET", False)
    mp.setattr(jpa, "_use_kernel", lambda: False)
    try:
        yield
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


# -- the walks' pieces --------------------------------------------------------
def emulate_pieces(q, kf, vf, pos, q_len, ps, pc):
    """The walks' fold in plain PyTorch, f32: every query block of
    min(lq, 8) queries walks its row's pages 0 .. through its last live
    query's position (at most mp), each page in pieces of `pc` keys, one
    online-softmax step a piece (scores of masked keys -1e30; alpha, the
    probabilities and l as `attend_row` forms them); the output is
    acc / max(l, 1e-30), dead queries 0. kf, vf: the dense f32 logical
    views [B, mp * ps, H_kv, D]."""
    b, lq, h, d = q.shape
    lmax, hkv = kf.shape[1], kf.shape[2]
    mp, rep = lmax // ps, h // hkv
    qblk = min(lq, 8)
    qf = q.float().reshape(b, lq, hkv, rep, d)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    i = torch.arange(lq)
    ql, p64 = q_len.long(), pos.long()
    qlive = i[None, :] < ql[:, None]                            # [B, lq]
    qmax = p64[:, None] + i[None, :]
    q0 = (i // qblk) * qblk
    last = torch.minimum(q0[None, :] + qblk, ql[:, None]) - 1
    n_pages = torch.clamp((p64[:, None] + last) // ps + 1, max=mp)
    m = torch.full((b, lq, hkv, rep), tpa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for p in range(mp):
        for c0 in range(0, ps, pc):
            keys = p * ps + torch.arange(c0, min(ps, c0 + pc))
            s = torch.einsum("bigrd,bjgd->bigrj", qf, kf[:, keys]) * scale
            live = qlive[..., None] & (keys[None, None, :] <= qmax[..., None])
            s = torch.where(live[:, :, None, None, :], s,
                            torch.full_like(s, tpa.NEG_INF))
            mnew = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mnew)
            pj = torch.exp(s - mnew[..., None])
            lnew = alpha * l + pj.sum(-1)
            accnew = acc * alpha[..., None] + torch.einsum(
                "bigrj,bjgd->bigrd", pj, vf[:, keys])
            act = (p < n_pages)[:, :, None, None]
            m = torch.where(act, mnew, m)
            l = torch.where(act, lnew, l)
            acc = torch.where(act[..., None], accnew, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = torch.where(qlive[:, :, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(b, lq, h, d)


def _walk_case(d, ps, seed=0):
    """Six rows of up to 11 queries over 3 table entries of page size ps,
    2 kv heads at rep 2: an idle row on the trash page, decode rows and
    prefill rows whose windows end inside a page's second piece."""
    rs = np.random.RandomState(seed)
    b, lq, hkv, rep, mp = 6, 11, 2, 2, 3
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[0] = 0
    q_len = np.array([0, 1, 11, 5, 1, 11], np.int32)
    pos = np.array([0, ps + ps // 2 + 3, 2 * ps - 20, ps // 2 - 7, 3 * ps - 1,
                    5], np.int32)
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    return (mk(b, lq, hkv * rep, d), mk(n_pages, ps, hkv, d),
            mk(n_pages, ps, hkv, d), table, pos, q_len)


@pytest.mark.parametrize("d,ps,pc", [(64, 256, 128), (40, 256, 128),
                                     (512, 16, 8)])
@pytest.mark.parametrize("lane", ["fp", "q8"])
def test_piecewise_fold_meets_the_rule(d, ps, pc, lane):
    assert tpa.piece_rows(d, ps) == pc
    q, k, v, table, pos, q_len = _walk_case(d, ps)
    t = [torch.from_numpy(a) for a in (q, k, v, table, pos, q_len)]
    if lane == "q8":
        (tk, ks), (tv, vs) = (tpa.quantize_kv_rowwise(x) for x in t[1:3])
        kf = tpa.dequantize_paged_q8(tk, ks, t[3])
        vf = tpa.dequantize_paged_q8(tv, vs, t[3])
        plain = tpa.ragged_attention_reference_q8(t[0], tk, tv, ks, vs,
                                                  *t[3:])
        want = np.asarray(jpa.ragged_paged_attention_q8(
            *(jnp.asarray(np.asarray(a)) for a in (q, tk, tv, ks, vs, table,
                                                   pos, q_len))))
    else:
        b, mp = table.shape
        kf, vf = (x[t[3].long()].reshape(b, mp * ps, *x.shape[2:])
                  for x in t[1:3])
        plain = tpa.ragged_attention_reference(*t)
        want = np.asarray(jpa.ragged_paged_attention(
            *(jnp.asarray(a) for a in (q, k, v, table, pos, q_len))))
    got = emulate_pieces(t[0], kf, vf, t[4], t[5], ps, pc)
    live = np.arange(q.shape[1])[None, :] < q_len[:, None]
    for ref in (plain.numpy(), want):
        ref = ref[live]
        np.testing.assert_allclose(got.numpy()[live], ref, rtol=0,
                                   atol=TOL * (1 + np.abs(ref).max()))


def test_piece_rows_keep_every_page_the_walks_took_whole():
    """Pages up to 128 keys stay whole wherever an f32 tile fit beside a
    query block's rows (up to head dim 256 with pages of 64, 128 with
    pages of 128), so the serving batches fold as they did; longer pages
    are cut into equal pieces of at most 128 keys."""
    for d in (12, 32, 40, 64, 80, 128):
        assert [tpa.piece_rows(d, ps) for ps in (1, 8, 16, 64, 128)] == [
            1, 8, 16, 64, 128]
    assert tpa.piece_rows(256, 64) == 64 and tpa.piece_rows(256, 128) == 64
    assert [tpa.piece_rows(64, ps) for ps in (129, 200, 256, 1024)] == [
        65, 100, 128, 128]
    for d in (300, 512, 1024):
        pc = tpa.piece_rows(d, 16)
        assert pc * (2 * d + 1) * 4 <= 65536 and pc >= 1


# -- K11 at ranks over 16 -----------------------------------------------------
def plan(b, w, cin, cout):
    """(blocks a cluster, IN slice of a block) as `make_plan` chooses
    them at the ranks below (each fits shared memory at the widest
    positions: 64 a cluster)."""
    wc = min(64, -(-max(w, 1) // 16) * 16)
    nwc = -(-w // wc)
    nk, nn = max(1, -(-cin // 16)), max(1, -(-cout // 8))
    nc = min(8, max(1, -(-132 // (b * nwc))), nk, nn)
    return nc, -(-nk // nc) * 16


def emulate_k11(x, a_pool, b_pool, apage, ascale):
    """K11's arithmetic in plain PyTorch: t over the cluster's IN slices
    (16-wide k-steps, slices added in rank order), rounded to the dtype;
    d = t . B over R in k-steps of 16, each step's f32 sum added to the
    accumulator in rank order, rounded; times the scale, rounded."""
    dt = x.dtype
    b, w, cin = x.shape
    nc, ks = plan(b, w, cin, b_pool.shape[2])
    ap = apage.long()
    xf, af, bf = x.float(), a_pool[ap].float(), b_pool[ap].float()
    r = af.shape[2]
    t = torch.zeros(b, w, r)
    for c in range(nc):                                 # rank order
        part = torch.zeros_like(t)
        for k0 in range(c * ks, min(cin, (c + 1) * ks), 16):   # k-steps
            step = xf[:, :, k0:k0 + 16, None] * af[:, None, k0:k0 + 16, :]
            part = part + step.sum(dim=2)
        t = t + part
    t = t.to(dt).float()
    d = torch.zeros(b, w, bf.shape[2])
    for r0 in range(0, r, 16):                          # d's k-steps
        d = d + torch.bmm(t[:, :, r0:r0 + 16], bf[:, r0:r0 + 16])
    d = d.to(dt).float()
    s = ascale.to(dt).float()[:, None, None]
    return (d * s).to(dt)


def _ulp(v, dt):
    _, e = torch.frexp(v.abs())
    ulp = torch.ldexp(torch.ones_like(v), e - (8 if dt == torch.bfloat16
                                               else 11))
    if dt == torch.float16:
        ulp = torch.clamp(ulp, min=2.0 ** -24)
    return torch.where(v == 0, torch.zeros_like(v), ulp)


def _within_rule(got, want, x, a_pool, b_pool, apage, ascale):
    dt = got.dtype
    got, want = got.float(), want.float()
    ap = apage.long()
    t = torch.bmm(x.float(), a_pool[ap].float()).to(dt).float()
    flip = torch.bmm(_ulp(t, dt), b_pool[ap].float().abs()) * \
        ascale.to(dt).float()[:, None, None]
    ref_max = want.abs().max().item()
    allowed = ULPS * _ulp(want, dt) + flip + F32_TOL * (
        ref_max if dt == torch.bfloat16 else 1 + ref_max)
    diff = (got - want).abs()
    assert (diff <= allowed).all(), (diff / allowed).max().item()


_CASES = [(16, 32, 768, 768, r) for r in (24, 32, 64)] + [
    (5, 70, 1000, 600, r) for r in (24, 64)]


def _operands(case, dtype, pages=9):
    """numpy f32 operands as `launch_check.lora_batch` builds them (page
    0 the zero page, one row at scale 0), rounded to `dtype`."""
    b, w, cin, cout, r = case
    rs = np.random.RandomState(b * 100 + r)
    a_pool = rs.randn(pages, cin, r).astype(np.float32) * 0.05
    b_pool = rs.randn(pages, r, cout).astype(np.float32) * 0.05
    a_pool[0] = 0.0
    b_pool[0] = 0.0
    apage = (np.arange(b) % pages).astype(np.int32)
    ascale = rs.rand(b).astype(np.float32)
    ascale[min(3, b - 1)] = 0.0
    x = rs.randn(b, w, cin).astype(np.float32)
    _, npdt = _DT[dtype]
    return [a.astype(npdt) for a in (x, a_pool, b_pool)] + [apage, ascale]


_JAX_OUT = {}


def _jax_output(case, dtype):
    """The JAX op's output for `case`: every case of a dtype in one jitted
    call (one compile instead of one per shape)."""
    if dtype not in _JAX_OUT:
        ops = [[jnp.asarray(a) for a in _operands(c, dtype)]
               for c in _CASES]
        run = jax.jit(lambda all_ops: [jpa.lora_delta_paged(*o)
                                       for o in all_ops])
        _JAX_OUT[dtype] = [np.asarray(o).astype(np.float32)
                           for o in run(ops)]
    return _JAX_OUT[dtype][_CASES.index(case)]


@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("case", _CASES)
def test_k11_rank_steps_meet_the_rule(dtype, case):
    ops = _operands(case, dtype)
    tdt, _ = _DT[dtype]
    x, A, B = (torch.from_numpy(a.astype(np.float32)).to(tdt)
               for a in ops[:3])
    apage, ascale = (torch.from_numpy(a) for a in ops[3:])
    got = emulate_k11(x, A, B, apage, ascale)
    zero = (apage == 0) | (ascale == 0)
    assert not got[zero].any()
    ref = tpa.lora_delta_paged_reference(x, A, B, apage, ascale)
    _within_rule(got, ref, x, A, B, apage, ascale)
    want = torch.from_numpy(_jax_output(case, dtype)).to(tdt)
    _within_rule(got, want, x, A, B, apage, ascale)
