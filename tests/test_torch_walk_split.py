"""The walks at shapes whose query rows pass one block's shared memory,
held against the JAX package on the CPU.

On the card a walk block of K6, K7 and K10 keeps the f32 query rows and
accumulators of 8 queries x rep heads in shared memory; at rep 32 with
head dim 128, or 71 heads of 64 over one kv head (multi-query attention
as Falcon-7B lays it out), at q_len 8 those rows pass it, and the walks
split them over several blocks (`walk_split` in csrc/paged_walk.cuh;
ROADMAP queue 3, F10). The split changes which block folds a row, not
the row's arithmetic, so the plain versions, which the CPU runs, are the
ones the card is held to. Here, at those shapes over pages of 16: the
ragged walk (K6's plain version), its int8 lane (K7's) and the grouped
walk (K10's) against the JAX `ragged_attention_reference` and
`ragged_paged_attention_q8`, and the single-token walk (K9's) against
the JAX `paged_attention_reference`, all on their jnp paths, in f32. The
Python wrappers' checks take these shapes: nothing is refused before
the library.
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.cuda import paged_attention as tpa

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# f32: the JAX test's own tolerance (tests/test_paged_attention.py)
RTOL, ATOL = 2e-5, 2e-6
# (query heads, head dim) over one kv head: rep 32 at head dim 128, and
# 71 heads of 64
SHAPES = [(32, 128), (71, 64)]


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("a Pallas kernel ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def jnp_paths():
    """The JAX ops on their jnp paths (the Pallas interpret switch off, a
    stand-in `disable_x64` that raises if a Pallas path runs)."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setattr(jpa, "_INTERPRET", False)
    try:
        yield
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def _batch(h, d, lq=8, q8=False, seed=0, b=4, ps=16, mp=4):
    """q [b, lq, h, d] over one kv head; pools of b * mp + 1 pages of ps
    (int8 codes with f32 scales for q8); shuffled tables; rows idle,
    decoding, partial and full-width prefill, the last one's window
    through its third page."""
    rs = np.random.RandomState(seed)
    n_pages = b * mp + 1
    q = rs.randn(b, lq, h, d).astype(np.float32)
    if q8:
        k, v = (rs.randint(-127, 128, (n_pages, ps, 1, d)).astype(np.int8)
                for _ in range(2))
        scales = tuple((rs.rand(n_pages, ps, 1) * 0.02).astype(np.float32)
                       for _ in range(2))
    else:
        k, v = (rs.randn(n_pages, ps, 1, d).astype(np.float32)
                for _ in range(2))
        scales = ()
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        b, mp)
    pos = np.array([0, 30, 5, 40], np.int32)[:b]
    q_len = np.array([0, 1, 3, lq], np.int32)[:b]
    return (q, k, v, table, pos, q_len), scales


def _live(q_len, lq):
    return np.arange(lq)[None, :] < q_len[:, None]


def _close(got, want, live):
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=RTOL, atol=ATOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("h,d", SHAPES)
def test_ragged_and_grouped_walks_match_jax(h, d):
    """K6's and K10's plain versions at q_len 8 against the JAX
    reference, with three rows sharing their first page in K10."""
    ops, _ = _batch(h, d)
    ops[3][1:, 0] = ops[3][1, 0]              # rows 1-3 share page 0
    t = [torch.from_numpy(a) for a in ops]
    want = jpa.ragged_attention_reference(*(jnp.asarray(a) for a in ops))
    live = _live(ops[5], ops[0].shape[1])
    _close(tpa.ragged_paged_attention(*t), want, live)
    gid = torch.tensor([0, 1, 1, 1], dtype=torch.int32)
    leader = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    cnt = torch.tensor([0, 1, 0, 0], dtype=torch.int32)
    _close(tpa.ragged_paged_attention_grouped(*t, gid, leader, cnt), want,
           live)


@pytest.mark.parametrize("h,d", SHAPES)
def test_int8_lane_matches_jax(h, d):
    """K7's plain version (int8 codes times f32 scales) at q_len 8
    against the JAX op, and K10's int8 lane against it."""
    ops, scales = _batch(h, d, q8=True, seed=1)
    t = [torch.from_numpy(a) for a in ops]
    ts = [torch.from_numpy(s) for s in scales]
    want = jpa.ragged_paged_attention_q8(
        *(jnp.asarray(a) for a in ops[:3]), *(jnp.asarray(s) for s in scales),
        *(jnp.asarray(a) for a in ops[3:]))
    live = _live(ops[5], ops[0].shape[1])
    _close(tpa.ragged_paged_attention_q8(*t[:3], *ts, *t[3:]), want, live)
    b = ops[0].shape[0]
    single = torch.arange(b, dtype=torch.int32)
    zero = torch.zeros(b, dtype=torch.int32)
    _close(tpa.ragged_paged_attention_grouped_q8(*t[:3], *ts, *t[3:],
                                                 single, zero, zero),
           want, live)


@pytest.mark.parametrize("h,d", SHAPES)
def test_decode_walk_matches_jax(h, d):
    """K9's plain version (one query a row) against the JAX decode
    reference."""
    ops, _ = _batch(h, d, lq=1, seed=2)
    q, k, v, table, pos, _ = ops
    want = jpa.paged_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v, table, pos)))
    got = tpa.paged_decode_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v, table, pos)))
    _close(got, want, np.ones((q.shape[0], 1), bool))


@pytest.mark.parametrize("h,d", SHAPES)
def test_wrappers_refuse_nothing_before_the_library(h, d):
    """The checks every walk wrapper makes before its C entry accept
    these shapes in every lane: only the library's plan can refuse a
    shape, and only where not even one query row fits a block."""
    for q8 in (False, True):
        ops, scales = _batch(h, d, q8=q8)
        t = [torch.from_numpy(a) for a in ops]
        ts = {k: torch.from_numpy(s)
              for k, s in zip(("k_scale", "v_scale"), scales)}
        tpa._check(*t, **ts)
        b = ops[0].shape[0]
        grp = [torch.arange(b, dtype=torch.int32),
               torch.zeros(b, dtype=torch.int32),
               torch.zeros(b, dtype=torch.int32)]
        tpa._grouped_check(*t, *grp, **ts)
        fp8 = [t[0], t[1].float().to(tpa.FP8_DTYPE),
               t[2].float().to(tpa.FP8_DTYPE), *t[3:]]
        tpa._check(*fp8)
