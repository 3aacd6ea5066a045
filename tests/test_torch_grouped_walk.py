"""K10's host side and plain version, held against the JAX package.

`shared_prefix_groups` and `count_page_block_reads` against the JAX
functions on 200 seeded random page tables (shared spans, copy-on-write
divergence mid-span, idle and trash rows), exactly; and the plain
two-phase op `grouped_attention_reference` against the JAX
`ragged_attention_reference` in f32, over rep {1, 2, 4}, page size
{8, 16} and mixed q_len, with groups of one, spans that end mid-row and
two groups at once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import prefix as jprefix
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import shared_prefix_groups

N_TABLES, BLOCKS = 200, 4
# f32 on both sides: the online softmax (page by page, rescaled) and the
# JAX reference's one full softmax round differently
TOL = 1e-5


def _random_table(seed):
    """A host page table as the engine builds them: rows attach a shared
    prefix of tree pages (some diverging mid-span into a private COW
    page), then private pages, then trash; some rows idle (q_len 0), some
    trash rows (a free slot)."""
    rs = np.random.RandomState(seed)
    s, mp, ps = rs.randint(1, 13), rs.randint(1, 11), 8
    next_page = [1]

    def fresh(n):
        out = list(range(next_page[0], next_page[0] + n))
        next_page[0] += n
        return out

    prefixes = [fresh(mp) for _ in range(rs.randint(1, 4))]
    table = np.zeros((s, mp), np.int32)
    for r in range(s):
        kind = rs.randint(6)
        if kind == 0:
            continue                               # free slot: all trash
        used = rs.randint(1, mp + 1)
        if kind >= 3:                              # attaches a prefix
            share = rs.randint(0, used + 1)
            row = prefixes[rs.randint(len(prefixes))][:share]
        else:
            row = []
        row = row + fresh(used - len(row))
        if kind == 5 and row:                      # COW divergence mid-span
            row[rs.randint(len(row))] = fresh(1)[0]
        table[r, :used] = row
    q_len = rs.choice([0, 0, 1, 1, 3, ps, ps + 1], size=s).astype(np.int32)
    pos = rs.randint(0, mp * ps, size=s).astype(np.int32)
    return table, pos, q_len, ps


@pytest.mark.parametrize("block", range(BLOCKS))
def test_shared_prefix_groups_match_jax(block):
    formed = 0
    for seed in range(block, N_TABLES, BLOCKS):
        table, _, q_len, _ = _random_table(seed)
        got = shared_prefix_groups(table, q_len)
        want = jprefix.shared_prefix_groups(table, q_len)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w, err_msg=f"seed {seed}")
        formed += int((got[2] > 0).sum())
    assert formed > 0


@pytest.mark.parametrize("block", range(BLOCKS))
def test_count_page_block_reads_matches_jax(block):
    saved = 0
    for seed in range(block, N_TABLES, BLOCKS):
        table, pos, q_len, ps = _random_table(seed)
        gid, _, gcn = shared_prefix_groups(table, q_len)
        for args in ((), (gid, gcn)):
            got = tpa.count_page_block_reads(table, pos, q_len, *args,
                                             page_size=ps)
            want = jpa.count_page_block_reads(table, pos, q_len, *args,
                                              page_size=ps)
            assert got == tuple(want), f"seed {seed}"
        saved += got[0] - got[1]
    assert saved > 0


def _grouped_case(rep, ps, seed):
    """Seven rows: row 0 idle; rows 1-3 a group sharing 2 pages whose
    span ends mid-row (their walks go on past it, one member idle this
    step); rows 4-5 a second group sharing 1 page; row 6 a group of one
    with a shared span of 1. q_len from {0, 1, 3, ps, ps + 1}."""
    rs = np.random.RandomState(seed)
    b, lq, hkv, d, mp = 7, ps + 1, 2, 16, 5
    h = hkv * rep
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[0] = 0
    table[1:4, :2] = table[1, :2]
    table[4:6, :1] = table[4, :1]
    q_len = np.array([0, 3, ps + 1, 0, 1, ps, 3], np.int32)
    lo = np.array([0, 2, 2, 2, 1, 1, 1]) * ps
    pos = np.array([rs.randint(lo[r], mp * ps - max(q_len[r], 1) + 1)
                    for r in range(b)], np.int32)
    pos[0] = 0
    group_id = np.array([0, 1, 1, 1, 2, 2, 3], np.int32)
    group_leader = np.array([0, 1, 4, 6, 0, 0, 0], np.int32)
    group_cnt = np.array([0, 2, 1, 1, 0, 0, 0], np.int32)
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    return (mk(b, lq, h, d), mk(n_pages, ps, hkv, d), mk(n_pages, ps, hkv, d),
            table, pos, q_len), (group_id, group_leader, group_cnt)


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("ps", [8, 16])
def test_grouped_reference_matches_jax(rep, ps):
    ops, grp = _grouped_case(rep, ps, seed=10 * rep + ps)
    want = np.asarray(jpa.ragged_attention_reference(
        *(jnp.asarray(a) for a in ops)))
    t = [torch.from_numpy(a) for a in ops + grp]
    got, (m, l, acc, written) = tpa.grouped_attention_reference(
        *t, return_partials=True)
    q_len = ops[5]
    live = np.arange(got.shape[1])[None, :] < q_len[:, None]
    ref = want[live]
    np.testing.assert_allclose(got.numpy()[live], ref, rtol=0,
                               atol=TOL * (1 + np.abs(ref).max()))
    # and K6's plain version agrees the same way
    flat = tpa.ragged_attention_reference(*t[:6]).numpy()
    np.testing.assert_allclose(got.numpy()[live], flat[live], rtol=0,
                               atol=TOL * (1 + np.abs(ref).max()))
    # phase 1 folded only member rows of live query blocks: rows 1, 2
    # (group 1; row 3 is idle), 4, 5 (group 2) and 6 (the group of one)
    rows = written.any(0).any(0).reshape(7, -1).any(1)
    assert rows.tolist() == [False, True, True, False, True, True, True]
    assert (m[~written] == tpa.NEG_INF).all()
    assert (l[~written] == 0).all() and (acc[~written] == 0).all()
    assert (l[written] > 0).all()


def test_grouped_op_on_the_cpu_is_the_plain_version():
    """The wrapper takes the plain version for CPU tensors and broadcasts
    0-dim operands; under a user mask it is K6's wrapper with that mask
    (the JAX op's fallback to its ungrouped kernel)."""
    ops, grp = _grouped_case(2, 8, seed=3)
    t = [torch.from_numpy(a) for a in ops + grp]
    out = tpa.ragged_paged_attention_grouped(*t)
    assert torch.equal(out, tpa.grouped_attention_reference(*t))
    b = ops[0].shape[0]
    zero = torch.tensor(0, dtype=torch.int32)
    singles = tpa.ragged_paged_attention_grouped(
        *t[:6], torch.arange(b, dtype=torch.int32), zero, zero)
    live = torch.arange(out.shape[1])[None, :] < t[5][:, None]
    torch.testing.assert_close(singles[live], out[live], rtol=0,
                               atol=TOL * (1 + out.abs().max().item()))
    masked = tpa.ragged_paged_attention_grouped(*t, mask=torch.zeros(1))
    assert torch.equal(masked, tpa.ragged_paged_attention(
        *t[:6], mask=torch.zeros(1)))
