"""K10's plain version, held on the CPU at the card tests' shapes.

- The rows whose partials `grouped_attention_reference` records as
  phase 1's (the rows the card tests compare K10a's partials on) against
  a brute force over random batches: every member row of every sharing
  group with a live query block, and no other row, each once per kv
  head.
- `grouped_attention_reference` (fp, fp8 and q8 lanes) against the JAX
  package's `ragged_paged_attention_grouped[_q8]` on its jnp path at the
  card tests' larger shapes (head dim 128 with pages of 32, head dim 256
  with pages of 64, head dim 32 with pages of 8) and a group of 12
  members.

The launch K10 makes for a batch (ring or direct page loads, shared
memory, grid) is the library's own choice (`grouped_plan`); the card
tests hold it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import shared_prefix_groups

# f32 on both sides: the online softmax (page by page, rescaled) and the
# JAX reference's one full softmax round differently
TOL = 1e-5


def _random_batch(seed):
    """A host batch with prefix groups (from `shared_prefix_groups`, or a
    group of up to 12 members declared by hand), idle and trash rows and
    members whose first query block ends inside the span."""
    rs = np.random.RandomState(seed)
    b, ps, mp = rs.randint(2, 15), rs.choice([8, 16, 32]), rs.randint(1, 9)
    lq = int(rs.choice([1, 5, 8, 17, 32]))
    table = rs.permutation(np.arange(1, b * mp + 1)).astype(np.int32)
    table = table.reshape(b, mp)
    q_len = rs.choice([0, 1, 3, lq], size=b).astype(np.int32)
    pos = rs.randint(0, mp * ps, size=b).astype(np.int32)
    if seed % 2:
        cnt = rs.randint(1, mp + 1)
        members = np.arange(1, b)
        table[members, :cnt] = table[1, :cnt]
        group_id = np.zeros(b, np.int32)
        group_id[members] = 1
        group_leader = np.zeros(b, np.int32)
        group_leader[1] = 1
        group_cnt = np.zeros(b, np.int32)
        group_cnt[1] = cnt
        group_id[0] = 0 if rs.rand() < 0.5 else -3   # outside [0, B)
    else:
        table[0] = 0
        q_len[0] = 0
        table[1:b // 2 + 1, :1] = table[1, :1]
        group_id, group_leader, group_cnt = shared_prefix_groups(table,
                                                                 q_len)
    return table, pos, q_len, (group_id, group_leader, group_cnt), lq, ps


@pytest.mark.parametrize("block", range(4))
def test_phase1_rows_are_the_live_members(block):
    formed = 0
    for seed in range(block, 120, 4):
        table, pos, q_len, (gid, gld, gcn), lq, ps = _random_batch(seed)
        b, mp = table.shape
        h, hkv, d = 2, 1, 4
        qblk = min(lq, 8)
        nqb = -(-lq // qblk)
        t_ = [torch.from_numpy(np.asarray(a)) for a in (
            np.zeros((b, lq, h, d), np.float32),
            np.zeros((b * mp + 1, ps, hkv, d), np.float32),
            np.zeros((b * mp + 1, ps, hkv, d), np.float32),
            table, pos, q_len, gid, gld, gcn)]
        _, (_, _, _, written) = tpa.grouped_attention_reference(
            *t_, return_partials=True)
        rows = written.reshape(hkv, nqb, b, qblk * h // hkv)
        for t in range(nqb):
            for r in range(b):
                g = gid[r]
                member = 0 <= g < b and gcn[g] > 0
                live = t * qblk < q_len[r]
                # a block's rows are written together, or not at all
                assert bool(rows[:, t, r].all()) == bool(
                    rows[:, t, r].any()) == (member and live), (seed, t, r)
                formed += member and live
    assert formed > 0


def _group12_case(rep, seed, d=128, ps=32):
    """Fourteen rows: row 0 idle on the trash page, rows 1-12 one group
    sharing 2 pages (one member idle, one whose first query block ends
    inside the span), row 13 alone. Head dim `d`, page size `ps`."""
    rs = np.random.RandomState(seed)
    b, lq, hkv, mp = 14, 9, 2, 4
    h = hkv * rep
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[0] = 0
    table[1:13, :2] = table[1, :2]
    q_len = np.array([0, 9, 1, 5, 0, 9, 3, 1, 9, 2, 1, 7, 9, 4], np.int32)
    pos = np.array([rs.randint(2 * ps, mp * ps - max(ql, 1) + 1)
                    for ql in q_len], np.int32)
    pos[0] = 0
    pos[3] = max(ps - 12, 0)             # pages 0 .. 0: inside the span
    group_id = np.array([0] + [1] * 12 + [2], np.int32)
    group_leader = np.zeros(b, np.int32)
    group_leader[1] = 5
    group_leader[2] = 13
    group_cnt = np.zeros(b, np.int32)
    group_cnt[1] = 2
    mk = lambda *s: rs.randn(*s).astype(np.float32)
    return (mk(b, lq, h, d), mk(n_pages, ps, hkv, d), mk(n_pages, ps, hkv, d),
            table, pos, q_len), (group_id, group_leader, group_cnt)


@pytest.mark.parametrize("d,ps", [(128, 32), (256, 64), (32, 8)])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("lane", ["fp", "fp8", "q8"])
def test_grouped_reference_matches_jax(monkeypatch, d, ps, rep, lane):
    monkeypatch.setattr(jpa, "_use_kernel", lambda: False)   # the jnp path
    ops, grp = _group12_case(rep, seed=rep, d=d, ps=ps)
    q, k, v, table, pos, q_len = ops
    scales = {}
    if lane == "q8":
        (k, ks), (v, vs) = (tuple(x.numpy() for x in tpa.quantize_kv_rowwise(
            torch.from_numpy(pool))) for pool in (k, v))
        scales = {"k_scale": ks, "v_scale": vs}
        want = np.asarray(jpa.ragged_paged_attention_grouped_q8(
            *(jnp.asarray(a) for a in (q, k, v, scales["k_scale"],
                                       scales["v_scale"], table, pos, q_len,
                                       *grp))))
    elif lane == "fp8":
        k, v = (np.clip(x, -448, 448) for x in (k, v))
        jk, jv = (jnp.asarray(x).astype(jpa.FP8_DTYPE) for x in (k, v))
        want = np.asarray(jpa.ragged_paged_attention_grouped(
            jnp.asarray(q), jk, jv, *(jnp.asarray(a) for a in (
                table, pos, q_len, *grp))))
    else:
        want = np.asarray(jpa.ragged_paged_attention_grouped(
            *(jnp.asarray(a) for a in (q, k, v, table, pos, q_len, *grp))))
    t = [torch.from_numpy(np.asarray(a)) for a in (q, k, v, table, pos,
                                                   q_len, *grp)]
    if lane == "fp8":
        t[1], t[2] = (x.to(tpa.FP8_DTYPE) for x in t[1:3])
    got, (m, l, acc, written) = tpa.grouped_attention_reference(
        *t, return_partials=True,
        **{n: torch.from_numpy(s) for n, s in scales.items()})
    live = np.arange(got.shape[1])[None, :] < q_len[:, None]
    ref = want[live]
    np.testing.assert_allclose(got.numpy()[live], ref, rtol=0,
                               atol=TOL * (1 + np.abs(ref).max()))
    # phase 1 folded the eleven live members' query blocks and no other row
    rows = written.any(0).any(0).reshape(14, -1).any(1).tolist()
    assert rows == [False] + [bool(x) for x in q_len[1:13] > 0] + [False]
    assert sum(rows) == 11
