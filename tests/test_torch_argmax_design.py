"""K12's design held on the CPU: the launch plan, the row partition and
the reduction, against the JAX `decode_greedy_argmax`.

`_argmax_plan` and `_argmax_slices` are the Python half of
`csrc/greedy_argmax.cu`: S blocks a row (a thread-block cluster), the
threads a block, and the elements each block reads (whole 16-byte
vectors after a scalar head that reaches the first aligned address, and
a scalar tail). Here they must cover every element of a row exactly
once at the serving and verify shapes on a card of 132 SMs. Then a
plain-PyTorch model of the kernel (each thread's scan in index order,
the unsigned keys `key_of` gives, two reductions a warp, the block's
warps, the cluster's blocks merged in a shuffled order) equals the JAX
function's CPU path (`jnp.argmax`) on rows with ties across slice
borders, NaNs in two slices, -0.0 before 0.0 and all -inf, and so does
the port's `decode_greedy_argmax` on the CPU.
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
SMS = 132     # the H100's SMs
ROWS = (1, 16, 128, 300)
VOCABS = (1, 3, 4, 5, 50257, 50304, 128256)


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("a Pallas kernel ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def jnp_paths():
    """The JAX op on its jnp path (the Pallas interpret switch off, a
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


@pytest.mark.parametrize("b", ROWS)
def test_plan_fills_one_wave_and_caps_the_cluster(b):
    for v in VOCABS:
        s, threads = tpa._argmax_plan(b, v, SMS)
        # S = 1 where the rows alone fill the card, else one wave of at
        # most 8 blocks a row
        assert s == {1: 8, 16: 8, 128: 1, 300: 1}[b]
        assert b * s <= max(SMS, b)
        assert threads % 32 == 0 and 32 <= threads <= 1024
        if s > 1 or b > SMS:
            assert threads <= 512
    assert tpa._argmax_plan(16, 50304, SMS) == (8, 512)
    assert tpa._argmax_plan(128, 50304, SMS) == (1, 1024)


@pytest.mark.parametrize("v", VOCABS)
def test_slices_cover_every_element_once(v):
    """Over every S a plan gives (and 2-8) and every misalignment of the
    row's start: each element read once, vectors 16-byte aligned and
    whole, scalars only before the first aligned address and after the
    last whole vector, and all of them in rank 0."""
    for s in sorted({tpa._argmax_plan(b, v, SMS)[0] for b in ROWS}
                    | set(range(1, 9))):
        for offset in range(4):
            seen = np.zeros(v, np.int64)
            head = min(v, (4 - offset) % 4)
            nv = (v - head) // 4
            slices = tpa._argmax_slices(v, s, offset)
            assert len(slices) == s
            for r, (scalars, runs) in enumerate(slices):
                if r:
                    assert scalars == []
                for i in scalars:
                    assert i < head or i >= head + 4 * nv
                    seen[i] += 1
                for a, z in runs:
                    assert z - a == 4 and (offset + a) % 4 == 0
                    seen[a:z] += 1
                # a rank's vectors are contiguous, ranks in order
                if runs:
                    assert runs[-1][0] - runs[0][0] == 4 * (len(runs) - 1)
                    assert len(runs) in (nv // s, -(-nv // s))
            assert (seen == 1).all(), (v, s, offset)


def _keys(x: torch.Tensor) -> torch.Tensor:
    """`key_of` of the kernel on f32 values, as int64: NaN on top, -0.0
    equal to 0.0, else the IEEE order."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    k = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return torch.where(torch.isnan(x), torch.full_like(k, 0xFFFFFFFF), k)


def _best(keys, idx, rng):
    """Merge (key, index) pairs in a shuffled order by the kernel's rule:
    the largest key, the smallest index holding it (the empty slot is
    key 0, index INT_MAX)."""
    bk, bi = 0, 2 ** 31 - 1
    for j in rng.permutation(len(keys)):
        k, i = int(keys[j]), int(idx[j])
        if k > bk or (k == bk and i < bi):
            bk, bi = k, i
    return bk, bi


def _model(row: torch.Tensor, s: int, threads: int, offset: int, rng):
    """K12 on one row, in plain PyTorch: each block's threads scan their
    elements in increasing index order keeping the first of the largest
    key, warps then the block's warps reduce, and the S blocks' pairs
    merge in a shuffled order."""
    v = row.numel()
    keys = _keys(row).tolist()
    head = min(v, (4 - offset) % 4)
    tail0 = head + 4 * ((v - head) // 4)
    pairs = []
    for scalars, runs in tpa._argmax_slices(v, s, offset):
        per_thread = [[] for _ in range(threads)]
        for i in scalars:     # head element t and tail element t: thread t
            per_thread[i if i < head else i - tail0].append(i)
        for j, (a, _) in enumerate(runs):
            per_thread[j % threads].extend(range(a, a + 4))
        best = []
        for elems in per_thread:
            bk, bi = 0, 2 ** 31 - 1
            for i in sorted(elems):
                if keys[i] > bk:
                    bk, bi = keys[i], i
            best.append((bk, bi))
        warps = [_best(*zip(*best[w:w + 32]), rng)
                 for w in range(0, threads, 32)]
        pairs.append(_best(*zip(*warps), rng))
    return _best(*zip(*pairs), rng)[1]


def _hard_rows(v: int, s: int, offset: int) -> np.ndarray:
    """Rows with a tie across the border of slices 0 and 1, NaNs in two
    slices, -0.0 before 0.0 as the maximum, all -inf, all equal, and a
    random row."""
    rng = np.random.RandomState(v + s)
    rows = rng.randn(6, v).astype(np.float32)
    runs = tpa._argmax_slices(v, s, offset)
    border = runs[1][1][0][0] if s > 1 and runs[1][1] else v // 2
    last = runs[-1][1][0][0] if runs[-1][1] else v - 1
    rows[0, [max(border - 1, 0), border]] = 9.0
    rows[1, [last, min(1, v - 1)]] = np.nan
    rows[2] = -1.0
    rows[2, [v // 2, v - 1]] = [-0.0, 0.0]
    rows[3] = -np.inf
    rows[4] = 0.25
    return rows


@pytest.mark.parametrize("v,s,threads", [(4099, 8, 64), (1000, 3, 32),
                                         (37, 8, 32), (5, 8, 32),
                                         (50304, 8, 512), (2053, 1, 128)])
def test_model_of_the_kernel_equals_jax(v, s, threads):
    rng = np.random.RandomState(0)
    for offset in (0, 1, 3):
        rows = _hard_rows(v, s, offset)
        want = np.asarray(jpa.decode_greedy_argmax(jnp.asarray(rows)))
        got = [_model(torch.from_numpy(r), s, threads, offset, rng)
               for r in rows]
        np.testing.assert_array_equal(got, want)


def test_port_on_the_cpu_equals_jax_on_the_hard_rows():
    """The port's `decode_greedy_argmax` on the CPU (its plain version)
    equals the JAX function on the slice-border, NaN, signed-zero and
    -inf rows at the megakernel's [16, 50304] plan."""
    s, _ = tpa._argmax_plan(16, 50304, SMS)
    rows = np.concatenate([_hard_rows(50304, s, 0)] * 3)[:16]
    got = tpa.decode_greedy_argmax(torch.from_numpy(rows))
    want = np.asarray(jpa.decode_greedy_argmax(jnp.asarray(rows)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
