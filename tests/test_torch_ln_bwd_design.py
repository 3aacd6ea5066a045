"""K2's summation plan for dw and db, held on the CPU before the card runs
it.

On the card K2 (`csrc/layer_norm.cu`) runs a grid of G persistent blocks
of 8 warps, G a multiple of 8 (its plan: as many clusters of 8 as the
card holds at once, no more than the rows need). Warp k of the grid
takes rows k, k + 8G, k + 16G, ..., and each lane adds its columns'
dy * xhat and dy into f32 accumulators, row after row. A block folds its
8 warps' sums into shared memory in warp order; block r of each cluster
of 8 adds slice r of the 8 blocks' sums in rank order (distributed
shared memory) into the cluster's partial; the last block to finish
slice r adds the G / 8 clusters' partials in cluster order and rounds
once to w's dtype. dx keeps its per-row arithmetic and is not affected.
`emulate_k2` does the same in plain PyTorch (each product rounded to f32
before its add: the kernel may fuse the two, a rounding the rule
covers). The emulation is held to K2's rule (f32 1e-5 x (1 + max|ref|);
bf16 2 ulps + 1e-5 x max|ref|; f16 2 f16 ulps + 1e-5 x (1 + max|ref|))
against `layer_norm_bwd_reference` at grids of one to 33 clusters (the
H100's 264 blocks at [16384, 768]), and against the JAX package's
`layer_norm_fused` VJP (its Pallas backward in interpret mode, as its
own tests run it) in f32, bf16 and f16.
"""
import contextlib
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import layer_norm as tln

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
WARPS, CLUSTER = 8, 8
ULPS, F32_TOL = 2, 1e-5
_DT = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
       torch.float16: np.float16}


@contextlib.contextmanager
def _disable_x64():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def jln():
    """The JAX Pallas LayerNorm module in interpret mode, importable
    under a working stand-in for `jax.experimental.disable_x64` (jax
    releases without the name fail its import); both are undone, and the
    module dropped, at teardown."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64", _disable_x64, raising=False)
    try:
        from paddle_tpu.ops.pallas import layer_norm as mod
        mp.setattr(mod, "_INTERPRET", True)
        yield mod
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def plan_grid(rows: int, resident: int = 33) -> int:
    """K2's grid (`ptt_layer_norm_bwd_plan`): the clusters the card
    holds at once (33 of 8 blocks: two blocks on each of an H100's 132
    SMs), no more than the rows need."""
    return CLUSTER * max(1, min(resident, -(-rows // (WARPS * CLUSTER))))


def emulate_k2(dy, x, w, eps, grid):
    """dw, db as K2 sums them with `grid` blocks, in w's dtype."""
    assert grid % CLUSTER == 0
    rows, cols = x.shape
    xc, rstd = tln._stats(x.float(), eps)
    xhat = xc * rstd
    g = dy.float()
    terms = torch.cat([g * xhat, g], dim=1)          # [rows, 2 * cols]
    nw = grid * WARPS
    lanes = torch.zeros(nw, 2 * cols)               # per-warp f32 sums
    for i in range(0, rows, nw):                    # each warp's next row
        n = min(nw, rows - i)
        lanes[:n] = lanes[:n] + terms[i:i + n]
    blocks = lanes.reshape(grid, WARPS, 2 * cols)
    red = torch.zeros(grid, 2 * cols)
    for k in range(WARPS):                          # warp order
        red = red + blocks[:, k]
    clusters = red.reshape(grid // CLUSTER, CLUSTER, 2 * cols)
    part = torch.zeros(grid // CLUSTER, 2 * cols)
    for k in range(CLUSTER):                        # rank order
        part = part + clusters[:, k]
    total = torch.zeros(2 * cols)
    for c in range(grid // CLUSTER):                # cluster order
        total = total + part[c]
    return total[:cols].to(w.dtype), total[cols:].to(w.dtype)


def _ulp(x, dtype):
    _, e = torch.frexp(x.abs())
    ulp = torch.ldexp(torch.ones_like(x), e - (8 if dtype == torch.bfloat16
                                               else 11))
    if dtype == torch.float16:
        ulp = torch.clamp(ulp, min=2.0 ** -24)
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def _within_rule(got, want):
    dtype = got.dtype
    got, want = got.float(), want.float()
    ref_max = want.abs().max().item()
    if dtype == torch.bfloat16:
        allowed = ULPS * _ulp(want, dtype) + F32_TOL * ref_max
    elif dtype == torch.float16:
        allowed = ULPS * _ulp(want, dtype) + F32_TOL * (1 + ref_max)
    else:
        allowed = torch.full_like(want, F32_TOL * (1 + ref_max))
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert (diff <= allowed).all(), (diff / allowed).max().item()


def _case(rows, cols, dtype, seed=0):
    rs = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    return ((mk(rows, cols) * 2 + 1).to(dtype), mk(rows, cols).to(dtype),
            mk(cols).to(dtype))


def test_plan_grid_at_the_card_shapes():
    """The H100's grids: 264 blocks (33 clusters) at the training step's
    16384 rows, 64 (8 clusters) at the serving step's 512, one cluster
    for a few rows."""
    assert plan_grid(16384) == 264
    assert plan_grid(512) == 64
    assert plan_grid(3) == 8 and plan_grid(0) == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols,grid", [
    (3, 96, 8), (300, 256, 8), (1000, 768, 24), (4229, 768, 264)])
def test_emulated_sums_within_rule_of_the_reference(dtype, rows, cols,
                                                    grid):
    x, dy, w = _case(rows, cols, dtype)
    _, dw, db = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)
    got = emulate_k2(dy, x, w, 1e-5, grid)
    for g, want in zip(got, (dw, db)):
        assert g.dtype == dtype
        _within_rule(g, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols", [(64, 256), (40, 768)])
def test_emulated_sums_within_rule_of_the_jax_vjp(jln, dtype, rows, cols):
    """dw and db in K2's order, and dx from the plain version (its order
    is unchanged), against the JAX `layer_norm_fused` VJP."""
    x, dy, w = _case(rows, cols, dtype, seed=1)
    b = torch.zeros_like(w)
    jt = lambda t: jnp.asarray(t.float().numpy().astype(_DT[dtype]))
    _, vjp = jax.vjp(lambda x_, w_, b_: jln.layer_norm_fused(
        x_, w_, b_, 1e-5, 16), jt(x), jt(w), jt(b))
    want = [torch.from_numpy(np.asarray(a).astype(np.float32)).to(dtype)
            for a in vjp(jt(dy))]
    dx = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)[0]
    got = (dx, *emulate_k2(dy, x, w, 1e-5, plan_grid(rows)))
    for g, ref in zip(got, want):
        _within_rule(g, ref)
