"""K11's summation plan, held on the CPU before the card runs it.

On the card K11 (`csrc/lora_paged.cu`) computes t = x . A once per row
over a thread-block cluster: block c of nc sums the c-th slice of IN in
whole 16-wide k-steps (one mma.sync k-step each: f32 products of 16
terms added into an f32 accumulator, step after step), the nc partials
are added in rank order 0 .. nc-1, and t is rounded to the dtype; then
d = t . B in f32, rounded, times the scale rounded. `emulate_k11` does
the same in plain PyTorch, with the cluster size and slices of the
kernel's plan (`plan`, a copy of `make_plan`'s arithmetic). At the
serving shapes and ranks 1-16, in bf16 and f16, the emulation is held
to chip_smoke.py's K11 rule (2 ulps + 1e-5 x max|ref| + one ulp of t
carried through B and the scale) against `lora_delta_paged_reference`
and against the JAX package's `lora_delta_paged` on its jnp path: the
rule's allowance covers the new order of t's sums.
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
from paddle_tpu_torch.ops.cuda import paged_attention as tpa

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# chip_smoke.py's rule: 2 ulps of the output's dtype + 1e-5 x max|ref|
# (f16: x (1 + max|ref|)) + one ulp of t through B and the scale
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
    try:
        yield
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def plan(b, w, cin, cout):
    """(blocks a cluster, IN slice of a block) as `make_plan` chooses
    them: enough blocks for the 132 SMs, at most 8 a cluster, each slice
    whole 16-wide k-steps."""
    wc = min(64, -(-max(w, 1) // 16) * 16)
    nwc = -(-w // wc)
    nk, nn = max(1, -(-cin // 16)), max(1, -(-cout // 8))
    nc = min(8, max(1, -(-132 // (b * nwc))), nk, nn)
    return nc, -(-nk // nc) * 16


def emulate_k11(x, a_pool, b_pool, apage, ascale):
    """K11's arithmetic in plain PyTorch (see the module note)."""
    dt = x.dtype
    b, w, cin = x.shape
    nc, ks = plan(b, w, cin, b_pool.shape[2])
    ap = apage.long()
    xf, af = x.float(), a_pool[ap].float()      # [B, W, IN], [B, IN, R]
    t = torch.zeros(b, w, af.shape[2])
    for c in range(nc):                                 # rank order
        part = torch.zeros_like(t)
        for k0 in range(c * ks, min(cin, (c + 1) * ks), 16):   # k-steps
            step = xf[:, :, k0:k0 + 16, None] * af[:, None, k0:k0 + 16, :]
            part = part + step.sum(dim=2)
        t = t + part
    t = t.to(dt).float()
    d = torch.bmm(t, b_pool[ap].float()).to(dt).float()
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


def _operands(seed, b, w, cin, cout, r, dtype, pages=9):
    """numpy f32 operands as `launch_check.lora_batch` builds them (page
    0 the zero page, one row at scale 0), rounded to `dtype`."""
    rs = np.random.RandomState(seed)
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


_CASES = [*((16, 32, 768, 768, r) for r in range(1, 17)),
          (5, 33, 200, 328, 8), (5, 70, 1000, 600, 16),
          (16, 3, 4096, 2064, 8)]


def _case_operands(case, dtype):
    b, w, cin, cout, r = case
    return _operands(b * 100 + r, b, w, cin, cout, r, dtype)


_JAX_OUT = {}


def _jax_output(case, dtype):
    """The JAX op's output for `case`: every case of a dtype in one jitted
    call (one compile instead of one per shape)."""
    if dtype not in _JAX_OUT:
        ops = [[jnp.asarray(a) for a in _case_operands(c, dtype)]
               for c in _CASES]
        run = jax.jit(lambda all_ops: [jpa.lora_delta_paged(*o)
                                       for o in all_ops])
        _JAX_OUT[dtype] = [np.asarray(o).astype(np.float32)
                           for o in run(ops)]
    return _JAX_OUT[dtype][_CASES.index(case)]


@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("b,w,cin,cout,r", _CASES)
def test_k11_plan_meets_its_rule(dtype, b, w, cin, cout, r):
    """The emulated plan against the plain version and the JAX op, by
    chip_smoke.py's rule; base-page and zero-scale rows exactly 0."""
    ops = _case_operands((b, w, cin, cout, r), dtype)
    tdt, _ = _DT[dtype]
    x, A, B = (torch.from_numpy(a.astype(np.float32)).to(tdt)
               for a in ops[:3])
    apage, ascale = (torch.from_numpy(a) for a in ops[3:])
    got = emulate_k11(x, A, B, apage, ascale)
    zero = (apage == 0) | (ascale == 0)
    assert not got[zero].any()
    ref = tpa.lora_delta_paged_reference(x, A, B, apage, ascale)
    _within_rule(got, ref, x, A, B, apage, ascale)
    want = torch.from_numpy(_jax_output((b, w, cin, cout, r), dtype)).to(
        tdt)
    _within_rule(got, want, x, A, B, apage, ascale)


def test_plan_covers_the_card_at_the_serving_shapes():
    """16 rows of 32 positions at IN = OUT = 768: clusters of 8 blocks
    (128 blocks), each summing 96 of IN; wider batches take smaller
    clusters, and a cluster never has more blocks than k-steps."""
    assert plan(16, 32, 768, 768) == (8, 96)
    assert plan(64, 32, 768, 768) == (3, 256)
    assert plan(200, 32, 768, 768) == (1, 768)
    assert plan(1, 1, 40, 768) == (3, 16)
