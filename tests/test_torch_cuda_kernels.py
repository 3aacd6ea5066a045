"""The hand-written CUDA kernels against their plain versions, on the
card. Every test here needs CUDA and `nvcc` and is marked `cuda`; without
a card it skips. Run them on the GPU machine with
`python -m pytest tests/test_torch_cuda_kernels.py -q`.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import layer_norm as tln
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.nn.functional.attention import (_mask_to_kernel_operands,
                                                      _sdpa_ref)
from paddle_tpu_torch.ops.cuda.launch_check import (FLASH_SERVING_CASES,
                                                    decode, decode_batch,
                                                    flash_serving_batch,
                                                    grouped, grouped_batch,
                                                    lane_batch, lora_batch,
                                                    ragged,
                                                    ragged_reference)
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

pytestmark = pytest.mark.cuda

# K6 against its plain version: f32 differs by summation order only;
# bf16 by the rounding of the output (the plain version rounds the same
# f32 values, so mostly 0 or 1 ulp)
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}
# the other kernels against their plain versions, both computing in f32
# from the same inputs: an f32 output within F32_TOL x (1 + max|ref|)
# (summation order); a bf16 output, element by element, within BF16_ULPS
# ulps of the reference element plus F32_TOL x max|ref|; an f16 output
# within BF16_ULPS f16 ulps plus the f32 rule's F32_TOL x (1 + max|ref|)
# (f16 keeps three more bits than bf16, so where an output is what is
# left of a cancellation, as dq with one key, the f32 summation noise of
# the cancelled terms can pass two of its ulps). The tensor-core flash
# kernels (K3, K4, K5 in bf16 and f16) round P_eff and dS to the operand
# dtype before their second product, as the TPU kernel does: their checks
# add, per element, one such rounding carried through that product
# (`tfa.fwd_rounding_allowance`, `tfa.dq_rounding_allowance`,
# `tfa.dkv_rounding_allowance`; see `_flash_extras`)
F32_TOL, BF16_ULPS = 1e-5, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(512, 768), (7, 256), (3, 1000)])
def test_layer_norm_kernel(cuda, dtype, rows, cols):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(rows, cols, generator=g, device=cuda) * 2 + 1).to(dtype)
    w = torch.randn(cols, generator=g, device=cuda).to(dtype)
    b = torch.randn(cols, generator=g, device=cuda).to(dtype)
    before = tln.LAUNCHES
    y = tln.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert tln.LAUNCHES == before + 1
    _close(y, tln.layer_norm_reference(x, w, b, 1e-5))


def _mixed_batch(cuda, dtype, h, hkv, d=64, ps=16, lq=32, seed=0):
    rs = np.random.RandomState(seed)
    b, mp = 6, 8
    n_pages = 1 + b * mp
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[0] = 0
    pos = np.array([0, 15, 16, 47, 0, 90], np.int32)
    q_len = np.array([0, 1, 1, 5, 32, 32], np.int32)
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        cuda, dtype)
    return (mk(b, lq, h, d), mk(n_pages, ps, hkv, d), mk(n_pages, ps, hkv, d),
            *(torch.from_numpy(a).to(cuda) for a in (table, pos, q_len)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(12, 12), (12, 6)])
def test_ragged_paged_attention_kernel(cuda, dtype, h, hkv):
    args = _mixed_batch(cuda, dtype, h, hkv)
    before = tpa.LAUNCHES
    out = tpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 1
    ref = tpa.ragged_attention_reference(*args)
    q_len = args[5].cpu()
    live = torch.arange(out.shape[1])[None, :] < q_len[:, None]
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float().cpu()[live],
                               ref.float().cpu()[live], **TOL[dtype])


def test_engine_tokens_on_the_card_equal_the_cpu(cuda):
    """The engine at its defaults (grouped walk on): the same greedy
    tokens on the card as on the CPU, K10's two phases and K1 launched
    the number of times each step needs, K6 not at all."""
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, size=n).astype(np.int64)
               for n in (5, 11, 17, 8)]
    tokens = {}
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu")
        model.to(dev)
        eng = ServingEngine(model, device=dev, num_slots=4, max_len=64,
                            page_size=8, chunk_len=8)
        tln.reset_launches()
        tpa.reset_launches()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        tokens[str(dev)] = [r.token_ids for r in res]
        if dev is cuda:
            steps = eng.metrics.unified_steps
            assert tpa.GROUPED_LAUNCHES == {"phase1": 2 * steps,
                                            "phase2": 2 * steps}
            assert tpa.LAUNCHES == 0
            assert tln.LAUNCHES == 5 * steps
    assert tokens["cpu"] == tokens[str(cuda)]


# K10's batches: two prefix groups (rows 1-3 share 4 pages, rows 4-5 two)
_GROUPS = ((1, 3, 4), (4, 2, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(12, 12, 64), (16, 4, 128)])
def test_grouped_paged_attention_kernel(cuda, dtype, h, hkv, d):
    """K10 against its plain version: the output on live queries, and
    the phase-1 partials of every row phase 1 folds (its only writes)."""
    ops, grp = grouped_batch(cuda, dtype, h, hkv, d, rows=6, mp=8,
                             groups=_GROUPS)
    assert int(grp[2].max()) == 4
    before = dict(tpa.GROUPED_LAUNCHES)
    out = tpa.ragged_paged_attention_grouped(*ops, *grp)
    torch.cuda.synchronize()
    assert {n: tpa.GROUPED_LAUNCHES[n] - before[n] for n in before} == \
        {"phase1": 1, "phase2": 1}
    ref, (m, l, acc, written) = tpa.grouped_attention_reference(
        *ops, *grp, return_partials=True)
    live = torch.arange(out.shape[1], device=cuda)[None, :] \
        < ops[5][:, None]
    assert torch.isfinite(out.float()).all()
    _close(out[live], ref[live])
    # the kernel's partials, from a phase-1 launch of their own
    partials = tpa.grouped_phase1(*ops, *grp)
    torch.cuda.synchronize()
    sel = written & (m > tpa.NEG_INF / 2)      # member rows, live queries
    assert sel.any()
    for got, want in zip(partials, (m, l, acc)):
        _close(got[sel], want[sel])


def test_paged_walks_are_bit_reproducible(cuda):
    """K6 and K10 give the same bits on every run: a race between the
    threads of a block would show as run-to-run differences."""
    ops, grp = grouped_batch(cuda, torch.bfloat16, 12, 12, 64)
    first = (tpa.ragged_paged_attention(*ops),
             tpa.ragged_paged_attention_grouped(*ops, *grp))
    for _ in range(20):
        assert torch.equal(tpa.ragged_paged_attention(*ops), first[0])
        assert torch.equal(tpa.ragged_paged_attention_grouped(*ops, *grp),
                           first[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(12, 12, 64), (16, 4, 128)],
                         ids=["rep1", "rep4"])
def test_grouped_walk_equals_k6_bit_for_bit(cuda, dtype, h, hkv, d):
    """K10 walks every row's pages in K6's order with K6's arithmetic:
    the outputs are the same bits, dead queries included, at the serving
    step's geometry (seven rows sharing 16 pages)."""
    ops, grp = grouped_batch(cuda, dtype, h, hkv, d)
    assert int(grp[2].max()) == 16
    out = tpa.ragged_paged_attention_grouped(*ops, *grp)
    want = tpa.ragged_paged_attention(*ops)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_engine_tokens_grouped_on_and_off_identical_on_the_card(cuda):
    """Shared-prefix traffic through the engine on the card with the
    grouped walk on and off: the same greedy tokens, K10 on one arm and
    K6 on the other, and groups of two or more rows formed."""
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    rs = np.random.RandomState(6)
    system = rs.randint(0, 256, size=20)
    prompts = [np.concatenate([system, rs.randint(0, 256, size=n)])
               for n in (3, 9, 5, 12, 7)]
    model = GPTForCausalLM(cfg, device="cpu").to(cuda)
    tokens = {}
    for grouped in (True, False):
        eng = ServingEngine(model, device=cuda, num_slots=4, max_len=64,
                            page_size=8, chunk_len=8, grouped=grouped)
        eng.generate(prompts[:1], SamplingParams(max_new_tokens=4))
        tpa.reset_launches()
        steps = -eng.metrics.unified_steps
        res = eng.generate(prompts[1:], SamplingParams(max_new_tokens=8))
        tokens[grouped] = [r.token_ids for r in res]
        steps += eng.metrics.unified_steps
        if grouped:
            assert tpa.GROUPED_LAUNCHES["phase2"] == 2 * steps
            assert tpa.LAUNCHES == 0
            assert eng.metrics.group_size_hist.max >= 2
        else:
            assert tpa.LAUNCHES == 2 * steps
            assert tpa.GROUPED_LAUNCHES["phase2"] == 0
    assert tokens[True] == tokens[False]


# -- K10's ring walk over the card-test shapes ------------------------------
def _k10_case(cuda, dtype, rep, d, ps, seed=0, mp=6):
    """Fourteen rows of up to 17 queries over pools of page size `ps`, 2
    kv heads, `mp` table entries a row: row 0 idle on the trash page;
    rows 1-12 one group sharing 3 pages, declared by hand (more members
    than the 8 warps of a block have rows for at rep 1), with q_len 0-17
    so their live query blocks differ, one member idle and one whose
    first query block ends inside the span; row 13 alone."""
    rs = np.random.RandomState(seed)
    b, lq, hkv = 14, 17, 2
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, mp)
    table[0] = 0
    table[1:13, :3] = table[1, :3]
    q_len = np.array([0, 17, 1, 5, 0, 9, 3, 1, 17, 8, 1, 16, 2, 4], np.int32)
    pos = np.array([rs.randint(3 * ps, mp * ps - max(ql, 1) + 1)
                    for ql in q_len], np.int32)
    pos[0] = 0
    pos[3] = ps                       # block 0 ends on page 1 of the 3
    gid = np.array([0] + [1] * 12 + [2], np.int32)
    leader = np.zeros(b, np.int32)
    leader[1], leader[2] = 6, 13
    cnt = np.zeros(b, np.int32)
    cnt[1] = 3
    mk = lambda *sh: torch.from_numpy(rs.randn(*sh).astype(np.float32)).to(
        cuda, dtype)
    ops = (mk(b, lq, hkv * rep, d), mk(n_pages, ps, hkv, d),
           mk(n_pages, ps, hkv, d),
           *(torch.from_numpy(a).to(cuda) for a in (table, pos, q_len)))
    return ops, tuple(torch.from_numpy(a).to(cuda) for a in (gid, leader,
                                                              cnt))


def _check_k10(ops, grp, scales):
    """K10's output equals K6's (K7's) bit for bit, its partials match
    the plain partials on the rows phase 1 folds, and 20 reruns repeat
    both bit for bit. Returns the launch `grouped_plan` reports."""
    plan = tpa.grouped_plan(ops[0], ops[1])
    assert plan["stages"] in (0, 2) and plan["tiles"] == (2 if plan[
        "stages"] else 1)
    assert plan["smem"] <= 232448 - 2064 and plan["threads"] == 256
    args = tpa._grouped_check(*ops, *grp, **scales)
    part = tpa.grouped_phase1(*args, **scales)
    out = tpa.grouped_phase2(*args, part, **scales)
    want = ragged(ops, scales)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    _, (m, l, acc, written) = tpa.grouped_attention_reference(
        *ops, *grp, return_partials=True, **scales)
    sel = written & (m > tpa.NEG_INF / 2)
    assert sel.any()
    for got, ref in zip(part, (m, l, acc)):
        _close(got[sel], ref[sel])
    for _ in range(20):
        again = tpa.grouped_phase1(*args, **scales)
        assert all(torch.equal(x[sel], y[sel]) for x, y in zip(again, part))
        assert torch.equal(tpa.grouped_phase2(*args, again, **scales), out)
    return plan


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("ps", [8, 16, 32, 64])
def test_grouped_ring_walk_over_shapes(cuda, ps, d, rep):
    """K10 in every lane and dtype at page size `ps`, head dim `d` and
    rep `rep` (`_check_k10`): every one of these shapes takes a launch,
    the ring where it fits shared memory, else direct page loads."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        base, grp = _k10_case(cuda, dtype, rep, d, ps)
        for lane in ("fp", "fp8", "q8"):
            ops, scales = lane_batch(base, lane)
            plan = _check_k10(ops, grp, scales)
            assert plan["paired"] == (ps == 16), (dtype, lane)


@pytest.mark.parametrize("dtype,d,ps,rep,mp", [
    (torch.float32, 256, 64, 1, 6), (torch.float32, 256, 64, 4, 6),
    (torch.float32, 128, 128, 1, 6), (torch.float32, 128, 128, 8, 6),
    (torch.float32, 256, 16, 8, 300), (torch.bfloat16, 256, 64, 2, 6),
    (torch.float16, 256, 64, 4, 6)])
def test_grouped_walk_takes_every_shape_k6_takes(cuda, dtype, d, ps, rep,
                                                 mp):
    """Shapes where two f32 tiles and the ring's stages do not fit shared
    memory beside the block's rows (large pages, head dim 256, rep 8, a
    page table of 300 entries), which K6 and the grouped walk took before
    the ring: K10 loads those pages straight into one tile and still
    equals K6 (K7) bit for bit (`_check_k10`)."""
    base, grp = _k10_case(cuda, dtype, rep, d, ps, mp=mp)
    stages = []
    for lane in ("fp", "fp8", "q8"):
        ops, scales = lane_batch(base, lane)
        stages.append(_check_k10(ops, grp, scales)["stages"])
    assert stages[0] == 0, stages      # the fp lane cannot take the ring


def _bf16_ulp(x, dtype=torch.bfloat16):
    """The spacing of bf16 (or f16) values at |x| (0 at 0)."""
    _, e = torch.frexp(x.abs())
    ulp = torch.ldexp(torch.ones_like(x), e - (8 if dtype == torch.bfloat16
                                               else 11))
    if dtype == torch.float16:   # subnormals: a fixed spacing
        ulp = torch.clamp(ulp, min=2.0 ** -24)
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def _close(got, want, extra=None):
    """got within F32_TOL / BF16_ULPS of want (see above), by got's
    dtype, plus `extra` per element where a kernel states an
    allowance."""
    dtype = got.dtype
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    ref_max = want.abs().max().item()
    if dtype == torch.bfloat16:
        allowed = BF16_ULPS * _bf16_ulp(want) + F32_TOL * ref_max
    elif dtype == torch.float16:
        allowed = BF16_ULPS * _bf16_ulp(want, dtype) + F32_TOL * (1 + ref_max)
    else:
        allowed = torch.full_like(want, F32_TOL * (1.0 + ref_max))
    if extra is not None:
        allowed = allowed + extra
    diff = (got - want).abs()
    assert (diff <= allowed).all(), (diff / allowed).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols", [(4096, 768), (7, 256), (3, 1000)])
def test_layer_norm_bwd_kernel(cuda, dtype, rows, cols):
    g = torch.Generator(device=cuda).manual_seed(1)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x, dy = (mk(rows, cols) * 2 + 1).to(dtype), mk(rows, cols).to(dtype)
    w = mk(cols).to(dtype)
    before = tln.BWD_LAUNCHES
    got = tln.layer_norm_bwd(dy, x, w, 1e-5)
    torch.cuda.synchronize()
    assert tln.BWD_LAUNCHES == before + 1
    want = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a, b)


def test_layer_norm_bwd_kernel_is_bit_reproducible(cuda):
    """K2 folds its warps and blocks in a fixed order, without atomics:
    dw and db are the same bits on every run."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x, dy = (torch.randn(8192, 768, generator=g, device=cuda)
             for _ in range(2))
    w = torch.randn(768, generator=g, device=cuda)
    first = tln.layer_norm_bwd(dy, x, w, 1e-5)
    for _ in range(3):
        again = tln.layer_norm_bwd(dy, x, w, 1e-5)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_layer_norm_on_the_card_raises_what_the_kernels_cannot_take(cuda):
    """No plain fallback on the card: the kernels' wrapper raises for a
    width that is not a multiple of 16 bytes, a width past MAX_COLS and
    f64 weights, while the functional LayerNorm routes each of them, by
    shape before any launch, to the port of the JAX jnp branch."""
    from paddle_tpu_torch.nn import functional as PF
    cases = [(torch.bfloat16, 100, torch.bfloat16),
             (torch.float32, tln.MAX_COLS + 4, torch.float32),
             (torch.float32, 768, torch.float64)]
    for dtype, cols, wdtype in cases:
        x = torch.randn(4, cols, device=cuda).to(dtype)
        w = torch.ones(cols, device=cuda, dtype=wdtype)
        b = torch.zeros(cols, device=cuda, dtype=wdtype)
        with pytest.raises((TypeError, ValueError)):
            tln.layer_norm(x, w, b)
        before = tln.LAUNCHES
        y = PF.layer_norm(x, cols, w, b)
        assert tln.LAUNCHES == before and y.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_on_the_card_carries_gradients(cuda, dtype):
    """The LayerNorm layer's output on the card has a grad_fn, and x,
    weight and bias get the gradients of the plain version's autograd."""
    from paddle_tpu_torch.nn import LayerNorm
    g = torch.Generator(device=cuda).manual_seed(2)
    layer = LayerNorm(768, device=cuda, dtype=dtype)
    with torch.no_grad():
        layer.weight.normal_(generator=g)
        layer.bias.normal_(generator=g)
    x = torch.randn(3, 40, 768, generator=g, device=cuda).to(dtype)
    x.requires_grad_(True)
    dy = torch.randn(3, 40, 768, generator=g, device=cuda).to(dtype)
    y = layer(x)
    assert y.grad_fn is not None
    y.backward(dy)
    xr = x.detach().clone().requires_grad_(True)
    wr = layer.weight.detach().clone().requires_grad_(True)
    br = layer.bias.detach().clone().requires_grad_(True)
    tln.layer_norm_reference(xr, wr, br, 1e-5).backward(dy)
    for got, want in ((x.grad, xr.grad), (layer.weight.grad, wr.grad),
                      (layer.bias.grad, br.grad)):
        assert got is not None and got.dtype == dtype
        _close(got, want)


def _attn_case(cuda, dtype, d, lq, lk, masks, seed=0):
    rs = np.random.RandomState(seed)
    b, h = 2, 3
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
        cuda, dtype)
    q, k, v, do = mk(b, lq, h, d), mk(b, lk, h, d), mk(b, lk, h, d), \
        mk(b, lq, h, d)
    bias = kvec = None
    if masks:
        bias = torch.from_numpy(rs.randn(1, h, lq, lk).astype(np.float32)
                                ).to(cuda)
        kvec = torch.from_numpy(np.where(rs.rand(b, lk) < 0.2, -1e30, 0.0)
                                .astype(np.float32)).to(cuda)
    seeds = torch.tensor([-123456789, 987654321], dtype=torch.int32,
                         device=cuda)
    return q, k, v, do, bias, kvec, seeds


def _flash_extras(q, k, v, o, lse, do, args):
    """The tensor-core design's per-element allowances of (o, dq, dk,
    dv) for rounding P_eff and dS to the operand dtype; None for a kernel
    that runs on the CUDA cores at this dtype and head dim."""
    design = tfa.kernel_design(q.dtype, q.shape[-1])
    tc = {n: design[n] == tfa.TENSOR_CORES for n in design}
    eo = tfa.fwd_rounding_allowance(q, k, v, *args) if tc["fwd"] else None
    bwd = (q, k, v, lse, tfa._row_dot(o, do), do, *args)
    eq = tfa.dq_rounding_allowance(*bwd) if tc["dq"] else None
    ek = ev = None
    if tc["dkv"]:
        ek, ev = tfa.dkv_rounding_allowance(*bwd)
    return eo, eq, ek, ev


def _close_lse(got, want):
    """lse: -inf exactly where the plain version has it (a query that
    sees no key), the f32 rule elsewhere."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isneginf(got), ~fin)
    _close(got[fin], want[fin])


def _check_flash(q, k, v, do, args):
    """K3, K4 and K5 once each against their plain versions, with the
    tensor-core allowances; returns (o, lse)."""
    before = dict(tfa.LAUNCHES)
    o, lse = tfa.flash_attention_fwd(q, k, v, *args)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, *args)
    eo, eq, ek, ev = _flash_extras(q, k, v, o, lse, do, args)
    _close(o, o_ref, eo)
    _close_lse(lse, lse_ref)
    for got, want, extra in zip(
            (dq, dk, dv), tfa.flash_bwd_reference(q, k, v, o, lse, do, *args),
            (eq, ek, ev)):
        assert got.dtype == q.dtype
        _close(got, want, extra)
    return o, lse, dq


_FLASH_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", _FLASH_DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dropout_p", [0.0, 0.2])
@pytest.mark.parametrize("lq,lk,masks", [(200, 200, False), (70, 130, False),
                                         (96, 96, True)])
def test_flash_attention_kernels(cuda, dtype, d, causal, dropout_p, lq, lk,
                                 masks):
    q, k, v, do, bias, kvec, seeds = _attn_case(cuda, dtype, d, lq, lk,
                                                masks)
    _check_flash(q, k, v, do, (bias, kvec, seeds, causal, None, dropout_p))


@pytest.mark.parametrize("dtype", _FLASH_DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk", [(1, 1), (1, 63), (63, 65), (65, 63),
                                   (127, 129), (129, 127), (1024, 1024),
                                   (129, 65)])
def test_flash_attention_kernels_around_the_tile_heights(cuda, dtype, d,
                                                         causal, lq, lk):
    """Lq and Lk on either side of the 64-row warpgroup and the 64- and
    128-row blocks and key tiles; with Lq > Lk causal the first Lq - Lk
    queries see no key: o 0, lse -inf and no gradient."""
    q, k, v, do, _, _, seeds = _attn_case(cuda, dtype, d, lq, lk, False,
                                          seed=lq + lk)
    o, lse, dq = _check_flash(q, k, v, do, (None, None, seeds, causal,
                                            None, 0.2))
    if causal and lq > lk:
        blind = slice(0, lq - lk)
        assert not o[:, blind].any() and not dq[:, blind].any()
        assert torch.isneginf(lse.view(2, 3, lq)[:, :, blind]).all()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tensor_core_flash_is_bit_reproducible(cuda, d):
    """K3, K4 and K5 in bf16 20 times on the same inputs: bit for bit the
    same (K4's blocks own their queries and K5's their keys: no
    atomics)."""
    q, k, v, do, bias, kvec, seeds = _attn_case(cuda, torch.bfloat16, d, 300,
                                                300, True)
    args = (bias, kvec, seeds, True, None, 0.2)
    o, lse = tfa.flash_attention_fwd(q, k, v, *args)
    di = tfa._row_dot(o, do)
    dq = tfa.flash_attention_dq(q, k, v, lse, di, do, *args)
    dk, dv = tfa.flash_attention_dkv(q, k, v, lse, di, do, *args)
    for _ in range(19):
        o2, lse2 = tfa.flash_attention_fwd(q, k, v, *args)
        dq2 = tfa.flash_attention_dq(q, k, v, lse, di, do, *args)
        dk2, dv2 = tfa.flash_attention_dkv(q, k, v, lse, di, do, *args)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        assert torch.equal(dq, dq2)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_f32_flash_keeps_the_cuda_core_design(cuda):
    """f32 runs the CUDA-core kernels, and the library refuses a
    tensor-core launch in f32 (TF32 would break its "highest"
    semantics): there is no other way to an f32 tensor-core launch."""
    for d in tfa.HEAD_DIMS:
        assert set(tfa.kernel_design(torch.float32, d).values()) == {
            tfa.CUDA_CORES}
    q, k, v, _, _, _, _ = _attn_case(cuda, torch.float32, 64, 70, 70, False)
    p, keep = tfa._params(q, k, v, None, None, None, True, 0.125, 0.0)
    o = torch.empty_like(q)
    lse = torch.empty(6, 70, device=cuda)
    p.out0, p.out1 = o.data_ptr(), lse.data_ptr()
    p.design = tfa._DESIGN_CODES[tfa.TENSOR_CORES]
    lib = tfa._build.load("flash_attention")
    err = lib.ptt_flash_fwd(tfa.ctypes.addressof(p), 0, cuda.index,
                            tfa._build.stream_ptr(cuda))
    assert err != 0
    _check_flash(q, k, v, torch.randn_like(q),
                 (None, None, None, True, None, 0.0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16_bit_flash_has_no_cuda_core_lane(cuda, dtype):
    """bf16 and f16 have no CUDA-core instantiation left: a launch that
    asks for one is refused by every entry, never rerouted."""
    q, k, v, do, _, _, _ = _attn_case(cuda, dtype, 64, 70, 70, False)
    lse = torch.zeros(6, 70, device=cuda)
    p, keep = tfa._bwd_params(q, k, v, lse, lse, do, None, None, None, True,
                              0.125, 0.0)
    out0, out1 = torch.empty_like(q), torch.empty_like(q)
    p.out0, p.out1 = out0.data_ptr(), out1.data_ptr()
    p.design = tfa._DESIGN_CODES[tfa.CUDA_CORES]
    lib = tfa._build.load("flash_attention")
    for entry in ("ptt_flash_fwd", "ptt_flash_dq", "ptt_flash_dkv"):
        err = getattr(lib, entry)(tfa.ctypes.addressof(p),
                                  tfa._build.dtype_code(dtype), cuda.index,
                                  tfa._build.stream_ptr(cuda))
        assert err != 0, entry


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_sends_a_per_head_key_mask_to_the_kernels(cuda, dtype):
    """A [B, H, 1, Lk] mask rides K3-K5's bias operand, broadcast over
    the queries, and matches the plain versions fed the mask expanded to
    [B, H, Lq, Lk]."""
    from paddle_tpu_torch.nn import functional as PF
    rs = np.random.RandomState(8)
    b, l, h, d = 2, 100, 3, 64
    mk = lambda: torch.from_numpy(rs.randn(b, l, h, d).astype(np.float32)
                                  ).to(cuda, dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    mask = torch.from_numpy(rs.rand(b, h, 1, l) < 0.8).to(cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(tfa.LAUNCHES)
    out = PF.scaled_dot_product_attention(*leaves, mask, is_causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert {n: tfa.LAUNCHES[n] - before[n] for n in before} == \
        {"fwd": 1, "dq": 1, "dkv": 1}
    bias = torch.where(mask, 0.0, -1e30).expand(b, h, l, l)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, bias,
                                                   causal=True)
    args = (bias, None, None, True, None, 0.0)
    extras = _flash_extras(q, k, v, out.detach(), lse_ref, do, args)
    _close(out, o_ref, extras[0])
    want = tfa.flash_bwd_reference(q, k, v, out.detach(), lse_ref, do, bias,
                                   causal=True)
    for leaf, w, extra in zip(leaves, want, extras[1:]):
        _close(leaf.grad, w, extra)


@pytest.mark.parametrize("dtype", _FLASH_DTYPES)
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_reads_strided_views_in_place(cuda, dtype, d):
    """GPT's q, k, v are per-head interleaved views of one QKV tensor
    (l stride 3 H D): the kernels read them through their strides (the
    TMA maps of the tensor-core design included) and agree with the
    contiguous copies bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(2, 130, 4, 3 * d, generator=g, device=cuda
                      ).to(dtype).requires_grad_(True)
    q, k, v = qkv.split(d, dim=-1)
    assert q.stride(1) == 3 * 4 * d and not q.is_contiguous()
    out = tfa.flash_attention_blhd(q, k, v, causal=True)
    out.float().square().sum().backward()
    qkv2 = qkv.detach().clone().requires_grad_(True)
    q2, k2, v2 = (t.contiguous() for t in qkv2.split(d, dim=-1))
    out2 = tfa.flash_attention_blhd(q2, k2, v2, causal=True)
    out2.float().square().sum().backward()
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    torch.testing.assert_close(qkv.grad, qkv2.grad, rtol=0, atol=0)


def test_gpt_train_steps_on_the_card_equal_the_cpu(cuda):
    """Three AdamW steps of a small f32 GPT through the kernels on the
    card give the CPU's losses (plain versions), and launch K1-K5 the
    number of times each step needs."""
    from paddle_tpu_torch import jit, optimizer
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=128,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    rs = np.random.RandomState(9)
    ids, labels = (torch.from_numpy(rs.randint(0, 256, (2, 96)))
                   for _ in range(2))
    losses = {}
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu").to(dev)
        opt = optimizer.AdamW(learning_rate=1e-3,
                              parameters=model.named_parameters())
        step = jit.compile_train_step(
            lambda i, l: model(i, labels=l), model, opt)
        tln.reset_launches()
        tfa.reset_launches()
        losses[str(dev)] = [step(ids, labels).item() for _ in range(3)]
        if dev is cuda:
            assert (tln.LAUNCHES, tln.BWD_LAUNCHES) == (15, 15)
            assert tfa.LAUNCHES == {"fwd": 6, "dq": 6, "dkv": 6}
    # f32 on both; summation order differs between the kernels and the
    # CPU's plain versions, and Adam passes it on
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-5)


# -- the quantized lanes: K6's fp8 lane, K7, K10's q8 and fp8 lanes, K8 ----
_LANE_KERNELS = {"fp8": ("K6-fp8", "K10a-fp8", "K10b-fp8"),
                 "q8": ("K7", "K10a-q8", "K10b-q8")}


def _launches():
    return dict(tpa.QUANT_LAUNCHES)


def _delta(before):
    return {n: c - before[n] for n, c in tpa.QUANT_LAUNCHES.items()
            if c != before[n]}


@pytest.mark.parametrize("lane", ["fp8", "q8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(12, 12, 64), (16, 4, 128)],
                         ids=["rep1", "rep4"])
def test_quantized_walks_against_their_plain_versions(cuda, lane, dtype, h,
                                                      hkv, d):
    """K7 / K6's fp8 lane and K10 in the same lane against their plain
    versions on the same quantized pools: the outputs on live queries,
    and K10a's partials on the rows it folds."""
    base, grp = grouped_batch(cuda, dtype, h, hkv, d, rows=6, mp=8,
                              groups=_GROUPS)
    ops, scales = lane_batch(base, lane)
    before = _launches()
    out6 = ragged(ops, scales)
    out10 = grouped(ops, grp, scales)
    torch.cuda.synchronize()
    k6, k10a, k10b = _LANE_KERNELS[lane]
    assert _delta(before) == {k6: 1, k10a: 1, k10b: 1}
    live = torch.arange(out6.shape[1], device=cuda)[None, :] \
        < ops[5][:, None]
    assert torch.isfinite(out6.float()).all()
    assert torch.isfinite(out10.float()).all()
    _close(out6[live], ragged_reference(ops, scales)[live])
    ref, (m, l, acc, written) = tpa.grouped_attention_reference(
        *ops, *grp, return_partials=True, **scales)
    _close(out10[live], ref[live])
    partials = tpa.grouped_phase1(*tpa._grouped_check(*ops, *grp, **scales),
                                  **scales)
    torch.cuda.synchronize()
    sel = written & (m > tpa.NEG_INF / 2)
    assert sel.any()
    for got, want in zip(partials, (m, l, acc)):
        _close(got[sel], want[sel])


@pytest.mark.parametrize("lane", ["fp8", "q8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(12, 12, 64), (16, 4, 128)],
                         ids=["rep1", "rep4"])
def test_quantized_grouped_walk_equals_the_ungrouped_bit_for_bit(
        cuda, lane, dtype, h, hkv, d):
    """K10's q8 lane equals K7 and its fp8 lane K6's fp8 lane, bit for
    bit, at the serving step's geometry (seven rows sharing 16 pages)."""
    base, grp = grouped_batch(cuda, dtype, h, hkv, d)
    ops, scales = lane_batch(base, lane)
    out = grouped(ops, grp, scales)
    want = ragged(ops, scales)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_quantized_walks_are_bit_reproducible(cuda):
    base, grp = grouped_batch(cuda, torch.bfloat16, 12, 12, 64)
    for lane in ("q8", "fp8"):
        ops, scales = lane_batch(base, lane)
        first = (ragged(ops, scales), grouped(ops, grp, scales))
        for _ in range(20):
            assert torch.equal(ragged(ops, scales), first[0])
            assert torch.equal(grouped(ops, grp, scales), first[1])


def _fp8_zeros(shape, dev):
    return torch.zeros(shape, dtype=torch.uint8, device=dev).view(
        tpa.FP8_DTYPE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [1.0, 300.0])
def test_paged_scatter_kernels_equal_their_plain_versions(cuda, dtype,
                                                          scale):
    """K8's e4m3 bytes and K8-q8's codes and scales equal the plain
    versions' bit for bit outside the trash page 0; at scale 300 most
    of the values lie beyond +-448 and are clipped. Every written value is
    finite, the trash page's too."""
    rs = np.random.RandomState(11)
    b, l, hkv, d, ps, mp = 6, 32, 4, 64, 16, 5
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = torch.from_numpy(table.reshape(b, mp)).to(cuda)
    pos = torch.tensor([0, 1, 15, 40, mp * ps - 3, 70], dtype=torch.int32,
                       device=cuda)
    upd = (torch.from_numpy(rs.randn(b, l, hkv, d).astype(np.float32))
           * scale).to(cuda, dtype)
    upd[0, 0, 0] = 0.0                       # a row at the 1e-8 floor
    shape = (n_pages, ps, hkv, d)
    before = _launches()
    fp8 = tpa.paged_scatter(_fp8_zeros(shape, cuda), upd, pos, table)
    codes, sc = tpa.paged_scatter_q8(
        torch.zeros(shape, dtype=torch.int8, device=cuda),
        torch.zeros(shape[:3], device=cuda), upd, pos, table)
    torch.cuda.synchronize()
    assert _delta(before) == {"K8": 1, "K8-q8": 1}
    want8 = tpa.paged_scatter_reference(_fp8_zeros(shape, cuda), upd, pos,
                                        table)
    wantc, wants = tpa.paged_scatter_q8_reference(
        torch.zeros(shape, dtype=torch.int8, device=cuda),
        torch.zeros(shape[:3], device=cuda), upd, pos, table)
    assert torch.equal(fp8.view(torch.uint8)[1:], want8.view(torch.uint8)[1:])
    assert torch.equal(codes[1:], wantc[1:])
    assert torch.equal(sc[1:].view(torch.int32), wants[1:].view(torch.int32))
    assert torch.isfinite(fp8.float()).all() and torch.isfinite(sc).all()
    assert (sc[1:] > 0).sum() < b * l * hkv     # some went to the trash


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_engine_tokens_on_the_card_equal_the_cpu(cuda, kv):
    """The engine at its defaults over int8 or e4m3 pools: the same
    greedy tokens on the card as on the CPU, with each step launching
    the lane's write once a layer (K8: K and V in one launch) or twice
    (K8-q8) and K10's two phases once a layer."""
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, size=n).astype(np.int64)
               for n in (5, 11, 17, 8)]
    tokens = {}
    write, phase1, phase2 = {"int8": ("K8-q8", "K10a-q8", "K10b-q8"),
                             "fp8": ("K8", "K10a-fp8", "K10b-fp8")}[kv]
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu")
        model.to(dev)
        eng = ServingEngine(model, device=dev, num_slots=4, max_len=64,
                            page_size=8, chunk_len=8, kv_dtype=kv)
        tln.reset_launches()
        tpa.reset_launches()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        tokens[str(dev)] = [r.token_ids for r in res]
        if dev is cuda:
            steps = eng.metrics.unified_steps
            # K and V in one launch a layer in both lanes (K8, K8-q8)
            assert {n: c for n, c in tpa.QUANT_LAUNCHES.items() if c} == \
                {write: 2 * steps, phase1: 2 * steps,
                 phase2: 2 * steps}
            assert tpa.LAUNCHES == 0
            assert tpa.GROUPED_LAUNCHES == {"phase1": 0, "phase2": 0}
            assert tln.LAUNCHES == 5 * steps
    assert tokens["cpu"] == tokens[str(cuda)]


# -- K9: the legacy step's decode walk ---------------------------------------
def _decode_mask(kind, ops, h, seed=0):
    """None, a random additive f32 [B, H, 1, lmax] mask, or a bool
    [B, 1, 1, lmax] mask that hides all but key 0."""
    q, k, _, table = ops[:4]
    b, lmax = q.shape[0], table.shape[1] * k.shape[1]
    if kind is None:
        return None
    if kind == "additive":
        g = torch.Generator(device=q.device).manual_seed(seed)
        return torch.randn(b, h, 1, lmax, generator=g, device=q.device) * 2
    m = torch.zeros(b, 1, 1, lmax, dtype=torch.bool, device=q.device)
    m[..., 0] = True
    return m


@pytest.mark.parametrize("mask", [None, "additive", "bool"])
@pytest.mark.parametrize("lane", ["fp", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(12, 12, 64), (16, 4, 128)],
                         ids=["rep1", "rep4"])
def test_paged_decode_attention_kernel(cuda, dtype, lane, mask, h, hkv, d):
    """K9 against its plain version at the legacy decode step's geometry
    (two trash rows among 16), in both lanes, without and with a mask;
    every launch counted in its lane."""
    ops, _ = lane_batch(decode_batch(cuda, dtype, h, hkv, d, trash=2), lane)
    m = _decode_mask(mask, ops, h)
    key = "K9" if lane == "fp" else "K9-fp8"
    before = dict(tpa.DECODE_LAUNCHES)
    out = decode(ops, m)
    torch.cuda.synchronize()
    assert {n: tpa.DECODE_LAUNCHES[n] - before[n] for n in before} == \
        {n: int(n == key) for n in before}
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    add = None if m is None else tpa._mask_to_additive(
        m, out.shape[0], h, ops[3].shape[1] * ops[1].shape[1])
    _close(out, tpa.paged_attention_reference(*ops[:5], add))


@pytest.mark.parametrize("lane", ["fp", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(12, 12, 64), (16, 4, 128)],
                         ids=["rep1", "rep4"])
def test_paged_decode_attention_equals_k6_at_q_len_1(cuda, dtype, lane, h,
                                                     hkv, d):
    """K9 without a mask folds each page with K6's `attend_row` in K6's
    order: the same bits as K6 at q_len 1, trash rows included."""
    ops, _ = lane_batch(decode_batch(cuda, dtype, h, hkv, d, trash=2), lane)
    out, want = decode(ops), ragged(ops, {})
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_paged_decode_attention_is_bit_reproducible(cuda):
    ops = decode_batch(cuda, torch.bfloat16, 12, 12, 64, trash=2)
    m = _decode_mask("additive", ops, 12)
    first = (decode(ops), decode(ops, m))
    for _ in range(20):
        assert torch.equal(decode(ops), first[0])
        assert torch.equal(decode(ops, m), first[1])


def test_paged_decode_attention_raises_what_the_kernel_cannot_take(cuda):
    """No plain fallback on the card: int8 pools (those take K7) and
    tensors on two devices raise. A head dim whose pool rows are not a
    multiple of 16 bytes (12 in bf16: 24 bytes) launches K9, read in
    8-byte copies, and equals K6 at q_len 1 bit for bit."""
    ops, scales = lane_batch(decode_batch(cuda, torch.bfloat16, 12, 12, 64),
                             "q8")
    q, k, v, table, pos, _ = ops
    with pytest.raises(TypeError, match="int8 pools"):
        tpa.paged_decode_attention(q, k, v, table, pos)
    ops = decode_batch(cuda, torch.bfloat16, 4, 4, 12, rows=2, mp=64)
    q, k, v, table, pos, _ = ops
    before = tpa.DECODE_LAUNCHES["K9"]
    out = tpa.paged_decode_attention(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert tpa.DECODE_LAUNCHES["K9"] == before + 1
    assert tpa.decode_plan(q, k)["copy"] == 8
    assert torch.equal(out, ragged(ops, {}))
    _close(out, tpa.paged_attention_reference(q, k, v, table, pos))
    q, k, v, table, pos, _ = decode_batch(cuda, torch.bfloat16, 4, 4, 64,
                                          rows=2, mp=4)
    q, k, v, table, pos, _ = decode_batch(cuda, torch.bfloat16, 4, 4, 64,
                                          rows=2, mp=4)
    with pytest.raises(ValueError, match="tensors on"):
        tpa.paged_decode_attention(q, k, v, table.cpu(), pos)
    with pytest.raises(ValueError, match="mask on"):
        tpa.paged_decode_attention(q, k, v, table, pos,
                                   torch.zeros(2, 4, 1, 64))


@pytest.mark.parametrize("kv", ["fp", "int8", "fp8"])
def test_legacy_engine_tokens_on_the_card_equal_the_cpu(cuda, kv):
    """The legacy step (f32 model; float, int8 and e4m3 pools): the same
    greedy tokens on the card as on the CPU; per decode step K1 5 and
    the lane's walk 2 (K9, K7 or K9's fp8 lane), with K8 2 (K and V in
    one launch) or K8-q8 4 in the 1-byte lanes; per prefill chunk K1 5
    and K3 2; K6 and K10 never.
    Head dim 64: the prefill chunk attends through K3, which holds 64
    and 128."""
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=128)
    rs = np.random.RandomState(7)
    system = rs.randint(0, 256, size=20)
    prompts = [np.concatenate([system, rs.randint(0, 256, size=n)])
               for n in (3, 9, 5, 12, 7)]
    walk = {"fp": "K9", "int8": "K7", "fp8": "K9-fp8"}[kv]
    write = {"fp": None, "int8": "K8-q8", "fp8": "K8"}[kv]
    tokens = {}
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu").to(dev)
        eng = ServingEngine(model, device=dev, unified=False, kv_dtype=kv,
                            num_slots=4, max_len=64, page_size=8,
                            chunk_len=16)
        for mod in (tln, tpa, tfa):
            mod.reset_launches()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        tokens[str(dev)] = [r.token_ids for r in res]
        if dev is cuda:
            snap = eng.metrics.snapshot()
            steps = snap["decode_step_s"]["count"]
            chunks = snap["prefill_chunks"]
            got = {"K1": tln.LAUNCHES, "K3": tfa.LAUNCHES["fwd"],
                   "K6": tpa.LAUNCHES, **tpa.GROUPED_LAUNCHES,
                   **tpa.QUANT_LAUNCHES, **tpa.DECODE_LAUNCHES}
            want = dict.fromkeys(got, 0)
            want.update(K1=5 * (steps + chunks), K3=2 * chunks)
            want[walk] = 2 * steps
            if write:   # K and V in one launch a layer
                want[write] = 2 * (steps + chunks)
            assert got == want
    assert tokens["cpu"] == tokens[str(cuda)]



# -- K3 on the serving paths, the gather arm and generate() ------------------
@pytest.mark.parametrize("dtype", _FLASH_DTYPES)
@pytest.mark.parametrize("case", list(FLASH_SERVING_CASES))
def test_flash_attention_at_the_serving_shapes(cuda, case, dtype):
    """K3 through the model's SDPA at every shape the serving paths give
    it: the legacy prefill chunks, the gather arm's step (a per-row
    window bias) and generate()'s prefill and decode step (the window as
    a kvec at Lq 1). One launch; f32 against `_sdpa_ref`, bf16 and f16
    against `flash_attention_reference` on the same operand with the
    tensor-core allowance, and 20 runs bit for bit."""
    q, k, v, mask = flash_serving_batch(cuda, dtype, case)
    b, lq, h, _ = q.shape
    form, operand = _mask_to_kernel_operands(mask, b, h, lq, k.shape[1])
    assert form == ("kvec" if lq == 1 else "bias")
    before = tfa.LAUNCHES["fwd"]
    out = PF.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          training=False)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["fwd"] == before + 1
    if dtype == torch.float32:
        _close(out, _sdpa_ref(q, k, v, mask, False, 0.125, 0.0, None))
        return
    _close(out, tfa.flash_attention_reference(q, k, v, **{form: operand})[0],
           tfa.fwd_rounding_allowance(q, k, v, **{form: operand}))
    for _ in range(19):
        again = PF.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                training=False)
        assert torch.equal(out, again)


def test_gather_arm_and_generate_tokens_on_the_card_equal_the_cpu(cuda):
    """The unified step's gather arm (f32 model) and generate() greedy:
    the same tokens on the card as on the CPU, the gather arm launching
    K3 2 per step and no paged walk."""
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=128)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 256, size=n) for n in (3, 19, 7, 12)]
    ids = torch.from_numpy(rs.randint(0, 256, size=(3, 9)))
    served, generated = {}, {}
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu").to(dev)
        eng = ServingEngine(model, device=dev, attn_impl="gather",
                            num_slots=4, max_len=64, page_size=8,
                            chunk_len=16)
        for mod in (tln, tpa, tfa):
            mod.reset_launches()
        res = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        served[str(dev)] = [r.token_ids for r in res]
        if dev is cuda:
            steps = eng.metrics.unified_steps
            assert tfa.LAUNCHES["fwd"] == 2 * steps
            assert tpa.LAUNCHES == 0
            assert tpa.GROUPED_LAUNCHES == {"phase1": 0, "phase2": 0}
        generated[str(dev)] = model.generate(
            ids.to(dev), max_new_tokens=6).cpu()
    assert served["cpu"] == served[str(cuda)]
    assert torch.equal(generated["cpu"], generated[str(cuda)])


def test_llama_engine_and_generate_on_the_card_equal_the_cpu(cuda):
    """A small Llama (f32, 2 heads of 128 over 1 kv head): the engine at
    its defaults (K10's two phases 2 a step, no K1: RMSNorm is plain
    torch) and with adapters under the megakernel (K11 4 a layer a step),
    and generate()'s greedy, beam and int8 runs, the same tokens on the
    card as on the CPU."""
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import make_random_lora
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=2, num_key_value_heads=1,
                      intermediate_size=128, max_position_embeddings=128)
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 256, size=n) for n in (3, 19, 7, 12)]
    ids = torch.from_numpy(rs.randint(0, 256, size=(3, 9)))
    lora = make_random_lora(2, 256, 256, 128, rank=4,
                            rng=np.random.RandomState(1), amp=0.1)
    got = {}
    for dev in ("cpu", cuda):
        model = LlamaForCausalLM(cfg, device="cpu", seed=3).eval().to(dev)
        out = []
        for opts in (dict(), dict(adapters=True, megakernel=True)):
            eng = ServingEngine(model, device=dev, num_slots=4, max_len=64,
                                page_size=8, chunk_len=16, **opts)
            tenants = [0] * 4
            if eng.adapters is not None:
                eng.adapters.register("t", lora)
                tenants = [1, 0, 1, 0]
            for mod in (tln, tpa, tfa):
                mod.reset_launches()
            res = eng.generate(prompts, [SamplingParams(
                max_new_tokens=8, adapter_id=a) for a in tenants])
            out.append([r.token_ids for r in res])
            if dev is cuda:
                steps = eng.metrics.unified_steps
                assert tpa.GROUPED_LAUNCHES == {"phase1": 2 * steps,
                                                "phase2": 2 * steps}
                assert tln.LAUNCHES == 0 and tpa.LAUNCHES == 0
                assert tpa.MEGA_LAUNCHES["K11"] == (
                    8 * steps if opts else 0)
        for kw in (dict(), dict(decode_strategy="beam_search", num_beams=3),
                   dict(kv_cache_dtype="int8")):
            out.append(model.generate(ids.to(dev), max_new_tokens=6,
                                      **kw).cpu().tolist())
        got[str(dev)] = out
    assert got["cpu"] == got[str(cuda)]


@pytest.mark.parametrize("shape", [(1, 6), (8, 4 * 32000), (3, 4 * 128256)])
def test_beam_top_k_tie_order_on_the_card(cuda, shape):
    """Beam search's top-k: among equal values the lower index first, as
    `jax.lax.top_k` orders them, on the card as on the CPU."""
    from paddle_tpu_torch.nlp.generation import _top_k_stable
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 3, shape).astype(np.float32))
    want = _top_k_stable(x, min(16, shape[1]))
    got = _top_k_stable(x.to(cuda), min(16, shape[1]))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    idx = want[1]
    vals = want[0]
    assert ((vals[:, 1:] < vals[:, :-1])
            | ((vals[:, 1:] == vals[:, :-1]) & (idx[:, 1:] > idx[:, :-1]))
            ).all()


# -- K11, K12, K8's float lane, the mask lane of K6/K7, K3-K5 at D 256 -----
def _lora_case(cuda, dtype, b, w, cin, cout, r=8, pages=9, seed=0):
    rs = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(cuda)
    a_pool, b_pool = mk(pages, cin, r) * 0.05, mk(pages, r, cout) * 0.05
    a_pool[0] = 0.0
    b_pool[0] = 0.0
    apage = torch.from_numpy((np.arange(b) % pages).astype(np.int32)).to(cuda)
    ascale = torch.from_numpy(rs.rand(b).astype(np.float32)).to(cuda)
    ascale[-1] = 0.0
    return (mk(b, w, cin).to(dtype), a_pool.to(dtype), b_pool.to(dtype),
            apage, ascale)


def _check_lora(out, x, A, B, apage, ascale):
    """K11's rule (chip_smoke.py's): base-page and zero-scale rows are
    exactly 0; f32 within F32_TOL; bf16/f16 within BF16_ULPS of the
    output's dtype plus one ulp of t (rounded to that dtype between the
    products, whose f32 sums the kernel and the plain version add in
    other orders) carried through B and the scale."""
    zero = (apage == 0) | (ascale == 0)
    assert not out[zero].any()
    want = tpa.lora_delta_paged_reference(x, A, B, apage, ascale)
    if out.dtype == torch.float32:
        _close(out, want)
        return
    ap = apage.long()
    t = torch.bmm(x.float(), A[ap].float()).to(out.dtype).float()
    flip = torch.bmm(_bf16_ulp(t, out.dtype), B[ap].float().abs()) * \
        ascale.to(out.dtype).float()[:, None, None]
    _close(out, want, extra=flip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,w,cin,cout", [(16, 32, 768, 768), (5, 3, 96, 40)])
def test_lora_delta_paged_kernel(cuda, dtype, b, w, cin, cout):
    """K11 against its plain version; base-page and zero-scale rows are
    exactly 0. In bf16 a t element (rounded to bf16 between the products)
    whose f32 sums straddle a rounding point may move one bf16 ulp: the
    allowance carries that ulp through B and the scale."""
    x, A, B, apage, ascale = _lora_case(cuda, dtype, b, w, cin, cout)
    before = tpa.MEGA_LAUNCHES["K11"]
    out = tpa.lora_delta_paged(x, A, B, apage, ascale)
    torch.cuda.synchronize()
    assert tpa.MEGA_LAUNCHES["K11"] == before + 1
    assert out.dtype == dtype and out.shape == (b, w, cout)
    _check_lora(out, x, A, B, apage, ascale)


def test_lora_delta_paged_kernel_is_bit_reproducible(cuda):
    args = _lora_case(cuda, torch.bfloat16, 16, 32, 768, 768)
    first = tpa.lora_delta_paged(*args)
    for _ in range(20):
        assert torch.equal(tpa.lora_delta_paged(*args), first)


def _argmax_logits(cuda, b, v, offset=0):
    """Random f32 logits [b, v] whose rows start `offset` elements past
    a 16-byte boundary, with a tie, NaNs in two places, an all -inf row
    and -0.0 before an equal 0.0 where b and v allow."""
    g = torch.Generator(device=cuda).manual_seed(v + offset)
    flat = torch.empty(b * v + 4, device=cuda)
    logits = flat[offset:offset + b * v].view(b, v)
    logits.copy_(torch.randn(b, v, generator=g, device=cuda))
    if v > 3 and b > 2:
        logits[0, [v // 3, v - 1]] = 1e4
        logits[1, [1, v // 2]] = float("nan")
        logits[2] = float("-inf")
    if v > 3 and b > 3:
        logits[3] = -1.0
        logits[3, [v // 2, v - 1]] = torch.tensor([-0.0, 0.0], device=cuda)
    return logits


@pytest.mark.parametrize("b,v", [(16, 50304), (3, 97), (2, 1), (5, 4097),
                                 (1, 50304), (128, 50304), (16, 50257),
                                 (16, 128256), (300, 5), (16, 3)])
def test_greedy_argmax_kernel_equals_torch_argmax(cuda, b, v):
    """K12 against torch.argmax bit for bit, with a tie, NaNs, an all
    -inf row and signed zeros, in rows aligned to 16 bytes and one
    element past; 20 repeats give the same answer."""
    for offset in (0, 1):
        logits = _argmax_logits(cuda, b, v, offset)
        _check_argmax(logits)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("v", [1, 3, 5, 31, 50304])
def test_greedy_argmax_kernel_at_every_cluster_size(cuda, s, v):
    """The C entry at S blocks a row (clusters of 1-8) and 32 or 256
    threads, V from below S x 4 up, rows off a 16-byte boundary too: the
    answer is torch.argmax's, ties across slice borders included."""
    lib = _build.load("greedy_argmax")
    for offset in (0, 3):
        logits = _argmax_logits(cuda, 6, v, offset)
        for r, (_, runs) in enumerate(tpa._argmax_slices(v, s, offset)):
            if r and runs:    # the last of slice r - 1 ties the first of r
                logits[4, [runs[0][0] - 1, runs[0][0]]] = 1e5
        want = torch.argmax(logits, dim=-1)
        for threads in (32, 256):
            out = torch.empty(6, dtype=torch.int32, device=cuda)
            err = lib.ptt_greedy_argmax(logits.data_ptr(), out.data_ptr(), 6,
                                        v, s, threads, cuda.index,
                                        _build.stream_ptr(cuda))
            _build.check(lib, err, "ptt_greedy_argmax")
            torch.cuda.synchronize()
            assert torch.equal(out.long(), want), (s, threads, offset)


def test_greedy_argmax_plan_fills_the_card(cuda):
    """`_argmax_plan` at the card's SM count: 16 slots of 50304 logits
    take clusters of 8 (128 blocks), 128 or more rows a block each."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tpa._argmax_plan(16, 50304, sms)[0] == min(8, sms // 16)
    assert tpa._argmax_plan(max(128, sms), 50304, sms)[0] == 1


def _check_argmax(logits):
    before = tpa.MEGA_LAUNCHES["K12"]
    got = tpa.decode_greedy_argmax(logits)
    torch.cuda.synchronize()
    assert tpa.MEGA_LAUNCHES["K12"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), torch.argmax(logits, dim=-1))
    for _ in range(20):
        assert torch.equal(tpa.decode_greedy_argmax(logits), got)


@pytest.mark.parametrize("upd_dtype,pool_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_paged_scatter_float_lane_equals_index_copy(cuda, upd_dtype,
                                                    pool_dtype):
    """K8's float lane writes what the unfused write (`index_copy_` of
    the cast rows) writes, bit for bit outside the trash page."""
    q, k, _, table, pos, _ = _mixed_batch(cuda, upd_dtype, 4, 4)
    shape = (k.shape[0], k.shape[1], 4, q.shape[3])
    got = tpa.paged_scatter_kernel(torch.zeros(shape, dtype=pool_dtype,
                                               device=cuda), q, pos, table)
    torch.cuda.synchronize()
    want = tpa.paged_scatter_reference(torch.zeros(
        shape, dtype=pool_dtype, device=cuda), q, pos, table)
    assert torch.equal(got[1:], want[1:])


@pytest.mark.parametrize("kind", ["additive", "bool"])
@pytest.mark.parametrize("lane", ["fp", "fp8", "q8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv", [(12, 12), (12, 6)])
def test_ragged_mask_lane_kernel(cuda, dtype, lane, kind, h, hkv):
    """K6 (and its fp8 lane, K7) with a user mask against the plain
    versions with the same additive mask, on the live queries."""
    ops, scales = lane_batch(_mixed_batch(cuda, dtype, h, hkv), lane)
    q, k, _, table, pos, q_len = ops
    b, lq = q.shape[:2]
    lmax = table.shape[1] * k.shape[1]
    g = torch.Generator(device=cuda).manual_seed(3)
    if kind == "additive":
        m = torch.randn(b, h, lq, lmax, generator=g, device=cuda)
    else:
        m = torch.rand(b, 1, 1, lmax, generator=g, device=cuda) < 0.7
        m[..., 0] = True
    out = ragged(ops, scales, mask=m)
    torch.cuda.synchronize()
    ref = ragged_reference(ops, scales,
                           mask=tpa._mask_to_additive(m, b, h, lmax, lq))
    live = torch.arange(lq, device=cuda)[None, :] < q_len[:, None]
    assert torch.isfinite(out.float()).all()
    _close(out[live], ref[live])


def test_unmasked_k6_is_untouched_by_the_mask_lane(cuda):
    """A zero additive mask gives K6's unmasked output to the f32
    rounding of the added zeros: the same bits."""
    args = _mixed_batch(cuda, torch.bfloat16, 12, 6)
    plain = tpa.ragged_paged_attention(*args)
    zero = torch.zeros(1, device=cuda)
    assert torch.equal(tpa.ragged_paged_attention(*args, mask=zero), plain)


@pytest.mark.parametrize("dtype", _FLASH_DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,masks", [(200, 200, False), (70, 130, True)])
def test_flash_attention_kernels_at_head_dim_256(cuda, dtype, causal, lq, lk,
                                                 masks):
    """K3-K5 at head dim 256 against their plain versions, with dropout:
    on the tensor cores in bf16 and f16 (K4 in 64-row blocks, K5's split
    lane), on the CUDA cores in f32 (32-row tiles)."""
    q, k, v, do, bias, kvec, seeds = _attn_case(cuda, dtype, 256, lq, lk,
                                                masks)
    _check_flash(q, k, v, do, (bias, kvec, seeds, causal, None, 0.2))


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_megakernel_engine_on_the_card(cuda, kv):
    """The engine with the megakernel: the same tokens as with the gate
    off on the card and as on the CPU; with adapters (K11 for the q/k/v
    prologue and the o-delta) the tokens the CPU gives. Launches per
    step: K8-q8 4, or K8's float lane 2 (K and V in one launch), K12 1,
    K11 8 with adapters (2 layers)."""
    from paddle_tpu_torch.serving import make_random_lora
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=128)
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 256, size=n).astype(np.int64)
               for n in (5, 11, 17, 8)]
    loras = [make_random_lora(2, 64, 64, 64, rank=4,
                              rng=np.random.RandomState(i), amp=0.25)
             for i in range(2)]
    write = "K8-q8" if kv == "int8" else "K8-float"
    tokens = {}
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu").to(dev)
        for mega, lora in ((False, False), (True, False), (True, True)):
            eng = ServingEngine(model, device=dev, num_slots=4, max_len=64,
                                page_size=8, chunk_len=8, kv_dtype=kv,
                                grouped=False, megakernel=mega,
                                adapters=lora or None)
            tenants = [0] * 4
            if lora:
                for i, w in enumerate(loras):
                    eng.adapters.register(f"t{i}", w)
                tenants = [1, 0, 2, 1]
            for mod in (tln, tpa, tfa):
                mod.reset_launches()
            res = eng.generate(prompts, [SamplingParams(
                max_new_tokens=8, adapter_id=a) for a in tenants])
            tokens[str(dev), mega, lora] = [r.token_ids for r in res]
            if dev is cuda and mega:
                steps = eng.metrics.unified_steps
                counts = dict(tpa.MEGA_LAUNCHES, **{
                    "K8-q8": tpa.QUANT_LAUNCHES["K8-q8"]})
                assert counts[write] == 2 * steps   # K and V in one launch
                assert counts["K12"] == steps
                assert counts["K11"] == (8 * steps if lora else 0)
    for key in ((False, False), (True, False), (True, True)):
        assert tokens["cpu", *key] == tokens[str(cuda), *key]
    assert tokens[str(cuda), True, False] == tokens[str(cuda), False, False]


@pytest.mark.parametrize("d", [32, 256])
def test_head_dim_routes_on_the_card(cuda, d):
    """A GPT at head dim 32 takes `_sdpa_ref` on the card (no flash
    launch) on the legacy step, the gather arm and generate(); at head
    dim 256 K3 runs there. Tokens equal the CPU's."""
    heads = 256 // d if d == 32 else 1
    cfg = GPTConfig(vocab_size=256, hidden_size=d * heads,
                    num_hidden_layers=2, num_attention_heads=heads,
                    max_position_embeddings=128)
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, 256, size=n) for n in (3, 19, 12)]
    ids = torch.from_numpy(rs.randint(0, 256, size=(2, 9)))
    out = {}
    for dev in ("cpu", cuda):
        model = GPTForCausalLM(cfg, device="cpu").to(dev)
        tfa.reset_launches()
        for opts in (dict(unified=False), dict(attn_impl="gather")):
            eng = ServingEngine(model, device=dev, num_slots=4, max_len=64,
                                page_size=8, chunk_len=16, **opts)
            res = eng.generate(prompts, SamplingParams(max_new_tokens=6))
            out[str(dev), str(opts)] = [r.token_ids for r in res]
        out[str(dev), "generate"] = model.generate(
            ids.to(dev), max_new_tokens=6).cpu().tolist()
        if dev is cuda:
            assert (tfa.LAUNCHES["fwd"] > 0) is (d == 256)
    for key in [k[1] for k in out if k[0] == "cpu"]:
        assert out["cpu", key] == out[str(cuda), key]


# -- K11 with t once per row on the tensor cores, K9 on the ring -----------
@pytest.mark.parametrize("dtype", _FLASH_DTYPES)
@pytest.mark.parametrize("r", [1, 4, 8, 16])
def test_lora_kernel_at_every_rank(cuda, dtype, r):
    """K11 at the serving step's shapes (x [16, 32, 768], 9 pages) at
    ranks 1-16 in f32, bf16 and f16: the rule, and 20 repeats give the
    same bits (t's partials combined in a fixed order, no atomics)."""
    args = lora_batch(cuda, dtype, r=r)
    before = tpa.MEGA_LAUNCHES["K11"]
    out = tpa.lora_delta_paged(*args)
    torch.cuda.synchronize()
    assert tpa.MEGA_LAUNCHES["K11"] == before + 1
    assert out.dtype == dtype and out.shape == (16, 32, 768)
    _check_lora(out, *args)
    for _ in range(20):
        assert torch.equal(tpa.lora_delta_paged(*args), out)


@pytest.mark.parametrize("dtype", _FLASH_DTYPES)
@pytest.mark.parametrize("b,w,cin,cout", [
    (5, 1, 768, 768), (5, 5, 200, 328), (16, 32, 328, 200),
    (5, 33, 768, 768), (3, 33, 100, 36), (5, 70, 1000, 600),
    (16, 3, 4096, 2064)])
def test_lora_kernel_at_ragged_shapes(cuda, dtype, b, w, cin, cout):
    """K11 where W, IN and OUT are not multiples of its tiles: W of 1, 5,
    33 and 70 (two clusters a row), IN and OUT of 200 and 328, 100 and 36
    (rows not 16-byte aligned in bf16: element loads), and IN and OUT
    larger than one staged piece (4096, 2064)."""
    args = lora_batch(cuda, dtype, b=b, w=w, cin=cin, cout=cout)
    out = tpa.lora_delta_paged(*args)
    torch.cuda.synchronize()
    assert out.shape == (b, w, cout)
    _check_lora(out, *args)
    assert torch.equal(tpa.lora_delta_paged(*args), out)


def test_lora_plan_reports_the_launch(cuda):
    """At the serving step's shapes K11 runs clusters of 8 blocks a row
    (128 blocks for 16 rows), both products on the tensor cores in bf16
    and f16, f32 on the CUDA cores; a rank over 16 takes the same launch,
    its t summed in groups of ranks (all 32 at once on the tensor cores)
    and d over R in k-steps of 16."""
    for dtype in _FLASH_DTYPES:
        x, A, B, _, _ = lora_batch(cuda, dtype)
        plan = tpa.lora_plan(x, A, B)
        assert plan["cluster"] == 8 and plan["grid"] == 128, plan
        assert plan["in_slice"] == 96 and plan["out_tile"] == 96, plan
        assert plan["tensor_cores"] == int(dtype != torch.float32)
        assert plan["smem"] <= 232448 and plan["threads"] == 256
        assert plan["positions"] == 32 and plan["rank_group"] == 16, plan
    x, A, B, _, _ = lora_batch(cuda, torch.bfloat16, r=16)
    plan = tpa.lora_plan(x, A.repeat(1, 1, 2), B.repeat(1, 2, 1))
    assert plan["cluster"] == 8 and plan["grid"] == 128, plan
    assert plan["rank_group"] == 32 and plan["smem"] <= 232448, plan


_DECODE_DIRECT = [
    (torch.float32, 4, 4, 256, 64, 6), (torch.float32, 16, 4, 256, 64, 6),
    (torch.float32, 2, 2, 128, 128, 6), (torch.float32, 16, 2, 128, 128, 6),
    (torch.float32, 16, 2, 256, 16, 300), (torch.bfloat16, 8, 4, 256, 64, 6),
    (torch.float16, 16, 4, 256, 64, 6)]


@pytest.mark.parametrize("mask", [None, "additive", "bool"])
@pytest.mark.parametrize("lane", ["fp", "fp8"])
@pytest.mark.parametrize("dtype,h,hkv,d,ps,mp", _DECODE_DIRECT)
def test_paged_decode_attention_takes_every_shape(cuda, dtype, h, hkv, d,
                                                  ps, mp, lane, mask):
    """K9 where the ring's stages and two f32 tiles do not fit shared
    memory beside the rows (f32 at head dim 256 with pages of 64, pages
    of 128, rep 8) and at a 300-entry table: without a mask equal to K6
    at q_len 1 bit for bit, with one within its plain version's rule."""
    ops, _ = lane_batch(decode_batch(cuda, dtype, h, hkv, d, rows=6, ps=ps,
                                     mp=mp, trash=1), lane)
    m = _decode_mask(mask, ops, h)
    out = decode(ops, m)
    torch.cuda.synchronize()
    if m is None:
        assert torch.equal(out, ragged(ops, {}))
    else:
        add = tpa._mask_to_additive(m, out.shape[0], h, mp * ps)
        _close(out, tpa.paged_attention_reference(*ops[:5], add))


def test_decode_plan_reports_the_feeder(cuda):
    """The legacy step's shapes take the ring (two stages, two tiles), two
    rows a warp with or without a mask; the shapes the ring does not fit
    take direct page loads in the fp lane; int8 pools take no K9
    launch."""
    q, k = decode_batch(cuda, torch.bfloat16, 12, 12, 64)[:2]
    plan = tpa.decode_plan(q, k)
    assert (plan["stages"], plan["tiles"], plan["paired"]) == (2, 2, 1)
    assert plan["grid"] == 16 * 12 and plan["threads"] == 256
    for dtype, h, hkv, d, ps, mp in _DECODE_DIRECT:
        q, k = decode_batch(cuda, dtype, h, hkv, d, rows=2, ps=ps, mp=mp)[:2]
        plan = tpa.decode_plan(q, k)
        assert plan["smem"] <= 232448 and plan["rows"] == h // hkv
        if ps >= 64 and dtype == torch.float32:
            assert (plan["stages"], plan["tiles"]) == (0, 1), plan
    q, k = decode_batch(cuda, torch.bfloat16, 12, 12, 64)[:2]
    with pytest.raises(ValueError, match="no launch"):
        tpa.decode_plan(q, lane_batch((q, k, k, None, None, None),
                                      "q8")[0][1])


# -- F8: K11 at any rank; F9: the walks at every page size and head dim;
# K6 on the ring ------------------------------------------------------------
@pytest.mark.parametrize("dtype", _FLASH_DTYPES)
@pytest.mark.parametrize("r", [24, 32, 64])
def test_lora_kernel_at_large_ranks(cuda, dtype, r):
    """K11 at ranks over 16 (t summed a group of ranks at a time, d over
    R in k-steps of 16) at the serving step's shapes and at ragged ones,
    in f32, bf16 and f16: the rule, and 20 repeats give the same bits."""
    for shape in (dict(), dict(b=5, w=70, cin=1000, cout=600)):
        args = lora_batch(cuda, dtype, r=r, **shape)
        before = tpa.MEGA_LAUNCHES["K11"]
        out = tpa.lora_delta_paged(*args)
        torch.cuda.synchronize()
        assert tpa.MEGA_LAUNCHES["K11"] == before + 1
        _check_lora(out, *args)
        for _ in range(20):
            assert torch.equal(tpa.lora_delta_paged(*args), out)


# (page size, head dim): pages over 128 keys (folded in pieces), head
# dims over 256 (acc's columns in pieces), and pool rows that are not a
# multiple of 16 bytes (12 and 40: 8-byte copies in bf16, int8 and fp8,
# 4-byte ones for 12 in the 1-byte lanes; 13: single elements)
_NEW_SHAPES = [(256, 64), (256, 12), (16, 12), (16, 40), (256, 40),
               (16, 512), (256, 512), (32, 13)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,d", _NEW_SHAPES)
def test_walks_at_every_page_size_and_head_dim(cuda, ps, d, dtype):
    """K6, K7 and K10 (every lane) at shapes the walks refused before:
    K10 equals K6 (K7) bit for bit with its partials against the plain
    ones and 20 reruns the same (`_check_k10`), and K6 within its rule of
    the plain version on the live queries."""
    base, grp = _k10_case(cuda, dtype, 2, d, ps, mp=6 if ps < 256 else 4)
    for lane in ("fp", "fp8", "q8"):
        ops, scales = lane_batch(base, lane)
        plan = _check_k10(ops, grp, scales)
        assert plan["piece"] == tpa.piece_rows(d, ps) <= 128
        out = ragged(ops, scales)
        torch.cuda.synchronize()
        live = (torch.arange(out.shape[1], device=cuda)[None, :]
                < ops[5][:, None])
        _close(out[live], ragged_reference(ops, scales)[live])


@pytest.mark.parametrize("mask", [None, "additive", "bool"])
@pytest.mark.parametrize("lane", ["fp", "fp8"])
@pytest.mark.parametrize("ps,d", _NEW_SHAPES)
def test_paged_decode_attention_at_every_page_size_and_head_dim(cuda, ps, d,
                                                               lane, mask):
    """K9 at the same shapes, bf16: without a mask equal to K6 at q_len
    1 bit for bit, with one within its plain version's rule."""
    mp = max(4, 800 // ps + 1)
    ops, _ = lane_batch(decode_batch(cuda, torch.bfloat16, 4, 2, d, rows=6,
                                     ps=ps, mp=mp, trash=1), lane)
    m = _decode_mask(mask, ops, 4)
    out = decode(ops, m)
    torch.cuda.synchronize()
    if m is None:
        assert torch.equal(out, ragged(ops, {}))
    add = None if m is None else tpa._mask_to_additive(m, 6, 4, mp * ps)
    _close(out, tpa.paged_attention_reference(*ops[:5], add))


def test_walk_plans_report_pieces_and_copies(cuda):
    """The serving step's K6 launch is the ring (two stages, two tiles,
    two rows a warp, with or without a mask); a page of 256 keys is
    folded in two pieces of 128 by every walk; pool rows of 24, 40 and
    26 bytes are copied 8, 8 and 2 bytes at a time (the last without
    the ring)."""
    q, k = grouped_batch(cuda, torch.bfloat16, 12, 12, 64)[0][:2]
    plan = tpa.ragged_plan(q, k)
    assert (plan["stages"], plan["tiles"], plan["paired"]) == (2, 2, 1)
    assert (plan["piece"], plan["copy"], plan["rows"]) == (16, 16, 8)
    assert plan["grid"] == 16 * 4 * 12 and plan["threads"] == 256
    for ps, d, dtype, copy in ((256, 64, torch.bfloat16, 16),
                               (16, 12, torch.bfloat16, 8),
                               (16, 40, torch.int8, 8),
                               (16, 13, torch.bfloat16, 2)):
        q = torch.empty(2, 8, 4, d, dtype=torch.bfloat16, device=cuda)
        k = torch.empty(9, ps, 2, d, dtype=dtype, device=cuda)
        for plan in (tpa.ragged_plan(q, k), tpa.grouped_plan(q, k)):
            assert plan["piece"] == min(ps, 128), (ps, d, plan)
            assert plan["copy"] == copy, (ps, d, plan)
            assert plan["stages"] == (0 if copy < 4 else 2), plan
        if dtype != torch.int8:
            assert tpa.decode_plan(q[:, :1], k)["piece"] == min(ps, 128)


def test_ring_k6_equals_another_build(cuda):
    """K6 on the ring against K6 as another checkout builds it (the
    parent, unpacked with `git archive`, named by
    PADDLE_TPU_TORCH_OTHER): the same bits in every lane, without a mask
    and with an additive and a bool one, in f32 and bf16, on the serving
    batch, and 20 reruns the same (`walk_control.compare`)."""
    import os

    from paddle_tpu_torch.ops.cuda import walk_control

    other = os.environ.get("PADDLE_TPU_TORCH_OTHER")
    if not other:
        pytest.skip("needs another checkout in PADDLE_TPU_TORCH_OTHER")
    here = str(walk_control.Path(walk_control.__file__).resolve().parents[3])
    built = walk_control.build_others([here, other])
    libs = {"this": walk_control._load(built[here][0]),
            "other": walk_control._load(built[other][0])}
    walk_control.compare(libs, cuda, time_it=False)



# -- F10: a block's query rows split over blocks; K8 redesigned; K2
# redesigned -----------------------------------------------------------------
# (rep, head dim) where 8 queries x rep rows pass a block's shared memory:
# rep 32 at head dim 128, 71 heads of 64 over one kv head (multi-query)
_SPLIT_SHAPES = [(32, 128), (71, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,d", _SPLIT_SHAPES)
def test_walks_split_rows_that_pass_shared_memory(cuda, rep, d, dtype):
    """K6, K7 and K10 (every lane) at rep 32 / head dim 128 and rep 71 /
    head dim 64 over pages of 16, q_len up to 17: every plan splits an
    item's rows over blocks, K10 equals K6 (K7) bit for bit with its
    partials against the plain ones and 20 reruns the same
    (`_check_k10`), and K6 within its rule of the plain version on the
    live queries."""
    base, grp = _k10_case(cuda, dtype, rep, d, 16)
    for lane in ("fp", "fp8", "q8"):
        ops, scales = lane_batch(base, lane)
        for plan in (tpa.ragged_plan(ops[0], ops[1]),
                     tpa.grouped_plan(ops[0], ops[1])):
            assert plan["split"] > 1, (lane, plan)
            assert plan["rows"] * plan["split"] >= 8 * rep, plan
            assert plan["grid"] == -(-17 // 8) * 14 * 2 * plan["split"]
        _check_k10(ops, grp, scales)
        out = ragged(ops, scales)
        torch.cuda.synchronize()
        live = (torch.arange(out.shape[1], device=cuda)[None, :]
                < ops[5][:, None])
        _close(out[live], ragged_reference(ops, scales)[live])


@pytest.mark.parametrize("lane", ["fp", "fp8"])
@pytest.mark.parametrize("h,d", [(32, 128), (71, 64), (128, 256)])
def test_decode_walk_at_the_split_shapes(cuda, h, d, lane):
    """K9 over one kv head of h heads, bf16: equal to K6 at q_len 1 bit
    for bit and within its rule of the plain version. Its rep rows fit a
    block at rep 32 and 71; rep 128 at head dim 256 passes shared memory
    even at one query, and K9's rows split there as every walk's do."""
    ops, _ = lane_batch(decode_batch(cuda, torch.bfloat16, h, 1, d, rows=6,
                                     mp=50, trash=1), lane)
    plan = tpa.decode_plan(ops[0], ops[1])
    assert (plan["split"] > 1) == (h == 128), plan
    assert plan == tpa.ragged_plan(ops[0], ops[1])
    out = decode(ops)
    torch.cuda.synchronize()
    assert torch.equal(out, ragged(ops, {}))
    _close(out, tpa.paged_attention_reference(*ops[:5]))


def test_walk_plans_the_parent_launched_keep_one_block(cuda):
    """Every shape the walks launched before the split reports a split of
    1, the same grid as before (one block per query block, row and kv
    head) and all of an item's rows in its block: the serving batches,
    the card tests' K10 shapes, the direct-load shapes and the page sizes
    and head dims of F9."""
    cases = [(torch.bfloat16, 16, 32, 12, 12, 64, 16),
             (torch.bfloat16, 16, 32, 16, 4, 128, 16)]
    cases += [(dt, 14, 17, 2 * rep, 2, d, ps)
              for dt in (torch.float32, torch.bfloat16, torch.float16)
              for rep in (1, 2, 4) for d in (32, 64, 128, 256)
              for ps in (8, 16, 32, 64)]
    cases += [(dt, 14, 17, 2 * rep, 2, d, ps) for dt, d, ps, rep, _ in (
        (torch.float32, 256, 64, 1, 6), (torch.float32, 256, 64, 4, 6),
        (torch.float32, 128, 128, 1, 6), (torch.float32, 128, 128, 8, 6),
        (torch.float32, 256, 16, 8, 300), (torch.bfloat16, 256, 64, 2, 6),
        (torch.float16, 256, 64, 4, 6))]
    cases += [(dt, 14, 17, 4, 2, d, ps) for dt in (torch.float32,
                                                   torch.bfloat16)
              for ps, d in _NEW_SHAPES]
    for dt, b, lq, h, hkv, d, ps in cases:
        q = torch.empty(b, lq, h, d, dtype=dt, device=cuda)
        for pool in (dt, torch.int8, tpa.FP8_DTYPE):
            k = torch.empty(4, ps, hkv, d, dtype=pool, device=cuda)
            for plan in (tpa.ragged_plan(q, k), tpa.grouped_plan(q, k)):
                assert plan["split"] == 1, (dt, b, lq, h, d, ps, pool, plan)
                assert plan["rows"] == min(lq, 8) * h // hkv
                assert plan["grid"] == -(-lq // 8) * b * hkv
            if pool != torch.int8:
                assert tpa.decode_plan(q[:, :1], k)["split"] == 1
    for dtype, h, hkv, d, ps, mp in _DECODE_DIRECT:
        q, k = decode_batch(cuda, dtype, h, hkv, d, rows=2, ps=ps, mp=mp)[:2]
        assert tpa.decode_plan(q, k)["split"] == 1


def test_walk_refuses_only_what_one_row_cannot_fit(cuda):
    """A head dim whose single query row with its tile passes shared
    memory is refused by the plan and the launch alike, in bytes."""
    q = torch.zeros(1, 1, 1, 40000, device=cuda)
    k = torch.zeros(2, 16, 1, 40000, device=cuda)
    with pytest.raises(ValueError, match="one query row needs"):
        tpa.ragged_plan(q, k)
    table = torch.ones(1, 1, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one query row needs"):
        tpa.ragged_paged_attention(q, k, k, table, pos, pos + 1)


def _scatter_case(cuda, dtype, b=6, l=32, hkv=4, d=64, ps=16, mp=5, seed=11,
                  scale=1.0):
    rs = np.random.RandomState(seed)
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = torch.from_numpy(table.reshape(b, mp)).to(cuda)
    pos = torch.tensor([0, 1, 15, 40, mp * ps - 3, 70][:b],
                       dtype=torch.int32, device=cuda)
    upd = [(torch.from_numpy(rs.randn(b, l, hkv, d).astype(np.float32))
            * scale).to(cuda, dtype) for _ in range(2)]
    return upd, pos, table, (n_pages, ps, hkv, d)


def _zeros(shape, dtype, cuda):
    if dtype == tpa.FP8_DTYPE:
        return _fp8_zeros(shape, cuda)
    return torch.zeros(shape, dtype=dtype, device=cuda)


def _bits(pool):
    return pool.view(torch.uint8) if pool.dtype == tpa.FP8_DTYPE else pool


@pytest.mark.parametrize("upd_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16,
                                        torch.float16, tpa.FP8_DTYPE])
def test_paged_scatter_pair_equals_two_single_writes(cuda, upd_dtype,
                                                     pool_dtype):
    """K8 writing K and V in one launch: each pool equals what a single
    K8 launch writes into it and what the plain version writes, bit for
    bit outside the trash page (at 300x the scale, past +-448 for the
    e4m3 lane); one launch is counted for the pair."""
    (ku, vu), pos, table, shape = _scatter_case(cuda, upd_dtype, scale=300.0)
    key = "K8" if pool_dtype == tpa.FP8_DTYPE else "K8-float"
    count = tpa.QUANT_LAUNCHES if key == "K8" else tpa.MEGA_LAUNCHES
    before = count[key]
    kp, vp = tpa.paged_scatter_kernel_pair(
        _zeros(shape, pool_dtype, cuda), _zeros(shape, pool_dtype, cuda), ku,
        vu, pos, table)
    torch.cuda.synchronize()
    assert count[key] == before + 1
    for got, upd in ((kp, ku), (vp, vu)):
        one = tpa.paged_scatter_kernel(_zeros(shape, pool_dtype, cuda), upd,
                                       pos, table)
        want = tpa.paged_scatter_reference(_zeros(shape, pool_dtype, cuda),
                                           upd, pos, table)
        assert torch.equal(_bits(got)[1:], _bits(one)[1:])
        assert torch.equal(_bits(got)[1:], _bits(want)[1:])
    if pool_dtype == tpa.FP8_DTYPE:
        before = tpa.QUANT_LAUNCHES["K8"]
        kq, vq = tpa.paged_scatter_pair(_zeros(shape, pool_dtype, cuda),
                                        _zeros(shape, pool_dtype, cuda), ku,
                                        vu, pos, table)
        torch.cuda.synchronize()
        assert tpa.QUANT_LAUNCHES["K8"] == before + 1
        assert torch.equal(_bits(kq)[1:], _bits(kp)[1:])
        assert torch.equal(_bits(vq)[1:], _bits(vp)[1:])


@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, tpa.FP8_DTYPE])
@pytest.mark.parametrize("hkv,d,offset", [(3, 5, 0), (2, 12, 0), (4, 64, 1),
                                          (1, 40, 2), (12, 64, 0)])
def test_paged_scatter_takes_every_tile(cuda, pool_dtype, hkv, d, offset):
    """K8 at tiles that are not a multiple of 16 bytes and at update rows
    that start off a 16-byte boundary (a view `offset` elements into its
    storage): narrower chunks, down to one element, the same bits as the
    plain version outside the trash page, single and paired."""
    (ku, vu), pos, table, shape = _scatter_case(cuda, torch.bfloat16,
                                                hkv=hkv, d=d)
    n = ku.numel()
    ku = torch.cat([ku.new_zeros(offset), ku.reshape(-1)])[offset:].view(
        ku.shape)
    assert ku.data_ptr() % 16 == 2 * offset % 16 and n == ku.numel()
    want = [tpa.paged_scatter_reference(_zeros(shape, pool_dtype, cuda), u,
                                        pos, table) for u in (ku, vu)]
    one = tpa.paged_scatter_kernel(_zeros(shape, pool_dtype, cuda), ku, pos,
                                   table)
    kp, vp = tpa.paged_scatter_kernel_pair(
        _zeros(shape, pool_dtype, cuda), _zeros(shape, pool_dtype, cuda), ku,
        vu, pos, table)
    torch.cuda.synchronize()
    assert torch.equal(_bits(one)[1:], _bits(want[0])[1:])
    assert torch.equal(_bits(kp)[1:], _bits(want[0])[1:])
    assert torch.equal(_bits(vp)[1:], _bits(want[1])[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols", [(16384, 768), (512, 768), (8, 4096),
                                       (300, 2048), (1, 8)])
def test_layer_norm_bwd_kernel_over_widths(cuda, dtype, rows, cols):
    """K2 in every dtype from one row to the training step's 16384, at
    widths from 8 to the widest each dtype takes (4096 columns are f32's
    2048): dx, dw and db within the rule of the plain version; dw and db
    the same bits over 20 reruns; its launch whole clusters of 8
    blocks."""
    cols = min(cols, tln.REGISTER_COLS[dtype])
    g = torch.Generator(device=cuda).manual_seed(2)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x, dy = (mk(rows, cols) * 2 + 1).to(dtype), mk(rows, cols).to(dtype)
    w = mk(cols).to(dtype)
    plan = tln.layer_norm_bwd_plan(rows, cols, dtype, cuda)
    assert plan["grid"] % plan["cluster"] == 0 and plan["cluster"] == 8
    assert plan["grid"] <= max(8, -(-rows // 8) + 7), plan
    got = tln.layer_norm_bwd(dy, x, w, 1e-5)
    torch.cuda.synchronize()
    for a, b in zip(got, tln.layer_norm_bwd_reference(dy, x, w, 1e-5)):
        assert a.dtype == dtype
        _close(a, b)
    for _ in range(20):
        again = tln.layer_norm_bwd(dy, x, w, 1e-5)
        assert torch.equal(again[1], got[1]) and torch.equal(again[2],
                                                             got[2])
        assert torch.equal(again[0], got[0])


# -- K8-q8 (one write and the pair), K1 at the serving shapes, F11 ----------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128, 40, 13, 512, 1030])
@pytest.mark.parametrize("scale", [1.0, 300.0])
def test_q8_scatter_single_and_pair_equal_the_plain_version(cuda, dtype, d,
                                                            scale):
    """K8-q8's codes and scales equal the plain version's bit for bit
    outside the trash page 0, one write at a time and K and V in one
    launch (each pool equal to a single write's), at head dims whose
    rows take 16-byte vectors (64, 128), narrower ones (40 in f32: 160
    bytes; 13: one element), more than 32 vectors (512) and more than
    128 (1030: two elements a vector, the row read twice);
    20 reruns of the pair bit for bit."""
    (ku, vu), pos, table, shape = _scatter_case(cuda, dtype, d=d,
                                                scale=scale)
    ku[0, 0, 0] = 0.0                       # a row at the 1e-8 floor
    zeros = lambda: (torch.zeros(shape, dtype=torch.int8, device=cuda),
                     torch.zeros(shape[:3], device=cuda))
    want = [tpa.paged_scatter_q8_reference(*zeros(), u, pos, table)
            for u in (ku, vu)]
    before = tpa.QUANT_LAUNCHES["K8-q8"]
    one = [tpa.paged_scatter_q8(*zeros(), u, pos, table) for u in (ku, vu)]
    (kc, ks), (vc, vs) = zeros(), zeros()
    pair = tpa.paged_scatter_q8_pair(kc, vc, ks, vs, ku, vu, pos, table)
    torch.cuda.synchronize()
    assert tpa.QUANT_LAUNCHES["K8-q8"] == before + 3
    bits = lambda c, s_: (c[1:], s_[1:].view(torch.int32))
    for got in (one[0], pair[0::2]):
        assert all(map(torch.equal, bits(*got), bits(*want[0])))
    for got in (one[1], pair[1::2]):
        assert all(map(torch.equal, bits(*got), bits(*want[1])))
    assert torch.isfinite(ks).all() and torch.isfinite(vs).all()
    for _ in range(20):
        again = tpa.paged_scatter_q8_pair(*zeros()[:1], *zeros()[:1],
                                          *zeros()[1:], *zeros()[1:], ku, vu,
                                          pos, table)
        assert all(torch.equal(a[1:], b[1:]) for a, b in zip(again, pair))


def test_q8_scatter_takes_unaligned_updates(cuda):
    """An update view off the 16-byte boundary takes a narrower vector,
    with the plain version's bits."""
    (ku, _), pos, table, shape = _scatter_case(cuda, torch.bfloat16)
    ku = torch.cat([ku.new_zeros(1), ku.reshape(-1)])[1:].view(ku.shape)
    assert ku.data_ptr() % 16 == 2
    zeros = lambda: (torch.zeros(shape, dtype=torch.int8, device=cuda),
                     torch.zeros(shape[:3], device=cuda))
    got = tpa.paged_scatter_q8(*zeros(), ku, pos, table)
    want = tpa.paged_scatter_q8_reference(*zeros(), ku, pos, table)
    torch.cuda.synchronize()
    assert torch.equal(got[0][1:], want[0][1:])
    assert torch.equal(got[1][1:], want[1][1:])


def _ln_case(cuda, rows, cols, dtype, wdtype=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda)
    wdtype = dtype if wdtype is None else wdtype
    return ((mk(rows, cols) * 2 + 1).to(dtype), mk(cols).to(wdtype),
            mk(cols).to(wdtype), mk(rows, cols).to(dtype))


@pytest.mark.parametrize("rows", [512, 16, 16384])
def test_layer_norm_kernel_at_the_serving_shapes(cuda, rows):
    """K1 at [512, 768] (the serving step), [16, 768] (the legacy decode
    step) and [16384, 768] (the training step) in bf16: within the rule
    of the plain version, 20 reruns bit for bit, a warp a row in blocks
    of four at the exact vector count a lane, w and b loaded with x up
    to two blocks an SM (the serving shapes) and after the statistics
    past that (the training shape)."""
    x, w, b, _ = _ln_case(cuda, rows, 768, torch.bfloat16)
    plan = tln.layer_norm_plan(rows, 768, torch.bfloat16, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan["per_lane"] == 3 and not plan["wide"], plan
    assert plan["threads"] == 128 and plan["grid"] == -(-rows // 4), plan
    assert plan["early"] == (plan["grid"] <= 2 * sms), plan
    y = tln.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    _close(y, tln.layer_norm_reference(x, w, b, 1e-5))
    for _ in range(20):
        assert torch.equal(tln.layer_norm(x, w, b, 1e-5), y)


@pytest.mark.parametrize("dtype,wdtype,cols,early", [
    (torch.bfloat16, torch.bfloat16, 1024, 1),
    (torch.bfloat16, torch.bfloat16, 2048, 1),
    (torch.bfloat16, torch.bfloat16, 3072, 0),
    (torch.bfloat16, torch.bfloat16, 4096, 0),
    (torch.bfloat16, torch.float32, 1024, 1),
    (torch.bfloat16, torch.float32, 1536, 0),
    (torch.float32, torch.float32, 1024, 1),
    (torch.float32, torch.float32, 1536, 0)])
def test_layer_norm_loads_weights_early_where_registers_fit(cuda, dtype,
                                                            wdtype, cols,
                                                            early):
    """On a serving-size grid ([16, cols]) K1 loads w and b with x only
    where a lane's x, w and b fit 128 registers (up to 8 vectors a lane,
    4 with f32 weights under bf16 x); either way y is within the rule of
    the plain version and the same bits as on a training-size grid,
    which loads them after the statistics."""
    x, w, b, _ = _ln_case(cuda, 16, cols, dtype, wdtype, seed=4)
    plan = tln.layer_norm_plan(16, cols, dtype, cuda, wdtype)
    assert plan["early"] == early and not plan["wide"], plan
    assert tln.layer_norm_plan(16384, cols, dtype, cuda, wdtype)[
        "early"] == 0
    y = tln.layer_norm(x, w, b, 1e-5)
    big = torch.cat([x, x.new_zeros(16384 - 16, cols)])
    torch.cuda.synchronize()
    _close(y, tln.layer_norm_reference(x, w, b, 1e-5))
    assert torch.equal(tln.layer_norm(big, w, b, 1e-5)[:16], y)


@pytest.mark.parametrize("dtype,rows,cols", [
    (torch.float32, 64, 2560), (torch.float32, 64, 4096),
    (torch.bfloat16, 64, 5120), (torch.bfloat16, 8, 65536),
    (torch.float16, 64, 5120), (torch.float32, 4, 65536),
    (torch.float16, 3, 40960), (torch.bfloat16, 2048, 5120),
    (torch.bfloat16, 64, 16384), (torch.float32, 300, 8192),
    (torch.bfloat16, 1000, 32768)])
def test_layer_norm_wide_lane(cuda, dtype, rows, cols):
    """F11: K1 and K2 at rows past the register lanes (GPT-3's 2560 and
    4096 in f32, 5120 in bf16 and f16, up to 65536 columns: a block a
    row, the row staged in shared memory where it fits) within the rule
    of the plain versions; K2's dw/db partials in shared memory where
    they fit beside the row (18944 bf16 columns) and in device memory
    past that, summed by its second launch; dw and db the same bits over
    20 reruns."""
    x, w, b, dy = _ln_case(cuda, rows, cols, dtype)
    plan = tln.layer_norm_plan(rows, cols, dtype, cuda)
    bplan = tln.layer_norm_bwd_plan(rows, cols, dtype, cuda)
    assert plan["wide"] == (cols > tln.REGISTER_COLS[dtype]) == bplan["wide"]
    assert bplan["per_lane"] == 0 and bplan["cluster"] == 1, bplan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert bplan["grid"] <= min(rows, 2 * sms), bplan
    y = tln.layer_norm(x, w, b, 1e-5)
    got = tln.layer_norm_bwd(dy, x, w, 1e-5)
    torch.cuda.synchronize()
    _close(y, tln.layer_norm_reference(x, w, b, 1e-5))
    for a, ref in zip(got, tln.layer_norm_bwd_reference(dy, x, w, 1e-5)):
        assert a.dtype == dtype
        _close(a, ref)
    for _ in range(20):
        again = tln.layer_norm_bwd(dy, x, w, 1e-5)
        assert all(map(torch.equal, again, got))


@pytest.mark.parametrize("dtype,wdtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float16, torch.float32), (torch.bfloat16, torch.float16)])
@pytest.mark.parametrize("cols", [768, 5120])
def test_layer_norm_weights_of_another_dtype(cuda, dtype, wdtype, cols):
    """F11: w and b of another dtype than x: y and dx in x's dtype, dw
    and db in w's, within the rule of the plain versions (which convert
    w to f32 as the kernels do); the functional LayerNorm takes the
    kernels."""
    x, w, b, dy = _ln_case(cuda, 256, cols, dtype, wdtype, seed=3)
    before = (tln.LAUNCHES, tln.BWD_LAUNCHES)
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = PF.layer_norm(xg, cols, wg, bg)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (tln.LAUNCHES, tln.BWD_LAUNCHES) == (before[0] + 1,
                                                before[1] + 1)
    assert y.dtype == xg.grad.dtype == dtype
    assert wg.grad.dtype == bg.grad.dtype == wdtype
    _close(y, tln.layer_norm_reference(x, w, b, 1e-5))
    for a, ref in zip((xg.grad, wg.grad, bg.grad),
                      tln.layer_norm_bwd_reference(dy, x, w, 1e-5)):
        _close(a, ref)


@pytest.mark.parametrize("dtype,wdtype,bdtype", [
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float16),
    (torch.float16, torch.float16, torch.float32)])
def test_layer_norm_w_and_b_of_two_dtypes(cuda, dtype, wdtype, bdtype):
    """w and b of two dtypes (converted to f32 by the wrappers, which is
    exact): the functional LayerNorm takes the kernels, y and dx in x's
    dtype, each parameter's gradient in its own dtype, within the rule
    of the plain versions (which convert w and b to f32 alike)."""
    x, w, _, dy = _ln_case(cuda, 256, 5120, dtype, wdtype, seed=9)
    b = torch.randn(5120, device=cuda).to(bdtype)
    before = (tln.LAUNCHES, tln.BWD_LAUNCHES)
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = PF.layer_norm(xg, 5120, wg, bg)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (tln.LAUNCHES, tln.BWD_LAUNCHES) == (before[0] + 1,
                                                before[1] + 1)
    assert y.dtype == xg.grad.dtype == dtype
    assert (wg.grad.dtype, bg.grad.dtype) == (wdtype, bdtype)
    _close(y, tln.layer_norm_reference(x, w, b, 1e-5))
    dx, dw, db = tln.layer_norm_bwd_reference(dy, x, w, 1e-5)
    for a, ref in ((xg.grad, dx), (wg.grad, dw), (bg.grad, db.to(bdtype))):
        _close(a, ref)


def test_layer_norm_at_a_misaligned_width_takes_the_jnp_branch(cuda):
    """F11: width 100 in bf16 (200 bytes) launches no kernel: the
    functional LayerNorm is the port of the JAX jnp branch on the card,
    equal within the rule to the same function on the CPU, with
    gradients."""
    from paddle_tpu_torch.nn.functional.norm import _ln_jnp
    x, w, b, dy = _ln_case(cuda, 64, 100, torch.bfloat16, seed=5)
    xg = x.clone().requires_grad_(True)
    before = (tln.LAUNCHES, tln.BWD_LAUNCHES)
    y = PF.layer_norm(xg, 100, w, b)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (tln.LAUNCHES, tln.BWD_LAUNCHES) == before
    xc = x.cpu().requires_grad_(True)
    want = _ln_jnp(xc, w.cpu(), b.cpu(), 1, 1e-5)
    want.backward(dy.cpu())
    _close(y.cpu(), want)
    _close(xg.grad.cpu(), xc.grad)
