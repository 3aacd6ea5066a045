"""The decode megakernel's parts against the JAX package, and the gate's
identity inside the port.

Plain versions of K11 (`lora_delta_paged`: gather + `lora_delta`), K12
(`decode_greedy_argmax`, with ties, a NaN row and an all -inf row), K8's
float lane (`paged_scatter_kernel` into f32 and bf16 pools) and
`spec_verify_accept` against the JAX functions; `megakernel_decode` and
`megakernel_decode_q8` against the JAX ops (fp, grouped, LoRA, q8), as
tests/test_megakernel.py builds them. Then the serving engine: tokens
and held logits with the gate on equal the gate off bit for bit, over
float and int8 pools. The JAX side runs its jnp paths.
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
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# f32: the JAX test's own tolerance (tests/test_paged_attention.py)
RTOL, ATOL = 2e-5, 2e-6


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


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def build_decode(rng, b, mp, ps, h, d, w=1):
    """tests/test_megakernel.py's packed decode step: pools, tables with
    room for the w new tokens, q and the new K/V."""
    pos = np.asarray(rng.randint(ps, (mp - 1) * ps - w, size=b), np.int32)
    n_pages = b * mp + 1
    kp = rng.randn(n_pages, ps, h, d).astype(np.float32)
    vp = rng.randn(n_pages, ps, h, d).astype(np.float32)
    pt = np.zeros((b, mp), np.int32)
    page = 1
    for r in range(b):
        for i in range((pos[r] + w - 1) // ps + 1):
            pt[r, i] = page
            page += 1
    q = rng.randn(b, w, h, d).astype(np.float32)
    kn = rng.randn(b, w, h, d).astype(np.float32)
    vn = rng.randn(b, w, h, d).astype(np.float32)
    ql = np.full(b, w, np.int32)
    return q, kn, vn, kp, vp, pt, pos, ql


def lora_operands(rng, b, w, h, d, pools=3, r=4):
    """Adapter pools (page 0 all zero) and the rows' pages and scales."""
    cin = cout = h * d
    aq = rng.randn(pools, cin, r).astype(np.float32) * 0.1
    bq = rng.randn(pools, r, cout).astype(np.float32) * 0.1
    aq[0] = 0.0
    bq[0] = 0.0
    x = rng.randn(b, w, cin).astype(np.float32)
    apage = np.asarray(rng.randint(0, pools, size=b), np.int32)
    ascale = rng.rand(b).astype(np.float32)
    return x, aq, bq, apage, ascale


# -- K11 -----------------------------------------------------------------------
def test_lora_delta_paged_matches_jax_and_page_0_is_exactly_0():
    rng = np.random.RandomState(0)
    x, aq, bq, apage, ascale = lora_operands(rng, 6, 3, 2, 8)
    apage[:2] = 0
    ascale[2] = 0.0
    got = tpa.lora_delta_paged(*_t(x, aq, bq, apage, ascale))
    want = jpa.lora_delta_paged(*_j(x, aq, bq, apage, ascale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert not got[:3].any()
    assert torch.equal(got, tpa.lora_delta_paged_reference(
        *_t(x, aq, bq, apage, ascale)))
    # lora_delta on the gathered pages, as the unfused path runs it
    ta, tb = _t(aq[apage], bq[apage])
    assert torch.equal(got, tpa.lora_delta(_t(x)[0], ta, tb,
                                           _t(ascale)[0]))


def test_lora_delta_rounds_to_x_dtype_as_jax_does():
    """bf16 x: t rounded to bf16 between the products, the scale cast
    to bf16, the product rounded — the JAX function's rounding points."""
    rng = np.random.RandomState(1)
    x, aq, bq, apage, ascale = lora_operands(rng, 4, 5, 2, 16)
    xb = x.astype(ml_dtypes.bfloat16)
    ab, bb = aq[apage].astype(ml_dtypes.bfloat16), bq[apage].astype(
        ml_dtypes.bfloat16)
    want = np.asarray(jpa.lora_delta(*_j(xb, ab, bb, ascale))).astype(
        np.float32)
    to_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    got = tpa.lora_delta(to_t(xb), to_t(ab), to_t(bb),
                         torch.from_numpy(ascale))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of the element: the frameworks' f32 sums differ in
    # order, so a rounding may fall the other way
    ulp = np.abs(want) * 2.0 ** -7 + 1e-6
    assert (np.abs(got.float().numpy() - want) <= ulp).all()


# -- K12 and the acceptance epilogue --------------------------------------------
def test_decode_greedy_argmax_matches_jax_with_ties_and_nan():
    rng = np.random.RandomState(2)
    logits = rng.randn(7, 97).astype(np.float32)
    logits[1, [5, 40, 90]] = 9.0          # a three-way tie: the first wins
    logits[2] = 1.0                        # all equal: index 0
    logits[3, [3, 60]] = np.nan            # the first NaN wins
    logits[4] = -np.inf                    # all -inf: index 0
    logits[5, [10, 11]] = [0.0, -0.0]      # +0 and -0 tie, the max row
    logits[5, :10] = -1.0
    logits[5, 12:] = -1.0
    logits[6, 96] = 50.0                   # the last column
    got = tpa.decode_greedy_argmax(torch.from_numpy(logits))
    want = np.asarray(jpa.decode_greedy_argmax(jnp.asarray(logits)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [
        logits[0].argmax(), 5, 0, 3, 0, 10, 96])
    assert torch.equal(got.long(), torch.argmax(torch.from_numpy(logits), -1))


def test_spec_verify_accept_matches_jax():
    rng = np.random.RandomState(3)
    b, w, v = 5, 4, 23
    logits = rng.randn(b, w, v).astype(np.float32)
    preds = logits.argmax(-1)
    toks = rng.randint(0, v, (b, w)).astype(np.int32)
    toks[0, 1:] = preds[0, :-1]           # every draft accepted
    toks[1, 1:3] = preds[1, :2]           # two, then a miss
    toks[1, 3] = (preds[1, 2] + 1) % v
    toks[2, 1:] = preds[2, :-1]           # accepted, but q_len 2
    toks[3, 1:] = preds[3, :-1]           # accepted, but not decoding
    q_len = np.array([4, 4, 2, 4, 1], np.int32)
    is_decode = np.array([True, True, True, False, True])
    got = tpa.spec_verify_accept(*_t(logits, toks, q_len, is_decode))
    want = jpa.spec_verify_accept(*_j(logits, toks, q_len, is_decode))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [3, 2, 1, 0, 0])


# -- K8's float lane ------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_scatter_kernel_float_lane_matches_jax(dtype):
    """Into a float pool: the JAX scatter's pool exactly (tokens past a
    row's window land on the trash page 0), and the unfused write's."""
    rng = np.random.RandomState(4)
    pool = rng.randn(9, 4, 2, 8).astype(np.float32)
    upd = rng.randn(2, 6, 2, 8).astype(np.float32)
    table = np.array([[3, 5, 1, 7], [2, 4, 6, 8]], np.int32)
    pos = np.array([2, 13], np.int32)      # row 1 runs past its window
    if dtype == "bf16":
        pool, upd = (a.astype(ml_dtypes.bfloat16) for a in (pool, upd))
        tt = lambda a: torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16)
    else:
        tt = lambda a: torch.from_numpy(a.copy())
    want = np.asarray(jpa.paged_scatter(*_j(pool, upd, pos, table)))
    got = tpa.paged_scatter_kernel(tt(pool), tt(upd), *_t(pos, table))
    plain = tpa.paged_scatter(tt(pool), tt(upd), *_t(pos, table))
    np.testing.assert_array_equal(got[1:].float().numpy(),
                                  want[1:].astype(np.float32))
    assert torch.equal(got, plain)


# -- the composition (K13) ------------------------------------------------------
@pytest.mark.parametrize("case", ["fp", "fp_grouped", "fp_lora",
                                  "fp_grouped_lora", "q8", "q8_lora"])
def test_megakernel_decode_matches_jax(case):
    rng = np.random.RandomState(5)
    b, mp, ps, h, d, w = 4, 4, 8, 2, 8, 2
    q, kn, vn, kp, vp, pt, pos, ql = build_decode(rng, b, mp, ps, h, d, w)
    grouped, lora, q8 = "grouped" in case, "lora" in case, case[:2] == "q8"
    rest = []
    if grouped:
        # rows 0 and 1 share their first page
        pt[1, 0] = pt[0, 0]
        rest += [np.array([0, 0, 2, 3], np.int32),
                 np.array([0, 0, 2, 3], np.int32),
                 np.array([1, 0, 0, 0], np.int32)]
    if lora:
        x, aq, bq, apage, ascale = lora_operands(rng, b, w, h, d)
        ak, bk, av, bv = (a * 0.5 for a in (aq, bq, aq, bq))
        rest += [x, aq, bq, ak, bk, av, bv, apage, ascale]
    opts = dict(grouped=grouped, lora=lora)
    if q8:
        kc = rng.randint(-127, 128, kp.shape).astype(np.int8)
        vc = rng.randint(-127, 128, vp.shape).astype(np.int8)
        ks, vs = ((rng.rand(*kp.shape[:3]) * 0.02).astype(np.float32)
                  for _ in range(2))
        got = tpa.megakernel_decode_q8(*_t(q, kn, vn, kc, vc, ks, vs, pt,
                                           pos, ql), *_t(*rest), **opts)
        want = jpa.megakernel_decode_q8(*_j(q, kn, vn, kc, vc, ks, vs, pt,
                                            pos, ql), *_j(*rest), **opts)
    else:
        got = tpa.megakernel_decode(*_t(q, kn, vn, kp, vp, pt, pos, ql),
                                    *_t(*rest), **opts)
        want = jpa.megakernel_decode(*_j(q, kn, vn, kp, vp, pt, pos, ql),
                                     *_j(*rest), **opts)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    for g, wt in zip(got[1:], want[1:]):
        g, wt = g.numpy(), np.asarray(wt)
        if not lora:
            np.testing.assert_array_equal(g, wt)
        elif g.dtype == np.int8:
            # the delta's f32 sums differ in order between the
            # frameworks: a written value may round to the next code
            assert np.abs(g.astype(np.int32) - wt).max() <= 1
        else:
            np.testing.assert_allclose(g, wt, rtol=RTOL, atol=ATOL)


# -- the serving engine: gate on = gate off ------------------------------------
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
ENGINE = dict(device="cpu", num_slots=4, max_len=64, page_size=8,
              chunk_len=16, seed=0)


class _Held(ServingEngine):
    """Keeps the held logits of every step."""

    def _sample_next(self):
        self.held = getattr(self, "held", [])
        self.held.append(self._last_logits.clone())
        return super()._sample_next()


def _prompts():
    rs = np.random.RandomState(21)
    system = rs.randint(0, 256, size=20)
    return [np.concatenate([system, rs.randint(0, 256, size=n)])
            for n in (3, 9, 5, 12, 7, 2)]


@pytest.mark.parametrize("opts", [dict(grouped=False),
                                  dict(grouped=False, kv_dtype="int8")])
def test_engine_megakernel_on_equals_off_bit_for_bit(opts):
    """grouped=False: the grouped walk's plain version is a slow loop of
    page folds, and the grouped composition is held above."""
    model = GPTForCausalLM(GPTConfig(**GEOMETRY), device="cpu", seed=3)
    runs = []
    for mega in (False, True):
        eng = _Held(model, megakernel=mega, **ENGINE, **opts)
        assert eng.megakernel is mega
        sampling = [SamplingParams(max_new_tokens=4)] * 3 + [
            SamplingParams(max_new_tokens=4, top_k=5)]
        out = eng.generate(_prompts()[:4], sampling)
        runs.append(([o.token_ids for o in out], eng.held))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == len(runs[1][1])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
