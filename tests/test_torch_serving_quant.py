"""The port's engine with quantized KV pools against the JAX engine.

`ServingEngine(model, kv_dtype="int8" | "fp8")` at the phase-7 geometry
of `__graft_entry__.dryrun_multichip` (vocab 256, hidden 64, 2 layers, 4
heads; the tiny f32 GPT of `test_torch_serving_defaults.py`) on its
shared-prefix traffic, at the defaults and with grouped=False: the
greedy tokens equal the JAX engine's, every emitted token won its step
by more than twice the quantized logits tolerance, the held logits and
the pools' committed slots agree with the JAX engine's, and so does
`page_bytes`. Then the int8 lane's features on the port alone: prefix
cache on and off, preemption on and off, and a spilled prefix page that
comes back with its codes and scales; and the `PADDLE_TPU_KV_DTYPE` gate.
"""
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda.paged_attention import FP8_DTYPE
from paddle_tpu_torch.serving import (KV_DTYPE_MODES, SamplingParams,
                                      ServingEngine, resolve_kv_dtype)

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=8)
# tests/test_serving_overload.py's preemption and prefix-spill geometries
OVERLOAD = dict(num_slots=2, max_len=64, page_size=8, num_pages=6,
                chunk_len=16)
SPILL = dict(num_slots=1, max_len=32, page_size=8, num_pages=5, chunk_len=8)
# held logits, port vs JAX, both f32 over quantized pools. The K/V the
# two frameworks quantize differ in their last f32 bits, so a value at a
# rounding boundary may take the neighbouring int8 code (or e4m3 step);
# one such flip moves one K/V element by a whole quantization step
# (amax / 127 for int8), far more than the fp lane's 1e-4. 2e-3 holds a
# few flips at this model's logit scale (std ~0.5); the runs here
# measured 3e-7, with no flip in a committed slot.
QUANT_LOGIT_TOL = 2e-3
SCALE_RTOL = 1e-5      # scales = amax / 127 of K/V that differ in last bits


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its engines step tiny
    tensors op by op, and beside the other test workers a pool of
    threads a process only waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX GPT and its port with the same weights, as in
    tests/test_torch_serving_defaults.py (the JAX side on its jnp paths
    under a stand-in `jax.experimental.disable_x64`)."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    mp.delenv("PADDLE_TPU_KV_DTYPE", raising=False)
    try:
        paddle.seed(0)
        jm = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0,
                                 **GEOMETRY))
        jm.eval()
        params = {k: v.numpy() for k, v in jm.state_dict().items()}
        tm = GPTForCausalLM(GPTConfig(**GEOMETRY), device="cpu")
        tm.load_state_dict(convert.from_paddle_state_dict(params))
        tm.eval()
        yield jm, tm
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def _prompts():
    rs = np.random.RandomState(21)
    system = rs.randint(0, 256, size=20)
    return [np.concatenate([system, rs.randint(0, 256, size=n)])
            .astype(np.int64) for n in (3, 9, 5, 12, 7, 2)]


def _serve(eng, sampling):
    """The first prompt alone (its pages enter the radix tree), then the
    rest together (they attach its prefix and walk it as one group)."""
    prompts = _prompts()
    first = eng.generate(prompts[:1], sampling(max_new_tokens=4))
    rest = eng.generate(prompts[1:], sampling(max_new_tokens=8))
    return [list(r.token_ids) for r in first + rest]


class _Watched(ServingEngine):
    """Keeps, for every emitted token, the margin by which it won the
    held logits it was sampled from, and each finished request's
    committed slots (its prompt and output positions, through its page
    table: a step writes the K/V of the token it samples)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.margins = []
        self.committed = np.zeros((self.num_pages, self.page_size), bool)

    def _unified_step(self, finished, suppress=frozenset()):
        held = self._last_logits.clone()
        before = {slot: (req, len(req.output_tokens))
                  for slot, req in self.scheduler.running.items()}
        super()._unified_step(finished, suppress)
        top2 = torch.topk(held, 2, dim=-1).values
        for slot, (req, n) in before.items():
            if len(req.output_tokens) > n:
                self.margins.append(float(top2[slot, 0] - top2[slot, 1]))

    def _finish_and_free(self, req, reason, now, finished):
        pages = self._slot_pages.get(req.slot) if req.slot is not None \
            else None
        if pages is not None:
            n = int(req.prompt_ids.size) + len(req.output_tokens)
            for p in range(n):
                self.committed[pages[p // self.page_size],
                               p % self.page_size] = True
        super()._finish_and_free(req, reason, now, finished)


@pytest.fixture(scope="module")
def jax_quant(models):
    """The JAX engine at its defaults on the shared-prefix traffic, int8
    and fp8: tokens, final pools, held logits and page_bytes."""
    out = {}
    for kv in ("int8", "fp8"):
        eng = JaxEngine(models[0], kv_dtype=kv, **ENGINE)
        assert eng.grouped and eng.kv_dtype == kv
        tokens = _serve(eng, JaxSampling)
        pools = [[None if a is None else np.asarray(a) for a in layer]
                 for layer in eng._ct]
        out[kv] = dict(tokens=tokens, pools=pools,
                       logits=np.asarray(eng._last_logits),
                       page_bytes=eng.page_bytes,
                       snap=eng.metrics.snapshot())
    return out


def _ordinal(codes: np.ndarray) -> np.ndarray:
    """int8 codes as ints; e4m3 bytes as signed step counts (sign and
    magnitude, so +0 and -0 are both 0 and neighbours differ by 1)."""
    if codes.dtype == np.int8:
        return codes.astype(np.int64)
    mag = (codes & 0x7F).astype(np.int64)
    return np.where(codes & 0x80, -mag, mag)


def _pool_bytes(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.dtype == FP8_DTYPE else t).numpy()


@pytest.mark.parametrize("grouped", [None, False],
                         ids=["defaults", "grouped_off"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_engine_matches_the_jax_engine(models, jax_quant, kv,
                                                 grouped):
    want = jax_quant[kv]
    eng = _Watched(models[1], device="cpu", kv_dtype=kv, grouped=grouped,
                   **ENGINE)
    assert eng.grouped is (grouped is None) and eng.kv_dtype == kv
    tokens = _serve(eng, SamplingParams)
    assert tokens == want["tokens"]
    assert len(eng.margins) == sum(map(len, tokens))
    assert min(eng.margins) > 2 * QUANT_LOGIT_TOL
    err = np.abs(eng._last_logits.numpy() - want["logits"]).max()
    assert err <= QUANT_LOGIT_TOL, err
    assert eng.page_bytes == want["page_bytes"]
    snap = eng.metrics.snapshot()
    assert snap["kv_dtype"] == want["snap"]["kv_dtype"] == kv
    assert snap["pool"]["bytes_per_page"] == \
        want["snap"]["pool"]["bytes_per_page"]
    assert snap["host_pool"]["bytes_total"] == \
        want["snap"]["host_pool"]["bytes_total"]
    # the committed slots of every layer's pools: codes equal or one step
    # apart, scales to SCALE_RTOL
    live = eng.committed
    assert live[1:].sum() > 100 and not live[0].any()
    differ = []
    for (k, v, ks, vs), jlayer in zip(eng._pools, want["pools"]):
        for got, ref in zip((k, v), jlayer[:2]):
            ref = ref.view(np.uint8) if ref.dtype.itemsize == 1 and \
                ref.dtype != np.int8 else ref
            steps = np.abs(_ordinal(_pool_bytes(got)[live])
                           - _ordinal(ref[live]))
            assert steps.max() <= 1
            differ.append(float((steps > 0).mean()))
        for got, ref in zip((ks, vs), jlayer[2:]):
            assert (got is None) == (ref is None) == (kv == "fp8")
            if got is not None:
                np.testing.assert_allclose(got.numpy()[live], ref[live],
                                           rtol=SCALE_RTOL)
    print(f"{kv} {'defaults' if grouped is None else 'grouped=False'}: "
          f"share of committed codes one step from the JAX engine's, per "
          f"pool: {differ}")


def test_page_bytes_are_the_jax_formula_at_gpt_head_dim():
    """At head dim 64 and page 16 (GPT-124M's) an int8 page costs 68/128
    and an fp8 page 64/128 of a bf16 page."""
    cfg = GPTConfig(vocab_size=64, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=64)
    model = GPTForCausalLM(cfg, device="cpu", dtype=torch.bfloat16)
    got = {kv: ServingEngine(model, device="cpu", kv_dtype=kv, num_slots=2,
                             max_len=32, page_size=16).page_bytes
           for kv in KV_DTYPE_MODES}
    assert got["fp"] == 2 * 2 * 16 * 2 * 64 * 2
    assert got["int8"] * 128 == got["fp"] * 68
    assert got["fp8"] * 128 == got["fp"] * 64


def test_pools_are_zeroed_in_the_lane_dtype(models):
    eng = ServingEngine(models[1], device="cpu", kv_dtype="int8", **ENGINE)
    for k, v, ks, vs in eng._pools:
        assert k.dtype == v.dtype == torch.int8
        assert ks.dtype == vs.dtype == torch.float32
        assert ks.shape == k.shape[:3]
        assert not any(t.any() for t in (k, v, ks, vs))
    eng = ServingEngine(models[1], device="cpu", kv_dtype="fp8", **ENGINE)
    for k, v, ks, vs in eng._pools:
        assert k.dtype == v.dtype == FP8_DTYPE and ks is vs is None
        assert not k.view(torch.uint8).any()


def test_int8_prefix_cache_on_and_off_give_the_same_tokens(models):
    """Mid-page prefix matches copy the page on write: its scales must
    come along, or the copy dequantizes to other values."""
    rs = np.random.RandomState(5)
    shared = rs.randint(0, 256, size=11)
    prompts = [np.concatenate([shared, rs.randint(0, 256, size=4)])
               for _ in range(4)]

    def run(prefix):
        eng = ServingEngine(models[1], device="cpu", kv_dtype="int8",
                            prefix_cache=prefix, num_slots=2, max_len=64,
                            page_size=8, chunk_len=16)
        out = [eng.generate([p], SamplingParams(max_new_tokens=6))[0]
               .token_ids for p in prompts]
        return out, eng

    on, eng = run(True)
    off, _ = run(False)
    assert on == off
    stats = eng.prefix_cache.stats()
    assert stats["hits"] > 0 and stats["cow_copies"] > 0


def _preempt_cycle(eng):
    """A priority-5 resident, then a priority-0 arrival after 6 steps
    that only preemption can admit (tests/test_serving_overload.py)."""
    lo = eng.add_request(np.arange(1, 9),
                         SamplingParams(max_new_tokens=24, priority=5))
    for _ in range(6):
        eng.step()
    hi = eng.add_request(np.arange(30, 38),
                         SamplingParams(max_new_tokens=24, priority=0))
    eng.run()
    eng.drain()
    return [lo.output_tokens, hi.output_tokens]


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_preemption_on_and_off_give_the_same_tokens(models, kv):
    """A preempted resident's pages go to the host tier and come back
    (codes with their scales for int8, e4m3 bytes for fp8): its tokens
    are those of a run that never preempts."""
    eng = ServingEngine(models[1], device="cpu", kv_dtype=kv, **OVERLOAD)
    on = _preempt_cycle(eng)
    off = _preempt_cycle(ServingEngine(models[1], device="cpu", kv_dtype=kv,
                                       preempt=False, **OVERLOAD))
    assert on == off
    assert eng.metrics.preemptions >= 1
    assert eng.metrics.swapped_out_pages >= 1
    assert eng.metrics.swapped_in_pages >= 1
    eng.pool.assert_quiesced()


def test_int8_spilled_prefix_page_restores_codes_and_scales(models):
    eng = ServingEngine(models[1], device="cpu", kv_dtype="int8", **SPILL)
    base = np.arange(1, 10, dtype=np.int64)
    first = eng.generate([base], SamplingParams(max_new_tokens=4))[0]
    eng.generate([np.arange(40, 57)], SamplingParams(max_new_tokens=4))
    again = eng.generate([base], SamplingParams(max_new_tokens=4))[0]
    pc = eng.prefix_cache
    assert pc.spilled_pages_total >= 1 and pc.restored_pages_total >= 1
    assert again.cached_tokens > 0 and again.token_ids == first.token_ids
    # a page's payload is its codes and scales; back in another page, the
    # page holds the same bytes
    k, v, ks, vs = eng._pools[1]
    src, dst = 1, 3
    k[src].random_(-127, 128)
    ks[src].uniform_(0.1, 2.0)
    payload = eng._extract_page(src)
    assert [t.dtype for t in payload] == [torch.int8, torch.float32]
    eng._restore_page(payload, dst)
    for layer in eng._pools:
        for t in layer:
            assert torch.equal(t[dst], t[src])
    eng.drain()


def test_kv_dtype_gate(monkeypatch, models):
    monkeypatch.delenv("PADDLE_TPU_KV_DTYPE", raising=False)
    assert resolve_kv_dtype() == "fp"
    assert resolve_kv_dtype("int8") == "int8"
    assert resolve_kv_dtype("fp8") == "fp8"
    with pytest.raises(ValueError, match="kv_dtype must be one"):
        resolve_kv_dtype("int4")
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int8")
    assert resolve_kv_dtype() == "int8"
    assert ServingEngine(models[1], device="cpu", **ENGINE).kv_dtype == "int8"
    assert ServingEngine(models[1], device="cpu", kv_dtype="fp",
                         **ENGINE).kv_dtype == "fp"
    monkeypatch.setenv("PADDLE_TPU_KV_DTYPE", "int4")
    with pytest.raises(ValueError, match="PADDLE_TPU_KV_DTYPE"):
        ServingEngine(models[1], device="cpu", **ENGINE)
