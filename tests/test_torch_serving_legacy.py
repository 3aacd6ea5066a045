"""The port's legacy alternating step and gather arm against the JAX engine.

`ServingEngine(model, unified=False)` (prefill chunks in power-of-two
buckets alternating with one decode step over every slot) and
`ServingEngine(model, attn_impl="gather")` at the phase-7 geometry of
`__graft_entry__.dryrun_multichip` (vocab 256, hidden 64, 2 layers, 4
heads; the tiny f32 GPT of `test_torch_serving_defaults.py`, weights
moved by `convert.py`) on shared-prefix traffic: the greedy tokens equal
the JAX engine's in the same configuration and the port's unified
engine's, every emitted token won its step by a clear margin, under page
pressure with the prefix cache on and off, over int8 and fp8 pools, and
through preemption and swap-in. Then the gates, the silent drop of the
grouped walk, the prefill bucket set and the metrics. The JAX engines
run once per module.
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
from paddle_tpu_torch.nlp.generation import resolve_paged_attn_impl
from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                      resolve_unified_flag)
from paddle_tpu_torch.serving.paging import chunk_bucket

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
_GATES = ("PADDLE_TPU_UNIFIED_STEP", "PADDLE_TPU_PAGED_ATTN",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_PREEMPT")
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
# chunk 16: prompts of 22-32 tokens prefill in buckets 16 and 8
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=16)
# tests/test_serving_overload.py's preemption geometry
OVERLOAD = dict(num_slots=2, max_len=64, page_size=8, num_pages=6,
                chunk_len=16)
# f32 on both sides: the frameworks sum in different orders and the JAX
# LayerNorm takes one-pass statistics where the port takes two-pass
LOGIT_TOL = 1e-4
# quantized pools: a K/V value at a rounding boundary may take the
# neighbouring code in the other framework (test_torch_serving_quant.py)
QUANT_LOGIT_TOL = 2e-3

# name -> engine options, run in both packages
CONFIGS = {
    "legacy": dict(unified=False),
    "legacy_prefix_off": dict(unified=False, prefix_cache=False),
    # 12 pages: at most two residents at a time, parked prefix pages
    # evicted under pressure
    "legacy_pressure": dict(unified=False, num_pages=12),
    "legacy_pressure_prefix_off": dict(unified=False, num_pages=12,
                                       prefix_cache=False),
    "legacy_int8": dict(unified=False, kv_dtype="int8"),
    "legacy_fp8": dict(unified=False, kv_dtype="fp8"),
    "gather": dict(attn_impl="gather"),
    "gather_int8": dict(attn_impl="gather", kv_dtype="int8"),
    "gather_fp8": dict(attn_impl="gather", kv_dtype="fp8"),
    "legacy_gather": dict(unified=False, attn_impl="gather"),
}


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
    """The JAX GPT and its port with the same weights (the JAX side on
    its jnp paths under a stand-in `jax.experimental.disable_x64`, every
    serving gate at its default)."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    for gate in _GATES:
        mp.delenv(gate, raising=False)
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
    """A 20-token system prompt and six tails: 22-32 tokens."""
    rs = np.random.RandomState(21)
    system = rs.randint(0, 256, size=20)
    return [np.concatenate([system, rs.randint(0, 256, size=n)])
            .astype(np.int64) for n in (3, 9, 5, 12, 7, 2)]


def _serve(eng, sampling):
    """The first prompt alone (its pages enter the radix tree), then the
    rest together."""
    prompts = _prompts()
    first = eng.generate(prompts[:1], sampling(max_new_tokens=4))
    rest = eng.generate(prompts[1:], sampling(max_new_tokens=8))
    return [list(r.token_ids) for r in first + rest]


def _preempt_cycle(eng, sampling):
    """A priority-5 resident, then a priority-0 arrival after 6 steps
    that only preemption can admit (tests/test_serving_overload.py)."""
    lo = eng.add_request(np.arange(1, 9),
                         sampling(max_new_tokens=24, priority=5))
    for _ in range(6):
        eng.step()
    hi = eng.add_request(np.arange(30, 38),
                         sampling(max_new_tokens=24, priority=0))
    eng.run()
    eng.drain()
    return [list(lo.output_tokens), list(hi.output_tokens)]


class _Watched(ServingEngine):
    """Keeps, for every emitted token, the margin by which it won the
    held logits it was sampled from, on either step."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.margins = []
        self._held = None

    def _sample_next(self):
        self._held = self._last_logits.clone()
        return super()._sample_next()

    def _emit_tokens(self, slots, nxt, finished):
        top2 = torch.topk(self._held, 2, dim=-1).values
        for slot in slots:
            req = self.scheduler.running.get(int(slot))
            if req is not None and req.state.name == "DECODE":
                self.margins.append(float(top2[slot, 0] - top2[slot, 1]))
        super()._emit_tokens(slots, nxt, finished)


@pytest.fixture(scope="module")
def jax_runs(models):
    """Every configuration's greedy tokens from the JAX engine, and its
    preemption cycle on the legacy step."""
    jm = models[0]
    out = {}
    for name, opts in CONFIGS.items():
        eng = JaxEngine(jm, **{**ENGINE, **opts})
        assert not eng.grouped and eng.unified is opts.get("unified", True)
        out[name] = _serve(eng, JaxSampling)
        eng.drain()
    eng = JaxEngine(jm, unified=False, **OVERLOAD)
    out["preempt"] = _preempt_cycle(eng, JaxSampling)
    assert eng.metrics.preemptions >= 1
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tokens_match_the_jax_engine_and_the_unified_step(models, jax_runs,
                                                          name):
    opts = {**ENGINE, **CONFIGS[name]}
    eng = _Watched(models[1], device="cpu", **opts)
    assert eng.unified is opts.get("unified", True)
    assert eng.attn_impl == opts.get("attn_impl", "kernel")
    assert not eng.grouped
    got = _serve(eng, SamplingParams)
    assert got == jax_runs[name]
    tol = QUANT_LOGIT_TOL if "kv_dtype" in opts else LOGIT_TOL
    assert len(eng.margins) == sum(map(len, got))
    assert min(eng.margins) > 2 * tol, min(eng.margins)
    # the port's unified kernel step on the same pools (the per-row walk:
    # the grouped walk's plain version, a loop over pages, gives the same
    # tokens more slowly; test_torch_serving_defaults.py holds that)
    base = {k: v for k, v in opts.items()
            if k not in ("unified", "attn_impl")}
    unified = ServingEngine(models[1], device="cpu", grouped=False, **base)
    assert unified.unified and unified.attn_impl == "kernel"
    assert _serve(unified, SamplingParams) == got
    eng.drain()
    snap = eng.metrics.snapshot()
    if not eng.unified:
        assert snap["unified_steps"] == 0
        assert snap["prefill_chunks"] > 0 and snap["decode_step_s"]["count"]
    assert snap["unified"] is eng.unified
    assert snap["attn_impl"] == eng.attn_impl


@pytest.mark.parametrize("kv", ["fp", "int8", "fp8"])
def test_preemption_on_the_legacy_step_gives_the_tokens_of_no_preemption(
        models, jax_runs, kv):
    """A preempted resident's pages go to the host tier and come back; on
    resume one prefilled token in an 8-bucket regenerates its held
    logits: its tokens are those of a run that never preempts, and the
    pool is quiesced after drain()."""
    eng = ServingEngine(models[1], device="cpu", unified=False, kv_dtype=kv,
                        **OVERLOAD)
    on = _preempt_cycle(eng, SamplingParams)
    off = _preempt_cycle(ServingEngine(models[1], device="cpu",
                                       unified=False, kv_dtype=kv,
                                       preempt=False, **OVERLOAD),
                         SamplingParams)
    assert on == off
    m = eng.metrics
    assert m.preemptions >= 1 and m.swapped_out_pages >= 1
    assert m.swapped_in_pages >= 1
    assert 8 in eng.prefill_buckets
    eng.pool.assert_quiesced()
    # what stays on the host tier is spilled prefix-cache pages only
    assert eng.pool.swapped_pages == eng.host_pool.used_pages
    if kv == "fp":
        assert on == jax_runs["preempt"]


def test_gates(monkeypatch, models):
    for gate in _GATES:
        monkeypatch.delenv(gate, raising=False)
    assert resolve_unified_flag() is True
    assert resolve_unified_flag(False) is False
    assert resolve_paged_attn_impl() == "kernel"
    assert resolve_paged_attn_impl("gather") == "gather"
    with pytest.raises(ValueError, match="paged attention impl"):
        resolve_paged_attn_impl("dense")
    monkeypatch.setenv("PADDLE_TPU_UNIFIED_STEP", "off")
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", "gather")
    eng = ServingEngine(models[1], device="cpu", **ENGINE)
    assert not eng.unified and eng.attn_impl == "gather"
    eng = ServingEngine(models[1], device="cpu", unified=True,
                        attn_impl="kernel", **ENGINE)
    assert eng.unified and eng.attn_impl == "kernel" and eng.grouped
    monkeypatch.setenv("PADDLE_TPU_UNIFIED_STEP", "maybe")
    with pytest.raises(ValueError, match="PADDLE_TPU_UNIFIED_STEP"):
        ServingEngine(models[1], device="cpu", **ENGINE)
    monkeypatch.setenv("PADDLE_TPU_UNIFIED_STEP", "on")
    monkeypatch.setenv("PADDLE_TPU_PAGED_ATTN", "dense")
    with pytest.raises(ValueError, match="PADDLE_TPU_PAGED_ATTN"):
        ServingEngine(models[1], device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="chunk_len must be >= 8"):
        ServingEngine(models[1], device="cpu", unified=False, num_slots=2,
                      max_len=32, page_size=8, chunk_len=4,
                      attn_impl="kernel")


@pytest.mark.parametrize("opts", [dict(unified=False),
                                  dict(attn_impl="gather")],
                         ids=["legacy", "gather"])
def test_grouped_drops_silently(monkeypatch, models, opts):
    """Only the unified kernel step has a grouped walk: an explicit
    grouped=True, and the gate, drop without an error, as in the JAX
    engine, and the tokens are the unified step's."""
    monkeypatch.setenv("PADDLE_TPU_GROUPED_ATTN", "on")
    eng = ServingEngine(models[1], device="cpu", grouped=True,
                        **{**ENGINE, **opts})
    assert eng.grouped is False and eng.metrics.grouped is False
    assert ServingEngine(models[1], device="cpu", **ENGINE).grouped
    ref = ServingEngine(models[1], device="cpu", grouped=False, **ENGINE)
    assert _serve(eng, SamplingParams) == _serve(ref, SamplingParams)


def test_prefill_buckets_stay_in_the_bucket_set(models):
    """Prompts of 1-60 tokens at chunk 32 run only buckets of
    {32} and {8 * 2**i <= 32}; each prompt's chunks are chunk_bucket's."""
    rs = np.random.RandomState(3)
    lens = [1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 40, 60]
    prompts = [rs.randint(0, 256, size=n).astype(np.int64) for n in lens]
    eng = ServingEngine(models[1], device="cpu", unified=False,
                        prefix_cache=False, num_slots=4, max_len=64,
                        page_size=8, chunk_len=32)
    eng.generate(prompts, SamplingParams(max_new_tokens=2))
    want, chunks = set(), 0
    for n in lens:
        cur = 0
        while cur < n:
            b = chunk_bucket(n - cur, 32, 8)
            want.add(b)
            cur += min(n - cur, b)
            chunks += 1
    assert eng.prefill_buckets == want <= {8, 16, 32}
    assert eng.prefill_buckets == {8, 16, 32}
    snap = eng.metrics.snapshot()
    assert snap["prefill_chunks"] == chunks
    assert snap["prefill_chunk_tokens"] == sum(lens)


def test_legacy_metrics(models):
    eng = ServingEngine(models[1], device="cpu", unified=False, **ENGINE)
    prompts = _prompts()
    outs = (eng.generate(prompts[:1], SamplingParams(max_new_tokens=4))
            + eng.generate(prompts[1:], SamplingParams(max_new_tokens=8)))
    snap = eng.metrics.snapshot()
    assert snap["unified"] is False and snap["attn_impl"] == "kernel"
    assert snap["unified_steps"] == 0
    assert snap["packed_prefill_tokens"] == snap["packed_decode_tokens"] == 0
    # every prompt token the prefix cache did not supply went through a
    # chunk; the later prompts attach the first one's system pages
    cached = sum(o.cached_tokens for o in outs)
    assert cached > 0
    assert snap["prefill_chunk_tokens"] == sum(p.size for p in prompts) \
        - cached
    assert snap["prefill_chunks"] >= len(prompts)
    assert snap["prefill_chunk_s"]["count"] == snap["prefill_chunks"]
    # one decode program per round that had a decoding row; rounds also
    # count those that only prefilled
    assert snap["decode_step_s"]["count"] >= 8
    assert snap["decode_steps"] >= snap["decode_step_s"]["count"]
    assert snap["prefill_stall_steps"] >= 1
    assert snap["tokens_generated"] == 4 + 5 * 8
