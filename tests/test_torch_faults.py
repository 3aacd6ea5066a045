"""Fault injection and poison quarantine in the port's serving engine,
against the JAX package.

`FaultInjector` (`serving/faults.py`): `parse` builds the same schedules
from the same `PADDLE_TPU_FAULTS` specs and refuses the same ones with
the same texts; each hook fires once where the JAX one fires, and
`chaos_schedule` draws the same schedule from the same seed (both take
their randomness from `random.Random(seed)`).

Quarantine: tests/test_serving_faults.py's three `TestPoisonQuarantine`
contracts (a poisoned resident isolated by bisection with its
co-residents token-identical; a poison arriving mid-decode; a fault that
tracks no single request propagating and poisoning nobody), on the
unified step, the legacy step and the n-gram spec engine, each against
the JAX engine on the same f32 weights (built once per module): the same
request is poisoned, the innocents' tokens and `requests_poisoned` are
the JAX engine's. A raising round leaves the pools, positions and held
logits bit for bit, and a CUDA error propagates without a probe.
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
from paddle_tpu.serving import faults as jfaults
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (FaultInjector, InjectedFault,
                                      PoisonedRequest, SamplingParams,
                                      ServingEngine, resolve_faults)
from paddle_tpu_torch.serving import faults as tfaults

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# tests/test_serving_faults.py's tiny GPT
GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=16,
              grouped=False)
PROMPTS = [[3, 14, 15, 9], [26, 5, 35], [1, 2, 3, 4, 5, 6], [7, 8, 9]]
ARMS = {"unified": {}, "legacy": dict(unified=False),
        "spec": dict(spec="ngram:4")}
_GATES = ("PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_PAGED_ATTN", "PADDLE_TPU_GROUPED_ATTN",
          "PADDLE_TPU_KV_DTYPE", "PADDLE_TPU_PREEMPT",
          "PADDLE_TPU_MEGAKERNEL", "PADDLE_TPU_ADAPTERS",
          "PADDLE_TPU_PREFIX_CACHE", "PADDLE_TPU_OBS", "PADDLE_TPU_SLO",
          "PADDLE_TPU_COST_CENSUS", "PADDLE_TPU_FAULTS")


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (tiny engines beside
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX GPT and its port on the same weights, the JAX side on its
    jnp paths (a stand-in `disable_x64` that raises if entered)."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    for gate in _GATES:
        mp.delenv(gate, raising=False)
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    try:
        paddle.seed(7)
        jm = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0,
                                 **GEOMETRY))
        jm.eval()
        tm = GPTForCausalLM(GPTConfig(**GEOMETRY), device="cpu")
        tm.load_state_dict(convert.from_paddle_state_dict(
            {k: v.numpy() for k, v in jm.state_dict().items()}))
        tm.eval()
        yield jm, tm
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


# -- the injector ------------------------------------------------------------
SPECS = ["kill:replica-0@40;hang:replica-1@10x0.0;fail_add:3;"
         "fail_add:replica-0@2;poison:req-9;spike:replica-0@20x8;seed:5",
         "kill:r@0;kill:r@0;spike:*@3", " ;fail_add:1; ",
         "boom:r@1", "kill:r@x", "spike:r@2x0", "fail_add:0", "hang:r@"]


def _drive(inj, steps=45):
    """Every hook over a fixed sequence of calls -> what fired where."""
    seen = []
    for step in range(steps):
        for rep in ("replica-0", "replica-1", "r"):
            try:
                inj.on_step(rep, step)
            except Exception as e:
                seen.append(("kill", rep, step, str(e)))
            n = inj.take_spike(rep, step)
            if n:
                seen.append(("spike", rep, step, n))
            try:
                inj.on_add_request(rep, f"{rep}-{step}")
            except Exception as e:
                seen.append(("add", rep, step, str(e), e.kind,
                             e.request_id))
            try:
                inj.on_engine_step(rep, [f"req-{step % 12}", "req-x"])
            except Exception as e:
                seen.append(("poison", rep, step, str(e), e.request_id))
    return seen, (inj.kills_fired, inj.hangs_fired, inj.add_fails_fired,
                  inj.poison_hits, inj.spikes_fired)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_hooks_match_jax(spec):
    outs = []
    for mod in (tfaults, jfaults):
        try:
            inj = mod.FaultInjector.parse(spec)
        except ValueError as e:
            outs.append(("ValueError", str(e)))
            continue
        notes = []
        inj.subscribe(lambda kind, rep, detail: notes.append(
            (kind, rep, detail)))
        outs.append((_drive(inj), notes, inj.rng.random()))
    assert outs[0] == outs[1]


def test_fired_faults_are_typed_and_fire_once():
    inj = FaultInjector().kill_at_step("a", 2).fail_add_request(2, "a")
    inj.on_step("a", 1)
    with pytest.raises(InjectedFault) as e:
        inj.on_step("a", 5)
    assert e.value.kind == "kill"
    inj.on_step("a", 6)            # one-shot
    inj.on_add_request("a", "x")
    with pytest.raises(InjectedFault) as e:
        inj.on_add_request("a", "y")
    assert (e.value.kind, e.value.request_id) == ("add_request", "y")
    inj.on_add_request("a", "z")
    inj.poison("p")
    with pytest.raises(InjectedFault):
        inj.on_engine_step("a", ["q", "p"])
    inj.clear_poison("p")
    inj.on_engine_step("a", ["p"])
    with pytest.raises(ValueError):
        inj.spike_at_step("a", 1, 0)
    with pytest.raises(ValueError):
        inj.fail_add_request(0)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_chaos_schedule_matches_jax_for_a_seed(seed):
    reps = [f"replica-{i}" for i in range(5)]
    for kw in (dict(), dict(kills=3, hangs=2, keep_alive=2, max_step=50)):
        got = tfaults.FaultInjector(seed).chaos_schedule(reps, **kw)
        want = jfaults.FaultInjector(seed).chaos_schedule(reps, **kw)
        assert got == want and got


def test_resolve_faults_env(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_FAULTS", raising=False)
    assert resolve_faults() is None and resolve_faults("  ") is None
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "poison:req-1")
    inj = resolve_faults()
    with pytest.raises(InjectedFault):
        inj.on_engine_step("r", ["req-1"])
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "nope:1")
    with pytest.raises(ValueError) as got:
        resolve_faults()
    with pytest.raises(ValueError) as want:
        jfaults.resolve_faults()
    assert str(got.value) == str(want.value)


# -- poison quarantine against the JAX engine --------------------------------
def _hooked(eng, inj):
    eng.step_fault_hook = lambda ids: inj.on_engine_step("r0", ids)
    return eng


def _isolate(make_engine, sampling, victim=1, after=None, n_new=10):
    """tests/test_serving_faults.py's first two contracts in one run:
    poison `victim` at admission (after=None) or after `after` steps."""
    inj = FaultInjector() if make_engine.__name__ == "port" else \
        jfaults.FaultInjector()
    eng = _hooked(make_engine(), inj)
    reqs = [eng.add_request(np.array(p, np.int64), sampling(n_new))
            for p in PROMPTS]
    if after is None:
        inj.poison(reqs[victim].request_id)
    else:
        for _ in range(after):
            eng.step()
        assert len(reqs[victim].output_tokens) > 0
        inj.poison(reqs[victim].request_id)
    eng.run()
    snap = eng.metrics.snapshot()
    out = dict(reasons=[r.finish_reason for r in reqs],
               tokens=[list(r.output_tokens) for r in reqs],
               errors=[type(r.error).__name__ if r.error else None
                       for r in reqs],
               poisoned=snap["requests"]["poisoned"],
               hits=inj.poison_hits)
    eng.drain()
    eng.pool.assert_quiesced()
    return eng, out


CASES = [(arm, after) for arm in ARMS for after in (None, 5)]


@pytest.fixture(scope="module")
def jax_quarantine(models):
    jm = models[0]
    out = {}
    for arm, after in CASES:
        def jax():
            return JaxEngine(jm, **ENGINE, **ARMS[arm])
        out[arm, after] = _isolate(
            jax, lambda n: JaxSampling(max_new_tokens=n), after=after)[1]
    return out


@pytest.mark.parametrize("arm,after", CASES)
def test_quarantine_isolates_the_jax_engines_victim(models, jax_quarantine,
                                                    arm, after):
    tm = models[1]

    def port():
        return ServingEngine(tm, device="cpu", **ENGINE, **ARMS[arm])

    eng, got = _isolate(port, lambda n: SamplingParams(max_new_tokens=n),
                        after=after)
    want = jax_quarantine[arm, after]
    assert got["reasons"] == want["reasons"] == \
        ["length", "poisoned", "length", "length"]
    assert got["errors"][1] == "PoisonedRequest"
    assert got["poisoned"] == want["poisoned"] == 1
    for i in (0, 2, 3):
        assert got["tokens"][i] == want["tokens"][i], (arm, i)
    if after is not None:
        # the victim keeps the tokens it streamed before the poison
        assert got["tokens"][1] == want["tokens"][1]
        assert len(got["tokens"][1]) > 0
    # innocents equal a run with no victim at all
    ref = ServingEngine(tm, device="cpu", **ENGINE, **ARMS[arm])
    solo = ref.generate([np.array(p, np.int64) for p in PROMPTS],
                        SamplingParams(max_new_tokens=10))
    for i in (0, 2, 3):
        assert got["tokens"][i] == list(solo[i].token_ids)
    kinds = [i["kind"] for i in eng.obs.flight.snapshot()["incidents"]]
    assert kinds == ["step_fault", "poison_quarantine"]
    assert eng.obs.tracer.timeline(
        f"req-{1}")[-1]["kind"] == "poison"


@pytest.mark.parametrize("arm", list(ARMS))
def test_global_fault_is_not_blamed_on_a_request(models, arm):
    """A fault that tracks no single request (every probe raises) fails
    the verdict and propagates; nobody is poisoned, in either package."""
    for make, samp in (
            (lambda: ServingEngine(models[1], device="cpu", **ENGINE,
                                   **ARMS[arm]), SamplingParams),
            (lambda: JaxEngine(models[0], **ENGINE, **ARMS[arm]),
             JaxSampling)):
        eng = make()
        boom = RuntimeError("global device fault")

        def hook(ids):
            raise boom

        eng.step_fault_hook = hook
        for p in ([3, 14, 15], [5, 6, 7]):
            eng.add_request(np.array(p, np.int64), samp(max_new_tokens=4))
        with pytest.raises(RuntimeError) as ei:
            eng.run()
        assert ei.value is boom
        assert eng.metrics.requests_poisoned == 0
        assert eng.metrics.snapshot()["requests"]["poisoned"] == 0


def _state(eng):
    return ([t.clone() for layer in eng._pools for t in layer
             if t is not None], eng._pos.copy(), eng._last_logits.clone(),
            dict(eng._prefill_cursor), eng._pt_host.copy(),
            {s: len(r.output_tokens) for s, r in eng.scheduler.running.items()})


@pytest.mark.parametrize("arm", list(ARMS) + ["int8", "megakernel"])
def test_a_raising_round_moves_nothing(models, arm):
    """A hook raising for every round, mid-run (residents prefilling and
    decoding): the round, and then each probe, raise before any launch,
    leaving the pools, positions, held logits, cursors, page tables and
    emitted tokens bit for bit."""
    extra = {"int8": dict(kv_dtype="int8"),
             "megakernel": dict(megakernel=True)}.get(arm, ARMS.get(arm))
    eng = ServingEngine(models[1], device="cpu", **{**ENGINE, **extra})
    reqs = [eng.add_request(np.array(p * 6, np.int64),
                            SamplingParams(max_new_tokens=8))
            for p in PROMPTS]
    for _ in range(3):
        eng.step()
    assert {r.state.name for r in reqs} >= {"DECODE"}
    before = _state(eng)
    calls = []

    def hook(ids):
        calls.append(list(ids))
        raise RuntimeError("boom")

    eng.step_fault_hook = hook
    with pytest.raises(RuntimeError, match="boom"):
        eng._run_round([])
    for suppress in ({0, 1}, {2, 3}, {3}):
        with pytest.raises(RuntimeError, match="boom"):
            eng._run_round([], suppress=frozenset(suppress))
    after = _state(eng)
    for b, a in zip(before[0], after[0]):
        assert torch.equal(b, a)
    assert torch.equal(before[2], after[2])
    assert np.array_equal(before[1], after[1])
    assert np.array_equal(before[4], after[4])
    assert before[3] == after[3] and before[5] == after[5]
    assert len(calls) == 4 and all(calls)


def test_a_cuda_error_is_replica_death_without_probes(models):
    eng = ServingEngine(models[1], device="cpu", **ENGINE)
    for p in PROMPTS:
        eng.add_request(np.array(p, np.int64),
                        SamplingParams(max_new_tokens=4))
    calls = []

    def hook(ids):
        calls.append(ids)
        raise RuntimeError("K6 launch: CUDA error 700 (an illegal memory "
                           "access was encountered)")

    eng.step_fault_hook = hook
    with pytest.raises(RuntimeError, match="CUDA error"):
        eng.step()
    assert len(calls) == 1 and eng.metrics.requests_poisoned == 0
    kinds = [i["kind"] for i in eng.obs.flight.snapshot()["incidents"]]
    assert kinds == ["step_fault", "replica_death"]


def test_poisoned_request_is_typed_and_counted(models):
    eng = ServingEngine(models[1], device="cpu", **ENGINE)
    inj = FaultInjector()
    _hooked(eng, inj)
    reqs = [eng.add_request(np.array(p, np.int64),
                            SamplingParams(max_new_tokens=3))
            for p in PROMPTS[:2]]
    inj.poison(reqs[0].request_id)
    eng.run()
    assert isinstance(reqs[0].error, PoisonedRequest)
    assert eng.metrics.requests_poisoned == 1
    from paddle_tpu_torch.serving.metrics import prometheus_render
    text = prometheus_render({"r0": eng.metrics.snapshot()})
    assert 'paddle_serving_poisoned_total{replica="r0"} 1' in text
