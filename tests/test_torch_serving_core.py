"""The serving core's surface against the JAX engine: `cache_spec`,
`scheduler=`, `metrics=` and `token_budget=`, `abort_all`,
`debug_state`, and the metrics' reading side (`tokens_per_sec`,
`achieved_util_recent`, bucketed histograms, `prometheus_render`).

Both engines serve the same traffic on the same weights (the geometry of
tests/test_torch_serving_defaults.py, `grouped=False`) under one manual
clock that only the test moves, between steps, so every time the engines
record is the same number. The budget engines run at their defaults,
obs, the SLO tracker and the "model" cost census on in both packages, so
the snapshot's `slo` and `cost_census` are live on both sides (the JAX
census's count of traced dispatches has no eager counterpart); the
abort engines run the JAX layers off.
"""
import copy
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
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (EngineClosed, SamplingParams,
                                      Scheduler, ServingEngine)
from paddle_tpu_torch.serving import metrics as tmetrics

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
# tests/test_serving_unified.py's tight budget: chunks of 16, 4 tokens a
# step
BUDGET = dict(num_slots=3, max_len=64, page_size=8, chunk_len=16,
              grouped=False, token_budget=4)
# tests/test_serving.py's abort_all geometry
ABORT = dict(num_slots=2, max_len=32, page_size=8, grouped=False)
JAX_GATES = dict(obs=False, slo=False, cost_census=False)
# the JAX engine counts its traced dispatches; an eager step has no trace
JAX_ONLY_SERIES = ("unified_dispatch_ops",)
JAX_ONLY_CENSUS = ("unified_dispatch",)
PORT_ONLY_KEYS = {"step_s", "prefill_chunk_s"}


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


class Clock:
    """A clock that moves only when the test moves it."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def models():
    """The JAX GPT and its port with the same weights, the JAX side on
    its jnp paths (a stand-in `disable_x64` that raises if entered)."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
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
    rs = np.random.RandomState(2)
    return [rs.randint(0, 256, size=n).astype(np.int64)
            for n in (5, 23, 9, 31, 14)]


def _drive(eng, sampling, clock):
    """Submit the prompts (priorities 0-2), step until idle with the
    clock moving 10 ms a step, and take `debug_state()` after 3 steps.
    Returns (tokens, debug state, steps)."""
    reqs = [eng.add_request(p, sampling(6, i % 3))
            for i, p in enumerate(_prompts())]
    state, steps = None, 0
    while eng.has_work:
        clock.t += 0.01
        eng.step()
        steps += 1
        if steps == 3:
            # a copy: the live census record is refreshed on later reads
            state = copy.deepcopy(eng.debug_state())
    return [list(r.output_tokens) for r in reqs], state, steps


@pytest.fixture(scope="module")
def jax_budget(models):
    clock = Clock()
    eng = JaxEngine(models[0], clock=clock, **BUDGET)
    tokens, state, steps = _drive(
        eng, lambda n, p: JaxSampling(max_new_tokens=n, priority=p), clock)
    m = eng.metrics
    out = dict(tokens=tokens, state=state, steps=steps, snap=m.snapshot(),
               tokens_per_sec=m.tokens_per_sec,
               util=m.achieved_util_recent,
               text=jmetrics.prometheus_render({"r0": m.snapshot()}),
               final_state=eng.debug_state())
    eng.drain()
    return out


@pytest.fixture(scope="module")
def port_budget(models):
    clock = Clock()
    eng = ServingEngine(models[1], device="cpu", clock=clock, **BUDGET)
    tokens, state, steps = _drive(
        eng, lambda n, p: SamplingParams(max_new_tokens=n, priority=p),
        clock)
    return eng, dict(tokens=tokens, state=state, steps=steps)


def test_token_budget_below_one_raises(models):
    with pytest.raises(ValueError, match="token_budget"):
        ServingEngine(models[1], device="cpu", num_slots=2, max_len=32,
                      page_size=8, chunk_len=8, token_budget=0)


def test_tight_token_budget_serves_the_jax_tokens(port_budget, jax_budget):
    """`token_budget=4` spreads prefill over many steps; the tokens, the
    step count and the packing equal the JAX engine's, and no step packs
    more than 4 tokens."""
    eng, run = port_budget
    assert eng.token_budget == 4
    assert run["tokens"] == jax_budget["tokens"]
    assert all(len(t) == 6 for t in run["tokens"])
    assert run["steps"] == jax_budget["steps"]
    snap = eng.metrics.snapshot()
    assert snap["packed_tokens_per_step"]["max"] <= 4
    for key in ("packed_tokens_per_step", "achieved_util"):
        assert snap[key] == jax_budget["snap"][key]


def test_tokens_per_sec_and_achieved_util_equal_the_jax_engine(
        port_budget, jax_budget):
    """F12: `tokens_per_sec` is a property and a snapshot key with the
    JAX engine's value (the busy window on the shared clock), as is
    `achieved_util_recent`."""
    m = port_budget[0].metrics
    assert m.tokens_per_sec == pytest.approx(jax_budget["tokens_per_sec"],
                                             rel=1e-12)
    assert m.tokens_per_sec > 0
    assert m.snapshot()["tokens_per_sec"] == m.tokens_per_sec
    assert "tokens_per_s" not in m.snapshot()
    assert m.achieved_util_recent == pytest.approx(jax_budget["util"],
                                                   rel=1e-12)


def _key_tree(d):
    """The nested key set of a snapshot: {key: subtree or None}."""
    return {k: (_key_tree(v) if isinstance(v, dict) and v
                and all(isinstance(x, str) for x in v) else None)
            for k, v in d.items()}


def _no_jax_only(d):
    """A snapshot or debug state without the JAX census's traced-dispatch
    record."""
    census = d.get("cost_census")
    return d if census is None else {**d, "cost_census": {
        k: v for k, v in census.items() if k not in JAX_ONLY_CENSUS}}


def test_snapshot_has_the_jax_keys_and_values(port_budget, jax_budget):
    snap = port_budget[0].metrics.snapshot()
    want = _no_jax_only(jax_budget["snap"])
    assert snap["slo"] is not None and snap["cost_census"] is not None
    assert set(snap) == set(want) | PORT_ONLY_KEYS
    ours = _key_tree({k: v for k, v in snap.items()
                      if k not in PORT_ONLY_KEYS})
    assert ours == _key_tree(want)
    # every count and gauge the engines share, the clock's times
    # included; decode_step_s is host wall time and differs
    for key, value in want.items():
        if key in ("decode_step_s", "unified_dispatch_ops"):
            continue
        assert snap[key] == value, key


def _series(text):
    return [ln for ln in text.splitlines()
            if not any(f"_{name}" in ln for name in JAX_ONLY_SERIES)]


def test_prometheus_render_equals_the_jax_text(port_budget, jax_budget):
    """Line for line, on one clock: every series, label (kv_dtype
    among the engine_info labels) and value, except the JAX engine's
    count of traced dispatches."""
    text = tmetrics.prometheus_render(
        {"r0": port_budget[0].metrics.snapshot()})
    assert _series(text) == _series(jax_budget["text"])
    assert 'kv_dtype="fp"' in text
    assert "paddle_serving_ttft_seconds_bucket" in text


def test_debug_state_equals_the_jax_engine(port_budget, jax_budget):
    """Mid-run (after 3 steps, the queue still holding requests) and at
    the end: the whole dict, the residents, queue, pools, prefix cache
    and config included."""
    eng, run = port_budget
    assert run["state"]["queue"]["depth"] > 0 and run["state"]["residents"]
    assert run["state"] == _no_jax_only(jax_budget["state"])
    assert eng.debug_state() == _no_jax_only(jax_budget["final_state"])
    assert eng.debug_state()["config"]["token_budget"] == 4


def test_given_cache_spec_scheduler_and_metrics_are_used(models):
    tm = models[1]
    sched, metrics = Scheduler(3), tmetrics.ServingMetrics()
    eng = ServingEngine(tm, (2, 4, 16), device="cpu", num_slots=3,
                        max_len=32, page_size=8, scheduler=sched,
                        metrics=metrics)
    assert eng.scheduler is sched and eng.metrics is metrics
    assert (eng.n_layers, eng.n_kv, eng.head_dim) == (2, 4, 16)
    assert eng.token_budget == 3 * eng.chunk_len
    out = eng.generate([np.arange(1, 6)], SamplingParams(max_new_tokens=3))
    assert len(out[0].token_ids) == 3
    assert metrics.tokens_generated == 3 and sched.queue_depth == 0
    with pytest.raises(ValueError, match="num_slots"):
        ServingEngine(tm, device="cpu", num_slots=3, max_len=32,
                      page_size=8, scheduler=Scheduler(2))


def _abort_traffic(eng, sampling):
    ra = eng.add_request(np.array([3, 14, 15, 9], np.int64), sampling(10))
    rb = eng.add_request(np.array([26, 5, 35], np.int64), sampling(10))
    rc = eng.add_request(np.array([1, 2], np.int64), sampling(4))
    eng.step()
    eng.step()                        # ra/rb decoding, rc queued
    used = eng.pool.used_pages
    outs = eng.abort_all("replica_failure")
    return (ra, rb, rc), outs, used


def test_abort_all_retires_everything_and_frees_every_page(models):
    """tests/test_serving.py's abort_all case on both engines: every
    request retires with the reason, residents keep their tokens (the
    JAX engine's), the pool is whole and the engine closed."""
    jeng = JaxEngine(models[0], **ABORT, **JAX_GATES)
    jreqs, jouts, jused = _abort_traffic(
        jeng, lambda n: JaxSampling(max_new_tokens=n))
    eng = ServingEngine(models[1], device="cpu", **ABORT)
    reqs, outs, used = _abort_traffic(
        eng, lambda n: SamplingParams(max_new_tokens=n))
    assert used == jused > 0
    assert len(outs) == len(jouts) == 3
    assert all(r.finish_reason == "replica_failure" for r in reqs)
    assert [r.output_tokens for r in reqs] == \
        [list(r.output_tokens) for r in jreqs]
    assert len(reqs[0].output_tokens) > 0 and reqs[2].output_tokens == []
    assert eng.pool.free_pages == eng.num_pages - 1
    assert not eng.has_work and eng.closed
    assert eng.metrics.requests_aborted == jeng.metrics.requests_aborted == 3
    assert eng.debug_state()["closed"] is True
    with pytest.raises(EngineClosed):
        eng.add_request(np.array([1], np.int64))


def test_abort_all_frees_preempted_requests_host_pages(models):
    """A preempted request's host-tier pages go back too."""
    eng = ServingEngine(models[1], device="cpu", num_slots=2, max_len=64,
                        page_size=8, num_pages=6, chunk_len=16,
                        grouped=False)
    lo = eng.add_request(np.arange(1, 9), SamplingParams(max_new_tokens=24,
                                                         priority=5))
    for _ in range(6):
        eng.step()
    eng.add_request(np.arange(30, 38), SamplingParams(max_new_tokens=24,
                                                      priority=0))
    eng.step()
    assert lo.preemptions >= 1 and eng.host_pool.used_pages > 0
    eng.abort_all()
    assert lo.finish_reason == "aborted"
    assert eng.host_pool.used_pages == 0
    assert eng.pool.free_pages == eng.num_pages - 1


class _R:
    pass


def _fake(prio, reason, deadline=1.0):
    r = _R()
    r.sampling = JaxSampling(max_new_tokens=4, priority=prio,
                             deadline_s=deadline)
    r.output_tokens = [1]
    r.arrival_t = 0.0
    r.finish_reason = reason
    return r


def _feed_obs_inputs(m):
    """tests/test_serving_obs.py's populated metrics: 40 requests over
    three priority classes, a quarter of them deadline-failed."""
    rng = np.random.RandomState(1)
    for i in range(40):
        r = _fake(i % 3, "stop" if i % 4 else "deadline")
        m.on_token(r, float(rng.exponential(0.1)))
        m.on_inter_token(float(rng.exponential(0.01)), priority=i % 3)
        m.on_finish(r, float(rng.exponential(0.5)))
    for prio, reason in ((0, "stop"), (5, "deadline")):
        r = _fake(prio, reason)
        m.on_token(r, 0.01)
        m.on_finish(r, 0.5)
    m.on_inter_token(0.005, priority=5)


def test_prometheus_render_on_the_obs_tests_inputs():
    """The JAX obs tests' inputs through both packages' metrics: the same
    snapshot (but the port's two keys) and the same text, also with a
    replica label that needs escaping, router series and extra gauges;
    the bucketed histograms are cumulative and end at +Inf = count."""
    ours, theirs = tmetrics.ServingMetrics(), jmetrics.ServingMetrics()
    _feed_obs_inputs(ours)
    _feed_obs_inputs(theirs)
    snap, want = ours.snapshot(), theirs.snapshot()
    assert {k: v for k, v in snap.items() if k not in PORT_ONLY_KEYS} \
        == want
    evil = 'rep"li\\ca\nzero'
    router = {"retries_total": 2, "breakers": {"r0": "open"},
              "controlplane": {"scale_up_total": 1,
                               "desired_replicas": 3}}
    for snaps in ({"r0": snap}, {evil: snap}):
        assert tmetrics.prometheus_render(
            snaps, router=router, extra_gauges={"fleet_size": 2}) == \
            jmetrics.prometheus_render(
                {k: want for k in snaps}, router=router,
                extra_gauges={"fleet_size": 2})
    assert snap["deadline_goodput"] == {"met": 31, "missed": 11}
    cum = ours.ttft_s.cumulative_buckets()
    assert [n for _, n in cum] == sorted(n for _, n in cum)
    assert cum[-1] == (float("inf"), ours.ttft_s.count)
    assert snap["ttft_s"]["buckets"][-1] == ["+Inf", ours.ttft_s.count]
    text = tmetrics.prometheus_render({evil: snap})
    assert 'replica="rep\\"li\\\\ca\\nzero"' in text
