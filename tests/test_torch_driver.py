"""The engine driver (`serving/http/driver.py`) of the port, against the
JAX package's.

Each test runs the same schedule through a port `EngineDriver` and a
JAX one over engines on the same f32 weights. Requests are queued on the
engine before the pump starts, so the pump's steps are the same in both
packages whatever the threads do: a `FaultInjector.kill_at_step` fails
the pending submissions with `ReplicaDead`, retires every resident as
"replica_failure" with the tokens it had streamed (equal to the JAX
driver's), and freezes the flight ring into a "replica_death" incident;
`fail_add_request(3)` refuses the third admission only; a poisoned
request fails alone through the engine's quarantine; `condemn()` takes
the death path from outside with `ReplicaHung`; the heartbeat beats.
Every wait is bounded and every pump thread is joined.
"""
import sys
import time

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
from paddle_tpu.serving.http import driver as jdriver
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (EngineClosed, FaultInjector,
                                      SamplingParams, ServingEngine)
from paddle_tpu_torch.serving.http import (EngineDriver, ReplicaDead,
                                           ReplicaHung)

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=16,
              grouped=False)
PROMPTS = [[3, 14, 15, 9], [26, 5, 35], [1, 2, 3, 4, 5, 6], [7, 8, 9],
           [11, 12], [40, 41, 42, 43, 44]]
JOIN_S = 60.0


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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
    for gate in ("PADDLE_TPU_OBS", "PADDLE_TPU_SLO", "PADDLE_TPU_FAULTS",
                 "PADDLE_TPU_COST_CENSUS", "PADDLE_TPU_UNIFIED_STEP",
                 "PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_PREFIX_CACHE"):
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


def _sides(models):
    jm, tm = models
    return {"port": (lambda: ServingEngine(tm, device="cpu", **ENGINE),
                     EngineDriver, FaultInjector, SamplingParams,
                     ReplicaDead),
            "jax": (lambda: JaxEngine(jm, **ENGINE), jdriver.EngineDriver,
                    jfaults.FaultInjector, JaxSampling,
                    jdriver.ReplicaDead)}


def _wait(pred, timeout=JOIN_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _kill_run(side, step):
    make, Driver, Injector, Sampling, Dead = side
    eng = make()
    inj = Injector().kill_at_step("replica-0", step)
    drv = Driver(eng, "replica-0", faults=inj, poll_interval_s=0.001)
    reqs = [eng.add_request(np.array(p, np.int64),
                            Sampling(max_new_tokens=20)) for p in PROMPTS]
    drv.start()
    assert _wait(lambda: drv.dead)
    drv._thread.join(JOIN_S)
    assert not drv._thread.is_alive()
    with pytest.raises(Dead):
        drv.submit(np.array([1, 2, 3], np.int64))
    assert drv.steps == step
    out = dict(reasons=[r.finish_reason for r in reqs],
               tokens=[list(r.output_tokens) for r in reqs],
               kills=inj.kills_fired, death=type(drv.death_exc).__name__,
               incidents=[i["kind"] for i in
                          eng.obs.flight.snapshot()["incidents"]],
               notes=[r["note"] for r in eng.obs.flight.snapshot()["steps"]
                      if "note" in r])
    eng.pool.assert_quiesced()
    return out


@pytest.mark.parametrize("step", [0, 6])
def test_kill_matches_the_jax_driver(models, step):
    sides = _sides(models)
    got, want = _kill_run(sides["port"], step), _kill_run(sides["jax"], step)
    assert got == want
    assert got["death"] == "InjectedFault" and got["kills"] == 1
    assert set(got["reasons"]) == {"replica_failure"}
    assert got["incidents"] == ["replica_death"]
    assert got["notes"] == ["fault:kill"]
    assert (sum(map(len, got["tokens"])) > 0) is (step > 0)


def _add_fail_run(side):
    make, Driver, Injector, Sampling, _ = side
    eng = make()
    inj = Injector().fail_add_request(3)
    drv = Driver(eng, "replica-0", faults=inj, poll_interval_s=0.001)
    drv.start()
    outcomes = []
    for p in PROMPTS[:5]:
        try:
            req = drv.submit(np.array(p, np.int64),
                             Sampling(max_new_tokens=6))
            outcomes.append(req)
        except Exception as e:
            outcomes.append(type(e).__name__)
    assert drv.drain(JOIN_S)
    reasons = [o if isinstance(o, str) else o.finish_reason
               for o in outcomes]
    tokens = [None if isinstance(o, str) else list(o.output_tokens)
              for o in outcomes]
    return reasons, tokens, inj.add_fails_fired


def test_failed_admission_matches_the_jax_driver(models):
    sides = _sides(models)
    got, want = _add_fail_run(sides["port"]), _add_fail_run(sides["jax"])
    assert got == want
    assert got[0] == ["length", "length", "InjectedFault", "length",
                      "length"]
    assert got[2] == 1


def test_poison_through_the_driver_fails_one_request(models):
    tm = models[1]
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    inj = FaultInjector()
    drv = EngineDriver(eng, "replica-0", faults=inj, poll_interval_s=0.001)
    reqs = [eng.add_request(np.array(p, np.int64),
                            SamplingParams(max_new_tokens=8))
            for p in PROMPTS[:4]]
    inj.poison(reqs[2].request_id)
    drv.start()
    assert _wait(lambda: all(r.finished for r in reqs))
    assert drv.drain(JOIN_S) and not drv.dead
    assert [r.finish_reason for r in reqs] == \
        ["length", "length", "poisoned", "length"]
    solo = ServingEngine(tm, device="cpu", **ENGINE).generate(
        [np.array(p, np.int64) for p in PROMPTS[:4]],
        SamplingParams(max_new_tokens=8))
    for i in (0, 1, 3):
        assert list(reqs[i].output_tokens) == list(solo[i].token_ids)
    notes = [r["note"] for r in eng.obs.flight.snapshot()["steps"]
             if "note" in r]
    assert notes and set(notes) == {"fault:poison"}


def test_condemn_heartbeat_and_stats(models):
    eng = ServingEngine(models[1], device="cpu", **ENGINE)
    drv = EngineDriver(eng, "replica-0", poll_interval_s=0.001,
                       condemn_grace_s=5.0)
    assert eng.heartbeat_hook is not None and eng.step_fault_hook is None
    with pytest.raises(EngineClosed):
        drv.submit(np.array([1, 2], np.int64))
    drv.start()
    req = drv.submit(np.array([5, 6, 7], np.int64),
                     SamplingParams(max_new_tokens=40))
    assert _wait(lambda: len(req.output_tokens) >= 2)
    assert drv.last_beat is not None and drv.healthy
    stats = drv.stats()
    assert stats["slo_state"] == "ok" and stats["name"] == "replica-0"
    assert stats["adapters_hot"] == [] and stats["dead"] is False
    drv.condemn()
    assert drv.dead and isinstance(drv.death_exc, ReplicaHung)
    drv._thread.join(JOIN_S)
    assert not drv._thread.is_alive()
    assert req.finish_reason == "replica_failure"
    with pytest.raises(ReplicaDead):
        drv.submit(np.array([1], np.int64))
    drv.cancel(req.request_id)           # a dead driver ignores it
    assert [i["kind"] for i in eng.obs.flight.snapshot()["incidents"]] == \
        ["replica_death"]
    with pytest.raises(ReplicaDead):
        drv.call(lambda e: e)


def test_call_runs_on_the_pump_between_steps(models):
    eng = ServingEngine(models[1], device="cpu", **ENGINE)
    drv = EngineDriver(eng, "replica-0", poll_interval_s=0.001)
    assert drv.call(lambda e: e.num_slots) == 4        # inline, not started
    drv.start()
    req = drv.submit(np.array([9, 8, 7], np.int64),
                     SamplingParams(max_new_tokens=5))
    assert drv.call(lambda e: e.closed) is False
    with pytest.raises(KeyError):
        drv.call(lambda e: {}["x"])
    assert _wait(lambda: req.finished)
    assert drv.drain(JOIN_S) and not drv._thread.is_alive()
    assert drv.call(lambda e: e.closed) is True        # inline after drain
