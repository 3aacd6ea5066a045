"""The fleet control plane (`serving/controlplane.py`) of the port, against
the JAX package's.

The pure parts run through both packages on the same inputs: the spec
texts and `ControlPlaneConfig`'s refusals (the same fields or the same
error type and message), `decide` over tables of `FleetSignals` on an
injected clock (the same decisions, reasons, records and stats), and the
admission math (the same predicted waits, Retry-After hints and shed
counts). `observe` reads the same signals off a port router and a JAX
router over engines on the same f32 weights. The live router: replicas
added and removed at run time (names never reused, the last live one
refused, a replica removed mid-stream finishing with the JAX engine's
tokens), the dead-replica tombstone cap, SLO-aware placement, `poll`'s
actuation and notes, the deadline-infeasible shed, the exposition's
series beside the JAX render's, and `serve`'s PADDLE_TPU_CONTROLPLANE
gate. A counted census ("lowered") read by the controller's thread is
captured once, on the driver's pump thread. Every wait is bounded and
every router is drained.
"""
import sys
import threading
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
from paddle_tpu.serving import controlplane as jcp
from paddle_tpu.serving import prometheus_render as jax_render
from paddle_tpu.serving.http import EngineDriver as JaxDriver
from paddle_tpu.serving.http import Router as JaxRouter
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (ControlPlaneConfig, DeadlineInfeasible,
                                      FleetController, FleetSignals,
                                      QueueFull, SamplingParams,
                                      ServingEngine, SLOConfig,
                                      parse_controlplane_spec,
                                      prometheus_render,
                                      resolve_controlplane,
                                      slo_placement_rank)
from paddle_tpu_torch.serving import controlplane as tcp
from paddle_tpu_torch.serving.http import EngineDriver, Router, serve

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=128)
ENGINE = dict(num_slots=2, max_len=64, grouped=False)
_GATES = ("PADDLE_TPU_OBS", "PADDLE_TPU_SLO", "PADDLE_TPU_FAULTS",
          "PADDLE_TPU_COST_CENSUS", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_PREFIX_CACHE",
          "PADDLE_TPU_CONTROLPLANE", "PADDLE_TPU_KV_FABRIC",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE")
JOIN_S = 30.0


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


def port_engine(models, **kw):
    return ServingEngine(models[1], device="cpu", **{**ENGINE, **kw})


def jax_engine(models, **kw):
    return JaxEngine(models[0], **{**ENGINE, **kw})


def flight_notes(eng, kind):
    return [e for e in eng.obs.flight.snapshot()["steps"]
            if e.get("note") == kind]


def outcome(fn, *args, **kw):
    """("ok", value) or ("raise", type name, message): what a call gives,
    in a form two packages' results compare by."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:     # noqa: BLE001 - the type is the result
        return ("raise", type(e).__name__, str(e))


def cfg_fields(cfg):
    return None if cfg is None else dict(vars(cfg))


# -- the gate: spec texts and the config's refusals --------------------------
SPECS = ["off", "0", "false", "on", "1", "true", "", "  on  ",
         "min=2,max=5,target_util=0.6,up_burn=3.5,down_util=0.2,"
         "up_cooldown=1,down_cooldown=2,interval=0.5,est_tokens=32,"
         "hw_flops=1e9,slack=1.5",
         "min=3", "max=4,min=2", " min = 2 , max=3", "bogus_key=1", "min",
         "min=lots", "est_tokens=1.5", "min=0", "min=3,max=2",
         "target_util=0", "target_util=1.5", "target_util=0.5,down_util=0.5",
         "up_cooldown=-1", "est_tokens=0", "hw_flops=0", "slack=0",
         "interval=abc", "min=2,,max=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_texts_match_jax(spec):
    """Each text parses to the JAX config's fields or raises the JAX
    package's error type and message."""
    got = outcome(lambda: cfg_fields(parse_controlplane_spec(spec)))
    want = outcome(lambda: cfg_fields(jcp.parse_controlplane_spec(spec)))
    assert got == want


CONFIGS = [dict(), dict(min_replicas=0), dict(min_replicas=3,
                                              max_replicas=2),
           dict(target_util=0.0), dict(target_util=1.01),
           dict(target_util=0.5, scale_down_util=0.5),
           dict(scale_down_util=-0.1), dict(scale_up_cooldown_s=-1),
           dict(scale_down_cooldown_s=-1), dict(est_request_tokens=0),
           dict(hw_flops_per_s=0), dict(admission_slack=0),
           dict(min_replicas=2, max_replicas=2, target_util=1.0)]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(kw) or "-")
def test_config_validation_matches_jax(kw):
    got = outcome(lambda: cfg_fields(ControlPlaneConfig(**kw)))
    want = outcome(lambda: cfg_fields(jcp.ControlPlaneConfig(**kw)))
    assert got == want


@pytest.mark.parametrize("override,env", [
    (None, None), (None, "on"), (None, "min=2,max=4"), (False, "on"),
    (True, "off"), ("min=3", "off"), ("off", "on"), (None, "nope=1")])
def test_resolve_matches_jax(monkeypatch, override, env):
    if env is None:
        monkeypatch.delenv("PADDLE_TPU_CONTROLPLANE", raising=False)
    else:
        monkeypatch.setenv("PADDLE_TPU_CONTROLPLANE", env)
    got = outcome(lambda: cfg_fields(resolve_controlplane(override)))
    want = outcome(lambda: cfg_fields(jcp.resolve_controlplane(override)))
    assert got == want
    cfg = ControlPlaneConfig(min_replicas=2)
    assert resolve_controlplane(cfg) is cfg


def test_exports_and_placement_rank():
    """The JAX names, the JAX ranks, and DeadlineInfeasible a QueueFull
    (the HTTP layer's 429 path)."""
    assert set(jcp.__all__) == set(tcp.__all__)
    assert tcp.CONTROLPLANE_ENV == jcp.CONTROLPLANE_ENV
    for st in ("ok", "warn", "page", None):
        assert slo_placement_rank(st) == jcp.slo_placement_rank(st)
    assert issubclass(DeadlineInfeasible, QueueFull)


# -- the decision core: tables of signals on an injected clock ---------------
DECIDE_TABLES = {
    "double_window_burn": (dict(), [
        (dict(replicas=2, fast_burn=5.0, slow_burn=5.0, mean_util=0.5),
         0.0)]),
    "single_window_burn": (dict(), [
        (dict(replicas=2, fast_burn=50.0, slow_burn=0.0, mean_util=0.5),
         0.0)]),
    "util_then_cooldown": (dict(scale_up_cooldown_s=15.0), [
        (dict(replicas=2, mean_util=0.9), 100.0),
        (dict(replicas=2, mean_util=0.9), 101.0),
        (dict(replicas=2, mean_util=0.9), 116.0)]),
    "hysteresis": (dict(), [
        (dict(replicas=3, mean_util=u), float(i))
        for i, u in enumerate([0.5, 0.7, 0.5, 0.7, 0.5])]),
    "idle_down_one_at_a_time": (dict(scale_down_cooldown_s=60.0), [
        (dict(replicas=3, mean_util=0.1), 0.0),
        (dict(replicas=2, mean_util=0.1), 1.0),
        (dict(replicas=2, mean_util=0.1), 61.0),
        (dict(replicas=1, mean_util=0.1), 122.0)]),
    "down_blocked_by_queue_or_burn": (dict(), [
        (dict(replicas=3, mean_util=0.1, queue_depth=4), 0.0),
        (dict(replicas=3, mean_util=0.1, fast_burn=9.0, slow_burn=9.0),
         1.0)]),
    "clamps": (dict(min_replicas=2, max_replicas=3), [
        (dict(replicas=3, fast_burn=99.0, slow_burn=99.0, mean_util=1.0),
         0.0),
        (dict(replicas=2, mean_util=0.0), 1.0)]),
    "backlog_capacity": (dict(max_replicas=4), [
        (dict(replicas=1, mean_util=0.0, queue_depth=8,
              capacity_tokens=64), 0.0)]),
    "clock_default": (dict(), [(dict(replicas=1), None),
                               (dict(replicas=4, mean_util=0.05), None)]),
}


@pytest.mark.parametrize("table", sorted(DECIDE_TABLES))
def test_decide_tables_match_jax(table):
    cfg, rows = DECIDE_TABLES[table]
    sides = []
    for mod in (tcp, jcp):
        ctrl = mod.FleetController(mod.ControlPlaneConfig(**cfg),
                                   clock=lambda: 42.0)
        out = [vars(ctrl.decide(mod.FleetSignals(**sig), now=now))
               for sig, now in rows]
        sides.append((out, list(ctrl.decisions), ctrl.stats(),
                      ctrl.desired_replicas))
    assert sides[0] == sides[1]


ADMISSION = [
    (dict(), dict(replicas=2, queue_depth=10, tokens_per_sec=100.0), 5.0),
    (dict(), dict(replicas=2, queue_depth=10, tokens_per_sec=100.0), 10.0),
    (dict(), dict(replicas=1, queue_depth=1, tokens_per_sec=100.0), 0.5),
    (dict(hw_flops_per_s=1e6), dict(replicas=1, queue_depth=5,
                                    mean_util=0.5, capacity_tokens=64,
                                    flops_per_token=1000.0), 0.1),
    (dict(hw_flops_per_s=1e6), dict(replicas=1, queue_depth=5,
                                    mean_util=0.0, capacity_tokens=64,
                                    flops_per_token=1000.0), 1.0),
    (dict(), dict(replicas=1, queue_depth=50, tokens_per_sec=10.0), None),
    (dict(), dict(replicas=1, tokens_per_sec=10.0), 0.001),
    (dict(), dict(replicas=1, queue_depth=50), 0.001),
    (dict(admission_slack=2.0), dict(replicas=2, queue_depth=10,
                                     tokens_per_sec=100.0), 4.0),
    (dict(admission_slack=2.0), dict(replicas=2, queue_depth=10,
                                     tokens_per_sec=100.0), 3.0),
    (dict(est_request_tokens=7), dict(replicas=3, queue_depth=3,
                                      mean_util=0.3, capacity_tokens=128,
                                      flops_per_token=3e6), 0.2)]


@pytest.mark.parametrize("i", range(len(ADMISSION)))
def test_admission_math_matches_jax(i):
    cfg, sig, deadline = ADMISSION[i]
    sides = []
    for mod in (tcp, jcp):
        ctrl = mod.FleetController(mod.ControlPlaneConfig(**cfg))
        s = mod.FleetSignals(**sig)
        sides.append((ctrl.predicted_wait_s(s),
                      ctrl.check_admission(s, deadline),
                      ctrl.admission_shed_total))
    assert sides[0] == sides[1]


def test_admission_figures():
    """The JAX tests' figures: 6.4 s of wait, Retry-After 1.4 s, a 1 s
    floor, the census' 0.64 s and 3.2 s."""
    ctrl = FleetController()
    s = FleetSignals(replicas=2, queue_depth=10, tokens_per_sec=100.0)
    assert ctrl.predicted_wait_s(s) == pytest.approx(6.4)
    assert ctrl.check_admission(s, 5.0) == pytest.approx(1.4)
    assert ctrl.check_admission(FleetSignals(
        replicas=1, queue_depth=1, tokens_per_sec=100.0), 0.5) == 1.0
    ctrl = FleetController(ControlPlaneConfig(hw_flops_per_s=1e6))
    for util, wait in ((0.5, 0.64), (0.0, 3.2)):
        assert ctrl.predicted_wait_s(FleetSignals(
            replicas=1, queue_depth=5, mean_util=util, capacity_tokens=64,
            flops_per_token=1000.0)) == pytest.approx(wait)


# -- observe, on routers over engines on the same weights --------------------
def test_observe_matches_jax(models):
    """Two replicas, one request served on each side: the same replica
    count, burns, queue depth and census capacity."""
    prompt = np.arange(1, 7)
    got = {}
    for side, make, Driver, Rtr, Sampling in (
            ("port", port_engine, EngineDriver, Router, SamplingParams),
            ("jax", jax_engine, JaxDriver, JaxRouter, JaxSampling)):
        engines = [make(models) for _ in range(2)]
        r = Rtr([Driver(e, name=f"replica-{i}")
                 for i, e in enumerate(engines)]).start()
        try:
            out = r.submit(prompt, Sampling(max_new_tokens=4)).result()
            mod = tcp if side == "port" else jcp
            s = mod.FleetController().observe(r)
            got[side] = (out.token_ids, s.replicas, s.fast_burn,
                         s.slow_burn, s.queue_depth, s.capacity_tokens)
        finally:
            r.drain(JOIN_S)
    assert got["port"] == got["jax"]


def test_counted_census_captured_once_on_the_pump_thread(models):
    """With PADDLE_TPU_COST_CENSUS=lowered, the census is a forward of the
    step: the driver's pump captures it once, before its first step, and
    `start()` returns after, so the controller's `observe` (on this
    thread, then on a second one) and a read after the pump is joined
    only read it."""
    eng = port_engine(models, cost_census="lowered")
    seen = []
    capture = eng._capture_census

    def spy():
        seen.append(threading.current_thread())
        capture()

    eng._capture_census = spy
    drv = EngineDriver(eng, name="replica-0")
    r = Router([drv]).start()
    try:
        pump = drv._thread
        assert seen == [pump] and eng._census_captures == 1
        s = FleetController().observe(r)
        assert s.capacity_tokens == eng.step_capacity_tokens
        other = threading.Thread(target=lambda: FleetController().observe(r))
        other.start()
        other.join(JOIN_S)
        assert not other.is_alive()
        assert r.submit(np.arange(1, 6), SamplingParams(
            max_new_tokens=3)).result().finish_reason == "length"
        assert seen == [pump] and eng._census_captures == 1
        assert eng.cost_census()["source"] == "lowered"
    finally:
        r.drain(JOIN_S)
    assert not pump.is_alive() and eng.cost_census() is not None
    assert seen == [pump] and eng._census_captures == 1


# -- the live router at run time ---------------------------------------------
def test_add_remove_replica_lifecycle(models):
    d0 = EngineDriver(port_engine(models), name="replica-0")
    r = Router([d0], watchdog_timeout_s=120.0).start()
    try:
        d1 = r.add_replica(port_engine(models))
        assert d1.name == "replica-1" and d1 in r.drivers
        assert d1 in r.watchdog.drivers and "replica-1" in r.breakers
        with pytest.raises(ValueError, match="already used"):
            r.add_replica(driver=EngineDriver(port_engine(models),
                                              name="replica-0"))
        with pytest.raises(ValueError, match="exactly one"):
            r.add_replica()
        removed = r.remove_replica("replica-1", wait=True)
        assert removed is d1 and d1 not in r.drivers
        assert d1 not in r.watchdog.drivers
        assert "replica-1" not in r.breakers
        d2 = r.add_replica(port_engine(models))
        assert d2.name == "replica-2"         # never reused
        with pytest.raises(ValueError, match="no replica named"):
            r.remove_replica("nope")
        r.remove_replica("replica-2", wait=True)
        with pytest.raises(ValueError, match="last live"):
            r.remove_replica("replica-0")
    finally:
        r.drain(JOIN_S)
    with pytest.raises(Exception, match="draining"):
        r.add_replica(port_engine(models))


def test_remove_mid_stream_finishes_with_jax_tokens(models):
    prompt = np.arange(1, 7)
    want = jax_engine(models).generate(
        [prompt], JaxSampling(max_new_tokens=8))[0].token_ids
    r = Router([EngineDriver(port_engine(models), name=f"replica-{i}")
                for i in range(2)]).start()
    try:
        t = r.submit(prompt, SamplingParams(max_new_tokens=8))
        r.remove_replica(t.driver.name, wait=False)
        out = t.result()
        assert out.finish_reason == "length" and out.token_ids == want
        assert len(r.drivers) == 1
    finally:
        r.drain(JOIN_S)


@pytest.mark.parametrize("cap", [0, 2, 16])
def test_dead_tombstone_cap_matches_jax(models, cap):
    """Four of five replicas condemned: the port's fleet view keeps the
    JAX router's replicas, evicts as many and drops their breakers."""
    got = {}
    for side, eng, Driver, Rtr in (
            ("port", port_engine(models), EngineDriver, Router),
            ("jax", jax_engine(models), JaxDriver, JaxRouter)):
        drivers = [Driver(eng, name=f"r{i}") for i in range(5)]
        r = Rtr(drivers, dead_replica_cap=cap)
        for d in drivers[:4]:
            d.condemn()
        snap = r.fleet_snapshot()
        got[side] = ({n: e["dead"] for n, e in snap["replicas"].items()},
                     r.fleet_dead_evicted_total,
                     snap["router"]["fleet_dead_evicted_total"],
                     sorted(r.breakers), sorted(snap["replicas"]["r4"]))
    assert got["port"] == got["jax"]


def test_slo_aware_placement_and_breaker_dominance(models):
    slo_cfg = SLOConfig(min_events=5)
    drivers = [EngineDriver(port_engine(models, slo=slo_cfg),
                            name=f"replica-{i}") for i in range(2)]
    ctrl = FleetController()
    r = Router(drivers, controller=ctrl).start()
    try:
        for _ in range(10):
            drivers[0].engine.slo.on_ttft(5.0)
        assert drivers[0].engine.slo.worst_state() == "page"
        assert r._load_key(drivers[0])[1] == 2
        assert r._load_key(drivers[1])[1] == 0
        t = r.submit(np.arange(1, 5), SamplingParams(max_new_tokens=4))
        assert t.driver is drivers[1]
        assert t.result().finish_reason == "length"
        assert ctrl.placement_avoided_total >= 1
        snap = r.fleet_snapshot()
        assert snap["replicas"]["replica-0"]["placement_avoided"] >= 1
        assert snap["controlplane"]["placement_avoided_total"] >= 1
        r.breakers["replica-1"].trip(time.monotonic())
        assert r._load_key(drivers[0]) < r._load_key(drivers[1])
    finally:
        r.drain(JOIN_S)
    d0 = EngineDriver(port_engine(models, slo=slo_cfg), name="replica-0")
    for _ in range(10):
        d0.engine.slo.on_ttft(5.0)
    assert Router([d0])._load_key(d0)[1] == 0   # controller off: inert


def test_poll_actuates_scale_up_then_down_with_notes(models):
    clk = [0.0]
    e0 = port_engine(models)
    cfg = ControlPlaneConfig(min_replicas=1, max_replicas=3,
                             scale_up_cooldown_s=0.0,
                             scale_down_cooldown_s=0.0)
    ctrl = FleetController(cfg, replica_factory=lambda: port_engine(models),
                           clock=lambda: clk[0])
    r = Router([EngineDriver(e0, name="replica-0")],
               controller=ctrl).start()
    try:
        ctrl.observe = lambda router: FleetSignals(
            replicas=1, fast_burn=9.0, slow_burn=9.0)
        d = ctrl.poll(r)
        assert d.action == "scale_up" and len(r.drivers) == 2
        assert ctrl.scale_up_total == 1
        assert flight_notes(e0, "controlplane:scale_up")
        clk[0] = 100.0
        ctrl.observe = lambda router: FleetSignals(replicas=2,
                                                   mean_util=0.0)
        d = ctrl.poll(r)
        assert d.action == "scale_down" and len(r.drivers) == 1
        st = r.stats()["controlplane"]
        assert (st["scale_up_total"], st["scale_down_total"],
                st["desired_replicas"]) == (1, 1, 1)
    finally:
        r.drain(JOIN_S)
    ctrl = FleetController(clock=lambda: 0.0)
    r = Router([EngineDriver(port_engine(models), name="replica-0")],
               controller=ctrl)
    ctrl.observe = lambda router: FleetSignals(replicas=1, fast_burn=9.0,
                                               slow_burn=9.0)
    assert ctrl.poll(r).action == "scale_up"
    assert len(r.drivers) == 1 and ctrl.scale_up_total == 0


def test_deadline_infeasible_shed_at_submit(models):
    e = port_engine(models)
    ctrl = FleetController()
    r = Router([EngineDriver(e, name="replica-0")], controller=ctrl).start()
    try:
        ctrl.observe = lambda router: FleetSignals(
            replicas=1, queue_depth=50, tokens_per_sec=10.0)
        with pytest.raises(DeadlineInfeasible) as ei:
            r.submit(np.arange(1, 5),
                     SamplingParams(max_new_tokens=4, deadline_s=1.0))
        assert isinstance(ei.value, QueueFull)
        assert ei.value.retry_after_s == pytest.approx(319.0)
        assert ctrl.admission_shed_total == 1
        assert flight_notes(e, "controlplane:shed")
        t = r.submit(np.arange(1, 5), SamplingParams(max_new_tokens=4))
        assert t.result().finish_reason == "length"
    finally:
        r.drain(JOIN_S)


# -- exposition and the serve gate -------------------------------------------
def _series(text):
    return sorted({ln.split("{")[0].split(" ")[0]
                   for ln in text.splitlines()
                   if ln and not ln.startswith("#")})


@pytest.mark.parametrize("with_controller", [True, False])
def test_exposition_series_match_jax(models, with_controller):
    """The router's and the controller's series, rendered from a port
    router's stats, are the JAX render's, with the same values."""
    texts = {}
    for side, eng, Driver, Rtr, mod, render in (
            ("port", port_engine(models), EngineDriver, Router, tcp,
             prometheus_render),
            ("jax", jax_engine(models), JaxDriver, JaxRouter, jcp,
             jax_render)):
        ctrl = None
        if with_controller:
            ctrl = mod.FleetController()
            ctrl.decide(mod.FleetSignals(replicas=2, mean_util=0.9),
                        now=0.0)
            ctrl.on_placement_avoided(3)
        r = Rtr([Driver(eng, name="replica-0")], controller=ctrl)
        texts[side] = render({"replica-0": eng.metrics.snapshot()},
                             router=r.stats())
    assert _series(texts["port"]) == _series(texts["jax"])
    fleet = [ln for ln in texts["port"].splitlines()
             if ln.startswith(("paddle_serving_fleet_", "paddle_serving_scale",
                               "paddle_serving_admission",
                               "paddle_serving_placement"))]
    assert fleet == [ln for ln in texts["jax"].splitlines()
                     if ln.startswith(("paddle_serving_fleet_",
                                       "paddle_serving_scale",
                                       "paddle_serving_admission",
                                       "paddle_serving_placement"))]
    assert ("paddle_serving_fleet_desired_replicas 3" in texts["port"]) \
        == with_controller
    assert ("admission_shed_total" in texts["port"]) == with_controller


def test_serve_gate(models, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_CONTROLPLANE", raising=False)
    server = serve([port_engine(models)])
    try:
        assert server.router.controller is None
    finally:
        server.drain(JOIN_S)
    monkeypatch.setenv("PADDLE_TPU_CONTROLPLANE", "min=2,max=5")
    server = serve([port_engine(models)])
    try:
        ctrl = server.router.controller
        assert isinstance(ctrl, FleetController)
        assert (ctrl.config.min_replicas, ctrl.config.max_replicas) == (2, 5)
    finally:
        server.drain(JOIN_S)
    server = serve([port_engine(models)], controller="off")
    try:
        assert server.router.controller is None
    finally:
        server.drain(JOIN_S)
