"""The request tracer, the flight recorder and the profiler of the port,
against the JAX package.

Units first: the tracer and the flight recorder fed the same records give
the same timelines, eviction, rings, incidents and stats as the JAX
classes, the env knobs resolve as the JAX resolvers do, a timeline's
Chrome export and `profiler.chrome_trace` equal the JAX ones on the same
records, and `profiler.Profiler` keeps the JAX scheduler's windows.

Then the engines: the port's and the JAX `ServingEngine` at their
defaults (obs, the SLO tracker and the "model" cost census on;
`grouped=False`, which grouping would not change) serve the same traffic
on the same f32 weights under one manual clock that only the test moves:
the unified step with a priority-0 arrival that preempts a resident
(preempt, swap_in) and the legacy step. Every request's timeline equals
the JAX engine's (event kinds, order, step, slot, pages, cause; times
excluded), the flight records carry the JAX keys and values (but `t` and
`step_wall_ms`), the metrics snapshot's live `slo` and `cost_census`
(but the JAX engine's count of traced dispatches) and `debug_state()`
equal the JAX engine's, and `prometheus_render` gives the JAX text line
for line. Tokens are the same with the layers on or off, and
`scripts/flight_dump.py` renders the port's flight snapshot.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as jprofiler
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu.serving import obs as jobs
from paddle_tpu_torch import convert
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import SamplingParams, ServingEngine
from paddle_tpu_torch.serving import metrics as tmetrics
from paddle_tpu_torch.serving import obs as tobs

REPO = Path(__file__).resolve().parents[1]
_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=128)
ARMS = {"unified": dict(num_slots=2, max_len=64, page_size=8, chunk_len=8,
                        grouped=False),
        "legacy": dict(num_slots=3, max_len=64, page_size=8, chunk_len=8,
                       unified=False)}
# the JAX engine's census key for its traced dispatches (an eager step has
# no trace) and its gauge
JAX_ONLY_CENSUS = ("unified_dispatch",)
JAX_ONLY_SERIES = ("_unified_dispatch_ops",)
# host wall time (perf_counter, not the test's clock): a swap-in's copies
HOST_TIME_SERIES = ("_swap_in_seconds",)
_GATES = ("PADDLE_TPU_OBS", "PADDLE_TPU_SLO", "PADDLE_TPU_COST_CENSUS",
          "PADDLE_TPU_FLIGHT_STEPS", "PADDLE_TPU_DEBUG",
          "PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_PREEMPT", "PADDLE_TPU_MEGAKERNEL",
          "PADDLE_TPU_ADAPTERS", "PADDLE_TPU_PREFIX_CACHE",
          "PADDLE_TPU_PAGED_ATTN")


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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (tiny engines beside
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_env(monkeypatch):
    for g in _GATES:
        monkeypatch.delenv(g, raising=False)
    return monkeypatch


# -- units -------------------------------------------------------------------
def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name,env,override", [
    ("obs", None, None), ("obs", "off", None), ("obs", "yes", None),
    ("obs", "off", True), ("debug", None, None), ("debug", "on", None),
    ("debug", "1", None), ("flight", None, None), ("flight", "16", None),
    ("flight", "0", None), ("flight", "x", None), ("flight", None, 3)])
def test_env_knobs_resolve_as_in_jax(clean_env, name, env, override):
    var, fn = {"obs": ("PADDLE_TPU_OBS", "resolve_obs_flag"),
               "debug": ("PADDLE_TPU_DEBUG", "resolve_debug_flag"),
               "flight": ("PADDLE_TPU_FLIGHT_STEPS",
                          "resolve_flight_steps")}[name]
    if env is not None:
        clean_env.setenv(var, env)
    assert _outcome(getattr(tobs, fn), override) == \
        _outcome(getattr(jobs, fn), override)


def _events(seed, n=400):
    rs = np.random.RandomState(seed)
    kinds = ["submit", "admit", "prefill_chunk", "decode", "first_token",
             "preempt", "swap_in", "finish", "poison", "deadline"]
    return [(f"req-{rs.randint(14)}", kinds[rs.randint(len(kinds))],
             float(i) * 0.5, int(rs.randint(50)), int(rs.randint(8)))
            for i in range(n)]


def test_tracer_matches_jax_and_stays_bounded():
    port = tobs.RequestTracer(max_requests=12, max_events=9)
    ref = jobs.RequestTracer(max_requests=12, max_events=9)
    for rid, kind, t, step, slot in _events(1):
        for tr in (port, ref):
            tr.record(rid, kind, t=t, step=step, slot=slot,
                      cause=None if kind != "preempt" else "overload",
                      pages=slot + 1)
    for i in range(12):          # one timeline past max_events
        for tr in (port, ref):
            tr.record("req-long", "decode", t=300.0 + i, step=i)
    assert port.request_ids() == ref.request_ids()
    assert len(port.request_ids()) == 12
    for rid in ref.request_ids():
        assert port.timeline(rid) == ref.timeline(rid)
    assert port.stats() == ref.stats()
    assert port.stats()["timelines_evicted"] > 0
    assert any("dropped" in e for rid in port.request_ids()
               for e in port.timeline(rid))
    assert port.timeline("nobody") is None
    assert tobs.TERMINAL_EVENTS == jobs.TERMINAL_EVENTS


def test_flight_ring_is_bounded_and_an_incident_freezes_it():
    clocks = [Clock(), Clock()]
    port = tobs.FlightRecorder(steps=5, clock=clocks[0])
    ref = jobs.FlightRecorder(steps=5, clock=clocks[1])
    for i in range(23):
        for fr, c in zip((port, ref), clocks):
            c.t += 1.0
            fr.on_step({"step": i, "decode_tokens": i % 3})
            if i % 4 == 0:
                fr.note("fault:kill", f"at {i}")
            if i in (7, 15, 16, 17, 18, 19, 20, 21, 22):
                fr.incident("step_fault", detail=f"e{i}", step=i,
                            slo={"worst": "ok"} if i == 7 else None)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert len(snap["steps"]) == 5 and snap["steps_recorded"] == 23
    assert len(snap["incidents"]) == tobs.FlightRecorder.MAX_INCIDENTS
    assert snap["incidents_total"] == 9
    # a dump is frozen: later steps do not reach it
    assert snap["incidents"][0]["steps"][-1]["step"] == 15
    eo, ej = tobs.EngineObs(flight_steps=4), jobs.EngineObs(flight_steps=4)
    assert eo.stats() == ej.stats()
    eo.flight.on_step({"step": 1})
    eo.reset()
    assert eo.stats() == ej.stats()


def test_timeline_chrome_export_equals_jax():
    rs = np.random.RandomState(4)
    kinds = ["submit", "admit", "prefill_chunk", "decode", "first_token",
             "preempt", "swap_in", "decode", "finish"]
    tl = []
    t = 10.0
    for k in kinds:
        t += float(rs.uniform(0.001, 0.2))
        ev = {"t": t, "kind": k, "step": int(rs.randint(9))}
        if rs.rand() < 0.5:
            ev["replica"] = "replica-1"
        tl.append(ev)
    assert tobs.timeline_to_chrome(tl, "req-3") == \
        jobs.timeline_to_chrome(tl, "req-3")
    spans = [("a", 1, 5_000, 9_000), ("b", 2, 1_000, 1_000)]
    assert tprofiler.chrome_trace(spans, pid=7) == \
        jprofiler.chrome_trace(spans, pid=7)
    assert tprofiler.chrome_trace([]) == jprofiler.chrome_trace([])


def test_profiler_windows_and_record_events(tmp_path):
    """The scheduler's states equal the JAX one's; RecordEvent spans land
    in the recording windows only, as context managers (which also enter
    torch's record_function) and through begin()/end(); export writes the
    chrome trace."""
    for kw in (dict(closed=1, ready=1, record=2, repeat=2),
               dict(closed=0, ready=0, record=3, skip_first=2)):
        t, j = tprofiler.make_scheduler(**kw), jprofiler.make_scheduler(**kw)
        assert [t(i).name for i in range(14)] == \
            [j(i).name for i in range(14)]
    windows = []
    prof = tprofiler.Profiler(targets=[tprofiler.ProfilerTarget.CPU],
                              scheduler=(1, 3),
                              on_trace_ready=lambda p: windows.append(
                                  [e[0] for e in p._events]))
    with prof:
        for i in range(5):
            with tprofiler.RecordEvent(f"step{i}"):
                torch.ones(2).sum()
            span = tprofiler.RecordEvent(f"req{i}")
            span.begin()
            span.end()
            prof.step()
    assert windows == [["step1", "req1", "step2", "req2"]]
    assert set(prof.aggregate()) == {"step1", "req1", "step2", "req2"}
    path = prof.export(str(tmp_path / "t.json"))
    trace = tprofiler.load_profiler_result(path)
    assert [e["name"] for e in trace["traceEvents"]] == windows[0]
    assert "Calls" in prof.summary()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as tp:
        with tprofiler.RecordEvent("serving::probe"):
            torch.ones(3).sum()
    assert "serving::probe" in {e.key for e in tp.key_averages()}


# -- the engines against JAX --------------------------------------------------
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


def _drive(eng, sampling, clock):
    """Four low-priority requests, then after 3 steps a priority-0 one
    (on the 2-slot unified engine it preempts a resident, which resumes
    through swap-in); the clock moves 10 ms a step. Returns (tokens,
    debug state after 4 steps)."""
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 97, size=n).astype(np.int64)
               for n in (5, 19, 9, 12, 7)]
    reqs = [eng.add_request(p, sampling(6, 3)) for p in prompts[:4]]
    state, steps = None, 0
    while eng.has_work:
        clock.t += 0.01
        if steps == 3:
            reqs.append(eng.add_request(prompts[4], sampling(5, 0)))
        eng.step()
        steps += 1
        if steps == 4:
            state = eng.debug_state()
    return [list(r.output_tokens) for r in reqs], state


def _record(eng, clock, sampling):
    tokens, state = _drive(eng, sampling, clock)
    m = eng.metrics
    out = dict(tokens=tokens, state=state, snap=m.snapshot(),
               timelines={rid: eng.obs.tracer.timeline(rid)
                          for rid in eng.obs.tracer.request_ids()},
               flight=eng.obs.flight.snapshot(),
               final_state=eng.debug_state())
    out["text"] = (jmetrics if isinstance(eng, JaxEngine)
                   else tmetrics).prometheus_render({"r0": out["snap"]})
    eng.drain()
    return out


@pytest.fixture(scope="module")
def runs(models):
    jm, tm = models
    out = {}
    for arm, kw in ARMS.items():
        clock = Clock()
        out["jax", arm] = _record(
            JaxEngine(jm, clock=clock, **kw), clock,
            lambda n, p: JaxSampling(max_new_tokens=n, priority=p))
        clock = Clock()
        eng = ServingEngine(tm, device="cpu", clock=clock, **kw)
        out["port", arm] = _record(
            eng, clock, lambda n, p: SamplingParams(max_new_tokens=n,
                                                    priority=p))
    return out


def _no_times(events):
    return [{k: v for k, v in e.items() if k not in ("t", "step_wall_ms")}
            for e in events]


def _no_jax_only(census):
    return None if census is None else {
        k: v for k, v in census.items() if k not in JAX_ONLY_CENSUS}


@pytest.mark.parametrize("arm", list(ARMS))
def test_timelines_match_the_jax_engine(runs, arm):
    got, want = runs["port", arm], runs["jax", arm]
    assert got["tokens"] == want["tokens"]
    assert set(got["timelines"]) == set(want["timelines"])
    for rid, tl in want["timelines"].items():
        assert _no_times(got["timelines"][rid]) == _no_times(tl), rid
    kinds = {e["kind"] for tl in got["timelines"].values() for e in tl}
    assert kinds >= {"submit", "admit", "prefill_chunk", "decode",
                     "first_token", "finish"}
    if arm == "unified":
        assert kinds >= {"preempt", "swap_in"}


@pytest.mark.parametrize("arm", list(ARMS))
def test_flight_records_match_the_jax_engine(runs, arm):
    got, want = runs["port", arm]["flight"], runs["jax", arm]["flight"]
    assert got["steps_recorded"] == want["steps_recorded"] > 5
    assert got["capacity"] == want["capacity"] == 1024
    for g, w in zip(got["steps"], want["steps"]):
        assert set(g) == set(w)
        assert _no_times([g]) == _no_times([w])
    assert got["incidents"] == want["incidents"] == []
    # the last record agrees with the metrics snapshot
    snap, last = runs["port", arm]["snap"], got["steps"][-1]
    assert last["queue_depth"] == snap["queue_depth"]
    assert last["pages_used"] == snap["pool"]["pages_used"]


@pytest.mark.parametrize("arm", list(ARMS))
def test_snapshot_state_and_text_with_the_layers_live(runs, arm):
    got, want = runs["port", arm], runs["jax", arm]
    snap, wsnap = got["snap"], want["snap"]
    assert snap["slo"] == wsnap["slo"] and snap["slo"]["events_total"] > 0
    assert _no_jax_only(snap["cost_census"]) == \
        _no_jax_only(wsnap["cost_census"])
    assert snap["cost_census"]["source"] == "model"
    assert snap["requests"] == wsnap["requests"]
    for key in ("ttft_s", "inter_token_s", "by_priority", "achieved_util",
                "preemptions", "swapped_in_pages", "deadline_goodput"):
        assert snap[key] == wsnap[key], key
    for s, w in ((got["state"], want["state"]),
                 (got["final_state"], want["final_state"])):
        s = {**s, "cost_census": _no_jax_only(s["cost_census"])}
        w = {**w, "cost_census": _no_jax_only(w["cost_census"])}
        assert s == w
    assert got["state"]["obs"]["tracer"]["events_recorded"] > 0

    def lines(text):
        return [ln for ln in text.splitlines()
                if not any(k in ln for k in JAX_ONLY_SERIES
                           + HOST_TIME_SERIES)]

    assert lines(got["text"]) == lines(want["text"])
    assert "paddle_serving_slo_state" in got["text"]
    assert "paddle_serving_cost_census_flops" in got["text"]


def test_layers_change_no_token_and_knobs_gate_them(models, clean_env):
    tm = models[1]
    kw = dict(device="cpu", **ARMS["unified"])
    prompts = [np.arange(3, 3 + n) for n in (5, 11, 7)]
    on = ServingEngine(tm, **kw)
    off = ServingEngine(tm, obs=False, slo=False, cost_census=False, **kw)
    assert off.obs is None and off.slo is None and off.census_mode == "off"
    t_on = [list(r.token_ids) for r in on.generate(prompts)]
    assert t_on == [list(r.token_ids) for r in off.generate(prompts)]
    assert off.debug_state()["obs"] is None
    assert off.metrics.snapshot()["slo"] is None
    clean_env.setenv("PADDLE_TPU_OBS", "off")
    assert ServingEngine(tm, **kw).obs is None
    clean_env.setenv("PADDLE_TPU_OBS", "on")
    clean_env.setenv("PADDLE_TPU_FLIGHT_STEPS", "3")
    eng = ServingEngine(tm, **kw)
    eng.generate(prompts)
    snap = eng.obs.flight.snapshot()
    assert snap["capacity"] == 3 and len(snap["steps"]) == 3
    assert snap["steps_recorded"] > 3
    assert ServingEngine(tm, flight_steps=2, **kw).obs.flight.capacity == 2
    clean_env.setenv("PADDLE_TPU_FLIGHT_STEPS", "0")
    with pytest.raises(ValueError):
        ServingEngine(tm, **kw)


def test_flight_dump_renders_the_port_snapshot(runs):
    spec = importlib.util.spec_from_file_location(
        "flight_dump", REPO / "scripts" / "flight_dump.py")
    fd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fd)
    snap = runs["port", "unified"]["flight"]
    text = fd.render({"replica-0": snap, "replica-1": None})
    assert "== replica-0:" in text and "observability off" in text
    assert len(text.splitlines()) == snap["steps_recorded"] + 4
    # every column but the step wall time (host time) is the JAX text's
    cut = [[ln.split()[:-1] for ln in fd.render(f).splitlines()[2:]]
           for f in (snap, runs["jax", "unified"]["flight"])]
    assert cut[0] == cut[1]
    header = fd.render(snap).splitlines()[1].split()
    assert header[:3] == ["step", "queue", "res"] and "util" in header
