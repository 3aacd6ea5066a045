"""The multi-replica router (`serving/http/router.py`) of the port, against
the JAX package's.

Units: the circuit breaker's transitions on a fake clock and the
heartbeat watchdog's scan over fake drivers give the JAX package's
states, counters and verdicts. Routers over engines on the same f32
weights (the JAX GPT and its port): a replica killed mid-stream leaves
the client the JAX router's tokens under the same kill (equal to the
JAX engine's uninterrupted run), with the same attempts, migrations and
usage, with the prefix cache on and off, under page pressure and over
two kills; the first failover attempt sleeps no backoff; a cancel racing
a re-placement cancels the new attempt; the migration cap and a fleet
with no survivor end the stream typed; a hang is condemned by the
watchdog and its stream migrates; the breaker takes a flapping replica
out of rotation and readmits it; a constrained stream migrates with
`grammar_prefix` bumped and keeps the JAX engine's tokens. The KV fabric:
the disaggregated hand-off (bf16 and int8 pools) gives the JAX router's
tokens, hand-offs and pages moved; a short prompt skips it; affinity
ranks the warm replica first; a removed replica's tree restores warm
into the next one added. Every wait is bounded and every router drained.
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
from paddle_tpu.serving import FabricConfig as JaxFabricConfig
from paddle_tpu.serving import FaultInjector as JaxInjector
from paddle_tpu.serving import GrammarSpec as JaxGrammarSpec
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.http import router as jrouter
from paddle_tpu.serving.http import EngineDriver as JaxDriver
from paddle_tpu.serving.http import ReplicaHung as JaxReplicaHung
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (FabricConfig, FaultInjector,
                                      GrammarSpec, SamplingParams,
                                      ServingEngine)
from paddle_tpu_torch.serving.http import (CircuitBreaker, EngineDriver,
                                           ReplicaDead, ReplicaHung,
                                           ReplicaWatchdog, Router)
from paddle_tpu_torch.serving.http import router as trouter

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=128)
ENGINE = dict(num_slots=2, max_len=64, grouped=False)
FABRIC_ENGINE = dict(num_slots=4, max_len=64, page_size=4, chunk_len=16,
                     prefix_cache=True, grouped=False)
PROMPT = [int(t) for t in np.random.default_rng(0).integers(1, 96, size=13)]
_GATES = ("PADDLE_TPU_OBS", "PADDLE_TPU_SLO", "PADDLE_TPU_FAULTS",
          "PADDLE_TPU_COST_CENSUS", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_PREFIX_CACHE",
          "PADDLE_TPU_CONTROLPLANE", "PADDLE_TPU_KV_FABRIC",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_GRAMMAR", "PADDLE_TPU_PREEMPT")
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


SIDES = {"port": (EngineDriver, trouter.Router, SamplingParams,
                  FaultInjector, FabricConfig),
         "jax": (JaxDriver, jrouter.Router, JaxSampling, JaxInjector,
                 JaxFabricConfig)}


def make_engine(models, side, **kw):
    if side == "port":
        return ServingEngine(models[1], device="cpu", **{**ENGINE, **kw})
    return JaxEngine(models[0], **{**ENGINE, **kw})


def cluster(models, side, n=2, *, faults=None, names=None, router_kw=None,
            **engine_kw):
    Driver, Rtr = SIDES[side][:2]
    engines = [make_engine(models, side, **engine_kw) for _ in range(n)]
    names = names or [f"replica-{i}" for i in range(n)]
    drivers = [Driver(e, name=nm, faults=faults)
               for e, nm in zip(engines, names)]
    return engines, drivers, Rtr(drivers, **(router_kw or {})).start()


def solo(models, prompt, n, **kw):
    """The JAX engine's uninterrupted greedy run of one prompt."""
    eng = make_engine(models, "jax", **kw)
    return eng.generate([np.asarray(prompt)],
                        JaxSampling(max_new_tokens=n))[0].token_ids


def wait_until(pred, timeout=JOIN_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def consume(ticket, on_token=None, poll_s=0.01):
    """Drain a ticket: (tokens, done reason or None, error or None)."""
    tokens = []
    for kind, val in ticket.events(poll_s=poll_s):
        if kind == "token":
            tokens.append(val)
            if on_token is not None:
                on_token(tokens)
        elif kind == "done":
            return tokens, val, None
        elif kind == "error":
            return tokens, None, val
    return tokens, None, None


def usage(out):
    return (out.token_ids, out.finish_reason, out.migrations,
            out.prompt_token_ids, out.preemptions)


# -- units ---------------------------------------------------------------------
BREAKER_SCRIPTS = {
    "opens_after_threshold": (3, 10.0, [
        ("allow", 0.0), ("fail", 1.0), ("fail", 2.0), ("state", 2.0),
        ("fail", 3.0), ("state", 3.0), ("allow", 3.0)]),
    "success_resets": (2, 10.0, [
        ("fail", 1.0), ("ok", 2.0), ("fail", 3.0), ("state", 3.0)]),
    "half_open_probe": (1, 5.0, [
        ("fail", 0.0), ("allow", 4.9), ("allow", 5.0), ("state", 5.0),
        ("fail", 6.0), ("state", 6.0), ("allow", 10.9), ("allow", 11.0),
        ("ok", 11.5), ("state", 12.0), ("trip", 13.0), ("state", 13.0)]),
    "trip_twice_and_recover": (4, 1.0, [
        ("trip", 0.0), ("trip", 0.5), ("state", 0.9), ("state", 1.5),
        ("fail", 1.6), ("state", 1.6), ("allow", 2.6), ("ok", 2.7),
        ("fail", 2.8), ("state", 2.8)]),
}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_matches_jax(script):
    threshold, open_s, ops = BREAKER_SCRIPTS[script]
    trace = {}
    for side, cls in (("port", CircuitBreaker),
                      ("jax", jrouter.CircuitBreaker)):
        b = cls(failure_threshold=threshold, open_s=open_s)
        out = []
        for op, t in ops:
            if op == "allow":
                out.append(b.allow(t))
            elif op == "state":
                out.append(b.state(t))
            else:
                {"fail": b.record_failure, "ok": b.record_success,
                 "trip": b.trip}[op](t)
            out.append((b.failures_total, b.opens_total))
        trace[side] = out
    assert trace["port"] == trace["jax"]
    assert CircuitBreaker.STATE_CODES == jrouter.CircuitBreaker.STATE_CODES
    assert CircuitBreaker.PLACEMENT_RANK == \
        jrouter.CircuitBreaker.PLACEMENT_RANK
    with pytest.raises(ValueError, match="failure_threshold"):
        CircuitBreaker(failure_threshold=0)


class _FakeDriver:
    def __init__(self, name, beat, started=True, dead=False,
                 draining=False, grace=0.0):
        self.name, self.last_beat = name, beat
        self.started, self.dead, self.draining = started, dead, draining
        self.watchdog_grace_s = grace
        self.condemned_with = None

    def condemn(self, exc=None):
        self.condemned_with = exc
        self.dead = True


def test_watchdog_matches_jax():
    """Only a started, live, undrained replica whose beat is older than
    the timeout plus its grace is condemned, typed ReplicaHung, with the
    JAX watchdog's message."""
    runs = {}
    for side, cls, hung in (("port", ReplicaWatchdog, ReplicaHung),
                            ("jax", jrouter.ReplicaWatchdog,
                             JaxReplicaHung)):
        t = [100.0]
        fleet = [_FakeDriver("fresh", 99.8), _FakeDriver("stale", 90.0),
                 _FakeDriver("unborn", None),
                 _FakeDriver("unstarted", 1.0, started=False),
                 _FakeDriver("dead", 1.0, dead=True),
                 _FakeDriver("draining", 1.0, draining=True),
                 _FakeDriver("graced", 98.5, grace=1.0)]
        kills = []
        wd = cls(fleet, timeout_s=1.0, clock=lambda: t[0],
                 on_kill=lambda d: kills.append(d.name))
        first = [d.name for d in wd.poll()]
        assert all(isinstance(d.condemned_with, hung)
                   for d in fleet if d.condemned_with is not None)
        t[0] = 102.0
        second = [d.name for d in wd.poll()]
        runs[side] = (first, second, kills, wd.kills_total,
                      [str(d.condemned_with) for d in fleet])
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == ["stale"]
    assert runs["port"][1] == ["fresh", "graced"]


# -- failover and migration, against the JAX router ----------------------------
def _kill_at(driver_of, marks):
    killed = []

    def hook(tokens):
        n = len(tokens)
        if n in marks and n not in killed:
            killed.append(n)
            driver_of().kill()
    return hook


@pytest.mark.parametrize("case", ["prefix_cache", "no_prefix_cache",
                                  "page_pressure", "double_kill"])
def test_midstream_kill_matches_jax_router(models, case):
    """The serving replica dies after a few tokens (twice over three
    replicas in `double_kill`): the port's client gets the JAX router's
    tokens, attempts, migrations and usage under the same schedule, and
    both equal the JAX engine's uninterrupted run."""
    prompt, n_new, n, marks, kw = {
        "prefix_cache": ([3, 14, 15, 9], 24, 2, (3,), {}),
        "no_prefix_cache": ([26, 5, 35], 20, 2, (2,),
                            dict(prefix_cache=False)),
        "page_pressure": ([3, 14, 15, 9, 26, 5], 40, 2, (4,),
                          dict(page_size=8, num_pages=17)),
        "double_kill": ([7, 8, 9, 10], 30, 3, (3, 12), {}),
    }[case]
    got = {}
    for side in ("port", "jax"):
        Sampling = SIDES[side][2]
        engines, drivers, r = cluster(models, side, n, **kw)
        try:
            if case == "page_pressure":
                # finished requests park pages the migration must evict
                for p in ([5, 6, 7, 8], [9, 10, 11], [12, 13]):
                    drivers[1].submit(np.array(p, np.int64),
                                      Sampling(max_new_tokens=8))
                assert wait_until(lambda: engines[1].pool.cached_pages > 0)
            t = r.submit(np.array(prompt, np.int64),
                         Sampling(max_new_tokens=n_new))
            toks, done, err = consume(
                t, on_token=_kill_at(lambda: t.driver, marks))
            got[side] = (toks, done, err, t.attempts, t.migrations,
                         usage(t.output()), r.migrations_total,
                         r.retries_total)
        finally:
            r.drain(JOIN_S)
        for e, d in zip(engines, drivers):
            if not d.dead:
                e.pool.assert_quiesced()
    assert got["port"] == got["jax"]
    assert got["port"][0] == solo(models, prompt, n_new, **kw)
    assert got["port"][4] == len(marks)


def test_first_failover_attempt_sleeps_no_backoff(models):
    jitter_calls = []

    def jitter():
        jitter_calls.append(1)
        return 1.0

    engines, drivers, r = cluster(models, "port", 2, router_kw=dict(
        backoff_base_s=0.05, jitter=jitter))
    try:
        t = r.submit(np.array([3, 14, 15], np.int64),
                     SamplingParams(max_new_tokens=30))
        victim = t.driver
        assert wait_until(lambda: len(t.request.output_tokens) > 0)
        victim.kill()
        toks, done, err = consume(t)
        assert done == "length" and err is None
        assert jitter_calls == []
        assert t.attempts == 2 and t.migrations == 1
        assert toks == solo(models, [3, 14, 15], 30)
    finally:
        r.drain(JOIN_S)


def test_cancel_racing_retry_cancels_the_new_attempt(models):
    engines, drivers, r = cluster(models, "port", 2)
    try:
        t = r.submit(np.array([3, 14, 15, 9], np.int64),
                     SamplingParams(max_new_tokens=60))
        first = t.request
        assert wait_until(lambda: len(first.output_tokens) > 2)
        t._cancelled = True
        t._failover(first)
        new_req = t.request
        assert new_req is not first
        # `finished` turns true when cancel() marks a resident, before the
        # step boundary retires it: wait for the retirement itself
        assert new_req.wait(JOIN_S)
        assert new_req.finish_reason == "cancelled"
    finally:
        r.drain(JOIN_S)
    for e in engines:
        e.pool.assert_quiesced()


def test_migration_cap_and_no_survivor(models):
    """`max_migrations=0`: the started stream closes as replica_failure
    with a typed ReplicaDead naming the cap; a one-replica fleet closes
    it the same way with nothing to migrate to."""
    engines, drivers, r = cluster(models, "port", 2, router_kw=dict(
        max_migrations=0))
    try:
        t = r.submit(np.array([3, 14, 15], np.int64),
                     SamplingParams(max_new_tokens=40))
        assert wait_until(lambda: len(t.request.output_tokens) > 1)
        t.driver.kill()
        toks, done, err = consume(t)
        assert done == "replica_failure" and len(toks) >= 1
        assert isinstance(t.error, ReplicaDead)
        assert "migration cap" in str(t.error) and t.migrations == 0
    finally:
        r.drain(JOIN_S)
    engines, drivers, r = cluster(models, "port", 1, router_kw=dict(
        max_retries=2, backoff_base_s=0.0))
    try:
        t = r.submit(np.array([3, 14, 15], np.int64),
                     SamplingParams(max_new_tokens=40))
        assert wait_until(lambda: len(t.request.output_tokens) > 1)
        drivers[0].kill()
        toks, done, err = consume(t)
        assert done == "replica_failure" and len(toks) >= 1
        assert t.error is not None and t.migrations == 0
        assert t.output().token_ids == toks
    finally:
        r.drain(JOIN_S)


def test_hung_replica_condemned_and_stream_migrates(models):
    inj = FaultInjector()
    engines, drivers, r = cluster(models, "port", 2, faults=inj,
                                  router_kw=dict(watchdog_timeout_s=0.4,
                                                 watchdog_interval_s=0.1,
                                                 breaker_open_s=600.0))
    prompt = [3, 14, 15, 9]
    hung = []
    try:
        t = r.submit(np.array(prompt, np.int64),
                     SamplingParams(max_new_tokens=25))
        victim = t.driver

        def hang_at_3(tokens):
            if len(tokens) == 3 and not hung:
                hung.append(1)
                inj.hang_at_step(victim.name, 0, 60.0)

        toks, done, err = consume(t, on_token=hang_at_3)
        assert err is None and done == "length"
        assert toks == solo(models, prompt, 25) and t.migrations == 1
        assert r.watchdog_kills_total == 1
        assert victim.dead and isinstance(victim.death_exc, ReplicaHung)
        assert r.breakers[victim.name].state(time.monotonic()) == "open"
    finally:
        inj.release_hangs()
        r.drain(JOIN_S)


def test_breaker_takes_flapping_replica_out_of_rotation(models):
    """The contract of tests/test_serving_faults.py:433 (red on the JAX
    side at take-up, on the jax 0.9 `disable_x64` break): injected
    admission failures on replica-0 open its breaker after three in a
    row; every request is served on replica-1 without a failed submit
    after that; past `breaker_open_s` the half-open probe readmits
    replica-0 and a success closes its breaker."""
    inj = FaultInjector()
    for k in range(1, 4):
        inj.fail_add_request(k, replica="replica-0")
    engines, drivers, r = cluster(models, "port", 2, faults=inj,
                                  router_kw=dict(breaker_failures=3,
                                                 breaker_open_s=0.2))
    try:
        outs = []
        for i in range(5):
            t = r.submit(np.array([3 + i, 14, 15], np.int64),
                         SamplingParams(max_new_tokens=2))
            toks, done, err = consume(t)
            assert done == "length" and err is None
            outs.append(t.driver.name)
        assert inj.add_fails_fired == 3
        assert r.breakers["replica-0"].opens_total >= 1
        assert all(n == "replica-1" for n in outs)
        time.sleep(0.25)
        t = r.submit(np.array([40, 41, 42], np.int64),
                     SamplingParams(max_new_tokens=2))
        assert consume(t)[1] == "length"
        assert wait_until(lambda: r.breakers["replica-0"].state(
            time.monotonic()) == "closed", timeout=5)
    finally:
        r.drain(JOIN_S)


def test_constrained_stream_migrates_with_grammar_prefix(models):
    """A regex-constrained stream killed after 3 tokens re-places with
    `grammar_prefix` bumped by the banked tokens (grammar output riding
    as prompt) and ends with the JAX engine's uninterrupted tokens."""
    eos, pattern, prompt, n_new = 0, "[A-C]+", [3, 14, 15, 9], 12
    want = make_engine(models, "jax", grammar=True).generate(
        [np.asarray(prompt)], JaxSampling(
            max_new_tokens=n_new, eos_token_id=eos,
            grammar=JaxGrammarSpec(kind="regex", pattern=pattern))
    )[0].token_ids
    engines, drivers, r = cluster(models, "port", 2, grammar=True)
    try:
        sp = SamplingParams(max_new_tokens=n_new, eos_token_id=eos,
                            grammar=GrammarSpec(kind="regex",
                                                pattern=pattern))
        t = r.submit(np.array(prompt, np.int64), sp)
        toks, done, err = consume(t, on_token=_kill_at(lambda: t.driver,
                                                       (3,)))
        assert err is None and t.migrations == 1
        assert toks == want and done == t.output().finish_reason
        banked = len(t._history)
        assert banked >= 3 and t.request.sampling.grammar_prefix == banked
        assert t.request.sampling.max_new_tokens == n_new - banked
        assert sp.grammar_prefix == 0
    finally:
        r.drain(JOIN_S)


# -- the KV fabric -------------------------------------------------------------
def fabric_cluster(models, side, names, fabric, **kw):
    return cluster(models, side, len(names), names=names,
                   router_kw=dict(fabric=fabric),
                   **{**FABRIC_ENGINE, **kw})


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_disaggregated_handoff_matches_jax_router(models, kv_dtype):
    """A 13-token prompt (3 full pages of 4) prefills on the prefill
    specialist, its pages move as a frame and the decode specialist
    continues: one stream, with the JAX router's tokens, hand-offs and
    pages moved, equal to the JAX engine's uninterrupted run."""
    kw = {} if kv_dtype is None else dict(kv_dtype=kv_dtype)
    got = {}
    for side in ("port", "jax"):
        Sampling, Fabric = SIDES[side][2], SIDES[side][4]
        engines, drivers, r = fabric_cluster(
            models, side, ["pre0", "dec0"], Fabric(
                handoff_min_pages=2,
                roles={"pre0": "prefill", "dec0": "decode"}), **kw)
        try:
            t = r.submit(PROMPT, Sampling(max_new_tokens=8))
            toks = [v for k, v in t.events() if k == "token"]
            fab = r.stats()["fabric"]
            got[side] = (toks, t.error, fab["handoffs_total"],
                         fab["pages_moved_total"],
                         fab["transfer_failures_total"],
                         engines[1].prefix_cache.stats()["hits"] >= 1,
                         t.output().cached_tokens, t.attempts)
            assert [e for e in engines[0].obs.flight.snapshot()["steps"]
                    if e.get("note") == "fabric:plan"]
        finally:
            r.drain(JOIN_S)
    assert got["port"] == got["jax"]
    assert got["port"][0] == solo(models, PROMPT, 8, **{**FABRIC_ENGINE,
                                                        **kw})
    assert got["port"][2:5] == (1, 3, 0)


def test_short_prompt_skips_handoff(models):
    engines, drivers, r = fabric_cluster(
        models, "port", ["pre0", "dec0"], FabricConfig(
            handoff_min_pages=8,
            roles={"pre0": "prefill", "dec0": "decode"}))
    try:
        t = r.submit(PROMPT, SamplingParams(max_new_tokens=4))
        toks = [v for k, v in t.events() if k == "token"]
        assert toks == solo(models, PROMPT, 4, **FABRIC_ENGINE)
        assert r.stats()["fabric"]["handoffs_total"] == 0
    finally:
        r.drain(JOIN_S)


def test_affinity_ranks_warm_replica_first(models):
    """Only the second replica holds the prompt's pages: placement picks
    it over the equally idle first, which load order alone would pick."""
    e1 = make_engine(models, "port", **FABRIC_ENGINE)
    e2 = make_engine(models, "port", **FABRIC_ENGINE)
    e2.generate([np.asarray(PROMPT)], SamplingParams(max_new_tokens=2))
    r = Router([EngineDriver(e1, name="r0"), EngineDriver(e2, name="r1")],
               fabric=FabricConfig()).start()
    try:
        r.refresh_fabric_summaries()
        assert len(r._fabric_fps["r1"]) >= 2
        t = r.submit(PROMPT, SamplingParams(max_new_tokens=2))
        toks = [v for k, v in t.events() if k == "token"]
        assert t.driver.name == "r1"
        assert toks == solo(models, PROMPT, 2, **FABRIC_ENGINE)
        assert t.output().cached_tokens == 12
    finally:
        r.drain(JOIN_S)


def test_warm_restart_matches_jax(models):
    """`remove_replica` drops every per-name structure of the removed
    replica and stashes its tree; `add_replica` restores it (the JAX
    router's page count) and the next request on the prompt is served
    with 12 cached tokens, the JAX tokens."""
    got = {}
    for side in ("port", "jax"):
        Sampling, Fabric = SIDES[side][2], SIDES[side][4]
        engines, drivers, r = fabric_cluster(models, side, ["r0", "r1"],
                                             Fabric())
        try:
            t = r.submit(PROMPT, Sampling(max_new_tokens=2))
            list(t.events())
            victim = t.driver.name
            for _ in range(8):
                r._breaker_for(victim).record_failure(r._clock())
            r._avoided_by[victim] = 3
            r.remove_replica(victim, wait=True)
            assert victim not in r.breakers
            assert victim not in r._avoided_by
            assert victim not in r._fabric_fps
            assert r._fabric_snapshot and r._fabric_snapshot["nodes"]
            d3 = r.add_replica(make_engine(models, side, **FABRIC_ENGINE))
            tree = d3.engine.prefix_cache.stats()["tree_pages"]
            restored = d3.engine.metrics.fabric_restored_pages
            # the restored replica serves the prompt: stop the other one
            other = next(d for d in r.drivers if d is not d3)
            r.remove_replica(other.name, wait=True)
            t2 = r.submit(PROMPT, Sampling(max_new_tokens=4))
            toks = [v for k, v in t2.events() if k == "token"]
            got[side] = (tree, restored, toks, t2.driver is d3,
                         t2.output().cached_tokens,
                         len(r._fabric_snapshot["nodes"]))
        finally:
            r.drain(JOIN_S)
    assert got["port"] == got["jax"]
    assert got["port"][0] >= 2 and got["port"][1] > 0
    assert got["port"][3] and got["port"][4] == 12


def test_fabric_off_and_fleet_snapshot(models):
    engines, drivers, r = cluster(models, "port", 1, **FABRIC_ENGINE)
    try:
        assert r.fabric is None and r.stats()["fabric"] is None
        t = r.submit(PROMPT, SamplingParams(max_new_tokens=4))
        toks = [v for k, v in t.events() if k == "token"]
        assert toks == solo(models, PROMPT, 4, **FABRIC_ENGINE)
    finally:
        r.drain(JOIN_S)
    engines, drivers, r = fabric_cluster(models, "port", ["r0"],
                                         FabricConfig())
    try:
        list(r.submit(PROMPT, SamplingParams(max_new_tokens=2)).events())
        entry = r.fleet_snapshot()["replicas"]["r0"]
        assert entry["prefix"]["tree_pages"] >= 2
        assert set(entry["fabric"]) == {"pages_sent", "bytes_sent",
                                        "pages_recv", "bytes_recv",
                                        "restored_pages"}
        assert entry["cost_census"]["source"] == "model"
    finally:
        r.drain(JOIN_S)
