"""The serving engine's gates and arguments, resolved as the JAX engine
resolves them.

`ServingEngine` reads the JAX engine's gates at construction: the
ported ones (prefix cache, megakernel, adapters, speculative decoding,
grammar, obs, the SLO tracker, the cost census, the mesh) resolve for real —
`prefix_cache="off"` or PADDLE_TPU_PREFIX_CACHE=off builds no cache,
`spec="ngram"` or PADDLE_TPU_SPEC_DECODE=ngram a spec engine,
`grammar=True` or PADDLE_TPU_GRAMMAR=on an engine that takes constrained
requests (and the legacy step refuses it), obs, SLO and the "model"
census are on by default and their keywords and variables give the modes
the JAX resolvers give, and `mesh="dp1mp2"` or PADDLE_TPU_MESH=dp1mp2
builds a tensor-parallel engine of the JAX resolver's shape over virtual
CPU shards (PADDLE_TPU_FORCE_CPU_DEVICES). A spelling the JAX
resolver refuses raises ValueError here too. `chunk_len` below
`MIN_CHUNK` (8) raises on both steps, as in the JAX engine.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import adapters as jadapters
from paddle_tpu.serving import grammar as jgrammar
from paddle_tpu.serving import obs as jobs
from paddle_tpu.serving import prefix as jprefix
from paddle_tpu.serving import slo as jslo
from paddle_tpu.serving import spec as jspec
from paddle_tpu.serving import tp as jtp
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import (ServingEngine, SpecConfig,
                                      resolve_adapters_flag,
                                      resolve_prefix_cache_flag)

SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, max_position_embeddings=64)
ENGINE = dict(device="cpu", max_len=32, page_size=8, chunk_len=8)
GATES = ("PADDLE_TPU_MESH", "PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_GRAMMAR",
         "PADDLE_TPU_MEGAKERNEL", "PADDLE_TPU_ADAPTERS",
         "PADDLE_TPU_PREFIX_CACHE", "PADDLE_TPU_OBS", "PADDLE_TPU_SLO",
         "PADDLE_TPU_COST_CENSUS", "PADDLE_TPU_UNIFIED_STEP",
         "PADDLE_TPU_PAGED_ATTN")


@pytest.fixture
def clean_env(monkeypatch):
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    # the port's virtual CPU devices for a mesh, as many as the JAX
    # package's (tests/conftest.py: 8)
    monkeypatch.setenv("PADDLE_TPU_FORCE_CPU_DEVICES", "8")
    return monkeypatch


def _assert_jax_mesh(eng, override=None):
    """A mesh engine's shape is the JAX resolver's for the same input;
    its megakernel is off (the JAX rule) and it serves."""
    want = jtp.resolve_serving_mesh(override)
    assert eng.tp.shape == want.shape
    assert (eng.dp, eng.mp) == (want.dp, want.mp)
    assert eng.metrics.snapshot()["mesh"] == want.shape
    assert not eng.megakernel
    out = eng.generate([np.arange(1, 12)])
    assert len(out[0].token_ids) == 16


@pytest.fixture(scope="module")
def model():
    return GPTForCausalLM(GPTConfig(**SMALL), device="cpu")


def _layer_modes(eng):
    """(obs on, SLO config or None, census mode) of an engine."""
    return (eng.obs is not None,
            None if eng.slo is None else vars(eng.slo.config),
            eng.census_mode)


def _jax_layer_modes(obs=None, slo=None, cost_census=None):
    cfg = jslo.resolve_slo_config(slo)
    return (jobs.resolve_obs_flag(obs), None if cfg is None else vars(cfg),
            jslo.resolve_cost_census(cost_census))


def test_roadmap_input_raises(clean_env, model):
    """ROADMAP queue 3's F1 input: spec decode on by its env var builds
    the spec engine the JAX engine builds, with the megakernel and no
    prefix cache; the mesh gate beside it builds a mesh spec engine of
    the JAX resolver's shape (its megakernel off), the grammar gate
    builds an engine whose `grammar` tag is on, and obs, SLO and the
    census build with the JAX resolvers' modes."""
    clean_env.setenv("PADDLE_TPU_SPEC_DECODE", "ngram")
    clean_env.setenv("PADDLE_TPU_MEGAKERNEL", "on")
    clean_env.setenv("PADDLE_TPU_PREFIX_CACHE", "off")
    eng = ServingEngine(model, **ENGINE)
    assert eng.spec.mode == "ngram" and eng.spec.k == 4
    assert eng.megakernel and eng.prefix_cache is None
    assert eng.metrics.snapshot()["spec"] == "ngram"
    assert _layer_modes(eng) == _jax_layer_modes()
    for env, value in (("PADDLE_TPU_MESH", "dp1mp2"),
                       ("PADDLE_TPU_GRAMMAR", "on"),
                       ("PADDLE_TPU_OBS", "on"), ("PADDLE_TPU_SLO", "on"),
                       ("PADDLE_TPU_COST_CENSUS", "model")):
        clean_env.setenv(env, value)
        if env == "PADDLE_TPU_MESH":
            eng = ServingEngine(model, **ENGINE)
            assert eng.spec.mode == "ngram"
            _assert_jax_mesh(eng)
        elif env == "PADDLE_TPU_GRAMMAR":
            eng = ServingEngine(model, **ENGINE)
            assert eng.grammar_on is jgrammar.resolve_grammar_flag() is True
            assert eng.metrics.snapshot()["grammar"] is True
        else:
            assert _layer_modes(ServingEngine(model, **ENGINE)) == \
                _jax_layer_modes()
        clean_env.delenv(env)
    clean_env.delenv("PADDLE_TPU_SPEC_DECODE")
    eng = ServingEngine(model, **ENGINE)
    assert eng.spec is None
    assert eng.megakernel and eng.prefix_cache is None


@pytest.mark.parametrize("value,want", [
    (None, True), (True, True), (False, False), ("on", True), ("off", False),
    ("1", True), ("0", False), ("true", True), ("no", False)])
def test_prefix_cache_keyword(clean_env, model, value, want):
    assert resolve_prefix_cache_flag(value) is want
    assert jprefix.resolve_prefix_cache_flag(value) is want
    eng = ServingEngine(model, prefix_cache=value, **ENGINE)
    assert (eng.prefix_cache is not None) is want


@pytest.mark.parametrize("env,want", [("off", False), ("on", True),
                                      ("false", False), ("yes", True)])
def test_prefix_cache_env(clean_env, model, env, want):
    clean_env.setenv("PADDLE_TPU_PREFIX_CACHE", env)
    assert jprefix.resolve_prefix_cache_flag() is want
    eng = ServingEngine(model, **ENGINE)
    assert (eng.prefix_cache is not None) is want


# gate env var -> (spellings that turn it on, spellings it accepts as off,
# spellings its JAX resolver refuses, the JAX resolver). Every gate is
# ported: its "on" spellings build an engine with the JAX resolver's mode
UNPORTED = {
    "PADDLE_TPU_MESH": (["dp1mp2", "dp2xmp1"], ["off", ""], ["tp4", "dp0mp2"],
                        lambda: jtp.resolve_serving_mesh()),
    "PADDLE_TPU_SPEC_DECODE": (["ngram", "ngram:4", "model"], ["off"],
                               ["ngram:", "off:2", "beam", "ngram:0"],
                               lambda: jspec.resolve_spec_config()),
    "PADDLE_TPU_GRAMMAR": (["on", "1"], ["off", "no"], ["json"],
                           lambda: jgrammar.resolve_grammar_flag()),
    "PADDLE_TPU_OBS": (["on"], ["off"], ["yes"],
                       lambda: jobs.resolve_obs_flag()),
    "PADDLE_TPU_SLO": (["on", "ttft_p99=0.25,fast=30"], ["off"],
                       ["ttft=1", "fast"], lambda: jslo.resolve_slo_config()),
    "PADDLE_TPU_COST_CENSUS": (["model", "xla"], ["off"], ["hlo"],
                               lambda: jslo.resolve_cost_census()),
}


# the ported observability gates -> their place in `_layer_modes`
_LAYERS = {"PADDLE_TPU_OBS": 0, "PADDLE_TPU_SLO": 1,
           "PADDLE_TPU_COST_CENSUS": 2}


@pytest.mark.parametrize("env", list(UNPORTED))
def test_unported_gates_raise_when_their_env_turns_them_on(clean_env, model,
                                                           env):
    on, off, bad, jax_resolve = UNPORTED[env]
    for v in on:
        clean_env.setenv(env, v)
        if env == "PADDLE_TPU_SPEC_DECODE":
            want = jax_resolve()
            eng = ServingEngine(model, **ENGINE)
            assert (eng.spec.mode, eng.spec.k) == (want.mode, want.k)
            continue
        if env in _LAYERS:
            eng = ServingEngine(model, **ENGINE)
            assert _layer_modes(eng) == _jax_layer_modes()
            assert _layer_modes(eng)[_LAYERS[env]] not in (False, None,
                                                             "off")
            continue
        if env == "PADDLE_TPU_GRAMMAR":
            eng = ServingEngine(model, **ENGINE)
            assert eng.grammar_on is jax_resolve() is True
            assert eng.debug_state()["config"]["grammar"] is True
            continue
        _assert_jax_mesh(ServingEngine(model, **ENGINE))
    for v in off:
        clean_env.setenv(env, v)
        eng = ServingEngine(model, **ENGINE)
        assert getattr(eng, "spec", None) is None
        if env in _LAYERS:
            assert _layer_modes(eng) == _jax_layer_modes()
            assert _layer_modes(eng)[_LAYERS[env]] in (False, None, "off")
        assert eng.grammar_on is False
        assert eng.tp is None and eng.metrics.snapshot()["mesh"] is None
    for v in bad:
        clean_env.setenv(env, v)
        with pytest.raises(ValueError):
            jax_resolve()
        with pytest.raises(ValueError):
            ServingEngine(model, **ENGINE)


@pytest.mark.parametrize("option,value", [
    ("mesh", "dp1mp2"), ("mesh", (1, 2)), ("grammar", True),
    ("grammar", "on"), ("obs", True), ("slo", True), ("slo", "on"),
    ("cost_census", "model")])
def test_unported_keywords_raise(clean_env, model, option, value):
    """mesh builds a mesh engine of the JAX resolver's shape; grammar
    builds an engine with its tag on, which the legacy step refuses with
    the JAX text; obs, slo and cost_census build the JAX resolvers' modes
    and serve."""
    if option == "mesh":
        _assert_jax_mesh(ServingEngine(model, **{option: value}, **ENGINE),
                         value)
        return
    if option == "grammar":
        eng = ServingEngine(model, **{option: value}, **ENGINE)
        assert eng.grammar_on is jgrammar.resolve_grammar_flag(value)
        assert eng.metrics.grammar is True
        assert eng.debug_state()["config"]["grammar"] is True
        out = eng.generate([np.arange(1, 12)])
        assert len(out[0].token_ids) == 16
        eng.drain()
        with pytest.raises(ValueError, match="unified ragged step"):
            ServingEngine(model, **{option: value}, unified=False,
                          **ENGINE)
        return
    eng = ServingEngine(model, **{option: value}, **ENGINE)
    assert _layer_modes(eng) == _jax_layer_modes(**{option: value})
    out = eng.generate([np.arange(1, 12)])
    assert len(out[0].token_ids) == 16
    snap = eng.metrics.snapshot()
    assert (snap["slo"] is not None) is (eng.slo is not None)
    assert snap["cost_census"]["source"] == "model"
    assert eng.obs.flight.steps_recorded > 0
    eng.drain()


@pytest.mark.parametrize("value,mode,k", [
    ("ngram", "ngram", 4), (True, "ngram", 4), ("ngram:2", "ngram", 2),
    ("model", "model", 4), ("model:3", "model", 3),
    (SpecConfig(k=5), "ngram", 5)])
def test_spec_keyword_builds_a_spec_engine(clean_env, model, value, mode,
                                           k):
    """spec= builds the engine the JAX resolver describes and serves; the
    model tier makes the half-depth draft model resident."""
    eng = ServingEngine(model, spec=value, **ENGINE)
    assert (eng.spec.mode, eng.spec.k) == (mode, k)
    assert eng.metrics.spec == mode
    assert (eng._draft is not None) is (mode == "model")
    assert eng.debug_state()["config"]["spec_draft_model"] is (mode ==
                                                                "model")
    out = eng.generate([np.arange(1, 12)])
    assert len(out[0].token_ids) == 16
    eng.drain()
    with pytest.raises(ValueError, match="unified ragged step"):
        ServingEngine(model, spec=value, unified=False, **ENGINE)


@pytest.mark.parametrize("option,value", [
    ("mesh", False), ("spec", False), ("spec", "off"), ("grammar", False),
    ("grammar", "off"), ("obs", False), ("slo", False), ("slo", "off"),
    ("cost_census", False), ("cost_census", "off")])
def test_unported_keywords_off_build(clean_env, model, option, value):
    ServingEngine(model, **{option: value}, **ENGINE)


def test_megakernel_gate_and_its_silent_downgrade(clean_env, model):
    """On only for the unified kernel step (the JAX rule); the env var's
    spellings and refusals are the JAX resolver's."""
    for v in ("on", "1", "true", "yes", "off", "0", "false", "no"):
        clean_env.setenv("PADDLE_TPU_MEGAKERNEL", v)
        want = v in ("on", "1", "true", "yes")
        assert tpa.resolve_megakernel_flag() is jpa.resolve_megakernel_flag()
        assert ServingEngine(model, **ENGINE).megakernel is want
    clean_env.setenv("PADDLE_TPU_MEGAKERNEL", "sideways")
    with pytest.raises(ValueError):
        jpa.resolve_megakernel_flag()
    with pytest.raises(ValueError):
        ServingEngine(model, **ENGINE)
    clean_env.delenv("PADDLE_TPU_MEGAKERNEL")
    assert not ServingEngine(model, **ENGINE).megakernel
    assert ServingEngine(model, megakernel=True, **ENGINE).megakernel
    assert not ServingEngine(model, megakernel=True, unified=False,
                             **ENGINE).megakernel
    assert not ServingEngine(model, megakernel=True, attn_impl="gather",
                             **ENGINE).megakernel


def test_adapters_gate(clean_env, model):
    """PADDLE_TPU_ADAPTERS builds the adapter pool; the legacy step
    refuses adapters; an unknown spelling raises as in JAX."""
    assert ServingEngine(model, **ENGINE).adapters is None
    clean_env.setenv("PADDLE_TPU_ADAPTERS", "on")
    assert resolve_adapters_flag() is jadapters.resolve_adapters_flag()
    eng = ServingEngine(model, adapter_pages=3, adapter_ranks=(4,), **ENGINE)
    assert eng.adapters.num_pages == 4 and eng.adapters.rank == 4
    with pytest.raises(ValueError, match="unified"):
        ServingEngine(model, unified=False, **ENGINE)
    clean_env.setenv("PADDLE_TPU_ADAPTERS", "maybe")
    with pytest.raises(ValueError):
        jadapters.resolve_adapters_flag()
    with pytest.raises(ValueError):
        ServingEngine(model, **ENGINE)


@pytest.mark.parametrize("unified", [True, False])
def test_chunk_len_floor_is_min_chunk(clean_env, model, unified):
    """ROADMAP queue 3's F2 input: chunk_len 4 raises on both steps."""
    for chunk in (1, 4, 7):
        with pytest.raises(ValueError, match="chunk_len must be >= 8"):
            ServingEngine(model, **{**ENGINE, "chunk_len": chunk},
                          unified=unified)
    eng = ServingEngine(model, unified=unified, **ENGINE)
    assert eng.chunk_len == ServingEngine.MIN_CHUNK == 8
    out = eng.generate([np.arange(1, 12)])
    assert len(out[0].token_ids) == 16
