"""Speculative decoding in the port's serving engine, against the JAX
package.

The drafter and the gate: `NgramDrafter.propose` and
`resolve_spec_config` give the JAX functions' proposals and error texts
on seeded histories and spellings, and `Scheduler.pack_tokens(
draft_wanted=)` / `pack_draft_seed` the JAX scheduler's grants on seeded
slot maps. Then the engines: small f32 GPT and Llama models (weights
moved across by `convert.py`) serve tests/test_serving_spec.py's mixed
and templated traffic with `spec="ngram:4"` and `spec="model:4"` in the
port and in the JAX engine (built once per module); tokens, the drafted
and accepted counts, each request's `accepted_draft_tokens` and the spec
snapshot keys and Prometheus series are the JAX engine's, and every
token wins its step by more than the logits tolerance. Last the port's
own spec on/off identity in the engine's arms, each run ending with the
page pool and the draft pool quiesced.
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
from paddle_tpu.nlp.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.nlp.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import metrics as jmetrics
from paddle_tpu.serving import request as jrequest
from paddle_tpu.serving import spec as jspec
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM)
from paddle_tpu_torch.serving import (Drafter, ModelDrafter, NgramDrafter,
                                      Request, RequestState, SamplingParams,
                                      Scheduler, ServingEngine, SpecConfig,
                                      make_random_lora, resolve_spec_config)
from paddle_tpu_torch.serving import engine as tengine
from paddle_tpu_torch.serving import metrics as tmetrics

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# tests/test_serving_spec.py's tiny GPT and tests/test_serving.py's Llama
GPT_GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=128)
LLAMA_GEOMETRY = dict(vocab_size=89, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=48, max_position_embeddings=128)
ENGINE = dict(num_slots=3, max_len=64, page_size=8, chunk_len=16)
NEW = 12
JAX_GATES = dict(obs=False, slo=False, cost_census=False)
_GATES = ("PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_PAGED_ATTN", "PADDLE_TPU_GROUPED_ATTN",
          "PADDLE_TPU_KV_DTYPE", "PADDLE_TPU_PREEMPT",
          "PADDLE_TPU_MEGAKERNEL", "PADDLE_TPU_ADAPTERS",
          "PADDLE_TPU_PREFIX_CACHE")
# f32 on both sides; the frameworks sum in different orders. The margin
# every compared token must win by: 10 x 1e-4 on GPT
# (tests/test_torch_serving_defaults.py), 2 x 1e-5 on Llama, whose
# untied head gives small logits (tests/test_torch_llama_serving.py)
MARGIN = {"gpt": 10 * 1e-4, "llama": 2 * 1e-5}
SPEC_KEYS = ("spec", "spec_drafted_tokens", "spec_accepted_tokens",
             "spec_tokens_per_step", "packed_draft_tokens",
             "spec_draft_model", "draft_pool", "unified_steps",
             "packed_tokens_per_step")


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
    """{"gpt": (JAX GPT, port GPT), "llama": (JAX Llama, port Llama)},
    each pair on the same weights; the JAX GPT on its jnp paths (a
    stand-in `disable_x64` that raises if entered)."""
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
        jg = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0,
                                 **GPT_GEOMETRY))
        jg.eval()
        tg = GPTForCausalLM(GPTConfig(**GPT_GEOMETRY), device="cpu")
        tg.load_state_dict(convert.from_paddle_state_dict(
            {k: v.numpy() for k, v in jg.state_dict().items()}))
        tg.eval()
        paddle.seed(11)
        jl = JaxLlama(JaxLlamaConfig(**LLAMA_GEOMETRY))
        jl.eval()
        tl = LlamaForCausalLM(LlamaConfig(**LLAMA_GEOMETRY), device="cpu")
        tl.load_state_dict(convert.from_paddle_state_dict(
            {k: v.numpy() for k, v in jl.state_dict().items()}))
        tl.eval()
        yield {"gpt": (jg, tg), "llama": (jl, tl)}
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def mixed_prompts(rng, vocab, n=6):
    """tests/test_serving_spec.py's mixed-length random prompts."""
    return [rng.randint(0, vocab, size=rng.randint(3, 14)).astype(np.int64)
            for _ in range(n)]


def templated_prompt(rng, vocab, reps=3, tpl_len=6):
    """tests/test_serving_spec.py's code-shaped prompt: a 2-token head
    and a repeated block."""
    head = rng.randint(0, vocab, size=2).astype(np.int64)
    tpl = rng.randint(0, vocab, size=tpl_len).astype(np.int64)
    return np.concatenate([head, np.tile(tpl, reps)])


def traffic(vocab, seed=0):
    """A templated prompt, five mixed ones, another templated one, and
    the first continued by three tokens: it comes last, when the first
    has retired into the prefix cache."""
    rng = np.random.RandomState(seed)
    first = templated_prompt(rng, vocab)
    prompts = [first] + mixed_prompts(rng, vocab, 5) + [
        templated_prompt(rng, vocab)]
    return prompts + [np.concatenate([first, rng.randint(0, vocab,
                                                         size=3)])]


def assert_clear_margins(tm, prompts, outputs, margin):
    """Every emitted token won its step by more than `margin`
    (teacher-forced through the port), so agreement with the JAX engine
    is not luck at a near-tie."""
    for p, toks in zip(prompts, outputs):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int64)])
        with torch.no_grad():
            lg = tm(torch.from_numpy(seq)[None])[0, p.size - 1:].float()
        top2 = torch.topk(lg, 2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min().item() > margin
        assert torch.argmax(lg, dim=-1).tolist() == list(toks)


# -- the drafter and the gate against JAX ------------------------------------
def _histories():
    rs = np.random.RandomState(3)
    out = []
    for _ in range(300):
        n = int(rs.randint(1, 30))
        if rs.rand() < 0.3:
            period = rs.randint(0, 5, size=int(rs.randint(1, 5)))
            h = np.concatenate([rs.randint(0, 9, size=int(rs.randint(0, 6))),
                                np.tile(period, n // period.size + 1)[:n]])
        else:
            h = rs.randint(0, int(rs.choice([3, 5, 50])), size=n)
        k = int(rs.randint(0, 7))
        budget = None if rs.rand() < 0.3 else int(rs.randint(-1, 6))
        ngram = [(3, 1), (2, 2), (4, 1), (1, 1)][int(rs.randint(4))]
        out.append((h.astype(np.int64), k, budget, ngram))
    return out


def test_ngram_proposals_equal_the_jax_drafter():
    for h, k, budget, (hi, lo) in _histories():
        got = NgramDrafter(hi, lo).propose(h, k, budget=budget)
        want = jspec.NgramDrafter(hi, lo).propose(h, k, budget=budget)
        assert got.dtype == np.int64 and np.array_equal(got, want), \
            (h, k, budget, hi, lo)
    assert NgramDrafter().propose(np.array([5, 6, 7, 7, 7]), 4).tolist() \
        == [7, 7, 7, 7]
    assert ModelDrafter().propose(np.array([1, 2, 3]), 4).size == 0
    for bad in (dict(min_ngram=0), dict(max_ngram=1, min_ngram=2)):
        with pytest.raises(ValueError) as got:
            NgramDrafter(**bad)
        with pytest.raises(ValueError) as want:
            jspec.NgramDrafter(**bad)
        assert str(got.value) == str(want.value)


SPELLINGS = ["off", "ngram", "ngram:4", "ngram:8", "model", "model:6",
             "ngram:", "model:", "off:2", "ngram:0", "model:-1",
             "ngram:lots", "beam", "", "tree:3", True, False, 42, 1.5,
             ("ngram",)]


def _resolve(fn, value):
    try:
        cfg = fn(value)
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)
    return None if cfg is None else (cfg.mode, cfg.k)


@pytest.mark.parametrize("value", SPELLINGS, ids=repr)
def test_resolve_spec_config_equals_jax(value):
    assert _resolve(resolve_spec_config, value) \
        == _resolve(jspec.resolve_spec_config, value)


@pytest.mark.parametrize("env", ["ngram:2", "model:3", "off", "medium",
                                 "off:1"])
def test_resolve_spec_config_env_equals_jax(monkeypatch, env):
    monkeypatch.setenv("PADDLE_TPU_SPEC_DECODE", env)
    assert _resolve(lambda v: resolve_spec_config(), None) \
        == _resolve(lambda v: jspec.resolve_spec_config(), None)
    monkeypatch.delenv("PADDLE_TPU_SPEC_DECODE")
    assert resolve_spec_config() is None


def test_spec_config_forms():
    own = SpecConfig(k=2)
    assert resolve_spec_config(own) is own
    cfg = SpecConfig(drafter="model")
    assert cfg.mode == "model" and isinstance(cfg.make_drafter(),
                                              ModelDrafter)
    assert isinstance(SpecConfig().make_drafter(), NgramDrafter)
    for bad, jbad in ((dict(k=0), dict(k=0)),
                      (dict(drafter="tree"), dict(drafter="tree"))):
        with pytest.raises(ValueError) as got:
            SpecConfig(**bad)
        with pytest.raises(ValueError) as want:
            jspec.SpecConfig(**jbad)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="not a serving.spec.Drafter"):
        SpecConfig(drafter=lambda: object()).make_drafter()


def _slot_maps():
    rs = np.random.RandomState(5)
    states = (None, RequestState.DECODE, RequestState.PREFILL)
    for _ in range(60):
        n = int(rs.randint(1, 7))
        slots = [states[int(rs.randint(3))] for _ in range(n)]
        remaining = {s: int(rs.randint(1, 40))
                     for s, st in enumerate(slots)
                     if st is RequestState.PREFILL}
        wanted = {s: int(rs.randint(0, 12)) for s in range(n)
                  if rs.rand() < 0.7}
        yield (slots, remaining, wanted, int(rs.randint(1, 40)),
               int(rs.randint(2, 17)))


def _schedulers(slots):
    port, ref = Scheduler(len(slots)), JaxScheduler(len(slots))
    for i, st in enumerate(slots):
        if st is None:
            continue
        for sched, req_cls, sp in ((port, Request, SamplingParams()),
                                   (ref, jrequest.Request, JaxSampling())):
            r = req_cls(f"r{i}", np.array([1, 2]), sp)
            r.state = getattr(jrequest.RequestState, st.name) \
                if req_cls is jrequest.Request else st
            r.slot = i
            sched.running[i] = r
    return port, ref


def test_pack_tokens_and_draft_seed_equal_the_jax_scheduler():
    for slots, remaining, wanted, budget, width in _slot_maps():
        port, ref = _schedulers(slots)
        got = port.pack_tokens(budget, width, remaining,
                               draft_wanted=wanted)
        want = ref.pack_tokens(budget, width, remaining,
                               draft_wanted=wanted)
        assert got == want, (slots, remaining, wanted, budget, width)
        # without draft_wanted: the two-tuple of the spec-off engine
        assert port.pack_tokens(budget, width, remaining) == want[:2]
        spare = budget - len(got[0]) - sum(got[1].values()) \
            - sum(got[2].values())
        lag = {s: n for s, n in wanted.items() if n}
        assert port.pack_draft_seed(spare, width, lag) \
            == ref.pack_draft_seed(spare, width, lag)


# -- the engines against JAX -------------------------------------------------
def _jax_run(jm, spec, prompts):
    eng = JaxEngine(jm, spec=spec, **ENGINE, **JAX_GATES)
    res = eng.generate(prompts, JaxSampling(max_new_tokens=NEW))
    snap = eng.metrics.snapshot()
    eng.drain()
    return ([list(r.token_ids) for r in res],
            [r.accepted_draft_tokens for r in res], snap)


@pytest.fixture(scope="module")
def jax_runs(models):
    return {(name, spec): _jax_run(models[name][0], spec,
                                   traffic(GPT_GEOMETRY["vocab_size"]
                                           if name == "gpt" else
                                           LLAMA_GEOMETRY["vocab_size"]))
            for name in ("gpt", "llama") for spec in ("ngram:4", "model:4")}


def _spec_lines(snap):
    text = tmetrics.prometheus_render({"r0": snap})
    return [ln for ln in text.splitlines()
            if "_spec_" in ln or "draft_pool" in ln]


@pytest.mark.parametrize("name", ["gpt", "llama"])
@pytest.mark.parametrize("spec", ["ngram:4", "model:4"])
def test_spec_engine_matches_the_jax_engine(models, jax_runs, name, spec):
    tm = models[name][1]
    prompts = traffic(tm.config.vocab_size)
    eng = ServingEngine(tm, device="cpu", spec=spec, **ENGINE)
    assert eng.spec.mode == spec.split(":")[0] and eng.spec.k == 4
    res = eng.generate(prompts, SamplingParams(max_new_tokens=NEW))
    tokens = [list(r.token_ids) for r in res]
    want_tokens, want_accepted, want_snap = jax_runs[name, spec]
    assert tokens == want_tokens
    assert_clear_margins(tm, prompts, tokens, MARGIN[name])
    assert [r.accepted_draft_tokens for r in res] == want_accepted
    snap = eng.metrics.snapshot()
    for key in SPEC_KEYS:
        assert snap[key] == want_snap[key], key
    assert snap["spec_drafted_tokens"] > 0
    assert sum(want_accepted) == snap["spec_accepted_tokens"]
    assert _spec_lines(snap) == [
        ln for ln in jmetrics.prometheus_render(
            {"r0": want_snap}).splitlines()
        if "_spec_" in ln or "draft_pool" in ln]
    state = eng.debug_state()
    assert state["config"]["spec"] == spec.split(":")[0]
    assert state["config"]["spec_draft_model"] is (spec == "model:4")
    eng.drain()
    assert not eng._drafters


# -- the port's spec on/off identity in the engine's arms ---------------------
class _Bursts(ServingEngine):
    """Notes, for every burst, how many tokens its verify row could emit
    (1 + accepted drafts) and how many it emitted."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.bursts = []

    def _emit_tokens(self, slots, nxt, finished, accept=None, drafts=None):
        before = {s: len(r.output_tokens)
                  for s, r in self.scheduler.running.items()}
        running = dict(self.scheduler.running)
        super()._emit_tokens(slots, nxt, finished, accept, drafts)
        for s in slots:
            req = running.get(int(s))
            if req is None or int(s) not in before:
                continue
            m = 0 if drafts is None else len(drafts.get(s, ()))
            planned = 1 + (min(int(accept[s]), m) if m else 0)
            self.bursts.append((req.request_id, planned,
                                len(req.output_tokens) - before[int(s)]))


def _eos_traffic(model, spec):
    """Prompts and an EOS token that ends a request inside a burst of
    its `spec` run. Per traffic seed: a spec run without EOS gives each
    request's bursts; the tokens first emitted inside a burst, not at
    its end, are tried first, then the run's other tokens (an EOS that
    retires a request early changes the other rows' bursts), and the
    first whose EOS run cuts a burst short is taken."""
    for seed in range(8):
        prompts = traffic(model.config.vocab_size, seed=seed)
        eng = _Bursts(model, device="cpu", spec=spec, **ENGINE)
        out = {r.request_id: r.token_ids for r in eng.generate(
            prompts, SamplingParams(max_new_tokens=NEW))}
        eng.drain()
        done, candidates = {}, []
        for rid, planned, emitted in eng.bursts:
            at = done.get(rid, 0)
            for i in range(at + 1, at + planned - 1):
                if out[rid][i] not in out[rid][:i]:
                    candidates.append(out[rid][i])
            done[rid] = at + emitted
        candidates += [t for r in out.values() for t in r]
        for eos in dict.fromkeys(candidates):
            eng = _Bursts(model, device="cpu", spec=spec, **ENGINE)
            eng.generate(prompts, SamplingParams(max_new_tokens=NEW,
                                                 eos_token_id=eos))
            eng.drain()
            if any(emitted < planned for _, planned, emitted in eng.bursts):
                return prompts, eos
    raise AssertionError("no EOS ends a burst short")


def _sampling(arm, n, eos=None):
    if arm == "sampled":
        return [SamplingParams(max_new_tokens=NEW, top_k=5, temperature=0.8)
                if i % 3 == 2 else SamplingParams(max_new_tokens=NEW)
                for i in range(n)]
    if arm == "preempt":
        # the first three less important than the rest
        return [SamplingParams(max_new_tokens=NEW, priority=int(i < 3))
                for i in range(n)]
    if arm == "adapters":
        return [SamplingParams(max_new_tokens=NEW, adapter_id=(i % 3))
                for i in range(n)]
    return [SamplingParams(max_new_tokens=NEW, eos_token_id=eos)] * n


# arm -> engine options: the defaults, grouped=False, the quantized pools
# with the prefix cache, the megakernel (spec_verify_accept), adapters in
# a mixed batch, preemption under page pressure (8 pages: later, more
# important requests preempt residents; prefix cache on), a tight token
# budget, EOS mid-burst and sampled neighbours
ARMS = {"defaults": {}, "grouped_off": dict(grouped=False),
        "int8": dict(kv_dtype="int8", prefix_cache=True),
        "fp8": dict(kv_dtype="fp8", prefix_cache=True),
        "megakernel": dict(megakernel=True),
        "adapters": dict(adapters=True, adapter_pages=2, grouped=False),
        "preempt": dict(num_pages=9),
        "token_budget": dict(token_budget=5),
        "eos": {}, "sampled": {}}


def _serve_arm(model, arm, spec, prompts, eos, monkeypatch):
    calls = []
    real = tengine.spec_verify_accept
    monkeypatch.setattr(tengine, "spec_verify_accept", lambda *a: (
        calls.append(1), real(*a))[1])
    eng = _Bursts(model, device="cpu", spec=spec, seed=3,
                  **{**ENGINE, **ARMS[arm]})
    if eng.adapters is not None:
        for i in range(2):
            eng.adapters.register(f"t{i}", make_random_lora(
                2, 32, 32, 32, rank=4, rng=np.random.RandomState(9 + i),
                amp=0.2))
    sps = _sampling(arm, len(prompts), eos)
    if arm == "preempt":
        first = [eng.add_request(p, sp) for p, sp in zip(prompts[:3],
                                                         sps[:3])]
        eng.step()
        eng.step()
        rest = [eng.add_request(p, sp) for p, sp in zip(prompts[3:],
                                                        sps[3:])]
        eng.run()
        res = [r.output() for r in first + rest]
    else:
        res = eng.generate(prompts, sps)
    snap = eng.metrics.snapshot()
    eng.drain()
    eng.pool.assert_quiesced()
    if eng._draft is not None:
        eng._draft.assert_quiesced()
    return eng, res, snap, len(calls)


# the spec-off runs, one an arm (and EOS token), shared by both tiers
_SPEC_OFF = {}


@pytest.mark.parametrize("spec", ["ngram:4", "model:4"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_spec_on_gives_the_spec_off_tokens(models, monkeypatch, arm, spec):
    model = models["gpt"][1]
    prompts, eos = ((traffic(model.config.vocab_size), None)
                    if arm != "eos" else _eos_traffic(model, spec))
    key = (arm, eos)
    if key not in _SPEC_OFF:
        _SPEC_OFF[key] = _serve_arm(model, arm, None, prompts, eos,
                                    monkeypatch)
    off, off_res, off_snap, _ = _SPEC_OFF[key]
    on, on_res, snap, verify_calls = _serve_arm(model, arm, spec, prompts,
                                                eos, monkeypatch)
    greedy = [i for i in range(len(on_res))
              if arm != "sampled" or i % 3 != 2]
    assert [on_res[i].token_ids for i in greedy] \
        == [off_res[i].token_ids for i in greedy]
    assert [r.finish_reason for r in on_res] \
        == [r.finish_reason for r in off_res]
    assert snap["spec_drafted_tokens"] > 0
    assert snap["spec_accepted_tokens"] > 0
    assert sum(r.accepted_draft_tokens for r in on_res) \
        == snap["spec_accepted_tokens"]
    assert snap["packed_draft_tokens"] == snap["spec_drafted_tokens"]
    assert off_snap["spec_drafted_tokens"] == 0
    assert snap["unified_steps"] < off_snap["unified_steps"]
    assert verify_calls == (snap["unified_steps"] if on.megakernel else 0)
    if arm == "sampled":
        assert all(on_res[i].accepted_draft_tokens == 0
                   for i in range(len(on_res)) if i not in greedy)
    if arm == "preempt":
        assert snap["preemptions"] >= 1 and off_snap["preemptions"] >= 1
    if arm == "token_budget":
        assert snap["packed_tokens_per_step"]["max"] <= 5
    if arm == "eos":
        assert "stop" in {r.finish_reason for r in on_res}
        assert any(emitted < planned for _, planned, emitted in on.bursts)
    if arm in ("int8", "fp8", "preempt"):
        assert snap["prefix"]["hits"] >= 1


def test_spec_refuses_the_legacy_step(models):
    with pytest.raises(ValueError) as got:
        ServingEngine(models["gpt"][1], device="cpu", spec="ngram",
                      unified=False, **ENGINE)
    with pytest.raises(ValueError) as want:
        JaxEngine(models["gpt"][0], spec="ngram", unified=False, **ENGINE,
                  **JAX_GATES)
    assert str(got.value) == str(want.value)


def test_two_argument_drafter_and_greedy_only(models):
    """A Drafter whose propose takes no budget still drafts (the engine
    falls back to the two-argument call); only greedy requests get a
    drafter, and every drafter goes at retirement."""

    class Legacy(Drafter):
        def propose(self, history, k):
            return NgramDrafter().propose(history, k)

    tm = models["gpt"][1]
    prompts = traffic(tm.config.vocab_size)[-2:]
    eng = ServingEngine(tm, device="cpu",
                        spec=SpecConfig(k=4, drafter=Legacy), **ENGINE)
    g = eng.add_request(prompts[0], SamplingParams(max_new_tokens=NEW))
    s = eng.add_request(prompts[1], SamplingParams(max_new_tokens=NEW,
                                                   top_k=5))
    eng.step()
    assert isinstance(eng._drafters[g.request_id], Legacy)
    assert s.request_id not in eng._drafters
    eng.run()
    assert eng._drafters == {}
    assert g.accepted_draft_tokens > 0 and s.accepted_draft_tokens == 0
    ref = ServingEngine(tm, device="cpu", **ENGINE).generate(
        prompts[:1], SamplingParams(max_new_tokens=NEW))
    assert g.output_tokens == ref[0].token_ids
    eng.drain()
