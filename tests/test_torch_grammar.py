"""Grammar-constrained decoding in the port's serving engine, against the
JAX package.

The machines first: `serving.grammar`'s allow-masks, budget masks and
accepting flags equal the JAX package's along seeded random walks, for
every machine, on the byte vocabulary and on a token table with
multi-character and empty tokens (the port lifts by character class, the
JAX package token by token); the spec's and the gate's errors are the
JAX texts, and so are the engine's `_grammar_bias` rows. Then the
engines: a tiny f32 GPT (weights moved across by `convert.py`, the JAX
GPT on its jnp paths) serves constrained and unconstrained requests in
the defaults, megakernel, `ngram:4` and `model:4` arms, through a
preemption and with `grammar_prefix`, in the port and in the JAX engine;
tokens, finish reasons and the grammar counters are the JAX engine's,
and every constrained token wins among the tokens its grammar allows by
more than the logits tolerance. Last the port's own identities: the gate
on with no constrained request is the gate off, token for token.
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
from paddle_tpu.serving import grammar as jgrammar
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (GrammarSpec, SamplingParams,
                                      ServingEngine, resolve_grammar_flag)
from paddle_tpu_torch.serving import grammar as tgrammar

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
# tests/test_serving_grammar.py's tiny GPT: the chr-identity vocabulary
# 0..96 (uppercase, digits, punctuation), chr(96) = '`' the EOS
V, EOS = 97, 96
GPT_GEOMETRY = dict(vocab_size=V, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=128)
ENGINE = dict(num_slots=3, max_len=64, page_size=8, chunk_len=16)
NEW = 12
JAX_GATES = dict(obs=False, slo=False, cost_census=False)
_GATES = ("PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_PAGED_ATTN", "PADDLE_TPU_GROUPED_ATTN",
          "PADDLE_TPU_KV_DTYPE", "PADDLE_TPU_PREEMPT",
          "PADDLE_TPU_MEGAKERNEL", "PADDLE_TPU_ADAPTERS",
          "PADDLE_TPU_PREFIX_CACHE", "PADDLE_TPU_GRAMMAR")
# f32 on both sides, summed in different orders: the margin every
# compared token must win by (tests/test_torch_serving_defaults.py's)
MARGIN = 10 * 1e-4
GRAMMAR_KEYS = ("grammar", "grammar_requests", "grammar_masked_steps",
                "grammar_masked_rows", "grammar_rejected_drafts")
SPECS = [dict(kind="choice", choices=("YES", "NO", "MAYBE")),
         dict(kind="regex", pattern="[A-C]+(-[0-9][0-9]?)?"),
         dict(kind="json_object"),
         dict(kind="regex", pattern="(AB|C)*D?[^Q]\\w\\s.")]


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its engines step tiny
    tensors op by op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX GPT, port GPT) on the same weights; the JAX GPT on its jnp
    paths (a stand-in `disable_x64` that raises if entered)."""
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
        yield jg, tg
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def text_of(tokens):
    return "".join(chr(t) for t in tokens if t != EOS)


# -- the machines against JAX ------------------------------------------------
def _tables():
    byte = tgrammar.default_token_strings(V)
    rich = tuple(chr(i) for i in range(V - 6)) + (
        "AB", "", '"}', "[1", "YE", "S`")
    return {"byte": (byte, jgrammar.default_token_strings(V)),
            "rich": (rich, rich)}


@pytest.mark.parametrize("table", ["byte", "rich"])
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_masks_budgets_and_accepting_equal_jax_along_walks(spec, table):
    ttoks, jtoks = _tables()[table]
    kw = SPECS[spec]
    for seed in range(6):
        rng = np.random.default_rng(seed)
        got = tgrammar.GrammarSpec(**kw, token_strings=ttoks).make(V)
        want = jgrammar.GrammarSpec(**kw, token_strings=jtoks).make(V)
        for _ in range(30):
            allow = got.allowed()
            assert np.array_equal(allow, want.allowed())
            assert got.accepting() == want.accepting()
            for left in (0, 1, 2, 5, int(rng.integers(0, 20))):
                assert np.array_equal(got.budget_allowed(left),
                                      want.budget_allowed(left)), left
            fork = got.fork()
            ids = np.nonzero(allow)[0]
            if not ids.size:
                break
            t = int(rng.choice(ids))
            fork.advance(t)
            assert np.array_equal(got.allowed(), allow)   # fork moved
            got.advance(t)
            want.advance(t)
        bad = np.nonzero(~got.allowed())[0]
        if bad.size:
            with pytest.raises(ValueError) as e_got:
                got.advance(int(bad[0]))
            with pytest.raises(ValueError) as e_want:
                want.advance(int(bad[0]))
            assert str(e_got.value) == str(e_want.value)


def test_specs_share_their_tables_and_the_vocab_check():
    spec = tgrammar.GrammarSpec(kind="json_object")
    a, b = spec.make(V), spec.make(V)
    assert a._t is b._t and a.fork()._t is a._t
    for cls, args in ((tgrammar.JsonGrammar, ()),
                      (tgrammar.ChoiceGrammar, (("YES",),)),
                      (tgrammar.RegexGrammar, ("[A-C]+",))):
        g = cls(*args, tgrammar.default_token_strings(V))
        assert g.vocab_size == V and g._t is not a._t
    for mod in (tgrammar, jgrammar):
        with pytest.raises(ValueError, match="token_strings has 3"):
            mod.GrammarSpec(kind="json_object",
                            token_strings=("a", "b", "c")).make(V)


@pytest.mark.parametrize("kw", [
    dict(kind="schema"), dict(kind="choice"), dict(kind="regex"),
    dict(kind="choice", choices=("",)), dict(kind="regex", pattern="(A"),
    dict(kind="regex", pattern="A)"), dict(kind="regex", pattern="[AB"),
    dict(kind="regex", pattern="*A")])
def test_spec_errors_are_the_jax_texts(kw):
    def err(mod):
        try:
            mod.GrammarSpec(**kw).make(V)
        except ValueError as e:
            return str(e)
        return None
    assert err(tgrammar) == err(jgrammar) is not None


@pytest.mark.parametrize("text", ['["A", 12]', "[", "-0.5", "YES", "NO",
                                  "MAYBE!", "AB-7", "AB-", "", "CCD1_ X",
                                  '{"K": [true, null]}', "01"])
def test_validates_equals_jax(text):
    for kw in SPECS:
        assert tgrammar.GrammarSpec(**kw).validates(text) \
            == jgrammar.GrammarSpec(**kw).validates(text)


@pytest.mark.parametrize("value", [None, True, False, "on", "off", "1",
                                   "no", "YES", " off ", "json", ""])
def test_resolve_grammar_flag_equals_jax(monkeypatch, value):
    def res(fn, v):
        try:
            return fn(v)
        except ValueError as e:
            return str(e)
    monkeypatch.delenv("PADDLE_TPU_GRAMMAR", raising=False)
    assert res(resolve_grammar_flag, value) == \
        res(jgrammar.resolve_grammar_flag, value)
    monkeypatch.setenv("PADDLE_TPU_GRAMMAR", "sometimes")
    assert res(resolve_grammar_flag, value) == \
        res(jgrammar.resolve_grammar_flag, value)


def test_sampling_params_guards_are_the_jax_texts():
    g = GrammarSpec(kind="regex", pattern="[A-C]+")
    for kw in (dict(grammar=g), dict(grammar=g, eos_token_id=EOS,
                                     embed=True),
               dict(grammar_prefix=-1)):
        with pytest.raises(ValueError) as got:
            SamplingParams(**kw)
        with pytest.raises(ValueError) as want:
            JaxSampling(**kw)
        assert str(got.value) == str(want.value)
    sp = SamplingParams(grammar=g, eos_token_id=EOS, grammar_prefix=2,
                        session="s", embed=False)
    assert sp.grammar is g and sp.grammar_prefix == 2


def test_grammar_bias_rows_equal_jax():
    """`_grammar_bias` on the states of seeded walks, every budget and
    EOS placement: the JAX engine's rows, bit for bit (forced EOS at a
    spent accepting state, the whole allow-set out of reach)."""
    rng = np.random.default_rng(3)
    for kw in SPECS:
        got = GrammarSpec(**kw).make(V)
        want = jgrammar.GrammarSpec(**kw).make(V)
        for _ in range(12):
            for left in (0, 1, 2, 3, 9):
                for eos in (EOS, None, V + 3, ord("A")):
                    a = ServingEngine._grammar_bias(got, left, eos, V)
                    b = JaxEngine._grammar_bias(want, left, eos, V)
                    assert a.dtype == np.float32
                    assert np.array_equal(a, b), (kw, left, eos)
            ids = np.nonzero(got.allowed())[0]
            if not ids.size:
                break
            t = int(rng.choice(ids))
            got.advance(t)
            want.advance(t)


def test_gate_texts_equal_jax(models):
    jm, tm = models
    spec_t = GrammarSpec(kind="choice", choices=("A",))
    spec_j = jgrammar.GrammarSpec(kind="choice", choices=("A",))
    with pytest.raises(ValueError) as got:
        ServingEngine(tm, device="cpu", grammar=True, unified=False,
                      **ENGINE)
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, grammar=True, unified=False, **ENGINE, **JAX_GATES)
    assert str(got.value) == str(want.value)
    eng = ServingEngine(tm, device="cpu", grammar=False, **ENGINE)
    jeng = JaxEngine(jm, grammar=False, **ENGINE, **JAX_GATES)
    prompt = np.array([1, 2, 3], np.int64)
    with pytest.raises(ValueError) as got:
        eng.add_request(prompt, SamplingParams(
            max_new_tokens=4, eos_token_id=EOS, grammar=spec_t))
    with pytest.raises(ValueError) as want:
        jeng.add_request(prompt, JaxSampling(
            max_new_tokens=4, eos_token_id=EOS, grammar=spec_j))
    assert str(got.value) == str(want.value)
    assert eng.metrics.snapshot()["grammar"] is False


# -- the engines against JAX -------------------------------------------------
def _prompts():
    rng = np.random.RandomState(1)
    head = rng.randint(0, V, size=2).astype(np.int64)
    tpl = rng.randint(65, 68, size=3).astype(np.int64)
    prompts = [np.concatenate([head, np.tile(tpl, 4)])]
    prompts += [rng.randint(0, V, size=rng.randint(3, 14)).astype(np.int64)
                for _ in range(4)]
    return prompts + [np.concatenate([prompts[0], [65, 66]])]


# request i's grammar (None: unconstrained), by SPECS index
_KINDS = (1, 0, 2, None, 3, 1)


def _sp(side, i, **kw):
    k = _KINDS[i]
    cls = SamplingParams if side == "port" else JaxSampling
    if k is None:
        return cls(max_new_tokens=kw.pop("new", NEW), **kw)
    mod = tgrammar if side == "port" else jgrammar
    return cls(max_new_tokens=kw.pop("new", NEW), eos_token_id=EOS,
               grammar=mod.GrammarSpec(**SPECS[k]), **kw)


ARMS = {"defaults": {}, "megakernel": dict(megakernel=True),
        "ngram": dict(spec="ngram:4"), "model": dict(spec="model:4")}


def _run(eng, side):
    prompts = _prompts()
    outs = eng.generate(prompts, [_sp(side, i) for i in range(len(prompts))])
    snap = eng.metrics.snapshot()
    eng.drain()
    return ([list(o.token_ids) for o in outs],
            [o.finish_reason for o in outs],
            {k: snap[k] for k in GRAMMAR_KEYS},
            {k: snap[k] for k in ("spec_drafted_tokens",
                                  "spec_accepted_tokens")})


@pytest.fixture(scope="module")
def jax_runs(models):
    jm, _ = models
    return {arm: _run(JaxEngine(jm, grammar=True, **opts, **ENGINE,
                                **JAX_GATES), "jax")
            for arm, opts in ARMS.items()}


def assert_clear_margins(tm, prompts, outputs, kinds):
    """Every emitted token won its step among the tokens its grammar
    allowed there (the budget-aware bias, replayed through the port's
    automaton) by more than MARGIN, teacher-forced through the port."""
    for p, toks, k in zip(prompts, outputs, kinds):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int64)])
        with torch.no_grad():
            lg = tm(torch.from_numpy(seq)[None])[0, p.size - 1:].double()
        g = None if k is None else GrammarSpec(**SPECS[k]).make(V)
        for j, t in enumerate(toks):
            row = lg[j].numpy()
            if g is not None:
                bias = ServingEngine._grammar_bias(g, NEW - j, EOS, V)
                row = np.where(bias == 0.0, row, -np.inf)
            assert int(np.argmax(row)) == t
            ok = np.isfinite(row)
            if ok.sum() > 1:
                top2 = np.sort(row[ok])[-2:]
                assert top2[1] - top2[0] > MARGIN, (k, j)
            if g is not None and t != EOS:
                g.advance(t)


@pytest.mark.parametrize("arm", list(ARMS))
def test_constrained_tokens_and_counters_equal_jax(models, jax_runs, arm):
    _, tm = models
    got = _run(ServingEngine(tm, device="cpu", grammar=True, **ARMS[arm],
                             **ENGINE), "port")
    assert got[:3] == jax_runs[arm][:3]
    if arm in ("ngram", "model"):
        assert got[3] == jax_runs[arm][3]
        assert got[3]["spec_drafted_tokens"] > 0
    toks, reasons, counts = got[:3]
    assert counts["grammar_requests"] == sum(k is not None for k in _KINDS)
    assert counts["grammar_masked_rows"] > 0
    for t, r, k in zip(toks, reasons, _KINDS):
        if k is not None:
            text = text_of(t)
            assert GrammarSpec(**SPECS[k]).validates(text) or r == "length"
            assert EOS not in t[:-1]
    if arm == "defaults":
        assert_clear_margins(tm, _prompts(), toks, _KINDS)
    # greedy tokens are the same in every arm
    assert toks == jax_runs["defaults"][0]


def _preempted(make, side):
    """tests/test_serving_grammar.py's preemption: a constrained
    priority-5 request, stepped 6 times on a 6-page pool, then a
    priority-0 request that preempts it."""
    eng = make(num_slots=2, max_len=64, page_size=8, num_pages=6,
               chunk_len=16)
    cls = SamplingParams if side == "port" else JaxSampling
    mod = tgrammar if side == "port" else jgrammar
    lo = eng.add_request(np.arange(1, 9), cls(
        max_new_tokens=24, priority=5, eos_token_id=EOS,
        grammar=mod.GrammarSpec(kind="regex", pattern="[A-C]+")))
    for _ in range(6):
        eng.step()
    banked = len(lo.output_tokens)
    hi = eng.add_request(np.arange(30, 38), cls(max_new_tokens=24,
                                                priority=0))
    eng.run()
    out = (list(lo.output_tokens), lo.finish_reason, lo.preemptions,
           list(hi.output_tokens), banked, eng.metrics.preemptions,
           eng.metrics.snapshot()["grammar_masked_rows"])
    eng.drain()
    eng.pool.assert_quiesced()
    return out


def _with_prefix(make, side):
    """A re-placed stream's shape: its banked output ("AB-") arrives as
    the tail of the prompt, `grammar_prefix` of them, and the automaton
    replays them before it constrains."""
    eng = make(**ENGINE)
    cls = SamplingParams if side == "port" else JaxSampling
    mod = tgrammar if side == "port" else jgrammar
    prompt = np.concatenate([np.arange(1, 9), [65, 66, 45]])
    outs = eng.generate([prompt, prompt], [cls(
        max_new_tokens=NEW, eos_token_id=EOS, grammar_prefix=k,
        grammar=mod.GrammarSpec(**SPECS[1])) for k in (3, 0)])
    eng.drain()
    return [(list(o.token_ids), o.finish_reason) for o in outs]


@pytest.mark.parametrize("case", ["preemption", "grammar_prefix"])
def test_preemption_and_grammar_prefix_equal_jax(models, case):
    jm, tm = models
    fn = _preempted if case == "preemption" else _with_prefix
    got = fn(lambda **kw: ServingEngine(tm, device="cpu", grammar=True,
                                        **kw), "port")
    want = fn(lambda **kw: JaxEngine(jm, grammar=True, **kw, **JAX_GATES),
              "jax")
    assert got == want
    if case == "preemption":
        assert got[2] >= 1 and got[4] >= 3
        assert GrammarSpec(kind="regex", pattern="[A-C]+").validates(
            text_of(got[0])) or got[1] == "length"
    else:
        # the replayed prefix leaves the automaton after "AB-": a digit
        # comes first, where the unreplayed stream starts over
        first = got[0][0][0]
        assert chr(first).isdigit() and got[0] != got[1]


# -- the port's own identities -----------------------------------------------
@pytest.mark.parametrize("arm", ["defaults", "ngram"])
def test_gate_on_unconstrained_equals_gate_off(models, arm):
    """The gate on with no constrained request: the tokens of the gate
    off, no grammar counter moves and no bias is uploaded."""
    _, tm = models
    prompts = _prompts()
    runs = {}
    for on in (False, True):
        eng = ServingEngine(tm, device="cpu", grammar=on, **ARMS[arm],
                            **ENGINE)
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=NEW))
        runs[on] = [list(o.token_ids) for o in outs]
        snap = eng.metrics.snapshot()
        assert snap["grammar"] is on and snap["grammar_masked_steps"] == 0
        assert eng.grammar_bias_bytes == 0
        eng.drain()
    assert runs[True] == runs[False]


def test_flight_record_and_exposition_carry_the_grammar(models):
    _, tm = models
    eng = ServingEngine(tm, device="cpu", grammar=True, spec="ngram:4",
                        **ENGINE)
    prompts = _prompts()
    eng.generate(prompts, [_sp("port", i) for i in range(len(prompts))])
    steps = [s for s in eng.obs.flight.snapshot()["steps"]
             if "constrained_rows" in s]
    assert steps and sum(s["constrained_rows"] for s in steps) == \
        eng.metrics.snapshot()["grammar_masked_rows"]
    assert sum(s["grammar_rejected"] for s in steps) == \
        eng.metrics.snapshot()["grammar_rejected_drafts"]
    from paddle_tpu_torch.serving import prometheus_render
    text = prometheus_render({"0": eng.metrics.snapshot()})
    assert 'grammar="on"' in text
    assert "paddle_serving_grammar_masked_steps_total" in text
    eng.drain()

