"""The draft-model tier of speculative decoding (`serving.draft`) against
the JAX package.

`make_draft_model` truncates the port's GPT and Llama as the JAX
function truncates the JAX models (the same kept weights, half the
layers by default, clamped to 1..L). A `DraftEngine` over the truncated
weights proposes the JAX `DraftEngine`'s drafts through seeding,
catch-up feeds, rollback by `committed` and release, with the same
positions and pool accounting. In the engine, a draft pool too small for
every slot makes slots draft less and never fails them, preemption drops
a slot's draft pages and drafter, and resume drafts again; tokens stay
those of a spec-off engine and the draft pool quiesces.
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
from paddle_tpu.serving import draft as jdraft
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM)
from paddle_tpu_torch.serving import (DraftConfig, DraftEngine,
                                      SamplingParams, ServingEngine,
                                      make_draft_model)

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = {
    "gpt": dict(vocab_size=97, hidden_size=32, num_hidden_layers=4,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=128),
    "llama": dict(vocab_size=89, hidden_size=32, num_hidden_layers=4,
                  num_attention_heads=4, num_key_value_heads=2,
                  intermediate_size=48, max_position_embeddings=128)}
DRAFT = dict(num_slots=3, chunk_len=16, page_size=8, num_pages=25,
             max_pages=8)
ENGINE = dict(num_slots=3, max_len=64, page_size=8, chunk_len=16)
NEW = 12


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
    """{name: (JAX model, port model)} on the same weights, 4 layers."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.delenv("PADDLE_TPU_SPEC_DECODE", raising=False)
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    try:
        out = {}
        for name, jcls, jcfg, tcls, tcfg, extra in (
                ("gpt", JaxGPT, JaxGPTConfig, GPTForCausalLM, GPTConfig,
                 dict(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)),
                ("llama", JaxLlama, JaxLlamaConfig, LlamaForCausalLM,
                 LlamaConfig, {})):
            paddle.seed(13)
            jm = jcls(jcfg(**extra, **GEOMETRY[name]))
            jm.eval()
            tm = tcls(tcfg(**GEOMETRY[name]), device="cpu")
            tm.load_state_dict(convert.from_paddle_state_dict(
                {k: v.numpy() for k, v in jm.state_dict().items()}))
            tm.eval()
            out[name] = (jm, tm)
        yield out
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_make_draft_model_keeps_the_jax_weights(models, name):
    jm, tm = models[name]
    jd, td = jdraft.make_draft_model(jm), make_draft_model(tm)
    assert td.config.num_hidden_layers == jd.config.num_hidden_layers == 2
    assert tm.config.num_hidden_layers == 4         # the target's untouched
    want = convert.from_paddle_state_dict(
        {k: v.numpy() for k, v in jd.state_dict().items()})
    got = td.state_dict()
    assert set(got) == set(want)
    for key, value in got.items():
        assert torch.equal(value, want[key]), key
    assert not td.training and td.device == tm.device
    for n, keep in ((0, 1), (1, 1), (3, 3), (9, 4)):
        assert make_draft_model(tm, num_layers=n).config \
            .num_hidden_layers == keep


def _drive(draft, vocab):
    """The same calls on either package's DraftEngine: admit three slots,
    seed slot 0's long prompt in two chunks, propose for all three
    (catch-ups of 1-16 tokens, k 4, 3 and 1), roll slot 0 back by
    `committed` and slot 1 by a shorter history, propose again, then
    release. Returns every proposal, position and stats read."""
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, vocab, size=n) for n in (30, 9, 1)]
    out = []
    for slot, p in enumerate(prompts):
        assert draft.admit(slot, p.size, 16)
    draft.seed({0: prompts[0][:16]})
    draft.seed({0: prompts[0][16:29]})
    out.append(draft.stats())
    t0 = [int(rs.randint(vocab)) for _ in range(3)]
    entries = {0: (np.concatenate([prompts[0][29:], [t0[0]]]), 4),
               1: (np.concatenate([prompts[1], [t0[1]]]), 3),
               2: (np.concatenate([prompts[2], [t0[2]]]), 1)}
    first = draft.propose_batch(entries)
    out.append({s: p.tolist() for s, p in first.items()})
    out.append(draft._dpos.tolist())
    # slot 0 commits t0 and two drafts, slot 1 only t0
    hist0 = np.concatenate([prompts[0], [t0[0]], first[0][:2]])
    hist1 = np.concatenate([prompts[1], [t0[1]]])
    out.append([draft.committed(0, hist0.size), draft.lag(0, hist0.size),
                draft.committed(1, hist1.size), draft.lag(2, 5)])
    second = draft.propose_batch({
        0: (np.concatenate([hist0[draft.committed(0, hist0.size):],
                            [first[0][2]]]), 4),
        1: (np.array([first[1][0]]), 2)})
    out.append({s: p.tolist() for s, p in second.items()})
    out.append(draft._dpos.tolist())
    for slot in range(3):
        draft.release(slot)
    out.append(draft.stats())
    draft.assert_quiesced()
    return out


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_draft_engine_proposes_the_jax_drafts(models, name):
    jm, tm = models[name]
    vocab = GEOMETRY[name]["vocab_size"]
    want = _drive(jdraft.DraftEngine(jdraft.make_draft_model(jm),
                                     jdraft.DraftConfig(**DRAFT)), vocab)
    got = _drive(DraftEngine(make_draft_model(tm), DraftConfig(**DRAFT)),
                 vocab)
    assert got == want
    assert any(len(p) == 4 for p in got[1].values())


def test_draft_pool_lifecycle(models):
    tm = models["gpt"][1]
    d = DraftEngine(make_draft_model(tm), DraftConfig(
        **{**DRAFT, "num_pages": 6}))
    assert d.page_bytes == 2 * 2 * 8 * 4 * 8 * 4       # f32, 2 layers
    assert d._pools[0][0].dtype == torch.float32
    assert d.admit(0, 20, 12)                          # 4 pages
    assert d.admit(0, 20, 12)                          # idempotent
    assert not d.admit(1, 20, 12)                      # pressure
    assert d.stats()["pages_used"] == 4 and d.resident(0)
    with pytest.raises(RuntimeError, match="page leak"):
        d.assert_quiesced()
    with pytest.raises(ValueError, match="want 1..16"):
        d.propose_batch({0: (np.zeros(17, np.int64), 2)})
    d.seed({0: np.arange(5)})
    assert d.lag(0, 9) == 4 and d.committed(0, 3) == 3
    d.release(0)
    d.release(2)                                       # not resident
    assert d.admit(1, 20, 12)
    d.release(1)
    d.assert_quiesced()


def _tokens(eng, prompts):
    res = eng.generate(prompts, SamplingParams(max_new_tokens=NEW))
    return [list(r.token_ids) for r in res], eng.metrics.snapshot()


def _prompts(vocab):
    rs = np.random.RandomState(2)
    tpl = rs.randint(0, vocab, size=6)
    return [np.concatenate([rs.randint(0, vocab, size=2),
                            np.tile(tpl, 3)]) if i % 2 else
            rs.randint(0, vocab, size=int(rs.randint(3, 14)))
            for i in range(7)]


def test_draft_pool_pressure_drafts_less_and_never_fails(models):
    """A draft pool of 5 pages (4 usable) holds one slot's budget at a
    time: the other slots draft later or not at all, tokens stay the
    spec-off tokens, and the pool quiesces."""
    tm = models["gpt"][1]
    prompts = _prompts(tm.config.vocab_size)
    want, _ = _tokens(ServingEngine(tm, device="cpu", grouped=False,
                                    **ENGINE), prompts)
    full_eng = ServingEngine(tm, device="cpu", grouped=False, spec="model:4",
                             **ENGINE)
    full, full_snap = _tokens(full_eng, prompts)
    eng = ServingEngine(tm, device="cpu", grouped=False, spec="model:4",
                        draft_pages=5, **ENGINE)
    tight, snap = _tokens(eng, prompts)
    assert tight == full == want
    assert eng._draft.num_pages == 5
    assert snap["draft_pool"]["pages_total"] == 4
    assert 0 < snap["spec_drafted_tokens"] < full_snap["spec_drafted_tokens"]
    assert snap["spec_accepted_tokens"] > 0
    assert eng.debug_state()["draft_pool"]["pages_total"] == 4
    eng.drain()
    full_eng.drain()
    eng._draft.assert_quiesced()


def test_preemption_drops_the_draft_and_resume_drafts_again(models):
    tm = models["llama"][1]
    prompts = _prompts(tm.config.vocab_size)[:2]
    want, _ = _tokens(ServingEngine(tm, device="cpu", **ENGINE), prompts)
    eng = ServingEngine(tm, device="cpu", spec="model:4", **ENGINE)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=NEW))
            for p in prompts]
    while len(reqs[1].output_tokens) < 3:
        eng.step()
    assert eng._draft.resident(reqs[1].slot)
    drafted = reqs[1].accepted_draft_tokens
    eng._preempt(reqs[1].slot, reqs[1], eng._clock())
    assert not eng._draft.resident(1) and eng._draft.stats()["residents"] == 1
    assert reqs[1].request_id not in eng._drafters
    eng.run()
    assert [r.output_tokens for r in reqs] == want
    assert reqs[1].preemptions == 1
    assert reqs[1].accepted_draft_tokens >= drafted
    eng.drain()
    eng._draft.assert_quiesced()
