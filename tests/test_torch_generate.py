"""`GPTForCausalLM.generate` of the port against the JAX package.

At the geometry of `__graft_entry__.entry()` (vocab 1024, hidden 256, 4
layers, 8 heads, 256 positions; a [2, 64] prompt), with the JAX model's
weights moved by `convert.py`: greedy tokens equal the JAX compiled
`generate`, with and without `eos_token_id`/`pad_token_id`, and every
emitted token wins its step by a clear margin; with `use_compiled=False`
and `eos_token_id` set, the tokens of the JAX eager loop, which never
stops at eos and never pads; the argument errors are
the JAX package's; a seeded sampling run is reproducible and stays
inside its top-k / top-p set; beam search and the int8 cache give the
JAX package's tokens.
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
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=1024, hidden_size=256, num_hidden_layers=4,
                num_attention_heads=8, max_position_embeddings=256)
NEW = 12
# f32 on both sides (test_torch_gpt_serving.py)
LOGIT_TOL = 1e-4


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def models():
    """The JAX GPT of `entry()` and its port with the same weights (the
    JAX side on its jnp paths)."""
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


def _ids():
    return np.random.RandomState(0).randint(0, 1024, (2, 64))


def _jax_generate(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


def _margins(tm, seq, prompt_len, n):
    """Teacher-force seq [B, L] through the port: each row's top-two
    logit margin at the n positions that produced its new tokens, and
    the greedy choice there."""
    with torch.no_grad():
        lg = tm(torch.from_numpy(np.array(seq)))[:, prompt_len - 1:
                                                 prompt_len - 1 + n]
    top2 = torch.topk(lg, 2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]), lg.argmax(-1)


@pytest.fixture(scope="module")
def jax_greedy(models):
    return _jax_generate(models[0], _ids(), max_new_tokens=NEW)


def test_greedy_matches_jax(models, jax_greedy):
    tm = models[1]
    got = tm.generate(torch.from_numpy(_ids()), max_new_tokens=NEW)
    assert got.shape == (2, 64 + NEW) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_greedy)
    margin, argmax = _margins(tm, jax_greedy, 64, NEW)
    assert margin.min().item() > 10 * LOGIT_TOL
    np.testing.assert_array_equal(argmax.numpy(), jax_greedy[:, 64:])
    # "greedy", its reference spelling and the eager loop agree
    for kw in (dict(decode_strategy="greedy"),
               dict(decode_strategy="greedy_search"),
               dict(use_compiled=False)):
        np.testing.assert_array_equal(
            tm.generate(torch.from_numpy(_ids()), max_new_tokens=NEW,
                        **kw).numpy(), jax_greedy)


def test_eos_and_pad_match_jax(models, jax_greedy):
    """Row 0 emits eos at its fifth token: from then on it emits pad,
    while row 1 runs to the budget (or stops at the same eos)."""
    eos = int(jax_greedy[0, 64 + 4])
    want = _jax_generate(models[0], _ids(), max_new_tokens=NEW,
                         eos_token_id=eos, pad_token_id=7)
    got = models[1].generate(torch.from_numpy(_ids()), max_new_tokens=NEW,
                             eos_token_id=eos, pad_token_id=7)
    np.testing.assert_array_equal(got.numpy(), want)
    first = int(np.argmax(want[0, 64:] == eos))
    assert (want[0, 64 + first + 1:] == 7).all() and first <= 4


def test_eager_loop_with_eos_matches_jax(models, jax_greedy):
    """ROADMAP queue 3's F6 input: `use_compiled=False` with eos set is
    the JAX eager debug loop — row 0 goes on past its eos and no row is
    padded — where the compiled loop pads."""
    eos = int(jax_greedy[0, 64 + 4])
    kw = dict(max_new_tokens=NEW, eos_token_id=eos, pad_token_id=7)
    want = _jax_generate(models[0], _ids(), use_compiled=False, **kw)
    got = models[1].generate(torch.from_numpy(_ids()), use_compiled=False,
                             **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jax_greedy)
    padded = models[1].generate(torch.from_numpy(_ids()), **kw)
    assert (padded.numpy()[0, 64 + 5:] == 7).all()


@pytest.mark.parametrize("kw", [
    dict(decode_strategy="top_k"),
    dict(kv_cache_dtype="fp16"),
    dict(decode_strategy="greedy", num_return_sequences=2),
    dict(num_return_sequences=3),
    dict(use_compiled=False, decode_strategy="sampling"),
    dict(use_compiled=False, top_p=0.9),
    dict(use_compiled=False, num_return_sequences=2, top_k=4),
], ids=["bad_strategy", "bad_cache_dtype", "greedy_nret", "argmax_nret",
        "eager_sampling", "eager_top_p", "eager_nret"])
def test_argument_errors_are_the_jax_packages(models, kw):
    ids = _ids()
    with pytest.raises(Exception) as want:
        _jax_generate(models[0], ids, max_new_tokens=2, **kw)
    with pytest.raises(want.type) as got:
        models[1].generate(torch.from_numpy(ids), max_new_tokens=2, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(decode_strategy="beam_search"),
                                dict(kv_cache_dtype="int8")],
                         ids=["beam_search", "int8"])
def test_beam_and_int8_match_jax(models, kw):
    """Beam search (4 beams) and the dense int8 cache give the JAX
    package's tokens."""
    want = _jax_generate(models[0], _ids(), max_new_tokens=4, **kw)
    got = models[1].generate(torch.from_numpy(_ids()), max_new_tokens=4,
                             **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [dict(decode_strategy="sampling", top_k=5),
                                dict(top_p=0.5),
                                dict(decode_strategy="sampling",
                                     temperature=0.7, top_k=20, top_p=0.9)],
                         ids=["top_k", "top_p", "all"])
def test_seeded_sampling_is_reproducible_and_inside_its_set(models, kw):
    tm = models[1]
    ids = torch.from_numpy(_ids())
    run = lambda seed: tm.generate(
        ids, max_new_tokens=NEW, generator=torch.Generator().manual_seed(
            seed), **kw)
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        lg = tm(a)[:, 63:63 + NEW] / kw.get("temperature", 1.0)
    toks = a[:, 64:]
    if "top_k" in kw:
        kth = torch.topk(lg, kw["top_k"], dim=-1).values[..., -1]
        assert (lg.gather(-1, toks[..., None])[..., 0] >= kth).all()
    if "top_p" in kw:
        probs = torch.softmax(lg.float(), -1)
        p_tok = probs.gather(-1, toks[..., None])[..., 0]
        # the token's mass rank: the mass of strictly likelier tokens is
        # below top_p (the nucleus keeps its first token, then all whose
        # exclusive cumulative mass is below p)
        above = (probs * (probs > p_tok[..., None])).sum(-1)
        assert (above < kw["top_p"] + 1e-6).all()


def test_sampling_rows_and_return_sequences(models):
    out = models[1].generate(torch.from_numpy(_ids()), max_new_tokens=4,
                             decode_strategy="sampling",
                             num_return_sequences=2,
                             generator=torch.Generator().manual_seed(0))
    assert out.shape == (4, 68)
    assert torch.equal(out[0, :64], out[1, :64])
