"""Beam search and the dense int8 cache of the port's `generate()`,
held against the JAX package's `nlp/generation.py`.

On GPT (tests/test_generation.py's int8 geometry: vocab 512, hidden 64,
2 layers, 4 heads) and Llama (its GQA geometry: vocab 256, hidden 64, 2
layers, 4 heads over 2 kv heads), with the JAX model's weights moved by
`convert.py`: beam tokens and `return_scores` against the JAX
`CompiledGenerator`, `num_beams=1` against greedy, the calibrated int8
scales, greedy tokens over the int8 cache, and beam search over it. On
a toy LM whose logits are a table lookup (the JAX tests' `_TableLM`, one
per package): `length_penalty` changing the choice,
`num_return_sequences` with eos, and a table with exact ties, whose
beams must come out in `jax.lax.top_k`'s order. Then `kv8_attend`
against the JAX op, the per-row int8 write against single rows bit for
bit, the JAX package's errors with the same types and messages, and the
scales measured again after the weights change.
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nlp import generation as jgen
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.nlp.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM)
from paddle_tpu_torch.nlp import generation as tgen

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GPT = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=128)
LLAMA = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=128, max_position_embeddings=64)
# f32 on both sides: logits and attention outputs to 1e-5; a beam's
# score sums NEW log-probabilities of magnitude ~6, so 1e-4
TOL, SCORE_TOL = 1e-5, 1e-4
NEW = 6


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def jax_ln_importable():
    """The JAX GPT's LayerNorm imports the Pallas module, which needs
    `jax.experimental.disable_x64`: a stand-in that raises if entered is
    put there for this module (tests/test_torch_gpt_serving.py), and the
    JAX side held on its jnp paths."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    try:
        yield
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


@pytest.fixture(scope="module", params=["gpt", "llama"])
def models(request):
    if request.param == "gpt":
        paddle.seed(11)
        jm = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0, **GPT))
        tm = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
        vocab = GPT["vocab_size"]
    else:
        paddle.seed(3)
        jm = JaxLlama(JaxLlamaConfig(**LLAMA))
        tm = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu")
        vocab = LLAMA["vocab_size"]
    jm.eval()
    params = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm.load_state_dict(convert.from_paddle_state_dict(params))
    tm.eval()
    ids = np.random.RandomState(0).randint(0, vocab, (2, 8))
    return jm, tm, ids


def _jax_gen(jm, **kw):
    return jgen.CompiledGenerator(jm, jm._decode_cache_spec(), **kw)


def _port_gen(tm, **kw):
    return tgen.CompiledGenerator(tm, tm._decode_cache_spec(), **kw)


def test_beam_tokens_and_scores_match_jax(models):
    """Three beams, the two best a row with their scores, best first."""
    jm, tm, ids = models
    kw = dict(decode_strategy="beam_search", num_beams=3,
              num_return_sequences=2)
    want, want_s = _jax_gen(jm, **kw)(paddle.to_tensor(ids), NEW,
                                      return_scores=True)
    got, got_s = _port_gen(tm, **kw)(torch.from_numpy(ids), NEW,
                                     return_scores=True)
    assert got.shape == (4, 8 + NEW) and got_s.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), rtol=0,
                               atol=SCORE_TOL)
    s = got_s.numpy().reshape(2, 2)
    assert (s[:, 0] >= s[:, 1]).all()


def test_num_beams_one_equals_greedy(models):
    jm, tm, ids = models
    greedy = jm.generate(paddle.to_tensor(ids), max_new_tokens=NEW).numpy()
    beam1 = tm.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                        decode_strategy="beam_search", num_beams=1)
    np.testing.assert_array_equal(beam1.numpy(), greedy)
    np.testing.assert_array_equal(
        tm.generate(torch.from_numpy(ids), max_new_tokens=NEW).numpy(),
        greedy)


def test_int8_scales_and_tokens_match_jax(models):
    """The calibrated per-(layer, kv head) scales, then greedy tokens
    over the int8 cache (with eos) equal to JAX's, and to the float
    cache's, as the JAX package's own test has them."""
    jm, tm, ids = models
    want = _jax_gen(jm, kv_cache_dtype="int8")._calibrate_kv_scales(
        paddle.to_tensor(ids))
    got = _port_gen(tm, kv_cache_dtype="int8")._calibrate_kv_scales(
        torch.from_numpy(ids))
    assert len(got) == len(want) == tm._decode_cache_spec()[0]
    for (gk, gv), (wk, wv) in zip(got, want):
        assert gk.shape == (tm._decode_cache_spec()[1],)
        np.testing.assert_allclose(gk.numpy(), wk, rtol=TOL, atol=0)
        np.testing.assert_allclose(gv.numpy(), wv, rtol=TOL, atol=0)
    floats = tm.generate(torch.from_numpy(ids), max_new_tokens=NEW).numpy()
    eos = int(floats[0, 8 + 2])
    for kw in (dict(), dict(eos_token_id=eos, pad_token_id=1)):
        want = jm.generate(paddle.to_tensor(ids), max_new_tokens=NEW,
                           kv_cache_dtype="int8", **kw).numpy()
        got = tm.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                          kv_cache_dtype="int8", **kw).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tm.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                    kv_cache_dtype="int8").numpy(), floats)
    assert (got[0, 8 + 3:] == 1).all()


def test_beam_over_int8_matches_jax(models):
    jm, tm, ids = models
    kw = dict(max_new_tokens=NEW, decode_strategy="beam_search",
              num_beams=3, kv_cache_dtype="int8")
    want = jm.generate(paddle.to_tensor(ids), **kw).numpy()
    got = tm.generate(torch.from_numpy(ids), **kw).numpy()
    np.testing.assert_array_equal(got, want)


# -- the table LM: logits[b, t] = table[ids[b, t]] ---------------------------
class _JaxTableLM(paddle.nn.Layer):
    def __init__(self, table):
        super().__init__()
        self.table = paddle.to_tensor(table)
        self.table.stop_gradient = False

    def forward(self, input_ids, caches=None):
        ids = input_ids._value if hasattr(input_ids, "_value") else input_ids
        return Tensor(jnp.take(self.table._value, ids, axis=0)), caches

    def parameters(self, include_sublayers=True):
        return [self.table]

    def named_buffers(self, prefix=""):
        return []


class _TorchTableLM(torch.nn.Module):
    def __init__(self, table):
        super().__init__()
        self.table = torch.nn.Parameter(torch.from_numpy(table))

    device = property(lambda self: self.table.device)
    dtype = property(lambda self: self.table.dtype)

    def forward(self, input_ids, caches=None):
        return self.table[input_ids], caches


def _table_pair(table, prompt, max_new, scores=False, **kw):
    """The JAX and port beam searches over one table: (tokens, scores)
    of each, new tokens only."""
    outs = []
    for gen_cls, lm, to in ((jgen.CompiledGenerator, _JaxTableLM,
                             paddle.to_tensor),
                            (tgen.CompiledGenerator, _TorchTableLM,
                             torch.from_numpy)):
        gen = gen_cls(lm(table), cache_spec=(1, 1, 4),
                      decode_strategy="beam_search", **kw)
        res = gen(to(prompt), max_new_tokens=max_new, return_scores=scores)
        tok, sc = res if scores else (res, None)
        outs.append((np.asarray(tok.numpy())[:, prompt.shape[1]:],
                     None if sc is None else np.asarray(sc.numpy())))
    return outs


def test_length_penalty_changes_the_choice():
    rng = np.random.default_rng(3)
    v = 8
    table = (rng.permutation(v * v).reshape(v, v) * 0.21).astype(np.float32)
    prompt = np.array([[2, 5]], np.int64)
    chosen = []
    for lp in (0.0, 1.0):
        (want, _), (got, _) = _table_pair(table, prompt, 5, num_beams=3,
                                          eos_token_id=6, pad_token_id=0,
                                          length_penalty=lp)
        np.testing.assert_array_equal(got, want)
        chosen.append(got)
    assert not np.array_equal(*chosen)


def test_num_return_sequences_and_eos_match_jax():
    """Three of four beams a row, best first, with their scores; beams
    that emit eos are frozen on pad."""
    rng = np.random.default_rng(5)
    v = 9
    table = (rng.permutation(v * v).reshape(v, v) * 0.37).astype(np.float32)
    prompt = np.array([[3], [6]], np.int64)
    (want, want_s), (got, got_s) = _table_pair(
        table, prompt, 5, scores=True, num_beams=4, num_return_sequences=3,
        eos_token_id=2, pad_token_id=0)
    assert got.shape == (6, 5) and got_s.shape == (6,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=SCORE_TOL)
    assert (np.diff(got_s.reshape(2, 3), axis=1) <= 0).all()
    hit = [row for row in got if 2 in row]
    assert hit and all((r[list(r).index(2) + 1:] == 0).all() for r in hit)


def test_ties_follow_the_jax_order():
    """A table of three distinct values: every step has exact ties among
    the beams' candidates, and among the final scores. The port keeps
    `jax.lax.top_k`'s lower-index-first order."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 3, (7, 7)).astype(np.float32)
    prompt = np.array([[1], [4], [0]], np.int64)
    (want, want_s), (got, got_s) = _table_pair(
        table, prompt, 4, scores=True, num_beams=4, num_return_sequences=4,
        pad_token_id=0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_s, want_s)
    assert len(set(got_s.tolist())) < got_s.size       # ties in the scores
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0]], np.float32)
    vals, idx = tgen._top_k_stable(torch.from_numpy(x), 4)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 4)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 2, 4, 0]]
    assert vals.tolist() == np.asarray(jvals).tolist()


# -- the dense int8 cache's ops ----------------------------------------------
def test_kv8_attend_matches_jax():
    """GQA (4 query heads over 2 kv heads), a per-row window mask; the
    port's codes are [B, L, H_kv, D], the JAX package's [B, H_kv, L, D]."""
    rs = np.random.RandomState(5)
    b, h, hkv, lmax, d = 2, 4, 2, 16, 8
    k8 = rs.randint(-127, 128, (b, lmax, hkv, d)).astype(np.int8)
    v8 = rs.randint(-127, 128, (b, lmax, hkv, d)).astype(np.int8)
    ks = rs.uniform(0.01, 0.02, (hkv,)).astype(np.float32)
    vs = rs.uniform(0.01, 0.02, (hkv,)).astype(np.float32)
    q = rs.randn(b, 1, h, d).astype(np.float32)
    pos = np.array([9, 3], np.int32)
    mask = np.asarray(jgen._window_mask_fwd(jnp.asarray(pos), 1, lmax))
    want = jgen._kv8_attend_fwd(
        jnp.asarray(q), jnp.asarray(k8.transpose(0, 2, 1, 3)),
        jnp.asarray(v8.transpose(0, 2, 1, 3)), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(mask))
    t = lambda a: torch.from_numpy(np.array(a))
    window = tgen.window_causal_mask(t(pos), 1, lmax)
    assert torch.equal(window, t(mask))
    got = tgen.kv8_attend(t(q), t(k8), t(v8), t(ks), t(vs), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_rowwise_int8_write_equals_single_rows():
    """A per-row pos on the int8 cache: the batched single-token write
    and attend equal each row's alone, bit for bit."""
    rs = np.random.RandomState(7)
    b, h, lmax, d = 2, 2, 16, 4
    t = lambda a: torch.from_numpy(np.array(a))
    k8 = rs.randint(-127, 128, (b, lmax, h, d)).astype(np.int8)
    v8 = rs.randint(-127, 128, (b, lmax, h, d)).astype(np.int8)
    ks, vs = (rs.uniform(0.01, 0.03, (h,)).astype(np.float32)
              for _ in range(2))
    q, kn, vn = (rs.randn(b, 1, h, d).astype(np.float32) for _ in range(3))
    pos = np.array([3, 5], np.int32)
    cache = tgen.DecodeCache(t(k8), t(v8), t(pos), k_scale=t(ks),
                             v_scale=t(vs))
    out, c2 = tgen.update_and_attend(t(q), t(kn), t(vn), cache)
    assert torch.equal(c2.pos, t(pos + 1))
    for r in range(b):
        cr = tgen.DecodeCache(t(k8[r:r + 1]), t(v8[r:r + 1]), int(pos[r]),
                              k_scale=t(ks), v_scale=t(vs))
        o, cr = tgen.update_and_attend(t(q[r:r + 1]), t(kn[r:r + 1]),
                                       t(vn[r:r + 1]), cr)
        assert torch.equal(o, out[r:r + 1])
        assert torch.equal(cr.k[0], c2.k[r]) and torch.equal(cr.v[0], c2.v[r])


def _dense_q8_case(kind):
    """(JAX call, port call) of one of the dense int8 cache's refused
    writes."""
    rs = np.random.RandomState(0)
    x3 = rs.randn(1, 3, 2, 4).astype(np.float32)
    scales = [(np.full((2,), 0.01, np.float32),
               np.full((2,), 0.01, np.float32))]
    if kind == "chunked_prefill":
        def jax_call():
            c = jgen.init_decode_caches(1, 1, 16, 2, 4, kv_scales=scales)[0]
            q = Tensor(jnp.asarray(x3))
            _, c = jgen.update_and_attend(q, q, q, c)
            jgen.update_and_attend(q, q, q, c)

        def port_call():
            c = tgen.init_decode_caches(1, 1, 16, 2, 4, kv_scales=scales)[0]
            q = torch.from_numpy(x3)
            _, c = tgen.update_and_attend(q, q, q, c)
            tgen.update_and_attend(q, q, q, c)
        return jax_call, port_call
    if kind == "rowwise_chunk":
        k8 = np.zeros((1, 16, 2, 4), np.int8)

        def jax_call():
            c = jgen.DecodeCache(Tensor(jnp.asarray(k8.transpose(0, 2, 1, 3))),
                                 Tensor(jnp.asarray(k8.transpose(0, 2, 1, 3))),
                                 Tensor(jnp.asarray([2], jnp.int32)),
                                 Tensor(jnp.asarray(scales[0][0])),
                                 Tensor(jnp.asarray(scales[0][1])))
            q = Tensor(jnp.asarray(x3))
            jgen.update_and_attend(q, q, q, c)

        def port_call():
            c = tgen.DecodeCache(torch.from_numpy(k8), torch.from_numpy(k8),
                                 torch.tensor([2], dtype=torch.int32),
                                 k_scale=torch.from_numpy(scales[0][0]),
                                 v_scale=torch.from_numpy(scales[0][1]))
            q = torch.from_numpy(x3)
            tgen.update_and_attend(q, q, q, c)
        return jax_call, port_call
    # the dense cache's per-head scales on a paged int8 pool
    pool = np.zeros((3, 4, 2, 4), np.int8)
    table = np.array([[1, 2]], np.int32)

    def jax_call():
        c = jgen.DecodeCache(Tensor(jnp.asarray(pool)),
                             Tensor(jnp.asarray(pool)),
                             Tensor(jnp.asarray([0], jnp.int32)),
                             Tensor(jnp.asarray(scales[0][0])),
                             Tensor(jnp.asarray(scales[0][1])),
                             page_table=Tensor(jnp.asarray(table)))
        q = Tensor(jnp.asarray(x3[:, :1]))
        jgen.update_and_attend(q, q, q, c)

    def port_call():
        c = tgen.DecodeCache(torch.from_numpy(pool), torch.from_numpy(pool),
                             torch.tensor([0], dtype=torch.int32),
                             page_table=torch.from_numpy(table),
                             k_scale=torch.from_numpy(scales[0][0]),
                             v_scale=torch.from_numpy(scales[0][1]))
        q = torch.from_numpy(x3[:, :1])
        tgen.update_and_attend(q, q, q, c)
    return jax_call, port_call


def _generator_case(kind):
    table = np.eye(5, dtype=np.float32)
    prompt = np.array([[1]], np.int64)
    if kind == "nret_over_beams":
        kw, call = dict(decode_strategy="beam_search", num_beams=2,
                        num_return_sequences=3), {}
    else:
        kw, call = dict(decode_strategy="greedy"), dict(return_scores=True)
    return (lambda: jgen.CompiledGenerator(_JaxTableLM(table), (1, 1, 4),
                                           **kw)(paddle.to_tensor(prompt),
                                                 2, **call),
            lambda: tgen.CompiledGenerator(_TorchTableLM(table), (1, 1, 4),
                                           **kw)(torch.from_numpy(prompt),
                                                 2, **call))


@pytest.mark.parametrize("kind", ["chunked_prefill", "rowwise_chunk",
                                  "dense_scales_on_pool", "nret_over_beams",
                                  "scores_without_beam"])
def test_errors_are_the_jax_packages(kind):
    jax_call, port_call = (_dense_q8_case(kind) if kind in (
        "chunked_prefill", "rowwise_chunk", "dense_scales_on_pool")
        else _generator_case(kind))
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(want.type) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_scales_follow_the_weights():
    """Changing a weight in place calibrates the int8 cache again, to the
    scales a fresh generator measures."""
    paddle.seed(3)
    tm = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu", seed=2).eval()
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 5)))
    gen = _port_gen(tm, kv_cache_dtype="int8")
    gen(ids, 2)
    before = [k.clone() for k, _ in gen._kv_scales]
    with torch.no_grad():
        tm.llama.layers[0].self_attn.k_proj.weight.mul_(3.0)
    gen(ids, 2)
    fresh = _port_gen(tm, kv_cache_dtype="int8")._calibrate_kv_scales(ids)
    assert not torch.equal(gen._kv_scales[0][0], before[0])
    for (k, v), (fk, fv) in zip(gen._kv_scales, fresh):
        assert torch.equal(k, fk) and torch.equal(v, fv)
