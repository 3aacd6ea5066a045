"""GPT and the serving engine of the port, held against the JAX package.

At the phase-7 geometry of `__graft_entry__.dryrun_multichip` (vocab
256, hidden 64, 2 layers, 4 heads): the weight conversion round trip,
GPT logits against the JAX `GPTForCausalLM`, and greedy tokens of the
port's `ServingEngine` against the JAX engine run with `grouped=False`
(the port's K6 path), with the prefix cache on and off, plus a
shared-prefix trace that forces a copy-on-write page.
"""
import sys

import jax
import jax.experimental
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=8)
PROMPT_LENS = (5, 11, 17, 8)
NEW_TOKENS = 8
# f32 on both sides; the frameworks sum in different orders and the JAX
# LayerNorm takes one-pass statistics where the port takes two-pass
LOGIT_TOL = 1e-4


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
def jax_ln_importable():
    """Let the JAX GPT run on this jax: `paddle_tpu/ops/pallas/
    layer_norm.py` imports `jax.experimental.disable_x64` at module
    level and every JAX LayerNorm imports that module first, so jax
    releases without the name fail every GPT forward. A stand-in that
    raises if entered (the Pallas path must not run on the CPU) is put
    there for this module and removed at teardown, together with the
    module imported under it. The fused-LN and Pallas-interpret switches
    are held off for the module, so the JAX side runs its jnp paths."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    # the jnp path is the oracle even where another test module has set
    # PADDLE_TPU_PALLAS_INTERPRET=1 for the whole process
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


@pytest.fixture(scope="module")
def models(jax_ln_importable):
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0, **GEOMETRY))
    jm.eval()
    params = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**GEOMETRY), device="cpu")
    tm.load_state_dict(convert.from_paddle_state_dict(params))
    tm.eval()
    return jm, tm, params


def _prompts():
    rs = np.random.RandomState(5)
    return [rs.randint(0, 256, size=n).astype(np.int64) for n in PROMPT_LENS]


def _assert_clear_margins(tm, prompts, outputs):
    """Teacher-force each finished sequence through the port and check
    that every emitted token won its step by more than LOGIT_TOL — so a
    disagreement could not be a near-tie across frameworks."""
    for p, toks in zip(prompts, outputs):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int64)])
        with torch.no_grad():
            lg = tm(torch.from_numpy(seq)[None])[0, p.size - 1:]
        top2 = torch.topk(lg, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 10 * LOGIT_TOL, \
            f"near-tie (margin {margin}): pick another seed"
        assert torch.argmax(lg, dim=-1).tolist() == list(toks)


@pytest.fixture(scope="module")
def jax_tokens(models):
    """Greedy tokens of the JAX engine on the grouped=False path, with
    the prefix cache on and off (built once per module)."""
    jm = models[0]
    out = {}
    for prefix in (True, False):
        eng = JaxEngine(jm, grouped=False, prefix_cache=prefix, **ENGINE)
        res = eng.generate(_prompts(),
                           [JaxSampling(max_new_tokens=NEW_TOKENS)
                            for _ in PROMPT_LENS])
        out[prefix] = [list(r.token_ids) for r in res]
    return out


def test_convert_round_trip(models, tmp_path):
    jm, tm, params = models
    back = convert.to_paddle_state_dict(tm.state_dict())
    assert sorted(back) == sorted(params)
    for name, arr in params.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    # Linear weights cross [in, out] -> [out, in]
    w = tm.state_dict()["gpt.layers.0.attn.qkv_proj.weight"]
    assert tuple(w.shape) == (192, 64)
    # a .pdparams file written by the JAX package's paddle.save
    path = tmp_path / "gpt.pdparams"
    paddle.save(jm.state_dict(), str(path))
    loaded = convert.from_paddle_state_dict(convert.load_pdparams(path))
    for name, t in tm.state_dict().items():
        torch.testing.assert_close(loaded[name], t, rtol=0, atol=0)
    # bf16 arrays arrive as ml_dtypes.bfloat16 and keep their bits
    arr = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    got = convert.from_paddle_state_dict(
        {"x.weight": arr.astype(ml_dtypes.bfloat16)})["x.weight"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4, 3)
    torch.testing.assert_close(
        got, torch.from_numpy(arr.T.copy()).to(torch.bfloat16),
        rtol=0, atol=0)


def test_gpt_logits_match_jax(models):
    jm, tm, _ = models
    ids = np.random.RandomState(7).randint(0, 256, size=(2, 24))
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("prefix", [True, False])
def test_engine_greedy_tokens_identical_to_jax(models, jax_tokens, prefix):
    tm = models[1]
    eng = ServingEngine(tm, device="cpu", prefix_cache=prefix, **ENGINE)
    res = eng.generate(_prompts(), [SamplingParams(max_new_tokens=NEW_TOKENS)
                                    for _ in PROMPT_LENS])
    got = [list(r.token_ids) for r in res]
    assert got == jax_tokens[prefix]
    assert all(r.finish_reason == "length" for r in res)
    _assert_clear_margins(tm, _prompts(), got)
    eng.pool.assert_quiesced()


def test_shared_prefix_copy_on_write(models):
    """A finished request's partial page is matched mid-page by the next
    prompt: the engine copies it into a private page before prefill, and
    the tokens equal a cache-less engine's."""
    tm = models[1]
    rs = np.random.RandomState(11)
    base = rs.randint(0, 256, size=13).astype(np.int64)
    first = np.concatenate([base, [3, 4, 5]])     # fills pages 0 and 1
    second = np.concatenate([base, [9, 8]])       # diverges inside page 1
    sp = SamplingParams(max_new_tokens=6)
    outs = {}
    for prefix in (True, False):
        eng = ServingEngine(tm, device="cpu", prefix_cache=prefix, **ENGINE)
        a = eng.generate([first], sp)[0]
        b = eng.generate([second], sp)[0]
        outs[prefix] = (a.token_ids, b.token_ids)
        if prefix:
            assert eng.prefix_cache.cow_copies_total == 1
            assert b.cached_tokens == 13
        eng.pool.assert_quiesced()
    assert outs[True] == outs[False]
    _assert_clear_margins(tm, [first, second], list(outs[True]))


def test_sampled_rows_with_a_single_candidate_decode_greedily(models):
    """top_k=1 (or a top_p below the top token's mass) leaves one token
    to draw: the sampling path must reproduce greedy decoding, while
    greedy neighbours in the same steps are unaffected."""
    tm = models[1]
    prompts = _prompts()
    greedy = ServingEngine(tm, device="cpu", **ENGINE).generate(
        prompts, SamplingParams(max_new_tokens=NEW_TOKENS))
    mixed = ServingEngine(tm, device="cpu", seed=3, **ENGINE).generate(
        prompts, [SamplingParams(max_new_tokens=NEW_TOKENS, top_k=1),
                  SamplingParams(max_new_tokens=NEW_TOKENS, top_p=1e-6,
                                 temperature=0.7),
                  SamplingParams(max_new_tokens=NEW_TOKENS),
                  SamplingParams(max_new_tokens=NEW_TOKENS, top_k=1,
                                 temperature=2.0)])
    assert [r.token_ids for r in mixed] == [r.token_ids for r in greedy]


def test_eviction_under_page_pressure_keeps_tokens(models):
    """A pool too small to keep every finished request's pages cached:
    admission evicts LRU tree pages, and tokens stay those of a
    cache-less engine."""
    tm = models[1]
    rs = np.random.RandomState(13)
    prompts = [rs.randint(0, 256, size=n).astype(np.int64)
               for n in (20, 9, 30, 14, 25, 20, 11, 30)]
    sp = SamplingParams(max_new_tokens=6)
    outs = {}
    for prefix in (True, False):
        eng = ServingEngine(tm, device="cpu", prefix_cache=prefix,
                            num_pages=12, **ENGINE)
        outs[prefix] = [r.token_ids for r in eng.generate(prompts, sp)]
        if prefix:
            assert eng.prefix_cache.evicted_pages_total > 0
        eng.pool.assert_quiesced()
    assert outs[True] == outs[False]


def test_cancel_timeout_and_queue_limit(models):
    from paddle_tpu_torch.serving import QueueFull, RequestState
    tm = models[1]
    eng = ServingEngine(tm, device="cpu", max_queue=2, **ENGINE)
    prompts = _prompts()
    a = eng.add_request(prompts[2], SamplingParams(max_new_tokens=20))
    b = eng.add_request(prompts[1], SamplingParams(max_new_tokens=20))
    with pytest.raises(QueueFull):
        eng.add_request(prompts[0])
    eng.step()               # both admitted; a's 17 tokens need 3 chunks
    assert a.state is RequestState.PREFILL
    assert eng.cancel(a.request_id)
    c = eng.add_request(prompts[0], SamplingParams(max_new_tokens=4))
    assert eng.cancel(c.request_id)  # still queued: drops at once
    assert c.finish_reason == "cancelled"
    d = eng.add_request(prompts[3], SamplingParams(timeout_s=1e-9))
    eng.run()
    assert d.finish_reason == "timeout" and not d.output_tokens
    assert a.finish_reason == "cancelled" and a.slot is None
    assert b.finish_reason == "length" and len(b.output_tokens) == 20
    assert not eng.cancel(b.request_id)
    eng.pool.assert_quiesced()
