"""The embeddings lane and session pins in the port's serving engine,
against the JAX package.

Embeddings: tiny f32 GPT and Llama models (weights moved across by
`convert.py`, the JAX GPT on its jnp paths) serve embed requests beside
generating ones in the port and in the JAX engine; each embedding is the
JAX engine's within EMBED_TOL, the generating rows' tokens are the JAX
engine's and those of a run without the embed rows, and the embedding is
the model's own last hidden state over the prompt. The epilogue writes
its recomputed K/V into the live pool, so the page it writes is saved and
restored: every byte of every pool is the same before and after it, in
the float, int8 and e4m3 pools and on the gather branch. The lane's
refusals and its zero output budget are the JAX engine's.

Session pins: tests/test_serving_grammar.py's TestSessionPinning on the
port's tree and engine (a pin holds a chain above LRU until the
injectable clock passes its TTL; re-pinning extends; `clear()` drops
pins), the tree's stats equal the JAX tree's through the same sequence,
and an engine's session request pins the JAX engine's page count.
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
from paddle_tpu.serving import PagePool as JaxPagePool
from paddle_tpu.serving import RadixPrefixCache as JaxRadix
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM)
from paddle_tpu_torch.serving import (PagePool, RadixPrefixCache,
                                      SamplingParams, ServingEngine,
                                      prometheus_render)
from paddle_tpu_torch.serving.engine import model_backbone

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GPT_GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=128)
LLAMA_GEOMETRY = dict(vocab_size=89, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=48, max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=16)
JAX_GATES = dict(obs=False, slo=False, cost_census=False)
_GATES = ("PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_PAGED_ATTN", "PADDLE_TPU_GROUPED_ATTN",
          "PADDLE_TPU_KV_DTYPE", "PADDLE_TPU_PREEMPT",
          "PADDLE_TPU_MEGAKERNEL", "PADDLE_TPU_ADAPTERS",
          "PADDLE_TPU_PREFIX_CACHE", "PADDLE_TPU_GRAMMAR")
NEW = 10
# f32 on both sides, summed in different orders through two layers and
# the final norm: an embedding element's tolerance against the JAX
# engine's and against the plain backbone, EMBED_TOL x (1 + max|ref|)
EMBED_TOL = 1e-4


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
    """{"gpt": (JAX GPT, port GPT), "llama": (JAX Llama, port Llama)},
    each pair on the same weights; the JAX GPT on its jnp paths."""
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


def traffic(vocab, seed=0):
    """Embed and generating requests interleaved, prompts of 5-30 tokens
    (some past one chunk), the last embed prompt a repeat of the first
    (a prefix-cache hit once the first retired)."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, vocab, size=int(n)).astype(np.int64)
               for n in (13, 7, 30, 5, 21, 17, 9)]
    prompts.append(prompts[0].copy())
    embed = [True, False, True, False, True, False, False, True]
    return prompts, embed


def _run(eng, side, prompts, embed, keep=None):
    cls = SamplingParams if side == "port" else JaxSampling
    outs = eng.generate(
        [p for p, e in zip(prompts, embed) if keep is None or keep(e)],
        [cls(embed=True) if e else cls(max_new_tokens=NEW)
         for e in embed if keep is None or keep(e)])
    eng.drain()
    return outs


def _close(got, want):
    want = np.asarray(want, np.float64)
    tol = EMBED_TOL * (1.0 + np.abs(want).max())
    return float(np.abs(np.asarray(got, np.float64) - want).max()), tol


@pytest.fixture(scope="module")
def jax_embeds(models):
    out = {}
    for name in ("gpt", "llama"):
        jm = models[name][0]
        vocab = jm.config.vocab_size
        out[name] = _run(JaxEngine(jm, **ENGINE, **JAX_GATES), "jax",
                         *traffic(vocab))
    return out


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_embeddings_and_tokens_equal_jax(models, jax_embeds, name):
    jm, tm = models[name]
    prompts, embed = traffic(tm.config.vocab_size)
    got = _run(ServingEngine(tm, device="cpu", **ENGINE), "port", prompts,
               embed)
    want = jax_embeds[name]
    hidden = tm.config.hidden_size
    for g, w, e, p in zip(got, want, embed, prompts):
        assert g.finish_reason == w.finish_reason
        assert g.cached_tokens == w.cached_tokens
        if e:
            assert g.token_ids == [] and g.finish_reason == "stop"
            assert g.embedding.dtype == np.float32
            assert g.embedding.shape == (hidden,)
            err, tol = _close(g.embedding, w.embedding)
            assert err <= tol, (err, tol)
            # the model's own last hidden state over the prompt
            with torch.no_grad():
                ref = model_backbone(tm)(torch.from_numpy(p)[None])[0, -1]
            err, tol = _close(g.embedding, ref.double().numpy())
            assert err <= tol, (err, tol)
        else:
            assert g.embedding is None
            assert g.token_ids == w.token_ids
    # the repeated prompt hit the first's pages and pooled its vector
    assert got[-1].cached_tokens > 0
    err, tol = _close(got[-1].embedding, got[0].embedding)
    assert err <= tol
    # the generating rows are those of a run without the embed rows
    alone = _run(ServingEngine(tm, device="cpu", **ENGINE), "port",
                 prompts, embed, keep=lambda e: not e)
    assert [o.token_ids for o in alone] == \
        [g.token_ids for g, e in zip(got, embed) if not e]


class _Watched(ServingEngine):
    """Copies every pool around each embed epilogue."""

    def _embed_rows(self, rows):
        before = [[(k.clone(), v.clone()) for k, v in plane]
                  for plane in self._planes]
        super()._embed_rows(rows)
        self.epilogues = getattr(self, "epilogues", 0) + 1
        for plane, copies in zip(self._planes, before):
            for (k, v), (k0, v0) in zip(plane, copies):
                assert torch.equal(k, k0) and torch.equal(v, v0)


@pytest.mark.parametrize("opts", [
    {}, dict(kv_dtype="int8"), dict(kv_dtype="fp8"),
    dict(attn_impl="gather"), dict(grouped=False, megakernel=True)],
    ids=["fp", "int8", "fp8", "gather", "megakernel"])
@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_the_epilogue_leaves_every_pool_byte(models, name, opts):
    """The epilogue's recomputed K/V lands in the live pool (the walk
    reads it there), and the saved page goes back: the pools hold the
    prefill's bytes. The embeddings are deterministic and finite in every
    lane, and a float pool's equal the fp engine's."""
    tm = models[name][1]
    prompts, embed = traffic(tm.config.vocab_size, seed=1)
    eng = _Watched(tm, device="cpu", **ENGINE, **opts)
    outs = _run(eng, "port", prompts, embed)
    assert eng.epilogues >= 2
    vecs = [o.embedding for o, e in zip(outs, embed) if e]
    assert all(np.isfinite(v).all() for v in vecs)
    again = _run(_Watched(tm, device="cpu", **ENGINE, **opts), "port",
                 prompts, embed)
    for a, b in zip(outs, again):
        assert a.token_ids == b.token_ids
        if a.embedding is not None:
            assert np.array_equal(a.embedding, b.embedding)
    if opts.get("kv_dtype") is None:
        fp = _run(ServingEngine(tm, device="cpu", **ENGINE), "port",
                  prompts, embed)
        for a, b in zip(outs, fp):
            if a.embedding is not None:
                err, tol = _close(a.embedding, b.embedding)
                assert err <= tol


def test_embed_refusals_and_budget_equal_jax(models):
    jm, tm = models["gpt"]
    small = dict(num_slots=2, max_len=32, page_size=8, chunk_len=8)
    prompt = np.arange(1, 25, dtype=np.int64)
    # prompt + max_new_tokens past max_len: an embed request reserves no
    # output, so both engines take it and serve it
    for eng, cls in ((ServingEngine(tm, device="cpu", **small),
                      SamplingParams),
                     (JaxEngine(jm, **small, **JAX_GATES), JaxSampling)):
        req = eng.add_request(prompt, cls(embed=True, max_new_tokens=64))
        eng.run()
        assert req.finish_reason == "stop" and req.embedding is not None
        with pytest.raises(ValueError, match="exceeds engine max_len"):
            eng.add_request(prompt, cls(max_new_tokens=64))
        eng.drain()
    errs = []
    for eng, cls in ((ServingEngine(tm, device="cpu", unified=False,
                                    **small), SamplingParams),
                     (JaxEngine(jm, unified=False, **small, **JAX_GATES),
                      JaxSampling)):
        with pytest.raises(ValueError) as e:
            eng.add_request(prompt[:5], cls(embed=True))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_embed_timeline_and_metrics(models):
    tm = models["gpt"][1]
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    req = eng.add_request(np.arange(3, 40), SamplingParams(embed=True))
    eng.run()
    kinds = [e["kind"] for e in eng.obs.tracer.timeline(req.request_id)]
    assert kinds[-2:] == ["embed", "finish"] and "decode" not in kinds
    embed_ev = [e for e in eng.obs.tracer.timeline(req.request_id)
                if e["kind"] == "embed"][0]
    assert embed_ev["hidden"] == tm.config.hidden_size
    snap = eng.metrics.snapshot()
    assert snap["requests"]["completed"] == 1
    assert snap["tokens_generated"] == 0
    # the prompt's pages went into the prefix cache
    assert eng.prefix_cache.stats()["inserted_pages"] == 37 // 8 + 1
    eng.drain()
    eng.pool.assert_quiesced()


# -- session pins ----------------------------------------------------------
PS = 4


def test_pin_blocks_eviction_until_ttl():
    t = [0.0]
    pool = PagePool(5)          # page 0 is the reserved trash page
    cache = RadixPrefixCache(pool, PS, clock=lambda: t[0])
    seq_a = np.arange(100, 108)       # 2 full pages
    seq_b = np.arange(200, 208)       # 2 full pages
    pages_a, pages_b = pool.alloc(2), pool.alloc(2)
    cache.insert(seq_a, pages_a, seq_a.size)
    cache.insert(seq_b, pages_b, seq_b.size)
    assert cache.pin(seq_a, ttl_s=10.0) == 2
    assert cache.stats()["pinned_pages"] == 2
    # a 3-page acquire must evict: only seq_b's 2 pages may go, so it
    # refuses rather than touch the session's pages
    assert cache.acquire(np.arange(300, 312), max_new_tokens=0) is None
    assert cache.stats()["pinned_pages"] == 2
    # the pin ends at its deadline on the injectable clock, no sweep
    t[0] = 20.0
    assert cache.stats()["pinned_pages"] == 0
    grant = cache.acquire(np.arange(300, 312), max_new_tokens=0)
    assert grant is not None
    cache.release(grant.pages)
    regrant = cache.acquire(seq_a, max_new_tokens=0)
    assert regrant is not None and regrant.cached_len < 7
    cache.release(regrant.pages)


def test_pin_noop_cases_extension_and_clear():
    t = [0.0]
    pool = PagePool(8)
    cache = RadixPrefixCache(pool, PS, clock=lambda: t[0])
    assert cache.pin(np.arange(8), ttl_s=5.0) == 0   # nothing cached
    cache.insert(np.arange(50, 58), pool.alloc(2), 8)
    assert cache.pin(np.arange(50, 58), ttl_s=0.0) == 0      # no TTL
    assert cache.pin(np.arange(50, 58), ttl_s=10.0) == 2
    assert cache.pin(np.arange(50, 54), ttl_s=1.0) == 1  # never shortens
    t[0] = 5.0
    assert cache.pinned_pages == 2
    # a pinned page is neither spilled nor evicted
    cache.set_host_tier(lambda page: 1, lambda slot: None, lambda s: None)
    assert cache.spill(2) == 0 and cache.evict(2) == 0
    assert cache.clear() == 2 and cache.pinned_pages == 0
    assert cache.tree_pages == 0


def _pin_script(pool_cls, cache_cls):
    """One sequence of tree operations; the stats after each."""
    t = [0.0]
    pool = pool_cls(14)
    cache = cache_cls(pool, PS, clock=lambda: t[0])
    rng = np.random.RandomState(4)
    seqs = [rng.randint(0, 50, size=12) for _ in range(4)]
    out = []
    for i, seq in enumerate(seqs):
        cache.insert(seq, pool.alloc(3), seq.size)
        out.append(cache.pin(seq[:8 + i], ttl_s=3.0 + i))
        t[0] += 1.0
        out.append(dict(cache.stats()))
    grant = cache.acquire(rng.randint(60, 90, size=20), max_new_tokens=4)
    out.append(None if grant is None else grant.cached_len)
    t[0] += 4.0
    out.append(dict(cache.stats()))
    out.append(cache.lookup(seqs[3]))
    out.append(cache.clear())
    out.append(dict(cache.stats()))
    return out


def test_tree_pins_equal_jax():
    assert _pin_script(PagePool, RadixPrefixCache) == \
        _pin_script(JaxPagePool, JaxRadix)


def test_session_request_pins_its_pages_as_jax(models):
    jm, tm = models["gpt"]
    prompt = np.arange(1, 18, dtype=np.int64)           # 2+ full pages
    stats = []
    for side in ("port", "jax"):
        t = [0.0]
        if side == "port":
            eng = ServingEngine(tm, device="cpu", clock=lambda: t[0],
                                session_ttl_s=30.0, **ENGINE)
            sp = SamplingParams(max_new_tokens=4, session="s-1")
        else:
            eng = JaxEngine(jm, clock=lambda: t[0], session_ttl_s=30.0,
                            **ENGINE, **JAX_GATES)
            sp = JaxSampling(max_new_tokens=4, session="s-1")
        eng.generate([prompt], sp)
        pinned = eng.prefix_cache.stats()["pinned_pages"]
        eng.step()                            # pushes the stats gauge
        text = prometheus_render({"0": eng.metrics.snapshot()}) \
            if side == "port" else ""
        t[0] = 100.0                          # past the TTL
        stats.append((pinned, eng.prefix_cache.stats()["pinned_pages"]))
        if side == "port":
            assert "paddle_serving_prefix_pinned_pages" in text
            assert f"paddle_serving_prefix_pinned_pages{{replica=\"0\"}} " \
                f"{pinned}" in text
        eng.drain()
    assert stats[0] == stats[1] and stats[0][0] >= 2 and stats[0][1] == 0


def test_pinned_turn_one_survives_the_pressure_that_evicts_it_unpinned(
        models):
    """The contract the pin is for: twelve other requests through a pool
    sized so that they evict turn 1's pages; with the pin turn 2 hits
    every full page, after the TTL the same pressure leaves it cold."""
    tm = models["gpt"][1]
    rng = np.random.RandomState(9)
    turn1 = rng.randint(0, 97, size=26).astype(np.int64)
    others = [rng.randint(0, 97, size=26).astype(np.int64)
              for _ in range(12)]
    hits = []
    for expire in (False, True):
        t = [0.0]
        eng = ServingEngine(tm, device="cpu", clock=lambda: t[0],
                            num_slots=2, max_len=48, page_size=8,
                            chunk_len=16, num_pages=12, host_pages=0)
        out = eng.generate([turn1], SamplingParams(max_new_tokens=6,
                                                   session="chat"))[0]
        if expire:
            t[0] = 31.0
        eng.generate(others, SamplingParams(max_new_tokens=6))
        turn2 = np.concatenate([turn1, out.token_ids, [5, 6, 7]])
        hits.append(eng.generate([turn2], SamplingParams(
            max_new_tokens=2))[0].cached_tokens)
        eng.drain()
    assert hits[0] == (26 + 6) // 8 * 8 and hits[1] == 0
