"""Multi-tenant LoRA adapters in the port against the JAX package.

`AdapterStore` runs the JAX store's residency sequences — refcounts,
park, LRU spill to the host tier and restore, eviction without a host
tier — with the same returns and stats, and uploads the same padded
pages. Then `ServingEngine(model, adapters=True)` at the serving tests'
geometry (vocab 256, hidden 64, 2 layers, 4 heads; the JAX model's
weights moved by `convert.py`): three random adapters of
`make_random_lora` (numpy seeds, the same arrays registered in both
engines) serve a mixed-tenant batch with the adapter pool under
pressure, and the greedy tokens equal the JAX engine's, each winning
its step by a clear margin; the megakernel gate (K11 from the whole
pools) gives the same tokens; base rows equal an adapters-off engine's;
the prefix cache keeps one namespace per adapter; and a preempted
tenant's adapter reference drops and comes back on resume. The JAX
engine runs once per module, on its jnp paths; both use
grouped=False (the grouped walk is not under test here).
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
from paddle_tpu.serving import adapters as jadapters
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (AdapterStore, SamplingParams,
                                      ServingEngine, make_random_lora)

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
_GATES = ("PADDLE_TPU_UNIFIED_STEP", "PADDLE_TPU_PAGED_ATTN",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_PREEMPT", "PADDLE_TPU_MEGAKERNEL",
          "PADDLE_TPU_ADAPTERS", "PADDLE_TPU_PREFIX_CACHE")
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
# two adapter pages for three tenants: the batch spills and restores
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=16,
              grouped=False, adapters=True, adapter_pages=2)
NEW = 6
# f32 on both sides (test_torch_serving_legacy.py)
LOGIT_TOL = 1e-4


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


def _loras():
    """Three random adapters of ranks 2, 4 and 3 (bucket 4), amp 0.25:
    big enough to change greedy tokens of the tiny model."""
    return [make_random_lora(2, 64, 64, 64, rank=r,
                             rng=np.random.RandomState(10 + i), amp=0.25)
            for i, r in enumerate((2, 4, 3))]


def _jax_loras():
    return [jadapters.LoRAWeights(w.layers, rank=w.rank, alpha=w.alpha)
            for w in _loras()]


@pytest.fixture(scope="module")
def models():
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    for gate in _GATES:
        mp.delenv(gate, raising=False)
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


def _traffic():
    """Six prompts of 9-20 tokens (two share a 12-token start) and their
    tenants: adapters 1, 2, 3, the base model, 1 again, the base."""
    rs = np.random.RandomState(3)
    start = rs.randint(0, 256, size=12)
    prompts = [np.concatenate([start, rs.randint(0, 256, size=n)])
               if i in (0, 4) else rs.randint(0, 256, size=9 + n)
               for i, n in enumerate((3, 8, 5, 2, 6, 4))]
    return [p.astype(np.int64) for p in prompts], [1, 2, 3, 0, 1, 0]


def _register(eng, loras):
    return [eng.adapters.register(f"t{i}", w) for i, w in enumerate(loras)]


@pytest.fixture(scope="module")
def jax_tokens(models):
    eng = JaxEngine(models[0], **ENGINE)
    assert _register(eng, _jax_loras()) == [1, 2, 3]
    prompts, tenants = _traffic()
    out = eng.generate(prompts, [JaxSampling(max_new_tokens=NEW,
                                             adapter_id=a)
                                 for a in tenants])
    eng.drain()
    return [list(o.token_ids) for o in out]


class _Watched(ServingEngine):
    """Keeps the margin by which every emitted token won its held
    logits."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.margins = []
        self._held = None

    def _sample_next(self):
        self._held = self._last_logits.clone()
        return super()._sample_next()

    def _emit_tokens(self, slots, nxt, finished):
        top2 = torch.topk(self._held, 2, dim=-1).values
        for slot in slots:
            req = self.scheduler.running.get(int(slot))
            if req is not None and req.state.name == "DECODE":
                self.margins.append(float(top2[slot, 0] - top2[slot, 1]))
        super()._emit_tokens(slots, nxt, finished)


def _serve(tm, tenants=None, **opts):
    eng = _Watched(tm, device="cpu", **{**ENGINE, **opts})
    if eng.adapters is not None:
        assert _register(eng, _loras()) == [1, 2, 3]
    prompts, default = _traffic()
    out = eng.generate(prompts, [SamplingParams(max_new_tokens=NEW,
                                                adapter_id=a)
                                 for a in (tenants or default)])
    return eng, [list(o.token_ids) for o in out]


@pytest.mark.parametrize("megakernel", [False, True])
def test_tokens_match_the_jax_engine(models, jax_tokens, megakernel):
    """Through spill and restore of the adapter pool; with the gate on
    the deltas come from K11's plain version over the whole pools."""
    eng, got = _serve(models[1], megakernel=megakernel)
    assert eng.megakernel is megakernel
    assert got == jax_tokens
    assert min(eng.margins) > 2 * LOGIT_TOL, min(eng.margins)
    st = eng.adapters.stats()
    assert st["loads_total"] >= 3 and st["spills_total"] >= 1, st
    assert st["restores_total"] >= 1, st
    snap = eng.metrics.snapshot()
    assert snap["adapters_enabled"] and snap["megakernel"] is megakernel
    assert snap["adapters"]["requests_by_adapter"] == {"0": 2, "1": 2,
                                                       "2": 1, "3": 1}
    eng.drain()
    # the tenants' deltas change the streams
    assert got[0] != got[1] != got[2]


def test_base_rows_equal_an_adapters_off_engine(models, jax_tokens):
    _, base = _serve(models[1], tenants=[0] * 6, adapters=None,
                     adapter_pages=None)
    assert [base[3], base[5]] == [jax_tokens[3], jax_tokens[5]]
    assert base[0] != jax_tokens[0]


def test_prefix_cache_keeps_one_namespace_per_adapter(models):
    """The same prompt under another adapter misses the pages a tenant
    inserted; the same tenant hits them and repeats its tokens."""
    eng = ServingEngine(models[1], device="cpu", **ENGINE)
    a, b = _register(eng, _loras())[:2]
    prompt = np.arange(5, 25)
    sp = lambda aid: SamplingParams(max_new_tokens=4, adapter_id=aid)
    first = eng.generate([prompt], [sp(a)])[0]
    other = eng.generate([prompt], [sp(b)])[0]
    base = eng.generate([prompt], [sp(0)])[0]
    again = eng.generate([prompt], [sp(a)])[0]
    assert first.cached_tokens == other.cached_tokens == 0
    assert base.cached_tokens == 0
    assert again.cached_tokens > 0 and again.token_ids == first.token_ids
    assert eng.prefix_cache.lookups == 4 and eng.prefix_cache.hits == 1
    eng.drain()


def test_adapter_references_through_preemption_and_resume(models):
    """One adapter page, two tenants: a priority-0 arrival preempts the
    priority-5 resident, whose adapter reference drops (it spills when
    the other tenant needs the page) and comes back when it resumes;
    both streams equal runs that never preempt."""
    tm = models[1]
    geom = dict(device="cpu", num_slots=2, max_len=64, page_size=8,
                num_pages=6, chunk_len=16, grouped=False, adapters=True,
                adapter_pages=1)
    eng = ServingEngine(tm, **geom)
    a, b = _register(eng, _loras())[:2]
    lo = eng.add_request(np.arange(1, 9), SamplingParams(
        max_new_tokens=24, priority=5, adapter_id=a))
    for _ in range(6):
        eng.step()
    assert eng.adapters.pool.refcount(lo._adapter_binding[0]) == 1
    hi = eng.add_request(np.arange(30, 38), SamplingParams(
        max_new_tokens=24, priority=0, adapter_id=b))
    eng.run()
    eng.drain()
    assert lo.preemptions >= 1 and not lo._adapter_held
    st = eng.adapters.stats()
    assert st["spills_total"] >= 1 and st["restores_total"] >= 1, st
    want = []
    for prompt, aid in ((np.arange(1, 9), a), (np.arange(30, 38), b)):
        alone = ServingEngine(tm, **{**geom, "adapter_pages": 2})
        _register(alone, _loras())
        want.append(alone.generate([prompt], [SamplingParams(
            max_new_tokens=24, adapter_id=aid)])[0].token_ids)
    assert [lo.output_tokens, hi.output_tokens] == want


def test_unknown_adapter_ids_raise_as_in_jax(models):
    eng = ServingEngine(models[1], device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="unknown adapter_id 1"):
        eng.add_request([1, 2, 3], SamplingParams(adapter_id=1))
    plain = ServingEngine(models[1], device="cpu", max_len=64, chunk_len=16)
    with pytest.raises(ValueError, match="no adapter subsystem"):
        plain.add_request([1, 2, 3], SamplingParams(adapter_id=2))
    with pytest.raises(ValueError, match="adapter_id must be >= 0"):
        SamplingParams(adapter_id=-1)


# -- the store alone -----------------------------------------------------------
def _toy(seed, rank=4):
    return make_random_lora(1, 4, 4, 4, rank=rank,
                            rng=np.random.RandomState(seed), amp=0.5)


def _stores(**kw):
    t = AdapterStore(1, 4, 4, 4, **kw)
    j = jadapters.AdapterStore(1, 4, 4, 4, **kw)
    return t, j


def _same_pools(t, j):
    for tp, jp in zip(t.pools, j.pools):
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_store_refcount_park_spill_restore_matches_jax():
    t, j = _stores(num_pages=3)
    ws = [_toy(1), _toy(2, rank=3), _toy(3, rank=2)]
    ids = [(t.register(f"a{i}", w), j.register(
        f"a{i}", jadapters.LoRAWeights(w.layers, rank=w.rank)))
        for i, w in enumerate(ws)]
    assert [i for i, _ in ids] == [jd for _, jd in ids] == [1, 2, 3]
    a1, a2, a3 = (i for i, _ in ids)
    steps = [("acquire", a1), ("acquire", a1), ("release", a1),
             ("release", a1), ("acquire", a2), ("acquire", a3),
             ("acquire", a1), ("release", a2), ("acquire", a1),
             ("release", a1), ("release", a3), ("acquire", 0)]
    for op, aid in steps:
        got, want = getattr(t, op)(aid), getattr(j, op)(aid)
        assert got == want, (op, aid)
        assert t.stats() == j.stats(), (op, aid)
        assert t.debug() == j.debug()
    _same_pools(t, j)
    st = t.stats()
    # a1 spills for a3, then a2 for a1's restore
    assert st["spills_total"] == 2 and st["restores_total"] == 1
    t.assert_quiesced()
    with pytest.raises(ValueError, match="unknown adapter_id"):
        t.acquire(42)
    with pytest.raises(ValueError, match="exceeds the largest rank bucket"):
        t.register("big", _toy(4, rank=9))
    with pytest.raises(ValueError, match="already registered"):
        t.register("a0", _toy(5))


def test_store_eviction_without_host_tier_matches_jax():
    t, j = _stores(num_pages=2, host_pages=0)
    for st in (t, j):
        a1 = st.register("a1", _toy(1))
        a2 = st.register("a2", _toy(2))
        st.acquire(a1)
        st.release(a1)
        st.acquire(a2)          # displaces a1: evicted, the host is full
        st.release(a2)
        assert st.acquire(a1) is not None   # re-uploaded from the registry
        st.release(a1)
        st.assert_quiesced()
    assert t.stats() == j.stats()
    assert t.stats()["evictions_total"] == 2 and t.stats()["loads_total"] == 3
    _same_pools(t, j)
