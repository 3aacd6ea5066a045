"""The port's engine at the shapes its walks and K11 took on the card only
after F8 and F9 were repaired, against the JAX engine.

One GPT at head dim 40 (vocab 256, hidden 80, 2 layers, 2 heads, 320
positions; the JAX model's weights moved by `convert.py`) serves:
- F8: LoRA adapters in rank buckets (8, 32), so the pool rank is 32
  (K11's ranks past one k-step of 16), with the megakernel off and on;
- F9: pages of 256 keys (a page K6, K9 and K10 fold in two pieces of
  128 on the card) with prompts past 128 tokens, at the engine's
  defaults; and an int8 pool at head dim 40 (rows of 40 bytes, which the
  card's walks copy 8 bytes at a time).
The greedy tokens must equal the JAX engine's, each winning its step by
a clear margin. Both run on the CPU, the port through its kernels'
plain versions, the JAX engine on its jnp paths; each JAX engine runs
once per module.
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
from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                      make_random_lora)

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
_GATES = ("PADDLE_TPU_UNIFIED_STEP", "PADDLE_TPU_PAGED_ATTN",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_PREEMPT", "PADDLE_TPU_MEGAKERNEL",
          "PADDLE_TPU_ADAPTERS", "PADDLE_TPU_PREFIX_CACHE")
# head dim 40
GEOMETRY = dict(vocab_size=256, hidden_size=80, num_hidden_layers=2,
                num_attention_heads=2, max_position_embeddings=320)
NEW = 5
# f32 on both sides (test_torch_serving_legacy.py)
LOGIT_TOL = 1e-4
# the runs: engine options, and whether the traffic is long (prompts of
# 140-230 tokens, past one 128-key piece) and carries adapters
RUNS = {
    "adapters_r32": (dict(num_slots=4, max_len=64, page_size=8,
                          chunk_len=16, grouped=False, adapters=True,
                          adapter_pages=3, adapter_ranks=(8, 32)),
                     False, True),
    "page_256": (dict(num_slots=4, max_len=300, page_size=256,
                      chunk_len=32), True, False),
    "int8_d40": (dict(num_slots=4, max_len=64, page_size=8, chunk_len=16,
                      kv_dtype="int8"), False, False),
}


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


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
        paddle.seed(2)
        jm = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0,
                                 initializer_range=0.2, **GEOMETRY))
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


def _loras():
    """Adapters of ranks 8, 32 and 20 (buckets 8, 32, 32: a pool of rank
    32), amp 0.25: big enough to change greedy tokens."""
    return [make_random_lora(2, 80, 80, 80, rank=r,
                             rng=np.random.RandomState(20 + i), amp=0.25)
            for i, r in enumerate((8, 32, 20))]


def _traffic(long: bool, adapters: bool):
    """Four prompts (of 140-230 tokens when `long`, two sharing a
    start, else 9-20) and their sampling: greedy, tenants 1, 2, 3 and the
    base model when `adapters`."""
    rs = np.random.RandomState(7)
    lens = (150, 230, 140, 190) if long else (12, 20, 9, 15)
    start = rs.randint(0, 256, size=min(lens) - 4)
    prompts = [np.concatenate([start, rs.randint(0, 256, size=n - len(start))])
               if i in (0, 3) else rs.randint(0, 256, size=n)
               for i, n in enumerate(lens)]
    tenants = (1, 2, 3, 0) if adapters else (0, 0, 0, 0)
    return [p.astype(np.int64) for p in prompts], tenants


@pytest.fixture(scope="module")
def jax_tokens(models):
    """Each run's greedy tokens from the JAX engine, once per module."""
    out = {}
    for name, (opts, long, adapters) in RUNS.items():
        eng = JaxEngine(models[0], **opts)
        if adapters:
            assert [eng.adapters.register(f"t{i}", jadapters.LoRAWeights(
                w.layers, rank=w.rank, alpha=w.alpha))
                for i, w in enumerate(_loras())] == [1, 2, 3]
        prompts, tenants = _traffic(long, adapters)
        res = eng.generate(prompts, [JaxSampling(max_new_tokens=NEW,
                                                 adapter_id=a)
                                     for a in tenants])
        eng.drain()
        out[name] = [list(r.token_ids) for r in res]
    return out


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


def _serve(tm, name, **extra):
    opts, long, adapters = RUNS[name]
    eng = _Watched(tm, device="cpu", **opts, **extra)
    if adapters:
        assert [eng.adapters.register(f"t{i}", w)
                for i, w in enumerate(_loras())] == [1, 2, 3]
    prompts, tenants = _traffic(long, adapters)
    res = eng.generate(prompts, [SamplingParams(max_new_tokens=NEW,
                                                adapter_id=a)
                                 for a in tenants])
    eng.drain()
    return eng, [list(r.token_ids) for r in res]


@pytest.mark.parametrize("megakernel", [False, True])
def test_rank_32_adapters_match_the_jax_engine(models, jax_tokens,
                                               megakernel):
    """F8: a pool of rank 32 (K11 sums d over two k-steps of 16 on the
    card); with the gate on the q/k/v deltas come from K11's plain
    version over the whole pools."""
    eng, got = _serve(models[1], "adapters_r32", megakernel=megakernel)
    assert eng.megakernel is megakernel
    assert eng.adapters.rank == 32
    assert got == jax_tokens["adapters_r32"]
    assert min(eng.margins) > 2 * LOGIT_TOL, min(eng.margins)
    assert len({tuple(t) for t in got}) == 4   # the tenants differ


@pytest.mark.parametrize("name", ["page_256", "int8_d40"])
def test_page_256_and_int8_head_dim_40_match_the_jax_engine(models,
                                                            jax_tokens,
                                                            name):
    """F9: pages of 256 keys holding prompts past 128 tokens, and int8
    pools at head dim 40, at the engine's defaults (the grouped walk,
    the prefix cache, preemption)."""
    eng, got = _serve(models[1], name)
    assert eng.page_size == RUNS[name][0]["page_size"]
    assert got == jax_tokens[name]
    assert min(eng.margins) > 2 * LOGIT_TOL, min(eng.margins)
