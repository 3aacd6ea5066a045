"""`ServingEngine` serving Llama in the port, against the JAX engine.

The tiny Llama of tests/test_serving.py (vocab 89, hidden 32, 2 layers,
4 heads over 2 kv heads: GQA at rep 2, per-row rope offsets), its
RMSNorm weights and biases perturbed and moved by `convert.py`. Six
prompts (the first and the last two sharing a 12-token start: the last
two attach the first's cached pages and form a group in the grouped
walk) serve in each arm: the defaults, grouped=False, int8 pools, the
legacy step (unified=False), the megakernel on, and LoRA adapters with
the megakernel off and on (tests/test_serving_adapters.py's Llama
case: separate q/k/v/o projections, the deltas before rope). Each arm's
greedy tokens equal the JAX engine's in the same arm (built once per
module), each winning its step by a clear margin; the megakernel gives
the gate-off tokens; with adapters under the megakernel each of the four
deltas is applied once a layer (K11 standalone) and the fused op runs
without its LoRA prologue. Then tests/test_serving.py's staggered joins:
requests that join a running engine step by step decode the tokens they
decode alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.nlp.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import adapters as jadapters
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nlp import generation as tgen
from paddle_tpu_torch.nlp import llama as tllama
from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                      make_random_lora)

GEOMETRY = dict(vocab_size=89, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                intermediate_size=48, max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=16)
_GATES = ("PADDLE_TPU_UNIFIED_STEP", "PADDLE_TPU_PAGED_ATTN",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_PREEMPT", "PADDLE_TPU_MEGAKERNEL",
          "PADDLE_TPU_ADAPTERS", "PADDLE_TPU_PREFIX_CACHE")
ARMS = {"defaults": {}, "grouped_off": dict(grouped=False),
        "int8": dict(kv_dtype="int8"), "legacy": dict(unified=False),
        "megakernel": dict(megakernel=True),
        "adapters": dict(grouped=False, adapters=True, adapter_pages=2),
        "adapters_megakernel": dict(grouped=False, adapters=True,
                                    adapter_pages=2, megakernel=True)}
TENANTS = [1, 0, 1, 2, 0, 2]
NEW = 6
# f32 on both sides (tests/test_torch_llama.py)
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    mp = pytest.MonkeyPatch()
    for gate in _GATES:
        mp.delenv(gate, raising=False)
    try:
        paddle.seed(11)
        jm = JaxLlama(JaxLlamaConfig(**GEOMETRY))
        jm.eval()
        rs = np.random.RandomState(5)
        params = {k: v.numpy() for k, v in jm.state_dict().items()}
        for name, arr in params.items():
            if name.endswith("norm.weight"):
                params[name] = (1 + 0.3 * rs.randn(*arr.shape)).astype(
                    arr.dtype)
            elif name.endswith(".bias"):
                params[name] = (0.02 * rs.randn(*arr.shape)).astype(
                    arr.dtype)
        jm.set_state_dict(params)
        tm = LlamaForCausalLM(LlamaConfig(**GEOMETRY), device="cpu")
        tm.load_state_dict(convert.from_paddle_state_dict(params))
        tm.eval()
        yield jm, tm
    finally:
        mp.undo()


def _loras():
    """Two rank-4 adapters over the separate projections (q out 32, k
    and v out 16), amp 0.2 (tests/test_serving_adapters.py)."""
    return [make_random_lora(2, 32, 32, 16, rank=4,
                             rng=np.random.RandomState(9 + i), amp=0.2)
            for i in range(2)]


def _prompts():
    rs = np.random.RandomState(3)
    start = rs.randint(0, 89, size=12)
    return [(np.concatenate([start, rs.randint(0, 89, size=n)])
             if i in (0, 4, 5) else rs.randint(0, 89, size=9 + n)).astype(
                 np.int64)
            for i, n in enumerate((3, 8, 5, 2, 6, 4))]


def _tenants(opts):
    return TENANTS if opts.get("adapters") else [0] * len(TENANTS)


@pytest.fixture(scope="module")
def jax_tokens(models):
    out = {}
    for arm, opts in ARMS.items():
        eng = JaxEngine(models[0], **ENGINE, **opts)
        if opts.get("adapters"):
            for i, w in enumerate(_loras()):
                eng.adapters.register(f"t{i}", jadapters.LoRAWeights(
                    w.layers, rank=w.rank, alpha=w.alpha))
        res = eng.generate(_prompts(), [JaxSampling(max_new_tokens=NEW,
                                                    adapter_id=a)
                                        for a in _tenants(opts)])
        out[arm] = [list(r.token_ids) for r in res]
    return out


class _Watched(ServingEngine):
    """Keeps the margin by which every decoded token won its held
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


def _serve(tm, opts):
    eng = _Watched(tm, device="cpu", **ENGINE, **opts)
    if eng.adapters is not None:
        assert [eng.adapters.register(f"t{i}", w)
                for i, w in enumerate(_loras())] == [1, 2]
    out = eng.generate(_prompts(), [SamplingParams(max_new_tokens=NEW,
                                                   adapter_id=a)
                                    for a in _tenants(opts)])
    return eng, [list(o.token_ids) for o in out]


@pytest.mark.parametrize("arm", list(ARMS))
def test_tokens_match_the_jax_engine(models, jax_tokens, arm):
    eng, got = _serve(models[1], ARMS[arm])
    assert got == jax_tokens[arm]
    assert eng.margins and min(eng.margins) > 2 * LOGIT_TOL, \
        min(eng.margins)
    if arm == "defaults":
        assert eng.grouped and eng.metrics.snapshot()[
            "group_size_per_step"]["max"] >= 2
    if arm == "megakernel":
        assert eng.megakernel and got == jax_tokens["defaults"]
    if arm == "adapters_megakernel":
        assert eng.megakernel and got == jax_tokens["adapters"]
    if arm.startswith("adapters"):
        base = jax_tokens["grouped_off"]
        assert all((got[i] != base[i]) == (a != 0)
                   for i, a in enumerate(TENANTS))
    eng.drain()


def test_megakernel_applies_each_delta_once(models, monkeypatch):
    """Under the megakernel with adapters, Llama adds its q, k, v and o
    deltas through four `lora_delta_paged` calls a layer (K11 on the
    card), and the fused op takes no LoRA operands: a delta applied in
    both places would change no shape."""
    calls, fused = [], []
    real_delta = tllama.lora_delta_paged
    real_fused = tgen.megakernel_decode

    def delta(*args):
        calls.append(args[1].shape)
        return real_delta(*args)

    def fused_op(*args, **opts):
        fused.append((len(args), opts))
        return real_fused(*args, **opts)

    monkeypatch.setattr(tllama, "lora_delta_paged", delta)
    monkeypatch.setattr(tgen, "megakernel_decode", fused_op)
    eng, _ = _serve(models[1], ARMS["adapters_megakernel"])
    steps = eng.metrics.unified_steps
    n_layers = GEOMETRY["num_hidden_layers"]
    assert len(calls) == 4 * n_layers * steps
    # q, k, v from the hidden size, o from the heads' width
    assert [s[1] for s in calls[:4]] == [32, 32, 32, 32]
    assert len(fused) == n_layers * steps
    assert all(not o["lora"] and not o["grouped"] and n == 8
               for n, o in fused)


def test_staggered_joins_decode_as_alone(models):
    """tests/test_serving.py's GQA/rotary case: three requests joining a
    running engine a step apart each decode the tokens `generate` gives
    it alone (per-row rope offsets in the unified step)."""
    tm = models[1]
    prompts = [np.array([3, 14, 15, 9], np.int64),
               np.array([26, 5, 35], np.int64), np.array([7, 8], np.int64)]
    want = [tm.generate(torch.from_numpy(p[None]),
                        max_new_tokens=NEW)[0, p.size:].tolist()
            for p in prompts]
    eng = ServingEngine(tm, device="cpu", num_slots=3, max_len=48)
    reqs = []
    for p in prompts:
        reqs.append(eng.add_request(p, SamplingParams(max_new_tokens=NEW)))
        eng.step()
    while eng.has_work:
        eng.step()
    assert [list(r.output_tokens) for r in reqs] == want
    assert all(r.finish_reason == "length" for r in reqs)
