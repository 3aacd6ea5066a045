"""Attention at head dims the flash kernels do not take, and the gather
branch's output type over 1-byte pools, against the JAX package.

The route (ROADMAP queue 3, F4): as the JAX `_use_pallas` chooses by head
dim, the port's SDPA takes the flash attention op (K3-K5 on the card)
at head dims 64, 128 and 256, and its plain `_sdpa_ref` at any other,
chosen before any launch. A GPT at head dim 32 (hidden 64, 2 heads)
serves through the legacy step's prefill chunks and the gather arm, and
decodes through `generate()`, by that route, with the JAX engine's and
the JAX method's tokens. The gather branch over int8 and fp8 pools
(F7) returns f32 as the JAX function does, and a bf16 GPT at head dim
32 on the legacy step over int8 pools — whose prefill chunks take that
branch and then run their later layers in f32 by jnp's promotion —
gives the JAX engine's greedy tokens, each winning its step by more
than the bf16 tolerance below. The JAX engines run once per module.
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
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
from paddle_tpu_torch.nlp import generation as tgen
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
_GATES = ("PADDLE_TPU_UNIFIED_STEP", "PADDLE_TPU_PAGED_ATTN",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_PREEMPT", "PADDLE_TPU_MEGAKERNEL")
# head dim 32
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=2, max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=16)
NEW = 6
# f32 on both sides (test_torch_serving_legacy.py)
LOGIT_TOL = 1e-4
# bf16 weights and activations: the frameworks round at other places
# (the JAX LayerNorm takes one-pass statistics, the port two-pass; sums
# in other orders), a few bf16 ulps of logits of magnitude ~1
BF16_LOGIT_TOL = 3e-2


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def models():
    """The JAX GPT at head dim 32 and its port (f32), and both in bf16."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    for gate in _GATES:
        mp.delenv(gate, raising=False)
    try:
        paddle.seed(1)
        jm = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0,
                                 initializer_range=0.2, **GEOMETRY))
        jm.eval()
        params = {k: v.numpy() for k, v in jm.state_dict().items()}
        tm = GPTForCausalLM(GPTConfig(**GEOMETRY), device="cpu")
        tm.load_state_dict(convert.from_paddle_state_dict(params))
        tm.eval()
        jb = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0,
                                 initializer_range=0.2, **GEOMETRY))
        jb.set_state_dict(jm.state_dict())
        jb.bfloat16()
        jb.eval()
        tb = GPTForCausalLM(GPTConfig(**GEOMETRY), device="cpu",
                            dtype=torch.bfloat16)
        tb.load_state_dict(convert.from_paddle_state_dict(
            {k: v.numpy() for k, v in jb.state_dict().items()}))
        tb.eval()
        yield jm, tm, jb, tb
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def _prompts():
    rs = np.random.RandomState(4)
    system = rs.randint(0, 256, size=20)
    return [np.concatenate([system, rs.randint(0, 256, size=n)])
            .astype(np.int64) for n in (3, 9, 5, 12)]


class _Watched(ServingEngine):
    """Keeps the margin by which every emitted token won its held
    logits, on either step."""

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


class _Spy:
    """Counts the calls of the flash op and of the plain `_sdpa_ref`."""

    def __init__(self, mp):
        self.flash = self.ref = 0
        flash, ref = PF.attention.flash_attention_blhd, PF.attention._sdpa_ref

        def spy_flash(*a, **kw):
            self.flash += 1
            return flash(*a, **kw)

        def spy_ref(*a, **kw):
            self.ref += 1
            return ref(*a, **kw)
        mp.setattr(PF.attention, "flash_attention_blhd", spy_flash)
        mp.setattr(PF.attention, "_sdpa_ref", spy_ref)


@pytest.mark.parametrize("d,flash", [(16, False), (32, False), (64, True),
                                     (80, False), (128, True), (256, True)])
def test_the_route_is_chosen_by_head_dim(monkeypatch, d, flash):
    assert PF.attention.uses_flash_kernel(d) is flash
    assert (d in tfa.HEAD_DIMS) is flash
    spy = _Spy(monkeypatch)
    rs = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rs.randn(2, 5, 2, d).astype(np.float32))
               for _ in range(3))
    out = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert (spy.flash, spy.ref) == ((1, 0) if flash else (0, 1))
    want = tfa.flash_attention_reference(q, k, v, causal=True)[0]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def jax_runs(models):
    jm, _, jb, _ = models
    out = {}
    for name, model, opts in (("legacy", jm, dict(unified=False)),
                              ("gather", jm, dict(attn_impl="gather")),
                              ("legacy_int8_bf16", jb,
                               dict(unified=False, kv_dtype="int8"))):
        eng = JaxEngine(model, **ENGINE, **opts)
        out[name] = [list(r.token_ids) for r in eng.generate(
            _prompts(), JaxSampling(max_new_tokens=NEW))]
        eng.drain()
    return out


@pytest.mark.parametrize("name,opts", [
    ("legacy", dict(unified=False)), ("gather", dict(attn_impl="gather")),
    ("legacy_int8_bf16", dict(unified=False, kv_dtype="int8"))])
def test_serving_at_head_dim_32_matches_jax(models, jax_runs, monkeypatch,
                                            name, opts):
    model = models[3] if name.endswith("bf16") else models[1]
    spy = _Spy(monkeypatch)
    eng = _Watched(model, device="cpu", **ENGINE, **opts)
    got = [list(r.token_ids) for r in eng.generate(
        _prompts(), SamplingParams(max_new_tokens=NEW))]
    assert got == jax_runs[name]
    tol = BF16_LOGIT_TOL if name.endswith("bf16") else LOGIT_TOL
    assert min(eng.margins) > 2 * tol, min(eng.margins)
    # the chunks and the gather arm attend by the plain route
    assert spy.flash == 0 and spy.ref > 0


def test_generate_at_head_dim_32_matches_jax(models, monkeypatch):
    jm, tm = models[:2]
    ids = np.random.RandomState(5).randint(0, 256, (2, 10))
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=NEW).numpy())
    spy = _Spy(monkeypatch)
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert spy.flash == 0 and spy.ref > 0


@pytest.mark.parametrize("pool", ["int8", "fp8"])
def test_gather_branch_over_1_byte_pools_returns_f32(pool):
    """A bf16 chunk over int8 (or e4m3) pools attends in f32 and returns
    f32, as the JAX function's promoting einsums do."""
    from paddle_tpu.core.tensor import Tensor as JT
    from paddle_tpu.nlp import generation as jgen
    rs = np.random.RandomState(6)
    q, kn, vn = (rs.randn(2, 4, 2, 32).astype(ml_dtypes.bfloat16)
                 for _ in range(3))
    table = np.array([[1, 2], [3, 4]], np.int32)
    pos = np.array([3, 9], np.int32)
    if pool == "int8":
        k, v = (rs.randint(-127, 128, (5, 8, 2, 32)).astype(np.int8)
                for _ in range(2))
        ks, vs = ((rs.rand(5, 8, 2) * 0.02).astype(np.float32)
                  for _ in range(2))
        jx = dict(k_scale=JT(jnp.asarray(ks)), v_scale=JT(jnp.asarray(vs)))
        tx = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        k, v = (rs.randn(5, 8, 2, 32).astype(ml_dtypes.float8_e4m3fn)
                for _ in range(2))
        jx, tx = {}, {}
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = (torch.from_numpy(a.view(np.uint8)).view(tpa.FP8_DTYPE)
                  for a in (k, v))
    jc = jgen.DecodeCache(JT(jk), JT(jv), JT(jnp.asarray(pos)),
                          page_table=JT(jnp.asarray(table)),
                          attn_impl="kernel", **jx)
    jout, _ = jgen.update_and_attend(JT(jnp.asarray(q)), JT(jnp.asarray(kn)),
                                     JT(jnp.asarray(vn)), jc)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    tc = tgen.DecodeCache(tk, tv, torch.from_numpy(pos),
                          page_table=torch.from_numpy(table),
                          attn_impl="kernel", **tx)
    tout, _ = tgen.update_and_attend(bf(q), bf(kn), bf(vn), tc)
    assert np.asarray(jout._value).dtype == np.float32
    assert tout.dtype == torch.float32
    # the JAX `_sdpa_ref` rounds its probabilities to q's dtype (bf16)
    # before the value product; the port keeps them in f32, as its
    # kernels do: a bf16 rounding of outputs of magnitude ~1
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout._value),
                               rtol=0, atol=1e-2)
