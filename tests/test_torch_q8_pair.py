"""The paired int8 paged KV write (K8-q8 writing K and V in one launch)
on the CPU, held against the JAX package, and the int8 paths that reach
it.

The JAX package writes K and V into its int8 pools with two
`paged_scatter_q8` calls (its unified and legacy steps and its
megakernel); the port makes one K8-q8 launch for both on the card
(`paged_scatter_q8_pair`), and on the CPU its plain version writes each
pool as `paged_scatter_q8_reference` does. Here: the pair's plain
version against two plain single writes and two JAX `paged_scatter_q8`
calls (jnp), byte for byte outside the trash page 0 (which of several
writes to one trash slot stays is unspecified on both sides), at
positions that reach past some rows' windows, in f32, bf16 and f16 at
head dims 64, 128 and 40; then the int8 unified step, the legacy step
(decode step and prefill chunks) and the megakernel's
`megakernel_decode_q8` each make one paired write a layer and no single
one, with the same greedy tokens as the JAX engine over int8 pools.
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
from paddle_tpu_torch.nlp import generation, gpt
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.serving import SamplingParams, ServingEngine

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
_UPD = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
        torch.float16: np.float16}
# the tiny f32 GPT and engine of tests/test_torch_serving_quant.py
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=8)


def _case(seed, dtype, d, b=5, l=7, hkv=3, ps=8, mp=4):
    """K and V updates [b, l, hkv, d] of `dtype`, positions that reach
    past some rows' windows (those tokens go to the trash page) and
    shuffled page tables."""
    rs = np.random.RandomState(seed)
    n_pages = b * mp + 1
    table = rs.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        b, mp)
    pos = np.array([0, 3, 8, mp * ps - 4, 17], np.int32)[:b]
    upd = [torch.from_numpy(rs.randn(b, l, hkv, d).astype(np.float32) * 3)
           .to(dtype) for _ in range(2)]
    upd[0][0, 0, 0] = 0.0                    # a row at the 1e-8 floor
    return upd, pos, table, (n_pages, ps, hkv, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [64, 128, 40])
def test_pair_plain_version_equals_two_jax_writes(dtype, d):
    (ku, vu), pos, table, shape = _case(d, dtype, d)
    zeros = lambda: (torch.zeros(shape, dtype=torch.int8),
                     torch.zeros(shape[:3]))
    tpos, ttab = torch.from_numpy(pos), torch.from_numpy(table)
    (kc, ks), (vc, vs) = zeros(), zeros()
    got = tpa.paged_scatter_q8_pair(kc, vc, ks, vs, ku, vu, tpos, ttab)
    assert got[0] is kc and got[1] is vc and got[2] is ks and got[3] is vs
    for (codes, scales), upd in (((kc, ks), ku), ((vc, vs), vu)):
        one = tpa.paged_scatter_q8_reference(*zeros(), upd, tpos, ttab)
        want = jpa.paged_scatter_q8(
            jnp.zeros(shape, jnp.int8), jnp.zeros(shape[:3], jnp.float32),
            jnp.asarray(upd.float().numpy().astype(_UPD[dtype])),
            jnp.asarray(pos), jnp.asarray(table))
        for g, o, w in ((codes, one[0], want[0]), (scales, one[1], want[1])):
            g = g.numpy()[1:].view(np.uint8)
            np.testing.assert_array_equal(g, o.numpy()[1:].view(np.uint8))
            np.testing.assert_array_equal(
                g, np.asarray(w)[1:].view(np.uint8))
        assert (scales[1:] > 0).any() and (codes[1:] != 0).any()


@pytest.fixture(scope="module")
def models():
    """The JAX GPT and its port with the same weights (the JAX side on
    its jnp paths under a stand-in `jax.experimental.disable_x64` that
    must not be entered), and the JAX engine's int8 greedy tokens."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()

    class _MustNotRun:
        def __enter__(self):
            raise AssertionError("the Pallas LayerNorm path ran on the CPU")

        def __exit__(self, *exc):
            return False

    mp.setattr(jax.experimental, "disable_x64", lambda: _MustNotRun(),
               raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    mp.delenv("PADDLE_TPU_KV_DTYPE", raising=False)
    mp.delenv("PADDLE_TPU_MEGAKERNEL", raising=False)
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
        eng = JaxEngine(jm, kv_dtype="int8", **ENGINE)
        want = [list(r.token_ids) for r in eng.generate(
            _prompts(), JaxSampling(max_new_tokens=6))]
        yield tm, want
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def _prompts():
    rs = np.random.RandomState(5)
    return [rs.randint(0, 256, size=n).astype(np.int64) for n in (11, 4, 9)]


@pytest.mark.parametrize("arm", [dict(grouped=False), dict(unified=False),
                                 dict(grouped=False, megakernel=True)],
                         ids=["unified", "legacy", "megakernel"])
def test_int8_steps_write_k_and_v_in_one_call_a_layer(models, monkeypatch,
                                                      arm):
    """Every attention call over int8 pools (a unified step's layer, a
    legacy decode step's or prefill chunk's, the megakernel's layer)
    makes exactly one paired write and no single one; the greedy tokens
    are the JAX int8 engine's."""
    tm, want = models
    calls = {"pair": 0, "single": 0, "int8 layers": 0, "megakernel": 0}

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    pair = counted("pair", tpa.paged_scatter_q8_pair)
    monkeypatch.setattr(tpa, "paged_scatter_q8_pair", pair)
    monkeypatch.setattr(generation, "paged_scatter_q8_pair", pair)
    monkeypatch.setattr(tpa, "paged_scatter_q8",
                        counted("single", tpa.paged_scatter_q8))
    monkeypatch.setattr(generation, "megakernel_decode_q8",
                        counted("megakernel", tpa.megakernel_decode_q8))
    attend = generation.update_and_attend

    def layer(q, k, v, cache, *args, **kwargs):
        if cache.k_scale is not None and cache.page_table is not None:
            calls["int8 layers"] += 1
        return attend(q, k, v, cache, *args, **kwargs)

    monkeypatch.setattr(gpt, "update_and_attend", layer)
    eng = ServingEngine(tm, device="cpu", kv_dtype="int8", **arm, **ENGINE)
    got = [list(r.token_ids) for r in eng.generate(
        _prompts(), SamplingParams(max_new_tokens=6))]
    assert got == want
    assert calls["int8 layers"] > 0 and calls["single"] == 0
    assert calls["pair"] == calls["int8 layers"], calls
    assert (calls["megakernel"] > 0) == arm.get("megakernel", False)
