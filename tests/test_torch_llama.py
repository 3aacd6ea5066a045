"""Llama in the port, held against the JAX package's `nlp/llama.py`.

RMSNorm against `_rms_fwd` (f32 and bf16, widths 32 and 100) and rope
against `_rope_fwd` / `_rope_dyn_fwd` (a static offset, a scalar and a
per-row traced offset; theta 1e4 and 5e5). Then the tiny Llama of
tests/test_serving.py (vocab 89, hidden 32, 2 layers, 4 heads over 2
kv heads) and its MHA variant, with the JAX model's weights moved by
`convert.py` (the RMSNorm weights and the biases perturbed first, so
that neither is the identity): logits, the loss and the eager (k, v)
tuple-cache path against JAX, the convert round trip (the embedding
table is not transposed), greedy `generate` tokens exactly equal,
sequence parallelism raising, and training and recompute running
(tests/test_torch_llama_train.py holds them against JAX).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import llama as jllama
from paddle_tpu.nlp.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.nlp.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.functional.norm import _rms_fwd
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nlp.llama import apply_rotary
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn.functional import rms_norm

GQA = dict(vocab_size=89, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2,
           intermediate_size=48, max_position_embeddings=128)
MHA = dict(GQA, num_key_value_heads=None)
# f32 on both sides; the frameworks sum in different orders (the JAX
# package runs its f32 matmuls at "highest" precision)
LOGIT_TOL = 1e-5
# f32 elementwise ops of two libraries (pow, cos and sin of the same f32
# arguments may differ in their last bit)
F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7          # one bf16 ulp, relative (8 bits)
NEW = 6


def _bf16_close(got: torch.Tensor, want: np.ndarray):
    """Within one bf16 ulp of the JAX value, element by element."""
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    assert (np.abs(g - w) <= BF16_ULP * np.abs(w) + 1e-30).all(), \
        np.abs(g - w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [32, 100])
def test_rms_norm_matches_jax(dtype, width):
    """The weight is multiplied in f32 before the one cast back (the JAX
    order); bf16 input is upcast for the statistics."""
    rs = np.random.RandomState(width)
    x = (rs.randn(3, 5, width) * 2).astype(np.float32)
    w = (1 + 0.5 * rs.randn(width)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = _rms_fwd(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-6)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    got = rms_norm(tx, tw, 1e-6)
    assert got.dtype == tdt and got.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)
    else:
        _bf16_close(got, want)
    layer = RMSNorm(width, epsilon=1e-6)
    assert torch.equal(layer.weight, torch.ones(width))
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w))
        torch.testing.assert_close(layer(tx.float()),
                                   rms_norm(tx.float(), layer.weight))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_jax(theta):
    """Interleaved pairs at f32 angles: a static offset (0 and 7), a
    traced scalar offset and a per-row offset vector, f32 and bf16."""
    rs = np.random.RandomState(int(theta) % 97)
    x = rs.randn(3, 5, 2, 16).astype(np.float32)
    cases = [(0, 0), (7, 7), (np.int32(9), torch.tensor(9, dtype=torch.int32)),
             (np.array([0, 40, 3001], np.int32),
              torch.tensor([0, 40, 3001], dtype=torch.int32))]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        for joff, toff in cases:
            xj = jnp.asarray(x, jdt)
            if isinstance(joff, int):
                want = jllama._rope_fwd(xj, joff, theta)
            else:
                want = jllama._rope_dyn_fwd(xj, jnp.asarray(joff), theta)
            got = apply_rotary(torch.from_numpy(x).to(tdt), toff, theta)
            assert got.dtype == tdt
            if tdt == torch.float32:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=F32_TOL, atol=F32_TOL)
            else:
                _bf16_close(got, want)
    # interleaved pairs: (x0, x1) rotate together, not (x0, x8)
    e = torch.zeros(1, 1, 1, 16)
    e[..., 0] = 1.0
    rot = apply_rotary(e, 1, theta)
    assert rot[..., 1].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    assert rot[..., 8].item() == 0.0


def _perturbed(jm, seed):
    """The JAX model's state with random RMSNorm weights and biases."""
    rs = np.random.RandomState(seed)
    params = {k: v.numpy() for k, v in jm.state_dict().items()}
    for name, arr in params.items():
        if name.endswith("layernorm.weight") or name.endswith("norm.weight"):
            params[name] = (1 + 0.3 * rs.randn(*arr.shape)).astype(arr.dtype)
        elif name.endswith(".bias"):
            params[name] = (0.02 * rs.randn(*arr.shape)).astype(arr.dtype)
    jm.set_state_dict(params)
    return params


@pytest.fixture(scope="module", params=["gqa", "mha"])
def models(request):
    geo = GQA if request.param == "gqa" else MHA
    paddle.seed(11)
    jm = JaxLlama(JaxLlamaConfig(**geo))
    jm.eval()
    params = _perturbed(jm, 5)
    tm = LlamaForCausalLM(LlamaConfig(**geo), device="cpu")
    tm.load_state_dict(convert.from_paddle_state_dict(params))
    tm.eval()
    return jm, tm, params


def _ids(b=2, l=9):
    return np.random.RandomState(0).randint(0, GQA["vocab_size"], (b, l))


def test_logits_and_loss_match_jax(models):
    jm, tm, _ = models
    ids = _ids()
    labels = np.roll(ids, -1, axis=1)
    want = jm(paddle.to_tensor(ids)).numpy()
    want_loss = float(jm(paddle.to_tensor(ids),
                         labels=paddle.to_tensor(labels)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    assert abs(loss.item() - want_loss) <= LOGIT_TOL


def test_tuple_cache_matches_jax(models):
    """A 6-token prefill from empty (k, v) tuples, then three single
    tokens, each step's logits against the JAX model's."""
    jm, tm, _ = models
    cfg = tm.config
    ids = _ids(2, 9)
    hd = cfg.hidden_size // cfg.num_attention_heads
    empty = np.zeros((2, 0, cfg.num_key_value_heads, hd), np.float32)
    jc = [(paddle.to_tensor(empty), paddle.to_tensor(empty))
          for _ in range(cfg.num_hidden_layers)]
    tc = [(torch.from_numpy(empty), torch.from_numpy(empty))
          for _ in range(cfg.num_hidden_layers)]
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        want, jc = jm(paddle.to_tensor(ids[:, lo:hi]), caches=jc)
        with torch.no_grad():
            got, tc = tm(torch.from_numpy(ids[:, lo:hi]), caches=tc)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=LOGIT_TOL)
        assert tc[0][0].shape == (2, hi, cfg.num_key_value_heads, hd)
    with torch.no_grad():
        full = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), full[:, -1:].numpy(), rtol=0,
                               atol=LOGIT_TOL)


def test_convert_round_trip(models, tmp_path):
    jm, tm, params = models
    back = convert.to_paddle_state_dict(tm.state_dict())
    assert sorted(back) == sorted(params)
    for name, arr in params.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)
    sd = tm.state_dict()
    # the embedding table keeps [vocab, hidden]; Linear weights cross
    # [in, out] -> [out, in]
    assert tuple(sd["llama.embed_tokens.weight"].shape) == (89, 32)
    np.testing.assert_array_equal(sd["llama.embed_tokens.weight"].numpy(),
                                  params["llama.embed_tokens.weight"])
    assert tuple(sd["lm_head.weight"].shape) == (89, 32)
    assert tuple(sd["llama.layers.0.self_attn.k_proj.weight"].shape) == \
        (tm.config.num_key_value_heads * 8, 32)
    path = tmp_path / "llama.pdparams"
    paddle.save(jm.state_dict(), str(path))
    loaded = convert.from_paddle_state_dict(convert.load_pdparams(path))
    for name, t in sd.items():
        torch.testing.assert_close(loaded[name], t, rtol=0, atol=0)
    got = convert.from_paddle_state_dict(
        {"llama.embed_tokens.weight": params["llama.embed_tokens.weight"]
         .astype(ml_dtypes.bfloat16)})["llama.embed_tokens.weight"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (89, 32)


def test_greedy_generate_matches_jax(models):
    """Tokens exactly equal, each winning its step by a clear margin."""
    jm, tm, _ = models
    ids = _ids(2, 7)
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=NEW).numpy()
    got = tm.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    assert got.shape == (2, 7 + NEW) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        lg = tm(torch.from_numpy(np.array(want)))[:, 6:6 + NEW]
    top2 = torch.topk(lg, 2, dim=-1).values
    assert (top2[..., 0] - top2[..., 1]).min().item() > 10 * LOGIT_TOL
    np.testing.assert_array_equal(lg.argmax(-1).numpy(), want[:, 7:])


def test_unported_options_raise(models):
    """Sequence parallelism names ROADMAP.md; training and recompute,
    which raised before Llama's training was ported, run: a training
    forward records the graph and every parameter gets a finite
    gradient. The model is built on the card by default."""
    tm = models[1]
    ids = torch.from_numpy(_ids())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LlamaForCausalLM(LlamaConfig(**GQA, sequence_parallel=True),
                         device="cpu")
    tm.train()
    try:
        tm(ids, labels=ids).backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in tm.parameters())
        with torch.no_grad():           # no graph: the forward runs
            assert tm(ids).shape == (2, 9, 89)
    finally:
        tm.eval()
        tm.zero_grad(set_to_none=True)
    rec = LlamaForCausalLM(LlamaConfig(**GQA, use_recompute=True),
                           device="cpu").train()
    loss = rec(ids, labels=ids)
    loss.backward()
    assert torch.isfinite(loss) and rec.lm_head.weight.grad is not None


def test_defaults_are_llama_7b_and_built_on_the_card(monkeypatch):
    cfg = LlamaConfig()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.num_key_value_heads,
            cfg.intermediate_size, cfg.max_position_embeddings,
            cfg.rms_norm_eps, cfg.rope_theta) == \
        (32000, 4096, 32, 32, 32, 11008, 4096, 1e-6, 10000.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(LlamaConfig(**GQA))
