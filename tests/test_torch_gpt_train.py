"""GPT training on the port, held against the JAX package.

At the `__graft_entry__.entry()` geometry (vocab 1024, hidden 256, 4
layers, 8 heads, seq 64, batch 2, dropout 0, f32), with the weights
carried across by `convert.py`: the loss and every parameter's gradient
against `jax.grad`, three AdamW steps through both packages'
`compile_train_step`, and the logits of a forward without labels, which
now go through `F.scaled_dot_product_attention` (flash attention's
plain versions on the CPU; JAX runs `_sdpa_ref` there).
"""
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu_torch import convert
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn.functional import attention as tattn

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=1024, hidden_size=256, num_hidden_layers=4,
                num_attention_heads=8, max_position_embeddings=256,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
BATCH, SEQ = 2, 64
LR, WD, STEPS = 1e-3, 0.01, 3


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def jax_ln_importable():
    """A stand-in `jax.experimental.disable_x64` that raises if entered
    (jax releases without the name fail every JAX GPT forward), with
    `PADDLE_TPU_FUSED_LN=0` holding the JAX LayerNorm on its jnp path;
    both are removed at teardown, with the module imported under them."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    try:
        yield
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def _pair():
    """A fresh JAX GPT (seed 0) and the port's GPT with its weights."""
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**GEOMETRY))
    params = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**GEOMETRY), device="cpu")
    tm.load_state_dict(convert.from_paddle_state_dict(params))
    return jm, tm


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, GEOMETRY["vocab_size"], (BATCH, SEQ)),
            rs.randint(0, GEOMETRY["vocab_size"], (BATCH, SEQ)))


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_ln_importable, batch):
    """The JAX loss and {name: gradient} by jax.grad, computed once."""
    jm, _ = _pair()
    names = [n for n, _ in jm.named_parameters()]
    state = [p for _, p in jm.named_parameters()]
    ids, labels = (jnp.asarray(a) for a in batch)

    def loss_of(vals):
        originals = [t._value for t in state]
        try:
            for t, v in zip(state, vals):
                t._value = v
            return jm(JaxTensor(ids), labels=JaxTensor(labels))._value
        finally:
            for t, v in zip(state, originals):
                t._value = v

    loss, grads = jax.value_and_grad(loss_of)([p._value for p in state])
    return float(loss), {n: np.asarray(g) for n, g in zip(names, grads)}


def test_loss_and_every_gradient_match_jax(jax_loss_and_grads, batch):
    want_loss, want_grads = jax_loss_and_grads
    _, tm = _pair()
    ids, labels = (torch.from_numpy(a) for a in batch)
    loss = tm(ids, labels=labels)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    grads = convert.to_paddle_state_dict(
        {n: p.grad for n, p in tm.named_parameters()})
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        # both f32; the frameworks sum in different orders and the JAX
        # LayerNorm takes one-pass statistics where the port takes two
        np.testing.assert_allclose(g, want_grads[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_three_adamw_steps_match_jax(jax_ln_importable, batch):
    jm, tm = _pair()
    jo = jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                    weight_decay=WD)
    jstep = jjit.compile_train_step(
        lambda ids, labels: jm(ids, labels=labels), jm, jo)
    to = topt.AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                    weight_decay=WD)
    tstep = tjit.compile_train_step(
        lambda ids, labels: tm(ids, labels=labels), tm, to)
    jb = [paddle.to_tensor(a) for a in batch]
    want = [float(jstep(*jb)) for _ in range(STEPS)]
    got = [tstep(*batch).item() for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    assert all(p.grad is None for p in tm.parameters())
    # the tied embedding (also the LM head) and every other weight
    # round-trip through convert.py after training
    back = convert.to_paddle_state_dict(tm.state_dict())
    jstate = {k: v.numpy() for k, v in jm.state_dict().items()}
    assert sorted(back) == sorted(jstate)
    # rtol 1e-5 for all but a few elements: where a gradient is near 0
    # (|g| ~ eps = 1e-8, or exactly 0 in exact arithmetic, as for the
    # key bias, which the softmax cancels), Adam's g / (|g| + eps) turns
    # the frameworks' f32 rounding of g into a step of any size up to
    # lr. Measured: 0.12 % of the elements, a quarter of them the key
    # biases. A wrong rule moves every element; the rule itself is held
    # element by element in test_adamw_rule_matches_jax.
    off = n = 0
    for name, arr in jstate.items():
        off += int((~np.isclose(back[name], arr, rtol=1e-5,
                                atol=1e-7)).sum())
        n += arr.size
    assert off / n < 2e-3, (off, n)
    sd = to.state_dict()
    assert sd["global_beta1_pow"] == np.float32(0.9) ** 3
    assert sd["gpt.embeddings.word_embeddings.weight_moment1_0"].dtype == \
        torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_rule_matches_jax(dtype):
    """Three updates of the same parameters with the same gradients:
    the port's multi-tensor sweep against the JAX `AdamW._rule`, with a
    parameter that `apply_decay_param_fun` keeps out of the decay."""
    rs = np.random.RandomState(8)
    shapes = {"w": (6, 5), "b": (5,)}
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rs.randn(*s) * 10.0 ** rs.randint(-6, 1, s)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(STEPS)]
    decay = lambda name: name != "b"
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jo = jopt.AdamW(learning_rate=LR, weight_decay=WD, parameters=[],
                    apply_decay_param_fun=decay)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    js = {k: {"moment1": jnp.zeros_like(v), "moment2": jnp.zeros_like(v)}
          for k, v in jp.items()}
    gstate = {k: jnp.asarray(v) for k, v in jo._global_state_spec().items()}
    for g in grads:
        for k in jp:
            jo._cur_extra = WD if decay(k) else 0.0
            jp[k], js[k] = jo._rule(jp[k], jnp.asarray(g[k], jdt), js[k],
                                    gstate, np.float32(LR))
        gstate = jo._advance_global(gstate)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v).to(tdt))
          for k, v in p0.items()}
    to = topt.AdamW(learning_rate=LR, weight_decay=WD,
                    parameters=list(tp.items()),
                    apply_decay_param_fun=decay)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]).to(tdt)
        to.step()
        to.clear_grad()
    for k, p in tp.items():
        assert p.dtype == tdt
        # f32: the same f32 arithmetic up to one rounding of each
        # factor; bf16: one bf16 rounding of the same f32 value
        tol = dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else \
            dict(rtol=0, atol=0)
        np.testing.assert_allclose(
            p.detach().float().numpy(),
            np.asarray(jnp.asarray(jp[k], jnp.float32)), err_msg=k, **tol)
        sd = to.state_dict()
        np.testing.assert_allclose(sd[f"{k}_moment2_0"].numpy(),
                                   np.asarray(js[k]["moment2"]),
                                   rtol=1e-6, atol=0)


def test_logits_without_labels_match_and_take_the_sdpa_route(
        jax_ln_importable, batch, monkeypatch):
    jm, tm = _pair()
    jm.eval()
    tm.eval()
    ids = batch[0]
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    calls = []
    # head dim 32: the JAX route's `_sdpa_ref`, not the flash op, which
    # takes 64, 128 and 256 (test_torch_head_dims.py)
    orig = tattn._sdpa_ref

    def spy(*args, **kw):
        calls.append(args[4])           # causal
        return orig(*args, **kw)

    def no_flash(*args, **kw):
        raise AssertionError("head dim 32 took the flash op")

    def no_paged_step(*args, **kw):
        raise AssertionError("a forward without caches took the paged step")

    monkeypatch.setattr(tattn, "_sdpa_ref", spy)
    monkeypatch.setattr(tattn, "flash_attention_blhd", no_flash)
    monkeypatch.setattr("paddle_tpu_torch.nlp.gpt.update_and_attend",
                        no_paged_step)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert calls == [True] * GEOMETRY["num_hidden_layers"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_training_dropout_draws_from_the_model_generator(batch):
    """With dropout on, two models of one seed give the same training
    loss, another seed another; eval mode turns dropout off."""
    cfg = dict(GEOMETRY, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
    ids, labels = (torch.from_numpy(a) for a in batch)
    losses = []
    for seed in (0, 0, 1):
        m = GPTForCausalLM(GPTConfig(**cfg), device="cpu", seed=seed)
        with torch.no_grad():
            losses.append(m(ids, labels=labels).item())
    assert losses[0] == losses[1] != losses[2]
    m.eval()
    with torch.no_grad():
        a, b = (m(ids, labels=labels).item() for _ in range(2))
    assert a == b


def test_unported_trainer_options_raise(batch):
    """GPT's tensor and sequence parallelism raise, naming ROADMAP.md;
    gradient merge, grad_clip and recompute, which raised before they
    were ported, run (tests/test_torch_train_options.py and
    tests/test_torch_llama_train.py hold them against JAX)."""
    for kw in (dict(tensor_parallel=2), dict(sequence_parallel=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            GPTForCausalLM(GPTConfig(**GEOMETRY, **kw), device="cpu")
    cfg = GPTConfig(**GEOMETRY, use_recompute=True)
    assert cfg.fuse_attention_qkv
    tm = GPTForCausalLM(cfg, device="cpu")
    o = topt.AdamW(parameters=tm.parameters(),
                   grad_clip=tclip.ClipGradByGlobalNorm(1.0))
    step = tjit.compile_train_step(lambda i, lab: tm(i, labels=lab), tm, o,
                                   accumulate_steps=2)
    ids, labels = (a[:, :16] for a in batch)
    loss = step(ids, labels)
    assert torch.isfinite(loss) and len(step.micro_losses) == 2
    assert all(p.grad is None for p in tm.parameters())
    assert o.state_dict()["global_beta1_pow"] == np.float32(0.9)
