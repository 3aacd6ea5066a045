"""Training Llama (and GPT's recompute) in the port, held against the
JAX package.

The small Llamas of tests/test_torch_llama.py at hidden 64: GQA (4
heads of 16 over 2 kv heads) and MHA, which take the plain attention
route, and a third at hidden 128, head dim 64 (2 heads over 1 kv
head), which takes the flash attention op (K3-K5 on the card, their
plain versions here).
Weights move through `convert.py`, the RMSNorm weights and the biases
perturbed first. Each JAX oracle is built once per module.

- the loss and every gradient against `jax.grad`, with `use_recompute`
  off and on (the JAX model's too), at rtol 1e-5 / atol 1e-6;
- three `compile_train_step` steps with AdamW under the warm-up/cosine
  schedule, `ClipGradByGlobalNorm(0.1)` (a clip that bites) and
  `accumulate_steps=2`, against the JAX step's losses and parameters;
- the flash op's calls a training step: with recompute K3 twice a
  layer, K4 and K5 once;
- GPT with `use_recompute=True` against JAX with dropout 0, and with
  dropout 0.1 bit for bit against itself without recompute: the rerun
  replays the model generator's draws; `recompute_sequential` against
  the layers run in turn.
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
from paddle_tpu.nlp.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.nlp.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import convert
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed.fleet import recompute_sequential
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM)
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import lr as tlr

GQA = dict(vocab_size=89, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2,
           intermediate_size=96, max_position_embeddings=64)
GEOMETRIES = {"gqa": GQA, "mha": dict(GQA, num_key_value_heads=None),
              "flash": dict(GQA, hidden_size=128, num_attention_heads=2,
                            num_key_value_heads=1)}
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
BATCH, SEQ = 4, 16
LR, WD, CLIP, STEPS = 1e-4, 0.01, 0.1, 3


def _ids(seed=0, shape=(BATCH, SEQ)):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, GQA["vocab_size"], shape),
            rs.randint(0, GQA["vocab_size"], shape))


def _perturbed(jm, seed=5):
    """The JAX model's state with random RMSNorm weights and biases, set
    into it; returned as {name: array}."""
    rs = np.random.RandomState(seed)
    params = {k: v.numpy() for k, v in jm.state_dict().items()}
    for name, arr in params.items():
        if name.endswith("norm.weight"):
            params[name] = (1 + 0.3 * rs.randn(*arr.shape)).astype(arr.dtype)
        elif name.endswith(".bias"):
            params[name] = (0.02 * rs.randn(*arr.shape)).astype(arr.dtype)
    jm.set_state_dict(params)
    return params


def _jax_llama(geo, recompute=False):
    paddle.seed(11)
    jm = JaxLlama(JaxLlamaConfig(**geo, use_recompute=recompute))
    return jm, _perturbed(jm)


def _port_llama(geo, params, recompute=False):
    tm = LlamaForCausalLM(LlamaConfig(**geo, use_recompute=recompute),
                          device="cpu")
    tm.load_state_dict(convert.from_paddle_state_dict(params))
    return tm.train()


def _jax_loss_and_grads(jm, ids, labels):
    """The JAX model's loss and {name: gradient} by jax.grad."""
    jm.train()
    names = [n for n, _ in jm.named_parameters()]
    state = [p for _, p in jm.named_parameters()]

    def loss_of(vals):
        originals = [t._value for t in state]
        try:
            for t, v in zip(state, vals):
                t._value = v
            return jm(JaxTensor(jnp.asarray(ids)),
                      labels=JaxTensor(jnp.asarray(labels)))._value
        finally:
            for t, v in zip(state, originals):
                t._value = v

    loss, grads = jax.value_and_grad(loss_of)([p._value for p in state])
    return float(loss), {n: np.asarray(g) for n, g in zip(names, grads)}


def _port_loss_and_grads(tm, ids, labels):
    loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = convert.to_paddle_state_dict(
        {n: p.grad for n, p in tm.named_parameters()})
    tm.zero_grad(set_to_none=True)
    return loss.item(), grads


@pytest.fixture(scope="module")
def jax_grads():
    """{(geometry, recompute): (loss, grads, params)}, built once."""
    ids, labels = _ids()
    out = {}
    for name, geo in GEOMETRIES.items():
        for rec in (False, True):
            jm, params = _jax_llama(geo, rec)
            out[name, rec] = (*_jax_loss_and_grads(jm, ids, labels), params)
    return out


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_loss_and_every_gradient_match_jax(jax_grads, geometry, recompute):
    want_loss, want, params = jax_grads[geometry, recompute]
    # the JAX model's recompute changes nothing in its gradients either
    plain_loss, plain, _ = jax_grads[geometry, False]
    assert want_loss == pytest.approx(plain_loss, rel=1e-6)
    tm = _port_llama(GEOMETRIES[geometry], params, recompute)
    assert all(layer.use_recompute is recompute
               for layer in tm.llama.layers)
    loss, got = _port_loss_and_grads(tm, *_ids())
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(plain[name], want[name], err_msg=name,
                                   **GRAD_TOL)


def test_recompute_gives_the_same_gradients_bit_for_bit():
    """Inside the port the rerun is the same arithmetic: recompute on
    and off agree bit for bit, at every geometry."""
    ids, labels = _ids(1)
    for geo in GEOMETRIES.values():
        jm, params = _jax_llama(geo)
        off = _port_loss_and_grads(_port_llama(geo, params), ids, labels)
        on = _port_loss_and_grads(_port_llama(geo, params, True), ids,
                                  labels)
        assert off[0] == on[0]
        assert all(np.array_equal(off[1][n], on[1][n]) for n in off[1])


class _Counted:
    """Counts the calls of the flash op's wrappers (K3, K4, K5 on the
    card; their plain versions here)."""

    def __init__(self, monkeypatch):
        self.calls = {"fwd": 0, "dq": 0, "dkv": 0}
        for key, name in (("fwd", "flash_attention_fwd"),
                          ("dq", "flash_attention_dq"),
                          ("dkv", "flash_attention_dkv")):
            monkeypatch.setattr(tfa, name, self._counting(key,
                                                          getattr(tfa, name)))

    def _counting(self, key, fn):
        def run(*a, **kw):
            self.calls[key] += 1
            return fn(*a, **kw)
        return run


@pytest.mark.parametrize("recompute", [False, True])
def test_recompute_reruns_the_forward_kernel_only(monkeypatch, recompute):
    """A training step of the head-dim-64 Llama (the one geometry on
    the flash op; the others take none): K3 once a layer, twice
    with recompute (the rerun); K4 and K5 once a layer either way. The
    loss and the head are not recomputed."""
    geo = GEOMETRIES["flash"]
    tm = LlamaForCausalLM(LlamaConfig(**geo, use_recompute=recompute),
                          device="cpu").train()
    counted = _Counted(monkeypatch)
    ids, labels = (torch.from_numpy(a) for a in _ids(2))
    loss = tm(ids, labels=labels)
    n = geo["num_hidden_layers"]
    assert counted.calls == {"fwd": n, "dq": 0, "dkv": 0}
    loss.backward()
    assert counted.calls == {"fwd": 2 * n if recompute else n, "dq": n,
                             "dkv": n}
    counted.calls = dict.fromkeys(counted.calls, 0)
    tm2 = LlamaForCausalLM(LlamaConfig(**GQA, use_recompute=recompute),
                           device="cpu").train()
    tm2(ids, labels=labels).backward()
    assert counted.calls == {"fwd": 0, "dq": 0, "dkv": 0}


def _jax_optimizer(params):
    sched = jlr.LinearWarmup(jlr.CosineAnnealingDecay(LR, T_max=10),
                             warmup_steps=2, start_lr=0.0, end_lr=LR)
    return jopt.AdamW(sched, parameters=params, weight_decay=WD,
                      grad_clip=jclip.ClipGradByGlobalNorm(CLIP)), sched


def _port_optimizer(params):
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(LR, T_max=10),
                             warmup_steps=2, start_lr=0.0, end_lr=LR)
    return topt.AdamW(sched, parameters=params, weight_decay=WD,
                      grad_clip=tclip.ClipGradByGlobalNorm(CLIP)), sched


@pytest.mark.parametrize("geometry", ["gqa", "flash"])
def test_three_merged_clipped_scheduled_steps_match_jax(geometry):
    """Three steps of [4, 16] as two micro-batches of 2 each, the caller
    stepping the scheduler after each: the losses (means of the micro
    losses) at rtol 1e-5, the lr each step read, and every parameter
    after the steps. The key projection's bias is held only to within
    one lr a step: its gradient is 0 in exact arithmetic (the softmax
    cancels it), so each package's step on it is its own rounding noise,
    which Adam scales to up to lr."""
    geo = GEOMETRIES[geometry]
    jm, params = _jax_llama(geo)
    jm.train()
    jo, jsched = _jax_optimizer(jm.parameters())
    jstep = jjit.compile_train_step(
        lambda ids, labels: jm(ids, labels=labels), jm, jo,
        accumulate_steps=2)
    tm = _port_llama(geo, params)
    to, tsched = _port_optimizer(tm.named_parameters())
    tstep = tjit.compile_train_step(
        lambda ids, labels: tm(ids, labels=labels), tm, to,
        accumulate_steps=2)
    read = []
    get_lr = to.get_lr
    to.get_lr = lambda: read.append(get_lr()) or read[-1]
    want, got, lrs = [], [], []
    for i in range(STEPS):
        ids, labels = _ids(10 + i)
        want.append(float(jstep(paddle.to_tensor(ids),
                                paddle.to_tensor(labels))))
        lrs.append(tsched())
        got.append(tstep(ids, labels).item())
        assert len(tstep.micro_losses) == 2
        assert got[-1] == pytest.approx(
            torch.stack(tstep.micro_losses).mean().item(), rel=1e-7)
        jsched.step()
        tsched.step()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert lrs == [0.0, LR / 2, LR] and set(read) == set(lrs)
    # the clip bites: the global norm of the first step's gradient
    first = _port_loss_and_grads(_port_llama(geo, params), *_ids(10))[1]
    gnorm = tclip.ClipGradByGlobalNorm(CLIP).global_norm(
        [torch.from_numpy(g) for g in first.values()])
    assert gnorm.item() > 3 * CLIP
    back = convert.to_paddle_state_dict(tm.state_dict())
    jstate = {k: v.numpy() for k, v in jm.state_dict().items()}
    assert sorted(back) == sorted(jstate)
    moved = 0
    for name, arr in jstate.items():
        if name.endswith("k_proj.bias"):
            assert np.abs(back[name] - arr).max() <= STEPS * LR
            continue
        np.testing.assert_allclose(back[name], arr, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        moved += int((arr != params[name]).sum())
    assert moved > 0


# -- GPT -------------------------------------------------------------------
_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GPT_GEO = dict(vocab_size=97, hidden_size=128, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=64,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def jax_ln_importable():
    """The stand-in `jax.experimental.disable_x64` of
    tests/test_torch_gpt_train.py (it raises if entered), with
    `PADDLE_TPU_FUSED_LN=0`; both removed at teardown."""
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


def test_gpt_recompute_matches_jax(jax_ln_importable):
    """GPT at head dim 64 (the flash op), dropout 0: the port with
    recompute against the JAX model with recompute, loss and every
    gradient."""
    ids, labels = (a[:2] for a in _ids(3))
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**GPT_GEO, use_recompute=True))
    params = {k: v.numpy() for k, v in jm.state_dict().items()}
    want_loss, want = _jax_loss_and_grads(jm, ids, labels)
    tm = GPTForCausalLM(GPTConfig(**GPT_GEO, use_recompute=True),
                        device="cpu")
    tm.load_state_dict(convert.from_paddle_state_dict(params))
    loss, got = _port_loss_and_grads(tm.train(), ids, labels)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], err_msg=name, **GRAD_TOL)


def test_gpt_recompute_replays_dropout_bit_for_bit():
    """Dropout 0.1 (the layers' dropout and flash dropout, both drawn
    from the model's generator): recompute on and off, from one seed,
    give the same loss and every gradient bit for bit, and leave the
    generator where a forward without recompute leaves it."""
    geo = dict(GPT_GEO, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
    ids, labels = (torch.from_numpy(a[:2]) for a in _ids(4))
    runs = []
    for rec in (False, True):
        m = GPTForCausalLM(GPTConfig(**geo, use_recompute=rec),
                           device="cpu", seed=7).train()
        loss = m(ids, labels=labels)
        loss.backward()
        runs.append((loss.item(),
                     {n: p.grad for n, p in m.named_parameters()},
                     m.generator.get_state(), m(ids, labels=labels).item()))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = runs
    assert l0 == l1 and n0 == n1 and torch.equal(s0, s1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    # and the dropout draws: another seed gives another loss
    other = GPTForCausalLM(GPTConfig(**geo, use_recompute=True),
                           device="cpu", seed=8).train()
    assert other(ids, labels=labels).item() != l0


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_recompute_sequential_matches_the_plain_sequence(segments):
    """Five layers in `segments` recomputed segments (len // segments
    layers each, the JAX split): the output and every gradient bit for
    bit against the layers run in turn without recompute."""
    torch.manual_seed(0)
    layers = [torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.Tanh())
              for _ in range(5)]
    x = torch.randn(3, 8, requires_grad=True)
    runs = []
    for rec in (False, True):
        if rec:
            out = recompute_sequential({"segments": segments}, layers, x)
        else:
            out = x
            for layer in layers:
                out = layer(out)
        out.square().sum().backward()
        runs.append((out.detach(), x.grad.clone(),
                     [p.grad.clone() for l in layers for p in l.parameters()]))
        x.grad = None
        for layer in layers:
            layer.zero_grad(set_to_none=True)
    (o0, x0, g0), (o1, x1, g1) = runs
    assert torch.equal(o0, o1) and torch.equal(x0, x1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
