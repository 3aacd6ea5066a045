"""The train step's options in the port, held against the JAX package.

- F13: `Adam(weight_decay=0.5)` and `Adam(weight_decay=L2Decay(0.5))`
  fold 0.5 p into the gradient (after the clip) on the eager `step()`
  and through `compile_train_step`, after one and three steps;
- the 16 LR schedulers of `optimizer.lr`, 30 steps each, with a
  `state_dict` round trip halfway;
- the clip classes, `apply_grad_clip_values`, `clip_grad_norm_` and
  `clip_grad_value_` in f32 and bf16, and three Adam steps with each
  class on the eager and the compiled paths;
- `multi_precision` master weights on a bf16 model (Adam and AdamW),
  and their `state_dict` keys;
- gradient merge: the merged gradient is the f32 sum of the micro-batch
  gradients (divided by k when averaging), bit for bit, and the loss the
  mean of the micro-batch losses.

The steps run on `Linear2`, two parameters w [3, 4] and b [4] whose
loss sum(w * c) + sum(b * d) has the batch (c, d) for its gradient,
exactly in both packages, so the optimizers see the same bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr

F32 = dict(rtol=1e-6, atol=1e-7)
BF16_ULP = 2.0 ** -7
STEPS = 3


def _batches(n=STEPS, seed=3):
    """n batches (c [3, 4], d [4]) of gradients spread over 1e-3..10."""
    rs = np.random.RandomState(seed)
    return [((rs.randn(3, 4) * 10.0 ** rs.uniform(-3, 1, (3, 4))
              ).astype(np.float32),
             (rs.randn(4) * 10.0 ** rs.uniform(-3, 1, 4)).astype(np.float32))
            for _ in range(n)]


def _init():
    rs = np.random.RandomState(1)
    return rs.randn(3, 4).astype(np.float32), rs.randn(4).astype(np.float32)


class JaxLinear2(jnn.Layer):
    def __init__(self, dtype):
        super().__init__()
        w, b = _init()
        self.w = JaxParameter(jnp.asarray(w, dtype))
        self.b = JaxParameter(jnp.asarray(b, dtype))

    def loss(self, c, d):
        return paddle.sum(self.w * c) + paddle.sum(self.b * d)


class Linear2(torch.nn.Module):
    def __init__(self, dtype):
        super().__init__()
        w, b = _init()
        self.w = torch.nn.Parameter(torch.from_numpy(w).to(dtype))
        self.b = torch.nn.Parameter(torch.from_numpy(b).to(dtype))

    def loss(self, c, d):
        return (self.w * c).sum() + (self.b * d).sum()


def _run_jax(make_opt, path, dtype="float32", steps=STEPS):
    """The JAX model's (w, b) as f32 numpy after `steps` steps, and the
    optimizer."""
    jdt = getattr(jnp, dtype)
    m = JaxLinear2(jdt)
    o = make_opt(m.parameters())
    batches = _batches(steps)
    if path == "eager":
        for c, d in batches:
            m.w.grad = paddle.to_tensor(jnp.asarray(c, jdt))
            m.b.grad = paddle.to_tensor(jnp.asarray(d, jdt))
            o.step()
            o.clear_grad()
    else:
        step = jjit.compile_train_step(m.loss, m, o)
        for c, d in batches:
            step(paddle.to_tensor(jnp.asarray(c, jdt)),
                 paddle.to_tensor(jnp.asarray(d, jdt)))
    return [np.asarray(jnp.asarray(p._value, jnp.float32))
            for p in (m.w, m.b)], o


def _run_port(make_opt, path, dtype="float32", steps=STEPS):
    tdt = getattr(torch, dtype)
    m = Linear2(tdt)
    o = make_opt(list(m.named_parameters()))
    batches = [tuple(torch.from_numpy(a).to(tdt) for a in cd)
               for cd in _batches(steps)]
    if path == "eager":
        for c, d in batches:
            m.w.grad, m.b.grad = c.clone(), d.clone()
            o.step()
            o.clear_grad()
    else:
        step = tjit.compile_train_step(m.loss, m, o)
        for c, d in batches:
            step(c, d)
    return [p.detach().float().numpy() for p in (m.w, m.b)], o


def _within_bf16_ulp(got, want, n=1):
    assert (np.abs(got - want) <= n * BF16_ULP * np.abs(want) + 1e-30
            ).all(), np.abs(got - want).max()


# -- F13: Adam's L2 weight decay -------------------------------------------
@pytest.mark.parametrize("path", ["eager", "compiled"])
@pytest.mark.parametrize("decay", ["float", "L2Decay"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adam_l2_weight_decay_matches_jax(path, decay, steps):
    """Adam(0.1, weight_decay=0.5): the rule sees g + 0.5 p. Before the
    fold the two packages' parameters stood 0.2 apart after one step."""
    wd = {"float": (0.5, 0.5),
          "L2Decay": (jreg.L2Decay(0.5), treg.L2Decay(0.5))}[decay]
    want, _ = _run_jax(lambda ps: jopt.Adam(0.1, parameters=ps,
                                            weight_decay=wd[0]),
                       path, steps=steps)
    got, o = _run_port(lambda ps: topt.Adam(0.1, parameters=ps,
                                            weight_decay=wd[1]),
                       path, steps=steps)
    assert o._decay == 0.5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32)
    # and the fold moves the result: without it the step is another
    plain, _ = _run_port(lambda ps: topt.Adam(0.1, parameters=ps), path,
                         steps=steps)
    assert np.abs(plain[0] - got[0]).max() > 1e-3


def test_l1decay_folds_as_l2_like_the_reference():
    """The JAX optimizers read only the coefficient (`_decay_coeff`), so
    an L1Decay folds coeff * p, not coeff * sign(p); so does the port.
    AdamW is decoupled: its decay is never folded into the gradient."""
    want, _ = _run_jax(lambda ps: jopt.Adam(0.1, parameters=ps,
                                            weight_decay=jreg.L1Decay(0.5)),
                       "eager")
    got, _ = _run_port(lambda ps: topt.Adam(
        0.1, parameters=ps, weight_decay=treg.L1Decay(0.5)), "eager")
    l2, _ = _run_port(lambda ps: topt.Adam(0.1, parameters=ps,
                                           weight_decay=0.5), "eager")
    for g, w, l in zip(got, want, l2):
        np.testing.assert_allclose(g, w, **F32)
        np.testing.assert_array_equal(g, l)
    assert repr(treg.L1Decay(0.5)) == "L1Decay(0.5)"
    want, _ = _run_jax(lambda ps: jopt.AdamW(0.1, parameters=ps,
                                             weight_decay=0.5), "compiled")
    got, _ = _run_port(lambda ps: topt.AdamW(0.1, parameters=ps,
                                             weight_decay=0.5), "compiled")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32)


# -- the 16 schedulers -------------------------------------------------------
def _schedulers(lr):
    return {
        "NoamDecay": lambda: lr.NoamDecay(64, 5, learning_rate=2.0),
        "PiecewiseDecay": lambda: lr.PiecewiseDecay([4, 11, 20],
                                                    [0.5, 0.1, 0.03, 0.01]),
        "NaturalExpDecay": lambda: lr.NaturalExpDecay(0.4, 0.13),
        "InverseTimeDecay": lambda: lr.InverseTimeDecay(0.4, 0.3),
        "PolynomialDecay": lambda: lr.PolynomialDecay(0.4, 12, 0.01, 2.0),
        "PolynomialDecay(cycle)": lambda: lr.PolynomialDecay(
            0.4, 7, 0.01, 1.5, cycle=True),
        "LinearWarmup": lambda: lr.LinearWarmup(
            lr.CosineAnnealingDecay(1e-4, T_max=10), warmup_steps=2,
            start_lr=0.0, end_lr=1e-4),
        "ExponentialDecay": lambda: lr.ExponentialDecay(0.4, 0.91),
        "MultiStepDecay": lambda: lr.MultiStepDecay(0.4, [3, 9, 17], 0.3),
        "StepDecay": lambda: lr.StepDecay(0.4, 4, 0.5),
        "LambdaDecay": lambda: lr.LambdaDecay(0.4, lambda e: 0.95 ** e),
        "MultiplicativeDecay": lambda: lr.MultiplicativeDecay(
            0.4, lambda e: 0.9 + 0.001 * e),
        "CosineAnnealingDecay": lambda: lr.CosineAnnealingDecay(
            0.4, T_max=13, eta_min=0.01),
        "CosineAnnealingWarmRestarts": lambda: lr.CosineAnnealingWarmRestarts(
            0.4, T_0=4, T_mult=2, eta_min=0.001),
        "OneCycleLR": lambda: lr.OneCycleLR(0.4, total_steps=25),
        "OneCycleLR(linear)": lambda: lr.OneCycleLR(
            0.4, total_steps=25, anneal_strategy="linear"),
        "CyclicLR": lambda: lr.CyclicLR(0.01, 0.4, step_size_up=3,
                                        step_size_down=5),
        "CyclicLR(exp_range)": lambda: lr.CyclicLR(
            0.01, 0.4, step_size_up=4, mode="exp_range", exp_gamma=0.97),
        "ReduceOnPlateau": lambda: lr.ReduceOnPlateau(
            0.4, factor=0.5, patience=2, cooldown=1, min_lr=0.02),
    }


# a loss that falls, stalls, falls and stalls (ReduceOnPlateau's metric)
_METRICS = [2.0 - 0.1 * min(i, 8) - 0.05 * max(0, min(i, 20) - 14)
            for i in range(30)]


def _sequence(sched, steps, start=0):
    out = []
    for i in range(start, start + steps):
        if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            sched.step(_METRICS[i])
        else:
            sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_sequence_and_state_round_trip_match_jax(name):
    """30 steps of the same float sequence as the JAX scheduler (1e-12),
    the first value before any step too; after 15 steps a fresh port
    scheduler takes the state_dict and continues identically."""
    jmake, tmake = _schedulers(jlr)[name], _schedulers(tlr)[name]
    js, ts = jmake(), tmake()
    assert ts() == pytest.approx(js(), rel=1e-12, abs=1e-15)
    want = _sequence(js, 30)
    got = _sequence(ts, 15)
    sd = ts.state_dict()
    resumed = tmake()
    resumed.set_state_dict(sd)
    got += _sequence(resumed, 15, start=15)
    tail = _sequence(ts, 15, start=15)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert tail == got[15:]
    assert len(set(np.round(want, 12))) > 1, "the schedule never moved"


def test_all_sixteen_schedulers_are_ported():
    names = set(tlr.__all__) - {"LRScheduler"}
    assert names == set(jlr.__all__) - {"LRScheduler"}
    assert len(names) == 16
    assert {n.split("(")[0] for n in _schedulers(tlr)} == names


def test_optimizer_reads_the_scheduler():
    """get_lr() is the scheduler's value; set_lr raises under one; the
    state_dict carries the scheduler's state."""
    sched = tlr.StepDecay(0.4, 2, 0.5)
    o = topt.AdamW(sched, parameters=[torch.nn.Parameter(torch.ones(2))])
    seen = []
    for _ in range(5):
        seen.append(o.get_lr())
        sched.step()
    assert seen == [0.4, 0.4, 0.2, 0.2, 0.1]
    with pytest.raises(RuntimeError, match="LRScheduler"):
        o.set_lr(0.1)
    assert o.state_dict()["LR_Scheduler"]["last_epoch"] == 5
    fresh = tlr.StepDecay(0.4, 2, 0.5)
    o2 = topt.AdamW(fresh, parameters=[torch.nn.Parameter(torch.ones(2))])
    o2.set_state_dict(o.state_dict())
    assert fresh.last_epoch == 5 and o2.get_lr() == o.get_lr()
    plain = topt.AdamW(0.01, parameters=[torch.nn.Parameter(torch.ones(2))])
    plain.set_lr(0.02)
    assert plain.get_lr() == 0.02 and "LR_Scheduler" not in \
        plain.state_dict()


# -- clipping ------------------------------------------------------------
_CLIPS = {"ClipGradByValue": lambda m: m.ClipGradByValue(0.05),
          "ClipGradByNorm": lambda m: m.ClipGradByNorm(0.3),
          "ClipGradByGlobalNorm": lambda m: m.ClipGradByGlobalNorm(0.3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_clip_class_matches_jax(name, dtype):
    """The class on (param, grad) pairs, with one parameter whose
    need_clip is False and a None gradient, and the bare-gradient form
    `apply_grad_clip_values`, against the JAX class and function."""
    rs = np.random.RandomState(4)
    gs = [(rs.randn(5, 7) * s).astype(np.float32) for s in (0.01, 0.3, 2)]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jclip_, tclip_ = _CLIPS[name](jclip), _CLIPS[name](tclip)
    jps = [JaxParameter(jnp.zeros((5, 7), jdt)) for _ in range(4)]
    tps = [torch.nn.Parameter(torch.zeros(5, 7, dtype=tdt))
           for _ in range(4)]
    jps[1].need_clip = False
    tps[1].need_clip = False
    jg = [paddle.to_tensor(jnp.asarray(g, jdt)) for g in gs] + [None]
    tg = [torch.from_numpy(g).to(tdt) for g in gs] + [None]
    want = jclip_(list(zip(jps, jg)))
    got = tclip_(list(zip(tps, tg)))
    assert got[3][1] is None and got[1][1] is tg[1]
    pairs = [(np.asarray(jnp.asarray(w._value, jnp.float32)),
              g.float().numpy()) for (_, w), (_, g) in zip(want[:3],
                                                           got[:3])]
    want_bare = jclip.apply_grad_clip_values(
        jclip_, [jnp.asarray(g, jdt) for g in gs])
    got_bare = tclip.apply_grad_clip_values(
        tclip_, [torch.from_numpy(g).to(tdt) for g in gs])
    pairs += [(np.asarray(jnp.asarray(w, jnp.float32)), g.float().numpy())
              for w, g in zip(want_bare, got_bare)]
    for w, g in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **F32)
        else:
            _within_bf16_ulp(g, w)
    assert all(g.dtype == tdt for g in got_bare)
    # the clip bit: at least one gradient changed
    assert any(not np.array_equal(g.float().numpy(),
                                  torch.from_numpy(a).to(tdt).float().numpy())
               for g, a in zip(got_bare, gs))


@pytest.mark.parametrize("norm_type", [2.0, 1.5, float("inf")])
def test_clip_grad_norm_and_value_match_jax(norm_type):
    rs = np.random.RandomState(5)
    gs = [(rs.randn(4, 6) * s).astype(np.float32) for s in (0.2, 1.5)]
    jps = [JaxParameter(jnp.zeros((4, 6))) for _ in gs]
    tps = [torch.nn.Parameter(torch.zeros(4, 6)) for _ in gs]
    for jp, tp, g in zip(jps, tps, gs):
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.from_numpy(g.copy())
    want = float(jclip.clip_grad_norm_(jps, 1.0, norm_type))
    got = float(tclip.clip_grad_norm_(tps, 1.0, norm_type))
    assert got == pytest.approx(want, rel=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(), **F32)
    jclip.clip_grad_value_(jps, 0.02)
    tclip.clip_grad_value_(tps, 0.02)
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(tp.grad.numpy(), jp.grad.numpy())
    assert tclip.GradientClipByGlobalNorm is tclip.ClipGradByGlobalNorm


@pytest.mark.parametrize("path", ["eager", "compiled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_adam_steps_with_each_clip_match_jax(name, dtype, path):
    """Three Adam steps of different gradients under each clip class
    (which then changes the steps' relative sizes), eager and through
    the train step, against the JAX package's."""
    want, _ = _run_jax(lambda ps: jopt.Adam(
        0.05, parameters=ps, grad_clip=_CLIPS[name](jclip)), path, dtype)
    got, _ = _run_port(lambda ps: topt.Adam(
        0.05, parameters=ps, grad_clip=_CLIPS[name](tclip)), path, dtype)
    unclipped, _ = _run_port(lambda ps: topt.Adam(0.05, parameters=ps),
                             path, dtype)
    for g, w in zip(got, want):
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **F32)
        else:
            _within_bf16_ulp(g, w)
    assert any(not np.array_equal(g, u) for g, u in zip(got, unclipped))


# -- multi_precision -------------------------------------------------------
@pytest.mark.parametrize("path", ["eager", "compiled"])
@pytest.mark.parametrize("cls", ["Adam", "AdamW"])
def test_multi_precision_master_weights_match_jax(cls, path):
    """A bf16 model: the f32 masters against JAX's (rtol 1e-6), each bf16
    parameter the master rounded (bit for bit) and within one bf16 ulp
    of JAX's; moments f32; the state_dict keys JAX's."""
    lr = 1e-3
    want, jo = _run_jax(lambda ps: getattr(jopt, cls)(
        lr, parameters=ps, multi_precision=True), path, "bfloat16")
    got, to = _run_port(lambda ps: getattr(topt, cls)(
        lr, parameters=ps, multi_precision=True), path, "bfloat16")
    sd = to.state_dict()
    jsd = jo.state_dict()
    jnames = [p.name for p in jo._parameter_list]
    for i, name in enumerate(("w", "b")):
        master = sd[f"{name}_master_weight_0"]
        assert master.dtype == torch.float32
        assert sd[f"{name}_moment1_0"].dtype == torch.float32
        np.testing.assert_allclose(
            master.numpy(), jsd[f"{jnames[i]}_master_weight_0"].numpy(),
            **F32)
        np.testing.assert_array_equal(
            got[i], master.to(torch.bfloat16).float().numpy())
        _within_bf16_ulp(got[i], want[i])
    rename = dict(zip(jnames, ("w", "b")))

    def renamed(key):
        for jn, tn in rename.items():
            if key.startswith(jn + "_"):
                return tn + key[len(jn):]
        return key

    jkeys = sorted(renamed(k) for k in jsd)
    assert sorted(sd) == jkeys
    # a bf16 step alone would lose what the master keeps: lr 1e-3 moves
    # each weight by about 1e-3, under half a bf16 ulp of most of them
    plain, _ = _run_port(lambda ps: getattr(topt, cls)(lr, parameters=ps),
                         path, "bfloat16")
    assert any(not np.array_equal(g, p) for g, p in zip(got, plain))


def test_set_state_dict_restores_the_master_weights():
    m = Linear2(torch.bfloat16)
    o = topt.AdamW(1e-3, parameters=list(m.named_parameters()),
                   multi_precision=True)
    step = tjit.compile_train_step(m.loss, m, o)
    c, d = (torch.from_numpy(a).to(torch.bfloat16) for a in _batches(1)[0])
    step(c, d)
    m2 = Linear2(torch.bfloat16)
    o2 = topt.AdamW(1e-3, parameters=list(m2.named_parameters()),
                    multi_precision=True)
    o2.set_state_dict(o.state_dict())
    with torch.no_grad():
        m2.w.copy_(m.w)
        m2.b.copy_(m.b)
    step2 = tjit.compile_train_step(m2.loss, m2, o2)
    step(c, d)
    step2(c, d)
    for k, v in o.state_dict().items():
        v2 = o2.state_dict()[k]
        assert (torch.equal(v, v2) if torch.is_tensor(v) else v == v2), k


# -- gradient merge --------------------------------------------------------
class _Capture:
    """Stands in for the optimizer: records the gradients the train step
    hands to the update."""

    _gradient_merge_avg = True

    def __init__(self, params):
        self._parameter_list = list(params)
        self.grads = None

    def _step(self, compiled):
        self.grads = [p.grad.clone() for p in self._parameter_list]

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge_is_the_f32_sum_bit_for_bit(avg, k):
    """accumulate_steps=k on a bf16 Llama: each micro-batch's gradient
    added in f32, divided by k when averaging, then cast to bf16 — not
    torch's bf16 accumulation in .grad, which rounds at every add past
    the second; the loss the mean of the micro-batch losses."""
    geo = dict(vocab_size=89, hidden_size=64, num_hidden_layers=1,
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=96, max_position_embeddings=64)
    m = LlamaForCausalLM(LlamaConfig(**geo), device="cpu",
                         dtype=torch.bfloat16, seed=2).train()
    ids = torch.from_numpy(np.random.RandomState(6).randint(0, 89, (4, 16)))
    params = list(m.parameters())
    want, losses = [torch.zeros(p.shape) for p in params], []
    for part in ids.chunk(k):
        loss = m(part, labels=part).float()
        loss.backward()
        losses.append(loss.detach())
        for acc, p in zip(want, params):
            acc.add_(p.grad.float())
            p.grad = None
    want32 = [a / k if avg else a for a in want]
    want = [a.to(torch.bfloat16) for a in want32]
    cap = _Capture(params)
    cap._gradient_merge_avg = avg
    step = tjit.compile_train_step(lambda i: m(i, labels=i), m, cap,
                                   accumulate_steps=k)
    loss = step(ids)
    assert all(torch.equal(g, w) for g, w in zip(cap.grads, want))
    assert all(g.dtype == torch.bfloat16 for g in cap.grads)
    assert torch.equal(loss, torch.stack(losses).mean())
    assert [x.item() for x in step.micro_losses] == \
        [x.item() for x in losses]
    if k > 2:
        # torch's own accumulation in .grad rounds in bf16 at each add
        for p in params:
            p.grad = None
        for part in ids.chunk(k):
            m(part, labels=part).float().backward()
        assert any(not torch.equal(p.grad, (w * k if avg else w).to(
            torch.bfloat16)) for p, w in zip(params, want32))
    with pytest.raises(ValueError, match="not divisible"):
        tjit.compile_train_step(lambda i: m(i, labels=i), m, cap,
                                accumulate_steps=3)(ids)
