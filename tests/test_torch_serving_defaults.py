"""The port's engine at its defaults against the JAX engine at its
defaults: the grouped walk, overload preemption and the host tier.

`ServingEngine(model)` means the same engine in both packages. At the
phase-7 geometry of `__graft_entry__.dryrun_multichip` (vocab 256,
hidden 64, 2 layers, 4 heads) with shared-prefix traffic, the greedy
tokens and the modeled page-block reads equal the JAX engine's; at the
geometry of `tests/test_serving_overload.py`, so do a preemption cycle
(tokens, preemption and swap counts, quiescence after `drain()`) and a
prefix spill and restore. The host-tier and priority-scheduling units of
that file run against the port's classes.
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
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (DeadlineExceeded, EngineClosed,
                                      HostPagePool, PagePool, QueueFull,
                                      Request, RequestState, SamplingParams,
                                      Scheduler, ServingEngine,
                                      resolve_grouped_flag,
                                      resolve_preempt_flag)

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=8)
# tests/test_serving_overload.py's preemption geometry: a pool sized so
# that preemption is the only way in
OVERLOAD = dict(num_slots=2, max_len=64, page_size=8, num_pages=6,
                chunk_len=16)
# and its prefix-spill geometry
SPILL = dict(num_slots=1, max_len=32, page_size=8, num_pages=5, chunk_len=8)
# f32 on both sides; the frameworks sum in different orders
LOGIT_TOL = 1e-4


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its engines step tiny
    tensors op by op, and beside the other test workers a pool of
    threads a process only waits for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX GPT and its port with the same weights. The JAX GPT needs
    `jax.experimental.disable_x64`, which this jax lacks: a stand-in that
    raises if entered is put there for the module (the JAX side runs its
    jnp paths), as in tests/test_torch_gpt_serving.py."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
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


def _assert_clear_margins(tm, prompts, outputs):
    """Every emitted token won its step by more than 10 x LOGIT_TOL
    (teacher-forced through the port), so agreement with the JAX engine
    is not luck at a near-tie."""
    for p, toks in zip(prompts, outputs):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int64)])
        with torch.no_grad():
            lg = tm(torch.from_numpy(seq)[None])[0, p.size - 1:]
        top2 = torch.topk(lg, 2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min().item() > 10 * LOGIT_TOL
        assert torch.argmax(lg, dim=-1).tolist() == list(toks)


def _shared_prefix_prompts():
    rs = np.random.RandomState(21)
    system = rs.randint(0, 256, size=20)
    return [np.concatenate([system, rs.randint(0, 256, size=n)])
            .astype(np.int64) for n in (3, 9, 5, 12, 7, 2)]


def _serve_shared_prefix(eng, sampling):
    """The first prompt alone (its pages enter the radix tree), then the
    rest together: they attach its prefix pages and walk them as one
    group."""
    prompts = _shared_prefix_prompts()
    first = eng.generate(prompts[:1], sampling(4))
    rest = eng.generate(prompts[1:], sampling(8))
    return [list(r.token_ids) for r in first + rest]


@pytest.fixture(scope="module")
def jax_defaults(models):
    eng = JaxEngine(models[0], **ENGINE)
    assert eng.grouped and eng.preempt and eng.prefix_cache is not None
    tokens = _serve_shared_prefix(
        eng, lambda n: JaxSampling(max_new_tokens=n))
    return tokens, eng.metrics


def test_default_engine_matches_the_jax_default_engine(models,
                                                       jax_defaults):
    tm = models[1]
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    assert eng.grouped and eng.preempt
    assert eng.host_pages == eng.num_pages - 1
    tokens = _serve_shared_prefix(
        eng, lambda n: SamplingParams(max_new_tokens=n))
    want, jm = jax_defaults
    assert tokens == want
    prompts = _shared_prefix_prompts()
    _assert_clear_margins(tm, prompts, tokens)
    assert eng.metrics.page_block_reads == jm.page_block_reads
    assert eng.metrics.shared_page_reads_saved == \
        jm.shared_page_reads_saved > 0
    assert eng.metrics.group_size_hist.max >= 2
    snap = eng.metrics.snapshot()
    assert snap["grouped"] is True
    assert snap["page_block_reads_total"] == jm.page_block_reads
    eng.drain()


def test_grouped_off_gives_the_same_tokens_and_no_saved_reads(models,
                                                              jax_defaults):
    eng = ServingEngine(models[1], device="cpu", grouped=False, **ENGINE)
    tokens = _serve_shared_prefix(
        eng, lambda n: SamplingParams(max_new_tokens=n))
    assert tokens == jax_defaults[0]
    assert eng.metrics.shared_page_reads_saved == 0
    assert eng.metrics.page_block_reads == \
        jax_defaults[1].page_block_reads \
        + jax_defaults[1].shared_page_reads_saved


def _preempt_cycle(eng, sampling):
    """A priority-5 resident, then a priority-0 arrival after 6 steps
    that only preemption can admit (tests/test_serving_overload.py)."""
    lo = eng.add_request(np.arange(1, 9), sampling(24, 5))
    for _ in range(6):
        eng.step()
    assert len(lo.output_tokens) >= 3
    hi = eng.add_request(np.arange(30, 38), sampling(24, 0))
    eng.run()
    return lo, hi


@pytest.fixture(scope="module")
def jax_preempt(models):
    eng = JaxEngine(models[0], **OVERLOAD)
    lo, hi = _preempt_cycle(
        eng, lambda n, p: JaxSampling(max_new_tokens=n, priority=p))
    m = eng.metrics
    out = dict(lo=list(lo.output_tokens), hi=list(hi.output_tokens),
               lo_preemptions=lo.preemptions, preemptions=m.preemptions,
               swapped_out=m.swapped_out_pages, swapped_in=m.swapped_in_pages,
               spilled=eng.prefix_cache.spilled_pages_total,
               restored=eng.prefix_cache.restored_pages_total)
    eng.drain()
    return out


def test_preemption_matches_the_jax_engine(models, jax_preempt):
    tm = models[1]
    eng = ServingEngine(tm, device="cpu", **OVERLOAD)
    lo, hi = _preempt_cycle(
        eng, lambda n, p: SamplingParams(max_new_tokens=n, priority=p))
    m = eng.metrics
    assert lo.output_tokens == jax_preempt["lo"]
    assert hi.output_tokens == jax_preempt["hi"]
    assert lo.preemptions == jax_preempt["lo_preemptions"] >= 1
    assert hi.preemptions == 0 and lo.output().preemptions >= 1
    assert m.preemptions == jax_preempt["preemptions"]
    assert m.swapped_out_pages == jax_preempt["swapped_out"] >= 1
    assert m.swapped_in_pages == jax_preempt["swapped_in"] >= 1
    assert eng.prefix_cache.spilled_pages_total == jax_preempt["spilled"]
    assert eng.prefix_cache.restored_pages_total == jax_preempt["restored"]
    _assert_clear_margins(tm, [np.arange(1, 9), np.arange(30, 38)],
                          [lo.output_tokens, hi.output_tokens])
    eng.drain()
    eng.pool.assert_quiesced()
    assert eng.pool.swapped_pages == eng.host_pool.used_pages
    with pytest.raises(EngineClosed):
        eng.add_request(np.arange(1, 9))


def _solo(tm, prompt, n):
    eng = ServingEngine(tm, device="cpu", **ENGINE)
    return eng.generate([prompt], SamplingParams(max_new_tokens=n))[0] \
        .token_ids


def test_a_request_preempted_twice_streams_exactly(models):
    tm = models[1]
    eng = ServingEngine(tm, device="cpu", **OVERLOAD)
    lo = eng.add_request(np.arange(1, 9),
                         SamplingParams(max_new_tokens=30, priority=9))
    for _ in range(5):
        eng.step()
    mid = eng.add_request(np.arange(20, 28),
                          SamplingParams(max_new_tokens=8, priority=5))
    while not mid.finished:
        eng.step()
    while not lo.output_tokens or lo.state is not RequestState.DECODE:
        eng.step()                      # lo resumed and decoding again
    banked = len(lo.output_tokens)
    hi = eng.add_request(np.arange(40, 48),
                         SamplingParams(max_new_tokens=8, priority=0))
    eng.run()
    assert lo.preemptions >= 2 and banked < 30
    assert lo.output_tokens == _solo(tm, np.arange(1, 9), 30)
    assert mid.output_tokens == _solo(tm, np.arange(20, 28), 8)
    assert hi.output_tokens == _solo(tm, np.arange(40, 48), 8)
    eng.drain()


def test_preempted_then_cancelled_releases_the_host_tier(models):
    eng = ServingEngine(models[1], device="cpu", num_slots=1, max_len=64,
                        page_size=8, num_pages=9, chunk_len=16)
    lo = eng.add_request(np.arange(1, 9),
                         SamplingParams(max_new_tokens=24, priority=5))
    for _ in range(4):
        eng.step()
    eng.add_request(np.arange(30, 38),
                    SamplingParams(max_new_tokens=4, priority=0))
    eng.step()                          # preempts lo (slot pressure)
    assert lo.state is RequestState.PREEMPTED
    assert eng.host_pool.used_pages >= 1
    assert eng.pool.swapped_pages == eng.host_pool.used_pages
    assert eng.cancel(lo.request_id)
    assert lo.finish_reason == "cancelled"
    assert eng.host_pool.used_pages == 0 and eng.pool.swapped_pages == 0
    eng.run()
    eng.drain()


def test_drain_resumes_a_preempted_request(models):
    tm = models[1]
    eng = ServingEngine(tm, device="cpu", num_slots=1, max_len=64,
                        page_size=8, num_pages=9, chunk_len=16)
    lo = eng.add_request(np.arange(1, 9),
                         SamplingParams(max_new_tokens=20, priority=5))
    for _ in range(4):
        eng.step()
    eng.add_request(np.arange(30, 38),
                    SamplingParams(max_new_tokens=4, priority=0))
    eng.step()
    assert lo.state is RequestState.PREEMPTED
    queued = eng.add_request(np.arange(50, 58),
                             SamplingParams(max_new_tokens=4, priority=7))
    eng.drain()
    assert lo.finish_reason == "length"
    assert queued.finish_reason == "aborted"
    assert lo.output_tokens == _solo(tm, np.arange(1, 9), 20)


def test_recompute_when_the_host_tier_is_off(models):
    """host_pages=0: preemption keeps nothing on the host and the resume
    recomputes the banked sequence; the tokens do not change."""
    tm = models[1]
    eng = ServingEngine(tm, device="cpu", host_pages=0, **OVERLOAD)
    lo, hi = _preempt_cycle(
        eng, lambda n, p: SamplingParams(max_new_tokens=n, priority=p))
    assert eng.metrics.preemptions >= 1
    assert eng.metrics.swapped_out_pages == 0
    assert lo.output_tokens == _solo(tm, np.arange(1, 9), 24)
    assert hi.output_tokens == _solo(tm, np.arange(30, 38), 24)
    eng.drain()


def _spill_trace(eng, sampling):
    base = np.arange(1, 10, dtype=np.int64)
    out = [eng.generate([base], sampling)[0]]
    out += eng.generate([np.arange(40, 57)], sampling)
    out += eng.generate([base], sampling)
    return [list(r.token_ids) for r in out], out[2].cached_tokens


def test_prefix_spill_matches_the_jax_engine(models):
    jeng = JaxEngine(models[0], **SPILL)
    want, want_cached = _spill_trace(jeng, JaxSampling(max_new_tokens=4))
    eng = ServingEngine(models[1], device="cpu", **SPILL)
    got, cached = _spill_trace(eng, SamplingParams(max_new_tokens=4))
    assert got == want and got[0] == got[2]
    assert cached == want_cached > 0
    pc, jpc = eng.prefix_cache, jeng.prefix_cache
    assert pc.spilled_pages_total == jpc.spilled_pages_total >= 1
    assert pc.restored_pages_total == jpc.restored_pages_total >= 1
    snap = eng.metrics.snapshot()
    assert snap["swapped_in_pages"] == jeng.metrics.swapped_in_pages
    eng.drain()


def test_gates_resolve_like_the_jax_engine(monkeypatch, models):
    for resolve, env in ((resolve_grouped_flag, "PADDLE_TPU_GROUPED_ATTN"),
                         (resolve_preempt_flag, "PADDLE_TPU_PREEMPT")):
        assert resolve(True) is True and resolve(False) is False
        monkeypatch.delenv(env, raising=False)
        assert resolve() is True
        monkeypatch.setenv(env, "off")
        assert resolve() is False
        monkeypatch.setenv(env, "sideways")
        with pytest.raises(ValueError):
            resolve()
        monkeypatch.delenv(env)
    monkeypatch.setenv("PADDLE_TPU_GROUPED_ATTN", "off")
    monkeypatch.setenv("PADDLE_TPU_PREEMPT", "off")
    eng = ServingEngine(models[1], device="cpu", **ENGINE)
    assert not eng.grouped and not eng.preempt
    assert eng.metrics.snapshot()["grouped"] is False


def test_preempt_off_backpressures_instead(models):
    eng = ServingEngine(models[1], device="cpu", preempt=False, **OVERLOAD)
    lo, hi = _preempt_cycle(
        eng, lambda n, p: SamplingParams(max_new_tokens=n, priority=p))
    assert eng.metrics.preemptions == 0 and lo.preemptions == 0
    assert lo.finish_reason == hi.finish_reason == "length"
    assert hi.admitted_t >= lo.finished_t
    eng.drain()


def test_placement_deadline_fails_a_queued_request_fast(models):
    t = [0.0]
    eng = ServingEngine(models[1], device="cpu", num_slots=1, max_len=64,
                        preempt=False, clock=lambda: t[0])
    running = eng.add_request(
        np.arange(1, 9), SamplingParams(max_new_tokens=30, deadline_s=5.0))
    eng.step()                          # admitted: its deadline is met
    queued = eng.add_request(
        np.arange(30, 38), SamplingParams(max_new_tokens=4, deadline_s=0.5))
    t[0] = 1.0
    finished = eng.step()
    assert [o.request_id for o in finished] == [queued.request_id]
    assert queued.finish_reason == "deadline" and not queued.output_tokens
    assert isinstance(queued.error, DeadlineExceeded)
    assert eng.metrics.requests_deadline == 1
    t[0] = 2.0
    eng.run()
    assert running.finish_reason == "length"
    eng.drain()


# -- tests/test_serving_overload.py's units, on the port's classes -----------
def _double_swap_out_raises():
    pool = PagePool(5)
    pages = pool.alloc(2)
    pool.swap_out(pages)
    assert pool.swapped_pages == 2
    with pytest.raises(ValueError, match="swap_out of free"):
        pool.swap_out(pages)


def _swap_out_shared_or_unowned_raises():
    pool = PagePool(5)
    pages = pool.alloc(1)
    pool.retain(pages)
    with pytest.raises(ValueError, match="still shared"):
        pool.swap_out(pages)
    pool.release(pages)
    pool.release(pages)
    with pytest.raises(ValueError, match="unowned"):
        pool.swap_out(pages)


def _swap_in_of_freed_host_page_raises():
    host = HostPagePool(2)
    slot = host.store(b"payload")
    assert host.load(slot) == b"payload"
    host.free(slot)
    with pytest.raises(ValueError, match="swap-in of a freed"):
        host.load(slot)
    with pytest.raises(ValueError, match="double free"):
        host.free(slot)


def _host_pool_capacity_bounds_store():
    host = HostPagePool(1)
    a = host.store(b"a")
    assert a is not None and host.free_pages == 0
    assert host.store(b"b") is None
    host.free(a)
    assert host.store(b"b") is not None


def _park_then_spill_refcounts():
    pool = PagePool(5)
    pages = pool.alloc(1)
    pool.release(pages)
    pool.park(pages)
    assert pool.cached_pages == 1
    pool.swap_out(pages, spill=True)
    assert pool.cached_pages == 0 and pool.swapped_pages == 1
    assert pool.free_pages == 4
    fresh = pool.alloc(1)
    pool.swapped_restored(1, spill=True)
    pool.release(fresh)
    pool.park(fresh)
    assert pool.swapped_pages == 0 and pool.cached_pages == 1
    pool.assert_quiesced()


def _assert_quiesced_counts_swapped():
    pool = PagePool(5)
    pages = pool.alloc(2)
    pool.swap_out(pages)
    with pytest.raises(RuntimeError, match="host-tier leak"):
        pool.assert_quiesced()
    pool.drop_swapped(2)
    pool.assert_quiesced()
    spill = pool.alloc(1)
    pool.release(spill)
    pool.park(spill)
    pool.swap_out(spill, spill=True)
    pool.assert_quiesced()


def _swapped_drain_overdraw_raises():
    pool = PagePool(5)
    pages = pool.alloc(1)
    pool.swap_out(pages)
    with pytest.raises(ValueError, match="only 1 are outstanding"):
        pool.swapped_restored(2)
    with pytest.raises(ValueError, match="only 0 are outstanding"):
        pool.drop_swapped(1, spill=True)
    pool.swapped_restored(1)


def _req(rid, *, priority=0, deadline_s=None, arrival=0.0):
    return Request(rid, np.array([1, 2, 3], np.int64),
                   SamplingParams(max_new_tokens=4, priority=priority,
                                  deadline_s=deadline_s),
                   arrival_t=arrival)


def _queue_orders_priority_then_deadline_then_arrival():
    s = Scheduler(num_slots=4)
    for r in (_req("early-lo", priority=5, arrival=0.0),
              _req("no-dl", priority=0, arrival=1.0),
              _req("late-hi", priority=0, arrival=3.0),
              _req("dl", priority=0, deadline_s=1.0, arrival=2.0)):
        s.submit(r)
    assert [r.request_id for _, r in s.assign()] == \
        ["dl", "no-dl", "late-hi", "early-lo"]


def _requeue_bypasses_max_queue():
    s = Scheduler(num_slots=1, max_queue=1)
    s.submit(_req("a"))
    with pytest.raises(QueueFull):
        s.submit(_req("b"))
    s.requeue(_req("preempted", priority=9))
    assert s.queue_depth == 2


def _deadline_expired_excludes_admitted():
    s = Scheduler(num_slots=2)
    fresh = _req("fresh", deadline_s=1.0, arrival=0.0)
    resumed = _req("resumed", deadline_s=1.0, arrival=0.0)
    resumed.admitted_t = 0.5
    resumed.state = RequestState.PREEMPTED
    s.submit(fresh)
    s.requeue(resumed)
    assert s.deadline_expired(2.0) == [fresh]


def _preemption_victim_strict_priority():
    s = Scheduler(num_slots=3)
    a, b, c = (_req("a", priority=5, arrival=0.0),
               _req("b", priority=9, arrival=1.0),
               _req("c", priority=9, arrival=0.5))
    for slot, r in enumerate((a, b, c)):
        r.state = RequestState.DECODE
        s.running[slot] = r
    assert s.preemption_victim(_req("head", priority=5))[1] is b
    assert s.preemption_victim(_req("h9", priority=9)) is None
    assert s.preemption_victim(_req("h0", priority=0))[1] is b


_UNITS = [_double_swap_out_raises, _swap_out_shared_or_unowned_raises,
          _swap_in_of_freed_host_page_raises,
          _host_pool_capacity_bounds_store, _park_then_spill_refcounts,
          _assert_quiesced_counts_swapped, _swapped_drain_overdraw_raises,
          _queue_orders_priority_then_deadline_then_arrival,
          _requeue_bypasses_max_queue, _deadline_expired_excludes_admitted,
          _preemption_victim_strict_priority]


@pytest.mark.parametrize("case", _UNITS, ids=lambda f: f.__name__[1:])
def test_host_tier_and_priority_units(case):
    case()
