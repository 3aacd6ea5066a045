"""The SLO tracker and the cost census of the port's serving engine,
against the JAX package's `serving/slo.py`.

The tracker runs on a fake clock with no engine: the same seeded event
stream (TTFT, inter-token and goodput observations over priority classes
and adapter ids, with idle gaps longer than both windows) goes into the
port's and the JAX `SLOTracker`, and the states, burns, transitions and
snapshot dicts must be equal (exactly: both compute the same float
expressions in the same order). `parse_slo_spec`, `resolve_slo_config`
and `resolve_cost_census` take the same spellings and refuse the same
ones with the same texts; `model_cost_census` gives the JAX numbers
exactly. The census's counted forward (`"lowered"`) is held on a small
port engine: captured once, counting the hand-written kernels by their
wrappers' reckoning, leaving the pools (but the trash page), positions,
cursors and held logits bit for bit, and the tokens equal to a run with
the census off.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import slo as jslo
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import cost as tcost
from paddle_tpu_torch.serving import SamplingParams, ServingEngine
from paddle_tpu_torch.serving import slo as tslo

SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=2, max_position_embeddings=64)
ENGINE = dict(device="cpu", num_slots=3, max_len=48, page_size=8,
              chunk_len=8, grouped=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (tiny engines beside
    the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_env(monkeypatch):
    for g in ("PADDLE_TPU_SLO", "PADDLE_TPU_COST_CENSUS"):
        monkeypatch.delenv(g, raising=False)
    return monkeypatch


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", [
    "off", "on", "", "ttft_p99=0.25,itl_p99=0.05,goodput=0.995,fast=30",
    "warn=3,page=12,min_events=5,slow=120", " ttft_p99 = 1.5 ",
    "ttft=1", "fast", "goodput=1.0", "goodput=0", "min_events=2.5",
    "ttft_p99=abc"])
def test_parse_slo_spec_matches_jax(spec):
    got, want = _outcome(tslo.parse_slo_spec, spec), \
        _outcome(jslo.parse_slo_spec, spec)
    assert got[0] == want[0]
    if got[0] == "ok":
        g, w = got[1], want[1]
        assert (g is None) == (w is None)
        if g is not None:
            assert vars(g) == vars(w)
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("override,env", [
    (None, None), (None, "off"), (None, "ttft_p99=0.5"), (False, "on"),
    ("off", None), ("fast=10", None), (True, "warn=4"),
    (None, "nonsense")])
def test_resolve_slo_config_matches_jax(clean_env, override, env):
    if env is not None:
        clean_env.setenv("PADDLE_TPU_SLO", env)
    got = _outcome(tslo.resolve_slo_config, override)
    want = _outcome(jslo.resolve_slo_config, override)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert (None if got[1] is None else vars(got[1])) == \
            (None if want[1] is None else vars(want[1]))
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("override,env", [
    (None, None), (None, "lowered"), (None, "xla"), (None, "off"),
    (False, "model"), (True, "lowered"), ("model", "off"), ("hlo", None),
    (None, "HLO")])
def test_resolve_cost_census_matches_jax(clean_env, override, env):
    if env is not None:
        clean_env.setenv("PADDLE_TPU_COST_CENSUS", env)
    assert _outcome(tslo.resolve_cost_census, override) == \
        _outcome(jslo.resolve_cost_census, override)
    assert tslo.COST_CENSUS_MODES == jslo.COST_CENSUS_MODES
    assert tslo.SLO_STATE_CODES == jslo.SLO_STATE_CODES
    assert tslo.SLO_NAMES == jslo.SLO_NAMES


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _stream(seed, n=600):
    """A seeded event stream: (dt to advance, kind, value, priority,
    adapter); bursts of slow TTFTs and inter-token gaps and missed
    deadlines, with two idle gaps past both windows, over 11 priority
    classes and 10 adapters (both past the label cap of 8)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        dt = float(rs.exponential(0.8))
        if i in (200, 420):
            dt = 700.0
        bad = (i // 60) % 3 == 1
        kind = ("ttft", "itl", "goodput")[rs.randint(3)]
        if kind == "ttft":
            v = float(rs.uniform(2.1, 5.0) if bad and rs.rand() < 0.6
                      else rs.uniform(0.01, 1.9))
        elif kind == "itl":
            v = float(rs.uniform(0.6, 2.0) if bad and rs.rand() < 0.6
                      else rs.uniform(0.001, 0.4))
        else:
            v = bool(not (bad and rs.rand() < 0.5))
        out.append((dt, kind, v, int(rs.randint(11)), int(rs.randint(10))))
    return out


@pytest.mark.parametrize("track_adapters", [False, True])
@pytest.mark.parametrize("spec", ["on", "fast=30,slow=120,min_events=10"])
def test_tracker_on_a_fake_clock_matches_jax(spec, track_adapters):
    """The same stream into both trackers: every transition (through the
    callback and the bounded log), the states and burns read mid-stream
    and at the end, and the snapshot dict, exactly."""
    trackers, fired = [], []
    for mod in (tslo, jslo):
        clock, seen = FakeClock(), []
        trackers.append((mod.SLOTracker(
            mod.parse_slo_spec(spec), clock=clock, on_transition=seen.append,
            track_adapters=track_adapters, max_transitions=16), clock))
        fired.append(seen)
    reads = [[], []]
    for i, (dt, kind, v, pr, aid) in enumerate(_stream(3)):
        for side, (tr, clock) in enumerate(trackers):
            clock.t += dt
            hook = {"ttft": tr.on_ttft, "itl": tr.on_inter_token,
                    "goodput": tr.on_goodput}[kind]
            hook(v, priority=pr, adapter_id=aid)
            if i % 37 == 0:
                reads[side].append((tr.states(), tr.worst_state(),
                                    tr.worst_burns()))
    assert fired[0] == fired[1] and len(fired[0]) > 4
    assert {t["to"] for t in fired[0]} >= {"warn", "page", "ok"}
    assert reads[0] == reads[1]
    (port, pc), (ref, rc) = trackers
    assert port.snapshot() == ref.snapshot()
    assert list(port.transitions) == list(ref.transitions)
    assert len(port.transitions) == 16
    labels = port.snapshot()["series"]["ttft_p99"]
    assert "priority:other" in labels
    assert ("adapter:other" in labels) is track_adapters
    # an idle gap past the fast window de-escalates with no new event
    pc.t += 100.0
    rc.t += 100.0
    assert port.states() == ref.states()
    assert port.worst_state() == "ok"
    port.reset()
    ref.reset()
    assert port.snapshot() == ref.snapshot()


@pytest.mark.parametrize("geom", [
    dict(n_params=124_439_808, param_bytes=248_879_616, num_slots=16,
         chunk_len=32, max_pages=32, page_bytes=589_824, n_heads=12,
         head_dim=64, page_size=16),
    dict(n_params=6_738_415_616, param_bytes=13_476_831_232, num_slots=8,
         chunk_len=64, max_pages=16, page_bytes=4_194_304, n_heads=32,
         head_dim=128, page_size=16, mp=1),
    dict(n_params=1234, param_bytes=4936, num_slots=3, chunk_len=8,
         max_pages=6, page_bytes=1024, n_heads=2, head_dim=16,
         page_size=8, mp=2)])
def test_model_cost_census_is_exact(geom):
    assert tslo.model_cost_census(**geom) == jslo.model_cost_census(**geom)
    fb = tslo.model_cost_census(**geom)
    cap = geom["num_slots"] * geom["chunk_len"]
    got = tslo.capture_cost_census("model", None, None,
                                   capacity_tokens=cap, fallback=fb)
    assert got == jslo.capture_cost_census("model", None, None,
                                           capacity_tokens=cap, fallback=fb)
    assert tslo.capture_cost_census("off", None, None, capacity_tokens=cap,
                                    fallback=fb) is None


def test_counted_census_falls_back_to_the_model_and_says_so():
    """A count that raises gives the "model" record, whose source says
    "model", for either counted mode."""
    fb = {"flops": 10.0, "bytes_accessed": 20.0}

    def boom():
        raise RuntimeError("no forward")

    for mode in ("lowered", "xla"):
        got = tslo.capture_cost_census(mode, boom, (), capacity_tokens=4,
                                       fallback=fb)
        assert got["source"] == "model" and got["flops"] == 10.0
        got = tslo.capture_cost_census(mode, lambda: None, (),
                                       capacity_tokens=4, fallback=fb)
        assert got["source"] == mode and got["flops"] == 0.0


def test_count_cost_counts_torch_ops_and_marked_wrappers():
    """A matrix product's FLOPs are torch's flop counter's (2 M N K) and
    its bytes its operands' and result's; views count nothing; a marked
    wrapper adds its reckoning and nothing it runs inside."""
    a, b = torch.ones(4, 6), torch.ones(6, 5)
    got, out = tcost.count_cost(lambda: (a @ b).t())
    assert out.shape == (5, 4)
    assert got["flops"] == 2 * 4 * 6 * 5
    assert got["bytes_accessed"] == 4 * (4 * 6 + 6 * 5 + 4 * 5)

    @tcost.kernel_cost(lambda x: ("KX", 7, 11))
    def wrapper(x):
        return (x @ x.t()).sum()

    got, _ = tcost.count_cost(lambda: wrapper(a) + wrapper(a))
    assert got["kernels"] == {"KX": [2, 14, 22]}
    # the add of the two results is counted beside the two kernels
    assert got["flops"] == 14 and got["bytes_accessed"] == 22 + 3 * 4
    assert wrapper(a).item() == 96.0       # unmarked when nothing counts


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return GPTForCausalLM(GPTConfig(**SMALL), device="cpu").eval()


def _prompts():
    rs = np.random.RandomState(5)
    return [rs.randint(0, 64, size=n).astype(np.int64) for n in (5, 17, 9)]


def _host_state(eng):
    return (eng._pos.copy(), dict(eng._prefill_cursor),
            eng._last_logits.clone(), eng._pt_host.copy(),
            [tuple(None if t is None else t.clone() for t in layer)
             for layer in eng._pools])


@pytest.mark.parametrize("arm", [
    dict(), dict(grouped=True), dict(megakernel=True),
    dict(kv_dtype="int8"), dict(adapters=True)])
def test_lowered_census_counts_once_and_moves_nothing(model, arm):
    """Mid-run (a resident prefilling, others decoding), the first
    `cost_census()` read counts one forward: the pools but the trash
    page, the positions, cursors, page tables and held logits stay bit
    for bit, and the run's tokens equal a census-off run's. The record
    names its source, counts each kernel of the step once a layer, and
    later reads (`debug_state`, the snapshot) return it without another
    capture."""
    kw = {**ENGINE, **arm}
    off = ServingEngine(model, cost_census="off", **kw)
    want = [list(r.token_ids) for r in off.generate(
        _prompts(), SamplingParams(max_new_tokens=6))]
    assert off.cost_census() is None and off.metrics.cost_census is None
    eng = ServingEngine(model, cost_census="lowered", **kw)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=6))
            for p in _prompts()]
    for _ in range(3):
        eng.step()
    assert eng._census is None      # the counted sources wait for a read
    before = _host_state(eng)
    census = eng.cost_census()
    after = _host_state(eng)
    for b, a in zip(before[:4], after[:4]):
        assert (np.array_equal(b, a) if isinstance(b, np.ndarray)
                else torch.equal(b, a) if isinstance(b, torch.Tensor)
                else b == a)
    for lb, la in zip(before[4], after[4]):
        for tb, ta in zip(lb, la):
            if tb is not None:         # page 0 is the trash page
                assert torch.equal(tb[1:], ta[1:])
    assert census["source"] == "lowered"
    assert census["capacity_tokens"] == 3 * 8
    assert census["flops"] > 0 and census["bytes_accessed"] > 0
    kernels = census["kernels"]
    assert kernels["K1"][0] == 2 * SMALL["num_hidden_layers"] + 1
    walk = [k for k in kernels if k.startswith(("K6", "K10"))]
    assert len(walk) == 1 and kernels[walk[0]][0] == 2
    assert ("K10" in walk[0]) is bool(arm.get("grouped"))
    if arm.get("megakernel") or arm.get("kv_dtype"):
        assert kernels["K8-q8" if arm.get("kv_dtype") else "K8"][0] == 2
    if arm.get("megakernel"):
        assert "K11" not in kernels            # no adapters here
    eng.run()
    assert [list(r.output_tokens) for r in reqs] == want
    assert eng.debug_state()["cost_census"] is census
    assert eng.metrics.snapshot()["cost_census"]["flops"] == census["flops"]
    assert eng._census_captures == 1
    eng.drain()


def test_counted_census_is_the_same_twice_and_model_after_a_step(model):
    """Two engines of one geometry count the same numbers; the "model"
    census is captured right after the first round, once; a legacy
    engine's "lowered" record is the model's and says so."""
    a = ServingEngine(model, cost_census="lowered", **ENGINE).cost_census()
    b = ServingEngine(model, cost_census="lowered", **ENGINE).cost_census()
    assert a == b
    eng = ServingEngine(model, **ENGINE)
    assert eng.census_mode == "model" and eng._census is None
    eng.generate(_prompts()[:1], SamplingParams(max_new_tokens=3))
    assert eng._census_captures == 1 and eng._census["source"] == "model"
    eng.debug_state()
    assert eng._census_captures == 1
    legacy = ServingEngine(model, cost_census="lowered", unified=False,
                           **{k: v for k, v in ENGINE.items()
                              if k != "grouped"})
    got = legacy.cost_census()
    assert got["source"] == "model" and "kernels" not in got
