"""The KV fabric's engine side in the port, against the JAX package.

Fingerprints: `fp_seed`, `fp_step`, `prompt_fingerprints` and the tree's
`fingerprints` give the JAX package's CRC chains. Frames: for the same
pages, the port's `encode_frame` writes the JAX package's bytes in the
bf16, f32, int8 and e4m3 lanes (the port's payloads are tuples of
tensors, the JAX package's arrays), each side decodes the other's frame
to the same pages, and the header checks refuse with the JAX texts. The
tree: tests/test_serving_fabric.py's TestTreeFabricUnit on the port's
`RadixPrefixCache`. The engine: TestEngineFabric's cases on port engines
(a transfer continues token for token, a mismatched geometry is refused
whole, a snapshot restores warm, the flight notes and the exposition),
and across the packages: a frame the JAX engine exports imports into a
port engine, which continues `prompt + [t1]` with the JAX engine's
tokens, and a port engine's frame decodes under the JAX `decode_frame`
to the port's own pages.
"""
import sys

import jax
import jax.experimental
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import HostPagePool as JaxHostPagePool
from paddle_tpu.serving import PagePool as JaxPagePool
from paddle_tpu.serving import RadixPrefixCache as JaxRadix
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import fabric as jfabric
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (HostPagePool, PagePool,
                                      RadixPrefixCache, SamplingParams,
                                      ServingEngine, prometheus_render)
from paddle_tpu_torch.serving import fabric as tfabric

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GPT_GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=128)
# obs stays on: the JAX engine's fabric methods note into its flight ring
JAX_GATES = dict(slo=False, cost_census=False)
_GATES = ("PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_PAGED_ATTN", "PADDLE_TPU_GROUPED_ATTN",
          "PADDLE_TPU_KV_DTYPE", "PADDLE_TPU_PREEMPT",
          "PADDLE_TPU_MEGAKERNEL", "PADDLE_TPU_ADAPTERS",
          "PADDLE_TPU_PREFIX_CACHE", "PADDLE_TPU_GRAMMAR",
          "PADDLE_TPU_KV_FABRIC")
ENGINE = dict(num_slots=4, max_len=64, page_size=4, chunk_len=16,
              prefix_cache=True)
PROMPT = [int(t) for t in np.random.default_rng(0).integers(1, 96, size=13)]


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: its engines step tiny
    tensors op by op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX GPT, port GPT) on the same weights (tests/test_serving_
    fabric.py's tiny GPT); the JAX GPT on its jnp paths."""
    had_module = _PALLAS_LN in sys.modules
    mp = pytest.MonkeyPatch()
    for gate in _GATES:
        mp.delenv(gate, raising=False)
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    try:
        paddle.seed(7)
        jg = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0,
                                 **GPT_GEOMETRY))
        jg.eval()
        tg = GPTForCausalLM(GPTConfig(**GPT_GEOMETRY), device="cpu")
        tg.load_state_dict(convert.from_paddle_state_dict(
            {k: v.numpy() for k, v in jg.state_dict().items()}))
        tg.eval()
        yield jg, tg
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


# -- fingerprints and the gate --------------------------------------------
def test_fingerprints_equal_jax():
    rng = np.random.RandomState(2)
    for _ in range(40):
        toks = rng.randint(0, 50000, size=int(rng.randint(0, 70)))
        ps = int(rng.choice([1, 4, 8, 16]))
        aid = int(rng.randint(0, 5))
        assert tfabric.prompt_fingerprints(toks, ps, aid) == \
            jfabric.prompt_fingerprints(toks, ps, aid)
        assert tfabric.fp_seed(aid) == jfabric.fp_seed(aid)
        assert tfabric.fp_step(7, toks) == jfabric.fp_step(7, toks)
    trees = []
    for pool_cls, cache_cls in ((PagePool, RadixPrefixCache),
                                (JaxPagePool, JaxRadix)):
        pool = pool_cls(64)
        cache = cache_cls(pool, 4)
        r = np.random.RandomState(3)
        for i in range(8):
            seq = r.randint(0, 40, size=int(r.randint(4, 20)))
            cache.insert(seq, pool.alloc(-(-seq.size // 4)), seq.size,
                         adapter_id=i % 3)
        trees.append((cache.fingerprints(), cache.fingerprints(limit=5)))
    assert trees[0] == trees[1] and len(trees[0][0]) > 5


@pytest.mark.parametrize("spec", ["off", "on", "0", "yes", "",
                                  "min_pages=3,summary=64,restore=off",
                                  "min_pages", "bogus=1", "restore=on"])
def test_fabric_spec_equals_jax(monkeypatch, spec):
    def res(fn, *a):
        try:
            cfg = fn(*a)
        except ValueError as e:
            return str(e)
        return None if cfg is None else (cfg.handoff_min_pages,
                                         cfg.summary_limit,
                                         cfg.restore_on_add, cfg.roles)
    assert res(tfabric.parse_fabric_spec, spec) == \
        res(jfabric.parse_fabric_spec, spec)
    monkeypatch.setenv("PADDLE_TPU_KV_FABRIC", spec)
    assert res(tfabric.resolve_fabric) == res(jfabric.resolve_fabric)
    for v in (True, False, "off"):
        assert res(tfabric.resolve_fabric, v) == \
            res(jfabric.resolve_fabric, v)


# -- frames -----------------------------------------------------------------
GEO = dict(page_size=4, n_layers=2, n_kv=2, head_dim=8)
SHAPE = (2, 2, 4, 2, 8)          # [n_layers, 2, ps, n_kv, D]
SCALES = (2, 2, 4, 2)


def _pages(lane, n, seed):
    """n pages of random bits as (port payloads, JAX payloads, the JAX
    receiver's fp_dtype, the port's): the same bytes on both sides."""
    rng = np.random.default_rng(seed)
    if lane == "int8":
        codes = [rng.integers(-127, 128, size=SHAPE).astype(np.int8)
                 for _ in range(n)]
        scales = [rng.random(SCALES, dtype=np.float32) for _ in range(n)]
        return ([(torch.from_numpy(c), torch.from_numpy(s))
                 for c, s in zip(codes, scales)],
                list(zip(codes, scales)), None, None)
    if lane == "bf16":
        bits = [rng.integers(0, 2 ** 16, size=SHAPE).astype(np.uint16)
                & 0x7f7f for _ in range(n)]
        return ([(torch.from_numpy(b.view(np.int16)).view(torch.bfloat16),)
                 for b in bits], [b.view(ml_dtypes.bfloat16) for b in bits],
                ml_dtypes.bfloat16, torch.bfloat16)
    if lane == "fp8":
        bits = [rng.integers(0, 256, size=SHAPE).astype(np.uint8)
                & 0x77 for _ in range(n)]
        return ([(torch.from_numpy(b),) for b in bits],
                [b.view(ml_dtypes.float8_e4m3fn) for b in bits],
                ml_dtypes.float8_e4m3fn, torch.uint8)
    arrs = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)]
    return ([(torch.from_numpy(a),) for a in arrs], arrs, np.float32,
            torch.float32)


def _same(port_payload, jax_payload):
    for t, a in zip(port_payload, jax_payload if isinstance(
            jax_payload, tuple) else (jax_payload,)):
        a = np.asarray(a)
        got = t.contiguous().view(torch.uint8).numpy() \
            if t.element_size() != 4 else t.numpy()
        want = a.view(np.uint8) if a.dtype.itemsize != 4 else a
        assert np.array_equal(got.reshape(-1), want.reshape(-1))


@pytest.mark.parametrize("lane", ["bf16", "fp32", "int8", "fp8"])
def test_frames_equal_jax_byte_for_byte(lane):
    port, ref, jdt, tdt = _pages(lane, 3, seed=len(lane))
    kv = {"int8": "int8", "fp8": "fp8"}.get(lane, "fp")
    itemsize = {"bf16": 2, "fp32": 4, "int8": 1, "fp8": 1}[lane]
    toks = np.arange(40, 51, dtype=np.int64)
    kw = dict(kv_dtype=kv, tokens=toks, valid=11, adapter_id=3, **GEO)
    got = tfabric.encode_frame(payloads=port, fp_itemsize=itemsize, **kw)
    want = jfabric.encode_frame(payloads=ref, fp_itemsize=itemsize, **kw)
    assert got == want
    # the itemsize a frame records when none is given: the first page's
    if lane in ("bf16", "fp32"):
        assert tfabric.encode_frame(payloads=port, **kw) == \
            jfabric.encode_frame(payloads=ref, **kw)
    assert tfabric.frame_header(got) == jfabric.frame_header(got)
    hdr, out_toks, pages = tfabric.decode_frame(want, fp_dtype=tdt)
    assert hdr == jfabric.frame_header(want)
    assert np.array_equal(out_toks, toks)
    for t, a in zip(pages, ref):
        assert all(x.dtype == y.dtype for x, y in zip(t, pages[0]))
        _same(t, a)
    _, jtoks, jpages = jfabric.decode_frame(got, fp_dtype=jdt)
    assert np.array_equal(jtoks, toks)
    for t, a in zip(port, jpages):
        _same(t, a)


def test_frame_checks_are_the_jax_texts():
    port, ref, _, _ = _pages("fp32", 1, seed=5)
    kw = dict(kv_dtype="fp", tokens=[1, 2, 3, 4], valid=4, **GEO)
    frame = tfabric.encode_frame(payloads=port, **kw)

    def err(fn, *a, **k):
        try:
            fn(*a, **k)
        except ValueError as e:
            return str(e)
        return None
    for bad in (b"XXXX" + frame[4:], frame[:-3],
                frame.replace(b'"version":1', b'"version":9'), b"PK"):
        assert err(tfabric.frame_header, bad) == \
            err(jfabric.frame_header, bad) is not None
    assert err(tfabric.decode_frame, frame, fp_dtype=torch.float16) == \
        err(jfabric.decode_frame, frame, fp_dtype=np.float16).replace(
            "float16", "torch.float16")
    for k in (dict(tokens=[1, 2], valid=3, payloads=[]),
              dict(tokens=list(range(9)), valid=9)):
        assert err(tfabric.encode_frame, **{**kw, "payloads": port, **k}) \
            == err(jfabric.encode_frame, **{**kw, "payloads": ref, **k}) \
            is not None
    # wire economics: int8 codes + scales halve f32 pages, e4m3 quarters
    n = int(np.prod(SHAPE))
    sizes = {lane: tfabric.frame_header(tfabric.encode_frame(
        payloads=_pages(lane, 1, 0)[0], fp_itemsize=None
        if lane != "fp8" else 1, **{**kw, "kv_dtype": {
            "int8": "int8", "fp8": "fp8"}.get(lane, "fp")}))[
                "payload_bytes"] for lane in ("fp32", "int8", "fp8")}
    assert sizes["fp32"] == 4 * n and sizes["fp8"] == n
    assert sizes["fp32"] / sizes["int8"] >= 2.0


# -- the tree's fabric mechanics (bare pool, no engine) ----------------------
PS = 4


def _tree(num_pages=16, cls=(PagePool, RadixPrefixCache)):
    pool = cls[0](num_pages)
    cache = cls[1](pool, PS)
    store = {}

    def alloc_restore(payload):
        pages = pool.alloc(1)
        if pages is None:
            return None
        store[pages[0]] = np.array(payload)
        pool.release(pages)
        pool.park(pages)
        return pages[0]
    return pool, cache, store, alloc_restore


def test_collect_chain_walks_and_stops():
    pool, cache, _, _ = _tree()
    seq = np.arange(100, 112)
    pages = pool.alloc(3)
    cache.insert(seq, pages, seq.size)
    assert cache.collect_chain(seq) == (12, [("page", p) for p in pages])
    other = np.concatenate([seq[:4], [7, 7, 7, 7]])
    assert cache.collect_chain(other) == (4, [("page", pages[0])])
    assert cache.collect_chain(seq, adapter_id=2) == (0, [])


def test_graft_dedup_partial_tail_and_alloc_failure():
    pool, cache, store, ar = _tree()
    toks = np.arange(50, 62)
    assert cache.graft(toks, [np.full(4, i) for i in range(3)], 12,
                       alloc_restore=ar) == 3
    assert pool.cached_pages == 3
    grant = cache.acquire(np.concatenate([toks, [1, 2]]), max_new_tokens=2)
    assert grant.cached_len == 12
    assert [store[p].tolist() for p in grant.pages[:3]] == \
        [[0] * 4, [1] * 4, [2] * 4]
    cache.release(grant.pages)
    free = pool.free_pages
    assert cache.graft(toks, [np.zeros(4)] * 3, 12, alloc_restore=ar) == 0
    assert pool.free_pages == free                 # dedup costs nothing
    toks = np.arange(0, 11)                        # 2 full + a tail of 3
    pays = [np.zeros(4), np.ones(4), np.full(4, 2)]
    pool, cache, _, ar = _tree(4)                  # 3 usable pages
    assert cache.graft(toks, pays, 11, alloc_restore=ar) == 3
    pool, cache, _, ar = _tree(3)                  # 2: the tail is denied
    assert cache.graft(toks, pays, 11, alloc_restore=ar) == 2
    assert cache.tree_pages == 2
    with pytest.raises(ValueError, match="payload capacity"):
        cache.graft(toks, pays[:1], 11, alloc_restore=ar)


def _spilled_tree(cls, host_cls, drop_host=False):
    pool, cache, store, ar = _tree(cls=cls)
    host = host_cls(8)
    cache.set_host_tier(store=lambda page: host.store(np.array(store[page])),
                        load=lambda slot: ar(host.load(slot)),
                        drop=host.free)
    toks = np.arange(30, 42)
    cache.graft(toks, [np.full(4, i + 7) for i in range(3)], 12,
                alloc_restore=ar)
    assert cache.spill(1) == 1                     # the LRU page -> host
    snap = cache.snapshot(lambda p: np.array(store[p]),
                          (lambda slot: None) if drop_host else host.load)
    return cache, snap, toks


def test_snapshot_load_roundtrip_with_a_spilled_node_as_jax():
    cache, snap, toks = _spilled_tree((PagePool, RadixPrefixCache),
                                      HostPagePool)
    _, jsnap, _ = _spilled_tree((JaxPagePool, JaxRadix), JaxHostPagePool)
    assert cache.stats()["spilled_nodes"] == 1
    assert len(snap["nodes"]) == 3                 # spilled included
    assert [(n["adapter"], n["parent"], n["tokens"].tolist(),
             np.asarray(n["payload"]).tolist(), n["partial"])
            for n in snap["nodes"]] == \
        [(n["adapter"], n["parent"], n["tokens"].tolist(),
          np.asarray(n["payload"]).tolist(), n["partial"])
         for n in jsnap["nodes"]]
    assert cache.lookup(np.concatenate([toks, [1]])) == 12
    pool2, cache2, store2, ar2 = _tree()
    assert cache2.load(snap, alloc_restore=ar2) == 3
    grant = cache2.acquire(np.concatenate([toks, [1]]), max_new_tokens=1)
    assert grant.cached_len == 12
    assert [store2[p].tolist() for p in grant.pages[:3]] == \
        [[7] * 4, [8] * 4, [9] * 4]
    cache2.release(grant.pages)
    # a chain with a hole is no prefix: the dropped host page's subtree
    # does not ship
    assert _spilled_tree((PagePool, RadixPrefixCache), HostPagePool,
                         drop_host=True)[1]["nodes"] == []
    _, cache3, _, ar3 = _tree()
    for bad, match in (({"version": 2, "page_size": 4, "nodes": []},
                        "version"),
                       ({"version": 1, "page_size": 8, "nodes": []},
                        "page_size")):
        with pytest.raises(ValueError, match=match):
            cache3.load(bad, alloc_restore=ar3)


# -- engines -----------------------------------------------------------------
def _run(eng, prompt, n_new, cls=SamplingParams):
    eng.add_request(list(prompt), cls(max_new_tokens=n_new))
    toks = []
    while eng.has_work:
        for o in eng.step():
            toks.extend(o.token_ids)
    return toks


@pytest.mark.parametrize("kv_dtype", ["int8", "fp", "fp8"])
def test_transfer_continues_token_for_token(models, kv_dtype):
    """TestEngineFabric's transfer on port engines: A prefills and
    exports, B grafts and continues `prompt + [t1]` with A's own
    continuation, every full page a hit; the census and the metrics
    carry the wire counters."""
    _, tm = models
    ea = ServingEngine(tm, device="cpu", kv_dtype=kv_dtype, **ENGINE)
    t1 = _run(ea, PROMPT, 1)
    frame = ea.export_prefix_frame(np.asarray(PROMPT + t1, np.int64))
    hdr = tfabric.frame_header(frame)
    assert hdr["kv_dtype"] == kv_dtype and hdr["n_pages"] == 14 // PS
    assert hdr["valid"] == 12
    # the bytes are the header's accounting: magic, length, header,
    # tokens, pages
    hlen = int.from_bytes(frame[4:8], "little")
    assert len(frame) == 8 + hlen + 8 * hdr["n_tokens"] + \
        hdr["payload_bytes"]
    assert hdr["payload_bytes"] == hdr["n_pages"] * ea.page_bytes
    assert ea.metrics.snapshot()["fabric"]["pages_sent"] == hdr["n_pages"]
    assert ea.cost_census()["fabric"]["bytes_sent"] == len(frame)
    want = _run(ea, PROMPT + t1, 6)
    eb = ServingEngine(tm, device="cpu", kv_dtype=kv_dtype, **ENGINE)
    assert eb.import_prefix_frame(frame) == hdr["n_pages"]
    assert _run(eb, PROMPT + t1, 6) == want
    st = eb.prefix_cache.stats()
    assert st["hits"] == 1 and st["cached_tokens"] == 12
    census = eb.cost_census()
    assert census["fabric"]["bytes_recv"] == len(frame)
    assert census["fabric"]["pages_recv"] == hdr["n_pages"]
    # a second import of the same frame grafts nothing
    assert eb.import_prefix_frame(frame) == 0
    for eng in (ea, eb):
        eng.drain()
        eng.pool.assert_quiesced()


def test_geometry_mismatch_is_refused_whole_as_jax(models):
    jm, tm = models
    ea = ServingEngine(tm, device="cpu", kv_dtype="int8", **ENGINE)
    _run(ea, PROMPT, 2)
    frame = ea.export_prefix_frame(np.asarray(PROMPT, np.int64))
    errs = []
    for eb in (ServingEngine(tm, device="cpu", kv_dtype="int8",
                             **{**ENGINE, "page_size": 8}),
               JaxEngine(jm, kv_dtype="int8", **{**ENGINE, "page_size": 8},
                         **JAX_GATES)):
        with pytest.raises(ValueError, match="page_size") as e:
            eb.import_prefix_frame(frame)
        errs.append(str(e.value))
        assert eb.prefix_cache.tree_pages == 0
        eb.drain()
        eb.pool.assert_quiesced()
    assert errs[0] == errs[1]
    eb = ServingEngine(tm, device="cpu", kv_dtype="fp", **ENGINE)
    with pytest.raises(ValueError, match="kv_dtype"):
        eb.import_prefix_frame(frame)
    assert ServingEngine(tm, device="cpu", **{**ENGINE, "prefix_cache":
                                              False}).import_prefix_frame(
        frame) == 0


def test_snapshot_restores_a_warm_engine(models):
    _, tm = models
    ea = ServingEngine(tm, device="cpu", kv_dtype="int8", **ENGINE)
    want = _run(ea, PROMPT, 4)
    ea.drain()
    snap = ea.export_prefix_state()
    assert snap["nodes"] and snap["geometry"] == ea.fabric_geometry
    eb = ServingEngine(tm, device="cpu", kv_dtype="int8", **ENGINE)
    restored = eb.import_prefix_state(snap)
    assert restored == len(snap["nodes"])
    assert eb.metrics.snapshot()["fabric"]["restored_pages"] == restored
    assert _run(eb, PROMPT, 4) == want
    assert eb.prefix_cache.stats()["hits"] == 1
    with pytest.raises(ValueError, match="geometry"):
        ServingEngine(tm, device="cpu", **ENGINE).import_prefix_state(snap)
    notes = [e.get("note") for e in ea.obs.flight.snapshot()["steps"]]
    assert "fabric:snapshot" in notes
    notes = [e.get("note") for e in eb.obs.flight.snapshot()["steps"]]
    assert "fabric:restore" in notes


def test_flight_notes_and_exposition(models):
    _, tm = models
    ea = ServingEngine(tm, device="cpu", kv_dtype="int8", **ENGINE)
    eb = ServingEngine(tm, device="cpu", kv_dtype="int8", **ENGINE)
    _run(ea, PROMPT, 2)
    eb.import_prefix_frame(ea.export_prefix_frame(
        np.asarray(PROMPT, np.int64)))
    steps_a = ea.obs.flight.snapshot()["steps"]
    steps_b = eb.obs.flight.snapshot()["steps"]
    assert any(e.get("note") == "fabric:send" for e in steps_a)
    assert any(e.get("note") == "fabric:recv" for e in steps_b)
    eb.step()
    text = prometheus_render({"r0": eb.metrics.snapshot()})
    for needle in ("fabric_pages_recv_total", "fabric_bytes_recv_total",
                   "prefix_tree_pages", "prefix_spilled_nodes"):
        assert needle in text, needle
    assert "paddle_serving_fabric_pages_recv_total{replica=\"r0\"} 3" in text


def test_exports_spilled_pages_from_the_host_tier(models):
    """A spilled chain ships from the host tier with no device
    round-trip, and its frame equals the frame of the same pages on the
    device."""
    _, tm = models
    ea = ServingEngine(tm, device="cpu", kv_dtype="int8", **ENGINE)
    _run(ea, PROMPT, 2)
    toks = np.asarray(PROMPT, np.int64)
    resident = ea.export_prefix_frame(toks)
    assert ea.prefix_cache.spill(8) >= 3
    assert [k for k, _ in ea.prefix_cache.collect_chain(toks)[1]] == \
        ["host"] * 3
    assert ea.export_prefix_frame(toks) == resident


@pytest.mark.parametrize("kv_dtype", ["int8", "fp"])
def test_jax_frames_import_into_the_port_and_back(models, kv_dtype):
    """The JAX engine prefills and exports; a port engine grafts the
    JAX engine's pages and continues `prompt + [t1]` with the JAX
    engine's tokens. A port engine's frame decodes under the JAX
    `decode_frame` to the port's own pages, and a JAX engine grafts it."""
    jm, tm = models
    ja = JaxEngine(jm, kv_dtype=kv_dtype, **ENGINE, **JAX_GATES)
    t1 = _run(ja, PROMPT, 1, JaxSampling)
    seq = np.asarray(PROMPT + t1, np.int64)
    frame = ja.export_prefix_frame(seq)
    want = _run(ja, PROMPT + t1, 6, JaxSampling)
    tb = ServingEngine(tm, device="cpu", kv_dtype=kv_dtype, **ENGINE)
    assert tb.import_prefix_frame(frame) == 3
    assert _run(tb, PROMPT + t1, 6) == want
    assert tb.prefix_cache.stats()["cached_tokens"] == 12
    # and back: the port's frame of its pages, read by the JAX codec
    ta = ServingEngine(tm, device="cpu", kv_dtype=kv_dtype, **ENGINE)
    _run(ta, PROMPT, 1)
    pframe = ta.export_prefix_frame(seq)
    _, _, jpages = jfabric.decode_frame(pframe, fp_dtype=np.float32)
    depth, refs = ta.prefix_cache.collect_chain(seq)
    own = ta._extract_pages([ref for _, ref in refs])
    for t, a in zip(own, jpages):
        _same(t, a)
    jb = JaxEngine(jm, kv_dtype=kv_dtype, **ENGINE, **JAX_GATES)
    assert jb.import_prefix_frame(pframe) == 3
    for eng in (ja, tb, ta, jb):
        eng.drain()
