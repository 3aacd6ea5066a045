"""The HTTP front end (`serving/http/protocol.py`, `ratelimit.py`,
`server.py`, `serve`) of the port, against the JAX package's.

Protocol: every completion and embeddings body of the JAX tests (valid
and malformed, with priority, deadline, `model`, `session`,
`response_format`) parses to the JAX request's fields or is refused with
the JAX status, error type and message; the status maps agree. The rate
limiter's buckets on an injected clock give the JAX waits and refusals.
Servers: a port server and a JAX server over engines on the same f32
weights answer the same requests (blocking, SSE, embeddings,
`response_format`, `model`, priority and deadline, temperature 0) with
the same bodies apart from ids, times and the embedding's last bits
(within 1e-5); concurrent mixed clients get the JAX engine's tokens;
/metrics gives the JAX server's series names (but the JAX engine's
traced-op count). Status codes 400, 404,
409, 422, 429 (rate limit, full queue, infeasible deadline), 503 and
504, keep-alive, a client that drops its stream, and drain. The
contracts left red on the JAX side at take-up (tests/test_serving_faults.py
:547, :621): a poisoned request gives 422 and is rendered, and an SSE
stream survives its replica's death with `usage.migrations` 1. Every
socket has a timeout, every wait a bound, every server is drained.
"""
import dataclasses
import http.client
import json
import socket
import sys
import threading
import time

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import RateLimited as JaxRateLimited
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.http import protocol as jproto
from paddle_tpu.serving.http import ratelimit as jrl
from paddle_tpu.serving.http import serve as jax_serve
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import (DeadlineExceeded, EngineClosed,
                                      FaultInjector, FleetController,
                                      FleetSignals, PoisonedRequest,
                                      QueueFull, RateLimited,
                                      RequestOutput, SamplingParams,
                                      ServingEngine)
from paddle_tpu_torch.serving.http import ReplicaDead, serve
from paddle_tpu_torch.serving.http import protocol as tproto
from paddle_tpu_torch.serving.http import ratelimit as trl

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
GEOMETRY = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=128)
ENGINE = dict(num_slots=2, max_len=64, grouped=False)
EOS = 0
_GATES = ("PADDLE_TPU_OBS", "PADDLE_TPU_SLO", "PADDLE_TPU_FAULTS",
          "PADDLE_TPU_COST_CENSUS", "PADDLE_TPU_UNIFIED_STEP",
          "PADDLE_TPU_SPEC_DECODE", "PADDLE_TPU_PREFIX_CACHE",
          "PADDLE_TPU_CONTROLPLANE", "PADDLE_TPU_KV_FABRIC",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_GRAMMAR", "PADDLE_TPU_DEBUG", "PADDLE_TPU_PREEMPT")
JOIN_S = 60.0


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX GPT and its port on the same weights, the JAX side on its
    jnp paths (a stand-in `disable_x64` that raises if entered)."""
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
        jm = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0,
                                 **GEOMETRY))
        jm.eval()
        tm = GPTForCausalLM(GPTConfig(**GEOMETRY), device="cpu")
        tm.load_state_dict(convert.from_paddle_state_dict(
            {k: v.numpy() for k, v in jm.state_dict().items()}))
        tm.eval()
        yield jm, tm
    finally:
        mp.undo()
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


def port_engines(models, n=1, **kw):
    return [ServingEngine(models[1], device="cpu", **{**ENGINE, **kw})
            for _ in range(n)]


def jax_engines(models, n=1, **kw):
    return [JaxEngine(models[0], **{**ENGINE, **kw}) for _ in range(n)]


def solo(models, prompt, n, **kw):
    eng = jax_engines(models, **kw)[0]
    return eng.generate([np.asarray(prompt)],
                        JaxSampling(max_new_tokens=n))[0].token_ids


def wait_until(pred, timeout=JOIN_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# -- loopback clients ------------------------------------------------------
def post(addr, body, path="/v1/completions", headers=None, timeout=60.0):
    """(status, headers, parsed body) of one POST."""
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json",
                      **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def get(addr, path, timeout=30.0):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def read_sse(addr, body, on_token=None, timeout=60.0):
    """(status, frames) of one streamed completion, read to [DONE]."""
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({**body, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        frames, tokens = [], []
        while True:
            line = resp.readline()
            if not line or line.strip() == b"data: [DONE]":
                break
            if line.startswith(b"data: "):
                frames.append(json.loads(line[6:]))
                ch = frames[-1].get("choices", [{}])[0]
                if ch.get("token") is not None:
                    tokens.append(ch["token"])
                    if on_token is not None:
                        on_token(tokens)
        return resp.status, frames
    finally:
        conn.close()


def sse_tokens(frames):
    return [f["choices"][0]["token"] for f in frames
            if "choices" in f and f["choices"][0]["token"] is not None]


def strip_ids(obj):
    """A body without its ids and times, and with its embedding apart."""
    if isinstance(obj, list):
        return [strip_ids(v) for v in obj]
    if not isinstance(obj, dict):
        return obj
    return {k: strip_ids(v) for k, v in obj.items()
            if k not in ("id", "timing", "embedding")}


# -- protocol ----------------------------------------------------------------
COMPLETION_BODIES = [
    b"{not json", b"\xff\xfe", b"[1, 2]", b"{}",
    {"max_tokens": 4}, {"prompt": []}, {"prompt": "hello"},
    {"prompt": [1.5]}, {"prompt": [1, "2"]}, {"prompt": [1], "max_tokens": 0},
    {"prompt": [1], "max_tokens": "4"}, {"prompt": [1], "top_p": 1.5},
    {"prompt": [1], "top_p": 0}, {"prompt": [1], "top_k": 0},
    {"prompt": [1], "timeout": -1}, {"prompt": [1], "timeout": 0},
    {"prompt": [1], "temperature": "hot"}, {"prompt": [1], "temperature": 0},
    {"prompt": [1], "temperature": 0.0, "top_k": 3},
    {"prompt": [3, 14], "max_tokens": 9, "stream": True,
     "temperature": 0.8, "top_k": 5, "top_p": 0.9, "eos_token_id": 42,
     "timeout": 30},
    {"prompt": [1, 2]}, {"prompt": [1, 2], "stream": 1},
    {"prompt": [1, 2, 3], "priority": 7, "deadline": 1.5},
    {"prompt": [1], "deadline": -1}, {"prompt": [1], "deadline": 0},
    {"prompt": [1], "priority": "high"}, {"prompt": [1], "priority": 2.5},
    {"prompt": [1, 2, 3], "max_tokens": 4, "model": "tenant-a"},
    {"prompt": [1, 2, 3], "model": 7},
    {"prompt": [1], "session": "chat-1"}, {"prompt": [1], "session": 3},
    {"prompt": [1], "request_id": "req-1.a:b_c-d"},
    {"prompt": [1], "request_id": "bad id"},
    {"prompt": [1], "request_id": "x" * 129}, {"prompt": [1], "greedy": False},
    {"prompt": [3, 7, 11], "max_tokens": 8, "eos_token_id": EOS,
     "response_format": {"type": "choice", "choices": ["YES", "NO"]}},
    {"prompt": [1], "max_tokens": 4, "eos_token_id": EOS,
     "response_format": {"type": "regex"}},
    {"prompt": [1], "max_tokens": 4, "eos_token_id": EOS,
     "response_format": {"type": "regex", "pattern": "[A-C]+"}},
    {"prompt": [1], "max_tokens": 4,
     "response_format": {"type": "json_object"}},
    {"prompt": [1], "eos_token_id": EOS,
     "response_format": {"type": "json_object"}},
    {"prompt": [1], "eos_token_id": EOS, "response_format": {"type": "text"}},
    {"prompt": [1], "eos_token_id": EOS, "response_format": "json"},
    {"prompt": [1], "eos_token_id": EOS, "response_format": {"type": "xml"}},
    {"prompt": [1], "eos_token_id": EOS,
     "response_format": {"type": "choice", "choices": "YES"}},
    {"prompt": [1], "eos_token_id": EOS,
     "response_format": {"type": "choice", "choices": ["A", 1]}},
    {"prompt": [1], "eos_token_id": EOS,
     "response_format": {"type": "choice", "choices": []}},
    {"prompt": [1], "eos_token_id": EOS,
     "response_format": {"type": "regex", "pattern": 5}},
    {"prompt": [1], "eos_token_id": EOS,
     "response_format": {"type": "regex", "pattern": "(["}},
]
EMBEDDING_BODIES = [
    b"nope", b"7", {"input": [3, 14, 15, 9]}, {"input": "text"},
    {"input": []}, {"input": [1, 2.0]}, {"prompt": [1]},
    {"input": [1], "timeout": -2}, {"input": [1], "timeout": 5},
    {"input": [1], "model": "m", "session": "s", "priority": 3,
     "request_id": "e-1"},
    {"input": [1], "request_id": "no spaces"}, {"input": [1], "priority": "x"},
]


def _raw(body):
    return body if isinstance(body, bytes) else json.dumps(body).encode()


def creq_view(creq):
    """The parsed request's fields, its grammar as its declaration."""
    sp = {f.name: getattr(creq.sampling, f.name)
          for f in dataclasses.fields(creq.sampling)}
    g = sp.pop("grammar")
    sp["grammar"] = None if g is None else (g.kind, g.choices, g.pattern,
                                            g.token_strings)
    return (creq.prompt_ids.tolist(), str(creq.prompt_ids.dtype),
            creq.stream, creq.request_id, creq.model, sp)


def parsed(mod, parse_name, body):
    try:
        return ("ok", creq_view(getattr(mod, parse_name)(_raw(body))))
    except mod.ProtocolError as e:
        return ("refused", e.status, e.err_type, str(e))


@pytest.mark.parametrize("parse,body", [
    ("parse_completion_request", b) for b in COMPLETION_BODIES] + [
    ("parse_embeddings_request", b) for b in EMBEDDING_BODIES])
def test_bodies_parse_like_jax(parse, body):
    """The same fields, or the same status, error type and message."""
    assert parsed(tproto, parse, body) == parsed(jproto, parse, body)


def _outputs():
    base = dict(request_id="r", prompt_token_ids=[1, 2], token_ids=[])
    return [dict(base, finish_reason=r, token_ids=t)
            for r in ("stop", "length", "timeout", "deadline",
                      "replica_failure", "poisoned", "aborted",
                      "cancelled", None)
            for t in ([], [5])]


def test_status_maps_and_bodies_match_jax():
    errors = [(QueueFull("q", retry_after_s=2.0),
               jproto.QueueFull("q", retry_after_s=2.0)),
              (RateLimited("r", retry_after_s=1.0),
               JaxRateLimited("r", retry_after_s=1.0)),
              (PoisonedRequest("p"), jproto.PoisonedRequest("p")),
              (DeadlineExceeded("d"), jproto.DeadlineExceeded("d")),
              (ReplicaDead("x"), jproto.ReplicaDead("x")),
              (EngineClosed("c"), jproto.EngineClosed("c")),
              (tproto.ProtocolError(418, "t"), jproto.ProtocolError(418, "t")),
              (RuntimeError("?"), RuntimeError("?"))]
    for mine, theirs in errors:
        assert tproto.status_for_error(mine) == \
            jproto.status_for_error(theirs)
    for kw in _outputs():
        mine = RequestOutput(**kw, cached_tokens=3, migrations=1,
                             preemptions=2, accepted_draft_tokens=1)
        theirs = jproto.RequestOutput(**kw, cached_tokens=3, migrations=1,
                                      preemptions=2,
                                      accepted_draft_tokens=1)
        assert tproto.status_for_output(mine) == \
            jproto.status_for_output(theirs)
        for fn in ("completion_body", "stream_final"):
            assert getattr(tproto, fn)("c", "m", mine) == \
                getattr(jproto, fn)("c", "m", theirs)
    emb = dict(_outputs()[2], finish_reason="stop")
    mine = RequestOutput(**emb, embedding=np.arange(3, dtype=np.float32))
    theirs = jproto.RequestOutput(**emb,
                                  embedding=np.arange(3, dtype=np.float32))
    assert tproto.embeddings_body("e", "m", mine) == \
        jproto.embeddings_body("e", "m", theirs)
    assert tproto.stream_chunk("c", "m", 7) == jproto.stream_chunk("c", "m", 7)
    assert tproto.sse({"a": 1}) == jproto.sse({"a": 1})
    assert tproto.SSE_DONE == jproto.SSE_DONE
    assert tproto.error_body(429, "x", "t") == jproto.error_body(429, "x", "t")


def test_serve_signature_and_exports_match_jax():
    import inspect

    import paddle_tpu.serving.http as jhttp

    import paddle_tpu_torch.serving.http as thttp
    assert str(inspect.signature(thttp.serve)).replace(
        "paddle_tpu_torch.", "") == str(inspect.signature(
            jhttp.serve)).replace("paddle_tpu.", "")
    assert set(thttp.__all__) == set(jhttp.__all__)
    assert set(tproto.__all__) == set(jproto.__all__)
    assert set(trl.__all__) == set(jrl.__all__)


# -- the rate limiter --------------------------------------------------------
LIMITER_SCRIPTS = {
    "bucket_refill": ("bucket", dict(rate=2.0, burst=2.0), [
        (0.0, None), (0.0, None), (0.0, None), (0.5, None), (0.5, None),
        (0.75, None), (10.0, None)]),
    "limiter_keys": ("limiter", dict(rate=1.0, burst=1.0), [
        (0.0, "k"), (0.0, "k"), (0.0, "other"), (1.5, "k"), (1.6, "k")]),
    "limiter_default_burst": ("limiter", dict(rate=0.5), [
        (0.0, "a"), (0.0, "a"), (1.0, "a"), (2.0, "a"), (2.1, "b")]),
    "limiter_lru_cap": ("limiter", dict(rate=1.0, burst=1.0,
                                        max_clients=2), [
        (0.0, "a"), (0.0, "b"), (0.0, "c"), (0.0, "a"), (0.0, "c")]),
}


@pytest.mark.parametrize("script", sorted(LIMITER_SCRIPTS))
def test_rate_limiter_matches_jax(script):
    """A script of (time, key) calls on an injected clock: the same
    waits, refusals, Retry-After hints, rejected totals and clients."""
    kind, kw, calls = LIMITER_SCRIPTS[script]
    runs = {}
    for side, mod, limited in (("port", trl, RateLimited),
                               ("jax", jrl, JaxRateLimited)):
        t = [0.0]
        if kind == "bucket":
            b = mod.TokenBucket(clock=lambda: t[0], **kw)
            out = []
            for now, _ in calls:
                t[0] = now
                out.append(b.try_acquire())
        else:
            rl = mod.RateLimiter(clock=lambda: t[0], **kw)
            out = []
            for now, key in calls:
                t[0] = now
                try:
                    rl.check(key)
                    out.append(0.0)
                except limited as e:
                    out.append((e.retry_after_s, str(e)))
            out.append((rl.rejected_total, rl.clients))
        runs[side] = out
    assert runs["port"] == runs["jax"]
    for mod in (trl, jrl):
        for bad in (dict(rate=0), dict(rate=1, burst=0)):
            with pytest.raises(ValueError, match="rate and burst"):
                mod.RateLimiter(**bad)


def test_rate_limiter_concurrent_clients():
    t = [0.0]
    rl = trl.RateLimiter(rate=1.0, burst=3.0, clock=lambda: t[0])
    granted = {}

    def client(key):
        ok = 0
        for _ in range(5):
            try:
                rl.check(key)
                ok += 1
            except RateLimited:
                pass
        granted[key] = ok

    threads = [threading.Thread(target=client, args=(f"k{i}",))
               for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
    assert all(v == 3 for v in granted.values()), granted
    assert rl.rejected_total == 16 and rl.clients == 8


# -- a port server beside a JAX server ---------------------------------------
PARITY_REQUESTS = [
    ("json", {"prompt": [3, 14, 15, 9], "max_tokens": 8}),
    ("sse", {"prompt": [26, 5, 35], "max_tokens": 6}),
    ("json", {"prompt": list(range(1, 21)), "max_tokens": 6}),
    ("json", {"prompt": list(range(1, 21)), "max_tokens": 6,
              "priority": 3, "deadline": 30.0}),
    ("emb", {"input": [3, 14, 15, 9]}),
    ("emb", {"input": list(range(5, 30)), "request_id": "emb-2"}),
    ("json", {"prompt": [3, 7, 11], "max_tokens": 8, "eos_token_id": EOS,
              "response_format": {"type": "choice",
                                  "choices": ["YES", "NO"]}}),
    ("sse", {"prompt": [2, 4, 6], "max_tokens": 6, "eos_token_id": EOS,
             "response_format": {"type": "regex", "pattern": "[A-C]+"}}),
    ("json", {"prompt": [1, 2], "max_tokens": 5, "model": "paddle-tpu"}),
    ("json", {"prompt": [1, 2], "max_tokens": 5, "model": "base",
              "temperature": 0}),
    ("json", {"prompt": [1, 2], "max_tokens": 5, "model": "tenant-x"}),
    ("json", {"prompt": [8, 9, 10], "max_tokens": 4, "request_id": "mine",
              "session": "s-1"}),
    ("json", {"prompt": [1], "max_tokens": 4, "eos_token_id": EOS,
              "response_format": {"type": "regex"}}),
    ("json", {"prompt": "text"}),
]


def _exchange(addr, kind, body):
    if kind == "sse":
        st, frames = read_sse(addr, body)
        return st, [strip_ids(f) for f in frames], None
    path = "/v1/embeddings" if kind == "emb" else "/v1/completions"
    st, _, out = post(addr, body, path=path)
    emb = None
    if kind == "emb" and st == 200:
        emb = np.asarray(out["data"][0]["embedding"], np.float64)
    return st, strip_ids(out), emb


def test_port_server_answers_like_the_jax_server(models):
    """Sequential requests, one of each kind, to a two-replica port
    server and a two-replica JAX server on the same weights: equal
    statuses and bodies (ids and times aside; embeddings within 1e-5),
    the same series names on /metrics."""
    results, series = {}, {}
    for side, engines, srv in (
            ("port", port_engines(models, 2, page_size=8, grammar=True),
             serve),
            ("jax", jax_engines(models, 2, page_size=8, grammar=True),
             jax_serve)):
        server = srv(engines, poll_interval_s=0.01)
        addr = server.server_address[:2]
        try:
            results[side] = [_exchange(addr, k, b)
                             for k, b in PARITY_REQUESTS]
            st, text = get(addr, "/metrics")
            assert st == 200
            series[side] = sorted({ln.split("{")[0].split(" ")[0]
                                   for ln in text.splitlines()
                                   if ln and not ln.startswith("#")})
        finally:
            server.drain(JOIN_S)
    for (kind, body), mine, theirs in zip(PARITY_REQUESTS, results["port"],
                                          results["jax"]):
        assert mine[:2] == theirs[:2], (kind, body)
        if mine[2] is not None:
            np.testing.assert_allclose(mine[2], theirs[2], rtol=0,
                                       atol=1e-5)
    statuses = [r[0] for r in results["port"]]
    assert statuses == [200] * 10 + [404, 200, 400, 400]
    # the JAX engine's count of traced XLA ops in its unified program has
    # no counterpart in an eager step (`metrics._unported_off`)
    assert series["port"] == [n for n in series["jax"]
                              if n != "paddle_serving_unified_dispatch_ops"]


def test_mixed_concurrent_clients_get_jax_tokens(models):
    """Six concurrent clients (three SSE, three blocking) against two
    replicas: each stream is the JAX engine's uninterrupted run, and
    each request was served once."""
    prompts = [[3 + i, 14, 15, 9] for i in range(4)] \
        + [[26, 5, 35], [1, 2, 3, 4, 5, 6]]
    want = [solo(models, p, 8) for p in prompts]
    engines = port_engines(models, 2)
    server = serve(engines, poll_interval_s=0.01)
    addr = server.server_address[:2]
    results = [None] * len(prompts)

    def client(i):
        body = {"prompt": prompts[i], "max_tokens": 8}
        if i % 2 == 0:
            st, frames = read_sse(addr, body)
            results[i] = (st, sse_tokens(frames),
                          frames[-1]["choices"][0]["finish_reason"])
        else:
            st, _, out = post(addr, body)
            results[i] = (st, out["choices"][0]["token_ids"],
                          out["choices"][0]["finish_reason"])

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        for i, res in enumerate(results):
            assert res == (200, want[i], "length"), i
        assert sum(e.metrics.requests_completed for e in engines) == 6
    finally:
        server.drain(JOIN_S)
    assert all(e.pool.used_pages == 0 for e in engines)
    assert all(e.pool.free_pages + e.pool.cached_pages == e.num_pages - 1
               for e in engines)


# -- status codes, connections and drain ---------------------------------------
def test_routes_and_refusals(models):
    """404 for an unknown route and an unknown model, 400 for a bad
    body, 409 for a live duplicate request id, 403 for /debug/* with the
    gate off, the probes' 200s."""
    server = serve(port_engines(models, 1, num_slots=1, max_len=128),
                   poll_interval_s=0.01)
    addr = server.server_address[:2]
    drv = server.router.drivers[0]
    try:
        assert get(addr, "/healthz")[0] == 200
        assert get(addr, "/readyz")[0] == 200
        assert get(addr, "/nope")[0] == 404
        st, _, body = post(addr, {"prompt": [1]}, path="/v1/other")
        assert st == 404 and body["error"]["type"] == "not_found"
        st, _, body = post(addr, {"prompt": [1], "model": "ghost"})
        assert st == 404 and body["error"]["type"] == "model_not_found"
        st, _, body = post(addr, {"prompt": "hi"})
        assert (st, body["error"]["type"]) == (400,
                                               "invalid_request_error")
        st, _, body = post(addr, {"input": []}, path="/v1/embeddings")
        assert st == 400
        live = drv.submit(np.array([3, 14, 15], np.int64),
                          SamplingParams(max_new_tokens=100),
                          request_id="dup")
        assert wait_until(lambda: drv.stats()["residents"] == 1)
        st, _, body = post(addr, {"prompt": [1, 2], "max_tokens": 2,
                                  "request_id": "dup"})
        assert st == 409 and body["error"]["type"] == "conflict"
        st, text = get(addr, "/debug/state")
        assert st == 403 and "PADDLE_TPU_DEBUG" in text
        drv.cancel("dup")
        assert live.wait(JOIN_S) and live.finish_reason == "cancelled"
    finally:
        server.drain(JOIN_S)


def test_debug_routes(models):
    server = serve(port_engines(models, 2), poll_interval_s=0.01,
                   debug_endpoints=True)
    addr = server.server_address[:2]
    try:
        st, _, out = post(addr, {"prompt": [3, 14, 15], "max_tokens": 3,
                                 "request_id": "dbg-1"})
        assert st == 200
        st, text = get(addr, "/debug/requests/dbg-1")
        events = json.loads(text)["events"]
        assert st == 200 and {e["replica"] for e in events} <= {
            "replica-0", "replica-1"}
        st, text = get(addr, "/debug/requests/dbg-1?format=chrome")
        assert st == 200 and "traceEvents" in json.loads(text)
        assert get(addr, "/debug/requests/ghost")[0] == 404
        for route in ("/debug/state", "/debug/flight", "/debug/fleet"):
            st, text = get(addr, route)
            assert st == 200 and json.loads(text)
        fleet = json.loads(get(addr, "/debug/fleet")[1])
        assert set(fleet["replicas"]) == {"replica-0", "replica-1"}
        assert fleet["slo_worst"] in ("ok", "warn", "page")
        assert get(addr, "/debug/nothing")[0] == 404
    finally:
        server.drain(JOIN_S)


def test_keep_alive_two_requests_one_socket(models):
    server = serve(port_engines(models, 1), poll_interval_s=0.01)
    addr = server.server_address[:2]
    try:
        conn = http.client.HTTPConnection(*addr, timeout=JOIN_S)
        outs = []
        for prompt in ([3, 14, 15, 9], [26, 5, 35]):
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": prompt, "max_tokens": 6}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            headers = dict(resp.getheaders())
            body = json.loads(resp.read())
            assert resp.status == 200
            assert headers["Connection"].lower() == "keep-alive"
            assert int(headers["Content-Length"]) > 0
            outs.append(body["choices"][0]["token_ids"])
        conn.close()
        assert outs == [solo(models, [3, 14, 15, 9], 6),
                        solo(models, [26, 5, 35], 6)]
    finally:
        server.drain(JOIN_S)


def test_usage_reports_cached_tokens(models):
    """A second identical prompt hits the prefix cache: usage carries
    its cached tokens, and both outputs are the JAX engine's."""
    server = serve(port_engines(models, 1, page_size=8),
                   poll_interval_s=0.01)
    addr = server.server_address[:2]
    prompt = list(range(1, 21))
    try:
        outs = [post(addr, {"prompt": prompt, "max_tokens": 6})
                for _ in range(2)]
        want = solo(models, prompt, 6, page_size=8)
        assert [o[0] for o in outs] == [200, 200]
        assert [o[2]["choices"][0]["token_ids"] for o in outs] == [want] * 2
        cached = [o[2]["usage"]["cached_tokens"] for o in outs]
        assert cached[0] == 0 and 0 < cached[1] <= len(prompt) - 1
        text = get(addr, "/metrics")[1]
        assert "paddle_serving_prefix_hits_total" in text
    finally:
        server.drain(JOIN_S)


def test_rate_limit_429_per_client(models):
    server = serve(port_engines(models, 1), poll_interval_s=0.01,
                   rate_limit=0.5, rate_limit_burst=1)
    addr = server.server_address[:2]
    try:
        def call(key):
            hdr = {"Authorization": f"Bearer {key}"} if key else {}
            return post(addr, {"prompt": [1, 2], "max_tokens": 2},
                        headers=hdr)
        assert call("alice")[0] == 200
        st, headers, body = call("alice")
        assert st == 429 and int(headers["Retry-After"]) >= 1
        assert body["error"]["type"] == "rate_limit_exceeded"
        assert call("bob")[0] == 200 and call(None)[0] == 200
        assert server.rate_limiter.rejected_total == 1
        text = get(addr, "/metrics")[1]
        assert "paddle_serving_rate_limited_total 1" in text
        assert "paddle_serving_rate_limit_clients 3" in text
    finally:
        server.drain(JOIN_S)


def test_full_queue_and_infeasible_deadline_429(models):
    engines = port_engines(models, 1, num_slots=1, max_len=128, max_queue=1)
    server = serve(engines, poll_interval_s=0.01, controller=True)
    addr = server.server_address[:2]
    driver = server.router.drivers[0]
    try:
        blocker = driver.submit(np.array([3, 14, 15, 9], np.int64),
                                SamplingParams(max_new_tokens=100))
        assert wait_until(lambda: driver.stats()["residents"] == 1)
        queued = driver.submit(np.array([26, 5, 35], np.int64),
                               SamplingParams(max_new_tokens=4))
        assert wait_until(lambda: driver.stats()["queue_depth"] == 1)
        st, headers, body = post(addr, {"prompt": [1, 2], "max_tokens": 2})
        assert st == 429 and int(headers["Retry-After"]) >= 1
        assert body["error"]["type"] == "rate_limit_exceeded"
        ctrl = server.router.controller
        ctrl.observe = lambda router: FleetSignals(
            replicas=1, queue_depth=50, tokens_per_sec=10.0)
        st, headers, body = post(addr, {"prompt": [1, 2], "max_tokens": 2,
                                        "deadline": 1.0})
        assert st == 429 and body["error"]["type"] == "deadline_infeasible"
        assert int(headers["Retry-After"]) == 319
        assert isinstance(ctrl, FleetController)
        assert ctrl.admission_shed_total == 1
        assert blocker.finish_reason is None
    finally:
        server.drain(JOIN_S)
    assert blocker.finish_reason == "length" and queued.finished
    assert engines[0].pool.used_pages == 0


def test_deadline_504_and_preemption_usage(models):
    """An equal-priority arrival queues behind the resident and its
    deadline passes: 504 with the typed body; a higher-priority arrival
    preempts the resident, which resumes and reports usage.preemptions
    with the JAX engine's tokens."""
    eng = port_engines(models, 1, num_slots=1, max_len=128, page_size=8,
                       chunk_len=16)[0]
    server = serve([eng], poll_interval_s=0.01)
    addr = server.server_address[:2]
    lo_prompt = [3, 14, 15, 9]
    want = solo(models, lo_prompt, 110, num_slots=1, max_len=128,
                page_size=8, chunk_len=16)
    res = {}

    def lo():
        res["lo"] = post(addr, {"prompt": lo_prompt, "max_tokens": 110,
                                "priority": 5})

    lt = threading.Thread(target=lo)
    try:
        lt.start()
        assert wait_until(lambda: eng.metrics.tokens_generated > 0)
        st, _, body = post(addr, {"prompt": [5, 6, 7], "max_tokens": 4,
                                  "priority": 5, "deadline": 0.05})
        assert st == 504 and body["error"]["code"] == 504
        assert body["error"]["type"] == "deadline_exceeded"
        st, _, body = post(addr, {"prompt": [8, 9, 10], "max_tokens": 4,
                                  "priority": 0})
        assert st == 200
        lt.join(JOIN_S)
        st, _, body = res["lo"]
        assert st == 200 and body["choices"][0]["token_ids"] == want
        assert body["usage"]["preemptions"] >= 1
    finally:
        server.drain(JOIN_S)


def test_client_disconnect_mid_stream_cancels_and_frees(models):
    eng = port_engines(models, 1, num_slots=2, max_len=128, page_size=8)[0]
    server = serve([eng], poll_interval_s=0.01)
    addr = server.server_address[:2]
    driver = server.router.drivers[0]
    try:
        pn = [26, 5, 35]
        neighbor = driver.submit(np.array(pn, np.int64),
                                 SamplingParams(max_new_tokens=60))
        body = json.dumps({"prompt": [3, 14, 15, 9], "max_tokens": 120,
                           "stream": True}).encode()
        sock = socket.create_connection(addr, timeout=30)
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode()
                     + body)
        reader = sock.makefile("rb")
        seen = 0
        while seen < 2:
            line = reader.readline()
            assert line, "stream ended before 2 tokens"
            if line.startswith(b"data: ") and \
                    json.loads(line[6:])["choices"][0]["token"] is not None:
                seen += 1
        victim = next(r for r in eng._requests.values()
                      if r.sampling.max_new_tokens == 120)
        sock.shutdown(socket.SHUT_RDWR)
        reader.close()
        sock.close()
        assert victim.wait(JOIN_S)
        assert victim.finish_reason == "cancelled"
        assert 2 <= len(victim.output_tokens) < 120
        assert wait_until(lambda: victim.slot is None
                          and victim.pages is None)
        assert neighbor.wait(JOIN_S)
        assert neighbor.output_tokens == solo(
            models, pn, 60, num_slots=2, max_len=128, page_size=8)
    finally:
        server.drain(JOIN_S)
    assert eng.pool.used_pages == 0 and not eng.scheduler.running


def test_drain_flips_readyz_and_finishes_residents(models):
    eng = port_engines(models, 1, num_slots=2, max_len=128)[0]
    server = serve([eng], poll_interval_s=0.01)
    addr = server.server_address[:2]
    prompt = [3, 14, 15, 9]
    result = {}
    client = threading.Thread(target=lambda: result.setdefault(
        "r", read_sse(addr, {"prompt": prompt, "max_tokens": 110})))
    client.start()
    assert wait_until(
        lambda: server.router.drivers[0].stats()["residents"] == 1)
    drainer = threading.Thread(target=server.drain, args=(JOIN_S,))
    drainer.start()
    try:
        assert wait_until(lambda: not server.accepting, timeout=10)
        st, text = get(addr, "/readyz")
        assert st == 503 and "draining" in text
        st, _, body = post(addr, {"prompt": [1, 2], "max_tokens": 2})
        assert st == 503
        assert body["error"]["type"] == "service_unavailable"
    finally:
        drainer.join(JOIN_S)
        client.join(JOIN_S)
    st, frames = result["r"]
    assert st == 200 and frames[-1]["choices"][0]["finish_reason"] \
        == "length"
    assert sse_tokens(frames) == solo(models, prompt, 110, num_slots=2,
                                      max_len=128)
    assert not eng.scheduler.running and eng.scheduler.queue_depth == 0
    assert eng.pool.used_pages == 0
    assert not drainer.is_alive() and not client.is_alive()


# -- the contracts red on the JAX side at take-up -----------------------------
def test_poisoned_request_is_422_and_rendered(models):
    """tests/test_serving_faults.py:547: the poisoned request fails alone
    as "poisoned" (422 by the status map, and over HTTP), its neighbour
    keeps the JAX engine's tokens, and /metrics renders the resilience
    series."""
    inj = FaultInjector()
    engines = port_engines(models, 1)
    server = serve(engines, poll_interval_s=0.01, faults=inj)
    addr = server.server_address[:2]
    drv = server.router.drivers[0]
    try:
        inj.poison("req-poison")
        neighbor = drv.submit(np.array([3, 14, 15, 9], np.int64),
                              SamplingParams(max_new_tokens=20))
        poisoned = drv.submit(np.array([26, 5, 35], np.int64),
                              SamplingParams(max_new_tokens=8),
                              request_id="req-poison")
        assert poisoned.wait(JOIN_S)
        assert poisoned.finish_reason == "poisoned"
        assert isinstance(poisoned.error, PoisonedRequest)
        assert neighbor.wait(JOIN_S) and neighbor.finish_reason == "length"
        assert neighbor.output_tokens == solo(models, [3, 14, 15, 9], 20)
        assert tproto.status_for_output(poisoned.output()) == 422
        inj.poison("req-http")
        st, _, body = post(addr, {"prompt": [7, 8, 9], "max_tokens": 4,
                                  "request_id": "req-http"})
        assert st == 422 and body["choices"][0]["finish_reason"] \
            == "poisoned"
        text = get(addr, "/metrics")[1]
        assert 'paddle_serving_poisoned_total{replica="replica-0"} 2' \
            in text
        assert 'paddle_serving_requests_total{outcome="poisoned",' \
            'replica="replica-0"} 2' in text
        for line in ("paddle_serving_migrations_total 0",
                     "paddle_serving_watchdog_kills_total 0",
                     'paddle_serving_breaker_state{replica="replica-0",'
                     'state="closed"} 0',
                     "paddle_serving_retries_total 0"):
            assert line in text
    finally:
        server.drain(JOIN_S)
    engines[0].pool.assert_quiesced()


def test_sse_stream_survives_replica_kill(models):
    """tests/test_serving_faults.py:621: the SSE client's replica dies
    after 3 tokens; the client reads the JAX engine's uninterrupted
    tokens to [DONE], finish_reason length, usage.migrations 1 and 30
    completion tokens."""
    engines = port_engines(models, 2)
    server = serve(engines, poll_interval_s=0.01)
    addr = server.server_address[:2]
    prompt = [3, 14, 15, 9]
    killed = []

    def kill_at_3(tokens):
        if len(tokens) == 3 and not killed:
            victim = next(d for d in server.router.drivers
                          if d.engine.scheduler.running)
            killed.append(victim.name)
            victim.kill()

    try:
        st, frames = read_sse(addr, {"prompt": prompt, "max_tokens": 30},
                              on_token=kill_at_3)
        final = frames[-1]
        assert st == 200 and final["choices"][0]["finish_reason"] == "length"
        assert sse_tokens(frames) == solo(models, prompt, 30)
        assert final["usage"]["migrations"] == 1
        assert final["usage"]["completion_tokens"] == 30
        assert server.router.migrations_total == 1 and len(killed) == 1
        assert get(addr, "/healthz")[0] == 200
    finally:
        server.drain(JOIN_S)
