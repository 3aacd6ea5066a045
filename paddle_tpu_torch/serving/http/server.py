"""Streaming HTTP front end over the replica router (counterpart of
`paddle_tpu/serving/http/server.py`). Stdlib only.

`ServingHTTPServer` is a `ThreadingHTTPServer`: one handler thread per
connection blocks on its Ticket's token queue while every engine keeps
stepping on its driver's pump thread, the one thread that touches its
card — N streaming clients cost N cheap waiting threads, not N engine
loops. Handler threads read host state only (metrics snapshots, debug
state); anything that touches the device goes through the driver.

Endpoints:
- `POST /v1/completions` — JSON in, JSON out; `"stream": true` switches
  to SSE token streaming (one `data:` frame per token, final frame with
  finish_reason + usage, then `data: [DONE]`).
- `GET /healthz` — liveness: 200 while >= 1 replica pump thread serves.
- `GET /readyz`  — readiness: 503 the moment drain begins (so a load
  balancer stops routing here before residents finish).
- `GET /metrics` — Prometheus text exposition, one labelled series set
  per replica (`serving.metrics.prometheus_render`).
- `GET /debug/state` / `/debug/requests/<id>` / `/debug/flight` /
  `/debug/fleet` — live debug introspection (serving/obs.py +
  serving/slo.py): per-replica engine state (residents, queue,
  pools, prefix cache), one merged request lifecycle timeline
  (`?format=chrome` for a Perfetto-openable trace), the
  flight-recorder ring + incident dumps, and the ONE-document fleet
  view (health/breaker, pool occupancy, SLO burn states, cost
  census, achieved utilization per replica). OFF by default — gated by
  `debug_endpoints=` / PADDLE_TPU_DEBUG=on — since timelines expose
  prompt metadata (lengths, priorities, ids).

Backpressure and failure map to status codes via typed errors
(serving/errors.py): full queue -> 429 + Retry-After (error type
`rate_limit_exceeded`; when the fleet control plane sheds a request
whose deadline is infeasible at the current backlog, the same 429 +
Retry-After path carries type `deadline_infeasible` so clients can
tell "slow down" from "your deadline cannot be met"), draining/closed
-> 503, a poisoned request (it deterministically kills the serving
step; quarantined by the engine, never retried) -> 422, replica death
-> 502 — and a 502 surfaces only after failover AND mid-stream
migration were exhausted: unstarted requests are resubmitted on
survivors, started streams are migrated (prompt + emitted tokens
re-prefilled elsewhere, the stream resumes token-identically;
`usage.migrations` counts the blips).

Per-client rate limiting (`rate_limit` req/s + `rate_limit_burst` on
the ctor, default off): each API key (Authorization header; remote
address otherwise) draws from its own token bucket BEFORE the request
reaches the router — one chatty client 429s (+ Retry-After) while
everyone else keeps being admitted (serving/http/ratelimit.py).

Connection handling: non-SSE completions (and every GET probe) are
HTTP/1.1 keep-alive — `Content-Length` + `Connection: keep-alive`, so
SDK clients reuse one socket across calls instead of
paying a TCP handshake per completion. SSE streams still close when
done (their length is unknowable up front).

Client disconnects: every SSE write is followed by a liveness probe of
the connection; a dropped reader cancels the request at the engine's
next step boundary, returning its slot and KV pages to the pool.

Graceful drain (`drain()` / SIGTERM via `install_signal_handlers`):
stop admitting (new completions get 503), flip `/readyz`, finish every
resident on every replica, join the driver threads, close the socket.
"""
from __future__ import annotations

import json
import math
import select
import signal
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..controlplane import DeadlineInfeasible
from ..errors import (EngineClosed, QueueFull, RateLimited,
                      ServingError)
from ..metrics import prometheus_render
from ..obs import resolve_debug_flag, timeline_to_chrome
from .protocol import (ProtocolError, completion_body, embeddings_body,
                       error_body, parse_completion_request,
                       parse_embeddings_request, sse, SSE_DONE,
                       status_for_error, status_for_output,
                       stream_chunk, stream_final)
from .ratelimit import RateLimiter
from .router import Router

__all__ = ["ServingHTTPServer"]


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, *, model_name: str = "paddle-tpu",
                 poll_interval_s: float = 0.05,
                 rate_limit: Optional[float] = None,
                 rate_limit_burst: Optional[float] = None,
                 rate_limit_max_clients: int = 4096,
                 debug_endpoints=None):
        self.router = router
        self.model_name = model_name
        self.poll_interval_s = float(poll_interval_s)
        # /debug/* gate (default OFF — request timelines expose prompt
        # metadata); explicit ctor arg wins, else PADDLE_TPU_DEBUG
        self.debug_endpoints = resolve_debug_flag(debug_endpoints)
        # per-client token buckets (None = unlimited): keyed by API key
        # (Authorization header) falling back to the remote address
        self.rate_limiter = (
            None if rate_limit is None else
            RateLimiter(rate_limit, rate_limit_burst,
                        max_clients=rate_limit_max_clients))
        self._accepting = True
        self._serve_thread: Optional[threading.Thread] = None
        super().__init__((host, port), _Handler)

    def handle_error(self, request, client_address):
        """Clients dropping connections mid-request is a normal event
        for a streaming server — don't spray tracebacks for it."""
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            TimeoutError)):
            return
        super().handle_error(request, client_address)

    # -- lifecycle ---------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def accepting(self) -> bool:
        return self._accepting and self.router.ready

    def start(self) -> "ServingHTTPServer":
        """Start the replica drivers and serve in a daemon thread."""
        self.router.start()
        self._serve_thread = threading.Thread(
            target=self.serve_forever, name="serving-http",
            daemon=True)
        self._serve_thread.start()
        return self

    def drain(self, timeout: Optional[float] = None):
        """Graceful shutdown: stop admitting (-> 503, /readyz flips),
        finish every resident request, join the driver threads, then
        stop the HTTP loop and close the listening socket. In-flight
        streams run to completion before this returns."""
        self._accepting = False
        self.router.drain(timeout)
        self.shutdown()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout)
        self.server_close()

    def install_signal_handlers(self, signals=(signal.SIGTERM,
                                               signal.SIGINT)):
        """SIGTERM/SIGINT -> graceful drain (call from the main
        thread). The drain runs in a helper thread so the handler
        returns immediately."""
        def _on_signal(signum, frame):
            threading.Thread(target=self.drain, daemon=True).start()
        for s in signals:
            signal.signal(s, _on_signal)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "paddle-tpu-serving"

    def log_message(self, format, *args):   # noqa: A002 - stdlib name
        pass                                # keep client output clean

    # -- plumbing ----------------------------------------------------------
    def _send_json(self, status: int, obj: dict, headers=()):
        body = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        # explicit keep-alive: Content-Length bounds the body, so the
        # client may reuse this socket for its next completion (SSE
        # streams are the only close-per-request path)
        self.send_header("Connection", "keep-alive")
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, status: int, message: str,
                         err_type: str = "server_error", headers=()):
        self._send_json(status, error_body(status, message, err_type),
                        headers=headers)

    def _client_disconnected(self) -> bool:
        """True once the peer closed its end: readable socket whose
        recv(MSG_PEEK) returns b'' (EOF). Never consumes request data."""
        try:
            r, _, _ = select.select([self.connection], [], [], 0)
            if not r:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True

    # -- routes ------------------------------------------------------------
    def do_GET(self):
        if self.path == "/healthz":
            ok = self.server.router.healthy
            self._send_json(200 if ok else 503,
                            {"status": "ok" if ok else "unhealthy"})
        elif self.path == "/readyz":
            ok = self.server.accepting
            self._send_json(200 if ok else 503,
                            {"status": "ready" if ok else "draining"})
        elif self.path == "/metrics":
            router = self.server.router
            stats = router.stats()
            extra = {
                "ready": int(self.server.accepting),
                "replicas_healthy": sum(
                    1 for r in stats["replicas"] if r["healthy"]),
                "replicas_total": len(stats["replicas"]),
                "router_retries_total": stats["retries_total"],
            }
            if self.server.rate_limiter is not None:
                extra["rate_limited_total"] = \
                    self.server.rate_limiter.rejected_total
                extra["rate_limit_clients"] = \
                    self.server.rate_limiter.clients
            # router= adds the resilience series: retries/migrations/
            # watchdog-kill counters + per-replica breaker_state gauge
            text = prometheus_render(router.metrics_snapshots(),
                                     extra_gauges=extra,
                                     router=stats)
            body = text.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/debug/"):
            self._respond_debug()
        else:
            self._send_error_json(404, f"no route {self.path!r}",
                                  "not_found")

    def _respond_debug(self):
        """`/debug/state` | `/debug/flight` | `/debug/requests/<id>`
        (+ `?format=chrome`): live introspection over serving/obs.py.
        403 unless the server was built with debug endpoints on."""
        if not self.server.debug_endpoints:
            self._send_error_json(
                403, "debug endpoints are disabled: start the server "
                "with debug_endpoints=True or PADDLE_TPU_DEBUG=on",
                "forbidden")
            return
        from urllib.parse import parse_qs, unquote, urlparse
        parsed = urlparse(self.path)
        router = self.server.router
        if parsed.path == "/debug/state":
            self._send_json(200, router.debug_state())
        elif parsed.path == "/debug/fleet":
            self._send_json(200, router.fleet_snapshot())
        elif parsed.path == "/debug/flight":
            self._send_json(200, router.flight_dumps())
        elif parsed.path.startswith("/debug/requests/"):
            rid = unquote(parsed.path[len("/debug/requests/"):])
            timeline = router.request_timeline(rid)
            if timeline is None:
                self._send_error_json(
                    404, f"no timeline for request {rid!r} (unknown "
                    "id, obs off, or evicted from the bounded "
                    "tracer)", "not_found")
            elif parse_qs(parsed.query).get("format",
                                            [""])[0] == "chrome":
                self._send_json(200, timeline_to_chrome(timeline, rid))
            else:
                self._send_json(200, {"request_id": rid,
                                      "events": timeline})
        else:
            self._send_error_json(404, f"no route {self.path!r}",
                                  "not_found")

    def do_POST(self):
        if self.path == "/v1/completions":
            parse = parse_completion_request
        elif self.path == "/v1/embeddings":
            # embeddings ride the completion plumbing end to end — a
            # prefill-only request (sampling.embed=True) through the
            # same admission, rate limiting and ticketing
            parse = parse_embeddings_request
        else:
            self._send_error_json(404, f"no route {self.path!r}",
                                  "not_found")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            creq = parse(self.rfile.read(length))
        except ProtocolError as e:
            self._send_error_json(e.status, str(e), e.err_type)
            return
        limiter = self.server.rate_limiter
        if limiter is not None:
            key = (self.headers.get("Authorization")
                   or f"addr:{self.client_address[0]}")
            try:
                limiter.check(key)
            except RateLimited as e:
                retry_after = max(1, math.ceil(e.retry_after_s))
                self._send_error_json(
                    429, str(e), "rate_limit_exceeded",
                    headers=[("Retry-After", str(retry_after))])
                return
        if not self.server.accepting:
            self._send_error_json(503, "server is draining",
                                  "service_unavailable")
            return
        # multi-tenant LoRA: map the OpenAI-style `model` name through
        # the fleet's adapter registry. The base model answers to the
        # server's own model_name (and "base"); anything else must be
        # a registered adapter -> sampling.adapter_id, which then
        # rides migration/preemption with the sampling params.
        if creq.model is not None and \
                creq.model not in (self.server.model_name, "base"):
            aid = self.server.router.resolve_model(creq.model)
            if aid is None:
                self._send_error_json(
                    404, f"unknown model {creq.model!r}: not the base "
                    "model and no adapter registered under that name",
                    "model_not_found")
                return
            creq.sampling.adapter_id = aid
        try:
            ticket = self.server.router.submit(
                creq.prompt_ids, creq.sampling,
                ticket_id=creq.request_id)
        except ValueError as e:
            # a client-named request_id colliding with a LIVE request
            # surfaces as the engine's duplicate-id ValueError
            self._send_error_json(409, str(e), "conflict")
            return
        except QueueFull as e:
            retry_after = max(1, math.ceil(e.retry_after_s))
            err_type = ("deadline_infeasible"
                        if isinstance(e, DeadlineInfeasible)
                        else "rate_limit_exceeded")
            self._send_error_json(
                429, str(e), err_type,
                headers=[("Retry-After", str(retry_after))])
            return
        except ServingError as e:
            self._send_error_json(status_for_error(e), str(e))
            return
        if self.path == "/v1/embeddings":
            self._respond_embeddings(ticket, creq.model)
        elif creq.stream:
            self._respond_stream(ticket, creq.model)
        else:
            self._respond_blocking(ticket, creq.model)

    # -- completion paths --------------------------------------------------
    def _respond_blocking(self, ticket, model=None):
        poll = self.server.poll_interval_s
        for kind, val in ticket.events(poll_s=poll):
            if kind in ("idle", "token"):
                if self._client_disconnected():
                    ticket.cancel()     # frees the slot + pages
                    return
            elif kind == "error":
                self._send_error_json(status_for_error(val), str(val))
                return
            elif kind == "done":
                break
        # merged view across attempts (mid-stream migration banks the
        # tokens of dead attempts; usage carries the migration count)
        out = ticket.output()
        status = status_for_output(out)
        if out.finish_reason == "deadline":
            # fail-fast overload path: the request never started (by
            # construction zero tokens), so clients get the typed
            # error envelope, not an empty completion
            self._send_error_json(
                status, "placement deadline exceeded while queued; "
                "the request never started", "deadline_exceeded")
            return
        self._send_json(status,
                        completion_body(
                            ticket.id,
                            model or self.server.model_name, out))

    def _respond_embeddings(self, ticket, model=None):
        poll = self.server.poll_interval_s
        for kind, val in ticket.events(poll_s=poll):
            if kind in ("idle", "token"):
                if self._client_disconnected():
                    ticket.cancel()
                    return
            elif kind == "error":
                self._send_error_json(status_for_error(val), str(val))
                return
            elif kind == "done":
                break
        out = ticket.output()
        status = status_for_output(out)
        if status != 200:
            self._send_error_json(
                status, f"embedding request failed: "
                f"{out.finish_reason}", "server_error")
            return
        self._send_json(status,
                        embeddings_body(
                            ticket.id,
                            model or self.server.model_name, out))

    def _respond_stream(self, ticket, model=None):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        poll = self.server.poll_interval_s
        model = model or self.server.model_name
        try:
            for kind, val in ticket.events(poll_s=poll):
                if kind == "token":
                    # probe BEFORE and not only on idle beats: a fast
                    # decode keeps the token queue non-empty, so idle
                    # may never fire and writes into a closed socket
                    # can succeed silently (OS send buffer)
                    if self._client_disconnected():
                        ticket.cancel()
                        return
                    self.wfile.write(sse(stream_chunk(ticket.id, model,
                                                      val)))
                    self.wfile.flush()
                elif kind == "idle":
                    if self._client_disconnected():
                        ticket.cancel()
                        return
                elif kind == "error":
                    self.wfile.write(sse(error_body(
                        status_for_error(val), str(val))))
                    self.wfile.write(SSE_DONE)
                    return
                elif kind == "done":
                    out = ticket.output()
                    self.wfile.write(sse(stream_final(ticket.id, model,
                                                      out)))
                    self.wfile.write(SSE_DONE)
                    return
        except (BrokenPipeError, ConnectionResetError):
            ticket.cancel()             # reader dropped mid-stream
