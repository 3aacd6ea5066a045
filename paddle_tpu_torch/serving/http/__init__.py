"""paddle_tpu_torch.serving.http: the streaming HTTP front end of the
serving engine (counterpart of `paddle_tpu.serving.http`). Stdlib only
over the engines.

`EngineDriver` gives each engine replica its own pump thread (the one
thread that touches its card), `Router` does health-scored placement,
failover, mid-stream migration, the circuit breaker, the heartbeat
watchdog, drain and the KV fabric's placements across N replicas, and
`ServingHTTPServer` exposes OpenAI-style `POST /v1/completions` (JSON
and SSE streaming) and `POST /v1/embeddings`, with `/healthz`, `/readyz`,
Prometheus `/metrics` and the `/debug/*` routes behind PADDLE_TPU_DEBUG:

    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.http import serve

    engines = [ServingEngine(model) for _ in range(2)]  # on the card
    server = serve(engines, port=8000)       # starts drivers + HTTP
    ...
    server.drain()                           # graceful shutdown

    curl -N localhost:8000/v1/completions -d \
      '{"prompt": [3, 14, 15], "max_tokens": 8, "stream": true}'

The engines are whatever the caller built: `ServingEngine(model)` runs
on the card, `ServingEngine(model, device="cpu")` on the CPU. The front
end itself launches nothing on the device.
"""
from typing import Optional, Sequence

from ..controlplane import (DeadlineInfeasible, FleetController,  # noqa: F401,E501
                            resolve_controlplane)
from ..faults import FaultInjector, InjectedFault, resolve_faults  # noqa: F401,E501
from .driver import EngineDriver, ReplicaDead, ReplicaHung  # noqa: F401
from .protocol import (CompletionRequest, ProtocolError,  # noqa: F401
                       parse_completion_request)
from .ratelimit import RateLimiter, TokenBucket  # noqa: F401
from .router import (CircuitBreaker, ReplicaWatchdog,  # noqa: F401
                     Router, Ticket)
from .server import ServingHTTPServer  # noqa: F401

__all__ = ["EngineDriver", "ReplicaDead", "ReplicaHung", "Router",
           "Ticket", "CircuitBreaker", "ReplicaWatchdog",
           "ServingHTTPServer", "ProtocolError", "CompletionRequest",
           "parse_completion_request", "RateLimiter", "TokenBucket",
           "FaultInjector", "InjectedFault", "resolve_faults",
           "FleetController", "DeadlineInfeasible",
           "resolve_controlplane", "serve"]


def serve(engines: Sequence, host: str = "127.0.0.1", port: int = 0,
          *, model_name: str = "paddle-tpu",
          default_timeout_s: Optional[float] = None,
          max_retries: int = 3,
          max_migrations: int = 8,
          poll_interval_s: float = 0.05,
          rate_limit: Optional[float] = None,
          rate_limit_burst: Optional[float] = None,
          watchdog_timeout_s: Optional[float] = None,
          breaker_failures: int = 3,
          breaker_open_s: float = 1.0,
          faults: Optional[FaultInjector] = None,
          controller=None,
          debug_endpoints=None) -> ServingHTTPServer:
    """One-call assembly: wrap each engine in a driver, front them with
    a router, start the HTTP server on (host, port) — port 0 picks a
    free one (see `server.url`). `rate_limit`/`rate_limit_burst` turn
    on per-client token-bucket limiting (429 + Retry-After per API
    key / remote address). `watchdog_timeout_s` starts the heartbeat
    watchdog (a replica whose pump stalls that long is condemned and
    its streams migrate; size it above the worst-case step time
    including first-use compilation: on the card the kernels build with
    nvcc at their first launch, which takes minutes, so build them
    first with `paddle_tpu_torch.ops.cuda._build.build()` or give the
    watchdog more than that). The router also resolves the KV fabric
    (PADDLE_TPU_KV_FABRIC, default off). `faults` injects a deterministic
    fault schedule (serving/faults.py) — when omitted, the
    PADDLE_TPU_FAULTS env spec is parsed (unset = no injection).
    `debug_endpoints=True` (or PADDLE_TPU_DEBUG=on) exposes the
    `/debug/state`, `/debug/requests/<id>` and `/debug/flight`
    introspection routes (serving/obs.py) — off by default, they
    carry prompt metadata. `controller` attaches a fleet control
    plane (serving/controlplane.py: SLO-aware placement,
    deadline-aware admission, burn-rate autoscaling) — pass a
    `FleetController`, True/False, or a spec string; when omitted,
    the PADDLE_TPU_CONTROLPLANE env spec is resolved (unset = off).
    Returns the STARTED server; call `drain()`
    (or `install_signal_handlers()` for SIGTERM) to stop."""
    if faults is None:
        faults = resolve_faults()
    if not isinstance(controller, FleetController):
        cp_cfg = resolve_controlplane(controller)
        controller = (None if cp_cfg is None
                      else FleetController(cp_cfg))
    drivers = [EngineDriver(e, name=f"replica-{i}", faults=faults)
               for i, e in enumerate(engines)]
    router = Router(drivers, max_retries=max_retries,
                    max_migrations=max_migrations,
                    default_timeout_s=default_timeout_s,
                    watchdog_timeout_s=watchdog_timeout_s,
                    breaker_failures=breaker_failures,
                    breaker_open_s=breaker_open_s,
                    controller=controller)
    server = ServingHTTPServer(router, host, port,
                               model_name=model_name,
                               poll_interval_s=poll_interval_s,
                               rate_limit=rate_limit,
                               rate_limit_burst=rate_limit_burst,
                               debug_endpoints=debug_endpoints)
    return server.start()
