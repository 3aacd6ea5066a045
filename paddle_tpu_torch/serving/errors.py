"""Typed errors of the serving engine (counterpart of
`paddle_tpu/serving/errors.py`). The HTTP layer (`serving/http/`) maps
them to status codes without matching exception text:

- `QueueFull` — admission queue at max_queue: shed load, retry later
  (429 + Retry-After).
- `RateLimited` — one client exceeded its token bucket: back off (429 +
  Retry-After, per client).
- `EngineClosed` — the engine is draining or aborted: no new requests
  (503).
- `PoisonedRequest` — this one request deterministically kills the
  serving step; the engine's quarantine failed it alone (422).
- `DeadlineExceeded` — a request's placement deadline (`deadline_s`)
  passed while it was still queued; it never started (504).

All subclass `ServingError(RuntimeError)`.
"""
from __future__ import annotations

__all__ = ["ServingError", "QueueFull", "EngineClosed", "RateLimited",
           "PoisonedRequest", "DeadlineExceeded"]


class ServingError(RuntimeError):
    """Base of all typed serving errors."""


class QueueFull(ServingError):
    """Admission queue at max_queue. `retry_after_s` is a hint for how
    long until queue drain plausibly frees a spot."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class RateLimited(ServingError):
    """This client (API key or remote address) exceeded its token
    bucket: back off for `retry_after_s`. Unlike QueueFull, which sheds
    load globally, other clients are still admitted."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class EngineClosed(ServingError):
    """The engine began shutdown (`drain()` or `abort_all()`): no new
    requests are admitted."""


class PoisonedRequest(ServingError):
    """This one request deterministically kills the serving step. The
    engine's quarantine isolated it by bisecting the resident batch,
    failed it alone (finish reason "poisoned") and kept serving its
    co-residents. Never retried or migrated: replaying it would kill the
    next replica too."""


class DeadlineExceeded(ServingError):
    """The request's placement deadline (`deadline_s`) expired while it
    was still QUEUED: it never reached a slot, emitted nothing, and is
    failed fast (finish reason "deadline"). A request that already
    started is never deadline-failed; runtime limits are `timeout_s`'s
    job."""
