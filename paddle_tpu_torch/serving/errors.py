"""Typed errors of the serving engine (counterpart of
`paddle_tpu/serving/errors.py`; the HTTP layer that maps them to status
codes is not ported yet).

- `QueueFull` — admission queue at max_queue: shed load, retry later.
- `EngineClosed` — the engine is draining (`drain()`): no new requests.
- `DeadlineExceeded` — a request's placement deadline (`deadline_s`)
  passed while it was still queued; it never started.

All subclass `ServingError(RuntimeError)`; the engine's other typed
errors come with the features that raise them.
"""
from __future__ import annotations

__all__ = ["ServingError", "QueueFull", "EngineClosed", "DeadlineExceeded"]


class ServingError(RuntimeError):
    """Base of all typed serving errors."""


class QueueFull(ServingError):
    """Admission queue at max_queue. `retry_after_s` is a hint for how
    long until queue drain plausibly frees a spot."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class EngineClosed(ServingError):
    """The engine began shutdown (`drain()`): no new requests are
    admitted; residents and preempted requests run to completion."""


class DeadlineExceeded(ServingError):
    """The request's placement deadline (`deadline_s`) expired while it
    was still QUEUED: it never reached a slot, emitted nothing, and is
    failed fast (finish reason "deadline"). A request that already
    started is never deadline-failed; runtime limits are `timeout_s`'s
    job."""
