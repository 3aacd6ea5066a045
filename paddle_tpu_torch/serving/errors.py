"""Typed errors of the serving engine (counterpart of
`paddle_tpu/serving/errors.py`; the HTTP layer that maps them to status
codes is not ported yet).

- `QueueFull` — admission queue at max_queue: shed load, retry later.

It subclasses `ServingError(RuntimeError)`; the engine's other typed
errors come with the features that raise them.
"""
from __future__ import annotations

__all__ = ["ServingError", "QueueFull"]


class ServingError(RuntimeError):
    """Base of all typed serving errors."""


class QueueFull(ServingError):
    """Admission queue at max_queue. `retry_after_s` is a hint for how
    long until queue drain plausibly frees a spot."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)

