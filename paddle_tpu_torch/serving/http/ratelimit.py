"""Per-client token-bucket rate limiting for the HTTP front end
(counterpart of `paddle_tpu/serving/http/ratelimit.py`).

Global load shedding already exists (admission queue full -> QueueFull
-> 429): it protects the ENGINE. This module protects OTHER CLIENTS —
one chatty client must not monopolize the admission queue of a server
meant for heavy multi-tenant traffic. Each client key (API key from the
Authorization header, falling back to the remote address) gets its own
token bucket: `burst` requests instantly, refilled at `rate` per
second. Over-limit requests are rejected BEFORE touching the router
with a typed `RateLimited` (HTTP 429 + Retry-After telling the client
exactly when its bucket will cover one request).

Buckets are lazily created and LRU-capped (`max_clients`) so an open
endpoint scanning random API keys cannot grow host memory unboundedly —
evicting a bucket merely refunds that client a full burst.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

from ..errors import RateLimited

__all__ = ["TokenBucket", "RateLimiter"]


class TokenBucket:
    """Classic token bucket: capacity `burst`, refilled continuously at
    `rate` tokens/second. Not thread-safe on its own — the RateLimiter
    serializes access."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be > 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self.tokens = float(burst)
        self._t = clock()

    def try_acquire(self, n: float = 1.0) -> float:
        """Take `n` tokens if available: returns 0.0 on success, else
        the seconds until the bucket will hold `n` tokens (the
        Retry-After hint). Refill happens lazily on each call."""
        now = self._clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


class RateLimiter:
    """Thread-safe map of client key -> TokenBucket with LRU capping.

    `check(key)` raises `RateLimited` (carrying retry_after_s) when the
    key's bucket is empty; otherwise it debits one token and returns.
    """

    def __init__(self, rate: float, burst: Optional[float] = None,
                 max_clients: int = 4096,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None
                           else max(1.0, rate))
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError("rate and burst must be > 0")
        self.max_clients = int(max_clients)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self.rejected_total = 0

    def check(self, key: str):
        """Debit one request from `key`'s bucket or raise RateLimited."""
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = TokenBucket(self.rate, self.burst,
                                     clock=self._clock)
                self._buckets[key] = bucket
                while len(self._buckets) > self.max_clients:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(key)
            wait = bucket.try_acquire()
            if wait > 0.0:
                self.rejected_total += 1
                raise RateLimited(
                    f"client {key!r} exceeded {self.rate:g} req/s "
                    f"(burst {self.burst:g}); retry in {wait:.2f}s",
                    retry_after_s=wait)

    @property
    def clients(self) -> int:
        with self._lock:
            return len(self._buckets)
