"""Serving telemetry (counterpart of `paddle_tpu/serving/metrics.py`,
cut to what the engine records in this slice): time to first token,
inter-token latency, tokens/s over the busy window, step wall time,
packed tokens per step, the legacy step's prefill chunks (and the host
time to issue each, `prefill_chunk_s`), the wall
time of every decode program (`decode_step_s`: the legacy decode step,
or a unified step, as in the JAX package), the `unified` and
`attn_impl` tags, pool and host-tier use (pages, and bytes by the
engine's `page_bytes`: the JAX engine's `pool.bytes_per_page` and
`host_pool.bytes_total` gauges, with the pools' `kv_dtype`),
preemptions and swap traffic, and the grouped walk's modeled
page-block reads (the JAX
engine's `page_block_reads` and `shared_page_reads_saved` totals and
group-size histogram). Times are seconds on the engine's clock. Per-step and per-request spans go through
`torch.profiler.record_function` in the engine, so a `torch.profiler`
trace of a serving run shows them next to the kernels.

With adapters on, the adapter pool's occupancy and traffic
(`adapter_stats`, `AdapterStore.stats()` refreshed each step) and the
requests submitted per adapter id; the `adapters_enabled` and
`megakernel` tags. The Prometheus rendering, per-priority labels, the
per-adapter latency classes and the other feature counters of the JAX
package are not ported yet.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Optional

__all__ = ["Histogram", "ServingMetrics"]


class Histogram:
    """Running count/sum/min/max over all observations, percentiles
    over the most recent `maxlen`."""

    def __init__(self, maxlen: int = 8192):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._recent = deque(maxlen=maxlen)

    def record(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._recent.append(v)

    def percentile(self, q: float) -> Optional[float]:
        if not self._recent:
            return None
        xs = sorted(self._recent)
        idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
        return xs[idx]

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "mean": (self.total / self.count) if self.count else None,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class ServingMetrics:
    """Engine-owned counters and histograms; one lock covers every hook
    and `snapshot()`, so a reader on another thread never sees a torn
    record."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_received = 0
        self.requests_admitted = 0
        self.requests_completed = 0
        self.requests_cancelled = 0
        self.requests_timeout = 0
        self.requests_deadline = 0
        self.requests_aborted = 0
        self.tokens_generated = 0
        self.prompt_tokens = 0
        self.unified_steps = 0
        # engine rounds (`on_step`), and the legacy step's prefill chunks
        # and the rounds in which chunks ran ahead of the decode step
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.prefill_stall_steps = 0
        # which step the engine runs (unified or the legacy alternating
        # one) and which paged attend ("kernel" | "gather"); set by the
        # engine at construction
        self.unified: Optional[bool] = None
        self.attn_impl: Optional[str] = None
        self.packed_prefill_tokens = 0
        self.packed_decode_tokens = 0
        self.pool_pages_used = 0
        self.pool_pages_cached = 0
        self.pool_pages_total = 0
        self.pool_pages_swapped = 0
        self.host_pages_used = 0
        self.host_pages_total = 0
        # the pools' dtype ("fp", "int8", "fp8") and the device bytes one
        # page costs across all layers (set by the engine)
        self.kv_dtype: Optional[str] = None
        self.pool_bytes_per_page = 0
        self.queue_depth = 0
        # overload preemption and the host tier
        self.preemptions = 0
        self.swapped_out_pages = 0
        self.swapped_in_pages = 0
        self.swap_in_s = Histogram()
        # the grouped walk: whether it is on, and the modeled page-block
        # reads of one (kv head, layer) walk summed over steps
        self.grouped: Optional[bool] = None
        self.page_block_reads = 0
        self.shared_page_reads_saved = 0
        self.group_size_hist = Histogram()
        self.ttft_s = Histogram()
        self.inter_token_s = Histogram()
        self.queue_wait_s = Histogram()
        self.step_s = Histogram()
        # synchronised wall time of one decode program: the legacy decode
        # step, or a unified step (the same histogram, for the A/B)
        self.decode_step_s = Histogram()
        # host time to issue one legacy prefill chunk
        self.prefill_chunk_s = Histogram()
        self.packed_tokens = Histogram()
        # the decode megakernel gate, and the adapter subsystem: whether
        # it is on, the adapter pool's stats (refreshed each step) and
        # the requests submitted per adapter id
        self.megakernel: Optional[bool] = None
        self.adapters_enabled: Optional[bool] = None
        self.adapter_stats: Optional[dict] = None
        self._by_adapter: dict = {}
        self._first_admit_t: Optional[float] = None
        self._last_token_t: Optional[float] = None

    def on_submit(self, req):
        with self._lock:
            self.requests_received += 1

    def on_adapter_request(self, adapter_id: int):
        """One request submitted under `adapter_id` (0: the base
        model)."""
        with self._lock:
            key = str(int(adapter_id))
            self._by_adapter[key] = self._by_adapter.get(key, 0) + 1

    def on_admit(self, req, now: float):
        with self._lock:
            self.requests_admitted += 1
            self.prompt_tokens += int(req.prompt_ids.size)
            self.queue_wait_s.record(now - req.arrival_t)
            if self._first_admit_t is None:
                self._first_admit_t = now

    def on_token(self, req, now: float):
        with self._lock:
            self.tokens_generated += 1
            self._last_token_t = now
            if len(req.output_tokens) == 1:
                self.ttft_s.record(now - req.arrival_t)

    def on_inter_token(self, dt: float):
        with self._lock:
            self.inter_token_s.record(dt)

    def on_finish(self, req, now: float):
        with self._lock:
            reason = req.finish_reason
            if reason in ("stop", "length"):
                self.requests_completed += 1
            elif reason == "cancelled":
                self.requests_cancelled += 1
            elif reason == "timeout":
                self.requests_timeout += 1
            elif reason == "deadline":
                self.requests_deadline += 1
            else:
                self.requests_aborted += 1

    def on_unified_step(self, prefill_tokens: int, decode_tokens: int,
                        wall_s: float):
        """One unified step ran `prefill_tokens` prompt tokens next to
        `decode_tokens` decode tokens in `wall_s` seconds (host clock
        around a step that ends in a device synchronisation)."""
        with self._lock:
            self.unified_steps += 1
            self.packed_prefill_tokens += int(prefill_tokens)
            self.packed_decode_tokens += int(decode_tokens)
            self.packed_tokens.record(int(prefill_tokens)
                                      + int(decode_tokens))
            self.step_s.record(wall_s)
            self.decode_step_s.record(wall_s)

    def on_prefill_chunk(self, n_tokens: int, wall_s: float):
        """The legacy step ran one prefill chunk of `n_tokens` real
        prompt tokens, issued in `wall_s` seconds (host clock, no device
        synchronisation: the host's cost of the chunk)."""
        with self._lock:
            self.prefill_chunks += 1
            self.prefill_chunk_tokens += int(n_tokens)
            self.prefill_chunk_s.record(wall_s)

    def on_decode_step(self, wall_s: float):
        """The legacy step ran one decode program in `wall_s` seconds
        (host clock around a step that ends in a device
        synchronisation)."""
        with self._lock:
            self.decode_step_s.record(wall_s)

    def on_grouped_step(self, flat_reads: int, actual_reads: int,
                        group_sizes):
        """One unified step's modeled page-block reads: the per-row walk
        would issue `flat_reads`, the step issued `actual_reads` (equal
        with grouping off); `group_sizes` lists the member count of
        every group that shared at least one page read."""
        with self._lock:
            self.page_block_reads += int(actual_reads)
            self.shared_page_reads_saved += \
                int(flat_reads) - int(actual_reads)
            for n in group_sizes:
                self.group_size_hist.record(int(n))

    def on_preempt(self, pages_out: int):
        """One resident was preempted: `pages_out` of its KV pages went
        to the host tier (0 = recompute on resume)."""
        with self._lock:
            self.preemptions += 1
            self.swapped_out_pages += int(pages_out)

    def on_swap_in(self, pages_in: int, wall_s: float):
        """Host -> device restore: a resumed request's pages, or one
        prefix-cache spill restore."""
        with self._lock:
            self.swapped_in_pages += int(pages_in)
            if pages_in and wall_s > 0:
                self.swap_in_s.record(wall_s)

    def on_step(self, queue_depth: int, pages_used: int, pages_cached: int,
                pages_total: int, pages_swapped: int = 0,
                host_pages_used: int = 0, host_pages_total: int = 0,
                stall_chunks: int = 0,
                adapter_stats: Optional[dict] = None):
        """One engine round ended; `stall_chunks` prefill chunks of the
        legacy step ran ahead of its decode program."""
        with self._lock:
            if adapter_stats is not None:
                self.adapter_stats = dict(adapter_stats)
            self.decode_steps += 1
            if stall_chunks:
                self.prefill_stall_steps += 1
            self.queue_depth = queue_depth
            self.pool_pages_used = pages_used
            self.pool_pages_cached = pages_cached
            self.pool_pages_total = pages_total
            self.pool_pages_swapped = pages_swapped
            self.host_pages_used = host_pages_used
            self.host_pages_total = host_pages_total

    def tokens_per_s(self) -> Optional[float]:
        """Generated tokens over the busy window (first admission to
        the last emitted token)."""
        with self._lock:
            if self._first_admit_t is None or self._last_token_t is None:
                return None
            span = self._last_token_t - self._first_admit_t
            return self.tokens_generated / span if span > 0 else None

    def snapshot(self) -> dict:
        tps = self.tokens_per_s()
        with self._lock:
            return {
                "requests": {"received": self.requests_received,
                             "admitted": self.requests_admitted,
                             "completed": self.requests_completed,
                             "cancelled": self.requests_cancelled,
                             "timeout": self.requests_timeout,
                             "deadline": self.requests_deadline,
                             "aborted": self.requests_aborted},
                "tokens_generated": self.tokens_generated,
                "prompt_tokens": self.prompt_tokens,
                "tokens_per_s": tps,
                "unified": self.unified,
                "attn_impl": self.attn_impl,
                "unified_steps": self.unified_steps,
                "decode_steps": self.decode_steps,
                "prefill_chunks": self.prefill_chunks,
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "prefill_chunk_s": self.prefill_chunk_s.snapshot(),
                "prefill_stall_steps": self.prefill_stall_steps,
                "decode_step_s": self.decode_step_s.snapshot(),
                "packed_prefill_tokens": self.packed_prefill_tokens,
                "packed_decode_tokens": self.packed_decode_tokens,
                "ttft_s": self.ttft_s.snapshot(),
                "inter_token_s": self.inter_token_s.snapshot(),
                "queue_wait_s": self.queue_wait_s.snapshot(),
                "step_s": self.step_s.snapshot(),
                "packed_tokens_per_step": self.packed_tokens.snapshot(),
                "kv_dtype": self.kv_dtype,
                "pool": {"pages_used": self.pool_pages_used,
                         "pages_cached": self.pool_pages_cached,
                         "pages_total": self.pool_pages_total,
                         "pages_swapped": self.pool_pages_swapped,
                         "bytes_per_page": self.pool_bytes_per_page},
                "host_pool": {"pages_used": self.host_pages_used,
                              "pages_total": self.host_pages_total,
                              "bytes_used": (self.host_pages_used
                                             * self.pool_bytes_per_page),
                              "bytes_total": (self.host_pages_total
                                              * self.pool_bytes_per_page)},
                "queue_depth": self.queue_depth,
                "preemptions": self.preemptions,
                "swapped_out_pages": self.swapped_out_pages,
                "swapped_in_pages": self.swapped_in_pages,
                "swap_in_s": self.swap_in_s.snapshot(),
                "grouped": self.grouped,
                "page_block_reads_total": self.page_block_reads,
                "shared_page_reads_saved_total":
                    self.shared_page_reads_saved,
                "group_size_per_step": self.group_size_hist.snapshot(),
                "megakernel": self.megakernel,
                "adapters_enabled": self.adapters_enabled,
                "adapters": (None if self.adapter_stats is None else {
                    **self.adapter_stats,
                    "requests_by_adapter": dict(
                        sorted(self._by_adapter.items()))}),
            }
