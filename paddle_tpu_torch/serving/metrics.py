"""Serving telemetry (counterpart of `paddle_tpu/serving/metrics.py`):
counters, gauges and histograms the engine records, read three ways.

- `ServingMetrics.snapshot()`: a plain dict for dashboards and benches
  (queue depth, TTFT, inter-token latency, `tokens_per_sec`, slot
  occupancy, the pool and host-tier gauges, per-priority latency
  classes, speculative decoding's drafted and accepted tokens and the
  draft pool, grammar-constrained decoding's masked rows and rejected
  drafts, the KV fabric's wire traffic, the SLO tracker's snapshot and the
  cost census), with the JAX engine's keys. The JAX engine's count of
  traced XLA ops in its unified program has no counterpart in an eager
  step: that key is None, as the JAX engine gives it before a trace.
- `prometheus_render(...)`: the same snapshots as Prometheus text
  exposition, fixed-bucket `_bucket` series for TTFT and inter-token
  latency included; `engine_info` carries the A/B tags (`kv_dtype`,
  `unified`, `grouped`, `megakernel`, ...) as labels.
- The host spans the engine opens around each step, prefill chunk and
  page copy (`profiler.RecordEvent`, which enters
  `torch.profiler.record_function`), so a trace of a serving run shows
  them next to the kernels.

The SLO tracker (`serving/slo.py`, `self.slo`) rides the TTFT,
inter-token and deadline-goodput observations, as in the JAX package.
Two histograms are the port's own: `step_s` (host wall time of a unified
step that ends in a device synchronisation) and `prefill_chunk_s` (host
time to issue one legacy prefill chunk). Times are seconds on the
engine's clock, wall times on the host's `perf_counter`.

Every recording hook and `snapshot()` hold one lock, so a scrape thread
never tears a read against the thread stepping the engine.
"""
from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Optional, Sequence

from .slo import SLO_STATE_CODES

__all__ = ["Histogram", "ServingMetrics", "prometheus_render",
           "TTFT_BUCKETS", "LATENCY_BUCKETS", "PACKED_TOKEN_BUCKETS",
           "SPEC_TOKEN_BUCKETS", "GROUP_SIZE_BUCKETS", "UTIL_BUCKETS"]

# fixed Prometheus-style bucket upper bounds (seconds). Fixed — not
# adaptive — so series stay comparable across scrapes and restarts.
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0, 60.0)
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5)
# per-unified-step packed token counts (decode tokens + prefill tokens
# sharing one ragged program invocation)
PACKED_TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
# tokens a decode row emitted in ONE step with speculation on
# (1 sampled + accepted drafts; 1 == nothing accepted/drafted)
SPEC_TOKEN_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16)
# members per prefix-sharing GROUP that actually shared pages in one
# unified step (>= 2 by construction — singletons don't group); the
# mean is the ~Nx of the grouped walk's HBM claim
GROUP_SIZE_BUCKETS = (2, 3, 4, 6, 8, 12, 16, 32)
# achieved utilization of one unified step: packed tokens / the
# step's capacity (num_slots * chunk_len) — the "is packing earning
# the hardware" fraction (1.0 = the step shape is completely full)
UTIL_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.85, 0.95, 1.0)

# distinct per-priority-class label values kept before overflow
# traffic folds into the "other" class (priority is client-supplied
# and unbounded — a label-cardinality bomb without a cap)
PRIORITY_CLASSES_MAX = 8

# distinct per-adapter label values kept before overflow traffic
# folds into "other" (a fleet may register thousands of adapters —
# same cardinality-cap pattern as the per-priority labels)
ADAPTER_IDS_MAX = 8


class Histogram:
    """Bounded-reservoir histogram: running count/sum/min/max over all
    observations, percentiles over the most recent `maxlen`. With
    `buckets` (sorted upper bounds) it also keeps exact fixed-bucket
    counts over ALL observations — the Prometheus histogram shape (the
    implicit +Inf bucket is the last slot)."""

    def __init__(self, maxlen: int = 8192,
                 buckets: Optional[Sequence[float]] = None):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._recent = deque(maxlen=maxlen)
        self.bucket_bounds = (tuple(sorted(float(b) for b in buckets))
                              if buckets else None)
        self._bucket_counts = ([0] * (len(self.bucket_bounds) + 1)
                               if self.bucket_bounds else None)

    def record(self, v: float):
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._recent.append(v)
        if self.bucket_bounds is not None:
            self._bucket_counts[bisect.bisect_left(self.bucket_bounds,
                                                   v)] += 1

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count), ..., (inf, count)] — the
        Prometheus `_bucket{le=...}` series; None without buckets."""
        if self.bucket_bounds is None:
            return None
        out, acc = [], 0
        for bound, n in zip(self.bucket_bounds, self._bucket_counts):
            acc += n
            out.append((bound, acc))
        out.append((math.inf, self.count))
        return out

    def percentile(self, q: float) -> Optional[float]:
        if not self._recent:
            return None
        xs = sorted(self._recent)
        idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
        return xs[idx]

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "sum": self.total,
            "mean": (self.total / self.count) if self.count else None,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }
        cum = self.cumulative_buckets()
        if cum is not None:
            out["buckets"] = [["+Inf" if math.isinf(b) else b, n]
                              for b, n in cum]
        return out


def _unported_off() -> dict:
    """The snapshot key the port has no counterpart of: the JAX engine's
    count of traced ops in its unified program (None, as the JAX engine
    gives it before its first trace)."""
    return {"unified_dispatch_ops": None}


class ServingMetrics:
    """Engine-owned counters/gauges/histograms. Times are seconds on
    the engine's clock; tokens/s is measured over the busy window
    (first admission .. last emitted token)."""

    def __init__(self):
        # one lock covers every recording hook AND snapshot(): the
        # /metrics scrape thread must never tear a read against the
        # thread stepping the engine (e.g. bucket counts vs. sum)
        self._lock = threading.RLock()
        # counters
        self.requests_received = 0
        self.requests_admitted = 0
        self.requests_completed = 0
        self.requests_cancelled = 0
        self.requests_timeout = 0
        self.requests_aborted = 0
        # queued requests that missed their placement deadline and
        # were failed fast ("deadline", HTTP 504) — the overload
        # fail-fast path, distinct from the runtime timeout above
        self.requests_deadline = 0
        # requests quarantined by the engine's poison bisection (they
        # deterministically killed the step; finish reason "poisoned")
        self.requests_poisoned = 0
        # deadline goodput: of the requests that CARRIED a placement
        # deadline, how many finished normally (met) vs deadline-
        # failed 504 (missed = requests_deadline). The pair is the
        # "did the overload scheduler actually deliver" number.
        self.deadline_met = 0
        # overload preemption: residents preempted (banked + swapped
        # to the host tier + requeued) and the whole-page traffic
        # through the device<->host swap programs
        self.preemptions = 0
        self.swapped_out_pages = 0
        self.swapped_in_pages = 0
        self.tokens_generated = 0
        self.prompt_tokens = 0
        self.prefills = 0
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.decode_steps = 0
        # gauges (last observed at a step boundary)
        self.queue_depth = 0
        self.slot_occupancy = 0.0
        self.num_slots = 0
        # paged KV pool gauges: used/total allocatable pages, and the
        # prefill-stall gauge — how many prefill chunk programs ran
        # ahead of the latest decode step (each one delays every
        # resident decode by one chunk forward)
        self.pool_pages_used = 0
        self.pool_pages_total = 0
        self.pool_pages_cached = 0
        # host-RAM tier gauges: outstanding swapped-out logical pages
        # (device side) and host slot occupancy
        self.pool_pages_swapped = 0
        self.host_pages_used = 0
        self.host_pages_total = 0
        self.prefill_stall = 0
        # prefix-cache mirror (source of truth: RadixPrefixCache; the
        # engine pushes a stats() snapshot every step so scrapes never
        # touch the cache's tree): lookups/hits/cached-token counters,
        # eviction + COW totals, resident-page gauge. None = cache off.
        self.prefix: Optional[dict] = None
        # which paged decode attention implementation the engine runs
        # ("kernel" | "gather"); set by the engine at construction so
        # benches/dashboards can attribute latency to the impl
        self.attn_impl: Optional[str] = None
        # paged-pool dtype tag ("fp" | "int8") + the per-page HBM cost
        # (all layers, K+V, codes+scales for int8) — the fourth A/B
        # label in engine_info, and the byte unit behind the
        # pool/host-tier byte gauges (quantized serving economics:
        # residents per HBM byte)
        self.kv_dtype: Optional[str] = None
        self.pool_bytes_per_page = 0
        # tensor-parallel serving (serving/tp.py): the mesh's tag
        # ("dp1xmp2", None on one device) and degrees, engine_info
        # labels; and the per-shard page cost (each of the mp shards
        # holds a 1/mp kv-head slice of every page)
        self.mesh: Optional[str] = None
        self.mp = 1
        self.dp = 1
        self.pool_shard_bytes_per_page = 0
        # whether the engine runs the unified ragged prefill+decode
        # step (True) or the legacy alternating program families
        # (False); set by the engine at construction — the second A/B
        # tag next to attn_impl so scrapes can tell the paths apart
        self.unified: Optional[bool] = None
        # unified-step counters: steps run, and the packed token split
        self.unified_steps = 0
        self.packed_prefill_tokens = 0
        self.packed_decode_tokens = 0
        self.packed_draft_tokens = 0
        # speculative decoding: the drafter mode tag (None = off), every
        # draft packed into a verify row, and the subset the model
        # confirmed and the engine committed (acceptance = accepted /
        # drafted)
        self.spec: Optional[str] = None
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        # the draft-model tier: whether a draft model is resident (the
        # `spec_draft_model` tag) and its page pool's gauges
        self.spec_draft_model = False
        self.draft_pool_pages_used = 0
        self.draft_pool_pages_total = 0
        # prefix-sharing grouped walk (the fifth A/B tag): whether the
        # engine runs it, the modeled page-block reads the step's walk
        # issues (CPU-reference count, one (layer, kv-head) sweep per
        # step), and how many reads grouping saved vs the flat walk
        # (flat - grouped; 0 with grouping off)
        self.grouped: Optional[bool] = None
        self.page_block_reads = 0
        self.shared_page_reads_saved = 0
        # the decode megakernel gate (the A/B tag)
        self.megakernel: Optional[bool] = None
        # grammar-constrained decoding: the gate's tag (None until an
        # engine sets it), constrained requests submitted, steps and rows
        # that carried a grammar bias, and drafts the host walk found the
        # grammar forbids
        self.grammar: Optional[bool] = None
        self.grammar_requests = 0
        self.grammar_masked_steps = 0
        self.grammar_masked_rows = 0
        self.grammar_rejected_drafts = 0
        # the KV fabric: pages and wire bytes of frames exported (sent)
        # and grafted (recv), and pages a warm restart restored
        self.fabric_pages_sent = 0
        self.fabric_bytes_sent = 0
        self.fabric_pages_recv = 0
        self.fabric_bytes_recv = 0
        self.fabric_restored_pages = 0
        # off-path counter: engine steps where prefill chunk programs
        # ran ahead of the decode step, stalling every resident decoder
        # (the TTFT spike the unified step exists to kill; stays 0 with
        # unified on)
        self.prefill_stall_steps = 0
        # histograms (TTFT/inter-token carry fixed Prometheus buckets)
        self.ttft_s = Histogram(buckets=TTFT_BUCKETS)
        self.inter_token_s = Histogram(buckets=LATENCY_BUCKETS)
        # synchronised wall time of one decode program (a legacy
        # decode step or a unified step) — the number the attn_impl A/B
        # compares
        self.decode_step_s = Histogram(buckets=LATENCY_BUCKETS)
        # wall time of one preempted request's RESUME swap-in (all its
        # restored pages, host->device) — the latency a preemption
        # adds at re-admission, the overload bench's p99
        self.swap_in_s = Histogram(buckets=LATENCY_BUCKETS)
        # tokens packed into one unified step (prefill + decode +
        # draft together — the "how full is the budget" histogram)
        self.packed_tokens_hist = Histogram(
            buckets=PACKED_TOKEN_BUCKETS)
        # tokens one decode row emitted in one step with speculation on
        # (1 + its accepted drafts)
        self.spec_tokens_per_step = Histogram(buckets=SPEC_TOKEN_BUCKETS)
        # members per sharing group per unified step (only groups that
        # actually deduplicated >= 1 shared page read)
        self.group_size_hist = Histogram(buckets=GROUP_SIZE_BUCKETS)
        self.queue_wait_s = Histogram()
        self.e2e_s = Histogram()
        # the port's own: host wall time of one unified step (ending in a
        # device synchronisation), and host time to issue one legacy
        # prefill chunk
        self.step_s = Histogram()
        self.prefill_chunk_s = Histogram()
        # per-priority-class latency histograms (label = str(priority),
        # capped at PRIORITY_CLASSES_MAX distinct classes, overflow ->
        # "other"): TTFT / inter-token / e2e per class, rendered as
        # labelled Prometheus series next to the aggregates — the
        # overload scheduler's promise ("high priority stays fast
        # under load") as a per-class percentile, not a guess
        self._by_priority: dict = {}
        # multi-tenant adapter serving (`adapters.py`): whether
        # the engine runs the subsystem (the `adapters` engine_info
        # tag), the adapter-pool occupancy/traffic mirror the engine
        # pushes each step (source of truth: AdapterStore.stats()),
        # and per-adapter request counters capped at ADAPTER_IDS_MAX
        # distinct ids + "other"
        self.adapters_enabled: Optional[bool] = None
        self.adapter_stats: Optional[dict] = None
        self._by_adapter: dict = {}
        # per-tenant latency/goodput labels: TTFT / inter-token / e2e
        # histograms plus deadline-goodput counters per adapter id,
        # recorded only on adapters-enabled engines, sharing ONE
        # capped label space with the request counters above
        self._by_adapter_lat: dict = {}
        self._adapter_labels: set = set()
        # the per-step achieved utilization: packed tokens over the
        # step's capacity, num_slots * chunk_len (set by the engine)
        self.step_capacity_tokens = 0
        self.achieved_util_hist = Histogram(buckets=UTIL_BUCKETS)
        # sliding window of the last N steps' achieved utilization:
        # the control plane's capacity signal (the lifetime histogram
        # mean is too sluggish to steer scaling through load phases)
        self._util_recent: deque = deque(maxlen=32)
        self.queue_depth_hist = Histogram()
        self.occupancy_hist = Histogram()
        self.pool_utilization_hist = Histogram()
        self.prefill_stall_hist = Histogram()
        # per-admission prefix-cache hit size (tokens served from
        # shared pages; 0 on a cold miss)
        self.prefix_cached_tokens_hist = Histogram()
        # the SLO tracker riding the latency and goodput hooks (set by
        # the engine; None with the gate off) and the cost census record
        # the engine pushes once captured
        self.slo = None
        self.cost_census: Optional[dict] = None
        # busy window for throughput
        self._first_admit_t: Optional[float] = None
        self._last_token_t: Optional[float] = None

    @staticmethod
    def _priority_of(req) -> int:
        """Priority class of a request-shaped object (duck-typed
        fakes without sampling params land in class 0)."""
        sampling = getattr(req, "sampling", None)
        return 0 if sampling is None else sampling.priority

    @staticmethod
    def _adapter_of(req) -> int:
        sampling = getattr(req, "sampling", None)
        return int(getattr(sampling, "adapter_id", 0) or 0)

    def _adapter_label(self, adapter_id) -> str:
        """ONE capped label space shared by every per-adapter series
        (request counters AND latency/goodput): the first
        ADAPTER_IDS_MAX distinct ids keep their own label, the rest
        fold into "other" (callers hold self._lock)."""
        lbl = str(int(adapter_id))
        if lbl in self._adapter_labels:
            return lbl
        if len(self._adapter_labels) >= ADAPTER_IDS_MAX:
            return "other"
        self._adapter_labels.add(lbl)
        return lbl

    def _adapter_class(self, adapter_id) -> dict:
        """The per-tenant histogram trio + goodput counters for
        `adapter_id`, created on first sight (callers hold
        self._lock; only called on adapters-enabled engines)."""
        lbl = self._adapter_label(adapter_id)
        cls = self._by_adapter_lat.get(lbl)
        if cls is None:
            cls = self._by_adapter_lat[lbl] = {
                "ttft_s": Histogram(buckets=TTFT_BUCKETS),
                "inter_token_s": Histogram(buckets=LATENCY_BUCKETS),
                "e2e_s": Histogram(buckets=TTFT_BUCKETS),
                "goodput": {"met": 0, "missed": 0}}
        return cls

    def _priority_class(self, priority) -> dict:
        """The per-class histogram trio for `priority`, creating it on
        first sight (callers hold self._lock)."""
        lbl = str(int(priority))
        cls = self._by_priority.get(lbl)
        if cls is None and len(self._by_priority) >= \
                PRIORITY_CLASSES_MAX:
            lbl = "other"
            cls = self._by_priority.get(lbl)
        if cls is None:
            cls = self._by_priority[lbl] = {
                "ttft_s": Histogram(buckets=TTFT_BUCKETS),
                "inter_token_s": Histogram(buckets=LATENCY_BUCKETS),
                "e2e_s": Histogram(buckets=TTFT_BUCKETS)}
        return cls

    # -- recording hooks (called by the engine) ---------------------------
    def on_submit(self, req):
        with self._lock:
            self.requests_received += 1

    def on_adapter_request(self, adapter_id: int):
        """One request submitted under `adapter_id` (0 = base model).
        Label cardinality capped: the first ADAPTER_IDS_MAX distinct
        ids keep their own counter, the rest fold into "other"."""
        with self._lock:
            lbl = self._adapter_label(adapter_id)
            self._by_adapter[lbl] = self._by_adapter.get(lbl, 0) + 1

    def on_grammar_request(self):
        """One request submitted with a grammar constraint."""
        with self._lock:
            self.grammar_requests += 1

    def on_grammar_step(self, rows: int, rejected: int = 0):
        """One unified step biased `rows` decode rows with their grammar;
        the host walk found `rejected` drafts the grammar forbids."""
        with self._lock:
            if rows > 0:
                self.grammar_masked_steps += 1
            self.grammar_masked_rows += int(rows)
            self.grammar_rejected_drafts += int(rejected)

    def on_fabric(self, sent_pages: int = 0, sent_bytes: int = 0,
                  recv_pages: int = 0, recv_bytes: int = 0,
                  restored_pages: int = 0):
        """KV fabric traffic: a frame left (sent) or was grafted into
        (recv) this engine's tree, or a warm restart restored
        `restored_pages` from a predecessor's snapshot."""
        with self._lock:
            self.fabric_pages_sent += int(sent_pages)
            self.fabric_bytes_sent += int(sent_bytes)
            self.fabric_pages_recv += int(recv_pages)
            self.fabric_bytes_recv += int(recv_bytes)
            self.fabric_restored_pages += int(restored_pages)

    def on_admit(self, req, now: float):
        with self._lock:
            self.requests_admitted += 1
            self.prefills += 1
            self.prompt_tokens += int(req.prompt_ids.size)
            self.prefix_cached_tokens_hist.record(
                getattr(req, "cached_tokens", 0))
            self.queue_wait_s.record(now - req.arrival_t)
            if self._first_admit_t is None:
                self._first_admit_t = now

    def on_token(self, req, now: float):
        with self._lock:
            self.tokens_generated += 1
            self._last_token_t = now
            if len(req.output_tokens) == 1:
                ttft = now - req.arrival_t
                pr, aid = self._priority_of(req), self._adapter_of(req)
                self.ttft_s.record(ttft)
                self._priority_class(pr)["ttft_s"].record(ttft)
                if self.adapters_enabled:
                    self._adapter_class(aid)["ttft_s"].record(ttft)
                if self.slo is not None:
                    self.slo.on_ttft(ttft, priority=pr,
                                     adapter_id=aid, t=now)

    def on_inter_token(self, dt: float, priority: int = 0,
                       adapter_id: int = 0,
                       now: Optional[float] = None):
        with self._lock:
            self.inter_token_s.record(dt)
            self._priority_class(priority)["inter_token_s"].record(dt)
            if self.adapters_enabled:
                self._adapter_class(adapter_id)[
                    "inter_token_s"].record(dt)
            if self.slo is not None:
                self.slo.on_inter_token(dt, priority=priority,
                                        adapter_id=adapter_id, t=now)

    def on_finish(self, req, now: float):
        with self._lock:
            sampling = getattr(req, "sampling", None)
            pr, aid = self._priority_of(req), self._adapter_of(req)
            if sampling is not None \
                    and sampling.deadline_s is not None:
                # deadline-goodput event: of the requests that CARRIED
                # a deadline, a normal finish met it, a queued 504
                # ("deadline") missed it; other terminal causes
                # (cancel, replica death) judge neither way
                if req.finish_reason in ("stop", "length"):
                    met = True
                elif req.finish_reason == "deadline":
                    met = False
                else:
                    met = None
                if met is not None:
                    if self.adapters_enabled:
                        self._adapter_class(aid)["goodput"][
                            "met" if met else "missed"] += 1
                    if self.slo is not None:
                        self.slo.on_goodput(met, priority=pr,
                                            adapter_id=aid, t=now)
            if sampling is not None \
                    and sampling.deadline_s is not None \
                    and req.finish_reason in ("stop", "length"):
                self.deadline_met += 1
            if req.finish_reason == "cancelled":
                self.requests_cancelled += 1
            elif req.finish_reason == "timeout":
                self.requests_timeout += 1
            elif req.finish_reason == "deadline":
                self.requests_deadline += 1
            elif req.finish_reason in ("stop", "length"):
                self.requests_completed += 1
            elif req.finish_reason == "poisoned":
                self.requests_poisoned += 1
            else:                 # "aborted", "replica_failure", ...
                self.requests_aborted += 1
            e2e = now - req.arrival_t
            self.e2e_s.record(e2e)
            self._priority_class(pr)["e2e_s"].record(e2e)
            if self.adapters_enabled:
                self._adapter_class(aid)["e2e_s"].record(e2e)

    def on_decode_step(self, wall_s: float):
        with self._lock:
            self.decode_step_s.record(wall_s)

    def on_preempt(self, pages_out: int):
        """One resident was preempted: `pages_out` of its KV pages
        swapped out to the host tier (0 = pure recompute fallback)."""
        with self._lock:
            self.preemptions += 1
            self.swapped_out_pages += int(pages_out)

    def on_swap_in(self, pages_in: int, wall_s: float):
        """Host->device restore: a resumed request's pages (or one
        prefix-cache spill restore) swapped back in."""
        with self._lock:
            self.swapped_in_pages += int(pages_in)
            if pages_in and wall_s > 0:
                self.swap_in_s.record(wall_s)

    def on_unified_step(self, prefill_tokens: int, decode_tokens: int,
                        wall_s: float, draft_tokens: int = 0):
        """One unified ragged step ran, packing `prefill_tokens` prompt
        tokens and `draft_tokens` speculative drafts next to
        `decode_tokens` sampled tokens. The wall time lands in the same
        decode_step_s histogram the alternating path records, so the
        on/off A/B compares like for like."""
        with self._lock:
            self.unified_steps += 1
            self.packed_prefill_tokens += int(prefill_tokens)
            self.packed_decode_tokens += int(decode_tokens)
            self.packed_draft_tokens += int(draft_tokens)
            packed = (int(prefill_tokens) + int(decode_tokens)
                      + int(draft_tokens))
            self.packed_tokens_hist.record(packed)
            if self.step_capacity_tokens:
                util = packed / self.step_capacity_tokens
                self.achieved_util_hist.record(util)
                self._util_recent.append(util)
            self.decode_step_s.record(wall_s)
            self.step_s.record(wall_s)

    def on_grouped_step(self, flat_reads: int, actual_reads: int,
                        group_sizes: Sequence[int]):
        """One unified step's modeled page-block DMA traffic: the flat
        (per-row) walk would issue `flat_reads`, the step actually
        issued `actual_reads` (== flat with grouping off), and
        `group_sizes` lists the member count of every group that
        shared at least one page read."""
        with self._lock:
            self.page_block_reads += int(actual_reads)
            self.shared_page_reads_saved += \
                int(flat_reads) - int(actual_reads)
            for n in group_sizes:
                self.group_size_hist.record(int(n))

    def on_spec(self, drafted: int, accepted: int,
                burst_sizes: Sequence[int]):
        """One unified step's speculative outcome: `drafted` draft
        tokens rode verify rows, `accepted` of them were confirmed and
        committed, and each decode row emitted `burst_sizes[i]` tokens
        (1 + its accepted drafts, cut by EOS or the budget)."""
        with self._lock:
            self.spec_drafted_tokens += int(drafted)
            self.spec_accepted_tokens += int(accepted)
            for n in burst_sizes:
                self.spec_tokens_per_step.record(int(n))

    def on_prefill_chunk(self, n_tokens: int,
                         wall_s: Optional[float] = None):
        """A prefill chunk of `n_tokens` prompt tokens ran: a legacy
        batch-1 chunk, issued in `wall_s` seconds (host clock, no device
        synchronisation), or one row's grant of a unified step (no
        wall time of its own)."""
        with self._lock:
            self.prefill_chunks += 1
            self.prefill_chunk_tokens += int(n_tokens)
            if wall_s is not None:
                self.prefill_chunk_s.record(wall_s)

    def on_step(self, queue_depth: int, occupancy: float, num_slots: int,
                pages_used: int = 0, pages_total: int = 0,
                stall_chunks: int = 0, pages_cached: int = 0,
                pages_swapped: int = 0, host_pages_used: int = 0,
                host_pages_total: int = 0,
                draft_pages_used: int = 0,
                draft_pages_total: int = 0,
                prefix_stats: Optional[dict] = None,
                adapter_stats: Optional[dict] = None):
        with self._lock:
            if adapter_stats is not None:
                self.adapter_stats = dict(adapter_stats)
            self.decode_steps += 1
            self.queue_depth = queue_depth
            self.slot_occupancy = occupancy
            self.num_slots = num_slots
            self.queue_depth_hist.record(queue_depth)
            self.occupancy_hist.record(occupancy)
            self.pool_pages_used = pages_used
            self.pool_pages_total = pages_total
            self.pool_pages_cached = pages_cached
            self.pool_pages_swapped = pages_swapped
            self.host_pages_used = host_pages_used
            self.host_pages_total = host_pages_total
            self.draft_pool_pages_used = draft_pages_used
            if draft_pages_total:
                self.draft_pool_pages_total = draft_pages_total
            if prefix_stats is not None:
                self.prefix = dict(prefix_stats)
            self.prefill_stall = stall_chunks
            if stall_chunks:
                self.prefill_stall_steps += 1
            if pages_total:
                self.pool_utilization_hist.record(pages_used / pages_total)
            self.prefill_stall_hist.record(stall_chunks)

    # -- reading ----------------------------------------------------------
    @property
    def achieved_util_recent(self) -> Optional[float]:
        """Mean achieved utilization over the last few steps (None
        before the first capacity-bearing step) — the control plane's
        fresh load signal, windowed so a diurnal trough is seen as a
        trough instead of being averaged away by the busy lifetime."""
        with self._lock:
            if not self._util_recent:
                return None
            return sum(self._util_recent) / len(self._util_recent)

    @property
    def tokens_per_sec(self) -> Optional[float]:
        if (self._first_admit_t is None or self._last_token_t is None
                or self._last_token_t <= self._first_admit_t):
            return None
        return self.tokens_generated / (self._last_token_t
                                        - self._first_admit_t)

    def snapshot(self) -> dict:
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        return {
            **_unported_off(),
            "requests": {
                "received": self.requests_received,
                "admitted": self.requests_admitted,
                "completed": self.requests_completed,
                "cancelled": self.requests_cancelled,
                "timeout": self.requests_timeout,
                "deadline": self.requests_deadline,
                "aborted": self.requests_aborted,
                "poisoned": self.requests_poisoned,
            },
            "preemptions": self.preemptions,
            "swapped_out_pages": self.swapped_out_pages,
            "swapped_in_pages": self.swapped_in_pages,
            "swap_in_s": self.swap_in_s.snapshot(),
            "tokens_generated": self.tokens_generated,
            "prompt_tokens": self.prompt_tokens,
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "decode_steps": self.decode_steps,
            "attn_impl": self.attn_impl,
            "kv_dtype": self.kv_dtype,
            "mesh": self.mesh,
            "mp": self.mp,
            "dp": self.dp,
            "unified": self.unified,
            "unified_steps": self.unified_steps,
            "packed_prefill_tokens": self.packed_prefill_tokens,
            "packed_decode_tokens": self.packed_decode_tokens,
            "packed_draft_tokens": self.packed_draft_tokens,
            "packed_tokens_per_step": self.packed_tokens_hist.snapshot(),
            "spec": self.spec,
            "spec_drafted_tokens": self.spec_drafted_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_tokens_per_step": self.spec_tokens_per_step.snapshot(),
            "grammar": self.grammar,
            "grammar_requests": self.grammar_requests,
            "grammar_masked_steps": self.grammar_masked_steps,
            "grammar_masked_rows": self.grammar_masked_rows,
            "grammar_rejected_drafts": self.grammar_rejected_drafts,
            "fabric": {
                "pages_sent": self.fabric_pages_sent,
                "bytes_sent": self.fabric_bytes_sent,
                "pages_recv": self.fabric_pages_recv,
                "bytes_recv": self.fabric_bytes_recv,
                "restored_pages": self.fabric_restored_pages,
            },
            "grouped": self.grouped,
            "page_block_reads_total": self.page_block_reads,
            "shared_page_reads_saved_total":
                self.shared_page_reads_saved,
            "megakernel": self.megakernel,
            "group_size_per_step": self.group_size_hist.snapshot(),
            "prefill_stall_steps": self.prefill_stall_steps,
            "decode_step_s": self.decode_step_s.snapshot(),
            "tokens_per_sec": self.tokens_per_sec,
            "queue_depth": self.queue_depth,
            "slot_occupancy": self.slot_occupancy,
            "num_slots": self.num_slots,
            "pool": {
                "pages_used": self.pool_pages_used,
                "pages_total": self.pool_pages_total,
                "pages_cached": self.pool_pages_cached,
                "pages_swapped": self.pool_pages_swapped,
                "bytes_per_page": self.pool_bytes_per_page,
                "shard_bytes_per_page": self.pool_shard_bytes_per_page,
                "utilization": self.pool_utilization_hist.snapshot(),
            },
            "host_pool": {
                "pages_used": self.host_pages_used,
                "pages_total": self.host_pages_total,
                "bytes_used": (self.host_pages_used
                               * self.pool_bytes_per_page),
                "bytes_total": (self.host_pages_total
                                * self.pool_bytes_per_page),
            },
            "spec_draft_model": self.spec_draft_model,
            "draft_pool": (None if not self.spec_draft_model else {
                "pages_used": self.draft_pool_pages_used,
                "pages_total": self.draft_pool_pages_total,
            }),
            "prefix": (None if self.prefix is None else {
                **self.prefix,
                "cached_tokens_per_request":
                    self.prefix_cached_tokens_hist.snapshot(),
            }),
            "prefill_stall": self.prefill_stall,
            "prefill_stall_hist": self.prefill_stall_hist.snapshot(),
            "ttft_s": self.ttft_s.snapshot(),
            "inter_token_s": self.inter_token_s.snapshot(),
            "queue_wait_s": self.queue_wait_s.snapshot(),
            "e2e_s": self.e2e_s.snapshot(),
            "step_s": self.step_s.snapshot(),
            "prefill_chunk_s": self.prefill_chunk_s.snapshot(),
            "queue_depth_hist": self.queue_depth_hist.snapshot(),
            "occupancy_hist": self.occupancy_hist.snapshot(),
            "adapters_enabled": self.adapters_enabled,
            "adapters": (None if self.adapter_stats is None else {
                **self.adapter_stats,
                "requests_by_adapter": dict(
                    sorted(self._by_adapter.items())),
            }),
            "deadline_goodput": {"met": self.deadline_met,
                                 "missed": self.requests_deadline},
            "by_priority": {
                lbl: {name: h.snapshot() for name, h in cls.items()}
                for lbl, cls in sorted(self._by_priority.items())},
            "by_adapter": {
                lbl: {"ttft_s": cls["ttft_s"].snapshot(),
                      "inter_token_s":
                          cls["inter_token_s"].snapshot(),
                      "e2e_s": cls["e2e_s"].snapshot(),
                      "deadline_goodput": dict(cls["goodput"])}
                for lbl, cls in sorted(self._by_adapter_lat.items())},
            "achieved_util": self.achieved_util_hist.snapshot(),
            "cost_census": (None if self.cost_census is None
                            else dict(self.cost_census)),
            "slo": (None if self.slo is None
                    else self.slo.snapshot()),
        }


# -- Prometheus text exposition -------------------------------------------
def _esc_label(v) -> str:
    """Escape a label VALUE per the exposition format: backslash,
    double-quote and newline must be escaped or the line is invalid
    (replica names are caller-supplied strings)."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _hist_lines(name: str, snap: dict, labels: dict, lines: list):
    for le, n in snap.get("buckets", []):
        le_s = le if isinstance(le, str) else repr(float(le))
        lines.append(f"{name}_bucket"
                     + _fmt_labels({**labels, "le": le_s}) + f" {n}")
    lines.append(f"{name}_sum" + _fmt_labels(labels)
                 + f" {snap.get('sum', 0.0)}")
    lines.append(f"{name}_count" + _fmt_labels(labels)
                 + f" {snap['count']}")


BREAKER_STATE_CODES = {"closed": 0, "half_open": 1, "open": 2}


def prometheus_render(snapshots: dict, namespace: str = "paddle_serving",
                      extra_gauges: Optional[dict] = None,
                      router: Optional[dict] = None) -> str:
    """Render `{replica_label: ServingMetrics.snapshot()}` as Prometheus
    text exposition (one labelled series set per replica), line for line
    as the JAX package's function renders it (its HTTP server's
    `/metrics` endpoint); `extra_gauges` adds unlabelled router-level
    gauges (`{name: value}`). `router` (a router's stats dict) adds the
    resilience series: `retries_total` / `migrations_total` /
    `watchdog_kills_total` / `fleet_dead_evicted_total` counters and a
    per-replica `breaker_state` gauge (value 0 closed / 1 half_open /
    2 open, with the state name also riding as a label). A
    `controlplane` block inside it (an attached fleet controller) adds
    the `fleet_desired_replicas` gauge
    and the scale/shed/placement-avoidance counters."""
    lines = []
    for name, kind in [("requests_total", "counter"),
                       ("tokens_generated_total", "counter"),
                       ("queue_depth", "gauge"),
                       ("slot_occupancy", "gauge"),
                       ("pool_pages_free", "gauge"),
                       ("pool_pages_total", "gauge"),
                       ("pool_pages_cached", "gauge"),
                       ("prefix_lookups_total", "counter"),
                       ("prefix_hits_total", "counter"),
                       ("prefix_cached_tokens_total", "counter"),
                       ("prefix_evicted_pages_total", "counter"),
                       ("prefix_cow_copies_total", "counter"),
                       ("prefix_resident_pages", "gauge"),
                       ("prefix_tree_pages", "gauge"),
                       ("prefix_spilled_nodes", "gauge"),
                       ("prefix_hit_rate", "gauge"),
                       ("fabric_pages_sent_total", "counter"),
                       ("fabric_bytes_sent_total", "counter"),
                       ("fabric_pages_recv_total", "counter"),
                       ("fabric_bytes_recv_total", "counter"),
                       ("fabric_restored_pages_total", "counter"),
                       ("engine_info", "gauge"),
                       ("poisoned_total", "counter"),
                       ("preemptions_total", "counter"),
                       ("deadline_expired_total", "counter"),
                       ("swapped_out_pages_total", "counter"),
                       ("swapped_in_pages_total", "counter"),
                       ("pool_pages_swapped", "gauge"),
                       ("pool_bytes_per_page", "gauge"),
                       ("pool_shard_bytes_per_page", "gauge"),
                       ("host_pages_used", "gauge"),
                       ("host_pages_total", "gauge"),
                       ("host_bytes_used", "gauge"),
                       ("host_bytes_total", "gauge"),
                       ("swap_in_seconds", "histogram"),
                       ("unified_steps_total", "counter"),
                       ("prefill_stall_steps_total", "counter"),
                       ("spec_drafted_total", "counter"),
                       ("spec_accepted_total", "counter"),
                       ("spec_tokens_per_step", "histogram"),
                       ("draft_pool_pages_used", "gauge"),
                       ("draft_pool_pages_total", "gauge"),
                       ("grammar_constrained_requests_total",
                        "counter"),
                       ("grammar_masked_steps_total", "counter"),
                       ("grammar_rejected_drafts_total", "counter"),
                       ("prefix_pinned_pages", "gauge"),
                       ("page_block_reads_total", "counter"),
                       ("unified_dispatch_ops", "gauge"),
                       ("shared_page_reads_saved_total", "counter"),
                       ("group_size_per_step", "histogram"),
                       ("packed_tokens_per_step", "histogram"),
                       ("ttft_seconds", "histogram"),
                       ("inter_token_seconds", "histogram"),
                       ("e2e_seconds", "histogram"),
                       ("deadline_goodput_total", "counter"),
                       ("adapter_pool_pages_used", "gauge"),
                       ("adapter_pool_pages_cached", "gauge"),
                       ("adapter_pool_pages_swapped", "gauge"),
                       ("adapter_pool_pages_total", "gauge"),
                       ("adapter_loads_total", "counter"),
                       ("adapter_evictions_total", "counter"),
                       ("adapter_spills_total", "counter"),
                       ("adapter_restores_total", "counter"),
                       ("adapter_requests_total", "counter"),
                       ("achieved_util", "histogram"),
                       ("cost_census_flops", "gauge"),
                       ("cost_census_bytes", "gauge"),
                       ("cost_census_capacity_tokens", "gauge"),
                       ("slo_state", "gauge"),
                       ("slo_burn_rate", "gauge")]:
        lines.append(f"# TYPE {namespace}_{name} {kind}")
    for replica, snap in sorted(snapshots.items()):
        lab = {"replica": str(replica)}
        # info-style gauge: the A/B tags (which attention impl, unified
        # vs alternating step, spec mode, paged-pool dtype) ride as
        # labels so scrapes from an A/B fleet are distinguishable
        # without relabeling
        lines.append(
            f"{namespace}_engine_info" + _fmt_labels({
                **lab, "attn_impl": snap.get("attn_impl") or "unknown",
                "unified": ("on" if snap.get("unified") else "off"),
                "spec": snap.get("spec") or "off",
                "spec_draft_model": ("on"
                                     if snap.get("spec_draft_model")
                                     else "off"),
                "kv_dtype": snap.get("kv_dtype") or "fp",
                "grouped": ("on" if snap.get("grouped") else "off"),
                "mesh": snap.get("mesh") or "off",
                "mp": snap.get("mp", 1) or 1,
                "dp": snap.get("dp", 1) or 1,
                "adapters": ("on" if snap.get("adapters_enabled")
                             else "off"),
                "grammar": ("on" if snap.get("grammar") else "off"),
                "megakernel": ("on" if snap.get("megakernel")
                               else "off")})
            + " 1")
        ad = snap.get("adapters")
        if ad is not None:
            for metric, key in [
                    ("adapter_pool_pages_used", "pages_used"),
                    ("adapter_pool_pages_cached", "pages_cached"),
                    ("adapter_pool_pages_swapped", "pages_swapped"),
                    ("adapter_pool_pages_total", "pages_total"),
                    ("adapter_loads_total", "loads_total"),
                    ("adapter_evictions_total", "evictions_total"),
                    ("adapter_spills_total", "spills_total"),
                    ("adapter_restores_total", "restores_total")]:
                lines.append(f"{namespace}_{metric}"
                             + _fmt_labels(lab)
                             + f" {ad.get(key, 0)}")
            for aid, n in sorted(
                    (ad.get("requests_by_adapter") or {}).items()):
                lines.append(
                    f"{namespace}_adapter_requests_total"
                    + _fmt_labels({**lab, "adapter": aid})
                    + f" {n}")
        lines.append(f"{namespace}_page_block_reads_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('page_block_reads_total', 0)}")
        lines.append(
            f"{namespace}_shared_page_reads_saved_total"
            + _fmt_labels(lab)
            + f" {snap.get('shared_page_reads_saved_total', 0)}")
        if snap.get("group_size_per_step") is not None:
            _hist_lines(f"{namespace}_group_size_per_step",
                        snap["group_size_per_step"], lab, lines)
        if snap.get("unified_dispatch_ops") is not None:
            lines.append(f"{namespace}_unified_dispatch_ops"
                         + _fmt_labels(lab)
                         + f" {snap.get('unified_dispatch_ops')}")
        lines.append(f"{namespace}_unified_steps_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('unified_steps', 0)}")
        lines.append(f"{namespace}_prefill_stall_steps_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('prefill_stall_steps', 0)}")
        lines.append(f"{namespace}_spec_drafted_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('spec_drafted_tokens', 0)}")
        lines.append(f"{namespace}_spec_accepted_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('spec_accepted_tokens', 0)}")
        if snap.get("spec_tokens_per_step") is not None:
            _hist_lines(f"{namespace}_spec_tokens_per_step",
                        snap["spec_tokens_per_step"], lab, lines)
        dpool = snap.get("draft_pool")
        if dpool is not None:
            lines.append(f"{namespace}_draft_pool_pages_used"
                         + _fmt_labels(lab)
                         + f" {dpool.get('pages_used', 0)}")
            lines.append(f"{namespace}_draft_pool_pages_total"
                         + _fmt_labels(lab)
                         + f" {dpool.get('pages_total', 0)}")
        lines.append(f"{namespace}_grammar_constrained_requests_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('grammar_requests', 0)}")
        lines.append(f"{namespace}_grammar_masked_steps_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('grammar_masked_steps', 0)}")
        lines.append(f"{namespace}_grammar_rejected_drafts_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('grammar_rejected_drafts', 0)}")
        if snap.get("packed_tokens_per_step") is not None:
            _hist_lines(f"{namespace}_packed_tokens_per_step",
                        snap["packed_tokens_per_step"], lab, lines)
        for outcome in ("completed", "cancelled", "timeout", "deadline",
                        "aborted", "poisoned"):
            lines.append(
                f"{namespace}_requests_total"
                + _fmt_labels({**lab, "outcome": outcome})
                + f" {snap['requests'].get(outcome, 0)}")
        lines.append(f"{namespace}_poisoned_total" + _fmt_labels(lab)
                     + f" {snap['requests'].get('poisoned', 0)}")
        lines.append(f"{namespace}_deadline_expired_total"
                     + _fmt_labels(lab)
                     + f" {snap['requests'].get('deadline', 0)}")
        lines.append(f"{namespace}_preemptions_total" + _fmt_labels(lab)
                     + f" {snap.get('preemptions', 0)}")
        lines.append(f"{namespace}_swapped_out_pages_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('swapped_out_pages', 0)}")
        lines.append(f"{namespace}_swapped_in_pages_total"
                     + _fmt_labels(lab)
                     + f" {snap.get('swapped_in_pages', 0)}")
        if snap.get("swap_in_s") is not None:
            _hist_lines(f"{namespace}_swap_in_seconds",
                        snap["swap_in_s"], lab, lines)
        lines.append(f"{namespace}_tokens_generated_total"
                     + _fmt_labels(lab) + f" {snap['tokens_generated']}")
        lines.append(f"{namespace}_queue_depth" + _fmt_labels(lab)
                     + f" {snap['queue_depth']}")
        lines.append(f"{namespace}_slot_occupancy" + _fmt_labels(lab)
                     + f" {snap['slot_occupancy']}")
        pool = snap["pool"]
        free = (pool["pages_total"] - pool["pages_used"]
                - pool.get("pages_cached", 0))
        lines.append(f"{namespace}_pool_pages_free" + _fmt_labels(lab)
                     + f" {free}")
        lines.append(f"{namespace}_pool_pages_total" + _fmt_labels(lab)
                     + f" {pool['pages_total']}")
        lines.append(f"{namespace}_pool_pages_cached" + _fmt_labels(lab)
                     + f" {pool.get('pages_cached', 0)}")
        lines.append(f"{namespace}_pool_pages_swapped"
                     + _fmt_labels(lab)
                     + f" {pool.get('pages_swapped', 0)}")
        lines.append(f"{namespace}_pool_bytes_per_page"
                     + _fmt_labels(lab)
                     + f" {pool.get('bytes_per_page', 0)}")
        lines.append(f"{namespace}_pool_shard_bytes_per_page"
                     + _fmt_labels(lab)
                     + f" {pool.get('shard_bytes_per_page', 0)}")
        host = snap.get("host_pool") or {}
        lines.append(f"{namespace}_host_pages_used" + _fmt_labels(lab)
                     + f" {host.get('pages_used', 0)}")
        lines.append(f"{namespace}_host_pages_total" + _fmt_labels(lab)
                     + f" {host.get('pages_total', 0)}")
        lines.append(f"{namespace}_host_bytes_used" + _fmt_labels(lab)
                     + f" {host.get('bytes_used', 0)}")
        lines.append(f"{namespace}_host_bytes_total" + _fmt_labels(lab)
                     + f" {host.get('bytes_total', 0)}")
        prefix = snap.get("prefix")
        if prefix is not None:
            for metric, key in [("prefix_lookups_total", "lookups"),
                                ("prefix_hits_total", "hits"),
                                ("prefix_cached_tokens_total",
                                 "cached_tokens"),
                                ("prefix_evicted_pages_total",
                                 "evicted_pages"),
                                ("prefix_cow_copies_total",
                                 "cow_copies"),
                                ("prefix_resident_pages",
                                 "resident_pages"),
                                ("prefix_tree_pages", "tree_pages"),
                                ("prefix_spilled_nodes",
                                 "spilled_nodes"),
                                ("prefix_pinned_pages",
                                 "pinned_pages")]:
                lines.append(f"{namespace}_{metric}" + _fmt_labels(lab)
                             + f" {prefix.get(key, 0)}")
            lines.append(f"{namespace}_prefix_hit_rate"
                         + _fmt_labels(lab)
                         + f" {prefix['hit_rate'] or 0.0}")
        fabric = snap.get("fabric")
        if fabric is not None:
            for metric, key in [
                    ("fabric_pages_sent_total", "pages_sent"),
                    ("fabric_bytes_sent_total", "bytes_sent"),
                    ("fabric_pages_recv_total", "pages_recv"),
                    ("fabric_bytes_recv_total", "bytes_recv"),
                    ("fabric_restored_pages_total",
                     "restored_pages")]:
                lines.append(f"{namespace}_{metric}" + _fmt_labels(lab)
                             + f" {fabric.get(key, 0)}")
        _hist_lines(f"{namespace}_ttft_seconds", snap["ttft_s"], lab,
                    lines)
        _hist_lines(f"{namespace}_inter_token_seconds",
                    snap["inter_token_s"], lab, lines)
        # per-priority-class latency series: same metric names, one
        # extra `priority` label per class (the unlabelled aggregates
        # above stay for dashboards that predate priorities)
        for lbl, cls in sorted((snap.get("by_priority") or {}).items()):
            plab = {**lab, "priority": lbl}
            _hist_lines(f"{namespace}_ttft_seconds", cls["ttft_s"],
                        plab, lines)
            _hist_lines(f"{namespace}_inter_token_seconds",
                        cls["inter_token_s"], plab, lines)
            _hist_lines(f"{namespace}_e2e_seconds", cls["e2e_s"],
                        plab, lines)
        # per-tenant latency/goodput series: same metric names, one
        # extra `adapter` label per tenant (adapters-enabled engines
        # only — the capped label space the request counters use)
        for lbl, cls in sorted((snap.get("by_adapter") or {}).items()):
            alab = {**lab, "adapter": lbl}
            _hist_lines(f"{namespace}_ttft_seconds", cls["ttft_s"],
                        alab, lines)
            _hist_lines(f"{namespace}_inter_token_seconds",
                        cls["inter_token_s"], alab, lines)
            _hist_lines(f"{namespace}_e2e_seconds", cls["e2e_s"],
                        alab, lines)
            for outcome in ("met", "missed"):
                lines.append(
                    f"{namespace}_deadline_goodput_total"
                    + _fmt_labels({**alab, "outcome": outcome})
                    + f" {cls['deadline_goodput'].get(outcome, 0)}")
        dg = snap.get("deadline_goodput")
        if dg is not None:
            for outcome in ("met", "missed"):
                lines.append(
                    f"{namespace}_deadline_goodput_total"
                    + _fmt_labels({**lab, "outcome": outcome})
                    + f" {dg.get(outcome, 0)}")
        # achieved utilization of the unified step (packed tokens /
        # program capacity — the cost census's live numerator)
        if snap.get("achieved_util") is not None:
            _hist_lines(f"{namespace}_achieved_util",
                        snap["achieved_util"], lab, lines)
        census = snap.get("cost_census")
        if census is not None:
            clab = {**lab, "source": census.get("source", "model")}
            lines.append(f"{namespace}_cost_census_flops"
                         + _fmt_labels(clab)
                         + f" {census.get('flops', 0.0)}")
            lines.append(f"{namespace}_cost_census_bytes"
                         + _fmt_labels(clab)
                         + f" {census.get('bytes_accessed', 0.0)}")
            lines.append(f"{namespace}_cost_census_capacity_tokens"
                         + _fmt_labels(lab)
                         + f" {census.get('capacity_tokens', 0)}")
        # SLO alert states + burn rates (a snapshot's "slo" dict): one gauge
        # per (slo, scope) series — value 0 ok / 1 warn / 2 page,
        # with the state name riding as a label like breaker_state
        slo = snap.get("slo")
        if slo is not None:
            for slo_name, per in sorted(
                    (slo.get("series") or {}).items()):
                for key, s in sorted(per.items()):
                    scope, _, label = key.partition(":")
                    slab = {**lab, "slo": slo_name, "scope": scope,
                            "label": label}
                    lines.append(
                        f"{namespace}_slo_state"
                        + _fmt_labels({**slab,
                                       "state": s["state"]})
                        + f" {SLO_STATE_CODES.get(s['state'], -1)}")
                    for window in ("fast", "slow"):
                        lines.append(
                            f"{namespace}_slo_burn_rate"
                            + _fmt_labels({**slab,
                                           "window": window})
                            + f" {s[f'{window}_burn']}")
    if router is not None:
        for name in ("retries_total", "migrations_total",
                     "watchdog_kills_total",
                     "fleet_dead_evicted_total"):
            lines.append(f"# TYPE {namespace}_{name} counter")
            lines.append(f"{namespace}_{name} {router.get(name, 0)}")
        # fleet control plane (the router's "controlplane" dict): the desired-
        # replica gauge + the actuator counters, present only when a
        # controller is attached (the gate is off by default)
        cp = router.get("controlplane")
        if cp is not None:
            for name in ("scale_up_total", "scale_down_total",
                         "admission_shed_total",
                         "placement_avoided_total"):
                lines.append(f"# TYPE {namespace}_{name} counter")
                lines.append(f"{namespace}_{name} {cp.get(name, 0)}")
            lines.append(
                f"# TYPE {namespace}_fleet_desired_replicas gauge")
            lines.append(
                f"{namespace}_fleet_desired_replicas "
                f"{cp.get('desired_replicas') or 0}")
        breakers = router.get("breakers") or {}
        if breakers:
            lines.append(f"# TYPE {namespace}_breaker_state gauge")
            for replica, state in sorted(breakers.items()):
                code = BREAKER_STATE_CODES.get(state, -1)
                lines.append(
                    f"{namespace}_breaker_state"
                    + _fmt_labels({"replica": str(replica),
                                   "state": str(state)})
                    + f" {code}")
    for name, value in sorted((extra_gauges or {}).items()):
        lines.append(f"# TYPE {namespace}_{name} gauge")
        lines.append(f"{namespace}_{name} {value}")
    return "\n".join(lines) + "\n"
