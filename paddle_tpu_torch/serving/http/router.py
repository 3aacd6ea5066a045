"""Multi-replica router: placement, failover, migration, health, drain
(counterpart of `paddle_tpu/serving/http/router.py`).

Fronts N `EngineDriver` replicas with:

- **Least-loaded, health-scored placement**: replicas are ranked by
  (breaker state, queue depth, inflight, -free pages) — a flapping
  replica (open/half-open breaker) yields to a clean one, the emptiest
  queue wins among equals, free KV pages break ties.
- **Typed load shedding**: when every healthy replica's admission queue
  is full, `submit` re-raises `QueueFull` (HTTP 429 + Retry-After);
  when none is healthy (or the router is draining), `EngineClosed`
  (HTTP 503).
- **Failover for EVERY request a replica death touches** — not just
  unstarted ones. A request that dies with reason "replica_failure"
  and zero emitted tokens is transparently resubmitted on a survivor.
  A request that already STREAMED tokens is MIGRATED mid-stream: the
  `Ticket` banks the emitted history, re-places
  `prompt + emitted_tokens` on a survivor (re-prefill is cheap — the
  prefix cache often already holds most of it), shrinks the remaining
  token budget by the same amount, and resumes the stream where it
  stopped. Greedy decode is deterministic, so the continuation is
  token-identical to an uninterrupted run in f32 (on the card in bf16
  the re-prefill runs its matmuls at another row count, so a near tie
  of the logits may resolve differently); SSE clients see at most a
  latency blip,
  and `usage.migrations` reports how many blips. The first failover
  attempt fires IMMEDIATELY; capped exponential backoff + full jitter
  applies only between subsequent attempts. Requests quarantined as
  POISON (finish reason "poisoned") are never re-placed.
- **Watchdog**: a monitor thread (`watchdog_timeout_s`) condemns a
  replica whose pump heartbeat goes stale — catching HUNG steps that
  never raise — which force-retires its residents into the same
  migration path.
- **Circuit breaker per replica** (closed/open/half-open): consecutive
  placement failures open the breaker and take the replica out of
  rotation; after `breaker_open_s` one probe placement is allowed
  (half-open) — success closes, failure re-opens. Watchdog kills and
  replica deaths trip it immediately.
- **Graceful drain**: `drain()` stops admission, drains every replica
  in parallel (residents finish, queued are aborted), and joins the
  driver threads. `/readyz` flips to 503 the moment drain begins.
- **Fleet control plane** (`controller=`, serving/controlplane.py,
  gated PADDLE_TPU_CONTROLPLANE, default off): placement becomes
  SLO-aware (a replica whose burn state is `warn` ranks below `ok`
  and `page` below `warn` — after breaker health, before load, so
  traffic drains away from a burning replica before it pages),
  `submit` sheds deadline-infeasible requests at the door (429 +
  Retry-After), and the controller resizes the fleet at runtime
  through `add_replica` / `remove_replica`: registration and
  removal happen under the router lock — the same discipline
  `Ticket._retry`/`cancel` use — so a retry or cancel racing a
  removal always acts on a live (driver, request) pair, and removal
  drains the replica gracefully (residents finish, streams complete).
  Dead replicas stay listed in `fleet_snapshot()` with their frozen
  SLO state, capped at the last `dead_replica_cap` (default 16;
  older tombstones are evicted and counted by
  `fleet_dead_evicted_total`).
- **Fleet KV fabric** (`fabric=`, serving/fabric.py, gated
  PADDLE_TPU_KV_FABRIC, default off): N replicas behave as ONE
  logical prefix cache. Placement gains prefix-affinity ranking
  (longest fingerprint match against per-replica tree summaries,
  refreshed on the controller poll — after breaker/SLO rank, before
  load); with `roles=` configured, long prompts run DISAGGREGATED —
  phase 1 prefills on a prefill specialist at a 1-token budget, the
  committed pages transfer as a versioned frame, and a decode
  specialist continues the stream token-identically
  (`Ticket._complete_handoff`); and `remove_replica` stashes the
  drained replica's whole tree so the next `add_replica` starts
  warm (zero re-prefill after a rolling deploy).
"""
from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..controlplane import DeadlineInfeasible, slo_placement_rank
from ..errors import EngineClosed, QueueFull, ServingError
from ..fabric import prompt_fingerprints, resolve_fabric
from ..faults import InjectedFault
from ..request import Request, RequestOutput, SamplingParams
from .driver import EngineDriver, ReplicaDead, ReplicaHung

__all__ = ["Router", "Ticket", "CircuitBreaker", "ReplicaWatchdog"]

_RETRYABLE_REASON = "replica_failure"


class CircuitBreaker:
    """Per-replica placement gate: closed (serving) / open (shunned) /
    half-open (one probe allowed). `failure_threshold` CONSECUTIVE
    failures open it; after `open_s` the next `allow()` observes
    half-open and lets a probe through — a success closes, a failure
    re-opens. Pure unit: every transition takes `now` explicitly, so
    tests drive it with a fake clock and no threads."""

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
    STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}
    # placement rank: half-open counts like closed — after the
    # cooldown the flapper sits idle (it was shunned), so load-ranking
    # naturally routes it the probe; ranking it below closed would
    # mean it only ever recovers once every clean replica fails
    PLACEMENT_RANK = {CLOSED: 0, HALF_OPEN: 0, OPEN: 1}

    def __init__(self, failure_threshold: int = 3, open_s: float = 1.0):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.open_s = float(open_s)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self.failures_total = 0
        self.opens_total = 0

    def _state_locked(self, now: float) -> str:
        if (self._state == self.OPEN
                and now - self._opened_at >= self.open_s):
            self._state = self.HALF_OPEN    # cooled off: probe allowed
        return self._state

    def state(self, now: float) -> str:
        with self._lock:
            return self._state_locked(now)

    def allow(self, now: float) -> bool:
        """May this replica receive a placement right now?"""
        with self._lock:
            return self._state_locked(now) != self.OPEN

    def record_success(self, now: float):
        with self._lock:
            self._state = self.CLOSED
            self._consecutive = 0
            self._opened_at = None

    def record_failure(self, now: float):
        with self._lock:
            self.failures_total += 1
            st = self._state_locked(now)
            self._consecutive += 1
            if (st == self.HALF_OPEN
                    or self._consecutive >= self.failure_threshold):
                if st != self.OPEN:
                    self.opens_total += 1
                self._state = self.OPEN
                self._opened_at = now

    def trip(self, now: float):
        """Immediate open — replica death / watchdog kill."""
        with self._lock:
            self.failures_total += 1
            self._consecutive = max(self._consecutive,
                                    self.failure_threshold)
            if self._state != self.OPEN:
                self.opens_total += 1
            self._state = self.OPEN
            self._opened_at = now


class ReplicaWatchdog:
    """Heartbeat monitor: condemns a replica whose pump has not beaten
    for `timeout_s` — the HUNG-step detector (a step that RAISES
    already takes the driver's own death path; a step that never
    returns beats nothing and only this catches it). Pure logic:
    `poll()` does one scan with the injected clock, so unit tests
    drive it with a fake clock and fake drivers; `Router` runs it on a
    daemon thread. `timeout_s` must exceed the worst-case legitimate
    step time (including first-use compilation) or a slow step reads
    as a hang."""

    def __init__(self, drivers: Sequence, timeout_s: float,
                 clock=time.monotonic, on_kill=None):
        self.drivers = list(drivers)
        self.timeout_s = float(timeout_s)
        self.clock = clock
        self.on_kill = on_kill
        self.kills_total = 0

    def poll(self) -> List:
        """One scan; returns the drivers condemned by it. A driver may
        expose `watchdog_grace_s` — extra tolerated staleness scaled
        with the tokens packed into its launch in flight — so a
        legitimately huge unified verify/prefill step reads as SLOW,
        not dead (false-positive hardening; `EngineDriver` computes it
        from `engine.step_tokens_inflight`)."""
        condemned = []
        now = self.clock()
        for d in self.drivers:
            if not getattr(d, "started", False) or d.dead or d.draining:
                continue
            beat = d.last_beat
            if beat is None:
                continue            # pump not yet ticking
            stale = now - beat
            allowed = self.timeout_s + float(
                getattr(d, "watchdog_grace_s", 0.0) or 0.0)
            if stale > allowed:
                d.condemn(ReplicaHung(
                    f"{d.name}: no heartbeat for {stale:.3f}s "
                    f"(watchdog_timeout_s={self.timeout_s}, "
                    f"grace={allowed - self.timeout_s:.3f}s)"))
                self.kills_total += 1
                condemned.append(d)
                if self.on_kill is not None:
                    self.on_kill(d)
        return condemned


class Ticket:
    """One client request's journey through the router — possibly
    spanning several engine-level Request attempts across replicas.
    `events()` is the single consumption point: it forwards tokens,
    surfaces idle beats (for disconnect probing), and performs
    failover — resubmission of unstarted requests AND mid-stream
    migration of started ones — transparently. `output()` is the
    merged client-facing view across every attempt."""

    def __init__(self, router: "Router", ticket_id: str, prompt_ids,
                 sampling: Optional[SamplingParams]):
        self.id = ticket_id
        self._router = router
        self._prompt_ids = np.asarray(prompt_ids).reshape(-1)
        self._sampling = sampling or SamplingParams()
        self.attempts = 1
        self.migrations = 0
        self.error: Optional[ServingError] = None
        self._history: List[int] = []   # tokens banked from dead attempts
        # accepted speculative drafts banked from dead attempts (the
        # live attempt's own count rides on its Request)
        self._accepted_drafts = 0
        # engine-level preemptions banked from dead attempts (the
        # overload counter follows the request across migrations)
        self._preemptions = 0
        # the dead attempt whose tokens were just banked: while a
        # terminal failover failure leaves it as self.request, the
        # merged output must not count its tokens TWICE (they are
        # already in _history)
        self._banked: Optional[Request] = None
        self._cancelled = False
        self._ttft_s: Optional[float] = None   # first attempt's, if any
        # disaggregated prefill/decode (fleet KV fabric, default
        # off): when the plan names a (prefill, decode) pair, phase 1
        # runs the prompt on the prefill specialist at a ONE-token
        # budget; its committed pages then transfer and the stream
        # continues on the decode specialist (`_complete_handoff`).
        # None = classic single-replica placement.
        self._fabric_dst: Optional[EngineDriver] = None
        plan = router._fabric_plan(self._prompt_ids, self._sampling)
        # the engine-level request id is the TICKET id — stable across
        # every attempt, never the engines' own per-replica counters:
        # replicas number requests independently, so engine-issued ids
        # collide across replicas, and anything keyed on a request id
        # globally (fault injection, logs, traces) must follow the
        # request when it migrates
        # may raise QueueFull/EngineClosed straight to the HTTP layer
        if plan is not None:
            pre, dst = plan
            try:
                self.driver, self.request = router._place_on(
                    pre, self._prompt_ids,
                    dataclasses.replace(self._sampling,
                                        max_new_tokens=1),
                    request_id=self.id)
                self._fabric_dst = dst
            except ServingError:
                plan = None     # prefill side refused: classic path
        if plan is None:
            self.driver, self.request = router._place(
                self._prompt_ids, self._sampling, exclude=(),
                request_id=self.id)
        self._tried = [self.driver]

    # -- consumption -------------------------------------------------------
    def events(self, poll_s: float = 0.05):
        """Yield ("token", id) / ("idle", None) / ("done", reason) /
        ("error", exc). "idle" fires every `poll_s` with no token so
        the caller can probe client liveness. A replica death
        ("replica_failure") triggers transparent failover: an
        unstarted request is resubmitted, a started one is MIGRATED
        (emitted history re-prefilled on a survivor, stream resumes
        token-identically). Only when failover itself fails does the
        caller see it: ("error", exc) if nothing was ever delivered,
        else ("done", "replica_failure") closing the partial stream.
        After "done"/"error" the generator returns."""
        while True:
            req = self.request
            kind, val = req.next_event(timeout=poll_s)
            if kind == "token":
                yield ("token", val)
            elif kind == "idle":
                yield ("idle", None)
            elif (self._fabric_dst is not None and val == "length"
                    and not self._cancelled):
                # phase 1 of a disaggregated placement ran out its
                # 1-token budget on the prefill specialist: hand off
                # to the decode specialist (pages transfer, stream
                # continues). Any other phase-1 reason (stop token,
                # timeout, replica death) takes its normal path.
                dst, self._fabric_dst = self._fabric_dst, None
                try:
                    if self._complete_handoff(req, dst):
                        continue
                    yield ("done", val)   # budget genuinely exhausted
                except ServingError as exc:
                    self.error = exc
                    # phase 1 delivered its token, so the stream
                    # closes as a partial rather than erroring
                    yield ("done", val)
                return
            elif val == _RETRYABLE_REASON and not self._cancelled:
                try:
                    self._failover(req)
                except ServingError as exc:
                    self.error = exc
                    if self._history:
                        yield ("done", val)
                    else:
                        yield ("error", exc)
                    return
            else:
                yield ("done", val)
                return

    def result(self, poll_s: float = 0.05) -> RequestOutput:
        """Blocking non-stream path: consume to completion. Raises the
        terminal ServingError if every attempt failed before anything
        was delivered."""
        for kind, val in self.events(poll_s=poll_s):
            if kind == "error":
                raise val
            if kind == "done":
                break
        return self.output()

    def output(self) -> RequestOutput:
        """Merged client-facing view of every attempt: banked history
        + the final attempt's tokens against the ORIGINAL prompt, with
        the migration count (usage.migrations over HTTP). When every
        re-placement failed (migration cap / no survivor) the live
        attempt IS the banked dead one — its tokens and counters are
        already in the banked totals and must not be added twice."""
        out = self.request.output()
        if not self._history and not self.migrations:
            return out
        live_is_banked = self.request is self._banked
        return RequestOutput(
            request_id=out.request_id,
            prompt_token_ids=self._prompt_ids.tolist(),
            token_ids=(list(self._history) if live_is_banked
                       else self._history + list(out.token_ids)),
            finish_reason=out.finish_reason,
            cached_tokens=out.cached_tokens,
            accepted_draft_tokens=(
                self._accepted_drafts
                + (0 if live_is_banked
                   else out.accepted_draft_tokens)),
            preemptions=(self._preemptions
                         + (0 if live_is_banked
                            else out.preemptions)),
            migrations=self.migrations,
            ttft_s=self._ttft_s if self._ttft_s is not None
            else out.ttft_s,
            queue_wait_s=out.queue_wait_s,
            e2e_s=out.e2e_s,
            embedding=out.embedding)

    def cancel(self):
        """Client went away: evict the live attempt and reclaim its
        slot/pages at the replica's next step boundary. Takes the
        router lock so a cancel racing a mid-failover retry can never
        target a STALE (driver, request) pair: whichever side wins the
        lock, the attempt that survives is the one cancelled (`_retry`
        re-checks the flag after swapping the pair in)."""
        with self._router._lock:
            self._cancelled = True
            driver, request = self.driver, self.request
        driver.cancel(request.request_id)

    # -- failover ----------------------------------------------------------
    def _failover(self, dead: Request):
        """The live attempt died with its replica. Bank whatever it
        streamed (by finish time the stream queue has been fully
        drained to the client, so `output_tokens` IS the delivered
        prefix), then re-place on a survivor: the new prompt is
        prompt + banked history and the token budget shrinks by the
        same amount — greedy decode is deterministic, so the survivor
        continues the exact sequence (token-identical to an
        uninterrupted run; asserted against the solo oracle)."""
        dead_replica = self.driver.name
        # a pending disaggregated handoff dies with its prefill
        # replica: the migration below re-places the whole request
        # with its FULL remaining budget, so nothing is lost
        self._fabric_dst = None
        if self._ttft_s is None and dead.output_tokens:
            self._ttft_s = dead.output().ttft_s
        self._history.extend(dead.output_tokens)
        self._accepted_drafts += dead.accepted_draft_tokens
        self._preemptions += dead.preemptions
        self._banked = dead
        if not self._history:
            self._retry(self._prompt_ids, self._sampling)
            return
        # migration cap: a fleet where every survivor
        # keeps dying must not bounce a started stream forever — after
        # max_migrations the typed replica error surfaces and the
        # partial stream closes, usage.migrations reported as-is
        if self.migrations >= self._router.max_migrations:
            raise ReplicaDead(
                f"migration cap reached ({self.migrations} of "
                f"{self._router.max_migrations}); giving up on "
                f"ticket {self.id}")
        remaining = self._sampling.max_new_tokens - len(self._history)
        if remaining <= 0:
            # unreachable: the engine retires at max_new_tokens before
            # a death can leave a full budget — guard anyway
            raise EngineClosed("no token budget left to migrate")
        prompt = np.concatenate(
            [self._prompt_ids,
             np.asarray(self._history, dtype=self._prompt_ids.dtype)])
        # grammar continuity: the banked history is PROMPT on the
        # survivor, but it is grammar OUTPUT — grammar_prefix tells
        # the new replica's engine to replay those trailing prompt
        # tokens through a fresh automaton before decoding, so the
        # constraint resumes mid-structure, token-identically
        sampling = dataclasses.replace(
            self._sampling, max_new_tokens=remaining,
            **({"grammar_prefix": self._sampling.grammar_prefix
                + len(self._history)}
               if getattr(self._sampling, "grammar", None) is not None
               else {}))
        self._retry(prompt, sampling)
        self.migrations += 1
        with self._router._lock:
            self._router.migrations_total += 1
        # timeline continuity: the ticket id IS the engine request id
        # on every replica, so the new replica's tracer already holds
        # the re-placement's submit/admit — this marks WHY it appeared
        # there (the merged /debug/requests/<id> view shows one
        # timeline spanning both replicas)
        obs = getattr(self.driver.engine, "obs", None)
        if obs is not None:
            obs.tracer.record(self.id, "migrate",
                              cause=f"replica_death:{dead_replica}",
                              tokens=len(self._history))

    def _complete_handoff(self, done: Request, dst: EngineDriver
                          ) -> bool:
        """Phase 2 of a disaggregated placement: the prefill
        specialist finished the prompt and emitted exactly its
        1-token budget. Bank that token (migration-style), ship the
        committed prompt pages to the decode specialist (best-effort:
        a failed transfer just means the decode side re-prefills —
        the prefix cache makes that its only cost), then continue
        `prompt + banked` there with the remaining budget. Greedy
        decode is deterministic AND the transferred pages hold exact
        quantized codes, so the merged stream is token-identical to
        an undisaggregated run. Returns False when no budget remains
        (the stream was genuinely done at 1 token)."""
        r = self._router
        src_name = self.driver.name
        if self._ttft_s is None and done.output_tokens:
            self._ttft_s = done.output().ttft_s
        self._history.extend(done.output_tokens)
        self._accepted_drafts += done.accepted_draft_tokens
        self._preemptions += done.preemptions
        self._banked = done
        remaining = self._sampling.max_new_tokens - len(self._history)
        if remaining <= 0:
            return False
        aid = int(getattr(self._sampling, "adapter_id", 0) or 0)
        r._fabric_transfer(self.driver, dst, self._prompt_ids, aid)
        prompt = np.concatenate(
            [self._prompt_ids,
             np.asarray(self._history, dtype=self._prompt_ids.dtype)])
        # grammar continuity across the handoff (see _failover): the
        # banked token is grammar output riding as prompt
        sampling = dataclasses.replace(
            self._sampling, max_new_tokens=remaining,
            **({"grammar_prefix": self._sampling.grammar_prefix
                + len(self._history)}
               if getattr(self._sampling, "grammar", None) is not None
               else {}))
        try:
            driver, request = r._place_on(dst, prompt, sampling,
                                          request_id=self.id)
        except ServingError:
            # decode side refused (shed/dying): any survivor can
            # finish the stream — the classic failover re-place
            driver, request = r._place(prompt, sampling, exclude=(),
                                       request_id=self.id)
        with r._lock:
            self.driver, self.request = driver, request
            self._banked = None
            self._tried = [driver]
            self.attempts += 1
            r.fabric_handoffs_total += 1
            cancelled = self._cancelled
        if cancelled:     # cancel raced the handoff: honor it
            driver.cancel(request.request_id)
        obs = getattr(driver.engine, "obs", None)
        if obs is not None:
            obs.tracer.record(self.id, "fabric_handoff",
                              cause=f"prefill:{src_name}",
                              tokens=len(self._history))
        return True

    def _retry(self, prompt_ids, sampling):
        """Re-place on another replica. Attempt 0 fires IMMEDIATELY —
        a dead replica's requests should land on a survivor with zero
        added latency; capped exponential backoff + full jitter only
        paces the attempts after a failed re-placement."""
        r = self._router
        last: Optional[ServingError] = None
        for attempt in range(r.max_retries):
            if attempt > 0:
                delay = min(r.backoff_cap_s,
                            r.backoff_base_s * (2 ** (attempt - 1)))
                time.sleep(delay * r._jitter())
            try:
                driver, request = r._place(
                    prompt_ids, sampling, exclude=self._tried,
                    request_id=self.id)
            except (QueueFull, EngineClosed) as exc:
                last = exc
                continue
            # swap the live pair in under the router lock so cancel()
            # can never act on a stale pair
            with r._lock:
                self.driver, self.request = driver, request
                self._banked = None      # live attempt is fresh again
                self._tried.append(driver)
                self.attempts += 1
                r.retries_total += 1
                cancelled = self._cancelled
            if cancelled:       # cancel raced the re-placement: honor it
                driver.cancel(request.request_id)
            return
        raise last if last is not None else EngineClosed(
            "failover retries exhausted")


class Router:
    def __init__(self, drivers: Sequence[EngineDriver], *,
                 max_retries: int = 3, max_migrations: int = 8,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 default_timeout_s: Optional[float] = None,
                 jitter=None,
                 watchdog_timeout_s: Optional[float] = None,
                 watchdog_interval_s: Optional[float] = None,
                 breaker_failures: int = 3,
                 breaker_open_s: float = 1.0,
                 controller=None,
                 dead_replica_cap: int = 16,
                 fabric=None,
                 clock=time.monotonic):
        if not drivers:
            raise ValueError("router needs at least one driver")
        names = [d.name for d in drivers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate driver names: {names}")
        self.drivers: List[EngineDriver] = list(drivers)
        self.max_retries = int(max_retries)
        # per-ticket bound on mid-stream migrations: a chaos schedule
        # that kills every survivor must terminate in a typed replica
        # error, not an endless bounce
        self.max_migrations = int(max_migrations)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.default_timeout_s = default_timeout_s
        # full jitter in (0, 1]: decorrelates thundering-herd retries
        self._jitter = jitter or (lambda: random.random() or 1.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._draining = False
        self._ids = itertools.count()
        self.retries_total = 0
        self.migrations_total = 0
        self._breaker_failures = int(breaker_failures)
        self._breaker_open_s = float(breaker_open_s)
        self.breakers: Dict[str, CircuitBreaker] = {
            d.name: CircuitBreaker(breaker_failures, breaker_open_s)
            for d in self.drivers}
        # fleet control plane (serving/controlplane.py; None = off):
        # SLO-aware placement, deadline-aware admission, and — when
        # the controller carries a replica_factory — autoscaling over
        # add_replica/remove_replica
        self.controller = controller
        self._controller_stop = threading.Event()
        self._controller_thread: Optional[threading.Thread] = None
        # runtime registration: monotonically increasing name seq
        # (never reuses a tombstoned name) + dead-replica tombstone cap
        self._started = False
        self._names_ever = set(names)
        self._replica_seq = len(self.drivers)
        self.dead_replica_cap = int(dead_replica_cap)
        self.fleet_dead_evicted_total = 0
        self._death_seen: List[str] = []
        # per-replica count of placements steered AROUND it because
        # its SLO was burning (the fleet view's burn-avoidance column)
        self._avoided_by: Dict[str, int] = {}
        # fleet KV fabric (serving/fabric.py; None = off, gated
        # PADDLE_TPU_KV_FABRIC / fabric=): prefix-affinity placement
        # over per-replica fingerprint summaries, disaggregated
        # prefill->decode page handoff, and warm restarts over the
        # stashed tree snapshot of the last drained replica
        self.fabric = resolve_fabric(fabric)
        self._fabric_fps: Dict[str, set] = {}
        self._fabric_snapshot: Optional[dict] = None
        self.fabric_handoffs_total = 0
        self.fabric_pages_moved_total = 0
        self.fabric_transfer_failures_total = 0
        self.watchdog: Optional[ReplicaWatchdog] = None
        self._watchdog_stop = threading.Event()
        self._watchdog_thread: Optional[threading.Thread] = None
        self._watchdog_interval_s = None
        if watchdog_timeout_s is not None:
            self.watchdog = ReplicaWatchdog(
                self.drivers, watchdog_timeout_s, clock=clock,
                on_kill=self._on_watchdog_kill)
            self._watchdog_interval_s = (
                float(watchdog_interval_s) if watchdog_interval_s
                else max(0.01, float(watchdog_timeout_s) / 4.0))

    def _on_watchdog_kill(self, driver: EngineDriver):
        self.breakers[driver.name].trip(self._clock())

    @property
    def watchdog_kills_total(self) -> int:
        return self.watchdog.kills_total if self.watchdog else 0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Router":
        self._started = True
        for d in list(self.drivers):
            d.start()
        if self.watchdog is not None and self._watchdog_thread is None:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, name="router-watchdog",
                daemon=True)
            self._watchdog_thread.start()
        if (self.controller is not None
                and self._controller_thread is None
                and getattr(self.controller.config, "interval_s", 0)
                > 0):
            self._controller_thread = threading.Thread(
                target=self._controller_loop,
                name="router-controlplane", daemon=True)
            self._controller_thread.start()
        return self

    def _controller_loop(self):
        interval = float(self.controller.config.interval_s)
        while not self._controller_stop.wait(interval):
            if self._draining:
                return
            try:
                self.controller.poll(self)
            except Exception:
                pass    # a torn stats read must not kill the loop

    def _watchdog_loop(self):
        while not self._watchdog_stop.wait(self._watchdog_interval_s):
            if self._draining:
                return
            try:
                self.watchdog.poll()
            except Exception:
                pass    # a torn stats read must not kill the monitor

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def healthy(self) -> bool:
        """Liveness: at least one replica pump thread is serving."""
        return any(d.healthy for d in list(self.drivers))

    @property
    def ready(self) -> bool:
        """Readiness: healthy AND still admitting (not draining)."""
        return not self._draining and self.healthy

    def drain(self, timeout: Optional[float] = None):
        """Stop admitting, finish every resident on every replica,
        join the driver threads. Safe to call more than once."""
        self._draining = True
        self._watchdog_stop.set()
        self._controller_stop.set()
        threads = [threading.Thread(target=d.drain, args=(timeout,),
                                    daemon=True)
                   for d in list(self.drivers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)

    # -- runtime replica registration (the controller's actuators) ---------
    def add_replica(self, engine=None, *, driver: Optional[EngineDriver]
                    = None, name: Optional[str] = None,
                    start: bool = True) -> EngineDriver:
        """Register a replica at runtime (the autoscaler's scale-up
        path): wrap `engine` in an EngineDriver (or take a prepared
        `driver`), create its breaker, extend the watchdog's scan
        list, and start the pump if the router is running. Names are
        auto-assigned from a monotonically increasing sequence and
        NEVER reuse a name this router has ever seen (a tombstoned
        replica keeps its identity in postmortems). All membership
        mutation happens under the router lock — the same discipline
        `Ticket._retry`/`cancel` take — so placement snapshots are
        always consistent."""
        if engine is not None and isinstance(engine, EngineDriver):
            driver, engine = engine, None           # positional driver
        if (engine is None) == (driver is None):
            raise ValueError("pass exactly one of engine= or driver=")
        if self._draining:
            raise EngineClosed("router is draining")
        with self._lock:
            if driver is None:
                while name is None or name in self._names_ever:
                    name = f"replica-{self._replica_seq}"
                    self._replica_seq += 1
                driver = EngineDriver(engine, name=name)
            if driver.name in self._names_ever:
                raise ValueError(
                    f"replica name {driver.name!r} already used")
            self._names_ever.add(driver.name)
            self.drivers.append(driver)
            self.breakers[driver.name] = CircuitBreaker(
                self._breaker_failures, self._breaker_open_s)
            if self.watchdog is not None:
                self.watchdog.drivers.append(driver)
            started = self._started
        # warm start (fleet KV fabric): restore the stashed tree
        # snapshot of the last drained replica BEFORE the pump starts
        # stepping, so the new replica's first admission already hits
        self._fabric_restore(driver)
        if start and started:
            driver.start()
        return driver

    def remove_replica(self, name: str, *,
                       timeout: Optional[float] = None,
                       wait: bool = True) -> EngineDriver:
        """Deregister a replica at runtime (the autoscaler's
        scale-down path): remove it from placement and the watchdog
        under the router lock, then GRACEFULLY drain it — residents
        finish and in-flight streams complete. A Ticket retry racing
        the removal re-snapshots `self.drivers` under the same lock,
        so it can never re-place onto the removed replica; a cancel
        racing it still targets the live driver object (removal never
        invalidates the (driver, request) pair, it only stops new
        placements). `wait=False` drains on a daemon thread (the
        controller's non-blocking path). Refuses to remove the last
        live replica — `drain()` is how the fleet stops."""
        with self._lock:
            target = next((d for d in self.drivers if d.name == name),
                          None)
            if target is None:
                raise ValueError(f"no replica named {name!r}")
            live = [d for d in self.drivers
                    if d.healthy and not d.draining]
            if target in live and len(live) <= 1:
                raise ValueError(
                    f"refusing to remove {name!r}: last live replica "
                    "(use drain() to stop the fleet)")
            self.drivers.remove(target)
            if self.watchdog is not None \
                    and target in self.watchdog.drivers:
                self.watchdog.drivers.remove(target)
            # drop the removed replica's router-side state NOW: a
            # gracefully removed replica is never reaped by the dead-
            # tombstone pruner, so leaving these would leak forever —
            # and a breaker entry that outlives its replica poisons
            # `stats()["breakers"]` with stale (possibly open) state.
            # An in-flight placement racing this read gets a
            # throwaway closed breaker from `_breaker_for` — its
            # verdict no longer matters.
            self.breakers.pop(name, None)
            self._avoided_by.pop(name, None)
            self._fabric_fps.pop(name, None)
        if wait:
            target.drain(timeout)
            self._fabric_stash(target)
        else:
            def _drain_then_stash():
                target.drain(timeout)
                self._fabric_stash(target)
            threading.Thread(target=_drain_then_stash,
                             daemon=True).start()
        return target

    def _prune_dead(self):
        """Dead-replica tombstone cap: dead replicas stay listed in
        `fleet_snapshot()` with their frozen SLO state — but only the
        last `dead_replica_cap` of them. Older tombstones are evicted
        (removed from every router structure) and counted by
        `fleet_dead_evicted_total`, so a chaos fleet cannot grow the
        snapshot without bound."""
        with self._lock:
            dead_names = {d.name for d in self.drivers if d.dead}
            for d in self.drivers:
                if d.dead and d.name not in self._death_seen:
                    self._death_seen.append(d.name)
            self._death_seen = [n for n in self._death_seen
                                if n in dead_names]
            excess = len(self._death_seen) - self.dead_replica_cap
            if excess <= 0:
                return
            for name in self._death_seen[:excess]:
                target = next(d for d in self.drivers
                              if d.name == name)
                self.drivers.remove(target)
                if self.watchdog is not None \
                        and target in self.watchdog.drivers:
                    self.watchdog.drivers.remove(target)
                self.breakers.pop(name, None)
                self._avoided_by.pop(name, None)
                self.fleet_dead_evicted_total += 1
            self._death_seen = self._death_seen[excess:]

    # -- submission --------------------------------------------------------
    def submit(self, prompt_ids, sampling: Optional[SamplingParams] = None,
               ticket_id: Optional[str] = None) -> Ticket:
        """Place a request on the least-loaded allowed replica. Raises
        QueueFull (429) when every healthy replica sheds, EngineClosed
        (503) when draining or no replica is healthy."""
        if self._draining:
            raise EngineClosed("router is draining")
        if sampling is not None and sampling.timeout_s is None \
                and self.default_timeout_s is not None:
            sampling.timeout_s = self.default_timeout_s
        # deadline-aware admission (controlplane on): a request whose
        # placement deadline is already infeasible at the current
        # backlog is shed AT THE DOOR (429 + Retry-After) before it
        # wastes a queue slot and KV pages
        ctrl = self.controller
        if (ctrl is not None and sampling is not None
                and sampling.deadline_s is not None):
            retry = ctrl.check_admission(ctrl.observe(self),
                                         sampling.deadline_s)
            if retry is not None:
                ctrl._note(self, "shed",
                           {"deadline_s": sampling.deadline_s,
                            "retry_after_s": round(retry, 3)})
                raise DeadlineInfeasible(
                    f"deadline {sampling.deadline_s}s is infeasible "
                    "at the current backlog (predicted queue wait "
                    "exceeds it); shed at admission",
                    retry_after_s=retry)
        if ticket_id is None:
            ticket_id = f"cmpl-{next(self._ids)}"
        return Ticket(self, ticket_id, prompt_ids, sampling)

    def _place(self, prompt_ids, sampling,
               exclude: Sequence[EngineDriver],
               request_id: Optional[str] = None
               ) -> Tuple[EngineDriver, Request]:
        if self._draining:
            raise EngineClosed("router is draining")
        now = self._clock()
        # membership snapshot under the lock: add/remove_replica
        # mutate self.drivers under the same lock, so a placement
        # racing a removal never walks a half-updated list
        with self._lock:
            drivers = list(self.drivers)
        healthy = [d for d in drivers if d.healthy]
        if not healthy:
            raise EngineClosed("no healthy replica")
        # breaker gate, with a last-resort fallback: if EVERY healthy
        # replica's breaker is open, shunning them all would turn a
        # flap into a total outage — use them anyway
        allowed = [d for d in healthy
                   if self._breaker_for(d.name).allow(now)]
        pool = allowed or healthy
        # every survivor already tried: allow re-tries on them rather
        # than failing a retryable request outright
        cands = [d for d in pool if d not in exclude] or pool
        # adapter affinity (multi-tenant LoRA serving): a replica
        # whose adapter pool already holds this request's adapter
        # resident (hot) beats a cold one — placement warmth for
        # weights, exactly like prefix affinity for KV — ranked right
        # after breaker health and before load
        aid = int(getattr(sampling, "adapter_id", 0) or 0) \
            if sampling is not None else 0
        keys = {id(d): self._load_key(d, aid) for d in cands}
        if self.fabric is not None:
            # prefix-affinity routing (fleet KV fabric): the replica
            # whose tree summary covers the longest page-aligned
            # prefix of THIS prompt wins among equals — spliced in at
            # index 2, after breaker health and SLO rank (a burning
            # warm replica still loses to a clean cold one), before
            # adapter warmth and load. Index 1 stays the SLO rank:
            # the burn-avoidance accounting below depends on it.
            fps_by_ps: Dict[int, list] = {}
            for d in cands:
                ps = int(getattr(d.engine, "page_size", 0) or 0)
                if ps > 0 and ps not in fps_by_ps:
                    fps_by_ps[ps] = prompt_fingerprints(
                        prompt_ids, ps, aid)
                aff = self._fabric_affinity(
                    d.name, fps_by_ps.get(ps, ()))
                k = keys[id(d)]
                keys[id(d)] = k[:2] + (-aff,) + k[2:]
        cands.sort(key=lambda d: keys[id(d)])
        last: Optional[ServingError] = None
        for d in cands:
            try:
                req = d.submit(prompt_ids, sampling,
                               request_id=request_id)
            except QueueFull as exc:
                # load, not a fault: no breaker charge
                last = exc
            except (ReplicaDead, EngineClosed, InjectedFault) as exc:
                # raced into death/drain between the health check and
                # the submit (or an injected admission fault): charge
                # the breaker, try the next candidate
                self._breaker_for(d.name).record_failure(self._clock())
                last = exc
            else:
                self._breaker_for(d.name).record_success(self._clock())
                # burn-avoidance accounting (controlplane on): this
                # placement steered around every candidate whose SLO
                # rank was worse than the chosen replica's
                if self.controller is not None:
                    chosen_slo = keys[id(d)][1]
                    avoided = [c for c in cands
                               if keys[id(c)][1] > chosen_slo]
                    if avoided:
                        with self._lock:
                            for c in avoided:
                                self._avoided_by[c.name] = \
                                    self._avoided_by.get(c.name, 0) + 1
                        self.controller.on_placement_avoided()
                return d, req
        if isinstance(last, QueueFull):
            raise last
        raise EngineClosed("no replica accepted the request") from last

    def _place_on(self, d: EngineDriver, prompt_ids, sampling,
                  request_id: Optional[str] = None
                  ) -> Tuple[EngineDriver, Request]:
        """Place on ONE specific replica (the fabric's role-pinned
        placements) with the same breaker accounting as `_place`:
        QueueFull is load (no charge), death/drain charges the
        breaker. No fallback here — the caller decides whether a
        refusal means `_place` normally or fail."""
        if self._draining:
            raise EngineClosed("router is draining")
        try:
            req = d.submit(prompt_ids, sampling, request_id=request_id)
        except QueueFull:
            raise
        except (ReplicaDead, EngineClosed, InjectedFault):
            self._breaker_for(d.name).record_failure(self._clock())
            raise
        self._breaker_for(d.name).record_success(self._clock())
        return d, req

    def _breaker_for(self, name: str) -> CircuitBreaker:
        """Breaker lookup that survives a racing remove/prune: a
        replica evicted mid-placement gets a throwaway closed breaker
        (its verdict no longer matters)."""
        b = self.breakers.get(name)
        if b is None:
            b = CircuitBreaker(self._breaker_failures,
                               self._breaker_open_s)
        return b

    def _load_key(self, d: EngineDriver, adapter_id: int = 0):
        s = d.stats()
        rank = CircuitBreaker.PLACEMENT_RANK[
            self._breaker_for(d.name).state(self._clock())]
        # SLO-aware placement (controlplane on): a replica whose burn
        # state is `warn` ranks below `ok` and `page` below `warn` —
        # after breaker health (a tripped replica is worse than a
        # burning one), before adapter warmth and load — so traffic
        # drains away from a burning replica before it pages
        slo_rank = (slo_placement_rank(s.get("slo_state"))
                    if self.controller is not None else 0)
        cold = 0
        if adapter_id:
            store = getattr(d.engine, "adapters", None)
            cold = 0 if (store is not None
                         and store.is_hot(adapter_id)) else 1
        return (rank, slo_rank, cold, s["queue_depth"], s["inflight"],
                -s["free_pages"])

    # -- fleet KV fabric (serving/fabric.py) -------------------------------
    def refresh_fabric_summaries(self):
        """Refresh every live replica's prefix-fingerprint summary
        (the affinity ranking's input) — called on the controller
        poll; cheap enough for tests to call directly. A
        replica that cannot answer keeps its stale summary: stale
        affinity is a mis-ranked placement, not an error."""
        if self.fabric is None:
            return
        limit = self.fabric.summary_limit
        for d in list(self.drivers):
            if d.dead or d.draining:
                continue
            try:
                fps = d.call(lambda eng: (
                    set() if eng.prefix_cache is None
                    else eng.prefix_cache.fingerprints(limit)))
            except Exception:
                continue
            with self._lock:
                self._fabric_fps[d.name] = fps

    def _fabric_affinity(self, name: str, prompt_fps) -> int:
        """Longest page-aligned prefix of the prompt this replica's
        last summary can serve, in pages. The fingerprint is a chain
        (depth d+1 folds depth d), so the first miss ends the walk."""
        fps = self._fabric_fps.get(name)
        if not fps or not prompt_fps:
            return 0
        depth = 0
        for d, fp in prompt_fps:
            if fp not in fps:
                break
            depth = d
        return depth

    def _fabric_plan(self, prompt_ids, sampling
                     ) -> Optional[Tuple[EngineDriver, EngineDriver]]:
        """Disaggregated placement decision: (prefill specialist,
        decode specialist) for this prompt, or None for the classic
        path. Requires role-configured fabric, both roles live, a
        token budget > 1 (phase 1 spends exactly 1), and a prompt
        spanning at least `handoff_min_pages` full pages (short
        prompts re-prefill cheaper than they transfer). Skipped when
        the best decode replica already holds the whole prefix —
        affinity routing alone lands it there with zero transfer."""
        fab = self.fabric
        if fab is None or not fab.roles or self._draining:
            return None
        budget = int(getattr(sampling, "max_new_tokens", 16) or 16) \
            if sampling is not None else 16
        if budget < 2:
            return None
        with self._lock:
            drivers = list(self.drivers)
        roles = fab.roles
        pre = [d for d in drivers
               if d.healthy and roles.get(d.name) == "prefill"]
        dec = [d for d in drivers
               if d.healthy and roles.get(d.name) == "decode"]
        if not pre or not dec:
            return None
        aid = int(getattr(sampling, "adapter_id", 0) or 0) \
            if sampling is not None else 0
        ps = int(getattr(dec[0].engine, "page_size", 0) or 0)
        if ps <= 0:
            return None
        prompt = np.asarray(prompt_ids).reshape(-1)
        n_pages = prompt.size // ps
        if n_pages < fab.handoff_min_pages:
            return None
        fps = prompt_fingerprints(prompt, ps, aid)
        src = min(pre, key=lambda d: self._load_key(d, aid))
        dst = min(dec, key=lambda d: (
            -self._fabric_affinity(d.name, fps),
            self._load_key(d, aid)))
        if self._fabric_affinity(dst.name, fps) >= n_pages:
            return None   # already warm there: no transfer needed
        obs = getattr(src.engine, "obs", None)
        if obs is not None:     # placement decision, in the flight ring
            obs.flight.note(
                "fabric:plan",
                f"prefill={src.name} decode={dst.name} "
                f"pages={n_pages} adapter={aid}")
        return src, dst

    def _fabric_transfer(self, src: EngineDriver, dst: EngineDriver,
                         tokens, adapter_id: int = 0) -> int:
        """Ship the committed page chain covering `tokens` from `src`
        to `dst` (export -> frame -> graft, each on its own driver
        thread between steps). Best-effort by design: on ANY failure
        the decode side simply re-prefills — correctness never rides
        the transfer. Returns pages grafted."""
        if self.fabric is None:
            return 0
        try:
            frame = src.call(
                lambda eng: eng.export_prefix_frame(tokens,
                                                    adapter_id))
            if frame is None:
                return 0
            grafted = dst.call(
                lambda eng: eng.import_prefix_frame(frame))
        except Exception:
            with self._lock:
                self.fabric_transfer_failures_total += 1
            return 0
        with self._lock:
            self.fabric_pages_moved_total += int(grafted)
        return int(grafted)

    def _fabric_stash(self, target: EngineDriver):
        """Snapshot a just-drained replica's whole prefix tree so the
        next `add_replica` starts warm (kept, not consumed: every
        subsequent add warms from the newest stash)."""
        if self.fabric is None or not self.fabric.restore_on_add:
            return
        try:
            snap = target.call(lambda eng: eng.export_prefix_state())
        except Exception:
            return
        if snap and snap.get("nodes"):
            with self._lock:
                self._fabric_snapshot = snap

    def _fabric_restore(self, driver: EngineDriver) -> int:
        """Warm a newly registered replica from the stashed snapshot
        (geometry-checked engine-side; any failure degrades to a cold
        start). Returns pages restored."""
        if self.fabric is None or not self.fabric.restore_on_add:
            return 0
        with self._lock:
            snap = self._fabric_snapshot
        if snap is None:
            return 0
        try:
            return int(driver.call(
                lambda eng: eng.import_prefix_state(snap)))
        except Exception:
            return 0

    # -- multi-tenant adapter registry --------------------------------------
    def resolve_model(self, name: str) -> Optional[int]:
        """Map an HTTP `model=` name to its adapter_id through the
        fleet's registries (replicas register the same adapters in
        the same order, so ids agree). None = unknown name."""
        for d in self.drivers:
            store = getattr(d.engine, "adapters", None)
            if store is not None:
                aid = store.id_for(name)
                if aid is not None:
                    return aid
        return None

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        now = self._clock()
        return {
            "ready": self.ready,
            "draining": self._draining,
            "replicas": [d.stats() for d in list(self.drivers)],
            "retries_total": self.retries_total,
            "migrations_total": self.migrations_total,
            "watchdog_kills_total": self.watchdog_kills_total,
            "fleet_dead_evicted_total": self.fleet_dead_evicted_total,
            "breakers": {name: b.state(now)
                         for name, b in dict(self.breakers).items()},
            "fabric": (None if self.fabric is None else {
                "handoffs_total": self.fabric_handoffs_total,
                "pages_moved_total": self.fabric_pages_moved_total,
                "transfer_failures_total":
                    self.fabric_transfer_failures_total,
                "stashed_nodes": (
                    0 if self._fabric_snapshot is None
                    else len(self._fabric_snapshot["nodes"])),
                "summary_fps": {n: len(f) for n, f in
                                sorted(self._fabric_fps.items())},
            }),
            "controlplane": (None if self.controller is None
                             else self.controller.stats()),
        }

    def metrics_snapshots(self) -> dict:
        """{replica name: engine metrics snapshot} for /metrics."""
        return {d.name: d.engine.metrics.snapshot()
                for d in list(self.drivers)}

    # -- debug introspection (serving/obs.py; env-gated in server.py) ------
    def debug_state(self) -> dict:
        """`GET /debug/state`: the router's own stats plus every
        replica's live engine state. Reads race the pump threads by
        design (a wedged replica must still answer) — the rare torn
        dict read is retried, then reported instead of raised."""
        replicas = {}
        for d in list(self.drivers):
            for _ in range(3):
                try:
                    replicas[d.name] = d.engine.debug_state()
                    break
                except RuntimeError:
                    continue        # dict mutated mid-read: retry
            else:
                replicas[d.name] = {"error": "state unstable (engine "
                                             "mutating during read)"}
        return {"router": self.stats(), "replicas": replicas}

    def request_timeline(self, request_id: str) -> Optional[List[dict]]:
        """ONE merged lifecycle timeline for `request_id` across every
        replica it touched (the ticket id is stable across
        migration), each event tagged with its replica, ordered by
        timestamp. None = no replica has ever seen the id."""
        merged: List[dict] = []
        for d in list(self.drivers):
            obs = getattr(d.engine, "obs", None)
            if obs is None:
                continue
            tl = obs.tracer.timeline(request_id)
            if tl:
                merged.extend({**ev, "replica": d.name} for ev in tl)
        if not merged:
            return None
        merged.sort(key=lambda ev: ev["t"])
        return merged

    def flight_dumps(self) -> dict:
        """`GET /debug/flight`: {replica: flight snapshot} — the live
        ring plus retained incident dumps of every replica (dead ones
        included: their ring holds the final steps)."""
        out = {}
        for d in list(self.drivers):
            obs = getattr(d.engine, "obs", None)
            out[d.name] = (None if obs is None
                           else obs.flight.snapshot())
        return out

    def fleet_snapshot(self) -> dict:
        """`GET /debug/fleet`: the whole fleet as ONE document — per
        replica its health (driver liveness + breaker state), load
        (queue/residents/pool/host-tier occupancy), throughput, the
        step cost census + achieved-utilization summary, the
        live SLO state (burn rates per class/tenant), and the
        incident count; plus the router's own stats and the
        fleet-worst SLO state at the top. Dead replicas stay listed —
        their engine objects survive the pump, so their final SLO
        state and census remain readable (the incident dump carries
        them too). Reads race the pumps by design (torn dict reads
        retried, then reported instead of raised) — a wedged fleet
        must still answer. Dead replicas are tombstones: they stay
        listed with their frozen SLO state, capped at the last
        `dead_replica_cap` (older ones evicted + counted)."""
        from ..slo import SLO_STATE_CODES
        self._prune_dead()
        now = self._clock()
        replicas = {}
        worst = "ok"
        for d in list(self.drivers):
            eng = d.engine
            entry = None
            for _ in range(3):
                try:
                    obs = getattr(eng, "obs", None)
                    slo = getattr(eng, "slo", None)
                    slo_snap = None if slo is None else slo.snapshot()
                    m = eng.metrics
                    entry = {
                        "healthy": d.healthy,
                        "dead": d.dead,
                        "draining": d.draining,
                        "breaker": self._breaker_for(d.name).state(now),
                        "steps": d.steps,
                        "queue_depth": eng.scheduler.queue_depth,
                        "residents": len(eng.scheduler.running),
                        "num_slots": eng.num_slots,
                        "pool": {
                            "pages_used": eng.pool.used_pages,
                            "pages_total": eng.num_pages - 1,
                            "pages_cached": eng.pool.cached_pages,
                            "pages_swapped": eng.pool.swapped_pages},
                        "host_pages_used": eng.host_pool.used_pages,
                        # cache warmth (the fleet view's warm column) +
                        # fabric wire traffic, per replica
                        "prefix": (None if eng.prefix_cache is None
                                   else eng.prefix_cache.stats()),
                        "fabric": {
                            "pages_sent": m.fabric_pages_sent,
                            "bytes_sent": m.fabric_bytes_sent,
                            "pages_recv": m.fabric_pages_recv,
                            "bytes_recv": m.fabric_bytes_recv,
                            "restored_pages":
                                m.fabric_restored_pages,
                        },
                        "tokens_generated": m.tokens_generated,
                        "tokens_per_sec": m.tokens_per_sec,
                        "achieved_util":
                            m.achieved_util_hist.snapshot(),
                        "cost_census": eng.cost_census(),
                        "slo": slo_snap,
                        "incidents_total": (
                            None if obs is None
                            else obs.flight.incidents_total),
                        "placement_avoided":
                            self._avoided_by.get(d.name, 0),
                    }
                    break
                except RuntimeError:
                    continue        # dict mutated mid-read: retry
            if entry is None:
                entry = {"error": "state unstable (engine mutating "
                                  "during read)"}
            st = ((entry.get("slo") or {}).get("worst")) or "ok"
            if SLO_STATE_CODES.get(st, 0) > SLO_STATE_CODES[worst]:
                worst = st
            replicas[d.name] = entry
        return {"router": self.stats(), "slo_worst": worst,
                "controlplane": (None if self.controller is None
                                 else self.controller.stats()),
                "replicas": replicas}
