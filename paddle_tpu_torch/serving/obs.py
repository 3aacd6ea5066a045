"""Serving flight recorder and request-lifecycle tracing (counterpart
of `paddle_tpu/serving/obs.py`).

- **RequestTracer**: every request gets an ordered event timeline
  (`submit -> admit -> prefill_chunk x N -> decode -> first_token ->
  preempt/swap_in -> finish|deadline|poison|replica_death`; an embed
  request's `prefill_chunk x N -> embed -> finish`), each event
  carrying the engine step index, slot, page counts and cause, recorded
  by the engine at the call sites that drive `ServingMetrics.on_*`.
  `timeline_to_chrome` renders one timeline as a Chrome trace through
  the profiler's chrome-tracing writer.
- **FlightRecorder**: a bounded, lock-protected ring (default 1024
  steps, env `PADDLE_TPU_FLIGHT_STEPS`) of per-step records: the token
  split, resident slots, queue depth, page-pool and host-tier
  occupancy, grouped-walk reads saved, spec drafted/accepted, achieved
  utilization, step wall time. `incident()` freezes the ring into a
  bounded dump list (the engine calls it on poison quarantine, deadline
  fail-fast and any raising round, the driver on replica death), so a
  postmortem (`scripts/flight_dump.py`) has the steps before the
  incident.

Both are host bookkeeping built from values the step already holds on
the host: no launch, no device read. Gated by `ServingEngine(obs=...)` /
`PADDLE_TPU_OBS=on|off` (default on); `PADDLE_TPU_DEBUG=on|off` (default
off) is the HTTP layer's gate for its debug endpoints.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

__all__ = ["EngineObs", "FlightRecorder", "RequestTracer",
           "resolve_obs_flag", "resolve_debug_flag",
           "resolve_flight_steps", "timeline_to_chrome",
           "OBS_ENV", "DEBUG_ENV", "FLIGHT_STEPS_ENV",
           "TERMINAL_EVENTS"]

OBS_ENV = "PADDLE_TPU_OBS"
DEBUG_ENV = "PADDLE_TPU_DEBUG"
FLIGHT_STEPS_ENV = "PADDLE_TPU_FLIGHT_STEPS"

OBS_MODES = ("on", "off")

# terminal timeline event kinds (the engine maps finish reasons:
# stop/length -> "finish", deadline -> "deadline", poisoned ->
# "poison", replica_failure -> "replica_death"; every other reason keeps
# its name). The tracer uses this set to pick eviction victims.
TERMINAL_EVENTS = frozenset({
    "finish", "deadline", "poison", "replica_death", "timeout",
    "cancelled", "aborted", "shed"})


def resolve_obs_flag(override=None) -> bool:
    """Whether the engine records request timelines and flight-recorder
    steps (default on: host-side dict work). An explicit override
    wins; otherwise PADDLE_TPU_OBS=on|off, read at engine
    construction."""
    if override is not None:
        return bool(override)
    v = os.environ.get(OBS_ENV, "on")
    if v not in OBS_MODES:
        raise ValueError(
            f"{OBS_ENV} must be one of {OBS_MODES}, got {v!r}")
    return v == "on"


def resolve_debug_flag(override=None) -> bool:
    """Whether an HTTP server exposes its `/debug/*` introspection
    endpoints (default off: request timelines carry prompt metadata —
    lengths, priorities, request ids). An explicit override wins;
    otherwise PADDLE_TPU_DEBUG=on|off."""
    if override is not None:
        return bool(override)
    v = os.environ.get(DEBUG_ENV, "off")
    if v not in OBS_MODES:
        raise ValueError(
            f"{DEBUG_ENV} must be one of {OBS_MODES}, got {v!r}")
    return v == "on"


def resolve_flight_steps(override=None) -> int:
    """Ring capacity of the flight recorder in engine steps (default
    1024; env PADDLE_TPU_FLIGHT_STEPS)."""
    v = override if override is not None else \
        os.environ.get(FLIGHT_STEPS_ENV, 1024)
    try:
        n = int(v)
    except (TypeError, ValueError):
        raise ValueError(
            f"{FLIGHT_STEPS_ENV} must be an integer >= 1, got {v!r}")
    if n < 1:
        raise ValueError(
            f"{FLIGHT_STEPS_ENV} must be an integer >= 1, got {v!r}")
    return n


class RequestTracer:
    """Bounded per-request event timelines. One instance per engine;
    every mutation and read holds one lock, so a reading thread never
    tears a timeline the pump thread is appending to. Capacity
    is bounded two ways: at most `max_requests` timelines (oldest
    FINISHED timeline evicted first, oldest overall as a last
    resort) and at most `max_events` events per timeline (the tail
    event then carries a `dropped` count instead of growing without
    bound)."""

    def __init__(self, max_requests: int = 512, max_events: int = 512,
                 clock=time.monotonic):
        self.max_requests = int(max_requests)
        self.max_events = int(max_events)
        self._clock = clock
        self._lock = threading.Lock()
        self._timelines: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._finished: set = set()
        self.events_recorded = 0
        self.timelines_evicted = 0

    def record(self, request_id: str, kind: str, *, t: Optional[float]
               = None, step: Optional[int] = None,
               slot: Optional[int] = None, cause: Optional[str] = None,
               **detail):
        ev = {"t": self._clock() if t is None else float(t),
              "kind": str(kind)}
        if step is not None:
            ev["step"] = int(step)
        if slot is not None:
            ev["slot"] = int(slot)
        if cause is not None:
            ev["cause"] = str(cause)
        ev.update(detail)
        with self._lock:
            tl = self._timelines.get(request_id)
            if tl is None:
                self._evict_locked()
                tl = self._timelines[request_id] = []
                # a request id may legitimately come back (a preempted
                # resume, a migrated re-placement): it is live again
                self._finished.discard(request_id)
            if len(tl) >= self.max_events:
                tl[-1]["dropped"] = tl[-1].get("dropped", 0) + 1
            else:
                tl.append(ev)
            self.events_recorded += 1
            if kind in TERMINAL_EVENTS:
                self._finished.add(request_id)

    def _evict_locked(self):
        if len(self._timelines) < self.max_requests:
            return
        victim = next((rid for rid in self._timelines
                       if rid in self._finished), None)
        if victim is None:       # nothing finished: oldest overall
            victim = next(iter(self._timelines))
        del self._timelines[victim]
        self._finished.discard(victim)
        self.timelines_evicted += 1

    def timeline(self, request_id: str) -> Optional[List[dict]]:
        """A copy of one request's ordered events (None = unknown)."""
        with self._lock:
            tl = self._timelines.get(request_id)
            return None if tl is None else [dict(e) for e in tl]

    def request_ids(self) -> List[str]:
        with self._lock:
            return list(self._timelines)

    def stats(self) -> dict:
        with self._lock:
            return {"timelines": len(self._timelines),
                    "finished": len(self._finished),
                    "events_recorded": self.events_recorded,
                    "timelines_evicted": self.timelines_evicted}


class FlightRecorder:
    """The serving black box: a lock-protected ring of the last N
    per-step records plus free-form `note()` entries (fired faults, SLO
    transitions), and a bounded list of incident dumps — each a frozen
    copy of the ring at the moment `incident()` was called, so the steps
    leading up to a death, quarantine or 504 survive the event."""

    MAX_INCIDENTS = 8

    def __init__(self, steps: Optional[int] = None, clock=time.monotonic):
        self.capacity = resolve_flight_steps(steps)
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._incidents: deque = deque(maxlen=self.MAX_INCIDENTS)
        self.steps_recorded = 0
        self.incidents_total = 0

    def on_step(self, record: dict):
        with self._lock:
            self._ring.append(record)
            self.steps_recorded += 1

    def note(self, kind: str, detail=None):
        """Ride a non-step event (an injected fault firing, an SLO
        transition) in the step stream, where a postmortem reads it in
        context. `detail` is stored verbatim; `incident()` freezes the
        notes into the dump with the surrounding steps."""
        with self._lock:
            self._ring.append({"t": self._clock(), "note": str(kind),
                               "detail": detail})

    def incident(self, kind: str, detail: Optional[str] = None,
                 step: Optional[int] = None,
                 slo: Optional[dict] = None) -> dict:
        """Freeze the ring into a dump. Called on the fault and error
        paths: poison quarantine, deadline fail-fast, raising rounds,
        replica death. `slo` (an SLOTracker snapshot) rides in the dump
        so a postmortem shows whether the SLO was already burning."""
        with self._lock:
            dump = {"kind": str(kind), "detail": detail,
                    "t": self._clock(),
                    "step": None if step is None else int(step),
                    "steps": [dict(r) for r in self._ring]}
            if slo is not None:
                dump["slo"] = slo
            self._incidents.append(dump)
            self.incidents_total += 1
            return dump

    def snapshot(self) -> dict:
        """The live ring and every retained incident dump (one
        replica's flight payload, as `scripts/flight_dump.py` reads
        it)."""
        with self._lock:
            return {"capacity": self.capacity,
                    "steps_recorded": self.steps_recorded,
                    "incidents_total": self.incidents_total,
                    "steps": [dict(r) for r in self._ring],
                    "incidents": [
                        {**dict(i), "steps": [dict(r)
                                              for r in i["steps"]]}
                        for i in self._incidents]}


class EngineObs:
    """One engine's observability sink: request tracer and flight
    recorder sharing the engine's clock. `ServingEngine` holds one (or
    None with the gate off) and feeds it from the call sites that drive
    ServingMetrics."""

    def __init__(self, flight_steps: Optional[int] = None,
                 max_requests: int = 512, clock=time.monotonic):
        self._flight_steps = flight_steps
        self._max_requests = int(max_requests)
        self._clock = clock
        self.tracer = RequestTracer(max_requests=self._max_requests,
                                    clock=clock)
        self.flight = FlightRecorder(steps=flight_steps, clock=clock)

    def reset(self):
        """Drop all recorded state (after a warm-up, as
        `metrics.__init__()` does)."""
        self.tracer = RequestTracer(max_requests=self._max_requests,
                                    clock=self._clock)
        self.flight = FlightRecorder(steps=self._flight_steps,
                                     clock=self._clock)

    def stats(self) -> dict:
        return {"tracer": self.tracer.stats(),
                "flight": {"capacity": self.flight.capacity,
                           "steps_recorded": self.flight.steps_recorded,
                           "incidents_total":
                               self.flight.incidents_total}}


# -- Chrome trace export ----------------------------------------------------
# phase-opening event kinds -> the span name drawn until the next
# phase boundary (a terminal event closes whatever is open)
_PHASE_STARTS = {"submit": "queued", "admit": "prefill",
                 "decode": "decode", "preempt": "preempted"}


def timeline_to_chrome(timeline: List[dict],
                       request_id: str = "request") -> dict:
    """One request timeline -> Chrome-trace JSON (openable in Perfetto
    / chrome://tracing) through the profiler's chrome-tracing writer.
    Each replica the request touched (an event's `replica` key, else
    "engine") gets its own tid lane; lifecycle phases (queued /
    prefill / decode / preempted) render as duration spans between
    their boundary events, and every raw event also lands as a
    zero-length marker."""
    from ..profiler import chrome_trace

    events = []           # (name, tid, t0_ns, t1_ns)
    lanes: Dict[str, int] = {}
    per_lane: Dict[str, List[dict]] = {}
    for ev in timeline:
        lane = str(ev.get("replica", "engine"))
        lanes.setdefault(lane, len(lanes) + 1)
        per_lane.setdefault(lane, []).append(ev)
        t = int(ev["t"] * 1e9)
        events.append((f"{ev['kind']}", lanes[lane], t, t))
    for lane, evs in per_lane.items():
        tid = lanes[lane]
        open_name, open_t = None, None
        for ev in evs:
            kind, t = ev["kind"], int(ev["t"] * 1e9)
            boundary = (kind in _PHASE_STARTS
                        or kind in TERMINAL_EVENTS)
            if boundary and open_name is not None:
                events.append((f"{request_id}:{open_name}", tid,
                               open_t, t))
                open_name = None
            if kind in _PHASE_STARTS:
                open_name, open_t = _PHASE_STARTS[kind], t
        if open_name is not None and evs:
            events.append((f"{request_id}:{open_name}", tid, open_t,
                           int(evs[-1]["t"] * 1e9)))
    trace = chrome_trace(events)
    trace["otherData"] = {"request_id": request_id,
                          "replicas": sorted(lanes)}
    return trace
