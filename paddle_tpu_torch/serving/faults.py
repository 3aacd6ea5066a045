"""Deterministic fault injection for the serving stack (counterpart of
`paddle_tpu/serving/faults.py`).

`FaultInjector` is a seedable, deterministic source of the failure
shapes a replica sees, wired in through host-side hooks only (never into
a launch):

- **kill**: the replica's pump thread raises `InjectedFault` at a chosen
  step boundary and takes the replica-death path (`EngineDriver` calls
  `on_step` once per engine step);
- **hang**: the pump thread blocks at a step boundary for a chosen
  duration and its heartbeat goes stale (`release_hangs()` cuts a hang
  short from another thread);
- **fail add_request**: the K-th admission on a replica (or globally)
  raises (`EngineDriver` calls `on_add_request` before
  `engine.add_request`);
- **poison**: any engine round that includes a chosen request id raises
  before the round's first launch, deterministically, so the engine's
  quarantine bisection can isolate it (`ServingEngine.step_fault_hook`
  calls `on_engine_step` with the round's participant ids);
- **overload spike**: at a chosen step boundary the replica's driver
  injects a burst of N synthetic low-priority requests through the real
  admission path (`take_spike`).

All hooks are cheap no-ops when nothing is scheduled. `PADDLE_TPU_FAULTS`
(parsed by `resolve_faults`) describes a schedule without code:

    PADDLE_TPU_FAULTS="kill:replica-0@40;hang:replica-1@10x5.0;
                       fail_add:3;fail_add:replica-0@7;poison:req-9;
                       spike:replica-0@20x8"

`chaos_schedule` derives a random but reproducible kill/hang schedule
from the injector's seed (`random.Random(seed)`, so a seed gives the same
schedule as the JAX package's), always leaving `keep_alive` replicas
untouched by lethal faults.
"""
from __future__ import annotations

import os
import random
import threading
from typing import Dict, List, Optional, Sequence

from .errors import ServingError

__all__ = ["InjectedFault", "FaultInjector", "resolve_faults",
           "FAULTS_ENV"]

FAULTS_ENV = "PADDLE_TPU_FAULTS"

_ANY = "*"          # scope wildcard: matches every replica


class InjectedFault(ServingError):
    """A fault thrown by `FaultInjector` (never by real hardware).

    Subclasses ServingError, so an injected add_request failure reads
    like any other replica-side refusal. `kind` is one of "kill" |
    "hang" | "add_request" | "poison".
    """

    def __init__(self, message: str, kind: str = "kill",
                 request_id: Optional[str] = None):
        super().__init__(message)
        self.kind = kind
        self.request_id = request_id


class FaultInjector:
    """Seedable, deterministic fault source. All scheduling and hook
    methods are thread-safe; hooks fire in the thread that calls them
    (the pump thread for kill/hang, the driver thread for add_request,
    the engine's stepping thread for poison)."""

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self._unhang = threading.Event()
        # scope -> sorted step thresholds still pending
        self._kills: Dict[str, List[int]] = {}
        # scope -> [(step, duration_s)] still pending
        self._hangs: Dict[str, List[tuple]] = {}
        # scope -> [(step, n_requests)] still pending
        self._spikes: Dict[str, List[tuple]] = {}
        # scope -> set of 1-based admission ordinals that fail
        self._fail_adds: Dict[str, set] = {}
        self._adds_seen: Dict[str, int] = {}
        self._poisoned: set = set()
        # observability (tests / bench assertions)
        self.kills_fired = 0
        self.hangs_fired = 0
        self.add_fails_fired = 0
        self.poison_hits = 0
        self.spikes_fired = 0
        # fired-fault listeners (serving/obs.py): each fn(kind,
        # replica, detail) is called — outside the lock, exceptions
        # swallowed — whenever a scheduled fault fires, so a replica's
        # flight recorder shows the fault in its step stream
        self._listeners: List = []

    def subscribe(self, fn) -> "FaultInjector":
        """Register fn(kind, replica, detail) to be told when any
        fault fires (EngineDriver subscribes the replica's flight
        recorder)."""
        with self._lock:
            self._listeners.append(fn)
        return self

    def _notify(self, kind: str, replica: str, detail: str):
        for fn in list(self._listeners):
            try:
                fn(kind, replica, detail)
            except Exception:
                pass            # a broken listener must not mask the fault

    # -- scheduling --------------------------------------------------------
    def kill_at_step(self, replica: str, step: int) -> "FaultInjector":
        """The replica's pump raises at its first step boundary with
        index >= `step` (so 0 means "next boundary"). One-shot."""
        with self._lock:
            self._kills.setdefault(replica, []).append(int(step))
            self._kills[replica].sort()
        return self

    def hang_at_step(self, replica: str, step: int,
                     duration_s: float) -> "FaultInjector":
        """The replica's pump blocks for `duration_s` at its first
        step boundary with index >= `step` — a hung step: no raise, no
        heartbeat, exactly what the watchdog exists for. One-shot;
        `release_hangs()` ends every in-progress and future hang."""
        with self._lock:
            self._hangs.setdefault(replica, []).append(
                (int(step), float(duration_s)))
            self._hangs[replica].sort()
        return self

    def spike_at_step(self, replica: str, step: int,
                      n: int) -> "FaultInjector":
        """Inject an OVERLOAD SPIKE: at the replica's first step
        boundary with index >= `step`, its driver submits `n`
        synthetic low-priority junk requests through the real
        admission path (see `EngineDriver`). One-shot."""
        if n < 1:
            raise ValueError("spike size must be >= 1")
        with self._lock:
            self._spikes.setdefault(replica, []).append(
                (int(step), int(n)))
            self._spikes[replica].sort()
        return self

    def take_spike(self, replica: str, step: int) -> int:
        """Driver hook: the number of junk requests to inject at this
        boundary (0 almost always)."""
        with self._lock:
            due = self._pop_due(self._spikes, replica, step)
            if due is not None:
                self.spikes_fired += 1
        if due is not None:
            self._notify("spike", replica,
                         f"{due[1]} junk requests at step {step}")
        return 0 if due is None else due[1]

    def fail_add_request(self, k: int,
                         replica: str = _ANY) -> "FaultInjector":
        """The K-th (1-based) add_request serviced on `replica` (or
        counted across all replicas for the default wildcard scope)
        raises InjectedFault instead of reaching the engine."""
        if k < 1:
            raise ValueError("k is a 1-based admission ordinal")
        with self._lock:
            self._fail_adds.setdefault(replica, set()).add(int(k))
        return self

    def poison(self, request_id: str) -> "FaultInjector":
        """Every engine round that includes `request_id` raises before
        its first launch: the deterministic request-kills-the-step shape
        quarantine bisection isolates. Stays in effect until
        `clear_poison`."""
        with self._lock:
            self._poisoned.add(request_id)
        return self

    def clear_poison(self, request_id: str):
        with self._lock:
            self._poisoned.discard(request_id)

    def release_hangs(self):
        """Cut every in-progress hang short and disarm future ones
        from blocking (they still count as fired)."""
        self._unhang.set()

    def chaos_schedule(self, replicas: Sequence[str], *,
                       kills: int = 1, hangs: int = 1,
                       hang_s: float = 2.0, max_step: int = 400,
                       keep_alive: int = 1) -> List[str]:
        """Derive a reproducible random fault schedule from the
        injector's seed: `kills` pump kills and `hangs` hung steps
        spread over random step indices in [1, max_step), with at
        least `keep_alive` replicas never receiving a lethal fault.
        Returns human-readable event strings."""
        names = list(replicas)
        self.rng.shuffle(names)
        lethal_pool = names[:max(0, len(names) - keep_alive)]
        events = []
        for _ in range(kills):
            if not lethal_pool:
                break
            victim = lethal_pool.pop(self.rng.randrange(len(lethal_pool)))
            step = self.rng.randrange(1, max_step)
            self.kill_at_step(victim, step)
            events.append(f"kill:{victim}@{step}")
        for _ in range(hangs):
            if not lethal_pool:
                break
            victim = lethal_pool.pop(self.rng.randrange(len(lethal_pool)))
            step = self.rng.randrange(1, max_step)
            self.hang_at_step(victim, step, hang_s)
            events.append(f"hang:{victim}@{step}x{hang_s}")
        return events

    # -- hooks (called by the serving stack) -------------------------------
    def _pop_due(self, table: Dict[str, list], replica: str, step: int):
        """First scheduled entry (for `replica` or the wildcard) whose
        step threshold has been reached, removed from the table."""
        for scope in (replica, _ANY):
            pending = table.get(scope)
            if pending and _step_of(pending[0]) <= step:
                return pending.pop(0)
        return None

    def on_step(self, replica: str, step: int):
        """Pump-thread hook, once per engine step boundary. Hangs
        fire before kills scheduled at the same boundary (a hang
        followed by a watchdog condemnation is the interesting
        order)."""
        with self._lock:
            hang = self._pop_due(self._hangs, replica, step)
            kill = self._pop_due(self._kills, replica, step)
            if hang is not None:
                self.hangs_fired += 1
            if kill is not None:
                self.kills_fired += 1
        if hang is not None:
            self._notify("hang", replica,
                         f"step {step} hangs {hang[1]}s")
            self._unhang.wait(hang[1])
        if kill is not None:
            self._notify("kill", replica, f"pump raises at step {step}")
            raise InjectedFault(
                f"injected kill of {replica} at step {step}",
                kind="kill")

    def on_add_request(self, replica: str,
                       request_id: Optional[str] = None):
        """Driver-thread hook, before each engine.add_request."""
        with self._lock:
            fire = False
            for scope in (replica, _ANY):
                seen = self._adds_seen.get(scope, 0) + 1
                self._adds_seen[scope] = seen
                if seen in self._fail_adds.get(scope, ()):
                    fire = True
            if fire:
                self.add_fails_fired += 1
        if fire:
            self._notify("add_request", replica,
                         f"admission of {request_id!r} fails")
            raise InjectedFault(
                f"injected add_request failure on {replica}",
                kind="add_request", request_id=request_id)

    def on_engine_step(self, replica: str,
                       request_ids: Sequence[str]):
        """Engine-round hook (ServingEngine.step_fault_hook), before
        each round's first launch, with the round's participant ids."""
        with self._lock:
            hit = next((r for r in request_ids if r in self._poisoned),
                       None)
            if hit is not None:
                self.poison_hits += 1
        if hit is not None:
            self._notify("poison", replica,
                         f"request {hit} kills the step")
            raise InjectedFault(
                f"injected poison: request {hit} kills the step on "
                f"{replica}", kind="poison", request_id=hit)

    # -- env wiring --------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultInjector":
        """Build an injector from a `PADDLE_TPU_FAULTS` spec string:
        ';'-separated events — `kill:<replica>@<step>`,
        `hang:<replica>@<step>x<seconds>`, `fail_add:<k>` or
        `fail_add:<replica>@<k>`, `poison:<request_id>`,
        `spike:<replica>@<step>xN` (overload burst of N junk
        requests), `seed:<int>` (applies to chaos_schedule draws)."""
        inj = cls()
        for raw in spec.split(";"):
            item = raw.strip()
            if not item:
                continue
            try:
                kind, _, rest = item.partition(":")
                if kind == "seed":
                    inj.rng = random.Random(int(rest))
                elif kind == "kill":
                    replica, _, step = rest.rpartition("@")
                    inj.kill_at_step(replica, int(step))
                elif kind == "hang":
                    replica, _, tail = rest.rpartition("@")
                    step, _, dur = tail.partition("x")
                    inj.hang_at_step(replica, int(step),
                                     float(dur or 1.0))
                elif kind == "fail_add":
                    if "@" in rest:
                        replica, _, k = rest.rpartition("@")
                        inj.fail_add_request(int(k), replica)
                    else:
                        inj.fail_add_request(int(rest))
                elif kind == "spike":
                    replica, _, tail = rest.rpartition("@")
                    step, _, n = tail.partition("x")
                    inj.spike_at_step(replica, int(step), int(n or 1))
                elif kind == "poison":
                    inj.poison(rest)
                else:
                    raise ValueError(f"unknown fault kind {kind!r}")
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"bad {FAULTS_ENV} event {item!r}: {e}") from e
        return inj


def _step_of(entry):
    return entry[0] if isinstance(entry, tuple) else entry


def resolve_faults(spec: Optional[str] = None
                   ) -> Optional[FaultInjector]:
    """The schedule gate: an explicit spec wins, else
    `PADDLE_TPU_FAULTS`; unset or empty means no injector (and no hook
    is installed)."""
    if spec is None:
        spec = os.environ.get(FAULTS_ENV, "")
    spec = spec.strip()
    return FaultInjector.parse(spec) if spec else None
