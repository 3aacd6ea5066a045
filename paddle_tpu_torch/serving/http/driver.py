"""EngineDriver: one thread owns one ServingEngine (counterpart of
`paddle_tpu/serving/http/driver.py`).

The engine's step is single-threaded by construction: every membership
change happens between steps. The driver keeps that invariant under
concurrent clients: every mutation (add_request, cancel, drain) funnels
through a thread-safe inbox that the driver's pump thread services
between steps, so the engine keeps stepping while any number of threads
submit and stream. Tokens fan back out through each Request's own
stream queue (`Request.next_event`); the driver never blocks on a slow
reader.

The pump thread owns the card: it makes the engine's device its current
CUDA device before its first step, so the kernels launch on that
thread's current stream of the engine's device (`ops.cuda._build.
stream_ptr`). The kernels' launch counters are module globals: the counts
of engines stepped concurrently by several drivers interleave.

Failure semantics: if the pump thread raises (a device error, an
injected fault), the driver marks itself dead, fails pending
submissions with `ReplicaDead`, and force-retires every resident and
queued request with finish reason "replica_failure" (freeing its pages),
after freezing the engine's flight ring into a "replica_death"
incident. If the pump thread hangs instead, the heartbeat (`last_beat`,
stamped at every pump iteration and, through the engine's
`heartbeat_hook`, around each round's launches) goes stale and a
watchdog calls `condemn()`, which takes the same death path from outside
and leaves a pending raise for the wedged thread in case it wakes. A
request the engine's quarantine identified as poison fails alone with
reason "poisoned".

Fault injection (`serving/faults.py`): construct with `faults=` to route
every step boundary through `FaultInjector.on_step` (kills, hangs,
spikes through `take_spike`), every admission through `on_add_request`,
and every engine round through the engine's `step_fault_hook` (poison);
a fault that fires is noted in the engine's flight ring. Without an
injector none of the hooks exist.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..errors import EngineClosed, ServingError
from ..request import Request, SamplingParams

__all__ = ["EngineDriver", "ReplicaDead", "ReplicaHung"]


class ReplicaDead(ServingError):
    """The replica's driver thread is gone; resubmit elsewhere."""


class ReplicaHung(ReplicaDead):
    """The replica's pump stopped beating (wedged step, not a raise);
    the watchdog condemned it."""


class _Submission:
    __slots__ = ("prompt_ids", "sampling", "request_id", "done",
                 "request", "error")

    def __init__(self, prompt_ids, sampling, request_id):
        self.prompt_ids = prompt_ids
        self.sampling = sampling
        self.request_id = request_id
        self.done = threading.Event()
        self.request: Optional[Request] = None
        self.error: Optional[BaseException] = None


class _Call:
    """An arbitrary engine function waiting for the driver thread (the
    same between-steps guarantee the submission inbox gives
    mutations)."""

    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class EngineDriver:
    """Pump thread + thread-safe intake for one ServingEngine replica."""

    def __init__(self, engine, name: str = "replica-0", *,
                 poll_interval_s: float = 0.002,
                 submit_timeout_s: float = 30.0,
                 faults=None, condemn_grace_s: float = 1.0,
                 watchdog_grace_per_token_s: float = 0.02):
        self.engine = engine
        self.name = name
        self.poll_interval_s = float(poll_interval_s)
        self.submit_timeout_s = float(submit_timeout_s)
        self.condemn_grace_s = float(condemn_grace_s)
        self.watchdog_grace_per_token_s = float(
            watchdog_grace_per_token_s)
        self._inbox: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._ready = threading.Event()
        self._started = False
        self._draining = False
        self._dead = False
        self.death_exc: Optional[BaseException] = None
        self._fault: Optional[BaseException] = None
        self.last_beat: Optional[float] = None
        self.steps = 0            # engine steps completed by the pump
        # serializes engine mutation between the pump thread and an
        # external condemn(): the pump holds it around inbox service +
        # engine.step(); condemn() takes it (bounded wait) before
        # abort_all so a live pump is never raced mid-step. A truly
        # wedged pump blocks in the faults hook or a launch, which run
        # outside or under it — hence the bounded wait.
        self._mutate_lock = threading.RLock()
        self._death_lock = threading.Lock()
        self._faults = faults
        # the engine beats the heartbeat at every step boundary and
        # around each round's launches (not just once per pump
        # iteration), so a pump grinding through a long multi-part
        # round is never mistaken for a hang
        engine.heartbeat_hook = self._on_beat
        if faults is not None:
            # poison path: the engine calls this with each round's
            # participant request ids before the round's first launch
            engine.step_fault_hook = (
                lambda ids, _f=faults, _n=name: _f.on_engine_step(_n,
                                                                  ids))
            # flight-recorder note: a fault that FIRES on this replica
            # lands in its step stream, so the postmortem dump shows
            # the injected kill/hang/poison in context
            if hasattr(faults, "subscribe"):
                faults.subscribe(self._on_fault_fired)
        self._thread = threading.Thread(target=self._pump,
                                        name=f"engine-driver[{name}]",
                                        daemon=True)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "EngineDriver":
        if not self._started:
            self._started = True
            self._thread.start()
            # a counted census is a forward on the device: the pump
            # captures it before its first step, and start() returns only
            # then, so no other thread's census read ever runs it
            self._ready.wait()
        return self

    @property
    def started(self) -> bool:
        return self._started

    def _on_beat(self):
        self.last_beat = time.monotonic()

    def _on_fault_fired(self, kind: str, replica: str, detail):
        if replica != self.name:
            return
        obs = getattr(self.engine, "obs", None)
        if obs is not None:
            obs.flight.note(f"fault:{kind}", detail)

    @property
    def watchdog_grace_s(self) -> float:
        """Extra heartbeat staleness a watchdog tolerates for this
        replica now, scaled with the tokens packed into the launch in
        flight: a legitimately huge unified verify/prefill step is slow,
        not dead. 0 between launches."""
        return self.watchdog_grace_per_token_s * float(
            getattr(self.engine, "step_tokens_inflight", 0) or 0)

    @property
    def dead(self) -> bool:
        return self._dead

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def healthy(self) -> bool:
        """Liveness probe: accepting work and the pump thread exists.
        A condemned-but-wedged pump (thread alive, `dead` set) is NOT
        healthy."""
        return (self._started and not self._dead and not self._draining
                and self._thread.is_alive())

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting (pending submissions fail
        with EngineClosed), let the engine finish its residents, then
        join the pump thread. Returns True once the thread exited."""
        if not self._started:
            self._draining = True
            return True
        self._draining = True
        self._wake.set()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def kill(self, exc: Optional[BaseException] = None):
        """Fault injection (tests / chaos): the pump thread raises at
        its next step boundary and takes the replica-death path."""
        self._fault = exc or RuntimeError(f"{self.name}: injected fault")
        self._wake.set()

    def condemn(self, exc: Optional[BaseException] = None):
        """Declare this replica dead from outside the pump thread —
        the watchdog path for a hung step (a raised step takes the
        death path through the pump itself). Marks the driver dead,
        fails pending submissions, and force-retires residents with
        reason "replica_failure" so their clients migrate; a pending
        raise is left for the wedged pump in case it ever wakes (it
        then exits without touching the engine again). Best-effort
        mutual exclusion: waits up to `condemn_grace_s` for the step
        lock so a merely-slow pump is never raced mid-step; a truly
        wedged thread holds nothing and we proceed."""
        exc = exc or ReplicaHung(f"{self.name}: heartbeat stale")
        self._fault = exc
        self._wake.set()
        got = self._mutate_lock.acquire(timeout=self.condemn_grace_s)
        try:
            self._do_die(exc)
        finally:
            if got:
                self._mutate_lock.release()

    # -- client-thread API -------------------------------------------------
    def submit(self, prompt_ids, sampling: Optional[SamplingParams] = None,
               request_id: Optional[str] = None) -> Request:
        """Thread-safe add_request: enqueue for the driver thread and
        wait for the engine's verdict. Raises QueueFull / EngineClosed /
        ValueError exactly as engine.add_request would, or ReplicaDead
        if the pump thread is gone."""
        if self._dead:
            raise ReplicaDead(f"{self.name} is dead") \
                from self.death_exc
        if self._draining or not self._started:
            raise EngineClosed(f"{self.name} is not accepting requests")
        sub = _Submission(prompt_ids, sampling, request_id)
        self._inbox.put(("submit", sub))
        self._wake.set()
        deadline = time.monotonic() + self.submit_timeout_s
        while not sub.done.wait(timeout=0.05):
            if self._dead:
                # one last grace period for _fail_pending to resolve it
                if not sub.done.wait(timeout=0.1):
                    raise ReplicaDead(f"{self.name} died mid-submit") \
                        from self.death_exc
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.name}: submission not serviced within "
                    f"{self.submit_timeout_s}s")
        if sub.error is not None:
            raise sub.error
        return sub.request

    def cancel(self, request_id: str):
        """Thread-safe engine.cancel (fire-and-forget: the eviction
        happens at the driver's next step boundary)."""
        if self._dead:
            return
        self._inbox.put(("cancel", request_id))
        self._wake.set()

    def call(self, fn, timeout: Optional[float] = None):
        """Run `fn(engine)` on the driver thread between steps and
        return its result — thread-safe engine access for everything
        that is not a submission. On a driver whose pump is not running
        (never started, or already drained and joined) the call runs
        inline under the mutate lock — the single-threaded invariant
        holds either way.
        Raises whatever `fn` raises, ReplicaDead if the replica is
        gone, EngineClosed if it drains before servicing."""
        if self._dead:
            raise ReplicaDead(f"{self.name} is dead") \
                from self.death_exc
        if not self._started or not self._thread.is_alive():
            with self._mutate_lock:
                return fn(self.engine)
        c = _Call(fn)
        self._inbox.put(("call", c))
        self._wake.set()
        wait_s = self.submit_timeout_s if timeout is None else timeout
        if not c.done.wait(wait_s):
            raise TimeoutError(
                f"{self.name}: call not serviced within {wait_s}s")
        if c.error is not None:
            raise c.error
        return c.result

    def stats(self) -> dict:
        """Racy-but-consistent-enough load snapshot for placement (every
        field is a single atomic read)."""
        eng = self.engine
        queued = eng.scheduler.queue_depth
        residents = len(eng.scheduler.running)
        return {
            "name": self.name,
            "healthy": self.healthy,
            "dead": self._dead,
            "draining": self._draining,
            "queue_depth": queued,
            "residents": residents,
            "free_pages": eng.pool.free_pages,
            "inflight": queued + residents + self._inbox.qsize(),
            "steps": self.steps,
            "last_beat": self.last_beat,
            # device-resident adapter ids (multi-tenant LoRA): a
            # placement affinity signal — hot beats cold
            "adapters_hot": (sorted(eng.adapters.hot_ids())
                             if eng.adapters is not None else []),
            # worst live SLO alert state (serving/slo.py; None = SLO
            # tracking off)
            "slo_state": (eng.slo.worst_state()
                          if getattr(eng, "slo", None) is not None
                          else None),
            # worst (fast, slow) burn rates and recent achieved
            # utilization: a control plane's scale signals
            "slo_burns": (eng.slo.worst_burns()
                          if getattr(eng, "slo", None) is not None
                          else None),
            "util_recent": (eng.metrics.achieved_util_recent
                            if getattr(eng, "metrics", None) is not None
                            else None),
        }

    # -- pump thread -------------------------------------------------------
    def _pump(self):
        try:
            device = getattr(self.engine, "device", None)
            if device is not None and device.type == "cuda":
                # the current device is per thread: this one owns the card
                torch.cuda.set_device(device)
            if getattr(self.engine, "_census_counted", False):
                with self._mutate_lock:
                    self.engine.cost_census()
            self._ready.set()
            while True:
                if self._fault is not None:
                    raise self._fault
                spike_n = 0
                if self._faults is not None:
                    # may sleep (hung step) or raise (injected kill);
                    # runs outside the mutate lock so a watchdog can
                    # condemn and reclaim the engine while we are
                    # wedged right here
                    self._faults.on_step(self.name, self.steps)
                    if self._fault is not None:
                        raise self._fault
                    spike_n = self._faults.take_spike(self.name,
                                                      self.steps)
                if self._draining:
                    self._fail_pending(EngineClosed(
                        f"{self.name} draining"))
                    with self._mutate_lock:
                        self.engine.drain()
                    return
                worked = False
                with self._mutate_lock:
                    if self._dead:
                        # condemned while wedged: the watchdog already
                        # reclaimed the engine; just exit
                        return
                    if spike_n:
                        self._inject_spike(spike_n)
                    self._service_inbox()
                    if self.engine.has_work:
                        self.engine.step()
                        self.steps += 1
                        worked = True
                if not worked:
                    self._wake.wait(self.poll_interval_s)
                    self._wake.clear()
                self.last_beat = time.monotonic()
        except BaseException as exc:   # replica death path
            self._do_die(exc)
        finally:
            self._ready.set()
            self._stopped.set()

    def _inject_spike(self, n: int):
        """Overload-spike fault (serving/faults.py): submit `n`
        synthetic junk requests at the lowest priority through the real
        admission path — they queue behind every real request, and any
        that the queue sheds (QueueFull) simply vanish."""
        for _ in range(n):
            try:
                self.engine.add_request(
                    np.array([1, 2, 3], np.int64),
                    SamplingParams(max_new_tokens=4,
                                   priority=1 << 16))
            except Exception:
                break

    def _service_inbox(self):
        while True:
            try:
                kind, payload = self._inbox.get_nowait()
            except queue.Empty:
                return
            if kind == "submit":
                try:
                    if self._faults is not None:
                        self._faults.on_add_request(self.name,
                                                    payload.request_id)
                    payload.request = self.engine.add_request(
                        payload.prompt_ids, payload.sampling,
                        request_id=payload.request_id)
                except BaseException as e:
                    payload.error = e
                finally:
                    payload.done.set()
            elif kind == "cancel":
                self.engine.cancel(payload)
            elif kind == "call":
                try:
                    payload.result = payload.fn(self.engine)
                except BaseException as e:
                    payload.error = e
                finally:
                    payload.done.set()

    def _fail_pending(self, exc: BaseException):
        while True:
            try:
                kind, payload = self._inbox.get_nowait()
            except queue.Empty:
                return
            if kind in ("submit", "call"):
                payload.error = exc
                payload.done.set()

    def _do_die(self, exc: BaseException):
        """Idempotent death: exactly one caller (the raising pump OR a
        condemning watchdog) marks the replica dead, fails pending
        submissions, and force-retires every request (freeing pages,
        waking every reader with reason "replica_failure": the signal
        a router's failover keys on)."""
        with self._death_lock:
            if self._dead:
                return
            self.death_exc = exc
            self._dead = True
        # freeze the flight recorder first: the ring's last N steps
        # are the postmortem; abort_all below only adds teardown.
        # The final SLO state rides in the dump.
        obs = getattr(self.engine, "obs", None)
        if obs is not None:
            try:
                slo = getattr(self.engine, "slo", None)
                obs.flight.incident(
                    "replica_death", detail=repr(exc),
                    slo=None if slo is None else slo.snapshot())
            except Exception:
                pass
        self._fail_pending(ReplicaDead(f"{self.name} died: {exc!r}"))
        try:
            self.engine.abort_all("replica_failure")
        except BaseException:
            pass
