"""The fleet control plane (counterpart of `paddle_tpu/serving/controlplane.py`):
the SLO tracker's and the cost census's signals become actuators.

Three actuators, all on the host (the unified step never sees the
control plane):

1. **SLO-aware placement**: `Router._load_key` ranks replicas whose burn
   state is `warn` below `ok` and `page` below `warn` (after breaker
   health, before load), so traffic drains away from a burning replica
   before it pages. `placement_avoided_total` counts placements that
   steered around a burning replica.
2. **Reactive autoscaling**: `FleetController` takes the fleet-worst
   burn rate as the scale-up signal and the cost census
   (`flops_per_token` x `achieved_util`) as the capacity model, computes
   a desired replica count, spawns replicas through an injected
   `replica_factory` (`Router.add_replica`) and drains surplus ones over
   the graceful-drain path (`Router.remove_replica`). Hysteresis (the
   scale-down watermark sits below the planning target) and cool-downs
   per direction keep a noisy window from flapping the fleet.
3. **Deadline-aware admission**: `check_admission` sheds at the door
   (HTTP 429 + Retry-After, typed `DeadlineInfeasible`) a request whose
   placement deadline is already infeasible given the queue depth and
   the census-predicted step cost.

Gate: `Router(controller=...)` / PADDLE_TPU_CONTROLPLANE=on|off (default
off; an explicit argument wins). The control plane decides where and
whether work runs, never what it computes: token streams are the same
with it on or off. Every scaling decision lands as a flight-recorder
note on the live replicas.

The decision core (`decide` / `check_admission`) takes an injectable
clock and an explicit `FleetSignals`, so tests drive it without threads.
`observe` reads each replica's census through `cost_census()`; a
driver's pump captures a counted census before its first step
(`serving/http/driver.py`), so the controller thread's read is host-only
and never runs a forward beside the pump.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from .errors import QueueFull
from .slo import SLO_STATE_CODES

__all__ = ["ControlPlaneConfig", "FleetController", "FleetSignals",
           "Decision", "DeadlineInfeasible", "resolve_controlplane",
           "slo_placement_rank", "CONTROLPLANE_ENV"]

CONTROLPLANE_ENV = "PADDLE_TPU_CONTROLPLANE"


class DeadlineInfeasible(QueueFull):
    """Admission shed AT THE DOOR: the request's placement deadline is
    already infeasible given the current backlog and the
    census-predicted step cost, so admitting it would only waste a
    queue slot and KV pages. Subclasses QueueFull, so the HTTP layer's
    existing 429 + Retry-After mapping applies unchanged (the error
    envelope carries type "deadline_infeasible")."""


def slo_placement_rank(state: Optional[str]) -> int:
    """Placement severity of a replica's worst live SLO state: ok(0)
    < warn(1) < page(2). None (SLO tracking off) ranks like ok."""
    return SLO_STATE_CODES.get(state or "ok", 0)


@dataclass(frozen=True)
class ControlPlaneConfig:
    """Fleet sizing targets + decision pacing. `target_util` is the
    planning setpoint (each replica planned at this fraction of its
    census step capacity); `scale_down_util` is the hysteresis
    low-water mark and MUST sit below it — the gap is what keeps a
    boundary-oscillating signal from flapping the fleet."""
    min_replicas: int = 1
    max_replicas: int = 8
    target_util: float = 0.75
    scale_up_burn: float = 2.0          # double-window burn trigger
    scale_down_util: float = 0.45       # hysteresis low-water mark
    scale_up_cooldown_s: float = 15.0
    scale_down_cooldown_s: float = 60.0
    interval_s: float = 0.0             # 0 = manual poll() only
    est_request_tokens: int = 64        # admission backlog estimate
    hw_flops_per_s: float = 5e12        # census flops -> seconds
    admission_slack: float = 1.0        # shed when wait > slack*deadline

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not (0.0 < self.target_util <= 1.0):
            raise ValueError("target_util must be in (0, 1]")
        if not (0.0 <= self.scale_down_util < self.target_util):
            raise ValueError(
                "scale_down_util must be in [0, target_util) — the "
                "hysteresis band between them prevents flapping")
        if self.scale_up_cooldown_s < 0 or self.scale_down_cooldown_s < 0:
            raise ValueError("cool-downs must be >= 0")
        if self.est_request_tokens < 1:
            raise ValueError("est_request_tokens must be >= 1")
        if self.hw_flops_per_s <= 0:
            raise ValueError("hw_flops_per_s must be > 0")
        if self.admission_slack <= 0:
            raise ValueError("admission_slack must be > 0")


_SPEC_KEYS = {
    "min": ("min_replicas", int),
    "max": ("max_replicas", int),
    "target_util": ("target_util", float),
    "up_burn": ("scale_up_burn", float),
    "down_util": ("scale_down_util", float),
    "up_cooldown": ("scale_up_cooldown_s", float),
    "down_cooldown": ("scale_down_cooldown_s", float),
    "interval": ("interval_s", float),
    "est_tokens": ("est_request_tokens", int),
    "hw_flops": ("hw_flops_per_s", float),
    "slack": ("admission_slack", float),
}


def parse_controlplane_spec(spec: str) -> Optional[ControlPlaneConfig]:
    """"off" -> None; "on" -> defaults; else "k=v,k=v" over the keys
    min,max,target_util,up_burn,down_util,up_cooldown,down_cooldown,
    interval,est_tokens,hw_flops,slack."""
    spec = spec.strip()
    if spec in ("off", "0", "false"):
        return None
    if spec in ("on", "1", "true", ""):
        return ControlPlaneConfig()
    fields = {}
    for part in spec.split(","):
        key, sep, val = part.partition("=")
        key = key.strip()
        if not sep or key not in _SPEC_KEYS:
            raise ValueError(
                f"bad {CONTROLPLANE_ENV} spec part {part!r}: expected "
                f"k=v with k in {sorted(_SPEC_KEYS)}")
        name, conv = _SPEC_KEYS[key]
        try:
            fields[name] = conv(val)
        except ValueError:
            raise ValueError(
                f"bad {CONTROLPLANE_ENV} value for {key!r}: {val!r}")
    return ControlPlaneConfig(**fields)


def resolve_controlplane(override=None) -> Optional[ControlPlaneConfig]:
    """The control-plane gate (default OFF). An explicit override wins
    — False/"off" disables, True/"on" enables defaults, a spec string
    or a ControlPlaneConfig configures — otherwise
    PADDLE_TPU_CONTROLPLANE is consulted."""
    if override is not None:
        if override is False:
            return None
        if override is True:
            return ControlPlaneConfig()
        if isinstance(override, ControlPlaneConfig):
            return override
        return parse_controlplane_spec(str(override))
    return parse_controlplane_spec(os.environ.get(CONTROLPLANE_ENV,
                                                  "off"))


@dataclass(frozen=True)
class FleetSignals:
    """One observation of the fleet, the decision core's whole input:
    live replica count, fleet-worst burn rates (both SLO windows),
    mean recent achieved utilization of the unified step, total queue
    backlog, and the census capacity model."""
    replicas: int
    fast_burn: float = 0.0
    slow_burn: float = 0.0
    mean_util: float = 0.0
    queue_depth: int = 0
    capacity_tokens: int = 0
    flops_per_token: float = 0.0
    tokens_per_sec: float = 0.0


@dataclass(frozen=True)
class Decision:
    action: str          # "scale_up" | "scale_down" | "hold"
    desired: int
    reason: str


class FleetController:
    """The decision core + actuator harness. `decide()` is the pure
    part (FleetSignals + injected clock -> Decision, with hysteresis
    and per-direction cool-downs); `poll(router)` observes a live
    Router, decides, and actuates — `add_replica` via the injected
    `replica_factory` on scale-up, `remove_replica` over the graceful
    drain path on scale-down — and drops a flight-recorder note on
    every live replica for each non-hold decision."""

    def __init__(self, config: Optional[ControlPlaneConfig] = None, *,
                 replica_factory: Optional[Callable[[], object]] = None,
                 clock=time.monotonic):
        self.config = config or ControlPlaneConfig()
        self.replica_factory = replica_factory
        self._clock = clock
        self._lock = threading.Lock()
        self.scale_up_total = 0
        self.scale_down_total = 0
        self.admission_shed_total = 0
        self.placement_avoided_total = 0
        self.desired_replicas: Optional[int] = None
        self.decisions = deque(maxlen=128)
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None

    # -- decision core (pure; fake-clock testable) -------------------------
    def desired_from(self, s: FleetSignals) -> int:
        """Census capacity model: live demand in replica-equivalents
        is replicas x mean achieved utilization, plus the queued
        backlog converted through the census step capacity (a backlog
        of k x capacity_tokens wants k more replica-steps right now);
        desired = ceil(demand / target_util), the planning setpoint."""
        cfg = self.config
        demand = s.replicas * max(0.0, s.mean_util)
        if s.queue_depth > 0 and s.capacity_tokens > 0:
            demand += (s.queue_depth * cfg.est_request_tokens
                       / float(s.capacity_tokens))
        raw = math.ceil(demand / cfg.target_util) if demand > 0 else 0
        return min(cfg.max_replicas, max(cfg.min_replicas, raw))

    def decide(self, s: FleetSignals,
               now: Optional[float] = None) -> Decision:
        """One evaluation. Scale-up fires on the DOUBLE-WINDOW burn
        rule (both the fast and slow window past `scale_up_burn` —
        the same multi-window discipline the SLO tracker alerts on)
        or on the capacity model wanting more replicas; scale-down
        only when the fleet is clearly idle (mean util at or under
        the low-water mark, empty queue, no burn) and steps down ONE
        replica at a time. Each direction has its own cool-down, and
        a decision made inside it is held (reason "cooldown")."""
        now = self._clock() if now is None else float(now)
        cfg = self.config
        live = max(0, int(s.replicas))
        desired = self.desired_from(s)
        burn_hot = (s.fast_burn >= cfg.scale_up_burn
                    and s.slow_burn >= cfg.scale_up_burn)
        if burn_hot:
            # the SLO is burning in both windows: add capacity even if
            # the utilization model thinks the fleet is big enough
            desired = max(desired, min(cfg.max_replicas, live + 1))
        if desired > live:
            if (self._last_up_t is not None
                    and now - self._last_up_t < cfg.scale_up_cooldown_s):
                return self._record(Decision(
                    "hold", live,
                    f"cooldown: scaled up "
                    f"{now - self._last_up_t:.1f}s ago"), now)
            self._last_up_t = now
            return self._record(Decision(
                "scale_up", desired,
                "double-window burn" if burn_hot
                else f"util {s.mean_util:.2f} over target"), now)
        if desired < live:
            if (s.mean_util > cfg.scale_down_util or burn_hot
                    or s.queue_depth > 0):
                # hysteresis: between the low-water mark and the
                # planning target the fleet holds — this band is what
                # keeps a boundary-oscillating signal from flapping
                return self._record(Decision("hold", live,
                                             "hysteresis"), now)
            if (self._last_down_t is not None
                    and now - self._last_down_t
                    < cfg.scale_down_cooldown_s):
                return self._record(Decision(
                    "hold", live,
                    f"cooldown: scaled down "
                    f"{now - self._last_down_t:.1f}s ago"), now)
            self._last_down_t = now
            return self._record(Decision(
                "scale_down", live - 1,
                f"idle: util {s.mean_util:.2f} under "
                f"{cfg.scale_down_util}"), now)
        return self._record(Decision("hold", live, "steady"), now)

    def _record(self, d: Decision, now: float) -> Decision:
        with self._lock:
            self.desired_replicas = d.desired
            self.decisions.append({"t": now, "action": d.action,
                                   "desired": d.desired,
                                   "reason": d.reason})
        return d

    # -- deadline-aware admission ------------------------------------------
    def predicted_wait_s(self, s: FleetSignals) -> float:
        """Predicted seconds before a newly queued request starts:
        backlog tokens over the fleet's delivery rate. The measured
        `tokens_per_sec` wins when warm; before any throughput exists
        the census predicts it — step seconds = step flops /
        `hw_flops_per_s`, tokens per step = capacity x achieved util
        (floored at 10%: an idle fleet is about to speed up, not shed
        everything)."""
        backlog = s.queue_depth * self.config.est_request_tokens
        if backlog <= 0:
            return 0.0
        rate = float(s.tokens_per_sec or 0.0)
        if rate <= 0.0 and s.capacity_tokens > 0 \
                and s.flops_per_token > 0:
            step_flops = s.flops_per_token * s.capacity_tokens
            step_s = step_flops / self.config.hw_flops_per_s
            per_step = s.capacity_tokens * max(s.mean_util, 0.1)
            rate = (max(1, s.replicas) * per_step
                    / max(step_s, 1e-9))
        if rate <= 0.0:
            return 0.0          # no model at all: admit
        return backlog / rate

    def check_admission(self, s: FleetSignals,
                        deadline_s: Optional[float]
                        ) -> Optional[float]:
        """None = admit. Otherwise the request's placement deadline is
        infeasible (predicted queue wait > slack x deadline): returns
        the Retry-After hint in seconds and counts the shed."""
        if deadline_s is None:
            return None
        wait = self.predicted_wait_s(s)
        if wait <= float(deadline_s) * self.config.admission_slack:
            return None
        with self._lock:
            self.admission_shed_total += 1
        return max(1.0, wait - float(deadline_s))

    # -- live-fleet observation + actuation --------------------------------
    def observe(self, router) -> FleetSignals:
        """Build FleetSignals from a live Router: fleet-worst burns
        across every live replica's tracker, mean recent achieved
        utilization, total queue backlog, the first available census,
        and the summed measured token rate."""
        live = [d for d in list(router.drivers)
                if d.healthy and not d.draining]
        fast = slow = 0.0
        utils = []
        queue_depth = 0
        capacity = 0
        flops_per_token = 0.0
        tps = 0.0
        for d in live:
            st = d.stats()
            queue_depth += st["queue_depth"]
            burns = st.get("slo_burns")
            if burns:
                fast = max(fast, burns[0])
                slow = max(slow, burns[1])
            u = st.get("util_recent")
            if u is not None:
                utils.append(u)
            m = getattr(d.engine, "metrics", None)
            if m is not None:
                tps += float(getattr(m, "tokens_per_sec", 0.0) or 0.0)
            if not capacity:
                census = d.engine.cost_census()
                if census:
                    capacity = int(census.get("capacity_tokens", 0))
                    flops_per_token = float(
                        census.get("flops_per_token", 0.0))
        return FleetSignals(
            replicas=len(live), fast_burn=fast, slow_burn=slow,
            mean_util=(sum(utils) / len(utils)) if utils else 0.0,
            queue_depth=queue_depth, capacity_tokens=capacity,
            flops_per_token=flops_per_token, tokens_per_sec=tps)

    def poll(self, router) -> Decision:
        """One observe -> decide -> actuate round. Scale-up spawns
        `desired - live` replicas through `replica_factory` (a no-op
        when no factory was injected — placement + admission still
        work, the fleet just can't grow); scale-down gracefully
        drains the least-loaded live replica. The `scale_*_total`
        counters count ACTUATED events."""
        # fleet KV fabric: the poll doubles as the prefix-affinity
        # refresh tick — each live replica's tree summary is re-read
        # so placement ranks against a recent view (stale summaries
        # survive a failed refresh; mis-ranking is the only cost)
        refresh = getattr(router, "refresh_fabric_summaries", None)
        if refresh is not None:
            try:
                refresh()
            except Exception:
                pass
        s = self.observe(router)
        d = self.decide(s)
        if d.action == "scale_up" and self.replica_factory is not None:
            added = 0
            for _ in range(d.desired - s.replicas):
                try:
                    router.add_replica(self.replica_factory())
                    added += 1
                except Exception:
                    break       # factory/registration failure: stop
            if added:
                with self._lock:
                    self.scale_up_total += 1
                self._note(router, "scale_up",
                           {"desired": d.desired, "added": added,
                            "reason": d.reason})
        elif d.action == "scale_down":
            victim = self._pick_victim(router)
            if victim is not None:
                router.remove_replica(victim.name, wait=False)
                with self._lock:
                    self.scale_down_total += 1
                self._note(router, "scale_down",
                           {"desired": d.desired,
                            "victim": victim.name,
                            "reason": d.reason})
        return d

    def _pick_victim(self, router):
        """Least-loaded live replica drains first; never the last."""
        live = [d for d in list(router.drivers)
                if d.healthy and not d.draining]
        if len(live) <= max(1, self.config.min_replicas):
            return None
        return min(live, key=lambda d: (
            d.stats()["residents"], d.stats()["queue_depth"]))

    def _note(self, router, action: str, detail: dict):
        """Drop the decision into every live replica's flight ring —
        notes ride the step stream, so incident dumps freeze the
        control history alongside the SLO state."""
        for d in list(router.drivers):
            if d.dead:
                continue
            obs = getattr(d.engine, "obs", None)
            if obs is not None:
                try:
                    obs.flight.note(f"controlplane:{action}",
                                    dict(detail))
                except Exception:
                    pass

    def on_placement_avoided(self, n: int = 1):
        """Router callback: one placement steered around a burning
        replica (actuator 1's effectiveness counter)."""
        with self._lock:
            self.placement_avoided_total += int(n)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """The `controlplane` block of Router.stats() /
        fleet_snapshot(): the gauge + counters the Prometheus render
        and fleet_top read."""
        with self._lock:
            last = self.decisions[-1] if self.decisions else None
            return {
                "desired_replicas": self.desired_replicas,
                "scale_up_total": self.scale_up_total,
                "scale_down_total": self.scale_down_total,
                "admission_shed_total": self.admission_shed_total,
                "placement_avoided_total": self.placement_avoided_total,
                "last_decision": (None if last is None
                                  else dict(last)),
                "config": {
                    "min_replicas": self.config.min_replicas,
                    "max_replicas": self.config.max_replicas,
                    "target_util": self.config.target_util,
                    "scale_up_burn": self.config.scale_up_burn,
                    "scale_down_util": self.config.scale_down_util,
                },
            }
