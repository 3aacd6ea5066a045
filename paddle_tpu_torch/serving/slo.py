"""Fleet SLO tracking and the step cost census (counterpart of
`paddle_tpu/serving/slo.py`).

- **SLOTracker**: burn-rate evaluation of three service-level objectives
  against sliding multi-window (fast/slow) views of the event stream:
  TTFT p99 <= target, inter-token p99 <= target, and deadline goodput >=
  target. Each SLO has an error budget (1% of events for a p99 latency
  target, 1 - g for a goodput target g); the burn rate is the observed
  bad-event fraction over that budget. A state escalates (`ok | warn |
  page`) only when both the fast and the slow window burn past the
  threshold, and de-escalates as soon as the fast window recovers.
  Windows are fixed-bucket rings (O(1) per event), the clock is
  injectable, and every SLO is tracked per priority class and per
  adapter id beside the aggregate, with capped label spaces. State
  transitions are kept in a bounded ring and handed to a callback: the
  engine notes them in the flight recorder.

- **Cost census**: one record per step shape, the FLOPs and bytes of
  the unified step's program capacity ([num_slots, chunk_len] tokens),
  gated by `PADDLE_TPU_COST_CENSUS=off|model|lowered|xla` (default
  "model"). "model" is the analytical estimate from the engine's
  geometry (`model_cost_census`, the JAX package's arithmetic). The JAX
  package asks XLA's cost analysis of the compiled step for "lowered"
  and "xla"; an eager port has no compiled program, and its "lowered"
  and executed programs are the same ops, so both modes count one
  forward of the unified step at its full shape, every row aimed at the
  trash page (`ops.cuda.cost.count_cost`: torch ops by
  `torch.utils.flop_counter`'s FLOPs and their operands' and results'
  bytes, each hand-written kernel by its wrapper's own reckoning), and
  `source` names the mode asked for. Where the count cannot be taken
  the record is the "model" one and says so. The census is captured at
  most once per engine and anchors `achieved_util` (packed tokens per
  step over capacity tokens) in every flight record.

Both halves are host bookkeeping on numbers the engine already holds.
"""
from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from ..ops.cuda.cost import count_cost

__all__ = ["SLOConfig", "SLOTracker", "resolve_slo_config",
           "resolve_cost_census", "model_cost_census",
           "capture_cost_census", "parse_slo_spec", "SLO_ENV",
           "COST_CENSUS_ENV", "COST_CENSUS_MODES", "SLO_STATE_CODES",
           "SLO_NAMES"]

SLO_ENV = "PADDLE_TPU_SLO"
COST_CENSUS_ENV = "PADDLE_TPU_COST_CENSUS"

# alert severity order (the Prometheus slo_state gauge value)
SLO_STATE_CODES = {"ok": 0, "warn": 1, "page": 2}

# the three objectives the tracker evaluates; latency SLOs are p99
# targets (budget = 1% of events may exceed), goodput is a fraction
# target (budget = 1 - target)
SLO_NAMES = ("ttft_p99", "itl_p99", "goodput")


@dataclass(frozen=True)
class SLOConfig:
    """Targets and window/alert geometry. The defaults are deliberately
    generous (an interactive-chat shape): tighten them per deployment
    via PADDLE_TPU_SLO / ServingEngine(slo="...")."""
    ttft_p99_s: float = 2.0        # 99% of first tokens within this
    itl_p99_s: float = 0.5         # 99% of inter-token gaps within
    goodput: float = 0.99          # fraction of deadlines met
    fast_window_s: float = 60.0    # detection window
    slow_window_s: float = 600.0   # confirmation window
    warn_burn: float = 2.0         # burn rate that flips ok -> warn
    page_burn: float = 10.0        # burn rate that flips -> page
    min_events: int = 20           # fast-window events before alerting
    buckets_per_window: int = 12   # ring granularity (fixed buckets)

    def budget(self, slo: str) -> float:
        """Error budget: the bad-event fraction that exactly meets the
        SLO (burn rate = observed bad fraction / budget)."""
        if slo == "goodput":
            return max(1e-9, 1.0 - self.goodput)
        return 0.01                 # p99 latency targets

    def target(self, slo: str) -> float:
        return {"ttft_p99": self.ttft_p99_s, "itl_p99": self.itl_p99_s,
                "goodput": self.goodput}[slo]


_SPEC_KEYS = {
    "ttft_p99": ("ttft_p99_s", float),
    "itl_p99": ("itl_p99_s", float),
    "goodput": ("goodput", float),
    "fast": ("fast_window_s", float),
    "slow": ("slow_window_s", float),
    "warn": ("warn_burn", float),
    "page": ("page_burn", float),
    "min_events": ("min_events", int),
}


def parse_slo_spec(spec: str) -> Optional[SLOConfig]:
    """"off" -> None; "on"/"" -> defaults; otherwise a comma-separated
    k=v list over {ttft_p99, itl_p99, goodput, fast, slow, warn, page,
    min_events} layered over the defaults, e.g.
    "ttft_p99=0.25,itl_p99=0.05,goodput=0.995,fast=30"."""
    spec = spec.strip()
    if spec == "off":
        return None
    cfg = SLOConfig()
    if spec in ("", "on"):
        return cfg
    kv = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(
                f"{SLO_ENV}: expected k=v, got {part!r} in {spec!r}")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in _SPEC_KEYS:
            raise ValueError(
                f"{SLO_ENV}: unknown key {k!r} (known: "
                f"{sorted(_SPEC_KEYS)})")
        field, typ = _SPEC_KEYS[k]
        kv[field] = typ(v)
    cfg = replace(cfg, **kv)
    if not (0.0 < cfg.goodput < 1.0):
        raise ValueError(
            f"{SLO_ENV}: goodput target must be in (0, 1), got "
            f"{cfg.goodput}")
    return cfg


def resolve_slo_config(override=None) -> Optional[SLOConfig]:
    """The engine's SLO gate (default on with the generous defaults:
    host arithmetic). An explicit override wins: False/"off" disables,
    True/None defers to PADDLE_TPU_SLO (a spec string, "on", or "off"),
    an SLOConfig or spec string is used directly."""
    if isinstance(override, SLOConfig):
        return override
    if override is False:
        return None
    if isinstance(override, str):
        return parse_slo_spec(override)
    return parse_slo_spec(os.environ.get(SLO_ENV, "on"))


class _BurnWindow:
    """Fixed-bucket sliding window of good/bad event counts with
    running totals: observe() and totals() are O(1) per call (bucket
    rotation is amortized O(1) and clamped to one full clear on a
    long idle gap). Bucket index is absolute (now // bucket_s), so an
    injected fake clock drives it deterministically."""

    __slots__ = ("bucket_s", "n", "good", "bad", "good_total",
                 "bad_total", "_cur")

    def __init__(self, window_s: float, n_buckets: int):
        self.n = max(1, int(n_buckets))
        self.bucket_s = float(window_s) / self.n
        self.good = [0] * self.n
        self.bad = [0] * self.n
        self.good_total = 0
        self.bad_total = 0
        self._cur: Optional[int] = None

    def _advance(self, now: float):
        idx = int(now / self.bucket_s)
        if self._cur is None or idx <= self._cur:
            if self._cur is None:
                self._cur = idx
            return
        if idx - self._cur >= self.n:       # idle longer than window
            self.good = [0] * self.n
            self.bad = [0] * self.n
            self.good_total = self.bad_total = 0
            self._cur = idx
            return
        while self._cur < idx:
            self._cur += 1
            s = self._cur % self.n
            self.good_total -= self.good[s]
            self.bad_total -= self.bad[s]
            self.good[s] = self.bad[s] = 0

    def observe(self, now: float, ok: bool):
        self._advance(now)
        s = self._cur % self.n
        if ok:
            self.good[s] += 1
            self.good_total += 1
        else:
            self.bad[s] += 1
            self.bad_total += 1

    def totals(self, now: float) -> Tuple[int, int]:
        self._advance(now)
        return self.good_total, self.bad_total


class _Series:
    """One (slo, scope, label) stream: its two windows + alert state."""

    __slots__ = ("fast", "slow", "state", "events")

    def __init__(self, cfg: SLOConfig):
        self.fast = _BurnWindow(cfg.fast_window_s,
                                cfg.buckets_per_window)
        self.slow = _BurnWindow(cfg.slow_window_s,
                                cfg.buckets_per_window)
        self.state = "ok"
        self.events = 0

    def burns(self, now: float, budget: float
              ) -> Tuple[float, float, int]:
        """(fast_burn, slow_burn, fast_events)."""
        fg, fb = self.fast.totals(now)
        sg, sb = self.slow.totals(now)
        fn, sn = fg + fb, sg + sb
        fast = (fb / fn / budget) if fn else 0.0
        slow = (sb / sn / budget) if sn else 0.0
        return fast, slow, fn

    def evaluate(self, now: float, budget: float,
                 cfg: SLOConfig) -> str:
        """Multi-window rule: escalate only when BOTH windows burn
        past the threshold (and the fast window has seen enough
        events to mean anything); recover as soon as the fast window
        does."""
        fast, slow, fn = self.burns(now, budget)
        if fn < cfg.min_events:
            return "ok"
        if fast >= cfg.page_burn and slow >= cfg.page_burn:
            return "page"
        if fast >= cfg.warn_burn and slow >= cfg.warn_burn:
            return "warn"
        return "ok"


class SLOTracker:
    """Burn-rate SLO evaluation over the engine's latency/goodput
    event stream. Fed by `ServingMetrics` at the exact call sites
    that record the histograms (same lock discipline: the tracker has
    its own lock, taken strictly after the metrics lock, and its
    `on_transition` callback only ever touches the flight recorder's
    own lock). Every event lands in up to three scopes — the "all"
    aggregate, its priority class, and (when adapter tracking is on)
    its adapter id — each scope a capped label space."""

    def __init__(self, config: Optional[SLOConfig] = None,
                 clock=time.monotonic,
                 on_transition: Optional[Callable[[dict], None]] = None,
                 track_adapters: bool = False,
                 max_label_classes: int = 8,
                 max_transitions: int = 64):
        self.config = config or SLOConfig()
        self._clock = clock
        self.on_transition = on_transition
        self.track_adapters = bool(track_adapters)
        self.max_label_classes = int(max_label_classes)
        self._lock = threading.Lock()
        # (slo, scope, label) -> _Series; label spaces capped per scope
        self._series: Dict[Tuple[str, str, str], _Series] = {}
        self._labels: Dict[str, set] = {"priority": set(),
                                        "adapter": set()}
        self.transitions: deque = deque(maxlen=int(max_transitions))
        self.events_total = 0

    def reset(self):
        with self._lock:
            self._series.clear()
            self._labels = {"priority": set(), "adapter": set()}
            self.transitions.clear()
            self.events_total = 0

    # -- intake (ServingMetrics hooks) -------------------------------------
    def on_ttft(self, ttft_s: float, *, priority: int = 0,
                adapter_id: int = 0, t: Optional[float] = None):
        self._observe("ttft_p99", ttft_s <= self.config.ttft_p99_s,
                      priority, adapter_id, t)

    def on_inter_token(self, dt_s: float, *, priority: int = 0,
                       adapter_id: int = 0, t: Optional[float] = None):
        self._observe("itl_p99", dt_s <= self.config.itl_p99_s,
                      priority, adapter_id, t)

    def on_goodput(self, met: bool, *, priority: int = 0,
                   adapter_id: int = 0, t: Optional[float] = None):
        self._observe("goodput", bool(met), priority, adapter_id, t)

    def _label(self, scope: str, value) -> str:
        lbl = str(int(value))
        seen = self._labels[scope]
        if lbl in seen:
            return lbl
        if len(seen) >= self.max_label_classes:
            return "other"
        seen.add(lbl)
        return lbl

    def _observe(self, slo: str, ok: bool, priority, adapter_id, t):
        now = self._clock() if t is None else float(t)
        budget = self.config.budget(slo)
        fired: List[dict] = []
        with self._lock:
            self.events_total += 1
            scopes = [("all", "")]
            scopes.append(("priority", self._label("priority",
                                                   priority)))
            if self.track_adapters:
                scopes.append(("adapter", self._label("adapter",
                                                      adapter_id)))
            for scope, label in scopes:
                key = (slo, scope, label)
                series = self._series.get(key)
                if series is None:
                    series = self._series[key] = _Series(self.config)
                series.fast.observe(now, ok)
                series.slow.observe(now, ok)
                series.events += 1
                new = series.evaluate(now, budget, self.config)
                if new != series.state:
                    fast, slow, _ = series.burns(now, budget)
                    tr = {"t": now, "slo": slo, "scope": scope,
                          "label": label, "from": series.state,
                          "to": new,
                          "fast_burn": round(fast, 3),
                          "slow_burn": round(slow, 3)}
                    series.state = new
                    self.transitions.append(tr)
                    fired.append(tr)
        cb = self.on_transition
        if cb is not None:
            for tr in fired:
                cb(tr)

    # -- reading ----------------------------------------------------------
    @staticmethod
    def _key_name(scope: str, label: str) -> str:
        return scope if scope == "all" else f"{scope}:{label}"

    def states(self, now: Optional[float] = None) -> Dict[str, Dict[str, str]]:
        """{slo: {"all"|"priority:N"|"adapter:N": state}} — states are
        re-evaluated at `now` so a recovered fast window de-escalates
        even with no new events (scrapes see fresh truth)."""
        now = self._clock() if now is None else float(now)
        out: Dict[str, Dict[str, str]] = {}
        with self._lock:
            for (slo, scope, label), series in self._series.items():
                budget = self.config.budget(slo)
                new = series.evaluate(now, budget, self.config)
                series.state = new
                out.setdefault(slo, {})[
                    self._key_name(scope, label)] = new
        return out

    def worst_state(self, now: Optional[float] = None) -> str:
        worst = "ok"
        for per in self.states(now).values():
            for st in per.values():
                if SLO_STATE_CODES[st] > SLO_STATE_CODES[worst]:
                    worst = st
        return worst

    def worst_burns(self, now: Optional[float] = None
                    ) -> Tuple[float, float]:
        """(fast, slow): the worst burn rate in each window across
        every series (a control plane's scale-up signal, read with the
        same double-window rule the alerts use)."""
        now = self._clock() if now is None else float(now)
        fast = slow = 0.0
        with self._lock:
            for (slo, _scope, _label), s in self._series.items():
                f, sl, _n = s.burns(now, self.config.budget(slo))
                fast = max(fast, f)
                slow = max(slow, sl)
        return fast, slow

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Plain-dict view for the metrics snapshot, `debug_state()` and
        incident dumps: per-series state + burn rates, the config
        targets, the bounded transition log, and the worst state."""
        now = self._clock() if now is None else float(now)
        series = {}
        worst = "ok"
        with self._lock:
            for (slo, scope, label), s in self._series.items():
                budget = self.config.budget(slo)
                st = s.evaluate(now, budget, self.config)
                s.state = st
                fast, slow, fn = s.burns(now, budget)
                series.setdefault(slo, {})[
                    self._key_name(scope, label)] = {
                        "state": st,
                        "fast_burn": round(fast, 3),
                        "slow_burn": round(slow, 3),
                        "events": s.events}
                if SLO_STATE_CODES[st] > SLO_STATE_CODES[worst]:
                    worst = st
            transitions = list(self.transitions)
            events_total = self.events_total
        return {
            "targets": {slo: self.config.target(slo)
                        for slo in SLO_NAMES},
            "windows": {"fast_s": self.config.fast_window_s,
                        "slow_s": self.config.slow_window_s,
                        "warn_burn": self.config.warn_burn,
                        "page_burn": self.config.page_burn,
                        "min_events": self.config.min_events},
            "worst": worst,
            "events_total": events_total,
            "series": series,
            "transitions": transitions,
        }


# -- the step cost census -----------------------------------------------------
COST_CENSUS_MODES = ("off", "model", "lowered", "xla")


def resolve_cost_census(override=None) -> str:
    """Which source the engine's once-per-step-shape cost census uses
    (default "model": host arithmetic). An explicit override wins:
    False -> "off", True -> the env/default resolution, a mode string
    is validated and used; otherwise
    PADDLE_TPU_COST_CENSUS=off|model|lowered|xla. "lowered" and "xla"
    count one forward of the step (see the module doc)."""
    if override is False:
        return "off"
    v = override if isinstance(override, str) else \
        os.environ.get(COST_CENSUS_ENV, "model")
    if v not in COST_CENSUS_MODES:
        raise ValueError(
            f"{COST_CENSUS_ENV} must be one of {COST_CENSUS_MODES}, "
            f"got {v!r}")
    return v


def model_cost_census(*, n_params: int, param_bytes: int,
                      num_slots: int, chunk_len: int,
                      max_pages: int, page_bytes: int,
                      n_heads: int, head_dim: int, page_size: int,
                      mp: int = 1) -> dict:
    """Analytical program-capacity estimate: dense work as 2 FLOPs per
    parameter per packed token plus the attention QK^T/AV terms at full
    context, bytes as one full pass over the weights plus the
    full-occupancy page walk (every slot streaming every page it could
    hold; per chip when mp > 1)."""
    capacity = int(num_slots) * int(chunk_len)
    ctx = int(max_pages) * int(page_size)
    attn_flops = 4.0 * capacity * ctx * int(n_heads) * int(head_dim)
    flops = 2.0 * float(n_params) * capacity + attn_flops
    walk_bytes = float(num_slots) * int(max_pages) * int(page_bytes) \
        / max(1, int(mp))
    return {"flops": flops,
            "bytes_accessed": float(param_bytes) + walk_bytes}


def capture_cost_census(mode: str, fn, example_args,
                        *, capacity_tokens: int,
                        fallback: dict) -> Optional[dict]:
    """Build the census record from `mode`: for "lowered" and "xla",
    count fn(*example_args) once (`ops.cuda.cost.count_cost`; `source`
    is the mode asked for), else, or where the count raises, the
    analytical `fallback` with `source` "model"."""
    if mode == "off":
        return None
    census = None
    if mode in ("lowered", "xla") and fn is not None \
            and example_args is not None:
        try:
            ca, _ = count_cost(fn, *example_args)
            census = {"source": mode, "flops": ca["flops"],
                      "bytes_accessed": ca["bytes_accessed"],
                      "kernels": ca["kernels"]}
        except Exception:
            census = None           # fall through to the model
    if census is None:
        census = {"source": "model",
                  "flops": float(fallback["flops"]),
                  "bytes_accessed": float(fallback["bytes_accessed"])}
    cap = max(1, int(capacity_tokens))
    census["capacity_tokens"] = cap
    census["flops_per_token"] = census["flops"] / cap
    census["bytes_per_token"] = census["bytes_accessed"] / cap
    if math.isnan(census["flops"]):
        census["flops"] = 0.0
    return census
