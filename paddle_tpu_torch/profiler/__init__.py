"""paddle.profiler parity: host spans and device trace capture
(counterpart of `paddle_tpu/profiler/__init__.py`).

Reference: python/paddle/profiler/profiler.py:344 (Profiler, scheduler
states at :79), RecordEvent (profiler/utils.py over C++ event_tracing.h),
ChromeTracingLogger (paddle/fluid/platform/profiler/chrometracing_logger.cc),
profiler_statistic.py summaries.

Host spans are `(name, tid, t0_ns, t1_ns)` records kept in-process by the
live `Profiler`. A `RecordEvent` used as a context manager (a span that
opens and closes inside one call) also enters
`torch.profiler.record_function`, so it lands in a torch trace beside
the kernels it launched; one opened by `begin()` and closed by `end()`
elsewhere (a request's lifetime, across steps and threads) is a host
record of the port's `Profiler` only, since `record_function` must exit
on the thread and in the frame that entered it.

The device side of `Profiler` is `torch.profiler` with CUDA activity,
started while the profiler records and the GPU is among its targets;
`export()` writes the host spans and, beside them, the torch trace.
The JAX package's per-op dispatch hook (a span around every eager op)
has no counterpart until the port has its own op dispatch layer
(ROADMAP.md, queue 1, item 7): here `torch.profiler` records the ops.
"""
from __future__ import annotations

import json
import os
import threading
import time
from enum import Enum
from typing import Callable, Optional

import torch

__all__ = ["Profiler", "RecordEvent", "ProfilerState", "ProfilerTarget",
           "make_scheduler", "export_chrome_tracing", "chrome_trace",
           "SortedKeys", "SummaryView", "load_profiler_result"]


def chrome_trace(events, pid: int = None) -> dict:
    """The chrome-tracing writer: `(name, tid, t0_ns, t1_ns)` span
    tuples -> the Chrome-trace JSON dict (openable in Perfetto /
    chrome://tracing; reference: chrometracing_logger.cc). Shared by
    `Profiler.export` and the serving observability layer
    (`serving/obs.py`). Timestamps are ns; the earliest t0 becomes the
    trace origin."""
    base = min((e[2] for e in events), default=0)
    return {
        "traceEvents": [
            {"name": name, "ph": "X", "cat": "host",
             "ts": (t0 - base) / 1e3, "dur": (t1 - t0) / 1e3,
             "pid": os.getpid() if pid is None else pid, "tid": tid}
            for name, tid, t0, t1 in events
        ],
        "displayTimeUnit": "ms",
    }


class ProfilerState(Enum):
    """reference: profiler.py:79."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2      # accepted for reference compatibility; traces nothing
    CUSTOM_DEVICE = 3


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


# process-global: RecordEvent spans on any thread record into the live
# profiler (events carry their tid; list.append is atomic under the GIL)
_active: dict = {"profiler": None}


def _active_profiler():
    return _active["profiler"]


def _now_ns():
    return time.perf_counter_ns()


class RecordEvent:
    """Host span (reference: profiler/utils.py RecordEvent over
    platform/profiler/event_tracing.h), as a context manager or through
    begin()/end(). As a context manager it also enters
    `torch.profiler.record_function(name)`."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self.event_type = event_type
        self._t0 = None
        self._rf = None

    def begin(self):
        self._t0 = _now_ns()

    def end(self):
        if self._t0 is None:
            return
        prof = _active_profiler()
        if prof is not None and prof._recording and not prof.timer_only:
            prof._events.append(
                (self.name, threading.get_ident(), self._t0, _now_ns()))
        self._t0 = None

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        return False


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0):
    """reference: profiler.py make_scheduler — cycle through
    CLOSED*closed -> READY*ready -> RECORD*record, repeating `repeat`
    times (0 = forever), after skipping `skip_first` steps."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat > 0 and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: str = None):
    """on_trace_ready factory (reference: profiler.py
    export_chrome_tracing)."""
    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        prof.export(os.path.join(
            dir_name, f"{name}_time_{time.time_ns()}"
                      f".paddle_trace.json"))
    return handler


def _default_targets():
    targets = [ProfilerTarget.CPU]
    if torch.cuda.is_available():
        targets.append(ProfilerTarget.GPU)
    return targets


class Profiler:
    """reference: profiler.py:344. Usage:

        with profiler.Profiler(targets=[...], scheduler=(2, 5)) as p:
            for batch in loader:
                train_step(batch)
                p.step()
        p.summary()
    """

    def __init__(self, *, targets=None, scheduler=None,
                 on_trace_ready: Optional[Callable] = None,
                 record_shapes=False, profile_memory=False,
                 timer_only=False, emit_nvtx=False, custom_device_types=None):
        self.targets = list(targets) if targets else _default_targets()
        if isinstance(scheduler, (tuple, list)) and len(scheduler) == 2:
            start, end = scheduler
            self._scheduler = make_scheduler(
                closed=max(start, 0), ready=0, record=end - start,
                repeat=1)
        elif callable(scheduler):
            self._scheduler = scheduler
        else:
            self._scheduler = None  # record everything between start/stop
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = bool(record_shapes)
        self.profile_memory = bool(profile_memory)
        self._events: list = []      # current recording window
        self._all_events: list = []  # flushed windows (for post-hoc use)
        self._step = 0
        self._recording = False
        self._device_prof = None     # the live torch.profiler.profile
        self.device_profile = None   # the last finished one
        self.current_state = ProfilerState.CLOSED
        self._step_times: list = []
        self._last_step_t = None

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        # fresh run: a restarted profiler must not re-export the previous
        # run's spans or resume its scheduler mid-cycle
        self._events = []
        self._all_events = []
        self._step = 0
        self._step_times = []
        self.device_profile = None
        _active["profiler"] = self
        self._last_step_t = time.perf_counter()
        self._update_state()
        return self

    def stop(self):
        if self._device_prof is not None:
            self._stop_device_trace()
        self._recording = False
        self.current_state = ProfilerState.CLOSED
        if _active_profiler() is self:
            _active["profiler"] = None
        self._flush_window()

    def step(self, num_samples=None):
        t = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append((t - self._last_step_t, num_samples))
        self._last_step_t = t
        was_returning = (self.current_state
                         == ProfilerState.RECORD_AND_RETURN)
        self._step += 1
        self._update_state()
        if was_returning:
            # window boundary: hand the collected window to the handler
            # and clear the buffer (reference: one trace per window)
            self._flush_window()

    def _flush_window(self):
        if self.timer_only:
            self._events = []
            return
        if self._events:
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
            self._all_events.extend(self._events)
            self._events = []

    def step_info(self, unit=None):
        if not self._step_times:
            return ""
        dt, ns = self._step_times[-1]
        ips = f" ips: {ns / dt:.2f}" if ns else ""
        return f"batch_cost: {dt:.5f} s{ips}"

    def _update_state(self):
        if self._scheduler is None:
            new = ProfilerState.RECORD
        else:
            new = self._scheduler(self._step)
        self.current_state = new
        self._recording = new in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN)
        if not self.timer_only:
            want = self._recording and ProfilerTarget.GPU in self.targets
            if want and self._device_prof is None:
                self._start_device_trace()
            elif not want and self._device_prof is not None:
                self._stop_device_trace()

    def _start_device_trace(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._device_prof = torch.profiler.profile(
            activities=acts, record_shapes=self.record_shapes,
            profile_memory=self.profile_memory)
        self._device_prof.__enter__()

    def _stop_device_trace(self):
        prof, self._device_prof = self._device_prof, None
        prof.__exit__(None, None, None)
        self.device_profile = prof

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- output --------------------------------------------------------------
    def export(self, path: str, format: str = "json"):
        """Chrome-trace JSON of the host spans (openable in Perfetto /
        chrome://tracing; reference: chrometracing_logger.cc). A
        finished device trace is written beside it as
        `<path>.device.json` and named in `otherData`."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # inside on_trace_ready: the current window; after stop(): all
        # flushed windows
        events = self._events or self._all_events
        trace = chrome_trace(events)
        if self.device_profile is not None:
            device_path = path + ".device.json"
            self.device_profile.export_chrome_trace(device_path)
            trace["otherData"] = {"torch_device_trace": device_path}
        with open(path, "w") as f:
            json.dump(trace, f)
        return path

    def aggregate(self):
        """name -> dict(calls, total_ns, avg_ns, max_ns, min_ns)."""
        agg: dict = {}
        for name, _tid, t0, t1 in (self._events or self._all_events):
            d = t1 - t0
            a = agg.setdefault(name, {"calls": 0, "total": 0,
                                      "max": 0, "min": None})
            a["calls"] += 1
            a["total"] += d
            a["max"] = max(a["max"], d)
            a["min"] = d if a["min"] is None else min(a["min"], d)
        for a in agg.values():
            a["avg"] = a["total"] / a["calls"]
        return agg

    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True,
                thread_sep=False, time_unit="ms", views=None):
        """Print the operator-view table of the host spans (reference:
        profiler_statistic.py)."""
        unit = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}[time_unit]
        agg = self.aggregate()
        sort_field = {
            SortedKeys.CPUTotal: "total", SortedKeys.CPUAvg: "avg",
            SortedKeys.CPUMax: "max", SortedKeys.CPUMin: "min",
        }.get(sorted_by, "total")
        rows = sorted(agg.items(), key=lambda kv: -kv[1][sort_field])
        lines = [f"{'Name':45s} {'Calls':>7s} {'Total(' + time_unit + ')':>12s}"
                 f" {'Avg(' + time_unit + ')':>12s} {'Max(' + time_unit + ')':>12s}"]
        lines.append("-" * 92)
        for name, a in rows:
            lines.append(
                f"{name[:45]:45s} {a['calls']:7d} {a['total'] / unit:12.4f}"
                f" {a['avg'] / unit:12.4f} {a['max'] / unit:12.4f}")
        text = "\n".join(lines)
        print(text)
        return text


def load_profiler_result(filename: str):
    """Load an exported chrome-trace JSON (reference:
    profiler.load_profiler_result)."""
    with open(filename) as f:
        return json.load(f)
