"""``mx.profiler`` over ``torch.profiler`` (counterpart of
``mxnet_tpu/profiler.py``; reference ``python/mxnet/profiler.py`` over
``src/profiler/profiler.cc``).

The reference's surface: ``set_config``, ``set_state``/``state``,
``start``/``stop``/``pause``/``resume``, ``dumps``/``dump``,
``record_span``, the scoped ``Task``/``Frame``/``Event``, ``Counter`` and
``Marker``, and ``MXNET_PROFILER_AUTOSTART=1``.

``set_state("run")`` starts ``torch.profiler.profile`` over the CPU and,
where a card is present, CUDA; ``"stop"`` and ``"pause"`` end it and
export its chrome trace (``<filename stem>_torch_trace.json``, one file
per window since the last reset, ``_1``, ``_2``... after the first).
The scoped objects are ``torch.profiler.record_function`` ranges and,
on the card, NVTX ranges, recorded in the host aggregate table as well.
``dumps()`` keeps the reference's table and adds a device section: the
CUDA kernels of the windows profiled since the last reset, by name, and
the port's kernel entry points (``mx_*``, the ranges
``kernels/_build.call`` opens) with the device time of their kernels.
``dumps(format="chrome_trace")`` merges torch's traces with the spans,
counters (``ph: "C"``), markers (instant events) and ``mx.telemetry``'s
counters. The memory lines come from ``storage.memory_info`` and
``pool_stats``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

__all__ = [
    "set_config", "set_state", "start", "stop", "pause", "resume", "dumps",
    "dump", "state", "record_span", "Task", "Frame", "Event", "Counter",
    "Marker",
]

_lock = threading.Lock()
_config: Dict = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": True,
    "continuous_dump": False,
}
_state = "stop"            # 'run' | 'stop' | 'pause'
_prof = None               # the torch.profiler.profile of this window
_traces: List[str] = []    # the torch chrome traces exported so far
# host-side span aggregation: name -> [count, total_s, min_s, max_s]
_spans: Dict[str, List[float]] = defaultdict(
    lambda: [0, 0.0, float("inf"), 0.0])
# device kernels and the port's entry points: name -> [launches, total_us]
_kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
_entries: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
_counters: Dict[str, float] = {}
_markers: List[tuple] = []
_paused_total = 0.0
_pause_started: Optional[float] = None


def set_config(**kwargs):
    """Configure the profiler (reference: profiler.py::set_config): the
    reference's keys (``profile_all``, ``profile_symbolic``,
    ``profile_imperative``, ``profile_memory``, ``profile_api``,
    ``filename``, ``aggregate_stats``, ``continuous_dump``).
    ``filename``'s stem names the torch trace files; ``profile_memory`` also records allocations
    in the torch profile and adds the memory lines to ``dumps()``."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise ValueError(f"unknown profiler config keys: {sorted(unknown)}")
    with _lock:
        _config.update(kwargs)


def state():
    return _state


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _start_window():
    import torch

    global _prof
    prof = torch.profiler.profile(activities=_activities(),
                                  profile_memory=_config["profile_memory"])
    prof.start()
    _prof = prof


def _end_window():
    """Stop the window's profile, fold its device events into the
    tables and export its chrome trace."""
    global _prof
    prof, _prof = _prof, None
    if prof is None:
        return
    import torch
    from torch.autograd import DeviceType

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == DeviceType.CUDA and dev_us > 0:
            rec = _kernels[e.key]
            rec[0] += e.count
            rec[1] += dev_us
        elif e.key.startswith("mx_"):
            rec = _entries[e.key]
            rec[0] += e.count
            rec[1] += getattr(e, "device_time_total", 0.0)
    stem = os.path.splitext(_config["filename"])[0]
    path = f"{stem}_torch_trace" + (f"_{len(_traces)}" if _traces else "") \
        + ".json"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    prof.export_chrome_trace(path)
    _traces.append(path)


def set_state(new_state="stop"):
    """'run' starts a torch profile; 'stop' and 'pause' end it (the
    reference's semantics); time spent paused is excluded and reported."""
    global _state, _paused_total, _pause_started
    if new_state not in ("run", "stop", "pause"):
        raise ValueError(f"bad profiler state {new_state!r}")
    with _lock:
        now = time.perf_counter()
        if new_state == "pause" and _state == "run":
            _pause_started = now
        elif _pause_started is not None and new_state in ("run", "stop"):
            _paused_total += now - _pause_started
            _pause_started = None
        if new_state == "run" and _state != "run":
            _start_window()
        elif new_state in ("stop", "pause") and _state == "run":
            _end_window()
        _state = new_state


def start():
    set_state("run")


def stop():
    set_state("stop")


def pause(profile_process="worker"):
    set_state("pause")


def resume(profile_process="worker"):
    set_state("run")


def _reset_locked(now):
    global _paused_total, _pause_started
    _spans.clear()
    _counters.clear()
    _markers.clear()
    _kernels.clear()
    _entries.clear()
    _traces.clear()
    _paused_total = 0.0
    if _pause_started is not None:
        # an open pause window was just reported: rebase it so resume()
        # does not count the reported part again
        _pause_started = now


def dumps(reset=False, format="table"):
    """Aggregate stats of host-recorded spans, counters and markers, and
    the device kernels of the profiled windows.

    ``format="table"`` (default) is the reference's aggregate table
    (timed spans, ``Counter`` values, ``Marker`` counts, the paused time
    in the header, memory lines with ``profile_memory``), then a
    ``Device kernels`` section (launches, total and average ms by kernel
    name) and a ``Kernel entry points`` section (the port's ``mx_*`` C
    entry points and the device ms of their kernels).
    ``format="chrome_trace"`` returns a chrome://tracing JSON string: the
    torch traces' events, aggregate span events, counters as ``ph:"C"``
    events, markers as instant events and ``mx.telemetry``'s counters."""
    if format == "chrome_trace":
        return _dumps_chrome_trace(reset)
    if format != "table":
        raise ValueError(f"unknown dumps format {format!r}")
    mem_lines = _memory_lines()
    with _lock:
        now = time.perf_counter()
        paused = _paused_total
        if _pause_started is not None:
            paused += now - _pause_started
        lines = ["Profile Statistics:"]
        if paused > 0:
            lines.append(f"(excluded paused time: {paused * 1e3:.3f} ms)")
        lines.extend(mem_lines)
        lines.append(f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}"
                     f"{'Min(ms)':>10}{'Max(ms)':>10}{'Avg(ms)':>10}")
        for name in sorted(_spans):
            cnt, tot, mn, mx = _spans[name]
            lines.append(
                f"{name:<40}{cnt:>8}{tot * 1e3:>12.3f}{mn * 1e3:>10.3f}"
                f"{mx * 1e3:>10.3f}{tot / max(cnt, 1) * 1e3:>10.3f}")
        for name in sorted(_counters):
            lines.append(f"{name:<40}{'':>8}{_counters[name]:>12.3f}")
        by_marker: Dict[str, int] = {}
        for name, scope, ts in _markers:
            key = f"Marker::{name} ({scope})"
            by_marker[key] = by_marker.get(key, 0) + 1
        for name in sorted(by_marker):
            lines.append(f"{name:<40}{by_marker[name]:>8}")
        for title, table in (("Device kernels", _kernels),
                             ("Kernel entry points", _entries)):
            if not table:
                continue
            lines.append(f"{title}:")
            lines.append(f"{'Name':<60}{'Launches':>10}{'Total(ms)':>12}"
                         f"{'Avg(ms)':>10}")
            for name, (cnt, us) in sorted(table.items(),
                                          key=lambda kv: -kv[1][1]):
                short = name if len(name) <= 59 else name[:56] + "..."
                lines.append(f"{short:<60}{cnt:>10}{us / 1e3:>12.3f}"
                             f"{us / 1e3 / max(cnt, 1):>10.3f}")
        if reset:
            _reset_locked(now)
        out = "\n".join(lines)
        traces = list(_traces)
    if traces:
        out += "\n(torch trace: " + ", ".join(traces) + ")"
    return out


def _memory_lines():
    """One line per device for ``dumps()`` when
    ``set_config(profile_memory=True)``: ``storage.pool_stats`` (the
    caching allocator's counters on the card; zeros on the CPU, which
    keeps no pool, so the flag's effect always shows)."""
    if not _config["profile_memory"]:
        return []
    import torch

    from . import storage
    from .context import Context

    ctxs = [Context("cpu", 0)] + [Context("gpu", i) for i in
                                  range(torch.cuda.device_count())]
    lines = []
    for ctx in ctxs:
        st = storage.pool_stats(ctx)
        free, total = storage.memory_info(ctx)
        lines.append(
            f"Memory::{ctx}"
            f"  bytes_in_use={st['bytes_in_use']}"
            f"  peak_bytes_in_use={st['peak_bytes_in_use']}"
            f"  bytes_limit={st['bytes_limit']}"
            f"  num_allocs={st['num_allocs']}"
            f"  free={free}  total={total}")
    return lines


def _dumps_chrome_trace(reset=False):
    from . import telemetry
    from . import tracing as _req_tracing

    events = []
    with _lock:
        now = time.perf_counter()
        traces = list(_traces)
        for name in sorted(_spans):
            cnt, tot, mn, mx = _spans[name]
            events.append({
                "name": name, "ph": "X", "pid": 0, "tid": 0, "ts": 0,
                "dur": tot * 1e6,
                "args": {"calls": cnt, "min_ms": mn * 1e3,
                         "max_ms": mx * 1e3,
                         "avg_ms": tot / max(cnt, 1) * 1e3}})
        for name in sorted(_counters):
            events.append({"name": name, "ph": "C", "pid": 0, "tid": 0,
                           "ts": now * 1e6,
                           "args": {"value": _counters[name]}})
        for name, scope, ts in _markers:
            events.append({"name": name, "ph": "i", "pid": 0, "tid": 0,
                           "ts": ts * 1e6, "s": "p",
                           "args": {"scope": scope}})
        paused = _paused_total
        if _pause_started is not None:
            paused += now - _pause_started
        if reset:
            _reset_locked(now)
    for path in traces:
        with open(path) as f:
            events.extend(json.load(f).get("traceEvents", []))
    events.extend(telemetry.chrome_counter_events())
    if _req_tracing.enabled():
        events.extend(_req_tracing.chrome_trace_events())
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"excluded_paused_ms": paused * 1e3}}
    if traces:
        doc["otherData"]["torch_traces"] = traces
    return json.dumps(doc)


def record_span(name: str, seconds: float) -> None:
    """Record one already-measured span into the aggregate table (for
    runtime-internal spans whose start and stop straddle a lock)."""
    with _lock:
        rec = _spans[name]
        rec[0] += 1
        rec[1] += seconds
        rec[2] = min(rec[2], seconds)
        rec[3] = max(rec[3], seconds)


def dump(finished=True, profile_process="worker"):
    """Write the aggregate table to the configured filename."""
    path = _config["filename"]
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(dumps())
    return path


class _Scope:
    """Scoped annotation: context manager and start/stop object. A
    ``torch.profiler.record_function`` range named ``Kind::name`` (and an
    NVTX range where a card is present), recorded in the host aggregate
    table."""

    _kind = "Event"

    def __init__(self, name):
        self.name = name
        self._t0 = None
        self._rf = None
        self._nvtx = False

    def start(self):
        import torch

        label = f"{self._kind}::{self.name}"
        self._t0 = time.perf_counter()
        self._rf = torch.profiler.record_function(label)
        self._rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(label)
            self._nvtx = True
        return self

    def stop(self):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        record_span(f"{self._kind}::{self.name}", dt)
        self._t0 = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class Task(_Scope):
    _kind = "Task"


class Frame(_Scope):
    _kind = "Frame"


class Event(_Scope):
    _kind = "Event"


class Counter:
    """Named counter (reference: profiler.Counter): set/increment/decrement."""

    def __init__(self, name, value=0):
        self.name = name
        self.set_value(value)

    def set_value(self, value):
        with _lock:
            _counters[self.name] = float(value)

    def increment(self, delta=1):
        with _lock:
            _counters[self.name] = _counters.get(self.name, 0.0) + delta

    def decrement(self, delta=1):
        self.increment(-delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    """Instant event (reference: profiler.Marker.mark)."""

    def __init__(self, name):
        self.name = name

    def mark(self, scope="process"):
        with _lock:
            _markers.append((self.name, scope, time.perf_counter()))


if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    set_state("run")
