"""``mx.tracing`` — request tracing + flight recorder.

Counterpart of ``mxnet_tpu/tracing.py``, copied (it is plain Python)
but for what only the fleet uses: traces crossing a process boundary
(``adopt``, ``Trace.wire``/``merge``/``export_spans``/``add_raw``), the
process name a worker sets, a future's done-callback, and the
chrome-trace export the reference's profiler merges.

A trace is minted at ``Server.submit``/``submit_generate`` (or continued
from an ambient one, :func:`active`), and every stage a request crosses
— ``batch.wait``, ``dispatch``, ``gen.queue``, ``prefill``,
``decode.step`` — contributes one span. A batch ``dispatch`` span is
shared by the N co-batched requests and linked to each of their
``batch.wait`` spans by flow ids (:func:`begin_batch`). ``fault.py``
annotates the live span when it injects a fault or retries.

Default-off with the telemetry/fault fast path: instrumented hot paths
cache a reference to ``_state`` and guard on ``_state.enabled`` — one
attribute load + branch, zero allocations per request while disabled.
Enable with ``MXNET_TRACING=1`` or :func:`enable`.

On top rides the **flight recorder**: a bounded ring of recently
completed traces plus structured events (preemptions, defrags), read
in process with :func:`events` and dumped as JSONL through
``checkpoint.atomic_write`` (:func:`dump`, or at interpreter exit when
``MXNET_TRACING_OUT=PATH`` is set, as ``PATH.<pid>.jsonl``). The serving
latency histograms attach ``# {trace_id="..."}`` exemplars to the bucket
a traced request lands in (``telemetry.record_serving_request``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "enable", "disable", "enabled", "reset",
    "Trace", "Span", "new_trace",
    "active", "ambient", "note",
    "begin_batch", "end_batch",
    "record_event", "events", "recorder", "FlightRecorder",
    "dump", "dump_jsonl", "maybe_dump", "dump_path", "now_us",
    "chrome_trace_events",
]


class _State:
    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled


# THE fast-path guard — same contract as telemetry/fault: instrumented
# modules cache a reference to `_state` and branch on `.enabled`; the
# instance is never swapped.
_state = _State(os.environ.get("MXNET_TRACING", "0") == "1")


def enabled() -> bool:
    return _state.enabled


def enable() -> None:
    _state.enabled = True


def disable() -> None:
    _state.enabled = False


def now_us() -> int:
    """Wall-clock epoch microseconds — spans from different processes on
    one host align on this axis (the serving fleet is single-host)."""
    return time.time_ns() // 1000


# process role shown on every span this process creates
_proc_name = f"pid{os.getpid()}"


# trace/span ids: 64-bit hex; flow ids: process-unique ints salted with
# the pid so flows minted in a worker never collide with the parent's
_id_lock = threading.Lock()
_id_counter = itertools.count(1)


def _mint_id() -> str:
    with _id_lock:
        n = next(_id_counter)
    return f"{os.getpid():08x}{n:08x}"


_flow_counter = itertools.count(1)


def _mint_flow() -> int:
    return os.getpid() * 1_000_000 + next(_flow_counter)


class Span:
    """One timed stage of one trace. Created via :meth:`Trace.begin`,
    sealed with :meth:`end` (which appends its dict form to the owning
    trace). ``note``/``tag`` annotate the live span — ``fault.py`` uses
    them so injected faults and retries show up inside the stage they
    hit."""

    __slots__ = ("trace", "span_id", "parent_id", "name", "ts", "dur",
                 "tags", "notes", "flow_out", "flows_in", "_fanout",
                 "_done")

    def __init__(self, trace: "Trace", name: str,
                 parent_id: Optional[str], tags: Optional[dict]):
        self.trace = trace
        self.span_id = _mint_id()
        self.parent_id = parent_id
        self.name = name
        self.ts = now_us()
        self.dur = None
        self.tags = dict(tags) if tags else None
        self.notes: Optional[list] = None
        self.flow_out: Optional[int] = None   # this span starts a flow
        self.flows_in: Optional[list] = None  # flows ending at this span
        self._fanout = None   # batch spans: sibling traces to copy into
        self._done = False

    def tag(self, **kv) -> None:
        if self.tags is None:
            self.tags = {}
        self.tags.update(kv)

    def note(self, text: str) -> None:
        if self.notes is None:
            self.notes = []
        self.notes.append([now_us(), str(text)])

    def end(self, **tags) -> None:
        if self._done:
            return
        self._done = True
        if tags:
            self.tag(**tags)
        self.dur = max(now_us() - self.ts, 0)
        self.trace._add(self.as_dict())

    def as_dict(self) -> dict:
        d = {"trace_id": self.trace.trace_id, "span_id": self.span_id,
             "name": self.name, "ts": self.ts,
             "dur": self.dur if self.dur is not None else 0,
             "proc": _proc_name, "pid": os.getpid()}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.tags:
            d["tags"] = self.tags
        if self.notes:
            d["notes"] = self.notes
        if self.flow_out is not None:
            d["flow_out"] = self.flow_out
        if self.flows_in:
            d["flows_in"] = list(self.flows_in)
        return d


class Trace:
    """One request's spans, across threads and (merged) processes.
    Thread-safe: span ends, merges and ``finish`` may race between the
    submitting thread, scheduler threads and reader threads; the first
    ``finish`` wins and hands the sealed record to the flight
    recorder."""

    __slots__ = ("trace_id", "root", "remote_parent", "spans", "events",
                 "status", "_lock", "_finished")

    def __init__(self, trace_id: Optional[str] = None,
                 root_name: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 tags: Optional[dict] = None):
        self.trace_id = trace_id or _mint_id()
        self.remote_parent = parent_id
        self.spans: List[dict] = []
        self.events: Optional[list] = None
        self.status: Optional[str] = None
        self._lock = threading.Lock()
        self._finished = False
        self.root = None     # set below; begin() reads it for defaults
        if root_name:
            self.root = self.begin(root_name, parent=parent_id,
                                   **(tags or {}))

    def begin(self, name: str, parent=None, **tags) -> Span:
        """Open a span. ``parent`` may be a :class:`Span`, a span-id
        string (the wire form), or None (defaults to the root span)."""
        if parent is None:
            parent = self.root
        pid = parent.span_id if isinstance(parent, Span) else parent
        return Span(self, name, pid, tags or None)

    def _add(self, span_dict: dict) -> None:
        with self._lock:
            self.spans.append(span_dict)

    def note(self, text: str) -> None:
        """Trace-level annotation (no live span to attach to — e.g. a
        worker crash observed by the supervisor thread)."""
        with self._lock:
            if self.events is None:
                self.events = []
            self.events.append([now_us(), str(text)])

    def finish(self, status: str = "ok") -> None:
        """Seal the trace (first call wins), ending the root span, and
        hand the record to the flight recorder."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
        self.status = status
        if self.root is not None and not self.root._done:
            self.root.end(status=status)
        _recorder.record_trace(self.record())

    def record(self) -> dict:
        with self._lock:
            spans = list(self.spans)
        d = {"trace_id": self.trace_id, "status": self.status or "open",
             "spans": spans}
        if self.events:
            d["events"] = list(self.events)
        return d

def new_trace(name: str = "request", **tags) -> Trace:
    """Mint a fresh trace with a root span called ``name``."""
    return Trace(root_name=name, tags=tags or None)


# ---------------------------------------------------------------------------
# Ambient context: how trace context crosses the synchronous call seams
# that share a signature between traced and untraced callers
# (Router._route -> replica.submit works for Server AND RemoteReplica
# without changing the dispatch contract).
# ---------------------------------------------------------------------------

_tls = threading.local()


@contextlib.contextmanager
def active(trace: Trace, parent=None):
    """Make ``(trace, parent)`` the ambient context for calls made by
    this thread inside the block. ``parent`` is the Span (or span-id
    string) child spans should hang off."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append((trace, parent))
    try:
        yield
    finally:
        stack.pop()


def ambient() -> Optional[Tuple[Trace, object]]:
    """The innermost ``(trace, parent)`` set by :func:`active` on this
    thread, or None."""
    stack = getattr(_tls, "stack", None)
    if not stack:
        return None
    return stack[-1]


def note(text: str) -> None:
    """Annotate the innermost ambient span (no-op without one) — the
    ``fault.py`` hook: an injected fault or a retry lands inside the
    stage span that was live when it fired."""
    amb = ambient()
    if amb is None:
        return
    trace, parent = amb
    if isinstance(parent, Span):
        parent.note(text)
    else:
        trace.note(text)


# ---------------------------------------------------------------------------
# Batch spans: one dispatch serves N requests; link them.
# ---------------------------------------------------------------------------

def begin_batch(items, name: str = "dispatch", wait_tags: Optional[dict] = None,
                **tags) -> Optional[Span]:
    """Close the co-batched requests' wait spans and open the shared
    batch span. ``items`` is ``[(Trace, Span-or-None), ...]`` for the
    traced requests in the batch; each wait span ends NOW (dispatch
    start) carrying ``wait_tags`` and a chrome-trace flow id that
    terminates at the batch span. Returns the batch span (owned by the
    first trace; :func:`end_batch` copies it into the others so every
    trace is self-contained)."""
    items = [(tr, sp) for tr, sp in items if tr is not None]
    if not items:
        return None
    flows = []
    for _tr, sp in items:
        if sp is not None and not sp._done:
            fid = _mint_flow()
            sp.flow_out = fid
            flows.append(fid)
            if wait_tags:
                sp.end(**wait_tags)
            else:
                sp.end()
    tr0 = items[0][0]
    bsp = Span(tr0, name, None, tags or None)
    bsp.flows_in = flows
    bsp.tag(batch=len(items))
    bsp._fanout = [tr for tr, _sp in items[1:]]
    return bsp


def end_batch(bsp: Optional[Span], **tags) -> None:
    """Seal a :func:`begin_batch` span and copy its dict into every
    other participating trace (dedup'd at export by span_id)."""
    if bsp is None:
        return
    fanout = bsp._fanout or []
    bsp.end(**tags)
    d = bsp.as_dict()
    for tr in fanout:
        tr._add(d)


# ---------------------------------------------------------------------------
# Flight recorder: the bounded ring of completed traces + structured
# events, dumped as JSONL when something goes wrong.
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of recently completed traces and structured events
    (breaker transitions, sheds, crashes, respawns, reloads, dumps).
    Everything is plain dicts so a dump is one ``json.dumps`` per line;
    thread-safe."""

    def __init__(self, trace_capacity: int = 256,
                 event_capacity: int = 1024):
        self._lock = threading.Lock()
        self._traces = collections.deque(maxlen=trace_capacity)
        self._events = collections.deque(maxlen=event_capacity)
        self.n_traces = 0
        self.n_events = 0

    def record_trace(self, record: dict) -> None:
        with self._lock:
            self._traces.append(record)
            self.n_traces += 1

    def record_event(self, kind: str, **fields) -> None:
        ev = {"event": str(kind), "ts": now_us(), "proc": _proc_name,
              "pid": os.getpid()}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)
            self.n_events += 1

    def traces(self) -> List[dict]:
        with self._lock:
            return list(self._traces)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._events.clear()

    def dump_jsonl(self) -> str:
        """The ring as JSONL: events first (fleet weather), then one
        line per completed trace."""
        with self._lock:
            events = list(self._events)
            traces = list(self._traces)
        lines = [json.dumps(e, sort_keys=True) for e in events]
        lines.extend(json.dumps(t, sort_keys=True) for t in traces)
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path: str) -> None:
        """Atomic JSONL dump — dumps happen at the worst moments
        (crash, SIGTERM, breaker trip); a torn file would be a second
        incident. Routes through ``checkpoint.atomic_write``."""
        from . import checkpoint

        checkpoint.atomic_write(path, self.dump_jsonl().encode("utf-8"))


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def record_event(kind: str, **fields) -> None:
    """Record one structured event into the flight recorder. Callers on
    hot paths guard with ``_state.enabled`` themselves (the
    telemetry/fault pattern)."""
    if not _state.enabled:
        return
    _recorder.record_event(kind, **fields)


def events(kind: Optional[str] = None) -> List[dict]:
    """The flight recorder's event ring (optionally filtered to one
    ``kind``) — the in-process read side of :func:`record_event`, e.g.
    ``tracing.events("preempted")`` to find who preempted whom without
    round-tripping a JSONL dump."""
    evs = _recorder.events()
    if kind is None:
        return evs
    return [e for e in evs if e.get("event") == kind]


def dump_jsonl() -> str:
    return _recorder.dump_jsonl()


def dump(path: str) -> None:
    _recorder.dump(path)


def dump_path() -> Optional[str]:
    """Where :func:`maybe_dump` writes: ``MXNET_TRACING_OUT`` with the
    pid woven in (router and worker processes inherit the same env —
    per-pid siblings keep a fleet from clobbering one file)."""
    out = os.environ.get("MXNET_TRACING_OUT")
    if not out:
        return None
    base, ext = os.path.splitext(out)
    return f"{base}.{os.getpid()}{ext or '.jsonl'}"


def maybe_dump(reason: str) -> Optional[str]:
    """Dump the flight recorder if tracing is enabled and
    ``MXNET_TRACING_OUT`` is set; records the dump itself as an event.
    Returns the path written (or None). Never raises — this runs on
    crash/SIGTERM paths where a secondary failure must not mask the
    primary one."""
    if not _state.enabled:
        return None
    path = dump_path()
    if path is None:
        return None
    try:
        _recorder.record_event("dump", reason=str(reason), path=path)
        _recorder.dump(path)
        return path
    except Exception:   # noqa: BLE001 - best-effort by contract
        return None


def reset() -> None:
    """Disable tracing and clear the recorder ring (test isolation)."""
    _state.enabled = False
    _recorder.clear()


# MXNET_TRACING_OUT=PATH: dump the ring at interpreter exit too (the
# MXNET_TELEMETRY_OUT contract) — a clean run still leaves the evidence.
if os.environ.get("MXNET_TRACING_OUT"):
    import atexit

    _state.enabled = True
    atexit.register(maybe_dump, "atexit")


def chrome_trace_events() -> List[Dict]:
    """The flight-recorder ring as chrome-trace events (merged into
    ``profiler.dumps(format="chrome_trace")``): one ``ph:"X"`` per span
    (once per span_id: a batch span is copied into every trace it
    served), ``ph:"s"``/``ph:"f"`` flow pairs linking each request's
    ``batch.wait`` span to its batch ``dispatch`` span, and one instant
    event per recorder event; epoch microseconds."""
    events: List[Dict] = []
    seen = set()
    for rec in _recorder.traces():
        for d in rec.get("spans", []):
            sid = d.get("span_id")
            if sid in seen:
                continue
            seen.add(sid)
            pid = d.get("pid", 0)
            tid = d.get("proc", "")
            args = {"trace_id": d.get("trace_id")}
            if d.get("tags"):
                args.update(d["tags"])
            if d.get("notes"):
                args["notes"] = [n[1] for n in d["notes"]]
            events.append({"name": d.get("name", "span"), "ph": "X",
                           "cat": "serving", "pid": pid, "tid": tid,
                           "ts": d.get("ts", 0), "dur": d.get("dur", 0),
                           "args": args})
            end_ts = d.get("ts", 0) + d.get("dur", 0)
            if d.get("flow_out") is not None:
                events.append({"name": "batch", "ph": "s",
                               "cat": "serving", "id": d["flow_out"],
                               "pid": pid, "tid": tid, "ts": end_ts})
            for fid in d.get("flows_in", ()):
                events.append({"name": "batch", "ph": "f", "bp": "e",
                               "cat": "serving", "id": fid, "pid": pid,
                               "tid": tid, "ts": d.get("ts", 0)})
    for ev in _recorder.events():
        events.append({"name": ev.get("event", "event"), "ph": "i",
                       "cat": "serving", "s": "g",
                       "pid": ev.get("pid", 0),
                       "tid": ev.get("proc", ""),
                       "ts": ev.get("ts", 0),
                       "args": {k: v for k, v in ev.items()
                                if k not in ("event", "ts")}})
    return events
