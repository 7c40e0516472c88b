"""``mx.telemetry`` — always-available runtime metrics.

Counterpart of ``mxnet_tpu/telemetry.py``: its registry of counters,
gauges and fixed-bucket histograms, its JSON and Prometheus text
exporters, and the recorders the port's serving, KV-cache, fault,
retry, checkpoint, training and compilation-service code call, copied
with their metric names and label sets. The HTTP exporter, the scrape parser and the
recorders of layers the port has not ported (op dispatch, the eager and
bulk caches, KVStore, the data pipeline, elastic training, the router
and ingress) come with those layers.

Recording is **default-off**: every instrumented hot path guards on one
module-level flag (``_state.enabled`` — a single attribute load + branch)
so the disabled fast path costs one branch and allocates nothing. Enable
with ``MXNET_TELEMETRY=1`` in the environment or ``telemetry.enable()``.

:func:`xla_cost_analysis` keeps the reference's name and its ``{"flops":
...}`` dict; it counts a step's forward and backward on ``meta`` copies
(``compiler/flops.py``) and runs no update.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


__all__ = [
    "enable", "disable", "enabled", "reset",
    "counter", "gauge", "histogram", "dumps", "prom_text", "snapshot",
    "record_fault_injected", "record_retry", "record_checkpoint_write",
    "record_serving_request", "record_serving_batch",
    "record_serving_queue_time", "set_serving_queue_depth",
    "record_serving_reload", "record_serving_shed",
    "record_decode_step", "record_token", "set_tenant_queue_depth",
    "record_preemption", "record_kvcache_defrag", "set_kvcache_pages",
    "record_training_step", "record_optimizer_dispatch",
    "record_step_skipped", "TrainingTelemetry", "xla_cost_analysis",
    "record_cache", "record_cache_eviction", "record_cold_start",
    "record_warm_start",
    "record_data_wait", "set_data_queue_depth", "record_images_decoded",
    "chrome_counter_events", "record_kv", "record_kv_collective", "record_kv_bucket",
    "record_kv_bucket_fallback", "record_kv_compression",
    "record_kv_overlap", "record_optimizer_state_bytes",
    "record_optimizer_bucket", "BYTES_BUCKETS",
    "LATENCY_BUCKETS", "STEP_BUCKETS", "SERVING_BUCKETS",
    "OCCUPANCY_BUCKETS",
]


class _State:
    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled


# THE fast-path guard: instrumented modules read `_state.enabled` directly
# (one attribute load + branch; never swap the _State instance, callers
# cache a reference to it).
_state = _State(os.environ.get("MXNET_TELEMETRY", "0") == "1")


def enabled() -> bool:
    return _state.enabled


def enable() -> None:
    _state.enabled = True


def disable() -> None:
    _state.enabled = False


# ---------------------------------------------------------------------------
# Metric registry
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_registry: Dict[str, "_Family"] = {}

# Per-family label-child cap: label values come from bounded sets (op names,
# cache names) but a bug upstream must degrade to a catch-all child, never
# to unbounded registry growth.
_MAX_CHILDREN = 4096
_OVERFLOW_LABEL = "_overflow"

# host-side dispatch/comms latencies: 10 µs .. 30 s, ~x3 geometric
LATENCY_BUCKETS: Tuple[float, ...] = (
    10e-6, 30e-6, 100e-6, 300e-6, 1e-3, 3e-3, 10e-3, 30e-3,
    100e-3, 300e-3, 1.0, 3.0, 10.0, 30.0)
# training steps: 1 ms .. 100 s
STEP_BUCKETS: Tuple[float, ...] = (
    1e-3, 3e-3, 10e-3, 30e-3, 100e-3, 300e-3, 1.0, 3.0, 10.0, 30.0, 100.0)
# inference request latencies: LATENCY_BUCKETS bottoms out too coarse for
# serving p50s (a batched CPU dense dispatch answers in tens of µs) —
# 20 µs .. 10 s, ~x2–2.5 geometric, dense through the sub-millisecond range
SERVING_BUCKETS: Tuple[float, ...] = (
    20e-6, 50e-6, 100e-6, 200e-6, 500e-6, 1e-3, 2e-3, 5e-3, 10e-3,
    20e-3, 50e-3, 100e-3, 200e-3, 500e-3, 1.0, 2.0, 5.0, 10.0)
# batch occupancy (real rows / padded bucket capacity): eighths of a batch
OCCUPANCY_BUCKETS: Tuple[float, ...] = (
    0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# payload sizes (gradient buckets): 4 KB .. 1 GB, x4 geometric
BYTES_BUCKETS: Tuple[float, ...] = (
    4096, 16384, 65536, 262144, 1 << 20, 4 << 20, 16 << 20, 64 << 20,
    256 << 20, 1 << 30)


class _Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with _lock:
            self.value += amount


class _Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        with _lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with _lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _Histogram:
    __slots__ = ("edges", "counts", "sum", "count", "exemplars")

    def __init__(self, edges: Tuple[float, ...]):
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)   # last slot = +Inf
        self.sum = 0.0
        self.count = 0
        # OpenMetrics exemplars: bucket index -> (labels, value, ts).
        # None until the first exemplar so plain observes stay
        # allocation-free; kept as last-write-wins per bucket.
        self.exemplars = None

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        i = 0
        edges = self.edges
        n = len(edges)
        # linear scan: bucket lists are ~a dozen entries, and bisect on a
        # tuple of floats is not faster at this size
        while i < n and value > edges[i]:
            i += 1
        with _lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1
            if exemplar is not None:
                if self.exemplars is None:
                    self.exemplars = {}
                self.exemplars[i] = (dict(exemplar), value, time.time())


_KINDS = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class _Family:
    """One named metric with a fixed label schema and per-labelset children."""

    __slots__ = ("name", "kind", "help", "labelnames", "buckets", "children")

    def __init__(self, name, kind, help="", labelnames=(), buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        self.children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *values) -> object:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values!r}")
        key = tuple(str(v) for v in values)
        child = self.children.get(key)
        if child is None:
            with _lock:
                child = self.children.get(key)
                if child is None:
                    if len(self.children) >= _MAX_CHILDREN:
                        key = (_OVERFLOW_LABEL,) * len(self.labelnames)
                        child = self.children.get(key)
                        if child is not None:
                            return child
                    child = (_Histogram(self.buckets)
                             if self.kind == "histogram"
                             else _KINDS[self.kind]())
                    self.children[key] = child
        return child

    # label-less convenience: family with no labelnames acts as its child
    def _solo(self):
        return self.labels()

    def inc(self, amount: float = 1.0):
        self._solo().inc(amount)

    def set(self, value: float):
        self._solo().set(value)

    def dec(self, amount: float = 1.0):
        self._solo().dec(amount)

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None):
        self._solo().observe(value, exemplar=exemplar)


def _get_or_create(name, kind, help, labelnames, buckets=None) -> _Family:
    fam = _registry.get(name)
    if fam is not None:
        if (fam.kind != kind or fam.labelnames != tuple(labelnames)
                or (buckets is not None and fam.buckets != tuple(buckets))):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.labelnames} and buckets {fam.buckets}")
        return fam
    with _lock:
        fam = _registry.get(name)
        if fam is None:
            fam = _Family(name, kind, help, labelnames, buckets)
            _registry[name] = fam
    return fam


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> _Family:
    """Get or create a monotonically-increasing counter family."""
    return _get_or_create(name, "counter", help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> _Family:
    """Get or create a gauge (set/inc/dec) family."""
    return _get_or_create(name, "gauge", help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = LATENCY_BUCKETS) -> _Family:
    """Get or create a fixed-bucket histogram family."""
    edges = tuple(sorted(float(b) for b in buckets))
    if not edges:
        raise ValueError("histogram needs at least one bucket edge")
    return _get_or_create(name, "histogram", help, labelnames, edges)


def reset() -> None:
    """Drop all registered metrics (values AND families).

    Instrumentation re-creates families lazily through the ``record_*``
    helpers, so a full clear is safe; tests use this for isolation.
    """
    with _lock:
        _registry.clear()


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def snapshot() -> Dict:
    """Point-in-time dict of every metric (the JSON exporter's payload)."""
    out: Dict = {"enabled": _state.enabled, "metrics": {}}
    with _lock:
        families = list(_registry.values())
    for fam in families:
        samples: List[Dict] = []
        with _lock:
            children = list(fam.children.items())
        for key, child in children:
            labels = dict(zip(fam.labelnames, key))
            if fam.kind == "histogram":
                with _lock:
                    counts = list(child.counts)
                    hsum, hcount = child.sum, child.count
                    exemplars = (dict(child.exemplars)
                                 if child.exemplars else None)
                cum = 0
                buckets = {}
                edges = list(fam.buckets) + [math.inf]
                ex_out = {}
                for i, (edge, c) in enumerate(zip(edges, counts)):
                    cum += c
                    le = _fmt_float(edge)
                    buckets[le] = cum
                    if exemplars is not None and i in exemplars:
                        xlabels, xval, xts = exemplars[i]
                        ex_out[le] = {"labels": xlabels, "value": xval,
                                      "ts": xts}
                buckets["+Inf"] = hcount
                sample = {"labels": labels, "sum": hsum,
                          "count": hcount, "buckets": buckets}
                if ex_out:
                    sample["exemplars"] = ex_out
                samples.append(sample)
            else:
                samples.append({"labels": labels, "value": child.value})
        out["metrics"][fam.name] = {
            "type": fam.kind, "help": fam.help, "samples": samples}
    return out


def dumps(indent: Optional[int] = None) -> str:
    """Structured JSON snapshot of all metrics."""
    return json.dumps(snapshot(), indent=indent, sort_keys=True)


def _fmt_float(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    s = repr(float(v))
    return s[:-2] if s.endswith(".0") else s


def _esc_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: Dict[str, str], extra: Tuple[str, str] = None) -> str:
    items = list(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_esc_label(str(v))}"' for k, v in items)
    return "{" + body + "}"


def prom_text() -> str:
    """Prometheus text exposition format (version 0.0.4) of all metrics."""
    snap = snapshot()
    lines: List[str] = []
    for name in sorted(snap["metrics"]):
        fam = snap["metrics"][name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for s in fam["samples"]:
            if fam["type"] == "histogram":
                exemplars = s.get("exemplars") or {}
                for le, cum in s["buckets"].items():
                    line = (f"{name}_bucket"
                            f"{_prom_labels(s['labels'], ('le', le))} {cum}")
                    ex = exemplars.get(le)
                    if ex is not None:
                        # OpenMetrics exemplar suffix:
                        #   ... 5 # {trace_id="deadbeef"} 0.053 1690000000.0
                        line += (f" # {_prom_labels(ex['labels'])} "
                                 f"{_fmt_float(ex['value'])}"
                                 + (f" {_fmt_float(ex['ts'])}"
                                    if ex.get("ts") is not None else ""))
                    lines.append(line)
                lines.append(
                    f"{name}_sum{_prom_labels(s['labels'])} "
                    f"{_fmt_float(s['sum'])}")
                lines.append(
                    f"{name}_count{_prom_labels(s['labels'])} {s['count']}")
            else:
                lines.append(
                    f"{name}{_prom_labels(s['labels'])} "
                    f"{_fmt_float(s['value'])}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Recorders
# ---------------------------------------------------------------------------

def record_fault_injected(site: str) -> None:
    """One fault fired by the injector (mxnet_tpu/fault.py)."""
    if not _state.enabled:
        return
    counter("mxnet_fault_injected_total",
            "Faults fired by the fault injector by site.",
            ("site",)).labels(site).inc()


def record_retry(site: str, outcome: str) -> None:
    """One retry event at a comms/IO site. ``outcome``: ``retry`` (one
    failed attempt), ``recovered`` (call succeeded after >=1 retry),
    ``exhausted`` (attempts used up, error surfaced)."""
    if not _state.enabled:
        return
    counter("mxnet_retry_total",
            "Retry events by site and outcome (retry/recovered/"
            "exhausted).", ("site", "outcome")).labels(site, outcome).inc()


def record_checkpoint_write(seconds: float) -> None:
    """One committed checkpoint bundle write (manifest valid on disk)."""
    if not _state.enabled:
        return
    histogram("mxnet_checkpoint_write_seconds",
              "Wall time to write + commit one checkpoint bundle.",
              buckets=STEP_BUCKETS).observe(seconds)


def record_serving_request(seconds: float, outcome: str = "ok",
                           trace_id: Optional[str] = None,
                           model: Optional[str] = None) -> None:
    """One served request, end-to-end (submit -> future resolved).
    ``outcome``: ``ok``, ``error`` (dispatch failed after retries) or
    ``rejected`` (queue full / server stopped — no latency recorded).
    p50/p99 come from the histogram quantiles. ``trace_id`` (when the
    request was traced) becomes an OpenMetrics exemplar on the latency
    bucket it lands in — the jump from "p99 is slow" to THE trace that
    explains it. ``model`` (multi-tenant serving) additionally counts
    the request into the per-tenant family
    ``mxnet_serving_tenant_requests_total{model,outcome}`` — the
    unlabeled family stays the fleet total, so existing dashboards and
    label sets are untouched."""
    if not _state.enabled:
        return
    counter("mxnet_serving_requests_total",
            "Serving requests by outcome (ok/error/rejected).",
            ("outcome",)).labels(outcome).inc()
    if model is not None:
        counter("mxnet_serving_tenant_requests_total",
                "Serving requests per tenant model, by outcome.",
                ("model", "outcome")).labels(model, outcome).inc()
    if outcome != "rejected":
        histogram("mxnet_serving_request_seconds",
                  "End-to-end request latency (submit to future "
                  "resolution).", buckets=SERVING_BUCKETS).observe(
            seconds,
            exemplar=({"trace_id": trace_id}
                      if trace_id is not None else None))


def record_serving_batch(n_real: int, capacity: int, reason: str) -> None:
    """One dispatched inference batch. ``reason``: what closed it —
    ``full`` (bucket capacity reached), ``deadline`` (oldest request
    neared its SLO), ``drain`` (server stopping)."""
    if not _state.enabled:
        return
    counter("mxnet_serving_batches_total",
            "Inference batches dispatched, by close reason "
            "(full/deadline/drain).", ("reason",)).labels(reason).inc()
    if capacity > 0:
        histogram("mxnet_serving_batch_occupancy",
                  "Real requests / padded bucket capacity per dispatched "
                  "batch.", buckets=OCCUPANCY_BUCKETS).observe(
                      n_real / capacity)
    pad = capacity - n_real
    if pad > 0:
        counter("mxnet_serving_padded_slots_total",
                "Padding rows dispatched to round batches up to their "
                "bucket.").inc(pad)


def record_serving_queue_time(seconds: float) -> None:
    """Time one request spent queued before its batch dispatched."""
    if not _state.enabled:
        return
    histogram("mxnet_serving_time_in_queue_seconds",
              "Time a request waited in the submission queue before "
              "batch dispatch.", buckets=SERVING_BUCKETS).observe(seconds)


def set_serving_queue_depth(depth: int) -> None:
    """Requests currently waiting in the server's submission queue."""
    if not _state.enabled:
        return
    gauge("mxnet_serving_queue_depth",
          "Requests waiting in the serving submission queue.").set(depth)


def record_serving_reload(seconds: float, outcome: str = "ok") -> None:
    """One hot-reload attempt (build + restore + warmup + swap)."""
    if not _state.enabled:
        return
    counter("mxnet_serving_reloads_total",
            "Model hot-reload attempts by outcome (ok/error).",
            ("outcome",)).labels(outcome).inc()
    if outcome == "ok":
        histogram("mxnet_serving_reload_seconds",
                  "Wall time to build, warm and swap in a reloaded "
                  "model.", buckets=STEP_BUCKETS).observe(seconds)


def record_serving_shed(reason: str, model: Optional[str] = None) -> None:
    """One request shed by admission control. ``reason``:
    ``queue_full`` (bounded queue at capacity), ``predicted_wait``
    (predicted queue wait exceeds the request's deadline), ``expired``
    (deadline blew while queued — the in-queue safety net),
    ``kvcache_full`` (a generate request that cannot fit the paged
    KV-cache budget) or ``throttled`` (a tenant's admission token
    bucket is empty). ``model`` additionally counts into
    ``mxnet_serving_tenant_shed_total{model,reason}`` — the isolation
    witness: under one tenant's overload, shed increments stay
    confined to that tenant's label."""
    if not _state.enabled:
        return
    counter("mxnet_serving_shed_total",
            "Requests shed by router admission control, by reason "
            "(queue_full/predicted_wait/expired/kvcache_full/"
            "throttled).",
            ("reason",)).labels(reason).inc()
    if model is not None:
        counter("mxnet_serving_tenant_shed_total",
                "Requests shed per tenant model, by reason.",
                ("model", "reason")).labels(model, reason).inc()


def record_decode_step(n_requests: int,
                       model: Optional[str] = None) -> None:
    """One continuous-batching decode step: a single (batch, 1)
    executable advancing ``n_requests`` co-batched completions by one
    token each. ``model`` counts the step into the per-tenant family
    ``mxnet_serving_tenant_decode_steps_total{model}``."""
    if not _state.enabled:
        return
    counter("mxnet_serving_decode_steps_total",
            "Autoregressive decode steps dispatched (one fused "
            "(batch, 1) executable per step).").inc()
    histogram("mxnet_serving_decode_batch_width",
              "Active completions co-batched per decode step.",
              buckets=(1, 2, 4, 8, 16, 32, 64)).observe(n_requests)
    if model is not None:
        counter("mxnet_serving_tenant_decode_steps_total",
                "Decode steps dispatched per tenant model.",
                ("model",)).labels(model).inc()


def record_token(seconds: float, model: Optional[str] = None) -> None:
    """One emitted token's inter-token latency (prefill first token:
    submit -> first token, i.e. TTFT). ``model`` counts the token into
    ``mxnet_serving_tenant_tokens_total{model}`` — per-tenant token
    share is the weighted-fairness witness."""
    if not _state.enabled:
        return
    counter("mxnet_serving_tokens_total",
            "Tokens emitted by autoregressive decode (prefill first "
            "tokens included).").inc()
    histogram("mxnet_serving_token_seconds",
              "Per-token latency: time since the previous token of the "
              "same completion (first token: since submit — TTFT).",
              buckets=SERVING_BUCKETS).observe(seconds)
    if model is not None:
        counter("mxnet_serving_tenant_tokens_total",
                "Tokens emitted per tenant model.",
                ("model",)).labels(model).inc()


def set_tenant_queue_depth(depth: int, model: str,
                           router: str = "") -> None:
    """Requests currently queued for ONE tenant model (replica level
    when ``router`` is empty, router level otherwise). Scraped into
    :class:`~.serving.controller.ScrapeFleetSignals` so the autoscaler
    sees per-tenant backlog, not just the fleet total."""
    if not _state.enabled:
        return
    gauge("mxnet_serving_tenant_queue_depth",
          "Requests waiting per tenant model (replica queues when "
          "router label is empty, router queue otherwise).",
          ("model", "router")).labels(model, router).set(depth)


def record_preemption(victim: str, beneficiary: str) -> None:
    """One priority preemption: ``victim``'s stream had its KV-cache
    pages reclaimed (between decode steps) for a higher-priority
    ``beneficiary`` arrival. Both are tenant model names — the counter
    answers "who preempted whom"."""
    if not _state.enabled:
        return
    counter("mxnet_serving_preempted_total",
            "Generate streams preempted, by victim and beneficiary "
            "tenant model.",
            ("victim", "beneficiary")).labels(victim, beneficiary).inc()


def record_kvcache_defrag(n_moves: int) -> None:
    """One automatic KV-cache defrag pass (pages packed between decode
    steps when fragmentation crossed the server's threshold)."""
    if not _state.enabled:
        return
    counter("mxnet_serving_kvcache_defrag_total",
            "Automatic KV-cache defrag passes.").inc()
    if n_moves > 0:
        counter("mxnet_serving_kvcache_defrag_moves_total",
                "Pages moved by automatic KV-cache defrag passes."
                ).inc(n_moves)


def set_kvcache_pages(free: int, used: int, reserved: int = 0) -> None:
    """Paged KV-cache arena occupancy, by page state."""
    if not _state.enabled:
        return
    g = gauge("mxnet_serving_kvcache_pages",
              "KV-cache arena pages by state (free/used/reserved).",
              ("state",))
    g.labels("free").set(free)
    g.labels("used").set(used)
    g.labels("reserved").set(reserved)


def record_optimizer_dispatch(path: str, n: int = 1) -> None:
    """One optimizer-phase update dispatch on the eager Trainer path.
    ``path``: ``per_param`` (one updater call per parameter) or
    ``fused_sweep`` (one multi-tensor sweep per dtype bucket)."""
    if not _state.enabled:
        return
    counter("mxnet_optimizer_dispatch_total",
            "Optimizer-phase update dispatches by path "
            "(per_param/fused_sweep).", ("path",)).labels(path).inc(n)


def record_step_skipped(reason: str) -> None:
    """One training step skipped by an anomaly guard. ``reason``:
    ``nonfinite_grad`` (the Trainer's ``check_nonfinite`` guard)."""
    if not _state.enabled:
        return
    counter("mxnet_steps_skipped_total",
            "Training steps skipped by anomaly guards, by reason.",
            ("reason",)).labels(reason).inc()


def record_data_wait(seconds: float, stage: str = "device_feed") -> None:
    """Time the consumer blocked waiting on an input-pipeline stage.

    The host-vs-device starvation discriminator: a real-data step whose
    ``mxnet_data_wait_seconds`` sum approaches wall time is host-starved
    (feed the device more); one near zero is device-bound (the pipeline
    keeps up)."""
    if not _state.enabled:
        return
    histogram("mxnet_data_wait_seconds",
              "Time the training loop blocked waiting for the input "
              "pipeline, by stage.", ("stage",)).labels(stage).observe(seconds)


def record_images_decoded(n: int) -> None:
    """Images decoded and augmented by the input pipeline."""
    if not _state.enabled or n <= 0:
        return
    counter("mxnet_data_decoded_images_total",
            "Images decoded and augmented by the input pipeline.").inc(n)


def chrome_counter_events(ts_us: Optional[float] = None) -> List[Dict]:
    """Current counter/gauge values as chrome-trace ``ph:"C"`` events
    (``profiler.dumps(format="chrome_trace")`` merges them onto its
    timeline); histograms contribute their ``_count`` and ``_sum``
    series."""
    if ts_us is None:
        ts_us = time.perf_counter() * 1e6
    events: List[Dict] = []
    for name, fam in sorted(snapshot()["metrics"].items()):
        for s in fam["samples"]:
            series = "/".join(v for v in s["labels"].values()) or "value"
            if fam["type"] == "histogram":
                args = {series + "_count": s["count"],
                        series + "_sum": s["sum"]}
            else:
                args = {series: s["value"]}
            events.append({"name": name, "ph": "C", "pid": 0, "tid": 0,
                           "ts": ts_us, "args": args})
    return events


def set_data_queue_depth(stage: str, depth: int) -> None:
    """Prefetched batches currently ready in a pipeline stage's queue."""
    if not _state.enabled:
        return
    gauge("mxnet_data_queue_depth",
          "Prefetched batches ready per input-pipeline stage.",
          ("stage",)).labels(stage).set(depth)


# ---------------------------------------------------------------------------
# The compilation service (reference telemetry.py:772-823, the same names)
# ---------------------------------------------------------------------------

def record_cache(cache: str, hit: bool) -> None:
    """One lookup in a compilation-service site cache."""
    if not _state.enabled:
        return
    counter("mxnet_jit_cache_total",
            "Compile-cache lookups by cache and result.",
            ("cache", "result")).labels(
                cache, "hit" if hit else "miss").inc()


def record_cache_eviction(cache: str, n: int = 1) -> None:
    """LRU eviction(s) from a site cache (or the disk tier,
    ``cache="persistent"``)."""
    if not _state.enabled:
        return
    counter("mxnet_jit_cache_evictions_total",
            "Compile-cache LRU evictions by cache.",
            ("cache",)).labels(cache).inc(n)


def record_cold_start(event: str, seconds: float) -> None:
    """A cold-start milestone (``compiler.mark_event``): seconds from
    package import to the first ``warm_start_done`` / ``first_train_step``
    / ``first_response``. Set once per event per process."""
    if not _state.enabled:
        return
    gauge("mxnet_coldstart_seconds",
          "Seconds from package import to each first-time lifecycle "
          "event.", ("event",)).labels(event).set(seconds)


def record_warm_start(outcome: str, n: int = 1) -> None:
    """Manifest warm-start replay outcomes (``replayed``: captured or
    built now, ``deduped``: already there, ``skipped``: no provider for
    the entry, ``failed``)."""
    if not _state.enabled:
        return
    counter("mxnet_compile_warm_total",
            "Signature-manifest warm-start entries by outcome.",
            ("outcome",)).labels(outcome).inc(n)


def record_training_step(seconds: float, examples: float,
                         mfu_pct: Optional[float] = None) -> None:
    if not _state.enabled:
        return
    counter("mxnet_training_steps_total", "Completed training steps.").inc()
    counter("mxnet_training_examples_total",
            "Examples consumed by training steps.").inc(examples)
    histogram("mxnet_training_step_seconds", "Training step wall time.",
              buckets=STEP_BUCKETS).observe(seconds)
    if seconds > 0:
        gauge("mxnet_training_examples_per_sec",
              "Throughput of the most recent training step.").set(
                  examples / seconds)
    if mfu_pct is not None:
        gauge("mxnet_training_mfu_pct",
              "Model-FLOP utilization of the most recent step (percent)."
              ).set(mfu_pct)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Data-parallel comms (reference telemetry.py:826-960, the same metric names)
# ---------------------------------------------------------------------------

def record_kv(op: str, nbytes: float, seconds: float) -> None:
    """One kvstore operation (push/pull/allreduce/row_sparse_pull)."""
    if not _state.enabled:
        return
    counter("mxnet_kvstore_calls_total",
            "KVStore operations by kind.", ("op",)).labels(op).inc()
    counter("mxnet_kvstore_bytes_total",
            "Payload bytes moved through the kvstore by kind.",
            ("op",)).labels(op).inc(float(nbytes))
    histogram("mxnet_kvstore_seconds",
              "Host-side kvstore call latency by kind.",
              ("op",)).labels(op).observe(seconds)


def record_kv_collective(path: str, n: int = 1) -> None:
    """One gradient-reduction dispatch on the comms path. ``path``:
    ``per_key`` (one reduce per parameter — the reference shape),
    ``bucketed`` (one exchange per fused gradient bucket), or ``zero``
    (one reduce-scatter + shard update + all-gather per ZeRO bucket);
    the reference's ``hierarchical`` label is kept in the help text and
    never recorded here (its topology is not ported)."""
    if not _state.enabled:
        return
    counter("mxnet_kvstore_collective_dispatch_total",
            "Gradient-reduction collective dispatches by path "
            "(per_key/bucketed/hierarchical/zero).", ("path",)).labels(path).inc(n)


def record_kv_bucket(nbytes: float, nkeys: int) -> None:
    """One fused gradient bucket exchanged by batched pushpull."""
    if not _state.enabled:
        return
    histogram("mxnet_kvstore_bucket_bytes",
              "Payload bytes per fused gradient bucket.",
              buckets=BYTES_BUCKETS).observe(float(nbytes))
    counter("mxnet_kvstore_bucketed_keys_total",
            "Parameter keys coalesced through bucketed pushpull."
            ).inc(nkeys)


def record_kv_bucket_fallback(reason: str, nkeys: int = 1) -> None:
    """Keys that fell OFF the fused bucketed-pushpull path back to the
    per-key exchange, or outside the ZeRO sharded sweep. ``reason``:
    ``row_sparse`` (non-default storage), ``zero_family`` (optimizer
    family the ZeRO shard sweep cannot reproduce bit-exactly, e.g.
    LAMB's cross-member trust-ratio norms), ``zero_multi_precision``,
    ``zero_sparse``, ``zero_layout`` (a weight not row-major).
    Observability for coverage gaps that used to be silent."""
    if not _state.enabled:
        return
    counter("mxnet_kvstore_bucket_fallback_total",
            "Keys excluded from fused bucketed pushpull by reason.",
            ("reason",)).labels(reason).inc(nkeys)


def record_optimizer_state_bytes(mode: str, nbytes: float) -> None:
    """Persistent optimizer-state bytes held by THIS rank, by layout
    ``mode``: ``replicated`` (every rank holds the full state — the
    reference KVStore shape), ``zero1`` / ``zero2`` (this rank's shard
    under ZeRO partitioning). The ZeRO engine publishes BOTH its actual
    per-rank bytes and the replicated-equivalent total, so the ~1/world
    memory drop is read directly off the gauge pair."""
    if not _state.enabled:
        return
    gauge("mxnet_optimizer_state_bytes",
          "Per-rank persistent optimizer-state bytes by layout mode.",
          ("mode",)).labels(mode).set(float(nbytes))


def record_kv_compression(ratio: float, elements: int) -> None:
    """One compressed bucket. ``ratio``: logical wire compression
    (uncompressed payload bits / 2-bit payload, e.g. 16x for fp32)."""
    if not _state.enabled:
        return
    gauge("mxnet_kvstore_compression_ratio",
          "Logical wire compression of the most recent compressed "
          "bucket (uncompressed bits / 2-bit quantized bits).").set(ratio)
    counter("mxnet_kvstore_compressed_elements_total",
            "Gradient elements through the 2-bit quantizer.").inc(elements)


def record_optimizer_bucket(nbytes: float, nparams: int) -> None:
    """One fused optimizer bucket swept (packed multi-tensor update)."""
    if not _state.enabled:
        return
    histogram("mxnet_optimizer_bucket_bytes",
              "Parameter bytes per fused optimizer sweep bucket.",
              buckets=BYTES_BUCKETS).observe(float(nbytes))
    counter("mxnet_optimizer_bucketed_params_total",
            "Parameters updated through fused multi-tensor sweeps."
            ).inc(nparams)


def record_kv_overlap(when: str, n: int = 1) -> None:
    """One gradient-bucket pushpull dispatched by the overlapped-comms
    trainer. ``when``: ``backward`` (issued from the grad-ready hook
    while autograd's reverse sweep was still running — the overlap win)
    or ``step`` (flushed by Trainer.step for buckets whose members never
    became ready in the backward)."""
    if not _state.enabled:
        return
    counter("mxnet_kvstore_overlap_dispatch_total",
            "Overlapped-comms bucket dispatches by phase "
            "(backward/step).", ("when",)).labels(when).inc(n)


# ---------------------------------------------------------------------------
# Training-step observability
# ---------------------------------------------------------------------------

def xla_cost_analysis(step, batch) -> Dict[str, float]:
    """The FLOPs of one step of ``step`` (a ``parallel.TrainStep``) on
    ``batch`` (``(data, label)``, each a tensor, an NDArray, a numpy
    array or a tuple of them), as ``{"flops": n}``.

    Unlike the reference's, this runs no update: the forward and the
    backward run on ``meta`` copies of the parameters and the batch
    under ``compiler.flops.counting()``, so nothing of the step, its
    optimizer or the random streams moves and nothing is computed. The
    count is of the work, whatever implements it: the matrix products
    PyTorch dispatches, and each kernel entry point's own formula
    (``compiler/flops.py``), so the same step counts the same on the CPU,
    on ``meta`` and on the card; a recompute (remat, the backward's) is
    not counted."""
    return {"flops": float(step.count_flops(*batch, meta=True))}


def _device_peak_flops() -> Optional[float]:
    """Dense bf16 peak of one card, for the MFU denominator: an H100
    SXM's 989 TFLOP/s (NVIDIA data sheet); None for another card or
    none."""
    import torch

    if not torch.cuda.is_available():
        return None
    return 989e12 if "H100" in torch.cuda.get_device_name(0) else None


class TrainingTelemetry:
    """Per-step observability hook for Gluon/Module training loops.

    Records step wall time, examples/sec and an MFU estimate into the
    telemetry registry (when enabled) and keeps the latest values as
    attributes (always), so it is usable standalone::

        tt = telemetry.TrainingTelemetry(batch_size=256,
                                         flops_per_step=fl, peak_flops=pk)
        for x, y in loader:
            with tt.step():
                loss, _ = train_step(x, y)
        print(tt.last_examples_per_sec, tt.last_mfu_pct)

    ``Module.fit``-style loops attach it as a batch-end callback
    (``batch_end_callback=tt.batch_end`` — step time is measured between
    consecutive calls, reference ``BatchEndParam`` contract).

    FLOP accounting: pass ``flops_per_step`` or ``flops_per_sample``
    (6ND-style), or build with :meth:`for_step`, which counts the step's
    own (:func:`xla_cost_analysis`). The MFU denominator is
    ``peak_flops`` or one card's dense bf16 peak x ``num_devices``
    (default ``torch.cuda.device_count()``; None on hosts with no known
    peak — MFU is skipped then).
    """

    def __init__(self, batch_size: int, flops_per_step: Optional[float] = None,
                 flops_per_sample: Optional[float] = None,
                 num_devices: Optional[int] = None,
                 peak_flops: Optional[float] = None):
        self.batch_size = batch_size
        self.flops_per_step = flops_per_step
        if flops_per_step is None and flops_per_sample is not None:
            self.flops_per_step = flops_per_sample * batch_size
        self._num_devices = num_devices
        self._peak = peak_flops
        self._peak_resolved = peak_flops is not None
        self._t0: Optional[float] = None
        self._last_batch_end: Optional[float] = None
        self.steps = 0
        self.last_step_seconds: Optional[float] = None
        self.last_examples_per_sec: Optional[float] = None
        self.last_mfu_pct: Optional[float] = None

    @classmethod
    def for_step(cls, step, batch, batch_size: int, **kwargs
                 ) -> "TrainingTelemetry":
        """Build with ``flops_per_step`` counted from ``step`` on
        ``batch`` by :func:`xla_cost_analysis` (no update runs)."""
        ca = xla_cost_analysis(step, batch)
        flops = float(ca.get("flops", 0.0)) or None
        return cls(batch_size, flops_per_step=flops, **kwargs)

    # -- explicit step timing -----------------------------------------
    def step_begin(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self) -> None:
        if self._t0 is None:
            return
        self._observe(time.perf_counter() - self._t0)
        self._t0 = None

    class _StepScope:
        __slots__ = ("tt",)

        def __init__(self, tt):
            self.tt = tt

        def __enter__(self):
            self.tt.step_begin()
            return self.tt

        def __exit__(self, *exc):
            self.tt.step_end()
            return False

    def step(self) -> "_StepScope":
        """Context manager timing one training step."""
        return self._StepScope(self)

    # -- Module.fit / BatchEndParam adapter ---------------------------
    def batch_end(self, param=None) -> None:
        """Batch-end callback: step time = time since the previous call
        (the first call only arms the clock)."""
        now = time.perf_counter()
        if getattr(param, "nbatch", None) == 0:
            # first batch of an epoch (reference BatchEndParam: nbatch
            # resets per epoch): the gap since the previous call spans
            # validation/checkpointing, not a training step — re-arm
            self._last_batch_end = now
            return
        if self._last_batch_end is not None:
            self._observe(now - self._last_batch_end)
        self._last_batch_end = now

    __call__ = batch_end

    # -- internals ----------------------------------------------------
    def _resolve_peak(self) -> Optional[float]:
        if not self._peak_resolved:
            per_chip = _device_peak_flops()
            if per_chip:
                if self._num_devices is None:
                    import torch

                    self._num_devices = torch.cuda.device_count()
                self._peak = per_chip * self._num_devices
            self._peak_resolved = True
        return self._peak

    def _observe(self, dt: float) -> None:
        self.steps += 1
        self.last_step_seconds = dt
        self.last_examples_per_sec = self.batch_size / dt if dt > 0 else None
        mfu = None
        if self.flops_per_step and dt > 0:
            peak = self._resolve_peak()
            if peak:
                mfu = 100.0 * self.flops_per_step / (dt * peak)
        self.last_mfu_pct = mfu
        record_training_step(dt, self.batch_size, mfu)
