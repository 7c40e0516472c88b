"""The compilation service: one cache spine for everything the port
captures or builds for the card.

Counterpart of ``mxnet_tpu/compiler/service.py``. Four pieces:

* :class:`SiteCache` — the LRU policy every site routes through (a
  hybridized block's CUDA graphs, the decode engine's graphs per batch
  bucket, a ``TrainStep``'s entry per batch signature), with a capacity
  per site and hit, miss and eviction telemetry
  (``mxnet_jit_cache_total{cache,result}``,
  ``mxnet_jit_cache_evictions_total{cache}``). An evicted entry is
  dropped, with its ``CUDAGraph`` and static tensors, and the site's
  ``on_evict`` hook releases what else it held.
* :class:`ExecutableTable` — single-flight builds keyed by fingerprint
  for NVRTC modules and the ``nvcc`` kernel build: N threads asking for
  one program run one build and share it; a failed build releases its
  slot. CUDA graphs bind their replica's own buffers, so they are never
  shared through it.
* :class:`GuardedExec` — a compiled callable with its eager fallback,
  for a site whose key does not pin the exact signature: the callable
  serves the calls its guard admits, the fallback every other. The
  port's own sites (``cached_op``, ``serving_decode``, ``train_step``)
  key by the exact signature and choose graph or eager before the
  lookup, so they hold their entries directly.
* :func:`warm_start` — replay a signature manifest (:mod:`.manifest`)
  before the first traffic: NVRTC and ``nvcc`` entries build on a thread
  pool; graph captures and train-step entries run on one thread per
  device, with the cyclic GC off (two captures at once on one device,
  or a graph freed by a cycle collection during a capture, break CUDA
  graphs).

Cold-start accounting: ``mark_event(name)`` records the first occurrence
of a milestone (``first_train_step``, ``first_response``,
``warm_start_done``) as seconds since the package began importing,
surfaced through ``events()`` and ``mxnet_coldstart_seconds{event}``.
"""
from __future__ import annotations

import collections
import gc
import logging
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

from . import keys, manifest as manifest_mod

__all__ = ["SiteCache", "ExecutableTable", "GuardedExec", "exec_table",
           "warm_start", "mark_event", "events", "seconds_since_import",
           "site_caches", "shared_cache"]

_log = logging.getLogger(__name__)

_events: Dict[str, float] = {}
_events_lock = threading.Lock()


def seconds_since_import() -> float:
    """Seconds since ``mxnet_tpu_torch`` began importing."""
    from .. import _IMPORT_T0

    return time.monotonic() - _IMPORT_T0


def mark_event(name: str) -> Optional[float]:
    """Record a cold-start milestone (first occurrence only). Returns the
    seconds since import it was recorded at, or None if already marked."""
    with _events_lock:
        if name in _events:
            return None
        t = seconds_since_import()
        _events[name] = t
    from .. import telemetry

    telemetry.record_cold_start(name, t)
    return t


def events() -> Dict[str, float]:
    """Cold-start milestones recorded so far: name -> seconds since the
    package began importing."""
    with _events_lock:
        return dict(_events)


# ---------------------------------------------------------------------------
# SiteCache
# ---------------------------------------------------------------------------

_MISS = object()


class SiteCache:
    """Thread-safe LRU over canonical signature keys for one cache site.

    ``maxsize=None`` is unbounded (entries live as long as their owner).
    Every lookup counts a hit or a miss (``hits``, ``misses``, and the
    telemetry counter when it is on); every eviction counts
    (``evictions``) and is logged at debug with its signature, and
    ``on_evict(key, value)`` runs for it outside the lock."""

    MISS = _MISS

    def __init__(self, site: str, maxsize: Optional[int] = None,
                 on_evict: Optional[Callable] = None):
        self.site = site
        self.maxsize = maxsize
        self.on_evict = on_evict
        self._od: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, key, record: bool = True):
        """Value for ``key`` (LRU-touched) or :attr:`MISS`; counts one hit
        or miss unless ``record=False``."""
        with self._lock:
            val = self._od.get(key, _MISS)
            if val is not _MISS:
                self._od.move_to_end(key)
            if record:
                if val is _MISS:
                    self.misses += 1
                else:
                    self.hits += 1
        if record:
            from .. import telemetry

            telemetry.record_cache(self.site, hit=val is not _MISS)
        return val

    def insert(self, key, value) -> None:
        evicted = []
        with self._lock:
            self._od[key] = value
            self._od.move_to_end(key)
            if self.maxsize is not None:
                while len(self._od) > self.maxsize:
                    evicted.append(self._od.popitem(last=False))
            self.evictions += len(evicted)
        if evicted:
            from .. import telemetry

            telemetry.record_cache_eviction(self.site, len(evicted))
            for k, v in evicted:
                _log.debug("cache %r: evicted signature %r (capacity %s)",
                           self.site, k, self.maxsize)
                if self.on_evict is not None:
                    self.on_evict(k, v)

    def pop(self, key, default=None):
        """Remove ``key`` (not an eviction: its owner let it go)."""
        with self._lock:
            return self._od.pop(key, default)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._od

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def clear(self) -> None:
        with self._lock:
            self._od.clear()

    def keys(self) -> list:
        with self._lock:
            return list(self._od)

    def values(self) -> list:
        with self._lock:
            return list(self._od.values())

    def items(self) -> list:
        with self._lock:
            return list(self._od.items())


_site_caches: Dict[str, SiteCache] = {}
_site_lock = threading.Lock()


def site_caches() -> Dict[str, SiteCache]:
    """The process-global site caches made so far (per-object caches, a
    block's graphs and a step's entries, are their owners' own)."""
    with _site_lock:
        return dict(_site_caches)


def shared_cache(site: str, maxsize: Optional[int] = None) -> SiteCache:
    """Process-global SiteCache for ``site`` (created on first use)."""
    with _site_lock:
        c = _site_caches.get(site)
        if c is None:
            c = _site_caches[site] = SiteCache(site, maxsize)
        return c


# ---------------------------------------------------------------------------
# ExecutableTable — single-flight in-process build dedupe
# ---------------------------------------------------------------------------

class _Pending:
    __slots__ = ("event",)

    def __init__(self):
        self.event = threading.Event()


class ExecutableTable:
    """fingerprint -> built value, with single-flight builds.

    ``get_or_build(fp, build)``: the first caller for a fingerprint runs
    ``build()``; concurrent callers for it block until it lands and share
    the result. A failed build releases the slot so a later caller can
    retry. LRU-bounded — eviction only drops the dedupe handle, never a
    value a caller holds."""

    def __init__(self, maxsize: int = 4096):
        self.maxsize = maxsize
        self._od: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.builds = 0          # build() calls that ran
        self.dedup_hits = 0      # calls served from the table
        self.waits = 0           # calls that blocked on another's build

    def get_or_build(self, fp: str, build: Callable):
        while True:
            wait_on = None
            with self._lock:
                entry = self._od.get(fp)
                if entry is None:
                    self._od[fp] = _Pending()
                elif isinstance(entry, _Pending):
                    wait_on = entry.event
                    self.waits += 1
                else:
                    self._od.move_to_end(fp)
                    self.dedup_hits += 1
                    return entry[0]
            if wait_on is not None:
                wait_on.wait()
                continue     # re-read: done (hit) or removed (retry)
            try:
                value = build()
            except BaseException:
                with self._lock:
                    entry = self._od.pop(fp, None)
                if isinstance(entry, _Pending):
                    entry.event.set()
                raise
            with self._lock:
                pending = self._od.get(fp)
                self._od[fp] = (value,)
                self._od.move_to_end(fp)
                self.builds += 1
                while len(self._od) > self.maxsize:
                    k, v = self._od.popitem(last=False)
                    if isinstance(v, _Pending):   # never evict in-flight
                        self._od[k] = v
                        self._od.move_to_end(k, last=False)
                        break
            if isinstance(pending, _Pending):
                pending.event.set()
            return value

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._od), "builds": self.builds,
                    "dedup_hits": self.dedup_hits, "waits": self.waits}

    def clear(self) -> None:
        with self._lock:
            pending = [v for v in self._od.values()
                       if isinstance(v, _Pending)]
            self._od.clear()
        for p in pending:
            p.event.set()


exec_table = ExecutableTable()


class GuardedExec:
    """A compiled callable (a captured graph's replay, say) with its eager
    fallback.

    ``compiled(*args)`` serves only the calls that ``accepts(*args)``
    admits (the signature it was captured at, in predict mode, on the
    card). Every other call runs ``fallback_factory()``'s callable, made
    once, for that call only."""

    __slots__ = ("compiled", "accepts", "_fallback_factory", "_fallback")

    def __init__(self, compiled, fallback_factory: Callable,
                 accepts: Callable):
        self.compiled = compiled
        self.accepts = accepts
        self._fallback_factory = fallback_factory
        self._fallback = None

    def _fb(self):
        if self._fallback is None:
            self._fallback = self._fallback_factory()
        return self._fallback

    def __call__(self, *args):
        if self.compiled is not None and self.accepts(*args):
            return self.compiled(*args)
        return self._fb()(*args)


# ---------------------------------------------------------------------------
# warm_start
# ---------------------------------------------------------------------------

# Per-provider serialization, PROCESS-GLOBAL: two entries (or two whole
# warm_start calls) targeting the same block or step must not race its
# state init or its captures. Weak-keyed so providers keep their own
# lifetimes. Captures on one device take that device's lock as well.
_provider_locks: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_device_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def _provider_lock(provider) -> threading.Lock:
    with _locks_guard:
        lock = _provider_locks.get(provider)
        if lock is None:
            lock = _provider_locks[provider] = threading.Lock()
        return lock


def _device_lock(device: str) -> threading.Lock:
    with _locks_guard:
        lock = _device_locks.get(device)
        if lock is None:
            lock = _device_locks[device] = threading.Lock()
        return lock


def _resolve_entries(manifest) -> List[dict]:
    if manifest is None:
        m = manifest_mod.recorder()
        if m is None:
            m = manifest_mod.Manifest()
        return m.entries()
    if isinstance(manifest, str):
        return manifest_mod.Manifest(manifest).entries()
    if isinstance(manifest, manifest_mod.Manifest):
        return manifest.entries()
    return list(manifest)


def _provider_device(provider) -> str:
    """The device a block's or a step's captures run on."""
    dev = getattr(provider, "_device", None)
    if dev is None:
        try:
            dev = next(provider.parameters()).device
        except (StopIteration, AttributeError, TypeError):
            return "cpu"
    return str(dev)


def _replay(entry: dict, provider) -> str:
    site, spec = entry["site"], entry["spec"]
    if site == "nvrtc":
        from .. import rtc

        return rtc.warm_spec(spec)
    if site == "kernels":
        from ..kernels import _build

        return _build.warm_spec(spec)
    if provider is None:
        return "skipped"
    if site == "cached_op":
        from ..gluon import block as block_mod

        return block_mod.warm_cached_op_spec(provider, spec)
    if site == "serving_decode":
        from ..gluon.model_zoo.nlp import llama

        return llama.warm_decode_spec(provider, spec)
    if site == "train_step":
        return provider.warm_from_spec(spec)
    return "skipped"


def warm_start(manifest=None, *, blocks: Sequence = (),
               train_steps: Sequence = (),
               max_workers: Optional[int] = None) -> dict:
    """Replay a signature manifest so this process starts hot.

    ``manifest``: a path, a :class:`~.manifest.Manifest`, a loaded entry
    list, or None (= the active recorder's journal, else the default
    manifest of the disk tier).

    ``blocks``: live blocks to warm ``cached_op`` entries (a hybridized
    block's graphs) and ``serving_decode`` entries (the decode graphs of
    the block's live engines, only the recorded buckets) against,
    matched by structural :func:`~.keys.graph_ident`. ``train_steps``:
    live TrainSteps to warm ``train_step`` entries against (settle,
    states, kernel libraries; no update). ``nvrtc`` and ``kernels``
    entries need no provider and build on a pool of ``max_workers``
    threads (default 4); entries with no provider are skipped, which is
    not fatal. Device entries run after them, one thread per device,
    with the cyclic GC off.

    Returns ``{"replayed", "deduped", "skipped", "failed", "entries",
    "seconds"}``; a failed entry is logged with its traceback."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    entries = _resolve_entries(manifest)
    report = {"replayed": 0, "deduped": 0, "skipped": 0, "failed": 0,
              "entries": len(entries), "seconds": 0.0}
    by_ident = {}
    for b in blocks:
        by_ident[("block", keys.graph_ident(b))] = b
    for s in train_steps:
        by_ident[("step", s.warm_ident())] = s

    def provider(entry):
        spec = entry.get("spec")
        if not isinstance(spec, dict):
            return None
        if entry["site"] in ("cached_op", "serving_decode"):
            return by_ident.get(("block", spec.get("graph")))
        if entry["site"] == "train_step":
            return by_ident.get(("step", spec.get("ident")))
        return None

    def one(entry, prov):
        try:
            if prov is None:
                return _replay(entry, None)
            with _provider_lock(prov):
                return _replay(entry, prov)
        except Exception:  # noqa: BLE001 - counted, logged, warm goes on
            _log.warning("warm_start: replay failed for site %s",
                         entry.get("site"), exc_info=True)
            return "failed"

    pooled, per_device, outcomes = [], {}, []
    for e in entries:
        prov = provider(e)
        if e["site"] in ("nvrtc", "kernels"):
            pooled.append(e)
        elif prov is None:
            outcomes.append("skipped")
        else:
            per_device.setdefault(_provider_device(prov), []).append(
                (e, prov))
    if pooled:
        n = max(1, min(max_workers or 4, len(pooled)))
        with ThreadPoolExecutor(max_workers=n,
                                thread_name_prefix="mx-warm") as pool:
            outcomes += list(pool.map(lambda e: one(e, None), pooled))

    def device_run(dev, items, out):
        with _device_lock(dev):
            for e, prov in items:
                out.append(one(e, prov))

    if per_device:
        gc_was = gc.isenabled()
        gc.disable()
        try:
            results = {dev: [] for dev in per_device}
            threads = [threading.Thread(
                target=device_run, args=(dev, items, results[dev]),
                name=f"mx-warm-{dev}") for dev, items in per_device.items()]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            for dev, items in per_device.items():
                got = results[dev]
                outcomes += got + ["failed"] * (len(items) - len(got))
        finally:
            if gc_was:
                gc.enable()
    for oc in outcomes:
        report[oc if oc in report else "failed"] += 1
    report["seconds"] = time.perf_counter() - t0
    mark_event("warm_start_done")
    from .. import telemetry

    for oc in ("replayed", "deduped", "skipped", "failed"):
        if report[oc]:
            telemetry.record_warm_start(oc, report[oc])
    return report
