"""Replica health primitives for the multi-replica serving router.

Counterpart of ``mxnet_tpu/serving/health.py``, copied whole. The
single-replica ``Server`` touches its :class:`Heartbeat` once per
scheduler turn; the router that reads it comes with the fleet.

Two building blocks, both lock-cheap and dependency-free:

* :class:`CircuitBreaker` — the per-replica health automaton the
  :class:`~.router.Router` consults before every dispatch. Three states,
  the classic cycle::

        CLOSED --(N consecutive failures | hung dispatch)--> OPEN
        OPEN   --(cooldown elapsed)-------------------------> HALF_OPEN
        HALF_OPEN --(probe succeeds)------------------------> CLOSED
        HALF_OPEN --(probe fails)---------------------------> OPEN

  CLOSED admits traffic freely; OPEN admits nothing until its cooldown
  elapses; HALF_OPEN admits exactly ONE in-flight request (the probe) —
  a recovered replica is re-admitted by one cheap canary instead of a
  thundering herd, and a still-broken one costs one retried request,
  not a queue. Repeated trips back off: the cooldown doubles per
  consecutive OPEN (capped at 16x) and resets on a successful close.

* :class:`Heartbeat` — the in-process liveness beacon, the PR-8 elastic
  heartbeat pattern (``parallel/elastic.py``'s per-rank file touches)
  without the filesystem: the watched loop calls :meth:`Heartbeat.touch`
  every iteration, a watchdog thread checks :meth:`Heartbeat.stale`.
  A scheduler thread that is *alive but wedged* (stuck dispatch, lost
  lock) looks exactly like a dead one — the failure PR 8 showed file
  heartbeats catch and ``Thread.is_alive()`` cannot.

Env knobs (read at construction so tests can monkeypatch):
``MXNET_SERVING_BREAKER_FAILURES`` (3) — consecutive dispatch failures
that trip CLOSED -> OPEN; ``MXNET_SERVING_BREAKER_COOLDOWN`` (1.0 s) —
base OPEN -> HALF_OPEN delay; ``MXNET_SERVING_DISPATCH_TIMEOUT``
(30 s) — a replica scheduler heartbeat silent longer than this while
requests are in flight there is a *hung dispatch* and trips the
breaker immediately (read by the router; must exceed the longest
legitimate single model dispatch).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from ..base import MXNetError

__all__ = ["CircuitBreaker", "Heartbeat",
           "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_COOLDOWN_BACKOFF_CAP = 16.0   # cooldown doubles per consecutive trip, to 16x


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError as e:
        raise MXNetError(f"{name}={raw!r} is not a number") from e


class Heartbeat:
    """In-process liveness beacon (the elastic heartbeat, file-free).

    The watched loop ``touch()``es once per iteration; a monitor asks
    ``stale(timeout)``. ``touch`` is a single float store (atomic under
    the GIL) so it costs nothing on the hot path.
    """

    __slots__ = ("_t",)

    def __init__(self):
        self._t = time.monotonic()

    def touch(self) -> None:
        self._t = time.monotonic()

    def age(self) -> float:
        return time.monotonic() - self._t

    def stale(self, timeout: float) -> bool:
        return self.age() > timeout


class CircuitBreaker:
    """Per-replica dispatch health automaton (thread-safe).

    The router asks :meth:`admit` before routing a request at the
    replica; every finished dispatch reports :meth:`record_success` or
    :meth:`record_failure`; a dispatch the router declares hung reports
    :meth:`record_hang` (trips immediately — a wedged replica must not
    get ``failure_threshold`` more requests to prove itself dead).
    """

    def __init__(self, name: str = "replica",
                 failure_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 time_fn=time.monotonic):
        if failure_threshold is None:
            failure_threshold = int(_env_float(
                "MXNET_SERVING_BREAKER_FAILURES", 3))
        if cooldown_s is None:
            cooldown_s = _env_float("MXNET_SERVING_BREAKER_COOLDOWN", 1.0)
        if failure_threshold < 1:
            raise MXNetError(
                f"breaker failure threshold must be >= 1, got "
                f"{failure_threshold}")
        if cooldown_s <= 0:
            raise MXNetError(
                f"breaker cooldown must be > 0, got {cooldown_s}")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._time = time_fn
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._open_streak = 0        # consecutive OPENs since last close
        self._probe_inflight = False
        self.n_trips = 0             # lifetime CLOSED/HALF_OPEN -> OPEN

    # -- state ---------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _cooldown(self) -> float:
        return self.cooldown_s * min(
            2.0 ** max(self._open_streak - 1, 0), _COOLDOWN_BACKOFF_CAP)

    def _maybe_half_open(self) -> None:
        # caller holds the lock
        if self._state == OPEN and \
                self._time() - self._opened_at >= self._cooldown():
            self._state = HALF_OPEN
            self._probe_inflight = False

    def _trip(self) -> None:
        # caller holds the lock
        self._state = OPEN
        self._opened_at = self._time()
        self._open_streak += 1
        self._probe_inflight = False
        self._consecutive_failures = 0
        self.n_trips += 1

    # -- router-facing protocol ----------------------------------------
    def admit(self) -> bool:
        """May one request be routed at this replica right now?

        CLOSED: always. OPEN: no (flips to HALF_OPEN once the cooldown
        elapsed, then admits). HALF_OPEN: exactly one — the caller that
        gets ``True`` owns the probe; everyone else is refused until
        the probe reports back.
        """
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        """A dispatch at this replica resolved OK."""
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                # the probe came back healthy: full re-admission
                self._state = CLOSED
                self._probe_inflight = False
                self._open_streak = 0

    def record_failure(self) -> None:
        """A dispatch at this replica failed (typed error after the
        replica's own retries). HALF_OPEN: the probe failed — re-open.
        CLOSED: trips after ``failure_threshold`` consecutive ones."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._trip()
                return
            if self._state == OPEN:     # late failure from a pre-trip
                return                  # dispatch: already quarantined
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.failure_threshold:
                self._trip()

    def release_probe(self) -> None:
        """The caller claimed the HALF_OPEN probe slot but never
        dispatched (routing fault, replica refused the submit): free
        the slot so the next request can probe instead of stalling
        recovery until a timeout."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = False

    def record_hang(self) -> None:
        """A dispatch exceeded the dispatch timeout: trip immediately,
        whatever the consecutive-failure count — a wedged replica gets
        no benefit of the doubt."""
        with self._lock:
            if self._state != OPEN:
                self._trip()
            else:
                # already quarantined; refresh the clock so the cooldown
                # measures from the LATEST evidence of brokenness
                self._opened_at = self._time()

    def describe(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "trips": self.n_trips,
                    "cooldown_s": self._cooldown()}
