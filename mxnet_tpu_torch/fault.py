"""``mx.fault`` — deterministic, seeded fault injection + bounded retry.

Counterpart of ``mxnet_tpu/fault.py``, copied: the spec grammar, the
sites, the seeded injector and ``retry_call`` are the reference's. The
one difference is :func:`is_transient`: the reference keys on XLA status
strings; here an injected fault and ``torch.OutOfMemoryError`` (XLA's
RESOURCE_EXHAUSTED) are transient, and a CUDA error (an illegal address,
a launch failure) never is, since it leaves the context unusable. Of the
sites, the port instruments ``serving.dispatch``, ``serving.reload``,
``checkpoint.write`` and ``checkpoint.read`` so far.

The reference stack survives production because its failure paths are
exercised constantly: the dependency engine propagates op failures
deterministically (ThreadedVar ``ExceptionRef``), the distributed KVStore
tolerates flaky workers, and checkpoints are the resume contract. A
reproduction with only happy paths cannot claim those properties — this
module makes the failure paths *testable*:

* **Named injection sites.** Instrumented layers call
  :func:`check` at a named point — ``engine.dispatch`` (every imperative
  op dispatch), ``kvstore.push`` / ``kvstore.pull`` /
  ``kvstore.allreduce`` (comms), ``checkpoint.write`` /
  ``checkpoint.read`` (every atomic file commit / checkpoint load),
  ``kvstore.barrier`` (every bounded cross-process rendezvous),
  ``datafeed.put`` (each batch staged by the async input pipeline —
  ``io.DeviceFeedIter``), ``serving.dispatch`` (every inference batch
  the model server dispatches), ``serving.reload`` (every model
  hot-reload — ``serving.Server``), ``serving.replica`` (every batch a
  Router-managed replica dispatches; the dotted sub-sites
  ``serving.replica.<i>`` target one replica — kill or wedge exactly
  one instance of the fleet), ``serving.route`` (every routing
  decision the serving Router makes), ``serving.ingress`` (every
  submit frame the socket ingress handles), ``worker.spawn`` (every
  replica worker process launch — dotted ``worker.spawn.<i>``
  sub-sites target one worker's spawn path), ``elastic.heartbeat`` (every
  liveness touch of the elastic runtime) and ``elastic.rejoin`` (every
  epoch-transition restore — ``parallel.elastic.ElasticRunner``).
  Like telemetry, every call site guards on one module-level flag
  (``_state.enabled`` — a single attribute load + branch), so the
  disabled fast path costs one branch and allocates nothing.

* **Policies.** ``MXNET_FAULT_SPEC`` (or :func:`inject` /
  :func:`install`) maps sites to policies::

      site=policy[;site=policy...]

      once        raise FaultInjected on the first hit, pass afterwards
      nth:N       raise on exactly the Nth hit (fail "mid-write")
      every:N     raise on every Nth hit (N, 2N, 3N, ...)
      p:F         raise each hit with probability F (seeded RNG)
      latency:S   sleep S seconds on every hit (slow, not broken)

  ``site`` may be ``*`` to match every instrumented point. All
  randomness comes from one ``random.Random(MXNET_FAULT_SEED)`` so a
  chaos run is reproducible bit-for-bit (``tools/chaos_check.py``).

* **Bounded retry.** :func:`retry_call` is the comms retry/backoff
  primitive the KVStore wraps its device work in: bounded attempts
  (``MXNET_COMM_RETRY_ATTEMPTS``), exponential backoff from
  ``MXNET_COMM_RETRY_DELAY`` with jitter drawn from the injector RNG,
  and a clear ``MXNetError`` naming the site, detail (key) and attempt
  count on exhaustion. Only *transient* failures are retried —
  injected faults and running out of device memory — so deterministic
  bugs still fail fast.

Telemetry (``MXNET_TELEMETRY=1``): ``mxnet_fault_injected_total{site}``,
``mxnet_retry_total{site,outcome}``.
"""
from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from typing import Dict, Optional, Tuple

from .base import MXNetError

__all__ = [
    "FaultInjected", "check", "inject", "install", "clear",
    "enable", "disable", "active", "stats", "parse_spec",
    "retry_call", "is_transient", "has_policy", "SITES",
]

# The instrumented points (documentation + spec validation). check() with
# an unlisted name still works — the list is the contract, not a cage.
SITES = (
    "engine.dispatch",
    "kvstore.push",
    "kvstore.pull",
    "kvstore.allreduce",
    "kvstore.barrier",
    "checkpoint.write",
    "checkpoint.read",
    "datafeed.put",
    "serving.dispatch",
    "serving.reload",
    "serving.replica",
    "serving.route",
    "serving.upgrade",
    "serving.ingress",
    "controller.scale",
    "worker.spawn",
    "elastic.heartbeat",
    "elastic.rejoin",
)

# Site families whose instrumented points check dotted per-instance
# sub-sites (``<family>.<i>``) in addition to the family name.
_SUBSITE_FAMILIES = ("serving.replica", "worker.spawn")


class FaultInjected(MXNetError):
    """An error raised by the fault injector (always retry-transient)."""

    def __init__(self, site: str, hit: int, detail: str = ""):
        self.site = site
        self.hit = hit
        self.detail = detail
        extra = f" ({detail})" if detail else ""
        super().__init__(
            f"injected fault at {site}{extra} [hit #{hit}]")


class _State:
    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled


# THE fast-path guard: instrumented modules read `_state.enabled` directly
# (one attribute load + branch; never swap the _State instance, callers
# cache a reference to it) — same pattern as telemetry._state.
_state = _State(False)

_lock = threading.Lock()
_sites: Dict[str, "_Policy"] = {}
_rng = random.Random(int(os.environ.get("MXNET_FAULT_SEED", "0")))


class _Policy:
    """One site's policy: decides per hit whether to fire, thread-safely."""

    __slots__ = ("kind", "arg", "hits", "injected")

    def __init__(self, kind: str, arg: float = 0.0):
        self.kind = kind
        self.arg = arg
        self.hits = 0
        self.injected = 0

    def hit(self) -> Tuple[str, int]:
        """Count one hit; return ("fail"|"sleep"|"pass", hit_number)."""
        with _lock:
            self.hits += 1
            n = self.hits
            kind = self.kind
            if kind == "once":
                fire = n == 1
            elif kind == "nth":
                fire = n == int(self.arg)
            elif kind == "every":
                fire = n % int(self.arg) == 0
            elif kind == "p":
                fire = _rng.random() < self.arg
            elif kind == "latency":
                self.injected += 1
                return "sleep", n
            else:  # pragma: no cover - parse_spec rejects unknown kinds
                fire = False
            if fire:
                self.injected += 1
                return "fail", n
            return "pass", n

    def describe(self) -> str:
        return self.kind if self.kind in ("once",) else \
            f"{self.kind}:{self.arg:g}"


def parse_spec(spec: str) -> Dict[str, _Policy]:
    """Parse an ``MXNET_FAULT_SPEC`` string into ``{site: policy}``.

    Raises :class:`MXNetError` on malformed grammar — a chaos run that
    silently injects nothing is worse than one that fails to start.
    """
    out: Dict[str, _Policy] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise MXNetError(
                f"fault spec entry {part!r} is not site=policy "
                f"(spec grammar: site=once|nth:N|every:N|p:F|latency:S)")
        site, policy = part.split("=", 1)
        site = site.strip()
        policy = policy.strip()
        # dotted SUB-sites name one instance of a replicated layer —
        # allowed ONLY for families whose instrumented points actually
        # check per-instance sub-sites (currently serving.replica.<i>,
        # the Router's replica targeting); accepting them under every
        # site would let kvstore.push.0=once install and silently
        # never fire, defeating the typo-catching point of SITES
        if site != "*" and site not in SITES and not any(
                site.startswith(fam + ".")
                and site[len(fam) + 1:].isdigit()
                for fam in _SUBSITE_FAMILIES):
            raise MXNetError(
                f"unknown fault site {site!r}; known sites: "
                f"{', '.join(SITES)} (or '*' for all, or a per-instance "
                "sub-site of " + "/".join(_SUBSITE_FAMILIES)
                + " like serving.replica.0 — the suffix is the integer "
                "instance index)")
        kind, _, arg = policy.partition(":")
        kind = kind.strip()
        try:
            if kind == "once":
                if arg:
                    raise ValueError("'once' takes no argument")
                pol = _Policy("once")
            elif kind in ("nth", "every"):
                n = int(arg)
                if n < 1:
                    raise ValueError(f"'{kind}' needs N >= 1")
                pol = _Policy(kind, n)
            elif kind == "p":
                f = float(arg)
                if not 0.0 <= f <= 1.0:
                    raise ValueError("'p' needs 0 <= F <= 1")
                pol = _Policy("p", f)
            elif kind == "latency":
                s = float(arg)
                if s < 0:
                    raise ValueError("'latency' needs S >= 0")
                pol = _Policy("latency", s)
            else:
                raise ValueError(
                    "policy must be once | nth:N | every:N | p:F | "
                    "latency:S")
        except ValueError as e:
            raise MXNetError(
                f"bad fault policy {policy!r} for site {site!r}: {e}") \
                from e
        out[site] = pol
    return out


def install(spec, seed: Optional[int] = None) -> None:
    """Install a fault spec (string or ``{site: policy}``) and enable
    injection. ``seed`` reseeds the injector RNG (default: keep)."""
    global _sites
    policies = parse_spec(spec) if isinstance(spec, str) else dict(spec)
    with _lock:
        _sites = policies
        if seed is not None:
            _rng.seed(int(seed))
    _state.enabled = bool(policies)


def clear() -> None:
    """Disable injection and drop all site policies."""
    global _sites
    _state.enabled = False
    with _lock:
        _sites = {}


def enable() -> None:
    _state.enabled = True


def disable() -> None:
    _state.enabled = False


def active() -> bool:
    return _state.enabled


def has_policy(site: str) -> bool:
    """Is a policy installed for exactly ``site`` (no ``*`` fallback)?

    For replicated layers whose instances check dotted sub-sites
    (``serving.replica.<i>``): the family check already honours ``*``,
    so instance checks guard on this to avoid double-counting the
    wildcard policy's hits."""
    with _lock:
        return site in _sites


def stats() -> Dict[str, Dict[str, int]]:
    """Per-site ``{"hits": n, "injected": k}`` for the installed spec."""
    with _lock:
        return {site: {"hits": p.hits, "injected": p.injected,
                       "policy": p.describe()}
                for site, p in _sites.items()}


@contextlib.contextmanager
def inject(spec, seed: Optional[int] = None):
    """Scoped injection: install ``spec``, enable, restore prior state on
    exit (the test-facing entry point)::

        with fault.inject("kvstore.allreduce=once"):
            trainer.step(batch_size)   # first allreduce fails, retry wins
    """
    global _sites
    with _lock:
        prev_sites = _sites
        prev_rng = _rng.getstate()
    prev_enabled = _state.enabled
    install(spec, seed=seed)
    try:
        yield stats
    finally:
        with _lock:
            _sites = prev_sites
            _rng.setstate(prev_rng)
        _state.enabled = prev_enabled


def check(site: str, detail: str = "") -> None:
    """One pass through a named injection point.

    No-op unless injection is enabled AND a policy matches ``site`` (or
    ``*``). Raises :class:`FaultInjected` or sleeps per the policy.
    Call sites on hot paths guard with ``if _state.enabled:`` themselves
    so the disabled cost is a single branch.
    """
    if not _state.enabled:
        return
    pol = _sites.get(site)
    if pol is None:
        pol = _sites.get("*")
        if pol is None:
            return
    action, n = pol.hit()
    if action == "pass":
        return
    from . import telemetry, tracing

    if telemetry._state.enabled:
        telemetry.record_fault_injected(site)
    if tracing._state.enabled:
        # annotate the live span (if any request trace is ambient on
        # this thread): the injected fault becomes part of the story
        # the dumped trace tells
        tracing.note(f"fault injected: {site}"
                     + (f" ({detail})" if detail else ""))
    if action == "sleep":
        time.sleep(pol.arg)
        return
    raise FaultInjected(site, n, detail)


# ---------------------------------------------------------------------------
# Bounded retry with exponential backoff — the comms resilience primitive.
# ---------------------------------------------------------------------------

def is_transient(exc: BaseException) -> bool:
    """Is ``exc`` worth retrying? Injected faults, and the card running
    out of memory (freed memory may let the next attempt fit). Nothing
    else: a CUDA error such as an illegal address or a launch failure
    leaves the context unusable, and a retry would only mask it."""
    if isinstance(exc, FaultInjected):
        return True
    import torch

    return isinstance(exc, torch.OutOfMemoryError)


def retry_call(site: str, fn, detail: str = "",
               attempts: Optional[int] = None,
               base_delay: Optional[float] = None):
    """Run ``fn()`` with bounded exponential-backoff retry on transient
    failures.

    ``attempts`` (>=1) and ``base_delay`` default to the
    ``MXNET_COMM_RETRY_ATTEMPTS`` (3) / ``MXNET_COMM_RETRY_DELAY``
    (0.05 s) env knobs, read per call so tests can monkeypatch them.
    Delay doubles per retry with up to +25% jitter from the seeded
    injector RNG (deterministic chaos runs stay deterministic). On
    exhaustion raises :class:`MXNetError` naming the site, detail and
    attempt count, chained to the last underlying failure.
    """
    # hot path: the first attempt runs bare — no env parsing, no
    # telemetry import, no loop state. A fault-free call (the only kind
    # a healthy training step makes, per key per step) costs one
    # try/except frame on top of fn() itself.
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - filtered by is_transient
        if not is_transient(e):
            raise
        last = e

    # failure path: now resolve the knobs and enter the backoff loop
    if attempts is None:
        attempts = int(os.environ.get("MXNET_COMM_RETRY_ATTEMPTS", "3"))
    if attempts < 1:
        raise MXNetError(f"retry attempts must be >= 1, got {attempts}")
    if base_delay is None:
        base_delay = float(os.environ.get("MXNET_COMM_RETRY_DELAY", "0.05"))
    from . import telemetry, tracing

    attempt = 1
    while True:
        if telemetry._state.enabled:
            telemetry.record_retry(site, "retry")
        if tracing._state.enabled:
            tracing.note(f"retry {attempt}/{attempts} at {site}: {last}")
        if attempt >= attempts:
            if telemetry._state.enabled:
                telemetry.record_retry(site, "exhausted")
            if tracing._state.enabled:
                tracing.note(f"retries exhausted at {site}")
            extra = f" ({detail})" if detail else ""
            raise MXNetError(
                f"{site}{extra} failed after {attempts} attempt(s); "
                f"last error: {last}") from last
        delay = base_delay * (2.0 ** (attempt - 1))
        if delay > 0:
            with _lock:
                jitter = _rng.random()
            time.sleep(delay * (1.0 + 0.25 * jitter))
        attempt += 1
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001
            if not is_transient(e):
                raise
            last = e
            continue
        if telemetry._state.enabled:
            telemetry.record_retry(site, "recovered")
        if tracing._state.enabled:
            tracing.note(f"recovered at {site} on attempt {attempt}")
        return result


# MXNET_FAULT_SPEC in the environment: install + enable at import so
# driver-spawned subprocesses (tools/chaos_check.py stages) inject without
# any code changes. A malformed spec fails the import — loudly.
_env_spec = os.environ.get("MXNET_FAULT_SPEC")
if _env_spec:
    install(_env_spec)
