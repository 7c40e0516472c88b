"""``mx.serving.Server`` — the SLO batcher and the continuous-batching
generate server, multi-tenant, with hot reload.

Counterpart of ``mxnet_tpu/serving/server.py``. One scheduler thread
serves both kinds of request:

* :meth:`Server.submit` (one-shot): any thread hands in ONE sample (no
  batch dimension) and gets a ``concurrent.futures.Future``. The sample
  is padded into its shape bucket and queued on its tenant's queue;
  ``_next_batch`` closes a batch when it is ``full``, when the tightest
  deadline in the queue (SLO minus ``close_margin_ms``) arrives
  (``deadline``), when the oldest request has waited
  ``batch_timeout_ms`` (``timeout``), or on a draining stop (``drain``).
  ``_dispatch`` pads the batch to a batch bucket, runs the tenant's
  model once under ``torch.inference_mode()`` in predict mode
  (``autograd.predict_mode()``: every dropout site is the identity),
  copies each output leaf to the host once and resolves every future
  with its own row.
* :meth:`Server.submit_generate` (with ``decode_pages``): an
  autoregressive greedy-decode request over a paged KV cache. Each turn
  admits pending requests with all-or-nothing page allocation
  (preempting lower-priority streams when the pool is full), prefills
  them grouped by tenant and len bucket, then runs ONE ``(batch, 1)``
  decode step round; tokens stream into a :class:`GenerateHandle`. On
  the card each decode step replays the tenant engine's CUDA graph for
  its batch bucket (:class:`~mxnet_tpu_torch.gluon.model_zoo.nlp.
  LlamaDecodeEngine`); ``warmup=True`` captures every bucket at
  :meth:`start`.

Tenants (:meth:`register_model`) share the bucket grid, the scheduler
thread and the one page pool; each owns its block, its decode engine,
its model version and its admission token bucket. A dispatch never mixes
tenants. Batch-close picks and decode slots are weighted-fair across
tenants, and a higher-priority generate arrival preempts the
lowest-priority active stream when the pool is full (the victim ends
typed :class:`~.kvcache.Preempted` with a sealed prefix).

Every dispatch (one-shot, prefill, decode) runs under
``fault.retry_call`` at site ``serving.dispatch``; :meth:`reload` at
``serving.reload``. Telemetry (``MXNET_TELEMETRY=1``) and tracing
(``MXNET_TRACING=1``) record the reference's metrics, spans and
flight-recorder events. The model runs on the card unless ``ctx=mx.cpu()``
is passed; output leaves come back as numpy arrays, a bfloat16 leaf as
float32 (numpy has no bfloat16 here).

Not ported: the fleet (``router.py``, ``worker.py``, ``remote.py``,
``ingress.py``, ``controller.py``, ``wire.py``; ROADMAP.md, port queue
1, item 3), hence no pre-dispatch hook.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from .. import autograd, compiler, fault, telemetry, tracing
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..fault import _state as _fault_state
from ..telemetry import _state as _telemetry_state
from ..tracing import _state as _tracing_state
from .buckets import DEFAULT_LEN_BUCKETS, BucketGrid, TokenBucket
from .health import Heartbeat
from .kvcache import CacheFull, PagePool, Preempted

__all__ = ["Server", "GenerateHandle", "TenantThrottled", "live_servers",
           "DEFAULT_MODEL"]

DEFAULT_MODEL = "default"
CLOSE_REASONS = ("full", "deadline", "timeout", "drain")


class TenantThrottled(MXNetError):
    """Typed per-tenant admission shed: this tenant's token bucket is
    empty. Synchronous at submit and scoped to ONE tenant — this
    tenant's configured rate is exceeded, not the server's capacity."""


class _Tenant:
    """One registered model sharing this server.

    Tenants share the bucket grid, the scheduler thread, and (when
    decode is on) the ONE :class:`PagePool`. Each tenant owns its block,
    its decode engine (its own K/V arenas over the shared page numbering
    and its own decode graphs), its model version, its admission token
    bucket, and its weighted-fair credit state (credits are only ever
    touched by the scheduler thread)."""

    __slots__ = ("name", "block", "slo_class", "priority", "weight",
                 "slo_s", "bucket", "engine", "engine_version",
                 "model_version", "credit", "dcredit", "warm_sigs",
                 "n_requests", "n_shed", "n_preempted", "n_tokens")

    def __init__(self, name, block, slo_class, priority, weight, slo_s,
                 bucket):
        self.name = name
        self.block = block
        self.slo_class = slo_class
        self.priority = int(priority)
        self.weight = float(weight)
        self.slo_s = float(slo_s)
        self.bucket = bucket            # TokenBucket or None
        self.engine = None
        self.engine_version = -1
        self.model_version = 0
        self.credit = 0.0               # weighted-fair classify pick
        self.dcredit = 0.0              # weighted-fair decode slots
        self.warm_sigs = set()          # sigs THIS tenant has served
        self.n_requests = 0
        self.n_shed = 0
        self.n_preempted = 0            # streams evicted FROM this tenant
        self.n_tokens = 0


# every running server, for a test-suite leak guard: a test that leaves a
# scheduler (or watcher) thread running would tax every later test
_live_servers = weakref.WeakSet()


def live_servers():
    """Servers whose scheduler thread is currently running."""
    return [s for s in list(_live_servers) if s.is_running]


class _Request:
    __slots__ = ("sample", "shape_key", "future", "t_enqueue", "deadline",
                 "trace", "span", "own_trace", "tenant")

    def __init__(self, sample, shape_key, deadline_s, tenant=None):
        self.sample = sample                 # numpy, padded to its bucket
        self.shape_key = shape_key
        self.tenant = tenant
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = self.t_enqueue + deadline_s
        # tracing: the request's Trace, its live batch.wait span, and
        # whether THIS server minted the trace
        self.trace = None
        self.span = None
        self.own_trace = False


class GenerateHandle:
    """Streaming handle for one autoregressive generate request.

    ``future`` resolves to the full int32 token array when the
    completion finishes (or raises the typed failure — ``CacheFull``,
    ``Preempted``, ``MXNetError``: a generate never wedges).
    ``on_token(index, token)`` fires per token from the scheduler thread
    (keep it cheap), ``tokens()`` snapshots what has arrived, and
    ``next_token(i)`` blocks until token ``i`` exists or the stream ends
    (None when it ended first).
    """

    def __init__(self, on_token=None):
        self.future = Future()
        self._on_token = on_token
        self._cond = threading.Condition()
        self._tokens: list = []

    def _push(self, token: int) -> None:
        with self._cond:
            self._tokens.append(int(token))
            i = len(self._tokens) - 1
            self._cond.notify_all()
        cb = self._on_token
        if cb is not None:
            try:
                cb(i, int(token))
            except Exception:   # noqa: BLE001 - user callback stays user's
                pass

    def _seal(self) -> None:
        """Wake every next_token() waiter once the future resolved."""
        with self._cond:
            self._cond.notify_all()

    def tokens(self) -> list:
        with self._cond:
            return list(self._tokens)

    def next_token(self, i: int, timeout: Optional[float] = None):
        """Block until token ``i`` streams in; None when the request
        finished (or failed — check ``future``) before producing it."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        with self._cond:
            while len(self._tokens) <= i:
                if self.future.done():
                    return None
                wait = 0.05 if deadline is None \
                    else min(0.05, deadline - time.perf_counter())
                if wait <= 0:
                    return None
                self._cond.wait(wait)
            return self._tokens[i]

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)


class _GenRequest:
    __slots__ = ("prompt", "max_new", "handle", "pages", "length",
                 "generated", "t_submit", "t_last", "deadline", "trace",
                 "span", "own_trace", "len_bucket", "model_version",
                 "tenant", "priority", "seq")

    def __init__(self, prompt, max_new, handle, deadline_s, len_bucket,
                 tenant=None, priority=0, seq=0):
        self.prompt = prompt                 # 1-D int32 token array
        self.max_new = int(max_new)
        self.handle = handle
        self.tenant = tenant
        self.priority = int(priority)        # preemption rank
        self.seq = int(seq)                  # stream id (preempt events)
        self.pages = None                    # page list once admitted
        self.length = len(prompt)            # tokens written OR known
        self.generated: list = []
        self.t_submit = time.perf_counter()
        self.t_last = self.t_submit          # last token emit
        self.deadline = (self.t_submit + deadline_s
                         if deadline_s is not None else None)
        self.trace = None
        self.span = None                     # live gen.queue / phase span
        self.own_trace = False
        self.len_bucket = len_bucket
        self.model_version = -1


def _flatten(out):
    """(leaves, tree) of a model output: a tensor, or tuples/lists of
    them nested."""
    if isinstance(out, torch.Tensor):
        return [out], None
    if isinstance(out, (tuple, list)):
        leaves, trees = [], []
        for o in out:
            sub, tree = _flatten(o)
            trees.append((len(sub), tree))
            leaves.extend(sub)
        return leaves, (type(out), trees)
    raise MXNetError(f"model output of type {type(out).__name__} is not a "
                     "tensor or a tuple/list of tensors")


def _unflatten(tree, leaves):
    if tree is None:
        return leaves[0]
    kind, trees = tree
    out, i = [], 0
    for n, sub in trees:
        out.append(_unflatten(sub, leaves[i:i + n]))
        i += n
    return kind(out)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class Server:
    """Serve models under a latency SLO with bucketed batching, and —
    with ``decode_pages`` and a decode-capable model (one with
    ``decode_engine(pool, dtype)``, e.g.
    :class:`~mxnet_tpu_torch.gluon.model_zoo.nlp.LlamaModel`) —
    continuous-batching greedy generation::

        net = mx.gluon.model_zoo.nlp.bert_12_768_12(ctx=mx.gpu(),
                                                    dtype=torch.bfloat16)
        with mx.serving.Server(net, shape_buckets=[(128,), (512,)],
                               batch_buckets=(1, 8, 32),
                               slo_ms=500) as srv:
            seq, pooled, cls, mlm = srv.submit(token_ids).result()

        net = mx.gluon.model_zoo.nlp.llama_3_8b(ctx=mx.gpu(),
                                                dtype=torch.bfloat16)
        with mx.serving.Server(net, dtype="bfloat16", decode_pages=1024,
                               batch_buckets=(1, 2, 4, 8),
                               len_buckets=(128, 512)) as srv:
            srv.register_model("premium", other_net, priority=10,
                               weight=3.0)
            tokens = srv.submit_generate(prompt, max_new_tokens=32,
                                         model="premium").result()

    ``batch_buckets``: allowed dispatch batch sizes. ``shape_buckets``:
    allowed per-sample shapes (a sample is zero-padded to the tightest
    that fits; None serves each exact shape). ``slo_ms``: a one-shot
    request's batch closes no later than ``slo_ms - close_margin_ms``
    after its submit (``deadline_ms=`` at submit overrides per request).
    ``batch_timeout_ms``: caps how long the oldest queued request waits
    for co-batching (None: fill toward the biggest bucket until the
    deadline). ``dtype``: samples are cast to it on submit (a bfloat16
    server keeps its samples in float32 on the host and casts on the
    device), and it is the generate engine's KV/compute dtype when it is
    a float dtype (float32 otherwise). ``warmup``: at :meth:`start` (and
    for a model registered or swapped in later) run one forward per grid
    signature (with ``shape_buckets``) and capture every batch bucket's
    decode graph (with ``decode_pages``); without it a decode bucket is
    captured at its first step.

    The constructor's block is tenant ``"default"``; ``slo_class``,
    ``priority``, ``weight``, ``rate_limit`` and ``burst`` configure it
    as :meth:`register_model` configures the others.

    Generate settings: ``decode_pages`` x ``page_size`` tokens make the
    KV arena (page 0 is scratch); ``len_buckets``: allowed padded
    prefill lengths; ``max_generate_tokens``: the per-request prompt +
    completion budget; ``defrag_threshold``: pack the pool when free
    holes below its high-water mark exceed this share of it (None
    disables). Generates carry their own ``deadline_ms``.
    """

    def __init__(self, block, batch_buckets=(1, 2, 4, 8, 16, 32),
                 shape_buckets=None, slo_ms: float = 100.0,
                 close_margin_ms: float = 5.0, max_queue: int = 4096,
                 dtype: str = "float32", ctx=None, warmup: bool = True,
                 name: Optional[str] = None,
                 batch_timeout_ms: Optional[float] = None,
                 decode_pages: Optional[int] = None, page_size: int = 16,
                 len_buckets=None,
                 max_generate_tokens: Optional[int] = None,
                 slo_class: str = "standard", priority: int = 0,
                 weight: float = 1.0, rate_limit: Optional[float] = None,
                 burst: Optional[float] = None,
                 defrag_threshold: Optional[float] = 0.25):
        if slo_ms <= 0:
            raise MXNetError(f"slo_ms must be > 0, got {slo_ms}")
        if close_margin_ms < 0 or close_margin_ms >= slo_ms:
            raise MXNetError(
                f"close_margin_ms must be in [0, slo_ms), got "
                f"{close_margin_ms} (slo_ms={slo_ms})")
        if batch_timeout_ms is not None and batch_timeout_ms <= 0:
            raise MXNetError(
                f"batch_timeout_ms must be > 0 (or None for the "
                f"deadline-keyed close), got {batch_timeout_ms}")
        if max_queue < 1:
            raise MXNetError(f"max_queue must be >= 1, got {max_queue}")
        self.device = resolve_device(ctx)
        self._check_device(block)
        self._decode_pages = decode_pages
        if decode_pages is not None and len_buckets is None:
            len_buckets = DEFAULT_LEN_BUCKETS
        self.grid = BucketGrid(batch_buckets, shape_buckets,
                               len_buckets=len_buckets)
        self._page_size = int(page_size)
        self._max_gen_tokens = 0
        self._defrag_min_pages: Optional[int] = None
        if decode_pages is not None:
            cap = (int(decode_pages) - 1) * self._page_size
            self._max_gen_tokens = int(
                max_generate_tokens if max_generate_tokens is not None
                else min(cap, self.grid.len_buckets[-1] + 256))
            if self._max_gen_tokens > cap:
                raise MXNetError(
                    f"max_generate_tokens={self._max_gen_tokens} exceeds "
                    f"the pool's {cap}-token capacity "
                    f"({decode_pages} pages x {page_size}, scratch "
                    "page excluded)")
            if defrag_threshold is not None:
                if not 0 < float(defrag_threshold) <= 1:
                    raise MXNetError(
                        f"defrag_threshold must be in (0, 1] or None, got "
                        f"{defrag_threshold}")
                self._defrag_min_pages = max(
                    2, int(float(defrag_threshold) * (int(decode_pages) - 1)))
        dt = torch_dtype(dtype)
        self.dtype = dtype
        self.input_dtype = dt
        # host-side sample dtype: numpy has no bfloat16 here
        self._np_dtype = (np.float32 if dt in (torch.bfloat16,
                                               torch.float16)
                          else np.dtype(str(dt).split(".")[-1]))
        self.engine_dtype = dt if dt.is_floating_point else torch.float32
        self.slo_s = slo_ms / 1e3
        self.margin_s = close_margin_ms / 1e3
        self.batch_timeout_s = (batch_timeout_ms / 1e3
                                if batch_timeout_ms is not None else None)
        self.max_queue = int(max_queue)
        self.name = name or f"server_{id(self):x}"
        self._warmup = bool(warmup)
        self._pool: Optional[PagePool] = None
        self._gen_table_w = 0
        self._gen_active: list = []
        self._model_lock = threading.Lock()
        self._cond = threading.Condition()
        # the constructor block IS tenant "default"; register_model()
        # adds tenants. Per-tenant queues, so one tenant's burst cannot
        # push another's requests back in a shared FIFO.
        if weight <= 0:
            raise MXNetError(f"weight must be > 0, got {weight}")
        self._tenants: Dict[str, _Tenant] = {}
        self._queues: Dict[str, list] = {}
        self._gen_pending: Dict[str, list] = {}
        self._seq = itertools.count()       # stream ids (preempt events)
        bucket = (TokenBucket(rate_limit, burst)
                  if rate_limit is not None else None)
        self._tenants[DEFAULT_MODEL] = _Tenant(
            DEFAULT_MODEL, block, str(slo_class), priority, weight,
            self.slo_s, bucket)
        self._queues[DEFAULT_MODEL] = []
        self._gen_pending[DEFAULT_MODEL] = []
        self._drain = True
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._watcher = None        # reload.ReloadWatcher, when enabled
        # scheduler-loop liveness beacon: touched once per loop turn
        self.hb = Heartbeat()
        self.loaded_step: Optional[int] = None
        # one-shot signatures actually served (warmed for a swapped-in
        # block; union across tenants, each tenant also keeps its own)
        self._warm_sigs = set()
        # always-on light counters (telemetry covers the full story)
        self.n_requests = 0
        self.n_batches = 0
        self.n_errors = 0
        self.n_cancelled = 0
        self.n_tokens = 0
        self.n_reloads = 0
        self.n_preemptions = 0
        self.n_defrags = 0
        self.n_warmup = 0
        self.batch_rows = 0          # real rows over dispatched batches
        self.batch_slots = 0         # their padded batch buckets
        self.close_reasons = dict.fromkeys(CLOSE_REASONS, 0)

    def _check_device(self, block) -> None:
        dev = next(block.parameters()).device
        if dev != self.device:
            raise MXNetError(f"the model's weights are on {dev}, the "
                             f"server's ctx is {self.device}")

    # -- the default tenant is the single-tenant server ----------------
    @property
    def engine(self):
        """The default tenant's decode engine (None before start)."""
        return self._tenants[DEFAULT_MODEL].engine

    @property
    def _block(self):
        return self._tenants[DEFAULT_MODEL].block

    @property
    def model_version(self) -> int:
        """The default tenant's model version: bumps on every
        swap_model / reload (``swap_model(version=)`` restores an old
        number). Per-tenant versions: :meth:`model_versions`."""
        return self._tenants[DEFAULT_MODEL].model_version

    def model_versions(self) -> Dict[str, int]:
        """Per-tenant model versions (upgrading tenant A never touches
        tenant B's number)."""
        with self._model_lock:
            return {n: t.model_version for n, t in self._tenants.items()}

    def models(self):
        """Registered tenant names (``"default"`` always present)."""
        return sorted(self._tenants)

    def _tenant(self, model) -> _Tenant:
        name = DEFAULT_MODEL if model is None else str(model)
        t = self._tenants.get(name)
        if t is None:
            raise MXNetError(
                f"{self.name}: unknown model {name!r} (registered: "
                f"{sorted(self._tenants)})")
        return t

    def register_model(self, name: str, block, slo_class: str = "standard",
                       priority: int = 0, weight: float = 1.0,
                       slo_ms: Optional[float] = None,
                       rate_limit: Optional[float] = None,
                       burst: Optional[float] = None) -> _Tenant:
        """Register another model to serve from THIS server. Tenants
        share the scheduler, the bucket grid and — when decode is on —
        the one page pool.

        ``slo_class`` is a label carried into telemetry and trace spans;
        ``priority`` orders preemption (higher preempts lower when the
        page pool is full); ``weight`` sets this tenant's weighted-fair
        share of batch-close picks and decode slots; ``rate_limit``
        (requests/second, with ``burst``) arms a per-tenant admission
        token bucket — an empty bucket sheds synchronously with
        :class:`TenantThrottled`. ``slo_ms`` overrides the server SLO
        for this tenant's default deadline. On a running server the
        block is warmed and its decode engine built (graphs captured)
        before the tenant is visible to submitters."""
        name = str(name)
        if not name:
            raise MXNetError("tenant name must be non-empty")
        if weight <= 0:
            raise MXNetError(f"weight must be > 0, got {weight}")
        if name in self._tenants:
            raise MXNetError(
                f"{self.name}: model {name!r} is already registered")
        self._check_device(block)
        bucket = (TokenBucket(rate_limit, burst)
                  if rate_limit is not None else None)
        t = _Tenant(name, block, str(slo_class), priority, weight,
                    slo_ms / 1e3 if slo_ms is not None else self.slo_s,
                    bucket)
        if self.is_running:
            self._warm_block(block)
            if self._decode_pages is not None:
                t.engine = self._make_engine(block)
                t.engine_version = t.model_version
        with self._cond:
            if name in self._tenants:
                raise MXNetError(
                    f"{self.name}: model {name!r} is already registered")
            self._tenants[name] = t
            self._queues[name] = []
            self._gen_pending[name] = []
            self._cond.notify_all()
        return t

    # -- lifecycle -----------------------------------------------------
    @property
    def is_running(self) -> bool:
        return self._running or (self._thread is not None
                                 and self._thread.is_alive())

    def _make_engine(self, block):
        """Build ``block``'s decode engine over the SHARED page pool (in
        the engine dtype, the KV/compute dtype: a token server runs
        dtype="int32" but the cache holds floats), and with ``warmup``
        capture every batch bucket's decode graph."""
        if not hasattr(block, "decode_engine"):
            raise MXNetError(
                f"{self.name}: decode_pages set but the model has no "
                "decode_engine() seam (paged-KV generate needs a "
                "decode-capable model)")
        engine = block.decode_engine(self._pool, dtype=self.engine_dtype)
        if self._warmup:
            engine.capture(self.grid.batch_buckets, self._gen_table_w)
        return engine

    def start(self) -> "Server":
        """Warm the bucket grid (one forward per signature per tenant),
        build the page pool and each tenant's decode engine (capturing
        its decode graphs) when generate is on, and start the scheduler
        thread."""
        if self.is_running:
            raise MXNetError(f"{self.name}: already running")
        if self._decode_pages is not None:
            for t in self._tenants.values():
                if not hasattr(t.block, "decode_engine"):
                    raise MXNetError(
                        f"{self.name}: decode_pages set but the model has "
                        "no decode_engine() seam (paged-KV generate needs "
                        "a decode-capable model)")
        for t in self._tenants.values():
            self._warm_block(t.block)
        if self._decode_pages is not None:
            self._pool = PagePool(self._decode_pages, self._page_size)
            self._gen_table_w = self._pool.pages_for(self._max_gen_tokens)
            for t in self._tenants.values():
                t.engine = self._make_engine(t.block)
                t.engine_version = t.model_version
        self._running = True
        self._drain = True
        self._thread = threading.Thread(
            target=self._scheduler_loop, name=self.name, daemon=True)
        self._thread.start()
        _live_servers.add(self)
        return self

    def _warm_block(self, block) -> int:
        """One forward of ``block`` per (batch bucket, shape bucket)
        signature and per signature served so far, so the first requests
        do not pay for cuBLAS's first pick of each GEMM shape, the
        allocator's first blocks, or a kernel library's build and
        load."""
        if not self._warmup:
            return 0
        with self._model_lock:
            sigs = set(self._warm_sigs)
        if self.grid.shape_buckets is not None:
            sigs.update(self.grid.input_signatures())
        if not sigs:
            return 0
        with torch.inference_mode(), autograd.predict_mode():
            for sig in sorted(sigs):
                block(torch.zeros(sig, dtype=self.input_dtype,
                                  device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.n_warmup += len(sigs)
        return len(sigs)

    def stop(self, drain: bool = True, timeout: Optional[float] = None
             ) -> None:
        """Stop the server (and its hot-reload watcher). ``drain=True``
        (default) serves every queued request and finishes every
        generate first (batches close at once, SLO waits skipped);
        ``drain=False`` fails them with :class:`MXNetError`."""
        with self._cond:
            self._running = False
            self._drain = bool(drain)
            if not drain:
                pending = [r for q in self._queues.values() for r in q]
                for q in self._queues.values():
                    del q[:]
                for r in pending:
                    if not r.future.set_running_or_notify_cancel():
                        self.n_cancelled += 1
                        continue        # the caller cancelled it
                    r.future.set_exception(
                        MXNetError(f"{self.name}: server stopped before "
                                   "this request was dispatched"))
                    self._count_request(outcome="rejected",
                                        tenant=r.tenant)
                    self._end_trace_rejected(r)
            self._cond.notify_all()
        if self._watcher is not None:
            self._watcher.stop(timeout)
            self._watcher = None
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise MXNetError(
                    f"{self.name}: scheduler thread did not exit within "
                    f"{timeout}s")
            self._thread = None
        _live_servers.discard(self)

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    # -- ingress -------------------------------------------------------
    def _throttle(self, t: _Tenant) -> None:
        """Per-tenant token-bucket admission: raises
        :class:`TenantThrottled` (synchronous, typed, scoped to ONE
        tenant) when ``t``'s bucket is empty."""
        if t.bucket is None or t.bucket.take():
            return
        t.n_shed += 1
        self._count_request(outcome="rejected", tenant=t)
        if _telemetry_state.enabled:
            telemetry.record_serving_shed("throttled", model=t.name)
        raise TenantThrottled(
            f"{self.name}: tenant {t.name!r} over its admission rate "
            f"({t.bucket.rate:g}/s, burst {t.bucket.burst:g})")

    def _begin_trace(self, req, t: _Tenant, span: str, root: str,
                     **tags) -> None:
        """Open ``req``'s first span (under the ambient trace when a
        caller set one, else in a trace this server mints)."""
        amb = tracing.ambient()
        if amb is not None:
            req.trace = amb[0]
            req.span = req.trace.begin(span, parent=amb[1],
                                       replica=self.name, model=t.name,
                                       slo_class=t.slo_class)
            return
        req.trace = tracing.new_trace(root, replica=self.name,
                                      model=t.name, slo_class=t.slo_class,
                                      **tags)
        req.own_trace = True
        req.span = req.trace.begin(span, replica=self.name, model=t.name,
                                   slo_class=t.slo_class)

    def submit(self, sample, deadline_ms: Optional[float] = None,
               model: Optional[str] = None,
               priority: Optional[int] = None) -> Future:
        """Enqueue one sample (NO batch dimension); returns a Future that
        resolves to the model's output for that sample (numpy leaves,
        in the model's output structure). Thread-safe.

        Rejection is synchronous and typed: :class:`MXNetError` when the
        model is unknown, no shape bucket fits the sample, the queue is
        full, or the server is not running; :class:`TenantThrottled`
        when the tenant's token bucket is empty — never a hung future.
        ``deadline_ms`` overrides the tenant's SLO for this request.
        ``model=`` selects the tenant (default: the constructor block);
        ``priority`` is accepted for symmetry with
        :meth:`submit_generate` (one-shot requests hold no pages, so
        nothing preempts them)."""
        t = self._tenant(model)
        self._throttle(t)
        if isinstance(sample, torch.Tensor):
            sample = sample.detach().cpu().numpy()
        arr = np.ascontiguousarray(sample, dtype=self._np_dtype)
        bucket = self.grid.bucket_shape(arr.shape)   # raises if none fits
        arr = self.grid.pad_sample(arr, bucket)
        req = _Request(arr, bucket, deadline_ms / 1e3
                       if deadline_ms is not None else t.slo_s, tenant=t)
        if _tracing_state.enabled:
            # the span exists BEFORE the queue append: the scheduler may
            # batch-close this request before submit returns
            self._begin_trace(req, t, "batch.wait", "request")
        with self._cond:
            if not self._running:
                self._count_request(outcome="rejected", tenant=t)
                self._end_trace_rejected(req)
                raise MXNetError(f"{self.name}: server is not running")
            q = self._queues[t.name]
            if len(q) >= self.max_queue:
                self._count_request(outcome="rejected", tenant=t)
                self._end_trace_rejected(req)
                raise MXNetError(
                    f"{self.name}: submission queue full for model "
                    f"{t.name!r} ({self.max_queue} requests)")
            q.append(req)
            depth = sum(len(x) for x in self._queues.values())
            tenant_depth = len(q)
            self._cond.notify_all()
        if _telemetry_state.enabled:
            telemetry.set_serving_queue_depth(depth)
            telemetry.set_tenant_queue_depth(tenant_depth, t.name)
        return req.future

    def submit_generate(self, prompt, max_new_tokens: int,
                        deadline_ms: Optional[float] = None,
                        on_token=None, model: Optional[str] = None,
                        priority: Optional[int] = None) -> GenerateHandle:
        """Enqueue one generate request: ``prompt`` is a 1-D int token
        array, ``max_new_tokens`` the completion budget (greedy decode).
        Returns a :class:`GenerateHandle` streaming tokens as the
        continuous batcher produces them.

        Rejection is synchronous and typed: :class:`~.kvcache.CacheFull`
        when the request can never fit the per-request cache budget,
        :class:`TenantThrottled` when the tenant's token bucket is empty,
        :class:`MXNetError` when decode is not enabled, the model is
        unknown, no len bucket fits the prompt, the queue is full, or
        the server is not running. ``deadline_ms`` bounds the WHOLE
        completion (default: none); a request that misses it fails its
        future typed.

        ``model=`` selects the tenant; ``priority`` overrides the
        tenant's preemption rank for this stream (a higher-priority
        arrival may reclaim a lower-priority stream's pages: the victim
        resolves typed :class:`~.kvcache.Preempted` with a sealed
        prefix)."""
        if self._decode_pages is None:
            raise MXNetError(f"{self.name}: decode is not enabled "
                             "(construct the server with decode_pages=)")
        t = self._tenant(model)
        self._throttle(t)
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        arr = np.ascontiguousarray(prompt, dtype=np.int32).reshape(-1)
        if arr.size < 1:
            raise MXNetError(f"{self.name}: empty prompt")
        if int(max_new_tokens) < 1:
            raise MXNetError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        len_bucket = self.grid.prefill_bucket(arr.size)  # raises: no fit
        if arr.size + int(max_new_tokens) > self._max_gen_tokens:
            t.n_shed += 1
            if _telemetry_state.enabled:
                telemetry.record_serving_shed("kvcache_full", model=t.name)
            raise CacheFull(
                f"{self.name}: prompt {arr.size} + max_new_tokens "
                f"{max_new_tokens} exceeds the {self._max_gen_tokens}-"
                "token per-request cache budget")
        handle = GenerateHandle(on_token)
        req = _GenRequest(arr, max_new_tokens, handle,
                          deadline_ms / 1e3 if deadline_ms is not None
                          else None, len_bucket, tenant=t,
                          priority=(t.priority if priority is None
                                    else priority),
                          seq=next(self._seq))
        if _tracing_state.enabled:
            self._begin_trace(req, t, "gen.queue", "generate",
                              prompt_len=int(arr.size),
                              max_new=int(max_new_tokens))
        with self._cond:
            if not self._running:
                self._count_request(outcome="rejected", tenant=t)
                self._end_trace_rejected(req)
                raise MXNetError(f"{self.name}: server is not running")
            q = self._gen_pending[t.name]
            if len(q) >= self.max_queue:
                self._count_request(outcome="rejected", tenant=t)
                self._end_trace_rejected(req)
                raise MXNetError(
                    f"{self.name}: generate queue full for model "
                    f"{t.name!r} ({self.max_queue} requests)")
            q.append(req)
            self._cond.notify_all()
        return handle

    # -- one-shot batching ---------------------------------------------
    def _next_batch(self):
        """Block until a batch should close; returns (requests, reason),
        ``([], "decode")`` when decode work should run NOW (continuous
        batching never parks the scheduler while generates are live),
        or (None, None) on shutdown with nothing left to serve.

        Every non-empty tenant queue is evaluated with the close rules —
        ``full`` (the head's shape key has a whole biggest bucket
        queued), ``drain`` (stopping), then ``timeout`` / ``deadline``
        (the TIGHTEST deadline in the queue minus the close margin, or
        the head's ``batch_timeout_ms``, whichever comes first) —
        against ITS OWN requests; when several tenants are closeable the
        pick is smooth weighted round-robin, and a batch never mixes
        tenants. A batch takes up to ``max_batch`` requests of the
        head's shape key, in submit order."""
        with self._cond:
            while True:
                self.hb.touch()
                gen_work = (any(self._gen_pending.values())
                            or bool(self._gen_active))
                nonempty = [n for n in self._queues if self._queues[n]]
                if not nonempty:
                    if not self._running:
                        if gen_work and self._drain:
                            return [], "decode"
                        return None, None
                    if gen_work:
                        return [], "decode"
                    self._cond.wait(0.1)
                    continue
                cap = self.grid.max_batch
                now = time.perf_counter()
                full, closeable = [], []
                min_close_at = None
                for name in nonempty:
                    q = self._queues[name]
                    head = q[0]
                    key = head.shape_key
                    if sum(1 for r in q if r.shape_key == key) >= cap:
                        full.append(name)
                        continue
                    deadline_at = min(r.deadline for r in q) - self.margin_s
                    timeout_at = (head.t_enqueue + self.batch_timeout_s
                                  if self.batch_timeout_s is not None
                                  else None)
                    close_at = deadline_at if timeout_at is None \
                        else min(deadline_at, timeout_at)
                    if now >= close_at:
                        reason = ("timeout" if timeout_at is not None
                                  and timeout_at <= close_at + 1e-9
                                  and now < deadline_at else "deadline")
                        closeable.append((name, reason))
                    elif min_close_at is None or close_at < min_close_at:
                        min_close_at = close_at
                if full:
                    picked = self._wrr_pick(
                        [self._tenants[n] for n in full]).name
                    reason = "full"
                elif not self._running:
                    # drain: the oldest head across tenants goes first
                    picked = min(nonempty,
                                 key=lambda n: self._queues[n][0].t_enqueue)
                    reason = "drain"
                elif closeable:
                    if len(closeable) == 1:
                        picked, reason = closeable[0]
                    else:
                        picked = self._wrr_pick(
                            [self._tenants[n] for n, _ in closeable]).name
                        reason = dict(closeable)[picked]
                else:
                    if gen_work:
                        # decode steps interleave with the batch fill
                        return [], "decode"
                    self._cond.wait(min(min_close_at - now, 0.1))
                    continue
                q = self._queues[picked]
                key = q[0].shape_key
                taken, rest = [], []
                for r in q:
                    if len(taken) < cap and r.shape_key == key:
                        taken.append(r)
                    else:
                        rest.append(r)
                self._queues[picked] = rest
                if _telemetry_state.enabled:
                    telemetry.set_serving_queue_depth(
                        sum(len(x) for x in self._queues.values()))
                    telemetry.set_tenant_queue_depth(len(rest), picked)
                return taken, reason

    def _dispatch(self, batch, reason: str) -> None:
        """Pad, run, slice, resolve — one bucketed inference dispatch of
        one tenant's model. A failure fails this batch's futures, not the
        server."""
        t_start = time.perf_counter()
        # a caller may have cancelled a still-queued future: drop it now
        # (set_result on a cancelled future would raise)
        live = [r for r in batch if r.future.set_running_or_notify_cancel()]
        self.n_cancelled += len(batch) - len(live)
        if not live:
            return
        n = len(live)
        key = live[0].shape_key
        tenant = live[0].tenant
        cap = self.grid.batch_bucket(n)
        payload = np.zeros((cap,) + key, dtype=self._np_dtype)
        for i, r in enumerate(live):
            payload[i] = r.sample
        model = tenant.block         # a reload swaps the attribute
        sig = (cap,) + key
        bsp = None
        if _tracing_state.enabled:
            traced = [(r.trace, r.span) for r in live if r.trace is not None]
            if traced:
                bsp = tracing.begin_batch(
                    traced, wait_tags={"close_reason": reason},
                    replica=self.name, sig=str(sig), reason=reason,
                    model=tenant.name)

        def run():
            if _fault_state.enabled:
                fault.check("serving.dispatch", f"{self.name} batch={sig}")
            x = torch.from_numpy(payload).to(self.device, self.input_dtype)
            with torch.inference_mode(), autograd.predict_mode():
                out = model(x)
            leaves, tree = _flatten(out)
            # one host copy per leaf per batch
            return [_to_numpy(leaf) for leaf in leaves], tree

        amb = (tracing.active(live[0].trace, bsp) if bsp is not None
               else contextlib.nullcontext())
        try:
            with amb:
                leaves, tree = fault.retry_call("serving.dispatch", run,
                                                detail=self.name)
            # futures get row copies (a row view would pin the whole
            # padded batch)
            results = [_unflatten(tree, [leaf[i].copy() for leaf in leaves])
                       for i in range(n)]
        except Exception as e:  # noqa: BLE001 - forwarded to the futures
            with self._cond:
                self.n_errors += 1
            tracing.end_batch(bsp, outcome="error", error=type(e).__name__)
            for r in live:
                r.future.set_exception(e)
                self._count_request(outcome="error", t_enqueue=r.t_enqueue,
                                    trace_id=self._trace_id(r),
                                    tenant=tenant)
                if r.own_trace:
                    r.trace.finish(type(e).__name__)
            return
        tracing.end_batch(bsp, outcome="ok")
        # the replica's cold-start milestone: import -> first served batch
        compiler.mark_event("first_response")
        with self._cond:
            self.n_batches += 1
            self.close_reasons[reason] += 1
            self.batch_rows += n
            self.batch_slots += cap
        if _telemetry_state.enabled:
            telemetry.record_serving_batch(n, cap, reason)
            for r in live:
                telemetry.record_serving_queue_time(t_start - r.t_enqueue)
        with self._model_lock:
            self._warm_sigs.add(sig)
            tenant.warm_sigs.add(sig)
        for r, res in zip(live, results):
            r.future.set_result(res)
            self._count_request(outcome="ok", t_enqueue=r.t_enqueue,
                                trace_id=self._trace_id(r), tenant=tenant)
            if r.own_trace:
                r.trace.finish("ok")

    @staticmethod
    def _trace_id(r):
        return r.trace.trace_id if r.trace is not None else None

    def _count_request(self, outcome: str, t_enqueue: Optional[float] = None,
                       trace_id: Optional[str] = None,
                       tenant: Optional[_Tenant] = None) -> None:
        with self._cond:
            self.n_requests += 1
            if tenant is not None:
                tenant.n_requests += 1
        if _telemetry_state.enabled:
            lat = (time.perf_counter() - t_enqueue
                   if t_enqueue is not None else 0.0)
            telemetry.record_serving_request(
                lat, outcome, trace_id=trace_id,
                model=tenant.name if tenant is not None else None)

    @staticmethod
    def _end_trace_rejected(req, status: str = "rejected") -> None:
        """Seal a traced request that never reached a batch."""
        if req.trace is None:
            return
        if req.span is not None:
            req.span.end(outcome=status)
            req.span = None
        if req.own_trace:
            req.trace.finish(status)

    # -- decode phase (continuous batching) ----------------------------
    @staticmethod
    def _wrr_pick(tenants, field: str = "credit") -> _Tenant:
        """Smooth weighted round-robin over ``tenants``: every pick adds
        each tenant's weight to its credit, takes the max, and charges
        the winner the total — long-run pick shares converge to the
        configured weights (scheduler thread only)."""
        total = 0.0
        for t in tenants:
            total += t.weight
            setattr(t, field, getattr(t, field) + t.weight)
        best = max(tenants, key=lambda t: getattr(t, field))
        setattr(best, field, getattr(best, field) - total)
        return best

    def _preempt(self, victim: _GenRequest, beneficiary: _GenRequest
                 ) -> None:
        """Evict ``victim`` for a higher-priority arrival — AT a decode
        step boundary, so every token it streamed is a clean, sealed
        prefix. The handle resolves typed :class:`~.kvcache.Preempted`;
        the flight recorder names victim and beneficiary."""
        victim.tenant.n_preempted += 1
        self.n_preemptions += 1
        if _telemetry_state.enabled:
            telemetry.record_preemption(victim.tenant.name,
                                        beneficiary.tenant.name)
        if _tracing_state.enabled:
            tracing.record_event(
                "preempted", replica=self.name,
                victim=victim.seq, beneficiary=beneficiary.seq,
                victim_model=victim.tenant.name,
                beneficiary_model=beneficiary.tenant.name,
                victim_priority=victim.priority,
                beneficiary_priority=beneficiary.priority,
                victim_tokens=len(victim.generated))
        self._finalize_gen(victim, error=Preempted(
            f"{self.name}: stream preempted at token "
            f"{len(victim.generated)}/{victim.max_new}: pages reclaimed "
            f"for higher-priority {beneficiary.tenant.name!r} arrival "
            f"(priority {beneficiary.priority} > {victim.priority})"))

    def _admit_pages(self, g: _GenRequest, active: list):
        """All-or-nothing page allocation for ``g``'s prompt plus its
        whole completion budget, preempting lower-priority active streams
        (lowest priority first, then the one with the least progress to
        waste) until it fits. Victims are removed from ``active`` in
        place. Raises :class:`CacheFull` when ``g`` cannot fit even with
        every lower-priority stream evicted (and then evicts nobody)."""
        while True:
            try:
                return self._pool.alloc(g, g.length + g.max_new)
            except CacheFull:
                lower = [v for v in active if v.priority < g.priority]
                if not lower:
                    raise
                need = self._pool.pages_for(g.length + g.max_new)
                avail = (self._pool.stats()["free"]
                         + sum(len(self._pool.owned(v)) for v in lower))
                if need > avail:
                    raise
                victim = min(lower,
                             key=lambda v: (v.priority, len(v.generated)))
                self._preempt(victim, beneficiary=g)
                active.remove(victim)

    def _decode_tick(self) -> bool:
        """One continuous-batching turn: swap in reloaded weights where
        a tenant has no active completion, admit pending generates
        (prefill), then run ONE decode step round for the active
        streams. Requests join and leave the decode batch at any step
        boundary. Returns False when nothing could move (the scheduler
        backs off)."""
        progressed = False
        now = time.perf_counter()
        with self._cond:
            active = list(self._gen_active)
            pending = {n: list(q) for n, q in self._gen_pending.items()
                       if q}
        # deferred per-tenant weight swap: a completion runs entirely on
        # ONE model version, so a reload reaches a tenant's engine only
        # while that tenant has no active completion (refresh_params
        # recaptures the engine's decode graphs over the new weights)
        for t in self._tenants.values():
            if (t.engine is not None
                    and t.engine_version != t.model_version
                    and not any(g.tenant is t for g in active)):
                with self._model_lock:
                    block, version = t.block, t.model_version
                t.engine.refresh_params(block)
                t.engine_version = version
        # admission: weighted-fair across tenants, all-or-nothing page
        # allocation per request, preemption on a full pool
        admitted: list = []
        while pending and len(admitted) < self.grid.max_batch:
            t = self._wrr_pick([self._tenants[n] for n in pending])
            queue = pending[t.name]
            g = queue.pop(0)
            if not queue:
                del pending[t.name]
            if g.deadline is not None and now > g.deadline:
                self._remove_pending(g)
                self._finalize_gen(g, error=MXNetError(
                    f"{self.name}: generate deadline expired before "
                    "prefill (cache/backlog starvation)"))
                progressed = True
                continue
            try:
                g.pages = self._admit_pages(g, active)
            except CacheFull as e:
                if not active and not admitted:
                    # nothing holds pages and it STILL does not fit:
                    # waiting cannot help — shed typed, never wedge
                    t.n_shed += 1
                    if _telemetry_state.enabled:
                        telemetry.record_serving_shed("kvcache_full",
                                                      model=t.name)
                    self._remove_pending(g)
                    self._finalize_gen(g, error=e)
                    progressed = True
                    continue
                # this tenant's head waits until actives free pages;
                # other tenants keep admitting this tick
                pending.pop(t.name, None)
                continue
            self._remove_pending(g)
            admitted.append(g)
        if admitted:
            groups: dict = {}
            for g in admitted:
                groups.setdefault((g.tenant.name, g.len_bucket),
                                  []).append(g)
            for key in sorted(groups):
                self._prefill_batch(groups[key], key[1])
            progressed = True
        with self._cond:
            active = list(self._gen_active)
        expired = [g for g in active
                   if g.deadline is not None and now > g.deadline]
        for g in expired:
            self._finalize_gen(g, error=MXNetError(
                f"{self.name}: generate deadline expired at token "
                f"{len(g.generated)}/{g.max_new}"))
        active = [g for g in active if g not in expired]
        if active:
            self._decode_round(active)
        self._maybe_defrag()
        return progressed or bool(active) or bool(expired)

    def _decode_round(self, active: list) -> None:
        """One decode step for active streams. One tenant: every stream
        steps, chunked to the grid. Several tenants: ``grid.max_batch``
        decode slots per round are assigned weighted-fair across tenants
        with live streams, each tenant's picks step as its OWN batch
        (its own engine and graph), and stepped streams rotate to the
        back of the active list so no stream starves within its
        tenant."""
        by_tenant: dict = {}
        for g in active:
            by_tenant.setdefault(g.tenant.name, []).append(g)
        if len(by_tenant) == 1:
            cap = self.grid.max_batch
            for i in range(0, len(active), cap):
                self._decode_batch(active[i:i + cap])
            return
        tenants = [self._tenants[n] for n in by_tenant]
        remaining = {t.name: len(by_tenant[t.name]) for t in tenants}
        share = {t.name: 0 for t in tenants}
        for _ in range(min(self.grid.max_batch, len(active))):
            elig = [t for t in tenants if remaining[t.name] > 0]
            if not elig:
                break
            t = self._wrr_pick(elig, field="dcredit")
            share[t.name] += 1
            remaining[t.name] -= 1
        for t in tenants:
            n = share[t.name]
            if n == 0:
                continue
            streams = by_tenant[t.name]
            self._decode_batch(streams[:n])
            if n < len(streams):
                # rotate the stepped streams behind the unstepped ones
                with self._cond:
                    for g in streams[:n]:
                        try:
                            self._gen_active.remove(g)
                        except ValueError:
                            continue    # finalized during the step
                        self._gen_active.append(g)

    def _maybe_defrag(self) -> None:
        """Automatic defrag between decode steps: when the free holes
        below the pool's high-water mark exceed the threshold, pack live
        pages down, replay the permutation onto EVERY tenant's arenas,
        and refresh every active stream's page snapshot."""
        if self._defrag_min_pages is None or self._pool is None:
            return
        n_live, span = self._pool.frag_info()
        if n_live == 0 or span - n_live < self._defrag_min_pages:
            return
        engines = [t.engine for t in self._tenants.values()
                   if t.engine is not None]
        moves = self._pool.defrag()
        if not moves:
            return
        for e in engines:
            e.apply_defrag(moves)
        with self._cond:
            for g in self._gen_active:
                g.pages = self._pool.owned(g)
        self.n_defrags += 1
        if _telemetry_state.enabled:
            telemetry.record_kvcache_defrag(len(moves))
        if _tracing_state.enabled:
            tracing.record_event("kvcache.defrag", replica=self.name,
                                 moves=len(moves), live_pages=n_live)

    def _remove_pending(self, g) -> None:
        with self._cond:
            q = self._gen_pending.get(g.tenant.name)
            if q is not None:
                try:
                    q.remove(g)
                except ValueError:
                    pass

    def _run_engine(self, sig, kind: str, fn):
        """``fn()`` (an engine dispatch) under the ``serving.dispatch``
        fault site and its bounded retry."""
        def run():
            if _fault_state.enabled:
                fault.check("serving.dispatch", f"{self.name} {kind}={sig}")
            return fn()

        return fault.retry_call("serving.dispatch", run, detail=self.name)

    def _prefill_batch(self, group, len_bucket: int) -> None:
        """Prefill one (tenant, len bucket) group: write the prompts' K/V
        into their pages and emit each request's FIRST token."""
        tenant = group[0].tenant
        engine = tenant.engine
        cap = self.grid.batch_bucket(len(group))
        w = self._gen_table_w
        tokens = np.zeros((cap, len_bucket), dtype=np.int32)
        lengths = np.zeros((cap,), dtype=np.int32)
        table = np.zeros((cap, w), dtype=np.int32)
        for i, g in enumerate(group):
            tokens[i, :g.prompt.size] = g.prompt
            lengths[i] = g.prompt.size
            table[i, :len(g.pages)] = g.pages
            g.model_version = tenant.engine_version
            if g.span is not None:          # gen.queue ends here
                g.span.end(outcome="ok")
            g.span = (g.trace.begin("prefill", replica=self.name,
                                    len_bucket=len_bucket,
                                    model=tenant.name,
                                    slo_class=tenant.slo_class)
                      if g.trace is not None else None)
        try:
            logits = self._run_engine(
                (cap, len_bucket), "prefill",
                lambda: engine.prefill(tokens, lengths, table))
        except Exception as e:  # noqa: BLE001 - forwarded to the handles
            self.n_errors += 1
            for g in group:
                self._finalize_gen(g, error=e)
            return
        self.n_batches += 1
        if _telemetry_state.enabled:
            telemetry.record_serving_batch(len(group), cap, "prefill")
        with self._cond:
            self._gen_active.extend(group)
        t_now = time.perf_counter()
        for i, g in enumerate(group):
            if g.span is not None:
                g.span.end(outcome="ok")
                g.span = None
            self._emit_token(g, int(np.argmax(logits[i])), t_now)
        # a generate's first response is its first token
        compiler.mark_event("first_response")

    def _decode_batch(self, chunk) -> None:
        """ONE decode step for up to max_batch active requests of ONE
        tenant: a ``(batch, 1)`` dispatch (on the card, a replay of the
        bucket's decode graph) whatever depth each request is at. Rows
        past the chunk are padding: length 0 and an all-scratch page
        table."""
        tenant = chunk[0].tenant
        engine = tenant.engine
        cap = self.grid.batch_bucket(len(chunk))
        w = self._gen_table_w
        tokens = np.zeros((cap,), dtype=np.int32)
        lengths = np.zeros((cap,), dtype=np.int32)
        table = np.zeros((cap, w), dtype=np.int32)
        spans = []
        for i, g in enumerate(chunk):
            tokens[i] = g.generated[-1]
            lengths[i] = g.length
            table[i, :len(g.pages)] = g.pages
            spans.append(g.trace.begin("decode.step", replica=self.name,
                                       token=len(g.generated),
                                       model=tenant.name)
                         if g.trace is not None else None)
        try:
            logits = self._run_engine(
                (cap, 1), "decode",
                lambda: engine.decode_step(tokens, lengths, table))
        except Exception as e:  # noqa: BLE001 - forwarded to the handles
            self.n_errors += 1
            for sp in spans:
                if sp is not None:
                    sp.end(outcome="error", error=type(e).__name__)
            for g in chunk:
                self._finalize_gen(g, error=e)
            return
        if _telemetry_state.enabled:
            telemetry.record_decode_step(len(chunk), model=tenant.name)
        t_now = time.perf_counter()
        for i, (g, sp) in enumerate(zip(chunk, spans)):
            if sp is not None:
                sp.end(outcome="ok")
            self._emit_token(g, int(np.argmax(logits[i])), t_now)

    def _emit_token(self, g, token: int, t_now: float) -> None:
        g.generated.append(token)
        g.length += 1
        self.n_tokens += 1
        g.tenant.n_tokens += 1
        if _telemetry_state.enabled:
            telemetry.record_token(t_now - g.t_last, model=g.tenant.name)
        g.t_last = t_now
        g.handle._push(token)
        if len(g.generated) >= g.max_new:
            self._finalize_gen(g)

    def _finalize_gen(self, g, error: Optional[Exception] = None) -> None:
        """Resolve one generate request: free its pages, leave the
        batch, settle the future (exactly once) and seal the stream."""
        if g.pages is not None:
            self._pool.free(g)
            g.pages = None
        with self._cond:
            try:
                self._gen_active.remove(g)
            except ValueError:
                pass
            if error is not None:
                self.n_errors += 1
        fut = g.handle.future
        try:
            if error is None:
                fut.set_result(np.asarray(g.generated, dtype=np.int32))
            else:
                fut.set_exception(error)
        except Exception:   # noqa: BLE001 - already settled (racing stop)
            pass
        g.handle._seal()
        self._count_request(outcome="ok" if error is None else "error",
                            t_enqueue=g.t_submit,
                            trace_id=self._trace_id(g), tenant=g.tenant)
        if g.span is not None:
            g.span.end(outcome="ok" if error is None else "error")
            g.span = None
        if g.own_trace and g.trace is not None:
            g.trace.finish("ok" if error is None else type(error).__name__)

    def _fail_generates(self, exc: Exception) -> None:
        with self._cond:
            doomed = [g for q in self._gen_pending.values() for g in q]
            doomed += self._gen_active
            for q in self._gen_pending.values():
                del q[:]
        for g in doomed:
            self._finalize_gen(g, error=exc)

    # -- scheduler -----------------------------------------------------
    def _scheduler_loop(self) -> None:
        try:
            while True:
                self.hb.touch()
                batch, reason = self._next_batch()
                if batch is None:
                    # a non-drain stop may leave generates behind
                    self._fail_generates(MXNetError(
                        f"{self.name}: server stopped before this "
                        "generate completed"))
                    return
                if batch:
                    self._dispatch(batch, reason)
                if any(self._gen_pending.values()) or self._gen_active:
                    if not self._decode_tick():
                        # nothing admissible this instant (pool full,
                        # actives still hold pages): breathe, retry
                        with self._cond:
                            self._cond.wait(0.005)
        except BaseException:
            # a scheduler death must be LOUD, not a server that accepts
            # requests into a queue nobody drains
            with self._cond:
                self._running = False
                pending = [r for q in self._queues.values() for r in q]
                for q in self._queues.values():
                    del q[:]
            for r in pending:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(MXNetError(
                        f"{self.name}: scheduler thread crashed"))
                    self._end_trace_rejected(r, "error")
            self._fail_generates(MXNetError(
                f"{self.name}: scheduler thread crashed"))
            raise

    # -- model management ----------------------------------------------
    def current_model(self, model: Optional[str] = None):
        """The block currently served for ``model`` (default tenant when
        None; an upgrade keeps the old one for rollback)."""
        return self._tenant(model).block

    def swap_model(self, block, version: Optional[int] = None,
                   model: Optional[str] = None) -> None:
        """Replace ONE tenant's served model with ``block`` (on the
        server's device), warming it first; other tenants' blocks and
        versions are untouched. One-shot requests take the new block at
        their next dispatch; the tenant's decode engine takes its
        weights (recapturing its decode graphs) at the scheduler's next
        turn in which the tenant has no active completion, so a
        completion runs on one model version. The old block is left as
        it was. ``version`` overrides the monotonic bump (a rollback
        restores the old number)."""
        t = self._tenant(model)
        self._check_device(block)
        self._warm_block(block)
        with self._model_lock:
            t.block = block
            t.model_version = (t.model_version + 1
                               if version is None else int(version))
        self.n_reloads += 1
        with self._cond:
            self._cond.notify_all()

    def reload(self, manager, model_factory, step: Optional[int] = None,
               model: Optional[str] = None) -> int:
        """Reload from a :class:`~mxnet_tpu_torch.checkpoint.
        CheckpointManager` bundle: build a fresh block with
        ``model_factory(bundle_path)``, then :meth:`swap_model` it in;
        the old model serves until the swap. Fault site
        ``serving.reload``: transient failures retry, persistent ones
        raise (the old model keeps serving). Returns the loaded step."""
        t0 = time.perf_counter()
        if step is None:
            step = manager.latest_step()
            if step is None:
                raise MXNetError(
                    f"{self.name}: no checksum-valid checkpoint under "
                    f"{manager.directory!r} to reload from")
        path = manager.path(step)

        def build():
            if _fault_state.enabled:
                fault.check("serving.reload", path)
            return model_factory(path)

        try:
            block = fault.retry_call("serving.reload", build, detail=path)
            self.swap_model(block, model=model)
        except Exception:
            if _telemetry_state.enabled:
                telemetry.record_serving_reload(0.0, outcome="error")
            raise
        self.loaded_step = step
        if _telemetry_state.enabled:
            telemetry.record_serving_reload(time.perf_counter() - t0)
        return step

    def enable_hot_reload(self, manager, model_factory,
                          interval_s: float = 0.5,
                          tag: Optional[str] = None):
        """Start a watcher thread that polls ``manager``
        (:meth:`CheckpointManager.poll_newest`) and reloads on every new
        valid bundle (see :class:`~.reload.ReloadWatcher`)."""
        from .reload import ReloadWatcher

        if self._watcher is not None:
            raise MXNetError(f"{self.name}: hot reload already enabled")
        self._watcher = ReloadWatcher(
            self, manager, model_factory, interval_s=interval_s,
            tag=tag or self.name)
        self._watcher.start()
        return self._watcher

    def stats(self) -> dict:
        """Light always-on counters. ``close_reasons`` counts one-shot
        batches by why they closed; ``batch_rows`` / ``batch_slots`` are
        the real and the padded rows over those batches; ``models``
        holds each tenant's own counters."""
        with self._cond:
            models = {
                n: {"slo_class": t.slo_class, "priority": t.priority,
                    "weight": t.weight, "version": t.model_version,
                    "requests": t.n_requests, "shed": t.n_shed,
                    "preempted": t.n_preempted, "tokens": t.n_tokens,
                    "queue_depth": len(self._queues[n]),
                    "generates_pending": len(self._gen_pending[n])}
                for n, t in self._tenants.items()}
            out = {"requests": self.n_requests, "batches": self.n_batches,
                   "errors": self.n_errors, "reloads": self.n_reloads,
                   "shed": sum(m["shed"] for m in models.values()),
                   "cancelled": self.n_cancelled,
                   "queue_depth": sum(len(q) for q in self._queues.values()),
                   "loaded_step": self.loaded_step,
                   "model_version": self.model_version,
                   "running": self.is_running, "models": models,
                   "preemptions": self.n_preemptions,
                   "close_reasons": dict(self.close_reasons),
                   "batch_rows": self.batch_rows,
                   "batch_slots": self.batch_slots,
                   "warmup_forwards": self.n_warmup}
            if self._decode_pages is not None:
                out.update(
                    tokens=self.n_tokens,
                    generates_pending=sum(len(q) for q in
                                          self._gen_pending.values()),
                    generates_active=len(self._gen_active),
                    defrags=self.n_defrags,
                    kvcache=self._pool.stats() if self._pool else None)
        return out
