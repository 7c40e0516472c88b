"""``mx.serving.Server`` — the SLO batcher and the continuous-batching
generate server.

Counterpart of ``mxnet_tpu/serving/server.py`` on its single-tenant
paths. One scheduler thread serves both:

* :meth:`Server.submit` (one-shot): any thread hands in ONE sample (no
  batch dimension) and gets a ``concurrent.futures.Future``. The sample
  is padded into its shape bucket and queued; ``_next_batch`` closes a
  batch when it is ``full``, when the tightest deadline in the queue
  (SLO minus ``close_margin_ms``) arrives (``deadline``), when the oldest
  request has waited ``batch_timeout_ms`` (``timeout``), or on a
  draining stop (``drain``). ``_dispatch`` pads the batch to a batch
  bucket, runs the model once under ``torch.inference_mode()`` in
  predict mode (``autograd.predict_mode()``: every dropout site is the
  identity, so a model built with dropout serves what it serves at
  dropout 0), copies each output leaf to the host once and resolves
  every future with its own row.
* :meth:`Server.submit_generate` (with ``decode_pages``): an
  autoregressive greedy-decode request over a paged KV cache. Each turn
  admits pending requests with all-or-nothing page allocation, prefills
  them grouped by len bucket (``_prefill_batch``), then runs ONE
  ``(batch, 1)`` decode step for every active stream
  (``_decode_batch``); tokens stream into a :class:`GenerateHandle`.
  Decode turns interleave with the one-shot batch fill (``_next_batch``
  returns ``([], "decode")``), so neither parks the other.

The model runs on the card unless ``ctx=mx.cpu()`` is passed; the
model's weights must live on the server's device. Output leaves come
back as numpy arrays; a bfloat16 leaf comes back as float32 (numpy has
no bfloat16 here).

Not yet ported (queued in ROADMAP.md): multi-tenancy and preemption,
hot reload, telemetry, tracing and fault injection.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from .buckets import DEFAULT_LEN_BUCKETS, BucketGrid
from .kvcache import CacheFull, PagePool

__all__ = ["Server", "GenerateHandle"]

CLOSE_REASONS = ("full", "deadline", "timeout", "drain")


class _Request:
    __slots__ = ("sample", "shape_key", "future", "t_enqueue", "deadline")

    def __init__(self, sample, shape_key, deadline_s):
        self.sample = sample                 # numpy, padded to its bucket
        self.shape_key = shape_key
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = self.t_enqueue + deadline_s


class GenerateHandle:
    """Streaming handle for one autoregressive generate request.

    ``future`` resolves to the full int32 token array when the
    completion finishes (or raises the typed failure — ``CacheFull``,
    ``MXNetError``: a generate never wedges). ``on_token(index, token)``
    fires per token from the scheduler thread (keep it cheap),
    ``tokens()`` snapshots what has arrived, and ``next_token(i)`` blocks
    until token ``i`` exists or the stream ends (None when it ended
    first).
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
                 "generated", "t_submit", "t_last", "deadline",
                 "len_bucket")

    def __init__(self, prompt, max_new, handle, deadline_s, len_bucket):
        self.prompt = prompt                 # 1-D int32 token array
        self.max_new = int(max_new)
        self.handle = handle
        self.pages = None                    # page list once admitted
        self.length = len(prompt)            # tokens written OR known
        self.generated: list = []
        self.t_submit = time.perf_counter()
        self.t_last = self.t_submit
        self.deadline = (self.t_submit + deadline_s
                         if deadline_s is not None else None)
        self.len_bucket = len_bucket


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
    """Serve a model under a latency SLO with bucketed batching, and —
    with ``decode_pages`` and a decode-capable model (one with
    ``decode_engine(pool, dtype)``, e.g.
    :class:`~mxnet_tpu_torch.gluon.model_zoo.nlp.LlamaModel`) —
    continuous-batching greedy generation::

        net = mx.gluon.model_zoo.nlp.bert_12_768_12(dtype=torch.bfloat16)
        with mx.serving.Server(net, shape_buckets=[(128,), (512,)],
                               batch_buckets=(1, 8, 32),
                               slo_ms=500) as srv:
            seq, pooled, cls, mlm = srv.submit(token_ids).result()

        net = mx.gluon.model_zoo.nlp.llama_3_8b(dtype=torch.bfloat16)
        with mx.serving.Server(net, dtype="bfloat16", decode_pages=1024,
                               batch_buckets=(1, 2, 4, 8),
                               len_buckets=(128, 512)) as srv:
            tokens = srv.submit_generate(prompt, max_new_tokens=32).result()

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
    a float dtype (float32 otherwise). ``warmup``: run one forward per
    grid signature at :meth:`start` (with ``shape_buckets``).

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
        dev = next(block.parameters()).device
        if dev != self.device:
            raise MXNetError(f"the model's weights are on {dev}, the "
                             f"server's ctx is {self.device}")
        self._block = block
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
        self.engine = None
        self._pool: Optional[PagePool] = None
        self._gen_table_w = 0
        self._queue: list = []
        self._gen_pending: list = []
        self._gen_active: list = []
        self._cond = threading.Condition()
        self._drain = True
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # always-on light counters
        self.n_requests = 0
        self.n_batches = 0
        self.n_errors = 0
        self.n_shed = 0
        self.n_cancelled = 0
        self.n_tokens = 0
        self.n_defrags = 0
        self.n_warmup = 0
        self.batch_rows = 0          # real rows over dispatched batches
        self.batch_slots = 0         # their padded batch buckets
        self.close_reasons = dict.fromkeys(CLOSE_REASONS, 0)

    # -- lifecycle -----------------------------------------------------
    @property
    def is_running(self) -> bool:
        return self._running or (self._thread is not None
                                 and self._thread.is_alive())

    def start(self) -> "Server":
        """Warm the bucket grid (one forward per signature), build the
        page pool and decode engine when generate is on, and start the
        scheduler thread."""
        if self.is_running:
            raise MXNetError(f"{self.name}: already running")
        if self._decode_pages is not None \
                and not hasattr(self._block, "decode_engine"):
            raise MXNetError(
                f"{self.name}: decode_pages set but the model has no "
                "decode_engine() seam (paged-KV generate needs a "
                "decode-capable model)")
        self._warm()
        if self._decode_pages is not None:
            self._pool = PagePool(self._decode_pages, self._page_size)
            self.engine = self._block.decode_engine(self._pool,
                                                    dtype=self.engine_dtype)
            self._gen_table_w = self._pool.pages_for(self._max_gen_tokens)
        self._running = True
        self._drain = True
        self._thread = threading.Thread(
            target=self._scheduler_loop, name=self.name, daemon=True)
        self._thread.start()
        return self

    def _warm(self) -> None:
        """One forward per (batch bucket, shape bucket) signature, so the
        first requests do not pay for cuBLAS's first pick of each GEMM
        shape, the allocator's first blocks, or a kernel library's
        build and load."""
        if not self._warmup or self.grid.shape_buckets is None:
            return
        with torch.inference_mode(), autograd.predict_mode():
            for sig in self.grid.input_signatures():
                self._block(torch.zeros(sig, dtype=self.input_dtype,
                                        device=self.device))
                self.n_warmup += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self, drain: bool = True, timeout: Optional[float] = None
             ) -> None:
        """Stop the server. ``drain=True`` (default) serves every queued
        request and finishes every generate first (batches close at
        once, SLO waits skipped); ``drain=False`` fails them with
        :class:`MXNetError`."""
        with self._cond:
            self._running = False
            self._drain = bool(drain)
            if not drain:
                pending, self._queue = self._queue, []
                for r in pending:
                    if not r.future.set_running_or_notify_cancel():
                        self.n_cancelled += 1
                        continue        # the caller cancelled it
                    r.future.set_exception(
                        MXNetError(f"{self.name}: server stopped before "
                                   "this request was dispatched"))
                    self.n_requests += 1
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise MXNetError(
                    f"{self.name}: scheduler thread did not exit within "
                    f"{timeout}s")
            self._thread = None

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=not any(exc))

    # -- ingress -------------------------------------------------------
    def submit(self, sample, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one sample (NO batch dimension); returns a Future that
        resolves to the model's output for that sample (numpy leaves,
        in the model's output structure). Thread-safe.

        Rejection is synchronous and typed: :class:`MXNetError` when no
        shape bucket fits the sample, the queue is full, or the server
        is not running — never a hung future. ``deadline_ms`` overrides
        the server's SLO for this request."""
        if isinstance(sample, torch.Tensor):
            sample = sample.detach().cpu().numpy()
        arr = np.ascontiguousarray(sample, dtype=self._np_dtype)
        bucket = self.grid.bucket_shape(arr.shape)   # raises if none fits
        arr = self.grid.pad_sample(arr, bucket)
        req = _Request(arr, bucket, deadline_ms / 1e3
                       if deadline_ms is not None else self.slo_s)
        with self._cond:
            if not self._running:
                self.n_requests += 1
                raise MXNetError(f"{self.name}: server is not running")
            if len(self._queue) >= self.max_queue:
                self.n_requests += 1
                raise MXNetError(
                    f"{self.name}: submission queue full ({self.max_queue} "
                    "requests)")
            self._queue.append(req)
            self._cond.notify_all()
        return req.future

    def submit_generate(self, prompt, max_new_tokens: int,
                        deadline_ms: Optional[float] = None,
                        on_token=None) -> GenerateHandle:
        """Enqueue one generate request: ``prompt`` is a 1-D int token
        array, ``max_new_tokens`` the completion budget (greedy decode).
        Returns a :class:`GenerateHandle` streaming tokens as the
        continuous batcher produces them.

        Rejection is synchronous and typed: :class:`~.kvcache.CacheFull`
        when the request can never fit the per-request cache budget,
        :class:`MXNetError` when decode is not enabled, no len bucket
        fits the prompt, the queue is full, or the server is not
        running. ``deadline_ms`` bounds the WHOLE completion (default:
        none); a request that misses it fails its future typed.
        """
        if self._decode_pages is None:
            raise MXNetError(f"{self.name}: decode is not enabled "
                             "(construct the server with decode_pages=)")
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
            with self._cond:
                self.n_shed += 1
            raise CacheFull(
                f"{self.name}: prompt {arr.size} + max_new_tokens "
                f"{max_new_tokens} exceeds the {self._max_gen_tokens}-"
                "token per-request cache budget")
        handle = GenerateHandle(on_token)
        req = _GenRequest(arr, max_new_tokens, handle,
                          deadline_ms / 1e3 if deadline_ms is not None
                          else None, len_bucket)
        with self._cond:
            if not self._running:
                self.n_requests += 1
                raise MXNetError(f"{self.name}: server is not running")
            if len(self._gen_pending) >= self.max_queue:
                self.n_requests += 1
                raise MXNetError(
                    f"{self.name}: generate queue full ({self.max_queue} "
                    "requests)")
            self._gen_pending.append(req)
            self._cond.notify_all()
        return handle

    # -- one-shot batching ---------------------------------------------
    def _next_batch(self):
        """Block until a batch should close; returns (requests, reason),
        ``([], "decode")`` when decode work should run NOW (continuous
        batching never parks the scheduler while generates are live),
        or (None, None) on shutdown with nothing left to serve.

        Close rules, in order: ``full`` (the head's shape key has a
        whole biggest bucket queued), ``drain`` (stopping), then
        ``timeout`` / ``deadline``: the batch closes at the TIGHTEST
        deadline in the queue minus the close margin, or when the head
        (the oldest request) has waited ``batch_timeout_ms``, whichever
        comes first. A batch takes up to ``max_batch`` requests of the
        head's shape key, in submit order."""
        with self._cond:
            while True:
                gen_work = bool(self._gen_pending or self._gen_active)
                q = self._queue
                if not q:
                    if not self._running:
                        if gen_work and self._drain:
                            return [], "decode"
                        return None, None
                    if gen_work:
                        return [], "decode"
                    self._cond.wait(0.1)
                    continue
                cap = self.grid.max_batch
                head = q[0]
                key = head.shape_key
                now = time.perf_counter()
                if sum(1 for r in q if r.shape_key == key) >= cap:
                    reason = "full"
                elif not self._running:
                    reason = "drain"
                else:
                    # the tightest deadline, not just the head's: a
                    # short-deadline request behind a lazy head must not
                    # wait out the head's SLO
                    deadline_at = min(r.deadline for r in q) - self.margin_s
                    timeout_at = (head.t_enqueue + self.batch_timeout_s
                                  if self.batch_timeout_s is not None
                                  else None)
                    close_at = deadline_at if timeout_at is None \
                        else min(deadline_at, timeout_at)
                    if now < close_at:
                        if gen_work:
                            # decode steps interleave with the batch fill
                            return [], "decode"
                        self._cond.wait(min(close_at - now, 0.1))
                        continue
                    reason = ("timeout" if timeout_at is not None
                              and timeout_at <= close_at + 1e-9
                              and now < deadline_at else "deadline")
                taken, rest = [], []
                for r in q:
                    if len(taken) < cap and r.shape_key == key:
                        taken.append(r)
                    else:
                        rest.append(r)
                self._queue = rest
                return taken, reason

    def _dispatch(self, batch, reason: str) -> None:
        """Pad, run, slice, resolve — one bucketed inference dispatch. A
        failure fails this batch's futures, not the server."""
        # a caller may have cancelled a still-queued future: drop it now
        # (set_result on a cancelled future would raise)
        live = [r for r in batch if r.future.set_running_or_notify_cancel()]
        self.n_cancelled += len(batch) - len(live)
        if not live:
            return
        n = len(live)
        key = live[0].shape_key
        cap = self.grid.batch_bucket(n)
        payload = np.zeros((cap,) + key, dtype=self._np_dtype)
        for i, r in enumerate(live):
            payload[i] = r.sample
        try:
            x = torch.from_numpy(payload).to(self.device, self.input_dtype)
            with torch.inference_mode(), autograd.predict_mode():
                out = self._block(x)
            leaves, tree = _flatten(out)
            # one host copy per leaf per batch; futures get row copies (a
            # row view would pin the whole padded batch)
            leaves = [_to_numpy(leaf) for leaf in leaves]
            results = [_unflatten(tree, [leaf[i].copy() for leaf in leaves])
                       for i in range(n)]
        except Exception as e:  # noqa: BLE001 - forwarded to the futures
            with self._cond:
                self.n_errors += 1
                self.n_requests += n
            for r in live:
                r.future.set_exception(e)
            return
        with self._cond:
            self.n_batches += 1
            self.close_reasons[reason] += 1
            self.batch_rows += n
            self.batch_slots += cap
            self.n_requests += n
        for r, res in zip(live, results):
            r.future.set_result(res)

    # -- decode phase (continuous batching) ----------------------------
    def _admit_pages(self, g: _GenRequest):
        """All-or-nothing page allocation for ``g``'s prompt plus its
        whole completion budget; raises :class:`CacheFull`."""
        return self._pool.alloc(g, g.length + g.max_new)

    def _decode_tick(self) -> bool:
        """One continuous-batching turn: admit pending generates
        (prefill), then run ONE decode step for every active request.
        Returns False when nothing could move (the scheduler backs
        off)."""
        progressed = False
        now = time.perf_counter()
        with self._cond:
            pending = list(self._gen_pending)
            n_active = len(self._gen_active)
        admitted: list = []
        for g in pending:
            if len(admitted) >= self.grid.max_batch:
                break
            if g.deadline is not None and now > g.deadline:
                self._remove_pending(g)
                self._finalize_gen(g, error=MXNetError(
                    f"{self.name}: generate deadline expired before "
                    "prefill (cache/backlog starvation)"))
                progressed = True
                continue
            try:
                g.pages = self._admit_pages(g)
            except CacheFull as e:
                if not n_active and not admitted:
                    # nothing holds pages and it STILL does not fit:
                    # waiting cannot help — shed typed, never wedge
                    with self._cond:
                        self.n_shed += 1
                    self._remove_pending(g)
                    self._finalize_gen(g, error=e)
                    progressed = True
                    continue
                break       # FIFO head blocked until actives free pages
            self._remove_pending(g)
            admitted.append(g)
        if admitted:
            groups: dict = {}
            for g in admitted:
                groups.setdefault(g.len_bucket, []).append(g)
            for len_bucket in sorted(groups):
                self._prefill_batch(groups[len_bucket], len_bucket)
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
        cap = self.grid.max_batch
        for i in range(0, len(active), cap):
            self._decode_batch(active[i:i + cap])
        self._maybe_defrag()
        return progressed or bool(active) or bool(expired)

    def _maybe_defrag(self) -> None:
        """Automatic defrag between decode steps: when the free holes
        below the pool's high-water mark exceed the threshold, pack live
        pages down, replay the permutation onto the engine's arenas, and
        refresh every active stream's page snapshot."""
        if self._defrag_min_pages is None:
            return
        n_live, span = self._pool.frag_info()
        if n_live == 0 or span - n_live < self._defrag_min_pages:
            return
        moves = self._pool.defrag()
        if not moves:
            return
        self.engine.apply_defrag(moves)
        with self._cond:
            for g in self._gen_active:
                g.pages = self._pool.owned(g)
        self.n_defrags += 1

    def _remove_pending(self, g) -> None:
        with self._cond:
            try:
                self._gen_pending.remove(g)
            except ValueError:
                pass

    def _prefill_batch(self, group, len_bucket: int) -> None:
        """Prefill one len-bucket group: write the prompts' K/V into
        their pages and emit each request's FIRST token."""
        cap = self.grid.batch_bucket(len(group))
        w = self._gen_table_w
        tokens = np.zeros((cap, len_bucket), dtype=np.int32)
        lengths = np.zeros((cap,), dtype=np.int32)
        table = np.zeros((cap, w), dtype=np.int32)
        for i, g in enumerate(group):
            tokens[i, :g.prompt.size] = g.prompt
            lengths[i] = g.prompt.size
            table[i, :len(g.pages)] = g.pages
        try:
            logits = self.engine.prefill(tokens, lengths, table)
        except Exception as e:  # noqa: BLE001 - forwarded to the handles
            self.n_errors += 1
            for g in group:
                self._finalize_gen(g, error=e)
            return
        self.n_batches += 1
        with self._cond:
            self._gen_active.extend(group)
        t_now = time.perf_counter()
        for i, g in enumerate(group):
            self._emit_token(g, int(np.argmax(logits[i])), t_now)

    def _decode_batch(self, chunk) -> None:
        """ONE decode step for up to max_batch active requests: a
        ``(batch, 1)`` dispatch whatever depth each request is at."""
        cap = self.grid.batch_bucket(len(chunk))
        w = self._gen_table_w
        tokens = np.zeros((cap,), dtype=np.int32)
        lengths = np.zeros((cap,), dtype=np.int32)
        table = np.zeros((cap, w), dtype=np.int32)
        for i, g in enumerate(chunk):
            tokens[i] = g.generated[-1]
            lengths[i] = g.length
            table[i, :len(g.pages)] = g.pages
        try:
            logits = self.engine.decode_step(tokens, lengths, table)
        except Exception as e:  # noqa: BLE001 - forwarded to the handles
            self.n_errors += 1
            for g in chunk:
                self._finalize_gen(g, error=e)
            return
        t_now = time.perf_counter()
        for i, g in enumerate(chunk):
            self._emit_token(g, int(np.argmax(logits[i])), t_now)

    def _emit_token(self, g, token: int, t_now: float) -> None:
        g.generated.append(token)
        g.length += 1
        self.n_tokens += 1
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
            self.n_requests += 1        # submitters count rejections too
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

    def _fail_generates(self, exc: Exception) -> None:
        with self._cond:
            doomed = self._gen_pending + self._gen_active
            self._gen_pending = []
        for g in doomed:
            self._finalize_gen(g, error=exc)

    # -- scheduler -----------------------------------------------------
    def _scheduler_loop(self) -> None:
        try:
            while True:
                batch, reason = self._next_batch()
                if batch is None:
                    # a non-drain stop may leave generates behind
                    self._fail_generates(MXNetError(
                        f"{self.name}: server stopped before this "
                        "generate completed"))
                    return
                if batch:
                    self._dispatch(batch, reason)
                if self._gen_pending or self._gen_active:
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
                pending, self._queue = self._queue, []
            for r in pending:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(MXNetError(
                        f"{self.name}: scheduler thread crashed"))
            self._fail_generates(MXNetError(
                f"{self.name}: scheduler thread crashed"))
            raise

    def stats(self) -> dict:
        """Light always-on counters. ``close_reasons`` counts one-shot
        batches by why they closed; ``batch_rows`` / ``batch_slots`` are
        the real and the padded rows over those batches (their ratio is
        the mean occupancy)."""
        with self._cond:
            return {"requests": self.n_requests, "batches": self.n_batches,
                    "errors": self.n_errors, "shed": self.n_shed,
                    "cancelled": self.n_cancelled,
                    "running": self.is_running, "queued": len(self._queue),
                    "close_reasons": dict(self.close_reasons),
                    "batch_rows": self.batch_rows,
                    "batch_slots": self.batch_slots,
                    "warmup_forwards": self.n_warmup,
                    "tokens": self.n_tokens,
                    "generates_pending": len(self._gen_pending),
                    "generates_active": len(self._gen_active),
                    "defrags": self.n_defrags,
                    "kvcache": self._pool.stats() if self._pool else None}
