"""``mx.serving.Server`` — continuous-batching generate server.

Counterpart of ``mxnet_tpu/serving/server.py`` on its single-tenant
generate path: :meth:`Server.submit_generate` queues an autoregressive
greedy-decode request over a paged KV cache, and one scheduler thread
runs continuous batching — each turn admits pending requests with
all-or-nothing page allocation, prefills them grouped by len bucket
(``_prefill_batch``), then runs ONE ``(batch, 1)`` decode step for every
active stream (``_decode_batch``). Requests join and leave the decode
batch at any step boundary; tokens stream into a :class:`GenerateHandle`.

The model runs on the card unless ``ctx=mx.cpu()`` is passed; the
model's weights must live on the server's device.

Not yet ported (queued in ROADMAP.md): one-shot ``submit`` and its SLO
batcher, multi-tenancy and preemption, hot reload, telemetry, tracing
and fault injection.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from .buckets import DEFAULT_LEN_BUCKETS, BucketGrid
from .kvcache import CacheFull, PagePool

__all__ = ["Server", "GenerateHandle"]


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


class Server:
    """Serve a decode-capable model (one with ``decode_engine(pool,
    dtype)``, e.g. :class:`~mxnet_tpu_torch.gluon.model_zoo.nlp.LlamaModel`)
    with continuous-batching greedy generation::

        net = mx.gluon.model_zoo.nlp.llama_3_8b(dtype=torch.bfloat16)
        with mx.serving.Server(net, dtype="bfloat16", decode_pages=1024,
                               batch_buckets=(1, 2, 4, 8),
                               len_buckets=(128, 512)) as srv:
            h = srv.submit_generate(prompt, max_new_tokens=32)
            tokens = h.result()

    ``dtype``: the engine's KV/compute dtype when it is a float dtype,
    else float32 (a token server keeps float caches). ``decode_pages`` x
    ``page_size`` tokens make the KV arena (page 0 is scratch).
    ``len_buckets``: allowed padded prefill lengths. ``batch_buckets``:
    allowed dispatch batch sizes. ``max_generate_tokens``: the
    per-request prompt + completion budget. ``defrag_threshold``: pack
    the pool when free holes below its high-water mark exceed this share
    of it (None disables). ``slo_ms`` is validated and kept for the
    one-shot ``submit`` path of a later slice; generates carry their own
    ``deadline_ms``.
    """

    def __init__(self, block, batch_buckets=(1, 2, 4, 8, 16, 32),
                 slo_ms: float = 100.0, max_queue: int = 4096,
                 dtype: str = "float32", ctx=None,
                 name: Optional[str] = None,
                 decode_pages: Optional[int] = None, page_size: int = 16,
                 len_buckets=None,
                 max_generate_tokens: Optional[int] = None,
                 defrag_threshold: Optional[float] = 0.25):
        if slo_ms <= 0:
            raise MXNetError(f"slo_ms must be > 0, got {slo_ms}")
        if max_queue < 1:
            raise MXNetError(f"max_queue must be >= 1, got {max_queue}")
        if decode_pages is None:
            raise MXNetError(
                "decode_pages is required: the port serves "
                "submit_generate only (one-shot submit is a later slice)")
        if not hasattr(block, "decode_engine"):
            raise MXNetError(
                "the model has no decode_engine() seam (paged-KV generate "
                "needs a decode-capable model)")
        self.device = resolve_device(ctx)
        dev = next(block.parameters()).device
        if dev != self.device:
            raise MXNetError(f"the model's weights are on {dev}, the "
                             f"server's ctx is {self.device}")
        self._block = block
        self.grid = BucketGrid(batch_buckets,
                               len_buckets=len_buckets
                               if len_buckets is not None
                               else DEFAULT_LEN_BUCKETS)
        self._decode_pages = int(decode_pages)
        self._page_size = int(page_size)
        cap = (self._decode_pages - 1) * self._page_size
        self._max_gen_tokens = int(
            max_generate_tokens if max_generate_tokens is not None
            else min(cap, self.grid.len_buckets[-1] + 256))
        if self._max_gen_tokens > cap:
            raise MXNetError(
                f"max_generate_tokens={self._max_gen_tokens} exceeds "
                f"the pool's {cap}-token capacity "
                f"({decode_pages} pages x {page_size}, scratch "
                "page excluded)")
        self._defrag_min_pages: Optional[int] = None
        if defrag_threshold is not None:
            if not 0 < float(defrag_threshold) <= 1:
                raise MXNetError(
                    f"defrag_threshold must be in (0, 1] or None, got "
                    f"{defrag_threshold}")
            self._defrag_min_pages = max(
                2, int(float(defrag_threshold) * (self._decode_pages - 1)))
        dt = torch_dtype(dtype)
        self.dtype = dtype
        self.engine_dtype = dt if dt.is_floating_point else torch.float32
        self.slo_s = slo_ms / 1e3
        self.max_queue = int(max_queue)
        self.name = name or f"server_{id(self):x}"
        self.engine = None
        self._pool: Optional[PagePool] = None
        self._gen_table_w = 0
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
        self.n_tokens = 0
        self.n_defrags = 0

    # -- lifecycle -----------------------------------------------------
    @property
    def is_running(self) -> bool:
        return self._running or (self._thread is not None
                                 and self._thread.is_alive())

    def start(self) -> "Server":
        """Build the page pool and the decode engine, start the
        scheduler thread."""
        if self.is_running:
            raise MXNetError(f"{self.name}: already running")
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

    def stop(self, drain: bool = True, timeout: Optional[float] = None
             ) -> None:
        """Stop the server. ``drain=True`` (default) finishes every
        queued and active generate first; ``drain=False`` fails them with
        :class:`MXNetError`."""
        with self._cond:
            self._running = False
            self._drain = bool(drain)
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
    def submit_generate(self, prompt, max_new_tokens: int,
                        deadline_ms: Optional[float] = None,
                        on_token=None) -> GenerateHandle:
        """Enqueue one generate request: ``prompt`` is a 1-D int token
        array, ``max_new_tokens`` the completion budget (greedy decode).
        Returns a :class:`GenerateHandle` streaming tokens as the
        continuous batcher produces them.

        Rejection is synchronous and typed: :class:`~.kvcache.CacheFull`
        when the request can never fit the per-request cache budget,
        :class:`MXNetError` when no len bucket fits the prompt, the
        queue is full, or the server is not running. ``deadline_ms``
        bounds the WHOLE completion (default: none); a request that
        misses it fails its future typed.
        """
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
                with self._cond:
                    while self._running and not (self._gen_pending
                                                 or self._gen_active):
                        self._cond.wait(0.1)
                    if not self._running and not (
                            self._drain and (self._gen_pending
                                             or self._gen_active)):
                        break
                if not self._decode_tick():
                    # nothing admissible this instant (pool full, actives
                    # still hold pages): breathe, retry
                    with self._cond:
                        self._cond.wait(0.005)
        except BaseException:
            # a scheduler death must be LOUD, not a server that accepts
            # requests into a queue nobody drains
            with self._cond:
                self._running = False
            self._fail_generates(MXNetError(
                f"{self.name}: scheduler thread crashed"))
            raise
        self._fail_generates(MXNetError(
            f"{self.name}: server stopped before this generate completed"))

    def stats(self) -> dict:
        """Light always-on counters."""
        with self._cond:
            pending = len(self._gen_pending)
            active = len(self._gen_active)
        return {"requests": self.n_requests, "batches": self.n_batches,
                "errors": self.n_errors, "shed": self.n_shed,
                "running": self.is_running, "tokens": self.n_tokens,
                "generates_pending": pending, "generates_active": active,
                "defrags": self.n_defrags,
                "kvcache": self._pool.stats() if self._pool else None}
