"""Paged KV-cache pool for autoregressive decode.

Counterpart of ``mxnet_tpu/serving/kvcache.py``. :class:`PagePool`,
:class:`CacheFull` and :class:`Preempted` are copied (numpy only; the
pool publishes its page gauges to :mod:`mxnet_tpu_torch.telemetry` as
the reference's does). Keys and values
live in fixed-size pages of one preallocated per-replica arena, and each
request owns a list of pages: token ``i`` of a request whose page table
is ``pt`` lives at slot ``pt[i // page_size] * page_size + i % page_size``.

Page 0 is reserved as scratch: batch-padding rows and padded tail
positions write their meaningless K/V there, so a padded dispatch never
corrupts a live request's pages.

Unlike the JAX package, which rebuilt the arenas functionally, the
port's arenas are torch tensors updated in place (:func:`apply_defrag`
and the engine's K/V writes).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..telemetry import _state as _telemetry_state

__all__ = ["CacheFull", "Preempted", "PagePool", "make_kv_arena",
           "apply_defrag"]


class CacheFull(MXNetError):
    """Typed admission error: the KV arena cannot hold this request.
    Raised synchronously at admission, never as a wedged future."""


class Preempted(MXNetError):
    """This stream's pages were reclaimed for a higher-priority arrival.
    Raised (as the generate future's failure) by the multi-tenant
    scheduler at a decode-step boundary: every token the stream emitted
    before it is a clean prefix, and it emits no more."""


class PagePool:
    """Free-list allocator over ``n_pages`` fixed-size cache pages.

    ``page_size`` is in tokens. Page 0 is reserved as the padding
    scratch page and is never handed out. Thread-safe: the serving
    scheduler allocates while ``stats()`` readers observe.
    """

    def __init__(self, n_pages: int, page_size: int = 16):
        if n_pages < 2:
            raise MXNetError(
                f"PagePool needs >= 2 pages (page 0 is the reserved "
                f"scratch page), got {n_pages}")
        if page_size < 1:
            raise MXNetError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._free: deque = deque(range(1, self.n_pages))
        self._owned: Dict[object, List[int]] = {}
        self._publish()

    # -- capacity ------------------------------------------------------
    @property
    def slots(self) -> int:
        """Total arena slots (tokens), scratch page included."""
        return self.n_pages * self.page_size

    @property
    def capacity_tokens(self) -> int:
        """Tokens the pool can hold for real requests (scratch excluded)."""
        return (self.n_pages - 1) * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 1) // self.page_size)

    # -- allocation ----------------------------------------------------
    def alloc(self, owner, n_tokens: int) -> List[int]:
        """Allocate pages covering ``n_tokens`` for ``owner``. Raises
        :class:`CacheFull` (allocating nothing) when the free list is
        short — admission is all-or-nothing, so a request can never
        wedge half-allocated."""
        need = self.pages_for(n_tokens)
        with self._lock:
            if owner in self._owned:
                raise MXNetError(f"PagePool: owner {owner!r} already holds "
                                 f"{len(self._owned[owner])} page(s)")
            if need > len(self._free):
                raise CacheFull(
                    f"kv cache full: need {need} page(s) for {n_tokens} "
                    f"token(s), {len(self._free)} of "
                    f"{self.n_pages - 1} free")
            pages = [self._free.popleft() for _ in range(need)]
            self._owned[owner] = pages
        self._publish()
        return list(pages)

    def extend(self, owner, n_tokens: int) -> List[int]:
        """Grow ``owner``'s allocation to cover ``n_tokens`` total.
        Raises :class:`CacheFull` without changing the allocation when
        the free list cannot cover the growth."""
        need = self.pages_for(n_tokens)
        with self._lock:
            held = self._owned.get(owner)
            if held is None:
                raise MXNetError(f"PagePool: unknown owner {owner!r}")
            grow = need - len(held)
            if grow <= 0:
                return list(held)
            if grow > len(self._free):
                raise CacheFull(
                    f"kv cache full: owner {owner!r} needs {grow} more "
                    f"page(s), {len(self._free)} free")
            held.extend(self._free.popleft() for _ in range(grow))
            out = list(held)
        self._publish()
        return out

    def free(self, owner) -> int:
        """Return ``owner``'s pages to the free list (idempotent);
        returns the number of pages released."""
        with self._lock:
            pages = self._owned.pop(owner, None)
            if pages:
                self._free.extend(pages)
        self._publish()
        return len(pages) if pages else 0

    def page_table(self, owner, width: Optional[int] = None) -> np.ndarray:
        """``owner``'s page list as an int32 vector padded with the
        scratch page (0) up to ``width``."""
        with self._lock:
            pages = list(self._owned.get(owner, ()))
        if width is None:
            width = len(pages)
        if len(pages) > width:
            raise MXNetError(
                f"PagePool: owner {owner!r} holds {len(pages)} page(s), "
                f"page_table width {width} too small")
        out = np.zeros((width,), dtype=np.int32)
        out[:len(pages)] = pages
        return out

    def owned(self, owner) -> List[int]:
        """``owner``'s current page list (a copy). Needed after
        :meth:`defrag`, which renumbers pages in place."""
        with self._lock:
            return list(self._owned.get(owner, ()))

    # -- observability -------------------------------------------------
    def frag_info(self) -> Tuple[int, int]:
        """``(n_live, span)``: live page count and the highest live page
        index (0 when empty). ``span - n_live`` is the number of free
        holes below the high-water mark."""
        with self._lock:
            live = [p for pages in self._owned.values() for p in pages]
            return len(live), (max(live) if live else 0)

    def stats(self) -> dict:
        with self._lock:
            used = sum(len(p) for p in self._owned.values())
            return {"free": len(self._free), "used": used, "reserved": 1,
                    "owners": len(self._owned),
                    "page_size": self.page_size,
                    "n_pages": self.n_pages}

    def _publish(self) -> None:
        if not _telemetry_state.enabled:
            return
        from .. import telemetry

        s = self.stats()
        telemetry.set_kvcache_pages(s["free"], s["used"], s["reserved"])

    # -- defrag --------------------------------------------------------
    def defrag(self) -> List[Tuple[int, int]]:
        """Pack live pages down to the lowest page indices. Returns the
        ``(src, dst)`` page moves performed (empty when already packed);
        the caller replays them onto the arena with
        :func:`apply_defrag` *before* the next dispatch reads it."""
        with self._lock:
            live = sorted(p for pages in self._owned.values()
                          for p in pages)
            target = {src: dst for dst, src in
                      enumerate(live, start=1) if src != dst}
            if not target:
                return []
            moves = sorted(target.items(), key=lambda m: m[1])
            for pages in self._owned.values():
                for i, p in enumerate(pages):
                    pages[i] = target.get(p, p)
            self._free = deque(range(len(live) + 1, self.n_pages))
            return moves


def make_kv_arena(n_layers: int, pool: PagePool, n_kv_heads: int,
                  head_dim: int, dtype=torch.float32, device=None):
    """Preallocate the per-replica K and V arenas,
    ``(n_layers, pool.slots, n_kv_heads, head_dim)`` zeros each, on
    ``device`` (default: the card)."""
    shape = (int(n_layers), pool.slots, int(n_kv_heads), int(head_dim))
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def apply_defrag(arena: torch.Tensor, moves, page_size: int) -> torch.Tensor:
    """Replay :meth:`PagePool.defrag` page moves onto one arena
    (``(layers, slots, heads, dim)``) in place. The source rows are
    gathered into a copy first, so overlapping src/dst chains are safe."""
    if not moves:
        return arena
    src = np.concatenate([np.arange(s * page_size, (s + 1) * page_size)
                          for s, _ in moves])
    dst = np.concatenate([np.arange(d * page_size, (d + 1) * page_size)
                          for _, d in moves])
    src_t = torch.from_numpy(src).to(arena.device)
    dst_t = torch.from_numpy(dst).to(arena.device)
    arena[:, dst_t] = arena[:, src_t]
    return arena
