"""The step's FLOP count, the same on the CPU, on ``meta`` and on the card.

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products
PyTorch dispatches (``mm``, ``addmm``, ``bmm``, convolutions, ...) and 0
for norms, sweeps and elementwise passes. The port's own entry points
that carry matrix work do not all dispatch them: on the card a kernel
launches through ``ctypes``, and on the CPU or ``meta`` the plain
version may do other work than the kernel does (full-square products
under a causal mask, a chunked head's recompute). So each such entry
point counts its own formula while a count is open (:func:`add`) and
runs its body uncounted (:func:`uncounted`):

* flash forward 4·B·H·Lq·Lk·D, flash backward 8·B·H·Lq·Lk·D, both
  halved under a causal mask when Lq = Lk (with Lk > Lq, the
  Lq·(Lk − Lq) pairs before the diagonal block counted in full); the
  backward's recompute of QKᵀ is not counted, since MFU counts no
  recomputation;
* the paged decode 4·H·D per attended (query, key) pair;
* the fused projection + CE head 2·N·V·D forward, 4·N·V·D backward (its
  backward's recompute of each chunk's logits not counted).

A rematerialised span's recompute is not counted either
(``gluon.block.is_recomputing``). The open count is process-wide, not
per thread: the card's backward runs on autograd's device thread.
"""
from __future__ import annotations

import contextlib
import threading

from torch.utils.flop_counter import FlopCounterMode

__all__ = ["counting", "active", "add", "uncounted", "attention_pairs"]

_lock = threading.Lock()
_active = []        # the open counter (at most one), read without the lock


class _Counter(FlopCounterMode):
    """``FlopCounterMode`` that skips what runs under :func:`uncounted`
    and a rematerialised span's recompute."""

    def __init__(self):
        super().__init__(display=False)
        self.suppress = 0

    def _count_flops(self, *args, **kwargs):
        from ..gluon.block import is_recomputing

        if self.suppress or is_recomputing():
            return args[1] if len(args) > 1 else kwargs.get("out")
        return super()._count_flops(*args, **kwargs)

    @property
    def total(self) -> int:
        return int(self.get_total_flops())


@contextlib.contextmanager
def counting():
    """Open a count (one at a time in a process); yields the counter,
    whose ``total`` is the FLOPs dispatched and added inside."""
    counter = _Counter()
    with _lock:
        if _active:
            raise RuntimeError("a FLOP count is already open")
        _active.append(counter)
    try:
        with counter:
            yield counter
    finally:
        with _lock:
            _active.clear()


def active() -> bool:
    return bool(_active)


def add(name: str, flops) -> None:
    """Count ``flops`` under ``name`` in the open count (if any; not in
    a rematerialised span's recompute)."""
    if not _active:
        return
    from ..gluon.block import is_recomputing

    if is_recomputing():
        return
    counter = _active[0]
    tracker = getattr(counter, "mod_tracker", None)
    parents = set(getattr(tracker, "parents", ()) or ()) or {"Global"}
    for par in parents:
        counter.flop_counts[par][name] += int(flops)


@contextlib.contextmanager
def uncounted():
    """Run the body without counting what it dispatches."""
    counter = _active[0] if _active else None
    if counter is None:
        yield
        return
    counter.suppress += 1
    try:
        yield
    finally:
        counter.suppress -= 1


def attention_pairs(lq: int, lk: int, causal: bool) -> float:
    """(query, key) pairs attended by one head: Lq·Lk, or under a causal
    mask aligned at the bottom right Lq·(Lk − Lq) + Lq²/2."""
    if not causal:
        return float(lq) * lk
    return float(lq) * max(lk - lq, 0) + float(lq) * lq / 2.0
