"""``mx.storage`` — device memory introspection and pool control
(counterpart of ``mxnet_tpu/storage.py``; reference
``src/storage/storage.cc``, the Python surface
``mx.context.gpu_memory_info``).

On the card the pool is torch's caching allocator: :func:`memory_info`
is ``torch.cuda.mem_get_info``, :func:`pool_stats` reads
``torch.cuda.memory_stats`` and :func:`empty_cache` returns the pool's
free blocks to the driver. The CPU keeps no pool, and there the answers
are the reference's for a platform without stats: ``(0, 0)`` and zeros.
"""
from __future__ import annotations

import gc
from typing import Dict, Optional

import torch

from .context import Context, current_context

__all__ = ["memory_info", "pool_stats", "empty_cache"]


def _cuda(ctx: Optional[Context]):
    """The CUDA device of ``ctx`` (default: the current context), or None
    for a host context."""
    dev = (ctx or current_context()).torch_device()
    return dev if dev.type == "cuda" else None


def memory_info(ctx: Optional[Context] = None):
    """``(free_bytes, total_bytes)`` of a device (reference:
    ``mx.context.gpu_memory_info``); ``(0, 0)`` on the CPU."""
    dev = _cuda(ctx)
    if dev is None:
        return (0, 0)
    free, total = torch.cuda.mem_get_info(dev)
    return (int(free), int(total))


def pool_stats(ctx: Optional[Context] = None) -> Dict[str, int]:
    """The caching allocator's counters for one card: bytes of live
    tensors now and at the peak, the card's memory, allocations made so
    far and the largest live block; zeros on the CPU."""
    dev = _cuda(ctx)
    if dev is None:
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                "bytes_limit": 0, "num_allocs": 0, "largest_alloc_size": 0}
    st = torch.cuda.memory_stats(dev)
    largest = 0
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device") != dev.index:
            continue
        for blk in seg.get("blocks", ()):
            if blk.get("state") == "active_allocated":
                largest = max(largest, int(blk.get("size", 0)))
    return {
        "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": memory_info(ctx)[1],
        "num_allocs": int(st.get("allocation.all.allocated", 0)),
        "largest_alloc_size": largest,
    }


def empty_cache(ctx: Optional[Context] = None):
    """Release the pool's free blocks (reference: Context::empty_cache):
    ``torch.cuda.empty_cache`` on the card, a garbage collection pass on
    the CPU."""
    dev = _cuda(ctx)
    gc.collect()
    if dev is not None:
        with torch.cuda.device(dev):
            torch.cuda.empty_cache()
