"""The exchange primitives of the data-parallel comms: one fixed
summation order for every path.

In the reference, XLA's ``psum`` (and ``psum_scatter``/``all_gather``)
reduces a gradient; its reduction tree is the same for a key exchanged
alone, inside a flat bucket, or carved into ZeRO shards, so the
reference's bucketed, per-key and sharded exchanges agree bit for bit
(``kvstore/bucketing.py:23-28``, ``optimizer/zero.py:22-30``). A
``torch.distributed`` ``all_reduce`` or ``reduce_scatter`` gives no such
promise: gloo at three or more workers, and NCCL's ring at any, sum each
element in an order set by how the buffer is chunked, so the same
element reduced inside two buckets of different sizes can round
differently. This module fixes the order instead:

* :func:`reduce_scatter` zero-pads the flat buffer to a multiple of the
  world, sends shard ``r`` to rank ``r`` with one ``all_to_all_single``,
  and sums the world's copies of its shard in rank order, left to right,
  in the buffer's dtype, each add rounded once;
* :func:`allreduce` is :func:`reduce_scatter` then :func:`all_gather`;
* :func:`all_gather` concatenates every rank's shard in rank order.

On the wire this moves what a ring allreduce moves, ``(world - 1) /
world`` of the buffer each way, and every element's sum is the same
whatever bucket, offset or shard it lies in: per key = bucketed = zero1
= zero2, at any world. :func:`local_sum` sums the copies of several
contexts of one process in the same left-to-right order; a process's
copies are summed first, then the processes.

The primitives run over the default process group; without one (one
worker, as the reference runs one) they return their input, and a group
of one rank still runs its collectives. Nothing else in the port calls a
collective.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch

__all__ = ["world", "rank", "local_sum", "reduce_scatter", "allreduce",
           "all_gather", "shard_len"]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def world() -> int:
    """Processes in the group (1 without one)."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def rank() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def shard_len(n: int, w: int) -> int:
    """Elements of each rank's shard of an ``n``-element buffer."""
    return -(-int(n) // int(w))


def local_sum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of one buffer's copies held by this process (one per
    context), left to right in the buffers' dtype, each add rounded
    once, on the first copy's device. One copy is returned as it is."""
    if len(tensors) == 1:
        return tensors[0]
    dev = tensors[0].device
    with torch.no_grad():
        acc = tensors[0].clone()
        for t in tensors[1:]:
            acc.add_(t if t.device == dev else t.to(dev))
    return acc


def _padded(flat: torch.Tensor, w: int) -> torch.Tensor:
    n = flat.numel()
    s = shard_len(n, w)
    if s * w == n:
        return flat
    buf = flat.new_zeros(s * w)
    buf[:n].copy_(flat)
    return buf


def reduce_scatter(flat: torch.Tensor) -> torch.Tensor:
    """This rank's shard (``shard_len(flat.numel(), world())`` elements,
    the padded tail zeros) of the sum over the group of the 1-D
    ``flat``, summed in rank order. A buffer whose length the world does
    not divide is padded here: torch's ``reduce_scatter_tensor`` would
    abort the process on it."""
    d = _dist()
    if d is None:
        return flat
    w = world()
    buf = _padded(flat, w)
    s = buf.numel() // w
    recv = torch.empty_like(buf)
    d.all_to_all_single(recv, buf)
    parts = recv.view(w, s)
    with torch.no_grad():
        acc = parts[0].clone()
        for r in range(1, w):
            acc.add_(parts[r])
    return acc


def all_gather(shard: torch.Tensor, total: Optional[int] = None
               ) -> torch.Tensor:
    """Every rank's ``shard`` concatenated in rank order (cut to
    ``total`` elements when given)."""
    d = _dist()
    if d is None:
        return shard if total is None else shard[:total]
    w = world()
    out = shard.new_empty(shard.numel() * w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        d.all_gather_into_tensor(out, shard.contiguous())
    return out if total is None else out[:total]


def allreduce(flat: torch.Tensor) -> torch.Tensor:
    """The sum over the group of the 1-D ``flat`` (a new tensor at more
    than one worker; ``flat`` itself at one): :func:`reduce_scatter`,
    then :func:`all_gather`."""
    if _dist() is None:
        return flat
    return all_gather(reduce_scatter(flat), flat.numel())
