"""Gradient bucketing for the kvstore's fused ``pushpull`` (counterpart
of ``mxnet_tpu/kvstore/bucketing.py``).

The planner is the reference's, copied: :func:`plan_buckets` partitions
keys, in the priority order they arrive in, into dtype-segregated
buckets capped at ``MXNET_KV_BUCKET_MB`` (default 25) payload bytes, a
key larger than the cap alone in a bucket of its own, and ``0`` turning
bucketing off (every key exchanged on its own). Under
``partition="zero1"|"zero2"`` each bucket gets a :class:`ShardPlan`: its
flat buffer, zero-padded to a multiple of ``world``, carved into
``world`` equal contiguous per-rank shards.

:func:`pack` writes a bucket's members into one flat buffer, kept per
bucket signature (the member shapes, dtype, device and the caller's
slot) and reused step after step; :func:`unpacker` hands back the
members as views of a flat buffer. Packing is a copy and unpacking a
view, so the bucketed exchange sums each element exactly as the per-key
one does (``comm.py`` fixes that order), bit for bit.
"""
from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["Bucket", "PARTITION_MODES", "ShardPlan", "bucket_cap_bytes",
           "pack", "plan_buckets", "shard_layout", "unpacker"]

DEFAULT_BUCKET_MB = 25.0  # PyTorch DDP's default gradient-bucket size

# the ZeRO stages the planner knows how to lay out: "zero1" shards
# optimizer state only (full gradients still materialize on every
# rank), "zero2" also leaves gradients reduce-scattered (each rank
# keeps only its reduced shard)
PARTITION_MODES = ("zero1", "zero2")


class ShardPlan(NamedTuple):
    """Per-rank carve of one flat bucket under ZeRO partitioning.

    ``total``: unpadded flat element count; ``padded``: total rounded up
    to a multiple of ``world`` (the tail is zero-filled — zeros are
    inert through sum-reduction and are dropped before scatter);
    ``shard_len``: ``padded // world`` elements owned per rank.
    """

    mode: str
    world: int
    total: int
    padded: int
    shard_len: int

    def shard_range(self, rank: int) -> Tuple[int, int]:
        """[start, stop) of ``rank``'s shard in the padded flat buffer."""
        if not (0 <= rank < self.world):
            raise ValueError(
                f"rank {rank} outside partition world {self.world}")
        return rank * self.shard_len, (rank + 1) * self.shard_len


def shard_layout(mode: str, total: int, world: int) -> ShardPlan:
    """The :class:`ShardPlan` for a flat buffer of ``total`` elements
    partitioned across ``world`` ranks."""
    if mode not in PARTITION_MODES:
        raise ValueError(
            f"unknown partition mode {mode!r}; expected one of "
            f"{PARTITION_MODES}")
    world = int(world)
    if world < 1:
        raise ValueError(f"partition world must be >= 1, got {world}")
    shard_len = -(-int(total) // world)          # ceil div
    return ShardPlan(mode, world, int(total), shard_len * world,
                     shard_len)


def bucket_cap_bytes() -> int:
    """Resolve ``MXNET_KV_BUCKET_MB`` (float MB; 0 disables bucketing)."""
    mb = float(os.environ.get("MXNET_KV_BUCKET_MB", str(DEFAULT_BUCKET_MB)))
    return int(mb * (1 << 20))


class Bucket:
    """One planned bucket: member positions (indices into the caller's
    key list), their shapes, and the flat-buffer layout."""

    __slots__ = ("indices", "shapes", "dtype", "nbytes", "group",
                 "shard_plan")

    def __init__(self, dtype, group):
        self.indices: List[int] = []
        self.shapes: List[Tuple[int, ...]] = []
        self.dtype = dtype
        self.group = group          # (dtype_str, nslots, slot device sig)
        self.nbytes = 0
        self.shard_plan: Optional[ShardPlan] = None   # set by partition=

    def elements(self) -> int:
        n = 0
        for s in self.shapes:
            m = 1
            for d in s:
                m *= int(d)
            n += m
        return n

    def add(self, index: int, shape: Tuple[int, ...],
            nbytes: int) -> None:
        self.indices.append(index)
        self.shapes.append(tuple(shape))
        self.nbytes += int(nbytes)

    def __len__(self):
        return len(self.indices)

    def __repr__(self):
        return (f"Bucket(keys={len(self.indices)}, dtype={self.dtype}, "
                f"bytes={self.nbytes})")


def plan_buckets(entries: Sequence[Tuple[int, Tuple[int, ...], object,
                                         object, int]],
                 cap_bytes: int,
                 partition: Optional[str] = None,
                 world: int = 1) -> List[Bucket]:
    """Partition ``entries`` into buckets, preserving the given order.

    ``entries``: ``(index, shape, dtype, group, nbytes)`` tuples in
    dispatch (priority) order. ``group`` segregates members that cannot
    share a flat buffer — different dtypes, different device-copy counts
    or placements. Greedy: an entry joins the open bucket of its group
    unless that would exceed ``cap_bytes``; an entry alone larger than
    the cap still gets (and fills) its own bucket.

    ``partition``: when ``"zero1"`` / ``"zero2"``, every planned bucket
    additionally gets a :class:`ShardPlan` carving its flat buffer into
    ``world`` per-rank shards (the reduce-scatter / shard-update /
    allgather layout the ZeRO engine dispatches on).
    """
    if partition is not None and partition not in PARTITION_MODES:
        raise ValueError(
            f"unknown partition mode {partition!r}; expected one of "
            f"{PARTITION_MODES}")
    buckets: List[Bucket] = []
    open_by_group: Dict[object, Bucket] = {}
    for index, shape, dtype, group, nbytes in entries:
        b = open_by_group.get(group)
        if b is None or (len(b) > 0 and b.nbytes + nbytes > cap_bytes):
            b = Bucket(dtype, group)
            buckets.append(b)
            open_by_group[group] = b
        b.add(index, shape, nbytes)
    if partition is not None:
        for b in buckets:
            b.shard_plan = shard_layout(partition, b.elements(), world)
    return buckets


# --------------------------------------------------------------------------
# pack / unpack
# --------------------------------------------------------------------------

def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def pack(tensors: Sequence[torch.Tensor], buffers: Optional[dict] = None,
         slot=0) -> torch.Tensor:
    """Flatten and concatenate a bucket's members into one flat buffer
    (one ``cat`` into it).

    With ``buffers`` (a dict the caller owns, such as a store's), the
    buffer is kept there per signature (the members' shapes, their dtype
    and device, and ``slot``, which tells apart two packs of one bucket
    that must both stay alive, such as the copies of several contexts)
    and written in place on every later call with that signature; it is
    freed with its owner. A signature that differs in anything gets a
    buffer of its own, so a buffer never carries one layout's bytes into
    another. Without ``buffers`` every call makes a new one. All members
    share one dtype and one device (the planner's ``group`` sees to
    it)."""
    t0 = tensors[0]
    buf = None
    if buffers is not None:
        sig = (tuple(tuple(t.shape) for t in tensors), t0.dtype, t0.device,
               slot)
        buf = buffers.get(sig)
    if buf is None:
        buf = torch.empty(sum(t.numel() for t in tensors), dtype=t0.dtype,
                          device=t0.device)
        if buffers is not None:
            buffers[sig] = buf
    with torch.no_grad():
        torch.cat([t.reshape(-1) for t in tensors], out=buf)
    return buf


_UNPACKERS: Dict[Tuple, object] = {}


def unpacker(shapes: Sequence[Tuple[int, ...]]):
    """The inverse of :func:`pack` for a bucket signature: flat buffer ->
    tuple of member views of it (no copy). Cached per shapes tuple."""
    sig = tuple(tuple(s) for s in shapes)
    fn = _UNPACKERS.get(sig)
    if fn is None:
        offsets = []
        off = 0
        for s in sig:
            n = _numel(s)
            offsets.append((off, n, s))
            off += n

        def unpack(flat):
            return tuple(flat[o:o + n].view(s) for o, n, s in offsets)

        fn = unpack
        _UNPACKERS[sig] = fn
    return fn
