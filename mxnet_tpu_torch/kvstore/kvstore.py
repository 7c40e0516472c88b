"""KVStore implementations of the port (counterpart of
``mxnet_tpu/kvstore/kvstore.py``; see the package docstring)."""
from __future__ import annotations

import atexit
import contextlib
import os
import threading
import time
import warnings
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from .. import fault
from .. import optimizer as opt
from .. import telemetry
from ..base import MXNetError
from ..context import Context
from ..fault import _state as _fault_state
from ..ndarray import NDArray
from ..telemetry import _state as _telemetry_state
from . import comm
from .bucketing import bucket_cap_bytes, pack, plan_buckets, unpacker

__all__ = ["BarrierTimeoutError", "KVStore", "KVStoreLocal",
           "KVStoreTPUSync", "create", "dist_initialized"]


def _nd_bytes(v) -> int:
    """Payload size of one NDArray."""
    t = v._data
    return int(t.numel()) * int(t.element_size())


def _payload_bytes(vals) -> int:
    return sum(_nd_bytes(v) for v in vals)


def _put(o: NDArray, t: torch.Tensor) -> None:
    """Write ``t`` into the NDArray ``o`` in place (to its device)."""
    o._assign(t if t.device == o._data.device else t.to(o._data.device))


# ---------------------------------------------------------------------------
# Bounded barriers: a dead worker surfaces as a typed error naming the site
# and the missing ranks, never as an unbounded hang.
# ---------------------------------------------------------------------------

# SPMD-consistent store-creation ordinal (every process creates its stores
# in the same program order): namespaces each store's barrier keys
_STORE_ORDINAL = 0


class BarrierTimeoutError(MXNetError):
    """A kvstore barrier (local drain or cross-process rendezvous) did
    not complete within ``MXNET_KV_BARRIER_TIMEOUT``."""


def _barrier_timeout_s() -> float:
    """Default barrier bound in seconds (``MXNET_KV_BARRIER_TIMEOUT``,
    300); <= 0 disables the bound."""
    try:
        return float(os.environ.get("MXNET_KV_BARRIER_TIMEOUT", "300"))
    except ValueError as e:
        raise MXNetError(
            "MXNET_KV_BARRIER_TIMEOUT="
            f"{os.environ['MXNET_KV_BARRIER_TIMEOUT']!r} is not a "
            "number") from e


def _bootstrap_timeout_s() -> int:
    """The rendezvous bound in seconds: ``MXNET_KV_BOOTSTRAP_TIMEOUT``,
    falling back to the barrier knob; <= 0 maps to ~24 days (the store
    wants a finite bound) and fractions round up."""
    try:
        t = float(os.environ.get(
            "MXNET_KV_BOOTSTRAP_TIMEOUT", "") or _barrier_timeout_s())
    except ValueError as e:
        raise MXNetError(
            "MXNET_KV_BOOTSTRAP_TIMEOUT="
            f"{os.environ['MXNET_KV_BOOTSTRAP_TIMEOUT']!r} is not a "
            "number") from e
    import math

    return 2**31 // 1000 if t <= 0 else max(1, math.ceil(t))


def _bounded_waitall(site: str, timeout: float) -> None:
    """Drain this process's queued device work, bounded: the wait runs on
    a daemon thread joined with ``timeout``; on expiry
    :class:`BarrierTimeoutError` names the site (the wedged work stays
    wedged, but the process regains control)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    if timeout <= 0:
        torch.cuda.synchronize()
        return
    done = threading.Event()
    err: List[BaseException] = []

    def _drain():
        try:
            torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)
        finally:
            done.set()

    threading.Thread(target=_drain, name="mxnet-kv-barrier-wait",
                     daemon=True).start()
    if not done.wait(timeout):
        raise BarrierTimeoutError(
            f"kvstore.barrier[{site}]: local device drain did not "
            f"complete within {timeout:g}s (MXNET_KV_BARRIER_TIMEOUT) — "
            "outstanding device work is wedged (dead collective peer?)")
    if err:
        raise err[0]


# the bootstrap of this process: (rank, workers, rendezvous TCPStore)
_BOOT: Optional[Tuple[int, int, object]] = None


def dist_initialized() -> bool:
    """Whether this process joined a multi-worker job
    (:func:`_maybe_init_distributed` ran with more than one worker)."""
    return _BOOT is not None


def _coord_client():
    """The rendezvous key-value store (a ``torch.distributed.TCPStore``),
    or None in a one-worker process."""
    return None if _BOOT is None else _BOOT[2]


def _present_ranks(client, prefix: str, num_workers: int) -> set:
    return {r for r in range(num_workers)
            if client.check([f"{prefix}/{r}"])}


def _cross_process_barrier(client, site: str, seq: int, rank: int,
                           num_workers: int, timeout: float,
                           poll_interval: float = 0.05,
                           key_ns: str = "",
                           time_fn=time.monotonic,
                           sleep_fn=time.sleep) -> List[int]:
    """Rendezvous ``num_workers`` ranks through the key-value store:
    announce ``.../{site}/{seq}/{rank}``, poll until every rank announced
    or the deadline passes. On expiry :class:`BarrierTimeoutError` names
    the site and the missing ranks. Announcements are idempotent, so a
    retry around it is safe."""
    prefix = f"mxnet_tpu/barrier/{key_ns}{site}/{int(seq)}"
    client.set(f"{prefix}/{int(rank)}", str(int(rank)))   # idempotent
    deadline = time_fn() + timeout
    while True:
        if _fault_state.enabled:
            fault.check("kvstore.barrier", f"{site} seq {seq}")
        present = _present_ranks(client, prefix, num_workers)
        if len(present) >= num_workers:
            return sorted(present)
        if timeout > 0 and time_fn() >= deadline:
            missing = sorted(set(range(num_workers)) - present)
            raise BarrierTimeoutError(
                f"kvstore.barrier[{site}] (seq {seq}) timed out after "
                f"{timeout:g}s: missing ranks {missing} of "
                f"{num_workers} (arrived: {sorted(present)}) — restart "
                "the dead worker (mxnet_tpu_torch.tools.launch "
                "--max-restarts) or tear the job down; "
                "MXNET_KV_BARRIER_TIMEOUT bounds this wait")
        sleep_fn(poll_interval)


def _register_exit_barrier(store: "KVStore") -> None:
    """Run the store's bounded exit barrier at interpreter exit: a
    multi-process job's ranks leave together when they can, and leave
    anyway (with a warning) when a peer is already gone."""
    ref = weakref.ref(store)

    def _hook():
        s = ref()
        if s is not None:
            s._barrier_before_exit()

    atexit.register(_hook)


def create(name="local") -> "KVStore":
    """``mx.kv.create`` (reference ``kvstore.py:254-277``)."""
    name = str(name).lower()
    if name in ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device"):
        return KVStoreLocal(name)
    if name in ("tpu_sync", "nccl", "dist_device_sync", "dist_sync"):
        return KVStoreTPUSync(name)
    if name in ("dist_async",):
        if os.environ.get("MXNET_KVSTORE_DIST_ASYNC_EMU") == "1":
            raise MXNetError(
                "kvstore 'dist_async': the bounded-staleness emulation "
                "(MXNET_KVSTORE_DIST_ASYNC_EMU=1) is not ported yet "
                "(ROADMAP.md, port queue 1, item 9)")
        raise MXNetError(
            "kvstore 'dist_async' (parameter-server async mode) has no "
            "equivalent here; use 'dist_sync' (synchronous allreduce over "
            "torch.distributed) — SURVEY.md §5.8, ADR-002")
    if name in ("horovod", "byteps"):
        raise MXNetError(
            f"kvstore '{name}' plugin is replaced by 'nccl'/'dist_sync'")
    raise MXNetError(f"unknown kvstore type {name!r}")


class KVStore:
    """Base interface (reference: include/mxnet/kvstore.h)."""

    def __init__(self, type_name):
        self._type = type_name
        self._updater = None
        self._optimizer = None
        self._compression = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        """Fused push+pull (reference ``kvstore.py::pushpull``). The
        batched form, ``pushpull(keys, values, outs, priorities)`` with
        parallel lists, coalesces the keys into flat dtype-segregated
        buckets of ``MXNET_KV_BUCKET_MB`` (default 25) MB and exchanges
        each bucket once; keys go in descending priority order, stable
        for ties. The scalar form is a one-key batch."""
        if isinstance(key, (list, tuple)):
            keys = list(key)
            values = list(value)
            if len(values) != len(keys):
                raise MXNetError(
                    f"batched pushpull: {len(keys)} keys but "
                    f"{len(values)} values")
            if out is None:
                outs = values
            else:
                outs = list(out) if isinstance(out, (list, tuple)) \
                    else [out]
                if len(outs) != len(keys):
                    raise MXNetError(
                        f"batched pushpull: {len(keys)} keys but "
                        f"{len(outs)} outs")
            if isinstance(priority, (list, tuple)):
                if len(priority) != len(keys):
                    raise MXNetError(
                        f"batched pushpull: {len(keys)} keys but "
                        f"{len(priority)} priorities")
                priorities = [int(p) for p in priority]
            else:
                priorities = [int(priority)] * len(keys)
            return self._pushpull_batched(keys, values, outs, priorities)
        return self._pushpull_batched(
            [key], [value], [out if out is not None else value],
            [int(priority)])

    def _pushpull_batched(self, keys, values, outs, priorities):
        """Per-key decomposition, in descending priority order: the path
        of a store without buckets and of the server-side optimizer."""
        for i in sorted(range(len(keys)), key=lambda j: -priorities[j]):
            self.push(keys[i], values[i], priorities[i])
            self.pull(keys[i], outs[i], priorities[i])

    def row_sparse_pull(self, key, out, priority=0, row_ids=None):
        if row_ids is None:
            return self.pull(key, out, priority)
        raise MXNetError("row_sparse_pull with row_ids needs RowSparse "
                         "storage, not ported yet (ROADMAP.md, port queue "
                         "1, item 11)")

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit threshold quantization with error feedback on every
        pushed gradient (reference ``kvstore.py:411``)."""
        from .gradient_compression import create_compression

        self._compression = create_compression(compression_params)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on this kvstore")
        from ..checkpoint import atomic_write

        atomic_write(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on this kvstore")
        from ..checkpoint import apply_state_bytes, read_state_bytes

        states = read_state_bytes(fname, "load_optimizer_states")
        store = getattr(self, "_store", None)

        def _apply(blob):
            # the states land on the stored values' context
            ctx = next(iter(store.values())).context if store else None
            with Context(ctx) if ctx is not None else \
                    contextlib.nullcontext():
                self._updater.set_states(blob)

        apply_state_bytes(states, _apply, fname, "load_optimizer_states")

    def barrier(self, site: str = "user", timeout: Optional[float] = None):
        """Synchronization barrier, bounded: drains this process's queued
        device work within ``timeout`` seconds (default
        ``MXNET_KV_BARRIER_TIMEOUT``, 300; <= 0 waits unbounded);
        distributed stores also rendezvous every process. On expiry
        raises :class:`BarrierTimeoutError` naming ``site`` (and, across
        processes, the missing ranks). Fault site ``kvstore.barrier``."""
        timeout = _barrier_timeout_s() if timeout is None \
            else float(timeout)
        if _fault_state.enabled:
            fault.check("kvstore.barrier", site)
        _bounded_waitall(site, timeout)

    def _barrier_before_exit(self) -> bool:
        """Bounded exit barrier (``MXNET_KV_EXIT_BARRIER_TIMEOUT``,
        default 10 s, capped by the main knob): never raises; a timeout
        is a warning and exit proceeds. True when the barrier
        completed."""
        try:
            cap = _barrier_timeout_s()
            timeout = float(os.environ.get(
                "MXNET_KV_EXIT_BARRIER_TIMEOUT", "10"))
            if cap > 0:
                timeout = min(timeout, cap)
        except Exception:  # noqa: BLE001 - runs from atexit: never raise
            timeout = 10.0
        try:
            self.barrier(site="exit", timeout=timeout)
            return True
        except Exception as e:  # noqa: BLE001 - exit path: warn only
            warnings.warn(
                f"kvstore exit barrier abandoned (exit continues): {e}",
                RuntimeWarning, stacklevel=2)
            return False


class KVStoreLocal(KVStore):
    """Aggregation across the device copies of one process (reference:
    ``kvstore_local.h`` + ``comm.h::CommCPU/CommDevice``): the copies are
    summed left to right on the first copy's device
    (:func:`comm.local_sum`); ``local`` and ``device`` are one store."""

    def __init__(self, type_name="local"):
        super().__init__(type_name)
        self._store: Dict = {}
        # fused-pushpull bucket cap (bytes); 0 disables bucketing
        self._bucket_bytes = bucket_cap_bytes()
        self._warned_fallback: set = set()
        # the flat gradient buffers of the bucketed exchange (pack), freed
        # with the store
        self._flats: Dict = {}

    def init(self, key, value):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        key = self._canon(key)
        if isinstance(value, (list, tuple)):
            value = value[0]
        self._store[key] = NDArray(value._data.detach().clone(),
                                   ctx=value.context)

    def _canon(self, key):
        return key if isinstance(key, (int, str)) else int(key)

    def _check_init(self, key):
        if key not in self._store:
            raise MXNetError(f"kvstore key {key!r} was not initialized")

    def push(self, key, value, priority=0):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        _tel = _telemetry_state.enabled
        t0 = time.perf_counter() if _tel else 0.0
        key = self._canon(key)
        self._check_init(key)
        vals = list(value) if isinstance(value, (list, tuple)) else [value]
        if self._compression is not None:
            # before the reduce, outside the retry: the error feedback is
            # state, and a retry must not apply it twice
            vals = [self._compression.compress(key, i, v)
                    for i, v in enumerate(vals)]

        def _reduce():
            if _fault_state.enabled:
                fault.check("kvstore.push", f"key {key!r}")
            return self._aggregate(vals)

        agg = fault.retry_call("kvstore.push", _reduce,
                               detail=f"key {key!r}")
        if self._updater is not None:
            # server-side optimizer (update_on_kvstore=True)
            self._updater(key, agg, self._store[key])
        else:
            self._store_reduced(key, agg)
        if _tel:
            telemetry.record_kv("push", _payload_bytes(vals),
                                time.perf_counter() - t0)
            telemetry.record_kv_collective("per_key")

    def _aggregate(self, vals: List[NDArray]) -> NDArray:
        """Reduce the device copies to one value (subclass hook): summed
        left to right on the first copy's device."""
        if len(vals) == 1:
            return vals[0]
        return NDArray(comm.local_sum([v._data.detach() for v in vals]),
                       ctx=vals[0].context)

    def _store_reduced(self, key, agg: NDArray):
        # a copy: never alias the caller's array, which it may go on
        # writing in place
        dst = self._store[key]
        with torch.no_grad():
            dst._data.copy_(agg._data.to(dst._data.device))

    def pull(self, key, out, priority=0, ignore_sparse=True):
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, o, priority)
            return
        _tel = _telemetry_state.enabled
        t0 = time.perf_counter() if _tel else 0.0
        key = self._canon(key)
        self._check_init(key)
        outs = out if isinstance(out, (list, tuple)) else [out]
        src = self._store[key]

        def _copy_out():
            if _fault_state.enabled:
                fault.check("kvstore.pull", f"key {key!r}")
            for o in outs:
                _put(o, src._data)

        fault.retry_call("kvstore.pull", _copy_out, detail=f"key {key!r}")
        if _tel:
            telemetry.record_kv("pull", _nd_bytes(src) * len(outs),
                                time.perf_counter() - t0)

    # -- bucketed fused pushpull ---------------------------------------
    def _pushpull_batched(self, keys, values, outs, priorities):
        """The fused entry: keys coalesced into dtype-segregated flat
        buckets, each reduced once (``_bucket_reduce``) and scattered back
        into the store entries and the outs. Bucket i+1's reduce is
        issued before bucket i's scatter. Falls back to the per-key
        decomposition under a server-side optimizer or with bucketing
        off (``MXNET_KV_BUCKET_MB=0``)."""
        if self._updater is not None or self._bucket_bytes <= 0:
            return KVStore._pushpull_batched(
                self, keys, values, outs, priorities)
        _tel = _telemetry_state.enabled
        t0 = time.perf_counter() if _tel else 0.0
        order = sorted(range(len(keys)), key=lambda j: -priorities[j])
        entries = []
        vals_by_pos: Dict = {}
        outs_by_pos: Dict = {}
        total_bytes = 0
        for pos in order:
            key = self._canon(keys[pos])
            self._check_init(key)
            vals = list(values[pos]) if isinstance(
                values[pos], (list, tuple)) else [values[pos]]
            outs_i = list(outs[pos]) if isinstance(
                outs[pos], (list, tuple)) else [outs[pos]]
            vals_by_pos[pos] = (key, vals)
            outs_by_pos[pos] = outs_i
            entry = self._bucket_entry(pos, vals)
            entries.append(entry)
            total_bytes += entry[4] * (len(vals) + len(outs_i))
        buckets = plan_buckets(entries, self._bucket_bytes)
        pending = None
        for b in buckets:
            reduced = self._bucket_exchange_reduce(b, vals_by_pos)
            if _tel:
                telemetry.record_kv_bucket(b.nbytes, len(b))
                telemetry.record_kv_collective("bucketed")
            if pending is not None:
                self._bucket_scatter(pending[0], pending[1], vals_by_pos,
                                     outs_by_pos)
            pending = (b, reduced)
        if pending is not None:
            self._bucket_scatter(pending[0], pending[1], vals_by_pos,
                                 outs_by_pos)
        if _tel:
            telemetry.record_kv("pushpull", total_bytes,
                                time.perf_counter() - t0)

    @staticmethod
    def _bucket_entry(pos, vals):
        """Planner entry for one key's payload: members of one bucket
        share dtype, copy count and per-slot context, so each slot packs
        into one flat buffer on one device. (Every payload of the port is
        dense: RowSparse storage is not ported, so no key falls back.)"""
        t = vals[0]._data
        return (pos, tuple(t.shape), t.dtype,
                (t.dtype, len(vals), tuple(v.context for v in vals)),
                t.numel() * t.element_size())

    def plan_pushpull(self, keys, values, priorities=None, outs=None):
        """Dry run of ``_pushpull_batched``'s bucket plan: the key groups
        a batched call with these arguments would coalesce, as lists of
        positions into ``keys``, in dispatch (descending-priority) order.
        The overlapped-comms Trainer dispatches each group as its own
        ``pushpull`` once its members' gradients are written; a group
        planned alone forms exactly the batched call's bucket, so the
        overlapped exchange is bit-identical to the batched one. With a
        server-side optimizer or bucketing off, every key is its own
        group. ``outs`` is the reference's argument: every payload of the
        port is dense, so the outs change no group."""
        n = len(keys)
        priorities = [0] * n if priorities is None else \
            [int(p) for p in priorities]
        order = sorted(range(n), key=lambda j: -priorities[j])
        if self._updater is not None or self._bucket_bytes <= 0:
            return [[pos] for pos in order]
        entries = []
        for pos in order:
            vals = list(values[pos]) if isinstance(
                values[pos], (list, tuple)) else [values[pos]]
            entries.append(self._bucket_entry(pos, vals))
        return [list(b.indices)
                for b in plan_buckets(entries, self._bucket_bytes)]

    def _bucket_exchange_reduce(self, bucket, vals_by_pos):
        """Pack each slot's member gradients into one flat buffer (kept
        per bucket and slot), quantize it when a compressor is set, and
        reduce the slots. Returns the reduced flat tensor and the packed
        buffers."""
        nslots = bucket.group[1]
        bkey = tuple(vals_by_pos[pos][0] for pos in bucket.indices)
        flats, packed = [], []
        for s in range(nslots):
            flat = pack([vals_by_pos[pos][1][s]._data.detach()
                         for pos in bucket.indices],
                        self._flats, slot=(bkey, s))
            packed.append(flat)
            if self._compression is not None:
                # one quantizer launch per bucket and slot, outside the
                # retry below (the error feedback is state)
                flat = self._compression.compress_flat(bkey, s, flat)
            flats.append(flat)

        def _reduce():
            if _fault_state.enabled:
                fault.check("kvstore.push",
                            f"bucket[{len(bucket)} keys]")
            return self._bucket_reduce(flats)

        return fault.retry_call("kvstore.push", _reduce,
                                detail=f"bucket[{len(bucket)} keys]"), packed

    def _bucket_reduce(self, flats):
        """Reduce the per-slot flat buffers to one (subclass hook): the
        flat-buffer twin of ``_aggregate``, the same sum per element."""
        return comm.local_sum(flats)

    def _bucket_scatter(self, bucket, reduced, vals_by_pos, outs_by_pos):
        """Unpack the reduced flat buffer into the store entries (views of
        it) and copy it into every out, all outs of a device in one
        multi-tensor copy. An out that is the very array a slot packed,
        when the reduced buffer is that slot's pack (one copy, nothing
        summed or quantized), already holds its value and is skipped."""
        reduced, packed = reduced
        unpack = unpacker(bucket.shapes)
        pieces_by_dev: Dict = {}

        def pieces_for(dev):
            p = pieces_by_dev.get(dev)
            if p is None:
                p = pieces_by_dev[dev] = unpack(
                    reduced if reduced.device == dev else reduced.to(dev))
            return p

        def _copy_out():
            if _fault_state.enabled:
                fault.check("kvstore.pull",
                            f"bucket[{len(bucket)} keys]")
            dsts, srcs, written = {}, {}, []
            for j, pos in enumerate(bucket.indices):
                key, vals = vals_by_pos[pos]
                dst = self._store[key]      # the store's own array: rebind
                dst._tensor = pieces_for(dst._tensor.device)[j]
                for s, o in enumerate(outs_by_pos[pos]):
                    if s < len(vals) and o is vals[s] \
                            and reduced is packed[s]:
                        continue
                    t = o._prepare_write()
                    written.append(o)
                    dsts.setdefault(t.device, []).append(t)
                    srcs.setdefault(t.device, []).append(
                        pieces_for(t.device)[j])
            with torch.no_grad():
                for dev, ts in dsts.items():
                    torch._foreach_copy_(ts, srcs[dev])
            for o in written:
                o._wrote()

        fault.retry_call("kvstore.pull", _copy_out,
                         detail=f"bucket[{len(bucket)} keys]")


class KVStoreTPUSync(KVStoreLocal):
    """Collective data-parallel sync over ``torch.distributed``
    (reference ``KVStoreTPUSync``, ``kvstore.py:863``; the name kept so
    scripts and tests find it), under the type names ``tpu_sync``,
    ``nccl``, ``dist_sync`` and ``dist_device_sync``.

    A push sums this process's copies left to right, then the processes
    in rank order (:mod:`~mxnet_tpu_torch.kvstore.comm`: reduce-scatter
    over ``all_to_all_single``, then all-gather), one collective per key
    or per bucket. ``dist_sync``/``dist_device_sync`` bootstrap from the
    ``DMLC_*`` variables the launcher exports (``tools/launch.py``): a
    rendezvous ``TCPStore`` at ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``
    that also carries the bounded barriers, and a process group made at
    the store's first ``init``: NCCL when its tensors are on a card, gloo
    on the CPU. At one worker there is no group and a push is the local
    sum, as in the reference.
    """

    def __init__(self, type_name="tpu_sync"):
        super().__init__(type_name)
        if type_name in ("dist_sync", "dist_device_sync"):
            _maybe_init_distributed()
            if dist_initialized():
                _register_exit_barrier(self)
        global _STORE_ORDINAL
        _STORE_ORDINAL += 1
        self._barrier_ns = _STORE_ORDINAL
        self._barrier_seq: Dict[str, int] = {}

    def init(self, key, value):
        first = value[0] if isinstance(value, (list, tuple)) else value
        if isinstance(key, (list, tuple)):
            first = first[0] if isinstance(first, (list, tuple)) else first
        _ensure_group(first._data.device)
        super().init(key, value)

    @property
    def num_workers(self):
        """The processes of the job (of the process group, where the
        caller made one itself)."""
        return _BOOT[1] if _BOOT is not None else comm.world()

    @property
    def rank(self):
        return _BOOT[0] if _BOOT is not None else comm.rank()

    def _next_barrier_seq(self, site: str) -> Tuple[int, str]:
        seq = self._barrier_seq.get(site, 0) + 1
        self._barrier_seq[site] = seq
        return seq, f"s{self._barrier_ns}/"

    def barrier(self, site: str = "user", timeout: Optional[float] = None):
        """Local drain and cross-process rendezvous, both within one
        bound; the rendezvous rides the bootstrap's key-value store, so a
        timeout names the ranks that never arrived (per-site sequence
        numbers keep repeated barriers apart under the SPMD contract that
        every process calls them in the same order)."""
        timeout = _barrier_timeout_s() if timeout is None \
            else float(timeout)
        t0 = time.monotonic()
        super().barrier(site, timeout)
        client = _coord_client()
        if client is None or self.num_workers <= 1:
            return
        remaining = timeout if timeout <= 0 else \
            max(0.05, timeout - (time.monotonic() - t0))
        seq, key_ns = self._next_barrier_seq(site)
        fault.retry_call(
            "kvstore.barrier",
            lambda: _cross_process_barrier(
                client, site, seq, self.rank, self.num_workers,
                remaining, key_ns=key_ns),
            detail=f"site {site!r} seq {seq}")

    # -- the collective ------------------------------------------------
    def _needs_collective(self) -> bool:
        """Whether a reduce crosses processes. One gate for the per-key
        (``_aggregate``) and bucketed (``_bucket_reduce``) paths, so that
        the two never reduce by different mechanisms."""
        return comm._dist() is not None

    def _collective_sum(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """This process's copies summed, then the processes, over a flat
        view; one collective, inside the bounded retry at
        ``kvstore.allreduce``."""
        local = comm.local_sum(tensors)
        shape = local.shape

        def _reduce():
            if _fault_state.enabled:
                fault.check("kvstore.allreduce",
                            f"{tuple(shape)} x {len(tensors)} copies")
            return comm.allreduce(local.reshape(-1)).view(shape)

        if not _telemetry_state.enabled:
            return fault.retry_call("kvstore.allreduce", _reduce)
        t0 = time.perf_counter()
        out = fault.retry_call("kvstore.allreduce", _reduce)
        telemetry.record_kv(
            "allreduce", local.numel() * local.element_size()
            * comm.world(), time.perf_counter() - t0)
        return out

    def _aggregate(self, vals: List[NDArray]) -> NDArray:
        if self._needs_collective():
            return NDArray(self._collective_sum(
                [v._data.detach() for v in vals]), ctx=vals[0].context)
        return super()._aggregate(vals)

    def _bucket_reduce(self, flats):
        if not self._needs_collective():
            return super()._bucket_reduce(flats)
        return self._collective_sum(flats)


def _ensure_group(device: torch.device) -> None:
    """Make the process group of a bootstrapped multi-worker job at first
    use: NCCL for tensors on a card, gloo on the CPU, over the
    bootstrap's store. Nothing at one worker or when a group exists."""
    if _BOOT is None:
        return
    import datetime

    import torch.distributed as dist

    if dist.is_initialized():
        return
    rank, n, store = _BOOT
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.PrefixStore("mxnet_pg", store), rank=rank,
        world_size=n,
        timeout=datetime.timedelta(seconds=_bootstrap_timeout_s()))


def _maybe_init_distributed():
    """Join the multi-worker job the ``DMLC_*`` variables describe
    (reference ``kvstore.py:1425-1463``): ``DMLC_PS_ROOT_URI`` /
    ``DMLC_PS_ROOT_PORT`` (the rendezvous address; rank 0 serves it),
    ``DMLC_NUM_WORKER`` and ``DMLC_WORKER_ID``. Bounded by
    ``MXNET_KV_BOOTSTRAP_TIMEOUT``: a worker that never comes up raises
    :class:`MXNetError` naming the site. Nothing at one worker or when
    this process already joined."""
    global _BOOT
    uri = os.environ.get("DMLC_PS_ROOT_URI")
    n = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    if not uri or n <= 1 or _BOOT is not None:
        return
    import datetime

    import torch.distributed as dist

    port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
    rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
    timeout_s = _bootstrap_timeout_s()
    try:
        store = dist.TCPStore(
            uri, port, n, is_master=(rank == 0),
            timeout=datetime.timedelta(seconds=timeout_s),
            wait_for_workers=True)
    except Exception as e:
        raise MXNetError(
            f"kvstore.bootstrap: rendezvous at {uri}:{port} failed for "
            f"rank {rank}/{n} within {timeout_s}s: {e} — check that all "
            f"{n} workers launched (mxnet_tpu_torch.tools.launch "
            "supervises and restarts them) and that the address is "
            "reachable") from e
    _BOOT = (rank, n, store)
