"""``DeviceFeedIter`` — the host-to-card input feed (counterpart of
``mxnet_tpu/io/device_feed.py``).

A producer thread takes each host batch, pins it (page-locked memory,
``mx.cpu_pinned()``) and copies it to the card on a copy stream of its
own, ``depth`` batches ahead of the consumer, so the copy of the next
batch overlaps the step on the current one:

    step = mx.parallel.TrainStep(net, loss, "sgd", ...)
    feed = mx.io.DeviceFeedIter(train_iter, step=step, depth=2)
    for batch in feed:
        loss, _ = step(batch.data[0], batch.label[0])

The producer records an event after each batch's copies (and after
``device_transform``, which runs on the copy stream over the staged
tensors: e.g. a uint8 batch normalised and cast to bf16 on the card, so
the copy carries a quarter of the bytes). ``next()`` makes the
consumer's current stream wait on that event before the step can read
the batch, and marks each staged tensor with ``record_stream`` so the
caching allocator does not hand its memory to the copy stream again
while the consumer's work on it is queued. (The reference instead
``jax.device_put``s with the step's input sharding and lets XLA order
the transfer.)

Placement: ``step=`` a ``TrainStep`` (its parameters' device), or
``shardings=`` one device or a list of them, one per batch array (a
``Context``, a ``torch.device`` or a device string); a mesh or a
sharding over several devices is not ported (ROADMAP.md, port queue 1,
item 11).

Telemetry (``MXNET_TELEMETRY=1``): ``mxnet_data_wait_seconds{stage}``
(the consumer's blocked time: the host-starved vs card-starved
discriminator), ``mxnet_data_queue_depth{stage}``. Fault site
``datafeed.put`` fires inside the producer; any producer failure
surfaces at ``next()`` as an ``MXNetError`` naming the stage, never a
hang on an empty queue (``io.io._AsyncStage``).
"""
from __future__ import annotations

import contextlib

import numpy as _np
import torch

from .. import fault
from ..base import MXNetError, torch_dtype
from ..context import Context, cpu_pinned, gpu, resolve_device
from ..ndarray import NDArray
from .io import DataBatch, _AsyncStage

__all__ = ["DeviceFeedIter", "stage_on_device", "make_normalize_transform"]


def make_normalize_transform(mean, std, dtype="bfloat16"):
    """The uint8-wire ``device_transform``: per-channel ``(x - mean) /
    std`` in f32 over NCHW's channel axis 1, rounded once to ``dtype``;
    labels pass through. ``mean``/``std`` are per-channel sequences (the
    ImageNet constants the C++ iterator took as ``mean_r/g/b`` and
    ``std_r/g/b``). The division is a product with std's f32 reciprocal,
    as XLA compiles the reference's division by a constant, so the two
    agree bit for bit."""
    mean = _np.asarray(mean, _np.float32).reshape(1, -1, 1, 1)
    inv = (_np.float32(1.0) / _np.asarray(std, _np.float32)).astype(
        _np.float32).reshape(1, -1, 1, 1)
    out_dtype = torch_dtype(dtype)
    consts = {}

    def transform(x, *labels):
        c = consts.get(x.device)
        if c is None:
            # made once per device, outside any timed or captured region
            c = consts[x.device] = (torch.from_numpy(mean).to(x.device),
                                    torch.from_numpy(inv).to(x.device))
        xb = ((x.float() - c[0]) * c[1]).to(out_dtype)
        return (xb,) + labels

    return transform


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: a host tensor is pinned first, so the copy runs
    asynchronously on the current stream."""
    if t.device == dev:
        return t
    if dev.type == "cuda" and t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def stage_on_device(batch, device_id=0, device=None):
    """Pin a host batch (NDArrays, nested lists) and start its copy to
    card ``device_id`` (or ``device``) on the current stream: the
    ``DataLoader(pin_memory=True)`` path. The returned NDArrays carry the
    ``cpu_pinned`` context, as the reference's (a staged batch keeps the
    label of its pinned host buffer); ``as_in_context(mx.gpu())`` then
    moves the label without another copy."""
    dev = resolve_device(gpu(device_id) if device is None else device)

    def go(b):
        if isinstance(b, (list, tuple)):
            return [go(x) for x in b]
        if isinstance(b, NDArray):
            return NDArray(_to_device(b._data, dev), ctx=cpu_pinned())
        return b

    return go(batch)


def _device_of(x) -> torch.device:
    if isinstance(x, (Context, torch.device, str)):
        return resolve_device(x)
    raise MXNetError(
        f"DeviceFeedIter: {type(x).__name__} is not a device; a mesh or a "
        "sharding over several devices is not ported yet (ROADMAP.md, port "
        "queue 1, item 11)")


class DeviceFeedIter(_AsyncStage):
    """Asynchronously stage batches from ``data_iter`` onto the card.

    Parameters
    ----------
    data_iter : DataIter, DataLoader or any iterable of batches. A batch
        may be a ``DataBatch`` (data+label lists) or a flat list/tuple of
        NDArrays (DataLoader's shape); the staged batch keeps the form.
    step : a ``TrainStep``: its parameters' device. Exactly one of
        ``step``/``shardings`` is required.
    shardings : one device for every batch array, or a sequence of them,
        one per array.
    depth : producer queue depth (batches staged ahead), default 2 —
        the classic double buffer.
    device_transform : optional function over the staged tensors, run on
        the copy stream (same arity in and out); e.g. uint8 → bf16
        normalize (:func:`make_normalize_transform`).
    name : stage label for telemetry, fault and error messages.
    """

    def __init__(self, data_iter, step=None, shardings=None, depth=2,
                 device_transform=None, name="device_feed"):
        self._source = data_iter
        if (step is None) == (shardings is None):
            raise MXNetError(
                "DeviceFeedIter needs exactly one of step= (a TrainStep "
                "whose device to feed) or shardings=")
        if step is not None:
            if not isinstance(getattr(step, "_device", None), torch.device):
                raise MXNetError(f"DeviceFeedIter: step= takes a TrainStep, "
                                 f"not {type(step).__name__}")
            self._devices = step._device
        elif isinstance(shardings, (list, tuple)):
            self._devices = [_device_of(s) for s in shardings]
        else:
            self._devices = _device_of(shardings)
        self._device_transform = device_transform
        self._streams = {}
        self.name = name
        self._stage_name = name
        super().__init__(getattr(data_iter, "batch_size", 0), depth=depth,
                         thread_name=f"mxnet-{name}")
        self._start()

    # -- provide_* proxy (the host side's descriptors: a transform may
    # change the dtypes, as the reference's prefetcher)
    @property
    def provide_data(self):
        return getattr(self._source, "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self._source, "provide_label", None)

    # -- _AsyncStage surface -------------------------------------------
    def _source_obj(self):
        return self._source

    def _on_start(self):
        self._iter = iter(self._source)

    def _produce(self):
        return self._stage(next(self._iter))

    def _raise_failure(self):
        raise MXNetError(
            f"input pipeline stage '{self.name}' failed at datafeed.put "
            f"(producer thread died): {self._failure!r}") \
            from self._failure

    # -- staging (the producer thread) ---------------------------------
    def _targets(self, n):
        if isinstance(self._devices, torch.device):
            return [self._devices] * n
        if len(self._devices) != n:
            raise MXNetError(f"DeviceFeedIter({self.name}): "
                             f"{len(self._devices)} devices for {n} batch "
                             "arrays")
        return self._devices

    def _copy_stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _stage(self, batch):
        """Copy every array of one batch to its device on the copy
        stream, apply the transform there, and record the event the
        consumer waits on. Returns ``(batch, events, tensors)``."""
        if fault._state.enabled:
            fault.check("datafeed.put", detail=self.name)
        if isinstance(batch, DataBatch):
            data = list(batch.data or [])
            label = list(batch.label or [])
        elif isinstance(batch, (list, tuple)):
            data, label = list(batch), []
        else:
            data, label = [batch], []
        arrs = data + label
        vals = [a._data if isinstance(a, NDArray) else torch.as_tensor(a)
                for a in arrs]
        devs = self._targets(len(vals))
        cards = sorted({d for d in devs if d.type == "cuda"}, key=str)
        first = self._copy_stream(cards[0]) if cards else None
        events = []
        with torch.cuda.stream(first) if first is not None \
                else contextlib.nullcontext():
            put = [None] * len(vals)
            for dev in cards[1:]:
                with torch.cuda.stream(self._copy_stream(dev)):
                    for i, (v, d) in enumerate(zip(vals, devs)):
                        if d == dev:
                            put[i] = _to_device(v, d)
                    ev = torch.cuda.Event()
                    ev.record()
                first.wait_event(ev)
            for i, (v, d) in enumerate(zip(vals, devs)):
                if put[i] is None:
                    put[i] = _to_device(v, d)
            if self._device_transform is not None:
                out = self._device_transform(*put)
                if not isinstance(out, (list, tuple)):
                    out = [out]
                if len(out) != len(put):
                    raise MXNetError(
                        f"DeviceFeedIter({self.name}): device_transform "
                        f"must keep arity ({len(put)} in, {len(out)} out)")
                put = list(out)
            if first is not None:
                ev = torch.cuda.Event()
                ev.record(first)
                events = [(dev, ev) for dev in cards]
        nds = [NDArray(v, ctx=Context.from_device(v.device)) for v in put]
        if isinstance(batch, DataBatch):
            staged = DataBatch(data=nds[:len(data)], label=nds[len(data):],
                               pad=batch.pad, index=batch.index,
                               provide_data=batch.provide_data,
                               provide_label=batch.provide_label)
        elif isinstance(batch, (list, tuple)):
            staged = nds
        else:
            staged = nds[0]
        return staged, events, [v for v in put if v.is_cuda]

    # -- the consumer --------------------------------------------------
    def iter_next(self):
        if not super().iter_next():
            return False
        staged, events, tensors = self._current
        for dev, ev in events:
            torch.cuda.current_stream(dev).wait_event(ev)
        for t in tensors:
            t.record_stream(torch.cuda.current_stream(t.device))
        self._current = staged
        return True

    # -- batch accessors -----------------------------------------------
    def getdata(self):
        b = self._current
        return b.data if isinstance(b, DataBatch) else b

    def getlabel(self):
        b = self._current
        return b.label if isinstance(b, DataBatch) else None

    def getpad(self):
        b = self._current
        return (b.pad or 0) if isinstance(b, DataBatch) else 0
