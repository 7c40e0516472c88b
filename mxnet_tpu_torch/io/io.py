"""DataIter implementations (counterpart of ``mxnet_tpu/io/io.py``;
reference python/mxnet/io/io.py). Iterators produce host batches: CPU
NDArrays, which ``io.DeviceFeedIter`` stages onto the card ahead of the
step, or the consumer moves with ``as_in_context``."""
from __future__ import annotations

import threading
import time
import queue as _queue
from collections import namedtuple

import numpy as _np

from .. import telemetry
from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray, array as nd_array
from ..telemetry import _state as _telemetry_state

__all__ = ["ImageRecordIter", "LibSVMIter",
           "DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter"]


def _host(arr):
    return nd_array(arr, ctx=cpu())


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """reference: io.py::DataDesc."""

    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), _np.dtype(dtype),
                               layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """reference: io.py::DataBatch."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        shapes = [d.shape for d in (self.data or [])]
        return f"DataBatch: data shapes: {shapes}"


class DataIter:
    """reference: io.py::DataIter — the iterator protocol Module.fit
    consumes (reset/next/iter_next/getdata/getlabel/getpad)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise MXNetError("data must be provided")
        return []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        out = [(f"{default_name}" if i == 0 else f"_{i}_{default_name}", d)
               for i, d in enumerate(data)]
    elif isinstance(data, dict):
        out = list(data.items())
    else:
        raise MXNetError(f"unsupported data type {type(data)}")
    return [(k, v if isinstance(v, _np.ndarray) else v.asnumpy())
            for k, v in out]


class NDArrayIter(DataIter):
    """reference: io.py::NDArrayIter — in-memory batch iterator with
    shuffle + last-batch padding/rollover."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._order = _np.arange(self.num_data)
        if shuffle:
            _np.random.shuffle(self._order)
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = -(-self.num_data // batch_size)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:],
                         v.dtype) for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            _np.random.shuffle(self._order)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        out = []
        for _, v in arrays:
            idx = self._order[self.cursor:self.cursor + self.batch_size]
            chunk = v[idx]
            if chunk.shape[0] < self.batch_size:
                # pad by wrapping (reference: last_batch_handle='pad')
                extra = self._order[: self.batch_size - chunk.shape[0]]
                chunk = _np.concatenate([chunk, v[extra]], axis=0)
            out.append(_host(chunk))
        return out

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def getindex(self):
        return self._order[self.cursor:self.cursor + self.batch_size]


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches
    (reference: io.py::ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad or 0


class _WorkerFailure:
    """Queue sentinel: the producer thread died on ``exc``."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _AsyncStage(DataIter):
    """Producer-thread machinery shared by the async pipeline stages
    (``PrefetchingIter``, ``io.DeviceFeedIter``): a daemon thread fills
    a bounded queue from :meth:`_produce`; the consumer pops.

    The lifecycle contract, implemented once here:

    * post-exhaustion ``next()`` raises ``StopIteration`` immediately
      (the worker is gone — blocking on its queue would hang forever);
    * a producer crash surfaces at ``next()`` as ``MXNetError``, never a
      hang, and stays sticky;
    * ``reset()`` restarts; ``close()`` is idempotent, joins the worker,
      closes the wrapped source, and makes further ``next()`` an error;
    * every worker generation binds its own ``(queue, stop)`` pair,
      and ``_shutdown_worker`` replaces BOTH unconditionally — an
      in-flight put that slipped past the drain, or a join-timeout
      zombie, writes into the orphaned queue, never the successor's.

    Subclasses implement ``_produce()`` (one item or StopIteration),
    ``_source_obj()`` (the wrapped iterator, for reset/close chaining),
    optionally ``_on_start()`` (rebind the source iterator) and set
    ``_stage_name`` (telemetry label).
    """

    _stage_name = "async_stage"

    def __init__(self, batch_size=0, depth=2, thread_name="mxnet-stage"):
        super().__init__(batch_size)
        self._depth = max(1, int(depth))
        self._thread_name = thread_name
        self._queue: _queue.Queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._thread = None
        self._current = None
        self._exhausted = False
        self._failure = None
        self._closed = False

    # -- subclass surface ----------------------------------------------
    def _produce(self):
        """Produce one staged item; raise StopIteration when drained."""
        raise NotImplementedError

    def _source_obj(self):
        """The wrapped iterator (reset()/close() chain to it)."""
        raise NotImplementedError

    def _on_start(self):
        """Hook run before each worker generation starts."""

    def _raise_failure(self):
        raise MXNetError(
            f"{type(self).__name__} worker thread died: "
            f"{self._failure!r}") from self._failure

    # -- producer ------------------------------------------------------
    @staticmethod
    def _stop_aware_put(q, stop, item) -> bool:
        """Bounded put that never blocks forever on a full queue whose
        consumer has gone away (close/reset drains concurrently)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _worker(self, q, stop):
        try:
            while not stop.is_set():
                try:
                    item = self._produce()
                except StopIteration:
                    self._stop_aware_put(q, stop, None)
                    return
                if not self._stop_aware_put(q, stop, item):
                    return
                if _telemetry_state.enabled:
                    telemetry.set_data_queue_depth(self._stage_name,
                                                   q.qsize())
        except BaseException as e:  # noqa: BLE001 - delivered to consumer
            # a dead producer must surface as an error at the consumer,
            # not as a next() that blocks on an empty queue forever
            self._stop_aware_put(q, stop, _WorkerFailure(e))

    def _start(self):
        self._on_start()
        self._thread = threading.Thread(
            target=self._worker, args=(self._queue, self._stop),
            daemon=True, name=self._thread_name)
        self._thread.start()

    def _shutdown_worker(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except _queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # fresh generation objects UNCONDITIONALLY: a put in flight
        # during the drain (or a zombie that outlived the join timeout)
        # lands in the orphaned queue, so no stale batch or None
        # sentinel can leak into the successor epoch
        self._queue = _queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()

    # -- consumer / lifecycle ------------------------------------------
    def reset(self):
        if self._closed:
            raise MXNetError(f"{type(self).__name__} is closed")
        self._shutdown_worker()
        inner_reset = getattr(self._source_obj(), "reset", None)
        if inner_reset is not None:
            inner_reset()
        self._exhausted = False
        self._failure = None
        self._start()

    def close(self):
        """Stop + join the worker and close the wrapped source
        (idempotent; also runs on GC)."""
        if self._closed:
            return
        self._closed = True
        self._shutdown_worker()
        inner_close = getattr(self._source_obj(), "close", None)
        if inner_close is not None:
            inner_close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def iter_next(self):
        if self._closed:
            raise MXNetError(
                f"{type(self).__name__} is closed; next() after close() "
                "would block on the dead worker's queue")
        if self._failure is not None:
            self._raise_failure()
        if self._exhausted:
            return False
        t0 = time.perf_counter()
        item = self._queue.get()
        if _telemetry_state.enabled:
            telemetry.record_data_wait(time.perf_counter() - t0,
                                       self._stage_name)
            telemetry.set_data_queue_depth(self._stage_name,
                                           self._queue.qsize())
        if item is None:
            self._exhausted = True
            return False
        if isinstance(item, _WorkerFailure):
            self._failure = item.exc
            self._raise_failure()
        self._current = item
        return True

    def next(self):
        if self.iter_next():
            return self._current
        raise StopIteration


class PrefetchingIter(_AsyncStage):
    """Threaded prefetch over one or more iters
    (reference: io.py::PrefetchingIter; the C++ analogue is
    src/io/iter_prefetcher.h). Host-side pipelining: the next batch is
    prepared while the device crunches the current one. Lifecycle per
    :class:`_AsyncStage` (shared with ``io.DeviceFeedIter``)."""

    _stage_name = "prefetch"

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter: composite mode not supported; "
                             "pass one iterator")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size, depth=prefetch_depth,
                         thread_name="mxnet-prefetch")
        self._start()

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def _source_obj(self):
        return self.iter

    def _produce(self):
        return self.iter.next()

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad or 0


class CSVIter(NDArrayIter):
    """reference: src/io/iter_csv.cc (C++ CSVIter) — host CSV reader."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype="float32")
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype="float32")
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        super().__init__(data, label, batch_size=batch_size, **kwargs)


class LibSVMIter(DataIter):
    """reference: ``src/io/iter_libsvm.cc``: its batches are
    ``CSRNDArray``s, and sparse arrays are not ported yet."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("LibSVMIter yields CSRNDArray batches: sparse "
                         "arrays are not ported yet (ROADMAP.md, port "
                         "queue 1, item 12)")


class MNISTIter(NDArrayIter):
    """reference: src/io/iter_mnist.cc — reads the IDX-format MNIST files."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, **kwargs):
        import gzip
        import struct

        def read_idx(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                magic = struct.unpack(">I", f.read(4))[0]
                ndim = magic & 0xFF
                dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
                return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(dims)

        images = read_idx(image).astype("float32") / 255.0
        labels = read_idx(label).astype("float32")
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1,
                                    *images.shape[1:])
        super().__init__(images, labels, batch_size=batch_size,
                         shuffle=shuffle, **kwargs)


def ImageRecordIter(path_imgrec=None, path_imgidx=None, data_shape=None,
                    batch_size=128, shuffle=False, rand_crop=False,
                    rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                    std_r=1.0, std_g=1.0, std_b=1.0, resize=0,
                    label_width=1, **kwargs):
    """Record-file image iterator (reference: the C++ ImageRecordIter of
    ``iter_image_recordio_2.cc``, exposed via io.py): a thin factory over
    ``mx.image.ImageIter`` with the classic flat kwargs. On the card the
    batch is decoded by nvJPEG and augmented there (``ctx=``, default the
    card); ``dtype="uint8"`` with normalization refuses, as the
    reference's."""
    from ..image import CreateAugmenter, ImageIter

    if data_shape is None:
        raise MXNetError("ImageRecordIter requires data_shape")
    mean = None
    std = None
    if any(v != 1.0 for v in (std_r, std_g, std_b)):
        std = _np.array([std_r, std_g, std_b], _np.float32)
    if any(v != 0.0 for v in (mean_r, mean_g, mean_b)) or std is not None:
        # std-only normalization still needs the ColorNormalizeAug (a
        # zero mean), as the C++ iterator's independent std divide
        mean = _np.array([mean_r, mean_g, mean_b], _np.float32)
    dtype = kwargs.get("dtype", "float32")
    if mean is not None and _np.issubdtype(_np.dtype(dtype), _np.integer):
        raise MXNetError(
            f"ImageRecordIter: mean/std normalization produces floats — "
            f"incompatible with dtype={dtype!r} (an integer cast would "
            "wrap). Ship integer pixels and normalize on device via "
            "io.DeviceFeedIter(device_transform=io.make_normalize_"
            "transform(mean, std)), or use a float dtype")
    aug = CreateAugmenter(data_shape, resize=resize, rand_crop=rand_crop,
                          rand_mirror=rand_mirror, mean=mean, std=std,
                          dtype=dtype)
    return ImageIter(batch_size=batch_size, data_shape=data_shape,
                     path_imgrec=path_imgrec, path_imgidx=path_imgidx,
                     shuffle=shuffle, aug_list=aug, label_width=label_width,
                     **kwargs)
