"""DataLoader — the host input pipeline (counterpart of
``mxnet_tpu/gluon/data/dataloader.py``; reference
``python/mxnet/gluon/data/dataloader.py``).

Workers produce **numpy** samples on the host and the batch is built
there as CPU NDArrays; it reaches the card when the consumer moves it
(``batch.as_in_context(mx.gpu())``) or, with ``pin_memory=True``, when
the loader pins it and starts the copy (``.to(device,
non_blocking=True)`` from page-locked memory, ``io.stage_on_device``);
for a copy on its own stream ahead of the step, wrap the loader in
``io.DeviceFeedIter``.

Workers are threads by default (``num_workers`` of them; torch's CPU
ops release the GIL). Fork workers are opt-in with the reference's
``MXNET_TPU_FORK_WORKERS=1``: a child forked from a process with a live
CUDA context may run CPU code only, so a worker refuses a sample on the
card with :class:`MXNetError` instead of touching it. Their transport is
zero-copy over POSIX shared memory, as the reference's
(``cpu_shared_storage_manager.h``): the worker stacks the samples into
``multiprocessing.shared_memory`` blocks and sends (name, shape, dtype)
descriptors; ``MXNET_TPU_SHM=0`` sends pickled numpy instead, and a
custom ``batchify_fn`` always does (the worker stacks for the default
batchify only). Every prefetched block left unconsumed by an early exit
is unlinked. A worker's failure, or a ``timeout``, surfaces at the
consumer as :class:`MXNetError`.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as _queue

import numpy as _np
import torch

from ...base import MXNetError
from ...context import cpu
from ...ndarray import NDArray, array as nd_array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def _host(arr):
    return nd_array(arr, ctx=cpu())


def default_batchify_fn(data):
    """Stack samples into a batch of CPU NDArrays (reference:
    dataloader.py::default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return _host(_np.stack([d.asnumpy() for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(list(i)) for i in data]
    return _host(_np.asarray(data))


default_mp_batchify_fn = default_batchify_fn


def _as_numpy_sample(sample, in_child=False):
    """A sample tree with its NDArrays and tensors as numpy. In a forked
    child an array on the card is refused: touching CUDA there would
    re-initialise it in a copy of a process whose context is live."""
    if isinstance(sample, tuple):
        return tuple(_as_numpy_sample(s, in_child) for s in sample)
    t = sample._data if isinstance(sample, NDArray) else sample
    if isinstance(t, torch.Tensor):
        if in_child and t.device.type != "cpu":
            raise MXNetError(
                f"a forked DataLoader worker got a sample on {t.device}: "
                "worker code may produce numpy or CPU tensors only (a "
                "forked child must not touch the card)")
        if isinstance(sample, NDArray):
            return sample.asnumpy()
        return t.detach().cpu().numpy()
    return sample


_worker_dataset = None
_in_fork_worker = False       # True in a forked worker process


def _worker_initializer(dataset):
    global _worker_dataset, _in_fork_worker
    _worker_dataset = dataset
    _in_fork_worker = True
    torch.set_num_threads(1)


def _stack_tree(samples):
    """default-batchify a list of numpy sample trees into batch arrays."""
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(_stack_tree([s[i] for s in samples])
                     for i in range(len(first)))
    return _np.stack([_np.asarray(s) for s in samples])


def _to_shm(tree):
    """Copy batch arrays into shm blocks; return the descriptor tree. The
    worker drops its mapping and unregisters each block from its
    resource tracker: the parent owns the unlink."""
    from multiprocessing import resource_tracker, shared_memory

    if isinstance(tree, tuple):
        return tuple(_to_shm(t) for t in tree)
    arr = _np.ascontiguousarray(tree)
    shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
    _np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
    name = shm.name
    shm.close()
    resource_tracker.unregister(shm._name, "shared_memory")
    return ("__shm__", name, tuple(int(s) for s in arr.shape), str(arr.dtype))


def _is_shm(tree):
    return isinstance(tree, tuple) and len(tree) == 4 \
        and tree[0] == "__shm__"


def _unlink_shm(tree):
    """Best-effort unlink of every block in a descriptor tree: the
    cleanup of batches prefetched but never consumed."""
    from multiprocessing import shared_memory

    if _is_shm(tree):
        try:
            shm = shared_memory.SharedMemory(name=tree[1])
            shm.close()
            shm.unlink()
        except Exception:
            pass
        return
    if isinstance(tree, tuple):
        for t in tree:
            _unlink_shm(t)


def _from_shm(tree):
    """Map a descriptor tree back into CPU NDArrays and unlink the
    blocks: one copy out of each block before it is unmapped, as the
    reference's rebuild pays."""
    from multiprocessing import shared_memory

    if _is_shm(tree):
        _, name, shape, dtype = tree
        shm = shared_memory.SharedMemory(name=name)
        arr = _np.ndarray(shape, dtype, buffer=shm.buf).copy()
        shm.close()
        shm.unlink()
        return _host(arr)
    if isinstance(tree, tuple):
        return [_from_shm(t) for t in tree]
    return tree


def _worker_fn(samples, batchify_is_default, use_shm=False):
    """Runs in a forked worker: fetch and transform samples; return them
    as pickled numpy, or (shm mode) stacked into blocks."""
    out = [_as_numpy_sample(_worker_dataset[i], in_child=True)
           for i in samples]
    if use_shm and batchify_is_default:
        return _to_shm(_stack_tree(out))
    return out


class DataLoader:
    """Mini-batch loader over a Dataset (reference:
    dataloader.py::DataLoader). ``shuffle`` draws from
    ``RandomSampler``'s generator; give ``sampler=RandomSampler(n,
    rng=...)`` for a seeded order."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._pin_device_id = pin_device_id
        self._thread_pool = thread_pool
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with a custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError(
                "batch_size/shuffle/sampler/last_batch must not be given "
                "with a batch_sampler")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._batchify_is_default = batchify_fn is None
        self._use_shm = (self._batchify_is_default
                         and os.environ.get("MXNET_TPU_SHM", "1") != "0")
        self._pool = None
        if self._num_workers > 0:
            if not thread_pool and os.environ.get("MXNET_TPU_FORK_WORKERS"):
                ctx = multiprocessing.get_context("fork")
                self._pool = ctx.Pool(
                    self._num_workers, initializer=_worker_initializer,
                    initargs=(dataset,))
            else:
                from multiprocessing.pool import ThreadPool

                self._thread_pool = True
                self._pool = ThreadPool(self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _fetch(self, idx):
        return [_as_numpy_sample(self._dataset[i]) for i in idx]

    def __iter__(self):
        if self._pool is None:
            for batch_idx in self._batch_sampler:
                yield self._batchify([self._dataset[i] for i in batch_idx])
            return
        # schedule `prefetch` batches ahead through the pool
        pending = _queue.Queue()
        it = iter(self._batch_sampler)

        def submit():
            try:
                batch_idx = next(it)
            except StopIteration:
                return False
            if self._thread_pool:
                res = self._pool.apply_async(self._fetch, (batch_idx,))
            else:
                res = self._pool.apply_async(
                    _worker_fn, (batch_idx, self._batchify_is_default,
                                 self._use_shm))
            pending.put(res)
            return True

        shm_mode = (not self._thread_pool and self._use_shm
                    and self._batchify_is_default)
        for _ in range(self._prefetch or 1):
            if not submit():
                break
        current = [None]  # the popped-but-unconsumed result, for cleanup
        try:
            while not pending.empty():
                res = pending.get()
                current[0] = res
                try:
                    samples = res.get(self._timeout)
                except multiprocessing.TimeoutError as e:
                    raise MXNetError(f"DataLoader worker timed out after "
                                     f"{self._timeout} s") from e
                except MXNetError:
                    raise
                except Exception as e:
                    raise MXNetError(f"DataLoader worker failed: {e!r}") \
                        from e
                current[0] = None
                submit()
                if shm_mode:
                    # stacked in the worker: a tuple sample (any arity)
                    # gives a list of arrays, a bare one an array, as
                    # default_batchify_fn does
                    batch = _from_shm(samples)
                    yield _pin(batch, self._pin_device_id) \
                        if self._pin_memory else batch
                else:
                    yield self._batchify(samples)
        finally:
            # early break, generator close, worker error or timeout: the
            # workers unregistered their blocks, so every prefetched but
            # unconsumed batch (and the one whose get() just failed) is
            # unlinked here, or /dev/shm fills across runs
            if shm_mode:
                leftovers = [current[0]] if current[0] is not None else []
                while not pending.empty():
                    leftovers.append(pending.get())
                for res in leftovers:
                    # a short wait only: a result whose get() timed out
                    # will not become ready now
                    try:
                        _unlink_shm(res.get(1.0))
                    except Exception:
                        pass

    def _batchify(self, samples):
        batch = self._batchify_fn(samples)
        if self._pin_memory:
            batch = _pin(batch, self._pin_device_id)
        return batch

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            try:
                pool.terminate()
            except Exception:
                pass  # interpreter shutdown: pool internals may be gone


def _pin(batch, device_id=0):
    """``pin_memory``: each batch array pinned and its copy to card
    ``device_id`` started (``io.stage_on_device``); the arrays keep the
    ``cpu_pinned`` label, as the reference's."""
    from ...io.device_feed import stage_on_device

    return stage_on_device(batch, device_id)
