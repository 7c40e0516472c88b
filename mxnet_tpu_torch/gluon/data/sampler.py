"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``;
reference ``python/mxnet/gluon/data/sampler.py``).

``RandomSampler`` draws its permutations from a generator it is given
(an ``np.random.RandomState`` or a ``torch.Generator``), or from a
``RandomState`` seeded from numpy's global stream, which the reference's
``np.random.permutation`` draws from."""
from __future__ import annotations

import numpy as _np
import torch

from ...base import MXNetError

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A fresh permutation of ``range(length)`` per pass, drawn from
    ``rng``: an ``np.random.RandomState``, a ``torch.Generator`` (a CPU
    one), or None for a ``RandomState`` seeded once from numpy's global
    stream."""

    def __init__(self, length, rng=None):
        self._length = length
        if rng is None:
            rng = _np.random.RandomState(_np.random.randint(2 ** 31))
        if not isinstance(rng, (_np.random.RandomState, torch.Generator)):
            raise MXNetError("RandomSampler: rng must be a numpy RandomState "
                             f"or a torch.Generator, not {type(rng).__name__}")
        self._rng = rng

    def __iter__(self):
        if isinstance(self._rng, torch.Generator):
            return iter(torch.randperm(self._length,
                                       generator=self._rng).tolist())
        return iter(self._rng.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Wrap a sampler into batches; last_batch ∈ {keep, discard, rollover}
    (reference: sampler.py::BatchSampler)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in ("keep", "discard", "rollover"):
            raise ValueError(f"last_batch must be one of keep/discard/"
                             f"rollover, got {last_batch}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (len(self._prev) + n) // self._batch_size
