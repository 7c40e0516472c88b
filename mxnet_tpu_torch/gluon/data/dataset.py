"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``).

Reference: ``python/mxnet/gluon/data/dataset.py`` — Dataset, SimpleDataset,
ArrayDataset, RecordFileDataset, and the lazy transform wrappers behind
``Dataset.transform`` / ``transform_first``.
"""
from __future__ import annotations

from typing import Callable

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn: Callable, lazy: bool = True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Zip of array-likes (reference: dataset.py::ArrayDataset)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; arg {i} has " \
                f"{len(data)} while the first has {self._length}"
            if isinstance(data, (list, tuple)):
                data = SimpleDataset(list(data))
            self._data.append(data)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file and its ``.idx`` (reference:
    dataset.py::RecordFileDataset; the reader is the native recordio
    module)."""

    def __init__(self, filename):
        from ... import recordio

        self._filename = filename
        idx_file = filename[: filename.rfind(".")] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
