"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; reference
``python/mxnet/gluon/data/vision/datasets.py``).

Nothing is downloaded. Each dataset reads the standard files under
``root`` (MNIST's gzipped idx files, CIFAR's binary batches); where they
are absent it takes the reference's **deterministic synthetic
surrogate**, the same bits (``_synthetic_images``): the same shapes and
dtypes and a learnable class structure (each class a fixed random
prototype plus noise). ``synthetic`` says which one is in use. Samples
are CPU NDArrays (HWC uint8) and int32 labels.

``ImageRecordDataset`` and ``ImageFolderDataset`` decode each image in
``__getitem__`` through ``mx.image.imdecode`` on ``ctx`` (default: the
current context, the card, where nvJPEG decodes; ``ctx=mx.cpu()``
decodes with Pillow). A forked ``DataLoader`` worker must not touch the
card: there a decode on the card raises :class:`MXNetError`, and only a
dataset made with ``ctx=mx.cpu()`` decodes.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from ....base import MXNetError
from ....context import Context
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _synthetic_images(num, shape, num_classes, seed, proto_seed=None):
    """Class-prototype + noise images: linearly separable enough to learn,
    hard enough that an untrained net is at chance.

    ``proto_seed`` (default: ``seed``) draws the class prototypes and MUST
    be shared across a dataset's train/test splits — with per-split
    prototypes a model trained on one split is at chance on the other
    (the bug this parameter fixes: train/test "MNIST" surrogates used to
    describe different classes entirely).
    """
    protos = _np.random.RandomState(
        seed if proto_seed is None else proto_seed).uniform(
        0, 255, size=(num_classes,) + shape).astype("float32")
    # disjoint stream for labels/noise: seeding with `seed` directly would
    # replay the prototype RNG's draws when seed == proto_seed, making
    # train-split noise a function of the prototype pixels
    rng = _np.random.RandomState(seed + 100003)
    labels = rng.randint(0, num_classes, size=(num,)).astype("int32")
    noise = rng.normal(0, 64.0, size=(num,) + shape).astype("float32")
    imgs = _np.clip(protos[labels] * 0.6 + noise, 0, 255).astype("uint8")
    return imgs, labels


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._data = None
        self._label = None
        self.synthetic = False
        self._get_data()

    def __getitem__(self, idx):
        from ....context import cpu
        from ....ndarray import array as nd_array

        img = nd_array(self._data[idx], dtype="uint8", ctx=cpu())
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """MNIST (reference: datasets.py::MNIST). Shape (28, 28, 1) uint8."""

    _NUM_CLASSES = 10
    _SHAPE = (28, 28, 1)
    _SEED = 42

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        if self._train:
            data_file = os.path.join(self._root, "train-images-idx3-ubyte.gz")
            label_file = os.path.join(self._root, "train-labels-idx1-ubyte.gz")
        else:
            data_file = os.path.join(self._root, "t10k-images-idx3-ubyte.gz")
            label_file = os.path.join(self._root, "t10k-labels-idx1-ubyte.gz")
        if os.path.exists(data_file) and os.path.exists(label_file):
            with gzip.open(label_file, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = _np.frombuffer(fin.read(), dtype=_np.uint8).astype(_np.int32)
            with gzip.open(data_file, "rb") as fin:
                struct.unpack(">IIII", fin.read(16))
                data = _np.frombuffer(fin.read(), dtype=_np.uint8)
                data = data.reshape(len(label), 28, 28, 1)
            self._data, self._label = data, label
            return
        # zero-egress fallback: learnable synthetic surrogate
        self.synthetic = True
        n_synth = 8192 if self._train else 2048
        seed = self._SEED if self._train else self._SEED + 1
        self._data, self._label = _synthetic_images(
            n_synth, self._SHAPE, self._NUM_CLASSES, seed,
            proto_seed=self._SEED)


class FashionMNIST(MNIST):
    _SEED = 77

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 (reference: datasets.py::CIFAR10). Shape (32, 32, 3) uint8."""

    _NUM_CLASSES = 10
    _SHAPE = (32, 32, 3)
    _SEED = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(-1, 3072 + 1)
        return (raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                raw[:, 0].astype(_np.int32))

    def _get_data(self):
        batches = [os.path.join(self._root, f"data_batch_{i}.bin")
                   for i in range(1, 6)] if self._train else \
                  [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(b) for b in batches):
            data, label = zip(*[self._read_batch(b) for b in batches])
            self._data = _np.concatenate(data)
            self._label = _np.concatenate(label)
            return
        self.synthetic = True
        n = 8192 if self._train else 2048
        seed = self._SEED if self._train else self._SEED + 1
        self._data, self._label = _synthetic_images(
            n, self._SHAPE, self._NUM_CLASSES, seed,
            proto_seed=self._SEED)


class CIFAR100(CIFAR10):
    _NUM_CLASSES = 100
    _SEED = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        f = os.path.join(self._root, "train.bin" if self._train else "test.bin")
        if os.path.exists(f):
            with open(f, "rb") as fin:
                raw = _np.frombuffer(fin.read(), dtype=_np.uint8).reshape(-1, 3072 + 2)
            self._data = raw[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            self._label = raw[:, 1 if self._fine_label else 0].astype(_np.int32)
            return
        self.synthetic = True
        n = 8192 if self._train else 2048
        self._data, self._label = _synthetic_images(
            n, self._SHAPE, self._NUM_CLASSES,
            self._SEED if self._train else self._SEED + 1,
            proto_seed=self._SEED)


def _decode_device(ctx, name):
    """The device a dataset decodes on, refused in a forked DataLoader
    worker when it is the card."""
    from ....image import _dev
    from .. import dataloader

    dev = _dev(ctx)
    if dev.type == "cuda" and dataloader._in_fork_worker:
        raise MXNetError(
            f"{name} decodes on the card ({dev}), which a forked DataLoader "
            "worker must not touch: use thread workers (the default), "
            "io.ImageRecordIter, or make the dataset with ctx=mx.cpu() to "
            "decode on the host")
    return dev


class ImageRecordDataset(Dataset):
    """Dataset over an image RecordIO file (reference:
    datasets.py::ImageRecordDataset): ``(image, label)`` with the image
    decoded on ``ctx`` (``flag`` 0 for gray)."""

    def __init__(self, filename, flag=1, transform=None, ctx=None):
        from ..dataset import RecordFileDataset

        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform
        self._ctx = ctx

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from .... import image, recordio

        dev = _decode_device(self._ctx, "ImageRecordDataset")
        header, img_bytes = recordio.unpack(self._record[idx])
        img = image.imdecode(img_bytes, flag=self._flag, ctx=dev)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """Images organized as root/<class>/<img> (reference:
    datasets.py::ImageFolderDataset): ``synsets`` the sorted class
    folders, ``items`` (path, label) sorted within each; ``.npy`` files
    load as arrays, the others decode on ``ctx``."""

    def __init__(self, root, flag=1, transform=None, ctx=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._ctx = ctx
        self._exts = {".jpg", ".jpeg", ".png", ".npy"}
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from .... import image
        from ....ndarray import array as nd_array

        path, label = self.items[idx]
        dev = _decode_device(self._ctx, "ImageFolderDataset")
        if path.endswith(".npy"):
            img = nd_array(_np.load(path), ctx=Context.from_device(dev))
        else:
            with open(path, "rb") as f:
                img = image.imdecode(f.read(), flag=self._flag, ctx=dev)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label
