"""The port's ``gluon.data`` held against the JAX package's on the CPU.

The same seeded numpy samples go through both packages: the sequential
sampler, ``BatchSampler`` in each ``last_batch`` mode and ``ArrayDataset``
/ ``transform`` / ``transform_first`` / ``RecordFileDataset`` give the
reference's sequences and samples; ``DataLoader`` batches (values,
dtypes, shapes) equal the reference's ``num_workers=0`` batches in every
worker mode of the port: none, threads, fork with shared memory, fork
with pickles; a worker's failure and a fork worker given a sample on a
device surface as ``MXNetError``; an early ``break`` leaves no shared
memory block behind. The random sampler is held to the permutation
property (the tests never compare random streams). The vision datasets
read local files and take the reference's synthetic surrogate bit for
bit; the deterministic transforms match the reference (``ToTensor`` and
``Normalize`` to one f32 rounding: the reference's XLA multiplies by
the reciprocal, the port divides, ROADMAP.md "scalar division").
"""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as pdata
from mxnet_tpu_torch.gluon.data import dataloader as pdl
from mxnet_tpu_torch.gluon.data.vision import transforms as ptf


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("n,bs", [(10, 3), (9, 3), (2, 4), (0, 2)])
def test_batch_sampler_sequences_are_the_references(last_batch, n, bs):
    """Two passes (rollover carries the remainder into the second) and
    ``len`` before each."""
    js = jdata.BatchSampler(jdata.SequentialSampler(n), bs, last_batch)
    ps = pdata.BatchSampler(pdata.SequentialSampler(n), bs, last_batch)
    for _ in range(2):
        assert len(ps) == len(js)
        assert list(ps) == list(js)


def test_sequential_sampler_with_a_start():
    assert list(pdata.SequentialSampler(5, start=3)) == \
        list(jdata.SequentialSampler(5, start=3))


@pytest.mark.parametrize("rng", ["numpy", "torch", "none"])
def test_random_sampler_is_a_fresh_permutation_each_pass(rng):
    gen = {"numpy": np.random.RandomState(3),
           "torch": torch.Generator().manual_seed(3), "none": None}[rng]
    s = pdata.RandomSampler(50, rng=gen)
    a, b = list(s), list(s)
    assert sorted(a) == sorted(b) == list(range(50)) and len(s) == 50
    assert a != b


def test_random_sampler_is_seeded_by_its_generator():
    a = list(pdata.RandomSampler(30, rng=np.random.RandomState(7)))
    b = list(pdata.RandomSampler(30, rng=np.random.RandomState(7)))
    assert a == b
    with pytest.raises(MXNetError):
        pdata.RandomSampler(3, rng=7)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _arrays(n=23, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (n, 5, 4, 3)).astype(np.uint8),
            rs.randint(0, 10, (n,)).astype(np.int32))


def test_array_dataset_transform_and_transform_first():
    x, y = _arrays()
    jd, pd = jdata.ArrayDataset(x, y), pdata.ArrayDataset(x, y)
    assert len(pd) == len(jd)
    for i in (0, 7, 22):
        _same(pd[i], jd[i])
    f = lambda a, b: (a.astype(np.float32) * 2, b + 1)  # noqa: E731
    jt, pt = jd.transform(f), pd.transform(f, lazy=False)
    _same(pt[4], jt[4])
    jf = jd.transform_first(lambda a: a[0])
    pf = pd.transform_first(lambda a: a[0])
    _same(pf[5], jf[5])
    _same(pdata.SimpleDataset([1, 2, 3])[2], 3)
    with pytest.raises(AssertionError):
        pdata.ArrayDataset(x, y[:3])


def test_record_file_dataset_reads_the_references_file(tmp_path):
    recs = [bytes([i]) * (i + 1) for i in range(6)]
    w = jrec.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                               str(tmp_path / "d.rec"), "w")
    for i, r in enumerate(recs):
        w.write_idx(i, r)
    w.close()
    ds = pdata.RecordFileDataset(str(tmp_path / "d.rec"))
    jds = jdata.RecordFileDataset(str(tmp_path / "d.rec"))
    assert len(ds) == len(jds) == 6
    assert [ds[i] for i in range(6)] == [jds[i] for i in range(6)] == recs


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------

_MODES = {
    "inline": ({}, {}),
    "threads": ({"num_workers": 3}, {}),
    "fork_shm": ({"num_workers": 2}, {"MXNET_TPU_FORK_WORKERS": "1"}),
    "fork_pickle": ({"num_workers": 2}, {"MXNET_TPU_FORK_WORKERS": "1",
                                         "MXNET_TPU_SHM": "0"}),
}


def _loader(mod, ds, mode, monkeypatch, **kw):
    args, env = _MODES[mode]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return mod.DataLoader(ds, **args, **kw)


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_dataloader_batches_are_the_references(mode, last_batch,
                                               monkeypatch):
    """A sequential sampler: every batch (a list of image and label
    arrays) equals the reference's, value, dtype and shape."""
    x, y = _arrays()
    want = list(jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=5,
                                 last_batch=last_batch))
    got = list(_loader(pdata, pdata.ArrayDataset(x, y), mode, monkeypatch,
                       batch_size=5, last_batch=last_batch))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
        assert all(b.context == mx.cpu() for b in g)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_dataloader_single_array_and_custom_batchify(mode, monkeypatch):
    x, _ = _arrays()
    want = list(jdata.DataLoader(jdata.SimpleDataset(list(x)),
                                 batch_size=4))
    got = list(_loader(pdata, pdata.SimpleDataset(list(x)), mode,
                       monkeypatch, batch_size=4))
    for g, w in zip(got, want):
        _same(g, w)
    stack = lambda s: np.stack(s).sum(axis=0)  # noqa: E731
    got = list(_loader(pdata, pdata.SimpleDataset(list(x)), mode,
                       monkeypatch, batch_size=4, batchify_fn=stack))
    want = list(jdata.DataLoader(jdata.SimpleDataset(list(x)),
                                 batch_size=4, batchify_fn=stack))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_dataloader_shuffle_covers_every_sample_once(mode, monkeypatch):
    x, y = _arrays(40, 1)
    seen = []
    for xb, yb in _loader(pdata, pdata.ArrayDataset(x, np.arange(40)),
                          mode, monkeypatch, batch_size=6, shuffle=True):
        seen += _np(yb).tolist()
    assert sorted(seen) == list(range(40))
    one = lambda: [int(v) for b in pdata.DataLoader(  # noqa: E731
        pdata.ArrayDataset(np.arange(40)), batch_size=8,
        sampler=pdata.RandomSampler(40, rng=np.random.RandomState(5)))
        for v in _np(b)]
    assert one() == one()


class _Faulty(pdata.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 is bad")
        return np.full((2,), i, np.float32)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_a_worker_failure_surfaces_as_mxnet_error(mode, monkeypatch):
    it = iter(_loader(pdata, _Faulty(), mode, monkeypatch, batch_size=2))
    next(it)
    next(it)
    err = ValueError if mode == "inline" else MXNetError
    with pytest.raises(err, match="sample 5 is bad"):
        next(it)


class _OnADevice(pdata.Dataset):
    """Samples on the meta device: on the CPU, the stand-in for a tensor
    on the card (tests/test_torch_cuda_data.py gives a real one)."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return torch.empty((2,), device="meta")


def test_a_fork_worker_refuses_a_sample_on_a_device(monkeypatch):
    it = iter(_loader(pdata, _OnADevice(), "fork_shm", monkeypatch,
                      batch_size=2, timeout=60))
    with pytest.raises(MXNetError, match="forked DataLoader worker"):
        next(it)


def test_an_early_break_leaves_no_shared_memory_block(monkeypatch,
                                                      tmp_path):
    """Every block the workers made (their names logged by a wrapper of
    ``_to_shm``, which the forked workers inherit) is unlinked after an
    early ``break``: the prefetched and unconsumed batches included.
    Other tests' blocks in ``/dev/shm`` are not looked at."""
    log = tmp_path / "blocks.txt"
    to_shm = pdl._to_shm

    def logged(tree):
        desc = to_shm(tree)
        with open(log, "a") as f:
            for d in desc if isinstance(desc, tuple) and desc[0] != \
                    "__shm__" else (desc,):
                f.write(d[1] + "\n")
        return desc

    monkeypatch.setattr(pdl, "_to_shm", logged)
    x, y = _arrays(64, 2)
    loader = _loader(pdata, pdata.ArrayDataset(x, y), "fork_shm",
                     monkeypatch, batch_size=4, prefetch=6)
    for i, _ in enumerate(loader):
        if i == 1:
            break
    made = log.read_text().split()
    assert len(made) >= 2 * 3          # two arrays a batch, some prefetched
    left = [n for n in made if os.path.exists("/dev/shm/" + n)]
    assert left == []


def test_dataloader_argument_errors():
    ds = pdata.SimpleDataset([1, 2, 3])
    with pytest.raises(MXNetError):
        pdata.DataLoader(ds)
    with pytest.raises(MXNetError):
        pdata.DataLoader(ds, 2, shuffle=True,
                         sampler=pdata.SequentialSampler(3))
    with pytest.raises(MXNetError):
        pdata.DataLoader(ds, 2, batch_sampler=pdata.BatchSampler(
            pdata.SequentialSampler(3), 2))
    assert len(pdata.DataLoader(ds, 2)) == 2


def test_pin_memory_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda_data.py")
    loader = pdata.DataLoader(pdata.SimpleDataset([np.ones(2)] * 2), 2,
                              pin_memory=True)
    with pytest.raises(MXNetError, match="gpu"):
        next(iter(loader))


# ---------------------------------------------------------------------------
# vision datasets and transforms
# ---------------------------------------------------------------------------

_VISION = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", _VISION)
def test_vision_surrogates_are_the_references_bits(name, train, tmp_path):
    from mxnet_tpu.gluon.data import vision as jv

    from mxnet_tpu_torch.gluon.data import vision as pv

    j = getattr(jv, name)(root=str(tmp_path), train=train)
    p = getattr(pv, name)(root=str(tmp_path), train=train)
    assert p.synthetic and j.synthetic and len(p) == len(j)
    np.testing.assert_array_equal(p._data, j._data)
    np.testing.assert_array_equal(p._label, j._label)
    for i in (0, len(p) - 1):
        _same(p[i], j[i])
        assert p[i][0].context == mx.cpu()


def _write_mnist(root, n, seed):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (n, 28, 28), np.uint8)
    lab = rs.randint(0, 10, (n,), np.uint8)
    os.makedirs(root, exist_ok=True)
    with gzip.open(os.path.join(root, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with gzip.open(os.path.join(root, "train-labels-idx1-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())


def _write_cifar10(root, n, seed):
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(1, 6):
        raw = np.concatenate([rs.randint(0, 10, (n, 1), np.uint8),
                              rs.randint(0, 256, (n, 3072), np.uint8)], 1)
        raw.tofile(os.path.join(root, f"data_batch_{i}.bin"))


@pytest.mark.parametrize("name", ["MNIST", "CIFAR10"])
def test_vision_datasets_read_local_files_as_the_reference(name, tmp_path):
    from mxnet_tpu.gluon.data import vision as jv

    from mxnet_tpu_torch.gluon.data import vision as pv

    root = str(tmp_path / name)
    (_write_mnist if name == "MNIST" else _write_cifar10)(root, 12, 4)
    j = getattr(jv, name)(root=root)
    p = getattr(pv, name)(root=root, transform=lambda a, b: (a, b + 1))
    assert not p.synthetic and len(p) == len(j)
    for i in range(len(p)):
        got, want = p[i], j[i]
        _same(got[0], want[0])
        assert got[1] == want[1] + 1


def test_image_datasets_need_the_image_module(tmp_path):
    """The image datasets decode through mx.image (their items against the
    JAX package's: tests/test_torch_image_iter.py)."""
    from mxnet_tpu_torch import image, recordio
    from mxnet_tpu_torch.gluon.data import vision as pv

    img = _img(3, (12, 10, 3))
    packed = recordio.pack_img(recordio.IRHeader(0, 2.0, 0, 0), img,
                               img_fmt=".png")
    w = recordio.MXIndexedRecordIO(str(tmp_path / "x.idx"),
                                   str(tmp_path / "x.rec"), "w")
    w.write_idx(0, packed)
    w.close()
    (tmp_path / "cls").mkdir()
    (tmp_path / "cls" / "a.png").write_bytes(recordio.unpack(packed)[1])
    rec = pv.ImageRecordDataset(str(tmp_path / "x.rec"), ctx=mx.cpu())
    folder = pv.ImageFolderDataset(str(tmp_path), ctx=mx.cpu())
    for got, label in (rec[0], folder[0]):
        want = image.imdecode(recordio.unpack(packed)[1], ctx=mx.cpu())
        assert np.array_equal(got.asnumpy(), want.asnumpy())
        assert np.array_equal(got.asnumpy(), img)
    assert rec[0][1] == 2.0 and folder[0][1] == 0
    assert folder.synsets == ["cls"]


def _img(seed=0, shape=(9, 11, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _run_tf(mod_tf, mod, make, img):
    x = mod.nd.array(img, dtype="uint8")
    return make(mod_tf)(x).asnumpy()


_TF = {
    "Resize": lambda t: t.Resize((7, 5)),
    "Resize_keep_ratio": lambda t: t.Resize((6, 6), keep_ratio=True),
    "CenterCrop": lambda t: t.CenterCrop((5, 4)),
    "CenterCrop_upscale": lambda t: t.CenterCrop(13),
    "CropResize": lambda t: t.CropResize(1, 2, 6, 5, size=(4, 3)),
    "Cast": lambda t: t.Cast("float16"),
    "Compose": lambda t: t.Compose([t.Cast("float32"), t.Cast("float16")]),
}


@pytest.mark.parametrize("name", sorted(_TF))
def test_deterministic_transforms_are_the_references(name):
    img = _img()
    want = _run_tf(jtf, jmx, _TF[name], img)
    with mx.cpu():
        got = _run_tf(ptf, mx, _TF[name], img)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_to_tensor_and_normalize_to_one_rounding(batched):
    img = _img(1, (2, 6, 5, 3) if batched else (6, 5, 3))
    make = lambda t: t.Compose([t.ToTensor(), t.Normalize(  # noqa: E731
        mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3))])
    for m in (lambda t: t.ToTensor(), make):
        want = _run_tf(jtf, jmx, m, img)
        with mx.cpu():
            got = _run_tf(ptf, mx, m, img)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-7)


_RANDOM_TF = {
    "RandomResizedCrop": lambda t: t.RandomResizedCrop((5, 4)),
    "RandomFlipLeftRight": lambda t: t.RandomFlipLeftRight(1.0),
    "RandomFlipTopBottom": lambda t: t.RandomFlipTopBottom(1.0),
    "RandomBrightness": lambda t: t.RandomBrightness(0.3),
    "RandomContrast": lambda t: t.RandomContrast(0.3),
    "RandomSaturation": lambda t: t.RandomSaturation(0.3),
    "RandomHue": lambda t: t.RandomHue(0.2),
    "RandomColorJitter": lambda t: t.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
    "RandomLighting": lambda t: t.RandomLighting(0.1),
}


@pytest.mark.parametrize("name", sorted(_RANDOM_TF))
def test_random_transforms_keep_shape_dtype_and_range(name):
    """Random draws are not compared: the output's shape, dtype and
    range are the reference's; a flip with p = 1 is exact."""
    img = _img(2)
    want = _run_tf(jtf, jmx, _RANDOM_TF[name], img)
    with mx.cpu():
        got = _run_tf(ptf, mx, _RANDOM_TF[name], img)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.min() >= 0 and got.max() <= 255
    if name.startswith("RandomFlip"):
        np.testing.assert_array_equal(got, want)


def test_mnist_through_transform_first_and_the_loader(tmp_path):
    """The eager Gluon loop's input: MNIST's surrogate through
    ``transform_first(ToTensor())`` and a 2-thread DataLoader, batch by
    batch against the reference's inline loader (one f32 rounding)."""
    from mxnet_tpu.gluon.data import vision as jv

    from mxnet_tpu_torch.gluon.data import vision as pv

    j = jv.MNIST(root=str(tmp_path), train=False).transform_first(
        jtf.ToTensor())
    p = pv.MNIST(root=str(tmp_path), train=False).transform_first(
        ptf.ToTensor())
    want = jdata.DataLoader(j, batch_size=64)
    got = pdata.DataLoader(p, batch_size=64, num_workers=2)
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 3:
            break
        assert g[0].shape == w[0].shape == (64, 1, 28, 28)
        np.testing.assert_allclose(_np(g[0]), _np(w[0]), rtol=2.5e-7)
        _same(g[1], w[1])


def test_default_batchify_builds_cpu_ndarrays():
    b = pdl.default_batchify_fn([(np.ones(2, np.float32), 1),
                                 (np.zeros(2, np.float32), 2)])
    assert [a.context for a in b] == [mx.cpu(), mx.cpu()]
    _same(b, jdata.dataloader.default_batchify_fn(
        [(np.ones(2, np.float32), 1), (np.zeros(2, np.float32), 2)]))
