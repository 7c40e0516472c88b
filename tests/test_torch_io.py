"""The port's ``mx.io`` held against the JAX package's on the CPU.

The same seeded numpy data goes through both packages: every batch of
``NDArrayIter`` (``last_batch_handle`` pad and discard, several data and
label arrays, dicts), ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``
and ``MNISTIter``, with its pad, index and ``provide_data`` /
``provide_label``, equals the reference's; ``make_normalize_transform``
equals the reference's bit for bit in f32 and bf16 (both multiply by
std's f32 reciprocal). ``DeviceFeedIter`` runs here with the CPU as its
target (``shardings=mx.cpu()`` or a CPU ``TrainStep``): its batches are
the source's, transformed; a producer failure (an injected
``datafeed.put`` fault) surfaces at ``next()`` as ``MXNetError`` naming
the stage; its telemetry is the reference's metric names. The card's
copy stream is held in ``tests/test_torch_cuda_data.py``.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import io as jio

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import fault, io as pio, telemetry
from mxnet_tpu_torch.base import MXNetError


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _batches(it):
    out = []
    for b in it:
        out.append(([_np(d) for d in b.data],
                    [_np(lab) for lab in (b.label or [])], b.pad,
                    None if b.index is None else np.asarray(b.index)))
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for ga, wa in zip(g[0] + g[1], w[0] + w[1]):
            assert ga.dtype == wa.dtype and ga.shape == wa.shape
            np.testing.assert_array_equal(ga, wa)
        assert len(g[0]) == len(w[0]) and len(g[1]) == len(w[1])
        assert g[2] == w[2]
        if w[3] is not None:
            np.testing.assert_array_equal(g[3], w[3])


def _data(n=23, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3, 4).astype(np.float32),
            rs.randint(0, 5, (n,)).astype(np.float32),
            rs.randint(0, 9, (n, 2)).astype(np.int32))


_ITERS = {
    "pad": lambda m, x, y, z: m.io.NDArrayIter(x, y, batch_size=5),
    "discard": lambda m, x, y, z: m.io.NDArrayIter(
        x, y, batch_size=5, last_batch_handle="discard"),
    "exact": lambda m, x, y, z: m.io.NDArrayIter(x[:20], y[:20],
                                                 batch_size=5),
    "two_data": lambda m, x, y, z: m.io.NDArrayIter(
        [x, z], [y], batch_size=4),
    "dict": lambda m, x, y, z: m.io.NDArrayIter(
        {"a": x, "b": z}, {"lab": y}, batch_size=6),
    "no_label": lambda m, x, y, z: m.io.NDArrayIter(x, batch_size=7),
    "names": lambda m, x, y, z: m.io.NDArrayIter(
        x, y, batch_size=5, data_name="img", label_name="cls"),
    "resize_longer": lambda m, x, y, z: m.io.ResizeIter(
        m.io.NDArrayIter(x, y, batch_size=5), 7),
    "resize_shorter": lambda m, x, y, z: m.io.ResizeIter(
        m.io.NDArrayIter(x, y, batch_size=5), 2),
    "prefetch": lambda m, x, y, z: m.io.PrefetchingIter(
        m.io.NDArrayIter(x, y, batch_size=5)),
}


@pytest.mark.parametrize("name", sorted(_ITERS))
def test_iterator_batches_are_the_references(name):
    """Two passes (``reset()`` between), and the descriptors."""
    x, y, z = _data()
    jit, pit = _ITERS[name](jmx, x, y, z), _ITERS[name](mx, x, y, z)
    for _ in range(2):
        _same_batches(_batches(pit), _batches(jit))
        jit.reset()
        pit.reset()
    for attr in ("provide_data", "provide_label"):
        assert getattr(pit, attr) == getattr(jit, attr)
    assert pit.batch_size == jit.batch_size
    if name == "prefetch":
        pit.close()
        jit.close()


def test_batches_are_host_ndarrays():
    x, y, _ = _data()
    b = next(iter(pio.NDArrayIter(x, y, batch_size=5)))
    assert [a.context for a in b.data + b.label] == [mx.cpu(), mx.cpu()]


def test_shuffle_covers_every_sample():
    x = np.arange(30, dtype=np.float32).reshape(30, 1)
    it = pio.NDArrayIter(x, batch_size=7, shuffle=True)
    seen = np.concatenate([_np(b.data[0])[:7 - b.pad].ravel() for b in it])
    assert sorted(seen.tolist()) == list(range(30))


def test_data_desc_and_batch_are_the_references():
    d, jd = pio.DataDesc("x", (2, 3), "int32"), jio.DataDesc("x", (2, 3),
                                                             "int32")
    assert tuple(d) == tuple(jd)
    assert pio.DataDesc.get_batch_axis("NHWC") == 0
    assert pio.DataDesc.get_batch_axis("TNC") == 1
    b = pio.DataBatch(mx.nd.zeros((2,), ctx=mx.cpu()), pad=1)
    assert len(b.data) == 1 and b.pad == 1 and b.label is None
    assert str(b) == "DataBatch: data shapes: [(2,)]"


def test_csv_iter_is_the_references(tmp_path):
    rs = np.random.RandomState(3)
    x = rs.randn(11, 6).astype(np.float32)
    y = rs.randint(0, 3, (11,)).astype(np.float32)
    np.savetxt(tmp_path / "x.csv", x, delimiter=",")
    np.savetxt(tmp_path / "y.csv", y, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "x.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "y.csv"), batch_size=4)
    _same_batches(_batches(pio.CSVIter(**kw)), _batches(jio.CSVIter(**kw)))


@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_is_the_references(tmp_path, flat):
    rs = np.random.RandomState(4)
    n = 10
    img = rs.randint(0, 256, (n, 28, 28), np.uint8)
    lab = rs.randint(0, 10, (n,), np.uint8)
    with gzip.open(tmp_path / "img.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + img.tobytes())
    with gzip.open(tmp_path / "lab.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())
    kw = dict(image=str(tmp_path / "img.gz"), label=str(tmp_path / "lab.gz"),
              batch_size=4, shuffle=False, flat=flat)
    _same_batches(_batches(pio.MNISTIter(**kw)),
                  _batches(jio.MNISTIter(**kw)))


def test_sparse_and_image_iterators_raise_naming_their_items(tmp_path):
    from mxnet_tpu_torch import recordio as prec
    from mxnet_tpu_torch.kernels import jpeg

    with pytest.raises(MXNetError, match="item 12"):
        pio.LibSVMIter(str(tmp_path / "x.libsvm"), (4,), 2)
    # ImageRecordIter reads images now (tests/test_torch_image_iter.py);
    # what the card's codec does not decode raises naming its item
    rec = str(tmp_path / "x.rec")
    w = prec.MXRecordIO(rec, "w")
    png = prec.pack_img(prec.IRHeader(0, 1.0, 0, 0),
                        np.zeros((8, 8, 3), np.uint8), img_fmt=".png")
    w.write(png)
    w.close()
    it = pio.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                             batch_size=1, ctx=mx.cpu())
    assert it.next().data[0].shape == (1, 3, 8, 8)
    with pytest.raises(MXNetError, match="item 10"):
        jpeg.decode(prec.unpack(png)[1])


class _Broken(pio.DataIter):
    def __init__(self):
        super().__init__(2)
        self.n = 0

    def iter_next(self):
        self.n += 1
        if self.n == 3:
            raise RuntimeError("source broke")
        return True

    def getdata(self):
        return [mx.nd.zeros((2,), ctx=mx.cpu())]

    def getlabel(self):
        return []


def test_prefetch_failure_surfaces_and_stays():
    it = pio.PrefetchingIter(_Broken())
    it.next()
    it.next()
    for _ in range(2):
        with pytest.raises(MXNetError, match="source broke"):
            it.next()
    it.close()
    with pytest.raises(MXNetError, match="closed"):
        it.next()


# ---------------------------------------------------------------------------
# the device feed
# ---------------------------------------------------------------------------

IMAGENET = ([123.68, 116.78, 103.94], [58.4, 57.1, 57.4])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_transform_is_the_references_bit_for_bit(dtype):
    import jax

    x = np.random.RandomState(0).randint(0, 256, (6, 3, 9, 7)).astype(
        np.uint8)
    y = np.arange(6, dtype=np.float32)
    want = jax.jit(jio.make_normalize_transform(*IMAGENET, dtype))(x, y)
    got = pio.make_normalize_transform(*IMAGENET, dtype)(
        torch.from_numpy(x), torch.from_numpy(y))
    w = np.asarray(want[0]).astype(np.float32)
    g = got[0].float().numpy()
    assert str(got[0].dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), y)


def _uint8_iter(n=20, bs=4):
    rs = np.random.RandomState(1)
    x = rs.randint(0, 256, (n, 3, 5, 5)).astype(np.uint8)
    y = rs.randint(0, 10, (n,)).astype(np.float32)
    return x, y, pio.NDArrayIter(x, y, batch_size=bs)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_feed_batches_are_the_sources_transformed(depth):
    x, y, src = _uint8_iter()
    tf = pio.make_normalize_transform(*IMAGENET, "float32")
    feed = pio.DeviceFeedIter(src, shardings=mx.cpu(), depth=depth,
                              device_transform=tf)
    for _ in range(2):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in feed]
        assert len(got) == 5
        for k, (gx, gy) in enumerate(got):
            want = tf(torch.from_numpy(x[4 * k:4 * k + 4]))[0].numpy()
            np.testing.assert_array_equal(gx, want)
            np.testing.assert_array_equal(gy, y[4 * k:4 * k + 4])
        feed.reset()
    assert feed.provide_data == src.provide_data
    feed.close()


def test_device_feed_takes_a_train_steps_device_and_dataloader_lists():
    from mxnet_tpu_torch.gluon import data as gdata

    net = torch.nn.Linear(3, 2)
    step = mx.parallel.TrainStep(net, lambda o, y: (o - y).square().sum(1),
                                 "sgd", optimizer_params={
                                     "learning_rate": 0.1})
    x = np.random.RandomState(2).randn(8, 3).astype(np.float32)
    y = np.zeros((8, 2), np.float32)
    loader = gdata.DataLoader(gdata.ArrayDataset(x, y), batch_size=4)
    feed = pio.DeviceFeedIter(loader, step=step)
    losses = []
    for data, label in feed:
        assert data.context == mx.cpu()
        losses.append(float(step(data, label)[0]))
    assert len(losses) == 2 and all(np.isfinite(losses))
    feed.close()


def test_device_feed_placement_errors():
    _, _, src = _uint8_iter()
    with pytest.raises(MXNetError, match="exactly one"):
        pio.DeviceFeedIter(src)

    class Mesh:
        devices = ("cuda:0", "cuda:1")

    with pytest.raises(MXNetError, match="item 11"):
        pio.DeviceFeedIter(src, shardings=Mesh())
    with pytest.raises(MXNetError, match="TrainStep"):
        pio.DeviceFeedIter(src, step=object())
    feed = pio.DeviceFeedIter(src, shardings=[mx.cpu()] * 3)
    with pytest.raises(MXNetError, match="3 devices for 2"):
        feed.next()
    feed.close()


def test_a_producer_fault_surfaces_naming_the_stage():
    _, _, src = _uint8_iter()
    with fault.inject("datafeed.put=every:2"):
        feed = pio.DeviceFeedIter(src, shardings=mx.cpu(), name="feedA")
        feed.next()
        with pytest.raises(MXNetError, match="'feedA' failed at "
                                             "datafeed.put"):
            feed.next()
        feed.close()


def test_device_feed_telemetry_is_the_references_metrics():
    _, _, src = _uint8_iter()
    telemetry.reset()
    telemetry.enable()
    try:
        feed = pio.DeviceFeedIter(src, shardings=mx.cpu(), name="feedT")
        n = sum(1 for _ in feed)
        feed.close()
        text = telemetry.prom_text()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert n == 5
    assert 'mxnet_data_wait_seconds_count{stage="feedT"} 6' in text
    assert 'mxnet_data_queue_depth{stage="feedT"}' in text


def test_stage_on_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda_data.py")
    with pytest.raises(MXNetError, match="gpu"):
        pio.stage_on_device([mx.nd.zeros((2,), ctx=mx.cpu())])


def test_cpu_pinned_context():
    c = mx.cpu_pinned()
    assert str(c) == "cpu_pinned(0)" and c.torch_device().type == "cpu"
    assert c.device_typeid == jmx.cpu_pinned().device_typeid
    a = mx.nd.NDArray(torch.ones(2), ctx=c)
    b = a.as_in_context(mx.cpu())
    assert b.context == mx.cpu() and b.asnumpy().tolist() == [1.0, 1.0]


def test_a_pinned_array_taken_to_the_host_is_a_copy():
    """``as_in_context(mx.cpu())`` of a ``cpu_pinned`` array is
    ``copyto``'s copy, not the batch's own storage."""
    a = mx.nd.NDArray(torch.arange(4.0), ctx=mx.cpu_pinned())
    b = a.as_in_context(mx.cpu())
    assert b._data.data_ptr() != a._data.data_ptr()
    a[:] = 7.0
    assert b.asnumpy().tolist() == [0.0, 1.0, 2.0, 3.0]


def test_io_surface_is_the_references():
    assert set(pio.__all__) == set(jio.__all__)
    assert mx.io is pio
