"""The port's image iterators, record packing, image datasets and model
store held against the JAX package's on the CPU.

One small seeded record file (JPEGs of at most 48x48 written by the
reference's ``pack_img``) feeds both packages' ``ImageIter``,
``io.ImageRecordIter`` and ``ImageDetIter``. From the same seed the
port's batches and labels equal the reference's serial ones, bit for bit
for uint8 and for float32 (the chain's float32 steps here, a cast and a
normalization, round alike): in the port's serial, thread and process
modes (the reference's own thread mode shares the global streams between
its threads, so only its serial batches are the yardstick). The ``.idx``
shuffle, ``last_batch_handle`` pad (the reference's only mode),
discard (its batches without the padded last one) and roll_over (the
left-over samples first in the next epoch, each with the draws it had)
are covered, as are ``pack_img``/``unpack_img`` across the packages,
``ImageRecordDataset``/``ImageFolderDataset`` items, the fork-worker
refusal, and the model store: a sha1 hit, a corrupt file refused, a
missing file naming where it was looked for, and ``pretrained=True``
equal to loading the file by hand.
"""
import hashlib
import random

import numpy as np
import pytest
import torch
from PIL import Image

import mxnet_tpu as jmx
from mxnet_tpu import image as jimg
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon.data.vision import datasets as jds

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as pimg
from mxnet_tpu_torch import recordio as prec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.data.vision import datasets as pds
from mxnet_tpu_torch.gluon.model_zoo import model_store

N = 7


def _pixels(h, w, seed):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(rs.uniform(0.05, 0.3) * x + k)
                    * np.cos(rs.uniform(0.05, 0.3) * y)
                    for k in range(3)], -1)
    img += rs.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _sizes(k):
    return 30 + (k * 7) % 19, 34 + (k * 5) % 15


@pytest.fixture(scope="module")
def recfile(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    rec, idx = str(d / "img.rec"), str(d / "img.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    for k in range(N):
        h, wd = _sizes(k)
        w.write_idx(k, jrec.pack_img(jrec.IRHeader(0, float(k % 3), k, 0),
                                     _pixels(h, wd, k), quality=90))
    w.close()
    return rec, idx


def _ref_batches(make, seed=5, epochs=1):
    """The reference iterator's batches, its global streams seeded."""
    random.seed(seed)
    np.random.seed(seed)
    it = make()
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return out


def _port_batches(make, seed=5, epochs=1):
    random.seed(seed)
    np.random.seed(seed)
    it = make()
    out = []
    try:
        for e in range(epochs):
            if e:
                it.reset()
            batches = []
            for b in it:
                assert b.data[0].context == mx.cpu()
                batches.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                                b.pad))
            out.append(batches)
    finally:
        it.close()
    return out


def _same(ref, got):
    assert len(ref) == len(got)
    for (rd, rl, rp), (gd, gl, gp) in zip(ref, got):
        assert gd.dtype == rd.dtype and gd.shape == rd.shape
        assert np.array_equal(gd, rd) and np.array_equal(gl, rl)
        assert (gp or 0) == (rp or 0)


CHAINS = {
    "uint8": dict(data_shape=(3, 24, 24), resize=28, rand_crop=True,
                  rand_mirror=True, dtype="uint8"),
    "float32": dict(data_shape=(3, 20, 20), rand_crop=True,
                    rand_resize=True, rand_mirror=True, mean=True,
                    std=True),
}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("mode", ["serial", "thread", "process"])
def test_image_iter_equals_the_reference_serial(recfile, chain, mode):
    rec, idx = recfile
    kw = dict(CHAINS[chain])
    dtype = kw.pop("dtype", "float32")

    def make(mod, **extra):
        return lambda: mod.ImageIter(
            3, kw["data_shape"], path_imgrec=rec, path_imgidx=idx,
            shuffle=True, aug_list=mod.CreateAugmenter(dtype=dtype, **kw),
            seed=11, dtype=dtype, **extra)

    ref = _ref_batches(make(jimg, worker_mode="serial"), epochs=2)
    got = _port_batches(make(pimg, worker_mode=mode, preprocess_threads=3,
                             ctx=mx.cpu()), epochs=2)
    assert [len(e) for e in ref] == [3, 3] and ref[0][-1][2] == 2
    for r, g in zip(ref, got):
        _same(r, g)


def test_unseeded_serial_iter_draws_the_global_streams(recfile):
    rec, idx = recfile
    kw = dict(data_shape=(3, 24, 24), rand_crop=True, rand_mirror=True)
    ref = _ref_batches(lambda: jimg.ImageIter(
        4, (3, 24, 24), path_imgrec=rec, path_imgidx=idx, shuffle=True,
        aug_list=jimg.CreateAugmenter(**kw), worker_mode="serial"))
    got = _port_batches(lambda: pimg.ImageIter(
        4, (3, 24, 24), path_imgrec=rec, path_imgidx=idx, shuffle=True,
        aug_list=pimg.CreateAugmenter(**kw), worker_mode="serial",
        ctx=mx.cpu()))
    _same(ref[0], got[0])


def test_last_batch_discard_and_roll_over(recfile):
    rec, idx = recfile
    aug = dict(data_shape=(3, 24, 24), rand_crop=True, rand_mirror=True,
               dtype="uint8")

    def make(mod, **extra):
        return lambda: mod.ImageIter(
            3, (3, 24, 24), path_imgrec=rec, path_imgidx=idx,
            aug_list=mod.CreateAugmenter(**aug), seed=4, dtype="uint8",
            worker_mode="serial", **extra)

    ref = _ref_batches(make(jimg), epochs=2)
    got = _port_batches(make(pimg, last_batch_handle="discard",
                             ctx=mx.cpu()), epochs=2)
    for r, g in zip(ref, got):
        _same(r[:-1], g)
    rolled = _port_batches(make(pimg, last_batch_handle="roll_over",
                                ctx=mx.cpu()), epochs=2)
    _same(ref[0][:-1], rolled[0])
    # epoch 1 starts with epoch 0's left-over sample (its epoch-0 draws),
    # then epoch 1's samples from its first
    first = rolled[1][0]
    assert np.array_equal(first[0][0], ref[0][-1][0][0])
    assert np.array_equal(first[0][1:], ref[1][0][0][:2])
    assert np.array_equal(first[1], np.r_[ref[0][-1][1][:1],
                                          ref[1][0][1][:2]])
    assert len(rolled[1]) == 2 and rolled[1][-1][2] in (0, None)
    with pytest.raises(MXNetError, match="last_batch_handle"):
        pimg.ImageIter(3, (3, 24, 24), path_imgrec=rec,
                       last_batch_handle="keep", ctx=mx.cpu())


def test_sequential_file_and_iter_next(recfile):
    rec, _ = recfile
    ref = _ref_batches(lambda: jimg.ImageIter(
        4, (3, 16, 16), path_imgrec=rec, worker_mode="serial", seed=2))
    got = _port_batches(lambda: pimg.ImageIter(
        4, (3, 16, 16), path_imgrec=rec, worker_mode="serial", seed=2,
        ctx=mx.cpu()))
    _same(ref[0], got[0])
    it = pimg.ImageIter(4, (3, 16, 16), path_imgrec=rec, seed=2,
                        ctx=mx.cpu())
    pads = []
    while it.iter_next():
        assert it.getdata()[0].shape == (4, 3, 16, 16)
        assert it.getlabel()[0].shape == (4,)
        pads.append(it.getpad())
    assert pads == [0, 1]
    with pytest.raises(MXNetError, match="path_imgidx"):
        pimg.ImageIter(4, (3, 16, 16), path_imgrec=rec, shuffle=True,
                       ctx=mx.cpu())


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_image_record_iter_equals_the_reference(recfile, dtype):
    rec, idx = recfile
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 24, 24),
              batch_size=4, shuffle=True, rand_crop=True, rand_mirror=True,
              resize=26, seed=9, dtype=dtype, worker_mode="serial")
    if dtype == "float32":
        kw.update(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.4,
                  std_g=57.1, std_b=57.4)
    ref = _ref_batches(lambda: jmx.io.ImageRecordIter(**kw))
    got = _port_batches(lambda: mx.io.ImageRecordIter(ctx=mx.cpu(), **kw))
    _same(ref[0], got[0])
    with pytest.raises(MXNetError, match="integer cast"):
        mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                              mean_r=1.0, dtype="uint8", ctx=mx.cpu())


def _det_file(tmp_path):
    rec, idx = str(tmp_path / "det.rec"), str(tmp_path / "det.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rs = np.random.RandomState(3)
    for k in range(5):
        n_obj = 1 + k % 3
        objs = []
        for _ in range(n_obj):
            x0, y0 = rs.uniform(0, 0.5, 2)
            objs += [float(rs.randint(0, 4)), x0, y0, x0 + 0.4, y0 + 0.3]
        label = np.array([2, 5] + objs, np.float32)
        w.write_idx(k, jrec.pack_img(jrec.IRHeader(0, label, k, 0),
                                     _pixels(36, 44, 20 + k), quality=90))
    w.close()
    return rec, idx


def test_image_det_iter_equals_the_reference(tmp_path):
    rec, idx = _det_file(tmp_path)

    def make(mod, **extra):
        return lambda: mod.ImageDetIter(
            2, (3, 24, 24), path_imgrec=rec, path_imgidx=idx,
            aug_list=mod.CreateDetAugmenter((3, 24, 24), rand_crop=1,
                                            rand_pad=1, rand_mirror=True,
                                            mean=True, std=True), **extra)

    ref = _ref_batches(make(jimg), epochs=2)
    got = _port_batches(make(pimg, ctx=mx.cpu()), epochs=2)
    for r, g in zip(ref, got):
        _same(r, g)
    it = pimg.ImageDetIter(2, (3, 24, 24), path_imgrec=rec, path_imgidx=idx,
                           ctx=mx.cpu())
    assert it.label_shape == (3, 5)
    it.reshape(data_shape=(3, 16, 16), label_shape=(4, 5))
    assert it.provide_label[0].shape == (2, 4, 5)
    with pytest.raises(MXNetError, match="object_width"):
        pimg.ImageDetIter._parse_label([2, 3, 1, 2, 3])


def test_pack_img_unpack_img_across_packages():
    img = _pixels(30, 41, 6)
    h = prec.IRHeader(0, 2.0, 5, 0)
    for q in (75, 95):
        ours = prec.pack_img(h, img, quality=q)
        theirs = jrec.pack_img(jrec.IRHeader(0, 2.0, 5, 0), img, quality=q)
        assert ours == theirs
        hp, ip = prec.unpack_img(theirs, ctx=mx.cpu())
        hj, ij = jrec.unpack_img(ours)
        assert isinstance(ip, mx.nd.NDArray) and ip.context == mx.cpu()
        assert np.array_equal(ip.asnumpy(), ij)
        assert hp.label == hj.label == 2.0
        _, gp = prec.unpack_img(theirs, iscolor=0, ctx=mx.cpu())
        _, gj = jrec.unpack_img(ours, iscolor=0)
        assert np.array_equal(gp.asnumpy()[:, :, 0], gj)
        with mx.cpu():
            _, nd = prec.unpack_img(ours)
        assert np.array_equal(nd.asnumpy(), ij)
        if not torch.cuda.is_available():     # the default is the card
            with pytest.raises(MXNetError, match="gpu"):
                prec.unpack_img(ours)
    png = prec.pack_img(h, img, img_fmt=".png")
    assert np.array_equal(jrec.unpack_img(png)[1], img)
    assert prec.pack_img(h, torch.from_numpy(img)) == prec.pack_img(h, img)
    with pytest.raises(MXNetError, match="unsupported"):
        prec.pack_img(h, img, img_fmt=".bmp")


def test_image_record_dataset_equals_the_reference(recfile):
    rec, _ = recfile
    ref = jds.ImageRecordDataset(rec)
    got = pds.ImageRecordDataset(rec, ctx=mx.cpu())
    gray = pds.ImageRecordDataset(rec, flag=0, ctx=mx.cpu())
    ref_gray = jds.ImageRecordDataset(rec, flag=0)
    assert len(got) == len(ref) == N
    for k in range(N):
        (ri, rl), (gi, gl) = ref[k], got[k]
        assert np.array_equal(gi.asnumpy(), ri.asnumpy()) and gl == rl
        assert np.array_equal(gray[k][0].asnumpy(), ref_gray[k][0].asnumpy())
    tf = pds.ImageRecordDataset(rec, ctx=mx.cpu(),
                                transform=lambda x, y: (x.shape, y + 1))
    assert tf[1] == (got[1][0].shape, got[1][1] + 1)


def test_image_folder_dataset_equals_the_reference(tmp_path):
    root = tmp_path / "folder"
    for c, cls in enumerate(("dog", "cat", "zebra")):
        (root / cls).mkdir(parents=True)
        for k in range(2):
            Image.fromarray(_pixels(20, 24, 10 * c + k)).save(
                root / cls / f"{k}.jpg", quality=90)
        np.save(root / cls / "x.npy", _pixels(8, 8, c))
        (root / cls / "notes.txt").write_text("skip")
    (root / "README").write_text("not a class")
    ref = jds.ImageFolderDataset(str(root))
    got = pds.ImageFolderDataset(str(root), ctx=mx.cpu())
    assert got.synsets == ref.synsets == ["cat", "dog", "zebra"]
    assert got.items == ref.items
    for k in range(len(ref)):
        (ri, rl), (gi, gl) = ref[k], got[k]
        assert np.array_equal(gi.asnumpy(), ri.asnumpy()) and gl == rl


def test_dataset_refuses_the_card_in_a_forked_worker(recfile, monkeypatch):
    from mxnet_tpu_torch.gluon.data import dataloader

    rec, _ = recfile
    monkeypatch.setattr(dataloader, "_in_fork_worker", True)
    card = pds.ImageRecordDataset(rec, ctx=torch.device("cuda", 0))
    with pytest.raises(MXNetError, match="forked DataLoader worker"):
        card[0]
    host = pds.ImageRecordDataset(rec, ctx=mx.cpu())
    assert host[0][0].shape == _sizes(0) + (3,)


def _params_file(tmp_path, name):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1

    net = resnet18_v1(classes=10)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(np.zeros((1, 3, 32, 32), np.float32), ctx=mx.cpu()))
    path = tmp_path / "src.params"
    net.save_parameters(str(path))
    sha1 = hashlib.sha1(path.read_bytes()).hexdigest()
    model_store.register(name, sha1)
    return path, sha1, net


def test_model_store_hit_corrupt_missing_and_pretrained(tmp_path,
                                                        monkeypatch):
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet

    monkeypatch.delenv("MXNET_GLUON_REPO", raising=False)
    monkeypatch.setattr(model_store, "_model_sha1",
                        dict(model_store._model_sha1))
    src, sha1, net = _params_file(tmp_path, "resnet18_v1")
    root = tmp_path / "models"
    want = root / f"resnet18_v1-{sha1[:8]}.params"
    with pytest.raises(MXNetError, match=str(want)):
        model_store.get_model_file("resnet18_v1", root=str(root))
    root.mkdir()
    want.write_bytes(src.read_bytes())
    assert model_store.get_model_file("resnet18_v1", root=str(root)) \
        == str(want)
    pre = get_resnet(1, 18, pretrained=True, root=str(root), classes=10,
                     ctx=mx.cpu())
    by_hand = get_resnet(1, 18, classes=10)
    by_hand.load_parameters(str(want), ctx=mx.cpu())
    a = pre._collect_params_with_prefix()
    b = by_hand._collect_params_with_prefix()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k].tensor, b[k].tensor), k
        assert torch.equal(a[k].tensor,
                           net._collect_params_with_prefix()[k].tensor)
    want.write_bytes(src.read_bytes()[:-4] + b"\0\0\0\0")
    with pytest.raises(MXNetError, match="corrupt"):
        model_store.get_model_file("resnet18_v1", root=str(root))
    repo = tmp_path / "repo" / "gluon" / "models"
    repo.mkdir(parents=True)
    (repo / want.name).write_bytes(src.read_bytes())
    monkeypatch.setenv("MXNET_GLUON_REPO", "file://" + str(tmp_path / "repo"))
    assert model_store.get_model_file("resnet18_v1", root=str(root)) \
        == str(want)
    assert hashlib.sha1(want.read_bytes()).hexdigest() == sha1
    monkeypatch.setenv("MXNET_GLUON_REPO", "https://example.invalid/")
    want.unlink()
    with pytest.raises(MXNetError, match="network"):
        model_store.get_model_file("resnet18_v1", root=str(root))
    with pytest.raises(MXNetError, match="no sha1"):
        model_store.get_model_file("resnet34_v1", root=str(root))
    model_store.purge(str(root))
    assert not list(root.glob("*.params"))
