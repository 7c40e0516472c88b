"""``mx.image`` on the card: nvJPEG and the augmenters there.

* nvJPEG's decode of the committed fixtures (``torch_image_fixtures/``,
  made with Pillow by ``make_fixtures.py``) against Pillow's pixels kept
  beside them, within the limits of ``torch_image_fixtures/fidelity.py``
  (which ``chip_smoke.py`` holds too); one file and a batch, on each
  backend the batch can take;
* Pillow's resampling on the card equal to the same function on the CPU,
  bit for bit, for every interp;
* nvJPEG's encode, decoded again, near its source, RGB and gray; the
  refusals of a non-JPEG on the card (no fallback to the host);
* four threads decoding at once give the single thread's bits, and two
  iterators alternating in one thread (each decoding on a stream of its
  own) with a decode on the current stream between give each one's bits
  alone;
* the seeded augmenter chain on the card equal to the same chain on the
  CPU fed the card's decoded image (crops, flips, resizes bit for bit,
  normalized float32 within 1e-6), and ``ImageRecordIter`` on the card
  equal to that chain sample for sample.

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX, nor the JAX package, nor Pillow:

    python -m pytest tests/test_torch_cuda_image.py -m cuda --noconftest
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image, recordio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.image import _resize
from mxnet_tpu_torch.kernels import jpeg
from torch_image_fixtures import fidelity

pytestmark = pytest.mark.cuda


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


def _psnr(got, want):
    return fidelity.judge(got, want, "4:2:0")[0]["psnr_db"]


def test_nvjpeg_decodes_the_fixtures_as_pillow_does():
    _require_card()
    fx = fidelity.load()
    misses = []

    def judge(name, route, got):
        rec, ok = fidelity.judge(got, fx[name][1], fx[name][2])
        if not ok:
            misses.append((name, route, rec))

    for name, (data, _, kind) in fx.items():
        flag = 0 if kind == "gray" else 1
        judge(name, "single",
              image.imdecode(data, flag=flag, ctx=mx.gpu(0)).asnumpy())
    color = [n for n in fx if fx[n][2] != "gray"]
    outs = jpeg.decode_batch([fx[n][0] for n in color], "cuda")
    assert jpeg.last_backend == "gpu_hybrid"    # the progressive file
    for n, t in zip(color, outs):
        judge(n, "gpu_hybrid", t.cpu().numpy())
    baseline = [n for n in color if n != "progressive"]
    outs = jpeg.decode_batch([fx[n][0] for n in baseline], "cuda")
    assert jpeg.last_backend in ("hardware", "gpu_hybrid")
    for n, t in zip(baseline, outs):
        judge(n, jpeg.last_backend, t.cpu().numpy())
    assert not misses, misses


def test_nvjpeg_bgr_and_gray_outputs():
    _require_card()
    data, want, _ = fidelity.load()["rgb444"]
    rgb = image.imdecode(data, ctx=mx.gpu(0)).asnumpy()
    bgr = image.imdecode(data, to_rgb=0, ctx=mx.gpu(0)).asnumpy()
    assert np.array_equal(bgr, rgb[:, :, ::-1])
    gray = image.imdecode(data, flag=0, ctx=mx.gpu(0)).asnumpy()
    assert gray.shape == rgb.shape[:2] + (1,)
    luma = rgb.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    assert np.abs(gray[:, :, 0] - luma).max() <= 3


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_card_resize_is_the_cpu_function_bit_for_bit(interp):
    _require_card()
    rs = np.random.RandomState(interp)
    for (h, w, c), (oh, ow) in [((375, 500, 3), (256, 341)),
                                ((61, 45, 1), (200, 150)),
                                ((1, 40, 3), (1, 17)),
                                ((33, 1, 3), (70, 1)),
                                ((224, 300, 3), (224, 224))]:
        img = torch.from_numpy(rs.randint(0, 256, (h, w, c)).astype(np.uint8))
        cpu = _resize.resize(img, ow, oh, interp)
        card = _resize.resize(img.cuda(), ow, oh, interp).cpu()
        assert torch.equal(cpu, card), ((h, w, c), (oh, ow), interp)


def test_encode_then_decode_round_trip():
    _require_card()
    y, x = np.mgrid[0:240, 0:320].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(0.05 * x), 128 + 100 * np.cos(0.04 * y),
                    128 + 60 * np.sin(0.03 * (x + y))], -1).astype(np.uint8)
    t = torch.from_numpy(img).cuda()
    data = jpeg.encode(t, quality=95)
    assert data[:2] == b"\xff\xd8" and jpeg.image_info(data)[1] == "4:2:0"
    back = jpeg.decode(data).cpu().numpy()
    assert _psnr(back, img) >= 35.0
    gray = torch.from_numpy(img[:, :, 1].copy()).cuda()
    g = jpeg.decode(jpeg.encode(gray, 95), fmt="Y").cpu().numpy()[:, :, 0]
    assert jpeg.image_info(jpeg.encode(gray, 95))[1] == "gray"
    assert _psnr(g, img[:, :, 1]) >= 35.0
    rec = recordio.pack_img(recordio.IRHeader(0, 3.0, 7, 0), mx.nd.array(
        img, ctx=mx.gpu(0), dtype="uint8"), quality=95)
    header, nd = recordio.unpack_img(rec, ctx=mx.gpu(0))
    assert header.label == 3.0 and header.id == 7
    assert np.array_equal(nd.asnumpy(), jpeg.decode(data).cpu().numpy())


def test_card_refuses_what_it_cannot_decode():
    _require_card()
    png = b"\x89PNG\r\n\x1a\n" + bytes(64)
    with pytest.raises(MXNetError, match="JPEG only"):
        image.imdecode(png, ctx=mx.gpu(0))
    with pytest.raises(MXNetError, match="NVJPEG_STATUS"):
        image.imdecode(b"\xff\xd8" + bytes(100), ctx=mx.gpu(0))
    img = mx.nd.array(np.zeros((8, 8, 3), np.uint8), ctx=mx.gpu(0),
                      dtype="uint8")
    with pytest.raises(MXNetError, match="JPEG only"):
        recordio.pack_img(recordio.IRHeader(0, 0.0, 0, 0), img,
                          img_fmt=".png")


def test_four_threads_decode_the_single_threads_bits():
    _require_card()
    fx = fidelity.load()
    datas = [fx[n][0] for n in fx if fx[n][2] != "gray"]
    want = [jpeg.decode(d).cpu() for d in datas]
    want_batch = [o.cpu() for o in jpeg.decode_batch(datas)]
    errors, done = [], []

    def work(k):
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                for it in range(10):
                    for d, w in zip(datas, want):
                        got = jpeg.decode(d)
                        stream.synchronize()
                        if not torch.equal(got.cpu(), w):
                            errors.append((k, it))
                    outs = jpeg.decode_batch(datas)
                    stream.synchronize()
                    if not all(torch.equal(o.cpu(), w)
                               for o, w in zip(outs, want_batch)):
                        errors.append((k, "batch", it))
            done.append(k)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((k, repr(e)))

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == [0, 1, 2, 3] and not errors, errors


def _card_images(n, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        h, w = rs.randint(240, 376), rs.randint(320, 501)
        y, x = np.mgrid[0:h, 0:w].astype(np.float64)
        img = np.stack([128 + 90 * np.sin(rs.uniform(0.01, 0.1) * x
                                          + rs.uniform(0, 6))
                        * np.cos(rs.uniform(0.01, 0.1) * y)
                        for _ in range(3)], -1)
        img += rs.normal(0, 6, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_image_record_iter_on_the_card_is_the_cpu_chain(tmp_path, dtype):
    _require_card()
    rec, idx = _write_card_records(tmp_path, 12, 5)
    norm = dtype == "float32"
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 224, 224),
              batch_size=5, shuffle=True, rand_crop=True, rand_mirror=True,
              resize=256, seed=11, dtype=dtype)
    if norm:
        kw.update(mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.4,
                  std_g=57.1, std_b=57.4)
    it = mx.io.ImageRecordIter(ctx=mx.gpu(0), **kw)
    order = list(it._order)
    seeds = [it._sample_seed(k) for k in range(12)]
    launches = jpeg.decode_batch.launches
    batches = list(it)
    assert len(batches) == 3 and batches[-1].pad == 3
    assert jpeg.decode_batch.launches == launches + 3
    # the same samples, decoded once on the card, through the same chain
    # on the CPU with the same seeds
    reader = recordio.MXIndexedRecordIO(idx, rec, "r")
    k = 0
    for b in batches:
        data = b.data[0]._data.cpu()
        for j in range(5 - (b.pad or 0)):
            _, payload = recordio.unpack(reader.read_idx(order[k]))
            img = jpeg.decode(payload).cpu()
            want = image._decode_augment(
                None, it.auglist, 3, np.dtype(dtype), seeds[k],
                image=mx.nd.NDArray(img))
            if norm:
                assert torch.allclose(data[j], want, rtol=0, atol=1e-6)
            else:
                assert torch.equal(data[j], want)
            k += 1
        assert b.label[0].context == mx.gpu(0)


def _write_card_records(tmp_path, n, seed):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = recordio.MXIndexedRecordIO(idx, rec, "w")
    for k, img in enumerate(_card_images(n, seed)):
        w.write_idx(k, recordio.pack_img(
            recordio.IRHeader(0, float(k % 3), k, 0),
            torch.from_numpy(img).cuda(), quality=90))
    w.close()
    return rec, idx


def test_two_iterators_alternating_in_one_thread_keep_their_bits(tmp_path):
    """A train and a val iterator in one thread, as a fit with an eval
    runs them: each decodes on a stream of its own, with no order between
    the two, and a decode on the current stream comes between. Each
    iterator's batches equal its batches alone."""
    _require_card()
    rec, idx = _write_card_records(tmp_path, 12, 9)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 96, 96),
              batch_size=4, dtype="uint8", ctx=mx.gpu(0))

    def iterators():
        """A seeded train iterator and a val iterator, made afresh, so
        each pass is their first epoch."""
        return (mx.io.ImageRecordIter(shuffle=True, rand_crop=True,
                                      rand_mirror=True, resize=128, seed=3,
                                      **kw),
                mx.io.ImageRecordIter(resize=112, **kw))

    payloads = []
    reader = recordio.MXIndexedRecordIO(idx, rec, "r")
    for k in range(12):
        payloads.append(recordio.unpack(reader.read_idx(k))[1])
    reader.close()
    alone = [[b.data[0]._data.cpu() for b in it] for it in iterators()]
    train, val = iterators()
    want_extra = [t.cpu() for t in jpeg.decode_batch(payloads[::-1])]
    got = ([], [])
    extra = []
    for _ in range(3):
        for j, it in enumerate((train, val)):
            got[j].append(it.next().data[0]._data)
            extra.append(jpeg.decode_batch(payloads[::-1]))
    torch.cuda.synchronize()
    for j in range(2):
        assert len(alone[j]) == 3
        assert all(torch.equal(g.cpu(), w)
                   for g, w in zip(got[j], alone[j])), j
    assert all(torch.equal(o.cpu(), w) for outs in extra
               for o, w in zip(outs, want_extra))
