"""The port's ``mx.image`` held against the JAX package's on the CPU.

Both decode with Pillow on the host, so ``imdecode``/``imread`` agree bit
for bit (RGB, ``flag=0``, ``to_rgb=0``, 4:4:4, 4:2:0, 4:2:2, progressive,
restart markers, odd sizes). ``imresize`` is Pillow's resampling written
as torch integer ops in the port and Pillow itself in the reference: bit
for bit for each interp, up- and down-scaling by non-integer factors,
1xN and Nx1, one channel and three, one side unchanged. Every augmenter
and ``CreateAugmenter``'s lists draw the reference's decisions from the
same seeds: the uint8 steps and float32 steps without a reduction are bit
for bit; ``ContrastJitterAug``'s float32 mean over the image (summed in
another order) and ``HueJitterAug``'s float64 product agree within the
tolerances stated at their tests. The committed card fixtures
(``torch_image_fixtures/``) are checked to be still Pillow's decode.
"""
import io
import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

import mxnet_tpu.image as jimg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as pimg
from mxnet_tpu_torch.base import MXNetError

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_image_fixtures")
with open(os.path.join(FIX, "manifest.json")) as _f:
    FIXTURES = sorted(json.load(_f))


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _pixels(h, w, seed, c=3):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(rs.uniform(0.05, 0.3) * x + k)
                    * np.cos(rs.uniform(0.05, 0.3) * y)
                    for k in range(c)], -1)
    img += rs.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg(arr, **opts):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _both(fn_name, *args, seed=0, **kwargs):
    """Call ``fn_name`` of each package with the global streams seeded
    alike; returns both results as numpy (tuples kept)."""
    out = []
    for mod in (jimg, pimg):
        random.seed(seed)
        np.random.seed(seed)
        with mx.cpu():
            r = getattr(mod, fn_name)(*args, **kwargs)
        out.append(r)
    return out


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_pixels_are_still_pillows_decode(name):
    with open(os.path.join(FIX, name + ".jpg"), "rb") as f:
        data = f.read()
    want = np.load(os.path.join(FIX, name + ".npy"))
    img = Image.open(io.BytesIO(data))
    got = np.asarray(img.convert("L" if want.ndim == 2 else "RGB"))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("flag,to_rgb", [(1, 1), (0, 1), (1, 0)])
def test_imdecode_equals_the_reference(name, flag, to_rgb):
    with open(os.path.join(FIX, name + ".jpg"), "rb") as f:
        data = f.read()
    ref = jimg.imdecode(data, flag=flag, to_rgb=to_rgb).asnumpy()
    got = pimg.imdecode(data, flag=flag, to_rgb=to_rgb, ctx=mx.cpu())
    assert got.context == mx.cpu()
    assert got.dtype == np.uint8 and np.array_equal(got.asnumpy(), ref)


def test_imread_and_out_equal_the_reference(tmp_path):
    path = tmp_path / "x.jpg"
    path.write_bytes(_jpeg(_pixels(33, 47, 1), quality=80))
    ref = jimg.imread(str(path)).asnumpy()
    assert np.array_equal(pimg.imread(str(path), ctx=mx.cpu()).asnumpy(),
                          ref)
    out = mx.nd.array(np.zeros(ref.shape, np.uint8), ctx=mx.cpu(),
                      dtype="uint8")
    assert pimg.imdecode(path.read_bytes(), out=out) is out
    assert np.array_equal(out.asnumpy(), ref)
    with pytest.raises(MXNetError, match="out has shape"):
        pimg.imdecode(path.read_bytes(), out=mx.nd.array(
            np.zeros((2, 2, 3), np.uint8), ctx=mx.cpu(), dtype="uint8"))


def test_cpu_decode_without_pillow_names_it(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(MXNetError, match="Pillow"):
        pimg.imdecode(_jpeg(_pixels(8, 8, 0)), ctx=mx.cpu())


RESIZE_CASES = [
    ((37, 53, 3), (25, 31)),      # down by non-integer factors
    ((37, 53, 3), (61, 90)),      # up by non-integer factors
    ((1, 40, 3), (1, 17)),        # 1xN
    ((40, 1, 1), (13, 1)),        # Nx1, one channel
    ((30, 45, 1), (30, 64)),      # one side unchanged
    ((64, 48, 3), (20, 48)),      # the other side unchanged
    ((23, 29, 3), (23, 29)),      # nothing changes
    ((50, 60, 3), (7, 9)),        # a strong downscale (wide support)
]


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4, 7])
@pytest.mark.parametrize("shape,size", RESIZE_CASES)
def test_imresize_equals_pillow_bit_for_bit(interp, shape, size):
    h, w, c = shape
    img = _pixels(h, w, h * w + interp, c)
    ref = jimg.imresize(img, size[1], size[0], interp).asnumpy()
    got = pimg.imresize(torch.from_numpy(img), size[1], size[0], interp)
    assert got.shape == ref.shape
    assert np.array_equal(got.asnumpy(), ref)


def test_resize_short_and_crops_equal_the_reference():
    img = _pixels(45, 70, 3)
    for interp in (1, 2):
        a, b = _both("resize_short", img, 24, interp)
        assert np.array_equal(_np(a), _np(b))
    a, b = _both("fixed_crop", img, 5, 7, 30, 20, (16, 12), 2)
    assert np.array_equal(_np(a), _np(b))
    for fn in ("center_crop", "random_crop"):
        for seed in range(4):
            (ra, ba), (rb, bb) = _both(fn, img, (32, 24), 2, seed=seed)
            assert ba == bb and np.array_equal(_np(ra), _np(rb))
    for seed in range(6):
        (ra, ba), (rb, bb) = _both("random_size_crop", img, (20, 20),
                                   (0.08, 1.0), (3 / 4, 4 / 3), 2, seed=seed)
        assert ba == bb and np.array_equal(_np(ra), _np(rb))


def _augment(mod, augs, img, seed):
    random.seed(seed)
    np.random.seed(seed)
    out = img
    with mx.cpu():
        for a in augs:
            out = a(out)
    return _np(out)


# name: (constructor args, tolerance: None = bit for bit, else atol)
AUGMENTERS = {
    "ResizeAug": ((20, 2), None),
    "ForceResizeAug": (((17, 23), 1), None),
    "CenterCropAug": (((24, 16),), None),
    "RandomCropAug": (((24, 16),), None),
    "RandomSizedCropAug": (((20, 20), (0.08, 1.0), (0.75, 1.333)), None),
    "HorizontalFlipAug": ((0.5,), None),
    "CastAug": (("float32",), None),
    "ColorNormalizeAug": (([123.68, 116.28, 103.53],
                           [58.395, 57.12, 57.375]), None),
    "BrightnessJitterAug": ((0.4,), None),
    "SaturationJitterAug": ((0.4,), None),
    # the float32 mean over the image sums in another order: 1 ulp of it
    "ContrastJitterAug": ((0.4,), 1e-4),
    "LightingAug": ((0.1, [55.46, 4.794, 1.148],
                     [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                      [-0.5836, -0.6948, 0.4203]]), None),
    "RandomGrayAug": ((0.5,), None),
    # float64 products summed by BLAS (numpy) and by torch, then float32
    "HueJitterAug": ((0.3,), 1e-4),
    "ColorJitterAug": ((0.3, 0.3, 0.3), 1e-4),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
def test_each_augmenter_draws_and_computes_as_the_reference(name):
    args, atol = AUGMENTERS[name]
    img = _pixels(40, 52, 7)
    for seed in range(6):
        ref = _augment(jimg, [getattr(jimg, name)(*args)], img, seed)
        got = _augment(pimg, [getattr(pimg, name)(*args)],
                       torch.from_numpy(img), seed)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        if atol is None:
            assert np.array_equal(got, ref), (name, seed)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol)


CREATE_CASES = [
    dict(data_shape=(3, 24, 24)),
    dict(data_shape=(3, 24, 24), resize=30, rand_crop=True,
         rand_mirror=True, dtype="uint8"),
    dict(data_shape=(3, 20, 28), rand_crop=True, rand_resize=True,
         rand_mirror=True, mean=True, std=True),
    dict(data_shape=(3, 24, 24), rand_crop=True, brightness=0.2,
         contrast=0.2, saturation=0.2, hue=0.1, pca_noise=0.1, rand_gray=0.3,
         mean=np.array([120.0, 110.0, 100.0]), inter_method=1),
]


@pytest.mark.parametrize("kw", range(len(CREATE_CASES)))
def test_create_augmenter_lists_equal_the_reference(kw):
    kwargs = CREATE_CASES[kw]
    ref_list = jimg.CreateAugmenter(**kwargs)
    got_list = pimg.CreateAugmenter(**kwargs)
    assert [type(a).__name__ for a in got_list] == \
        [type(a).__name__ for a in ref_list]
    img = _pixels(36, 44, kw)
    jitter = "brightness" in kwargs
    for seed in range(4):
        ref = _augment(jimg, ref_list, img, seed)
        got = _augment(pimg, got_list, torch.from_numpy(img), seed)
        assert got.dtype == ref.dtype
        if jitter:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
        else:
            assert np.array_equal(got, ref), seed


def test_sequential_random_order_and_scale_down():
    augs = [pimg.BrightnessJitterAug(0.2), pimg.SaturationJitterAug(0.2)]
    img = _pixels(16, 16, 2)
    for seed in range(4):
        ref = _augment(jimg, [jimg.RandomOrderAug(
            [jimg.BrightnessJitterAug(0.2), jimg.SaturationJitterAug(0.2)])],
            img, seed)
        got = _augment(pimg, [pimg.RandomOrderAug(augs)],
                       torch.from_numpy(img), seed)
        assert np.array_equal(got, ref)
    seq = _augment(pimg, [pimg.SequentialAug(augs)], torch.from_numpy(img), 1)
    ref = _augment(jimg, [jimg.SequentialAug(
        [jimg.BrightnessJitterAug(0.2), jimg.SaturationJitterAug(0.2)])],
        img, 1)
    assert np.array_equal(seq, ref)
    for src, size in (((640, 480), (720, 480)), ((100, 200), (300, 50)),
                      ((50, 50), (10, 20))):
        assert pimg.scale_down(src, size) == jimg.scale_down(src, size)


def test_color_normalize_and_integer_dtype_refusal():
    img = _pixels(12, 10, 4)
    mean = np.array([100.0, 110.0, 120.0], np.float32)
    std = np.array([50.0, 51.0, 52.0], np.float32)
    a, b = _both("color_normalize", img, mean, std)
    assert np.array_equal(_np(a), _np(b))
    with pytest.raises(MXNetError, match="dtype"):
        pimg._finish(pimg.color_normalize(torch.from_numpy(img), mean, std),
                     np.dtype(np.uint8))


def test_det_augmenters_move_boxes_as_the_reference():
    img = _pixels(40, 60, 9)
    label = np.array([[1, 0.1, 0.2, 0.5, 0.6], [0, 0.4, 0.1, 0.9, 0.7],
                      [-1, -1, -1, -1, -1]], np.float32)
    for name, args in (("DetHorizontalFlipAug", (0.5,)),
                       ("DetRandomCropAug", (0.3,)),
                       ("DetRandomPadAug", ())):
        for seed in range(5):
            outs = []
            for mod, x in ((jimg, img), (pimg, torch.from_numpy(img))):
                random.seed(seed)
                np.random.seed(seed)
                with mx.cpu():
                    im, lab = getattr(mod, name)(*args)(x, label.copy())
                outs.append((_np(im), lab))
            assert np.array_equal(outs[0][0], outs[1][0]), (name, seed)
            assert np.array_equal(outs[0][1], outs[1][1]), (name, seed)
    ref = jimg.CreateDetAugmenter((3, 24, 24), rand_crop=1, rand_pad=1,
                                  rand_mirror=True, mean=True, std=True)
    got = pimg.CreateDetAugmenter((3, 24, 24), rand_crop=1, rand_pad=1,
                                  rand_mirror=True, mean=True, std=True)
    assert [type(a).__name__ for a in got] == [type(a).__name__ for a in ref]
