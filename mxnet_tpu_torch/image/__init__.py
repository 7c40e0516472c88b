"""``mx.image`` — image decode and augmentation (counterpart of
``mxnet_tpu/image/__init__.py``; reference ``python/mxnet/image/image.py``).

Pixels are torch tensors on the image's device, handed out as NDArrays
(HWC, uint8 until ``CastAug``). On the card a JPEG file is decoded by
nvJPEG (``kernels/jpeg.py``) and every augmenter runs there; on the CPU
the codec is Pillow, imported here only, inside :func:`_pil`, as the
reference imports it. Resizing is Pillow's resampling as torch integer
ops (``_resize.py``), the same bits on either device. There is no
fallback between the two: a file the card cannot decode raises
:class:`MXNetError`.

Each augmenter draws what the reference's draws, with the same calls in
the same order (``random.random()``, ``random.uniform``,
``random.randint``, ``random.shuffle``, ``np.random.normal``), so a
sample's decisions (crop box, flip, jitter factors, Lighting's alpha,
gray) equal the reference's under the same seed. The arithmetic follows
the reference's numpy dtype steps: uint8 until ``CastAug``, then float32
(float64 where numpy promotes, rounded to float32 at the end as the
reference's array constructor does).
"""
from __future__ import annotations

import contextlib as _contextlib
import io as _io
import os as _os
import random as _pyrandom
import threading as _threading
import zlib as _zlib

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError, torch_dtype
from ..context import Context, current_context
from ..ndarray import NDArray
from ..telemetry import _state as _telemetry_state
from ._resize import resize as _pillow_resize

__all__ = [
    "imdecode", "imread", "imresize", "resize_short", "fixed_crop",
    "center_crop", "random_crop", "random_size_crop", "color_normalize",
    "Augmenter", "ResizeAug", "ForceResizeAug", "CenterCropAug",
    "RandomCropAug", "RandomSizedCropAug", "HorizontalFlipAug", "CastAug",
    "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
    "SaturationJitterAug", "ColorJitterAug", "LightingAug", "RandomGrayAug",
    "CreateAugmenter", "ImageIter",
]

_GRAY_COEF = (0.299, 0.587, 0.114)

# ---------------------------------------------------------------------------
# draws: the global streams, or a sample's own generators in thread mode
# ---------------------------------------------------------------------------

_draw = _threading.local()


def _py():
    """The Python ``random`` stream augmenters draw from: a per-sample
    ``random.Random`` while a thread-mode worker runs a seeded sample,
    else the module's global stream (the reference's)."""
    return getattr(_draw, "py", None) or _pyrandom


def _npr():
    """The numpy stream, likewise (``np.random`` by default)."""
    return getattr(_draw, "np", None) or np.random


@_contextlib.contextmanager
def _sample_draws(sseed, reseed_globals=True):
    """Draw one sample's decisions from ``sseed``: reseed the global
    streams (the reference's serial and process modes), or, for threads
    running side by side, give this thread generators of its own in the
    same states (``random.Random(s)`` and ``np.random.RandomState(s)``
    yield what ``random.seed(s)`` and ``np.random.seed(s)`` would)."""
    if sseed is None:
        yield
        return
    if reseed_globals:
        _pyrandom.seed(sseed)
        np.random.seed(sseed)
        yield
        return
    prev = (getattr(_draw, "py", None), getattr(_draw, "np", None))
    _draw.py = _pyrandom.Random(sseed)
    _draw.np = np.random.RandomState(sseed)
    try:
        yield
    finally:
        _draw.py, _draw.np = prev


# ---------------------------------------------------------------------------
# pixels
# ---------------------------------------------------------------------------

def _t(img) -> torch.Tensor:
    """The image as a tensor: an NDArray's own, a tensor as is, anything
    else through numpy on the host."""
    if isinstance(img, NDArray):
        return img._data
    if isinstance(img, torch.Tensor):
        return img
    return torch.from_numpy(np.ascontiguousarray(np.asarray(img)))


def _nd(t: torch.Tensor) -> NDArray:
    """An augmenter's output: an NDArray over ``t``, float64 rounded to
    float32 (the reference's ``nd_array`` rule)."""
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return NDArray(t)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def _dev(ctx) -> torch.device:
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return ctx.torch_device()
    return torch.device(ctx)


def _pil():
    """Pillow, the CPU codec; imported only for a decode or an encode on
    the host."""
    try:
        from PIL import Image
    except ImportError as err:
        raise MXNetError(
            "decoding an image on the CPU needs Pillow (PIL), which is not "
            "installed; decode on the card instead (ctx=mx.gpu())") from err
    return Image


def _decode_host(buf: bytes, flag: int, to_rgb: int) -> torch.Tensor:
    Image = _pil()
    img = Image.open(_io.BytesIO(buf))
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img)
    if not flag:
        arr = arr[:, :, None]
    if flag and not to_rgb:
        arr = arr[:, :, ::-1]            # BGR, the reference's cv2 default
    return torch.from_numpy(np.array(arr, order="C"))


def _card_format(flag, to_rgb) -> str:
    if not flag:
        return "Y"
    return "RGB" if to_rgb else "BGR"


def _buffer(buf) -> bytes:
    if isinstance(buf, NDArray):
        return buf.asnumpy().tobytes()
    if isinstance(buf, torch.Tensor):
        return buf.detach().cpu().numpy().tobytes()
    return bytes(buf)


def _decode(buf: bytes, flag: int, to_rgb: int, device) -> torch.Tensor:
    if device.type == "cuda":
        from ..kernels import jpeg

        return jpeg.decode(buf, device, _card_format(flag, to_rgb))
    return _decode_host(buf, flag, to_rgb)


def imdecode(buf, flag=1, to_rgb=1, out=None, ctx=None):
    """Decode an encoded image buffer to an HWC uint8 NDArray (reference:
    imdecode): ``flag`` 0 gives one gray channel, ``to_rgb`` 0 gives BGR.
    It decodes on ``ctx`` (default: the current context, the card): with
    nvJPEG there (JPEG only; a gray image is its luma plane), with Pillow
    on the CPU."""
    device = out._data.device if out is not None and ctx is None \
        else _dev(ctx)
    t = _decode(_buffer(buf), flag, to_rgb, device)
    if out is not None:
        if tuple(out.shape) != tuple(t.shape):
            raise MXNetError(f"imdecode: out has shape {tuple(out.shape)}, "
                             f"the image {tuple(t.shape)}")
        out._assign(t)
        return out
    return NDArray(t)


def imread(filename, flag=1, to_rgb=1, ctx=None):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb, ctx=ctx)


def imresize(src, w, h, interp=1):
    """Resize to (h, w) with Pillow's resampling (reference: imresize;
    interp 0 nearest, 1 bilinear, 2 bicubic, 3 nearest, 4 Lanczos), on
    the image's device; the input is taken as uint8, as the reference's
    ``astype(np.uint8)``."""
    t = _t(src)
    if t.dtype != torch.uint8:
        t = t.to(torch.uint8)
    return NDArray(_pillow_resize(t, w, h, interp))


def resize_short(src, size, interp=2):
    """Resize so the SHORT side equals size (reference: resize_short)."""
    h, w = _t(src).shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    arr = _t(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(arr, size[0], size[1], interp)
    return _nd(arr.contiguous())


def center_crop(src, size, interp=2):
    h, w = _t(src).shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = _t(src).shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _py().randint(0, w - new_w)
    y0 = _py().randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2, max_attempts=10):
    """Random area+aspect crop (the Inception-style crop)."""
    h, w = _t(src).shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(max_attempts):
        target = _py().uniform(*area) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(_py().uniform(*log_ratio))
        new_w = int(round(np.sqrt(target * ar)))
        new_h = int(round(np.sqrt(target / ar)))
        if new_w <= w and new_h <= h:
            x0 = _py().randint(0, w - new_w)
            y0 = _py().randint(0, h - new_h)
            return (fixed_crop(src, x0, y0, new_w, new_h, size, interp),
                    (x0, y0, new_w, new_h))
    return center_crop(src, size, interp)


def _like(value, t: torch.Tensor) -> torch.Tensor:
    """A mean/std as a tensor on ``t``'s device, in its numpy dtype
    (float32 from the augmenters, float64 where a caller gives it)."""
    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        return value.to(t.device)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(value))).to(t.device)


def color_normalize(src, mean, std=None):
    arr = _f32(_t(src))
    arr = arr - _like(mean, arr)
    if std is not None:
        arr = arr / _like(std, arr)
    return _nd(arr)


_gray_coef = {}


def _gray(arr: torch.Tensor, keepdim: bool) -> torch.Tensor:
    """``(arr * coef).sum(-1)`` in float32, summed left to right as
    numpy's reduction over a length-3 axis does."""
    c = _gray_coef.get(arr.device)
    if c is None:
        c = _gray_coef[arr.device] = torch.tensor(
            _GRAY_COEF, dtype=torch.float32).to(arr.device)
    p = arr * c
    g = (p[..., 0] + p[..., 1]) + p[..., 2]
    return g.unsqueeze(-1) if keepdim else g


# ---------------------------------------------------------------------------
# augmenters (reference: image.py Augmenter zoo)
# ---------------------------------------------------------------------------


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _py().random() < self.p:
            return _nd(torch.flip(_t(src), (1,)))
        return src if isinstance(src, NDArray) else _nd(_t(src))


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return _nd(_t(src).to(torch_dtype(np.dtype(self.typ))))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32) if std is not None else None
        self._consts = {}          # device -> (mean, std) tensors there

    def __call__(self, src):
        arr = _f32(_t(src))
        consts = self._consts.get(arr.device)
        if consts is None:
            consts = self._consts[arr.device] = (
                _like(self.mean, arr),
                None if self.std is None else _like(self.std, arr))
        arr = arr - consts[0]
        if consts[1] is not None:
            arr = arr / consts[1]
        return _nd(arr)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _py().uniform(-self.brightness, self.brightness)
        return _nd(_f32(_t(src)) * alpha)


class ContrastJitterAug(Augmenter):
    """The gray level is the float32 mean over the image: torch and numpy
    sum it in different orders, so it agrees with the reference's to
    float32 rounding, not bit for bit."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _py().uniform(-self.contrast, self.contrast)
        arr = _f32(_t(src))
        gray = _gray(arr, False).mean()
        return _nd(arr * alpha + gray * np.float32(1 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _py().uniform(-self.saturation, self.saturation)
        arr = _f32(_t(src))
        gray = _gray(arr, True)
        return _nd(arr * alpha + gray * np.float32(1 - alpha))


class SequentialAug(Augmenter):
    """Apply a list of augmenters in order (reference: image.py ::
    SequentialAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        return ["SequentialAug", [t.dumps() for t in self.ts]]

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply a list of augmenters in random order (reference: image.py ::
    RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        return ["RandomOrderAug", [t.dumps() for t in self.ts]]

    def __call__(self, src):
        order = list(self.ts)
        _py().shuffle(order)
        for t in order:
            src = t(src)
        return src


class ColorJitterAug(RandomOrderAug):
    """Random-order brightness/contrast/saturation jitter (reference:
    image.py::ColorJitterAug)."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness:
            ts.append(BrightnessJitterAug(brightness))
        if contrast:
            ts.append(ContrastJitterAug(contrast))
        if saturation:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def dumps(self):
        return ["ColorJitterAug", [t.dumps() for t in self.ts]]

    def __call__(self, src):
        src = super().__call__(src)
        return src if isinstance(src, NDArray) else _nd(_t(src))


class LightingAug(Augmenter):
    """PCA lighting noise (AlexNet-style); the offset is float64 (numpy's
    promotion of the float64 alpha), added in float64 and rounded to
    float32 as the reference's result is."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = _npr().normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(-1)
        arr = _f32(_t(src))
        return _nd(arr.to(torch.float64) + _like(rgb, arr))


class RandomGrayAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _py().random() < self.p:
            arr = _f32(_t(src))
            return _nd(_gray(arr, True).expand(arr.shape).contiguous())
        return src if isinstance(src, NDArray) else _nd(_t(src))


class HueJitterAug(Augmenter):
    """Random hue jitter (reference: image.py::HueJitterAug, the YIQ
    rotation); the product is float64, rounded to float32."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]])
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]])

    def __call__(self, src):
        alpha = _py().uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]])
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        x = _f32(_t(src))
        return _nd(x.to(torch.float64) @ _like(t, x))


def scale_down(src_size, size):
    """Scale `size` down to fit in `src_size`, keeping aspect ratio
    (reference: image.py::scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2, dtype="float32"):
    """Standard augmenter list builder (reference: CreateAugmenter;
    ``dtype="uint8"`` keeps the chain cast-free, in which case the float
    augmenters (jitter, normalize, lighting) must stay off)."""
    auglist = []
    crop_size = (data_shape[2], data_shape[1])
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if np.dtype(dtype) != np.uint8:
        auglist.append(CastAug(str(np.dtype(dtype))))
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and len(np.shape(mean)):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# ImageIter
# ---------------------------------------------------------------------------

def _finish(img, dtype: np.dtype) -> torch.Tensor:
    """An augmented HWC sample as CHW of the batch dtype; an integer
    dtype after float arithmetic raises (an integer cast would wrap
    normalised pixels)."""
    t = _t(img).permute(2, 0, 1)
    want = torch_dtype(dtype)
    if t.dtype == want:
        return t
    if not t.dtype.is_floating_point or want.is_floating_point:
        return t.to(want)
    raise MXNetError(
        f"augmenter chain produced {str(t.dtype).replace('torch.', '')} "
        f"but ImageIter(dtype={dtype}) was requested; keep normalization "
        "off the chain (io.DeviceFeedIter device_transform) or use a float "
        "dtype")


def _decode_augment(payload, auglist, channels, dtype, sseed=None,
                    device=None, reseed_globals=True, image=None):
    """Decode one sample (or take its decoded ``image``), run the
    augmenter chain with the sample's draws -> CHW tensor."""
    with _sample_draws(sseed, reseed_globals):
        img = image if image is not None else NDArray(_decode(
            bytes(payload), 1 if channels == 3 else 0, 1,
            device or torch.device("cpu")))
        for aug in auglist:
            img = aug(img)
    return _finish(img, dtype)


_worker_cfg = None
_ITER_UID = 0


def _image_worker_init(auglist, channels, dtype):
    global _worker_cfg
    _worker_cfg = (list(auglist), int(channels), np.dtype(dtype))
    torch.set_num_threads(1)


def _image_worker_chunk(payloads, seeds, shape, shm_name):
    """Decode and augment one chunk in a forked worker (the CPU path),
    writing each sample straight into one shared-memory block the parent
    named; only the descriptor crosses the pipe."""
    from multiprocessing import resource_tracker, shared_memory

    auglist, channels, dtype = _worker_cfg
    n = len(payloads)
    nbytes = n * int(np.prod(shape)) * dtype.itemsize
    shm = shared_memory.SharedMemory(name=shm_name, create=True,
                                     size=max(nbytes, 1))
    try:
        dst = np.ndarray((n,) + tuple(shape), dtype, buffer=shm.buf)
        for j, (p, s) in enumerate(zip(payloads, seeds)):
            dst[j] = _decode_augment(p, auglist, channels, dtype, s).numpy()
        del dst
    except BaseException:
        # no descriptor reaches the parent: the worker owns the unlink
        shm.close()
        shm.unlink()
        raise
    shm.close()
    resource_tracker.unregister(shm._name, "shared_memory")
    return shm_name, n


class ImageIter:
    """Record-file image iterator (reference: ImageIter).

    Yields ``DataBatch``es of NCHW data and float32 labels as NDArrays on
    the iterator's context ``ctx`` (default: the current context, the
    card).

    Worker model (``worker_mode``) on the CPU, as the reference's:

    * ``"process"``: a fork pool of ``preprocess_threads`` workers; each
      decodes (Pillow) and augments a contiguous chunk of the batch and
      ships it back as one shared-memory block. Default when
      ``MXNET_DATA_WORKERS`` is set (its value = worker count).
    * ``"thread"`` (default) / ``"serial"``: in process. A seeded thread
      mode gives each worker thread the sample's own generators, so its
      batches are the serial ones bit for bit.

    On the card every worker mode runs alike, on the calling thread
    (``"process"`` as the others: a forked child must not touch the live
    CUDA context; ``preprocess_threads`` is not used there, since a
    reader thread decoding the next batch ahead slowed the feed on an
    H100, PERF.md §6): the batch's records are read, decoded in one
    batched nvJPEG call and augmented on the card one sample at a time,
    each sample's draws on the host. The card's work runs on a stream of the
    iterator's own, which the consumer's current stream waits on, so it
    overlaps the step that consumes the previous batch.

    ``seed`` makes augmentation deterministic: sample ordinal ``k`` of
    epoch ``e`` draws from ``crc32(f"{base(seed, e)}:{k}") % 2**31``, so
    every mode gives the serial batches (unseeded serial and thread modes
    draw from the global streams). ``last_batch_handle``: ``"pad"``
    fills the last batch with its own first samples (``pad`` says how
    many), ``"discard"`` drops it, ``"roll_over"`` carries its samples
    into the next epoch's first batch. ``dtype`` is the batch dtype:
    ``"uint8"`` with a crop/flip-only chain ships quarter-size batches
    and leaves normalization to the device (``io.DeviceFeedIter``).
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imgidx=None, shuffle=False, aug_list=None,
                 label_width=1, last_batch_handle="pad",
                 preprocess_threads=4, worker_mode=None, seed=None,
                 dtype="float32", worker_timeout=120, ctx=None, **kwargs):
        from ..io import DataDesc
        from ..recordio import MXIndexedRecordIO, MXRecordIO

        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (channels, height, width)")
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError(f"last_batch_handle must be 'pad', 'discard' "
                             f"or 'roll_over', got {last_batch_handle!r}")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self._device = _dev(ctx)
        env_workers = _os.environ.get("MXNET_DATA_WORKERS")
        if worker_mode is None:
            worker_mode = "process" if env_workers else "thread"
        if worker_mode not in ("serial", "thread", "process"):
            raise MXNetError(
                f"worker_mode must be 'serial', 'thread' or 'process', "
                f"got {worker_mode!r}")
        n = int(env_workers) if env_workers else int(preprocess_threads)
        self._n_workers = max(1, min(n, _os.cpu_count() or 1))
        if worker_mode == "thread" and self._n_workers == 1:
            worker_mode = "serial"
        self._worker_mode = worker_mode
        self._worker_timeout = worker_timeout
        global _ITER_UID
        _ITER_UID += 1
        self._shm_prefix = f"mxi{_os.getpid()}u{_ITER_UID}"
        self._pool = None
        self._seed = seed
        self._dtype = np.dtype(dtype)
        self._epoch = -1
        self._drawn = 0
        self._carry = []              # roll_over: (payload, label, seed)
        self._current = None
        self._stream = None          # the card's work: decode, augment
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        if path_imgrec is None:
            raise MXNetError("ImageIter requires path_imgrec (use "
                             "gluon.data for folder datasets)")
        self._keys = None
        if path_imgidx:
            self._rec = MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self._keys = list(self._rec.keys)
        else:
            if shuffle:
                raise MXNetError(
                    "ImageIter(shuffle=True) requires path_imgidx — "
                    "sequential record files cannot be reordered")
            self._rec = MXRecordIO(path_imgrec, "r")
        self._order = None
        self._cursor = 0
        self.provide_data = [DataDesc("data",
                                      (batch_size,) + self.data_shape,
                                      self._dtype, "NCHW")]
        lshape = (batch_size,) if label_width == 1 else (batch_size,
                                                         label_width)
        self.provide_label = [DataDesc("softmax_label", lshape, "float32",
                                       "N")]
        self.reset()
        if self._worker_mode == "process" and self._on_host:
            # fork now, on the constructing thread, before any other
            # thread of this iterator exists
            self._ensure_pool()

    @property
    def _on_host(self) -> bool:
        return self._device.type != "cuda"

    def reset(self):
        self._cursor = 0
        self._epoch += 1
        self._drawn = 0
        if self._seed is not None:
            self._epoch_base = (self._seed + 1000003 * self._epoch) \
                & 0x7FFFFFFF
        else:
            # a fresh per-epoch base from the global stream, so forked
            # workers do not replay one augmentation stream
            self._epoch_base = _pyrandom.getrandbits(31)
        if self._keys is not None:
            self._order = list(self._keys)
            if self.shuffle:
                if self._seed is not None:
                    _pyrandom.Random(self._epoch_base).shuffle(self._order)
                else:
                    _pyrandom.shuffle(self._order)
        else:
            self._rec.reset()

    def _sample_seed(self, ordinal):
        """Per-sample augmentation seed, or None for the global streams
        (unseeded serial/thread modes)."""
        if self._seed is None and self._worker_mode != "process":
            return None
        return _zlib.crc32(f"{self._epoch_base}:{ordinal}".encode()) \
            % (2 ** 31)

    def _next_sample(self):
        from ..recordio import unpack

        if self._keys is not None:
            if self._cursor >= len(self._order):
                return None
            rec = self._rec.read_idx(self._order[self._cursor])
            self._cursor += 1
        else:
            rec = self._rec.read()
            if rec is None:
                return None
        header, payload = unpack(rec)
        label = header.label
        if isinstance(label, (np.ndarray, list)):
            label = np.asarray(label, np.float32)
        else:
            label = np.float32(label)
        return label, payload

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        """Advance to the next batch (``getdata``/``getlabel``/``getpad``
        read it); False at the end of the epoch."""
        try:
            self._current = self.next()
        except StopIteration:
            self._current = None
            return False
        return True

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getpad(self):
        return self._current.pad or 0

    def close(self):
        """Shut down the decode pool (idempotent; also runs on GC): a
        thread pool cancels queued work; a process pool is terminated and
        the iterator's shared-memory namespace swept."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        if hasattr(pool, "shutdown"):           # ThreadPoolExecutor
            pool.shutdown(wait=False, cancel_futures=True)
        else:                                   # multiprocessing.Pool
            pool.terminate()
            pool.join()
            import glob as _glob

            for path in _glob.glob(f"/dev/shm/{self._shm_prefix}*"):
                try:
                    _os.unlink(path)
                except OSError:  # pragma: no cover - raced cleanup
                    pass

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def _decode_one(self, payload, sseed=None):
        return _decode_augment(payload, self.auglist, self.data_shape[0],
                               self._dtype, sseed, self._device,
                               reseed_globals=self._worker_mode != "thread")

    def _ensure_pool(self):
        if self._pool is not None:
            return self._pool
        if self._worker_mode == "process":
            import multiprocessing

            # fork, not spawn: workers inherit the augmenter list without
            # importing the framework again; they run CPU code only
            ctx = multiprocessing.get_context("fork")
            self._pool = ctx.Pool(
                self._n_workers, initializer=_image_worker_init,
                initargs=(self.auglist, self.data_shape[0],
                          str(self._dtype)))
        else:
            import concurrent.futures as _cf

            self._pool = _cf.ThreadPoolExecutor(self._n_workers)
        return self._pool

    def _decode_chunks_into(self, data, payloads, seeds):
        """Fan one batch out over the process pool in contiguous chunks;
        each comes back as one shm block copied once into the batch."""
        from multiprocessing import shared_memory

        pool = self._ensure_pool()
        n = len(payloads)
        size = -(-n // min(self._n_workers, n))
        results = [(ofs, pool.apply_async(
            _image_worker_chunk,
            (payloads[ofs:ofs + size], seeds[ofs:ofs + size],
             (self.data_shape[0],) + self.data_shape[1:],
             f"{self._shm_prefix}e{self._epoch}d{self._drawn}o{ofs}")))
            for ofs in range(0, n, size)]
        got, failed = [], None
        for ofs, res in results:
            try:
                got.append((ofs, res.get(self._worker_timeout)))
            except Exception as e:  # noqa: BLE001 - rewrapped below
                failed = failed or e
        for ofs, (name, cnt) in got:
            shm = shared_memory.SharedMemory(name=name)
            try:
                if failed is None:
                    src = np.ndarray((cnt,) + tuple(data.shape[1:]),
                                     self._dtype, buffer=shm.buf)
                    data[ofs:ofs + cnt] = torch.from_numpy(src.copy())
                    del src
            finally:
                shm.close()
                shm.unlink()
        if failed is not None:
            raise MXNetError(
                f"ImageIter decode worker failed: {failed!r}") from failed

    def _stream_for_card(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        return self._stream

    def _read_decode(self):
        """The card's read: the batch's samples and, unless the epoch
        ends there, their images from one batched nvJPEG call on the
        iterator's stream."""
        from ..kernels import jpeg

        samples = self._read_batch()
        if self._at_end(samples):
            return samples, None
        with torch.cuda.stream(self._stream_for_card()):
            imgs = jpeg.decode_batch([p for p, _, _ in samples],
                                     self._device,
                                     "RGB" if self.data_shape[0] == 3
                                     else "Y")
        return samples, imgs

    def _at_end(self, samples) -> bool:
        return not samples or (len(samples) < self.batch_size
                               and self.last_batch_handle != "pad")

    def _read_batch(self):
        """Up to batch_size (payload, label, seed) triples: the samples
        rolled over from the last epoch first."""
        samples, self._carry = self._carry, []
        fresh = []
        while len(samples) + len(fresh) < self.batch_size:
            sample = self._next_sample()
            if sample is None:
                break
            fresh.append(sample)
        seeds = [self._sample_seed(self._drawn + j)
                 for j in range(len(fresh))]
        self._drawn += len(fresh)
        samples += [(p, lab, s) for (lab, p), s in zip(fresh, seeds)]
        return samples

    def next(self):
        from ..io import DataBatch

        if self._on_host:
            samples = self._read_batch()
        else:
            samples, imgs = self._read_decode()
        i = len(samples)
        if self._at_end(samples):
            if self.last_batch_handle == "roll_over":
                self._carry = samples
            raise StopIteration
        payloads = [s[0] for s in samples]
        seeds = [s[2] for s in samples]
        c, h, w = self.data_shape
        shape = (self.batch_size, c, h, w)
        dt = torch_dtype(self._dtype)
        labels = np.zeros((self.batch_size,) if self.label_width == 1
                          else (self.batch_size, self.label_width),
                          np.float32)
        for j, s in enumerate(samples):
            labels[j] = s[1]
        if self._on_host:
            data = torch.zeros(shape, dtype=dt)
            if self._worker_mode == "process":
                self._decode_chunks_into(data, payloads, seeds)
            elif self._worker_mode == "thread":
                decoded = list(self._ensure_pool().map(
                    self._decode_one, payloads, seeds))
                for j, arr in enumerate(decoded):
                    data[j] = arr
            else:
                for j, (p, s) in enumerate(zip(payloads, seeds)):
                    data[j] = self._decode_one(p, s)
            label_t = torch.from_numpy(labels)
        else:
            consumer = torch.cuda.current_stream(self._device)
            stream = self._stream_for_card()
            stream.wait_stream(consumer)
            with torch.cuda.stream(stream):
                data = torch.empty(shape, dtype=dt, device=self._device)
                for j, (img, sd) in enumerate(zip(imgs, seeds)):
                    data[j] = _decode_augment(None, self.auglist, c,
                                              self._dtype, sd,
                                              image=NDArray(img))
                label_t = torch.from_numpy(labels).pin_memory().to(
                    self._device, non_blocking=True)
            consumer.wait_stream(self._stream)
            data.record_stream(consumer)
            label_t.record_stream(consumer)
        if _telemetry_state.enabled:
            telemetry.record_images_decoded(i)
        pad = self.batch_size - i
        if pad:
            # pad by recycling real samples, so a fit never trains on
            # fabricated zero images; DataBatch.pad discounts them
            for j in range(i, self.batch_size):
                data[j] = data[j % i]
                label_t[j] = label_t[j % i]
        return DataBatch(data=[NDArray(data)], label=[NDArray(label_t)],
                         pad=pad)


from .detection import (DetAugmenter, DetBorrowAug,  # noqa: E402
                        DetHorizontalFlipAug, DetRandomCropAug,
                        DetRandomPadAug, CreateDetAugmenter, ImageDetIter)

__all__ += ["SequentialAug", "RandomOrderAug", "HueJitterAug",
            "scale_down"]
__all__ += ["DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
            "DetRandomCropAug", "DetRandomPadAug", "CreateDetAugmenter",
            "ImageDetIter"]
