"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``; reference
``python/mxnet/gluon/data/vision/transforms.py``) — Compose, Cast,
ToTensor, Normalize, Resize, CenterCrop, RandomResizedCrop,
RandomFlipLeftRight/TopBottom, ColorJitter et al.

These run in the host input pipeline (DataLoader workers) on HWC uint8
CPU NDArrays, with the reference's numpy arithmetic (``_resize_np``), so
the card is left to training. ``ToTensor``, ``Normalize`` and ``Cast``
are ``HybridBlock``s over the op registry; what they are given decides
their device.
"""
from __future__ import annotations

import math
import random as _pyrandom

import numpy as _np

from ....context import cpu
from ....ndarray import NDArray, array as nd_array
from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting", "CropResize"]


def _to_np(img):
    return img.asnumpy() if isinstance(img, NDArray) else _np.asarray(img)


def _host(arr):
    return nd_array(arr, ctx=cpu())


class Compose(HybridSequential):
    """Chain transforms (reference: transforms.py::Compose)."""

    def __init__(self, transforms):
        super().__init__()
        with self.name_scope():
            for t in transforms:
                self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference: ToTensor)."""

    def hybrid_forward(self, F, x):
        if x.ndim == 3:
            return F.transpose(x.astype("float32"), axes=(2, 0, 1)) / 255.0
        return F.transpose(x.astype("float32"), axes=(0, 3, 1, 2)) / 255.0


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, dtype="float32").reshape(-1, 1, 1)
        self._std = _np.asarray(std, dtype="float32").reshape(-1, 1, 1)

    def hybrid_forward(self, F, x):
        mean = nd_array(self._mean, ctx=x.context)
        std = nd_array(self._std, ctx=x.context)
        return F.broadcast_div(F.broadcast_sub(x, mean), std)


def _resize_np(img, w, h):
    """Bilinear resize on host numpy (the cv2 role)."""
    src = _to_np(img).astype("float32")
    if src.ndim == 2:
        src = src[:, :, None]
    sh, sw, c = src.shape
    ys = _np.linspace(0, sh - 1, h)
    xs = _np.linspace(0, sw - 1, w)
    y0 = _np.floor(ys).astype(int)
    x0 = _np.floor(xs).astype(int)
    y1 = _np.minimum(y0 + 1, sh - 1)
    x1 = _np.minimum(x0 + 1, sw - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    out = (src[y0][:, x0] * (1 - wy) * (1 - wx)
           + src[y0][:, x1] * (1 - wy) * wx
           + src[y1][:, x0] * wy * (1 - wx)
           + src[y1][:, x1] * wy * wx)
    return out


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._keep = keep_ratio

    def forward(self, x):
        w, h = self._size
        if self._keep:
            sh, sw = x.shape[:2]
            scale = min(w / sw, h / sh)
            w, h = int(sw * scale), int(sh * scale)
        out = _resize_np(x, w, h)
        return _host(out.astype("uint8") if _to_np(x).dtype == _np.uint8 else out)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        w, h = self._size
        sh, sw = x.shape[:2]
        if sh < h or sw < w:
            out = _resize_np(x, max(w, sw), max(h, sh))
            x = _host(out)
            sh, sw = x.shape[:2]
        y0 = (sh - h) // 2
        x0 = (sw - w) // 2
        return x[y0 : y0 + h, x0 : x0 + w]


class CropResize(Block):
    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y, self._w, self._h = x, y, width, height
        self._size = size

    def forward(self, img):
        out = img[self._y : self._y + self._h, self._x : self._x + self._w]
        if self._size:
            w, h = self._size if isinstance(self._size, (tuple, list)) \
                else (self._size, self._size)
            out = _host(_resize_np(out, w, h))
        return out


class RandomResizedCrop(Block):
    """reference: transforms.py::RandomResizedCrop — random area/ratio crop
    then resize."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        h, w = x.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = _pyrandom.uniform(*self._scale) * area
            log_ratio = (math.log(self._ratio[0]), math.log(self._ratio[1]))
            aspect = math.exp(_pyrandom.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                x0 = _pyrandom.randint(0, w - cw)
                y0 = _pyrandom.randint(0, h - ch)
                crop = x[y0 : y0 + ch, x0 : x0 + cw]
                return _host(_resize_np(crop, *self._size).astype("uint8"))
        return CenterCrop(self._size).forward(x)


class RandomFlipLeftRight(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _pyrandom.random() < self._p:
            return x.flip(axis=1)
        return x


class RandomFlipTopBottom(Block):
    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _pyrandom.random() < self._p:
            return x.flip(axis=0)
        return x


class _RandomJitter(Block):
    def _factor(self, spread):
        return 1.0 + _pyrandom.uniform(-spread, spread)


class RandomBrightness(_RandomJitter):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        f = self._factor(self._b)
        out = _np.clip(_to_np(x).astype("float32") * f, 0, 255)
        return _host(out.astype(_to_np(x).dtype))


class RandomContrast(_RandomJitter):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        f = self._factor(self._c)
        src = _to_np(x).astype("float32")
        mean = src.mean()
        out = _np.clip((src - mean) * f + mean, 0, 255)
        return _host(out.astype(_to_np(x).dtype))


class RandomSaturation(_RandomJitter):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        f = self._factor(self._s)
        src = _to_np(x).astype("float32")
        gray = src.mean(axis=-1, keepdims=True)
        out = _np.clip(gray + (src - gray) * f, 0, 255)
        return _host(out.astype(_to_np(x).dtype))


class RandomHue(_RandomJitter):
    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        # lightweight hue rotation in YIQ space (reference uses HSV via cv2)
        f = _pyrandom.uniform(-self._h, self._h) * math.pi
        src = _to_np(x).astype("float32") / 255.0
        t_yiq = _np.array([[0.299, 0.587, 0.114],
                           [0.596, -0.274, -0.321],
                           [0.211, -0.523, 0.311]], dtype="float32")
        t_rgb = _np.linalg.inv(t_yiq)
        yiq = src @ t_yiq.T
        c, s = math.cos(f), math.sin(f)
        rot = _np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype="float32")
        out = _np.clip((yiq @ rot.T) @ t_rgb.T, 0, 1) * 255
        return _host(out.astype(_to_np(x).dtype))


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            x = t.forward(x)
        return x


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise (reference: RandomLighting)."""

    _EIGVAL = _np.array([55.46, 4.794, 1.148], dtype="float32")
    _EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.814],
                         [-0.5836, -0.6948, 0.4203]], dtype="float32")

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _np.random.normal(0, self._alpha, size=(3,)).astype("float32")
        delta = (self._EIGVEC * a * self._EIGVAL).sum(axis=1)
        out = _np.clip(_to_np(x).astype("float32") + delta, 0, 255)
        return _host(out.astype(_to_np(x).dtype))
