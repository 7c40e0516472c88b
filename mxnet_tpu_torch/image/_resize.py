"""Pillow's ``Image.resize`` for uint8 images, as torch integer ops.

The reference resizes through Pillow (``mxnet_tpu/image/__init__.py:102``
``imresize``), which the card's path cannot call. This is the same
function, bit for bit, on either device: Pillow's separable resampling
(``libImaging/Resample.c``) with its coefficients worked out on the host
in double precision exactly as Pillow does, and the pixel sums done on
the image's device in int32, so the card and the CPU give the same bits.

* For each output pixel the filter's support is scaled by the downscale
  factor (antialiasing); the taps are normalised to sum 1 in double and
  then made fixed point with 22 fraction bits, rounded away from zero.
* The horizontal pass runs first, its sums clipped to uint8
  (``(acc + 2**21) >> 22``), then the vertical pass over that; a pass is
  skipped where its side does not change.
* Nearest is Pillow's own sampling rule, not a filter: the source of
  output x is ``int(x0)`` with ``x0 = scale / 2 + x * scale``, summed in
  double one step at a time as Pillow's affine scaler does.

``interp`` is the reference's: 0 nearest, 1 bilinear, 2 bicubic
(a = -0.5), 3 nearest, 4 Lanczos (a = 3); another value is bilinear.
"""
from __future__ import annotations

import math
import threading
from functools import lru_cache

import numpy as np
import torch

__all__ = ["resize"]

PRECISION_BITS = 22


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x):
    # Pillow's bicubic_filter with a = -0.5, term for term
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1
    far = ((((x - 5) * x + 8) * x) - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x):
    # math.sin, the C library's sin that Pillow calls, one value at a time
    flat = [(_sinc(v) * _sinc(v / 3) if -3.0 <= v < 3.0 else 0.0)
            for v in np.asarray(x, np.float64).ravel().tolist()]
    return np.asarray(flat, np.float64).reshape(np.shape(x))


# interp -> (filter, support); None is nearest
_FILTERS = {0: None, 1: (_bilinear, 1.0), 2: (_bicubic, 2.0), 3: None,
            4: (_lanczos, 3.0)}


@lru_cache(maxsize=4096)
def _coeffs(in_size: int, out_size: int, interp: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``:
    ``(first tap, taps)`` of each output pixel; taps past a pixel's count
    are 0."""
    filt, support0 = _FILTERS[interp]
    scale = filterscale = float(in_size) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)[None, :]
    arg = (((taps + xmin[:, None]).astype(np.float64) - center[:, None])
           + 0.5) * ss
    live = taps < xmax[:, None]
    w = np.where(live, filt(arg), 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):                  # Pillow's order of the sum
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    scaled = w * float(1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, -0.5 + scaled, 0.5 + scaled))
    return xmin, k.astype(np.int32)


@lru_cache(maxsize=4096)
def _nearest(in_size: int, out_size: int):
    """Pillow's ``ImagingScaleAffine`` source indices (-1: off the image,
    left black)."""
    a = float(in_size) / out_size
    xo = a * 0.5
    out = np.empty(out_size, np.int64)
    for x in range(out_size):
        xin = -1 if xo < 0.0 else int(xo)
        out[x] = xin if 0 <= xin < in_size else -1
        xo += a
    return out


_dev_cache = {}
_dev_lock = threading.Lock()


def _on(device, key, make):
    """A host table moved to ``device`` once (tables are small)."""
    k = (str(device),) + key
    with _dev_lock:
        t = _dev_cache.get(k)
    if t is None:
        t = make()
        with _dev_lock:
            if len(_dev_cache) > 8192:
                _dev_cache.clear()
            _dev_cache[k] = t
    return t


def _taps(in_size, out_size, interp, device):
    def make():
        xmin, k = _coeffs(in_size, out_size, interp)
        idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :],
                         in_size - 1)
        return (torch.from_numpy(idx).to(device),
                torch.from_numpy(k).to(device))
    return _on(device, ("taps", in_size, out_size, interp), make)


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    return ((acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS) \
        .clamp_(0, 255).to(torch.uint8)


def _pass(img: torch.Tensor, axis: int, out_size: int, interp: int):
    """One separable pass of ``img`` (H, W, C) uint8 along ``axis``."""
    idx, k = _taps(img.shape[axis], out_size, interp, img.device)
    if axis == 1:
        g = img[:, idx, :].to(torch.int32)            # (H, out, taps, C)
        acc = (g * k[None, :, :, None]).sum(2, dtype=torch.int32)
    else:
        g = img[idx].to(torch.int32)                  # (out, taps, W, C)
        acc = (g * k[:, :, None, None]).sum(1, dtype=torch.int32)
    return _clip8(acc)


def _nearest_resize(img, w, h):
    H, W = img.shape[:2]
    dev = img.device

    def table(n_in, n_out):
        src = _nearest(n_in, n_out)
        return (torch.from_numpy(np.maximum(src, 0)).to(dev),
                torch.from_numpy(src < 0).to(dev), bool((src < 0).any()))

    xi, xoff, xany = _on(dev, ("nn", W, w), lambda: table(W, w))
    yi, yoff, yany = _on(dev, ("nn", H, h), lambda: table(H, h))
    out = img[yi][:, xi]
    if xany or yany:                     # Pillow leaves those pixels black
        out[yoff] = 0
        out[:, xoff] = 0
    return out


def resize(img: torch.Tensor, w: int, h: int, interp: int = 1) -> torch.Tensor:
    """``img`` (H, W, C) uint8 resized to (h, w, C) as Pillow's
    ``Image.resize((w, h), resample)`` with the reference's ``interp``
    mapping, on ``img``'s device."""
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise ValueError(f"resize takes an (H, W, C) uint8 tensor, not "
                         f"{tuple(img.shape)} {img.dtype}")
    w, h = int(w), int(h)
    if w <= 0 or h <= 0:
        raise ValueError(f"resize to {w}x{h}: sizes must be positive")
    H, W = img.shape[:2]
    if (W, H) == (w, h):
        return img.clone()
    interp = interp if interp in _FILTERS else 1
    if _FILTERS[interp] is None:
        return _nearest_resize(img, w, h)
    out = img
    if w != W:
        out = _pass(out, 1, w, interp)
    if h != H:
        out = _pass(out, 0, h, interp)
    return out
