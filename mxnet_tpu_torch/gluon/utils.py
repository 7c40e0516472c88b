"""``gluon.utils`` of the port (counterpart of ``mxnet_tpu/gluon/utils.py:
16-97``): ``split_data``, ``split_and_load``, ``clip_global_norm``,
``check_sha1`` and ``download``, which raises as the reference's does:
the port fetches nothing over the network."""
from __future__ import annotations

import hashlib
import math
import warnings

import torch

from ..base import MXNetError
from ..ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (views); with
    ``even_split=False`` the last slice takes the remainder."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice:
        raise MXNetError(
            f"cannot evenly split axis {batch_axis} of size {size} into "
            f"{num_slice} slices (set even_split=False)")
    if num_slice == 1:
        return [data]
    if size < num_slice:
        raise MXNetError(f"axis {batch_axis} of size {size} is smaller than "
                         f"num_slice {num_slice}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(lo, hi)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch and load each slice onto its context."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their global L2 norm is at most
    ``max_norm``; returns the norm before scaling (a float, summed in
    f64 on the arrays' device)."""
    if not arrays:
        raise MXNetError("clip_global_norm: empty array list")
    total = sum(a._data.detach().double().square().sum() for a in arrays)
    norm = math.sqrt(float(total))
    if check_isfinite and not math.isfinite(norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            with torch.no_grad():
                a._data.mul_(scale)
            a._wrote()
    return norm


def check_sha1(filename, sha1_hash):
    """Whether the file's sha1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Raises: downloads are not available; place the file locally and
    pass its path to the consuming API."""
    raise MXNetError(
        f"download({url!r}): this environment has no network egress. "
        "Place the file locally and pass its path to the consuming API "
        "(e.g. CustomEmbedding, ImageRecordIter).")
