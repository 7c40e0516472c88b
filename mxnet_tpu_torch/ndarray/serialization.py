"""NDArray binary serialization, the ``.params`` format (counterpart of
``mxnet_tpu/ndarray/serialization.py:36-215``; reference:
``src/ndarray/ndarray.cc :: NDArray::Save/Load`` and
``src/c_api/c_api.cc :: MXNDArraySave/MXNDArrayLoad``).

A file this module writes is byte for byte the file the JAX package
writes for the same arrays, and each package loads the other's::

    list file   : u64 0x112 | u64 0 | u64 n | n x NDArray
                  | u64 m | m x (u64 len, utf-8 name)
    NDArray (V2): u32 0xF993FAC9 | i32 stype 0 | i32 ndim | i32 x ndim
                  | i32 dev_type 1 | i32 dev_id 0 | i32 dtype id
                  | raw little-endian data, C order

bf16 (dtype id 12) is written with the V3 magic 0xF993FACA, through its
``uint16`` bits: the port needs no ``ml_dtypes``. The loader also takes
the V1 and oldest layouts and, as an escape hatch for fixtures made
elsewhere, numpy ``.npz`` archives. A file is committed atomically (a
temporary file in the same directory, fsync, rename).
"""
from __future__ import annotations

import os
import struct
import tempfile
from typing import List

import numpy as _np
import torch

from ..base import MXNetError, dtype_from_id, dtype_id
from ..context import Context, current_context

__all__ = ["save", "load", "loads"]

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA


def _header(t: torch.Tensor) -> bytes:
    type_id = dtype_id(t.dtype)
    return (struct.pack("<Ii", _V3_MAGIC if type_id == 12 else _V2_MAGIC, 0)
            + struct.pack(f"<i{t.dim()}i", t.dim(), *t.shape)
            + struct.pack("<iii", 1, 0, type_id))


def _payload(t: torch.Tensor) -> memoryview:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy().reshape(-1).view(_np.uint8))


def save(fname: str, data) -> None:
    """Save an NDArray, a list of them or a dict name -> NDArray
    (reference: ``mx.nd.save``)."""
    from .ndarray import NDArray

    if isinstance(data, NDArray):
        arrays, names = [data], []
    elif isinstance(data, (list, tuple)):
        arrays, names = list(data), []
    elif isinstance(data, dict):
        names = list(data)
        arrays = [data[k] for k in names]
    else:
        raise TypeError("save requires NDArray, list of NDArray, or dict")
    fname = os.fspath(fname)
    d = os.path.dirname(os.path.abspath(fname))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(fname) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
            for a in arrays:
                t = a._data
                f.write(_header(t))
                f.write(_payload(t))
            f.write(struct.pack("<Q", len(names)))
            for n in names:
                nb = n.encode("utf-8")
                f.write(struct.pack("<Q", len(nb)) + nb)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _load_one(buf, off: int, device):
    (magic,) = struct.unpack_from("<I", buf, off)
    off += 4
    if magic in (_V2_MAGIC, _V3_MAGIC):
        (stype, ndim) = struct.unpack_from("<ii", buf, off)
        off += 8
        if stype != 0:
            raise MXNetError("sparse NDArray storage in .params files is "
                             "not supported")
        shape = struct.unpack_from(f"<{ndim}i", buf, off)
    elif magic == _V1_MAGIC:
        (ndim,) = struct.unpack_from("<I", buf, off)
        off += 4
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
    else:
        # the oldest layout: the magic word itself is ndim
        ndim = magic
        if ndim > 32:
            raise MXNetError("unrecognized NDArray file magic")
        shape = struct.unpack_from(f"<{ndim}I", buf, off)
    off += 4 * ndim
    _dev_type, _dev_id, type_id = struct.unpack_from("<iii", buf, off)
    off += 12
    dt = dtype_from_id(type_id)
    n = 1
    for s in shape:
        n *= s
    nbytes = n * torch.empty((), dtype=dt).element_size()
    if off + nbytes > len(buf):
        raise MXNetError(f"array of shape {tuple(shape)} runs past the end "
                         "of the payload")
    if n == 0:
        t = torch.empty(shape, dtype=dt)
    else:
        t = torch.frombuffer(buf, dtype=dt, count=n, offset=off)
    return t.reshape(shape).to(device, copy=True), off + nbytes


def loads(data, ctx: Context = None):
    """Load NDArrays from the bytes of a ``.params`` file onto ``ctx``
    (default: :func:`current_context`): a dict if the file names them,
    else a list."""
    from .ndarray import NDArray

    device = (ctx or current_context()).torch_device()
    # a writable buffer: torch.frombuffer warns on a read-only one
    buf = data if isinstance(data, bytearray) else bytearray(data)
    try:
        magic, _reserved, n = struct.unpack_from("<QQQ", buf, 0)
        if magic != _LIST_MAGIC:
            raise MXNetError("invalid NDArray list file magic")
        off = 24
        arrays: List[NDArray] = []
        for _ in range(n):
            t, off = _load_one(buf, off, device)
            arrays.append(NDArray(t))
        (m,) = struct.unpack_from("<Q", buf, off)
        off += 8
        names: List[str] = []
        for _ in range(m):
            (ln,) = struct.unpack_from("<Q", buf, off)
            off += 8
            names.append(bytes(buf[off:off + ln]).decode("utf-8"))
            off += ln
    except (struct.error, ValueError, UnicodeDecodeError) as e:
        raise MXNetError(f"corrupt or truncated NDArray payload: {e!r}") \
            from e
    return dict(zip(names, arrays)) if m else arrays


def load(fname: str, ctx: Context = None):
    """Load a ``.params`` file (or a numpy ``.npz``) onto ``ctx`` (default:
    :func:`current_context`; reference: ``mx.nd.load``)."""
    from .ndarray import array

    try:
        with open(fname, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            buf = bytearray(size)
            f.readinto(buf)
    except OSError as e:
        raise MXNetError(f"cannot read NDArray file {fname!r}: {e}") from e
    if buf[:2] == b"PK":
        with _np.load(fname) as npz:
            return {k: array(npz[k], ctx=ctx) for k in npz.files}
    try:
        return loads(buf, ctx=ctx)
    except MXNetError as e:
        raise MXNetError(f"{fname!r}: {e}") from e
