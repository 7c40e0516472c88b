"""Base utilities of the PyTorch/CUDA port.

Counterpart of ``mxnet_tpu/base.py``: the framework error, the scalar
types (``:40``), the mapping from MXNet's dtype names to
``torch.dtype``, and MXNet's dtype ids (``:67``, mshadow's ``TypeFlag``
order, bf16 = 12) that ``.params`` files carry. The port keeps its own
copy rather than importing the JAX package (importing any ``mxnet_tpu``
module reconfigures JAX for the whole process), and it needs no
``ml_dtypes``: bf16 is a ``torch.bfloat16`` and travels through numpy as
its ``uint16`` bits.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

__all__ = ["MXNetError", "torch_dtype", "numeric_types", "integer_types",
           "dtype_id", "dtype_from_id", "name_manager"]


class MXNetError(RuntimeError):
    """Framework-level error (reference: ``python/mxnet/base.py :: MXNetError``)."""


class _NameManager(threading.local):
    """Unique names per thread: ``get(None, "dense")`` hands out
    ``dense0``, ``dense1``, ... (reference: ``base.py:83-104``)."""

    def __init__(self):
        super().__init__()
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    def reset(self):
        self._counter = {}


name_manager = _NameManager()

numeric_types = (float, int, _np.generic)
integer_types = (int, _np.integer)


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` as a ``torch.dtype``: a ``torch.dtype`` passes through, a
    name such as ``"bfloat16"`` or ``"int32"`` (or a numpy dtype or type)
    maps to the torch dtype of that name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, type) and issubclass(dtype, _np.generic):
        dtype = _np.dtype(dtype)
    name = getattr(dtype, "name", None) or str(dtype)
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return out


# mshadow's TypeFlag order (mshadow/base.h :: kFloat32=0, kFloat64=1,
# kFloat16=2, kUint8=3, kInt32=4, kInt8=5, kInt64=6, kBool=7, then the
# reference's int16..uint64 and bf16 = 12)
_DTYPE_IDS = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.uint8: 3,
    torch.int32: 4, torch.int8: 5, torch.int64: 6, torch.bool: 7,
    torch.int16: 8, torch.uint16: 9, torch.uint32: 10, torch.uint64: 11,
    torch.bfloat16: 12,
}
_ID_DTYPES = {v: k for k, v in _DTYPE_IDS.items()}


def dtype_id(dtype) -> int:
    """MXNet's dtype id of ``dtype`` (reference: ``dtype_np_to_id``)."""
    dt = torch_dtype(dtype)
    if dt not in _DTYPE_IDS:
        raise MXNetError(f"dtype {dt} has no MXNet dtype id")
    return _DTYPE_IDS[dt]


def dtype_from_id(type_id: int) -> torch.dtype:
    """The torch dtype of MXNet's dtype id (reference: ``dtype_id_to_np``)."""
    if type_id not in _ID_DTYPES:
        raise MXNetError(f"unknown MXNet dtype id {type_id}")
    return _ID_DTYPES[type_id]
