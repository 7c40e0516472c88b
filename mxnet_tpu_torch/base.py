"""Base utilities of the PyTorch/CUDA port.

Counterpart of ``mxnet_tpu/base.py``: the framework error, and the
mapping from MXNet's dtype names to ``torch.dtype``. The port keeps its
own copy rather than importing the JAX package (importing any
``mxnet_tpu`` module reconfigures JAX for the whole process).
"""
from __future__ import annotations

import torch

__all__ = ["MXNetError", "torch_dtype"]


class MXNetError(RuntimeError):
    """Framework-level error (reference: ``python/mxnet/base.py :: MXNetError``)."""


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` as a ``torch.dtype``: a ``torch.dtype`` passes through, a
    name such as ``"bfloat16"`` or ``"int32"`` (or a numpy dtype) maps to
    the torch dtype of that name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return out
