"""Device contexts mapped onto ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``. ``mx.cpu()`` and ``mx.gpu(i)``
return ``torch.device`` objects. The port's native context is the CUDA
card: entry points that take ``ctx=None`` resolve it to ``gpu(0)``, and
asking for a GPU where CUDA is unavailable raises :class:`MXNetError` —
there is no silent fallback to the CPU. The CPU is reached only by
passing ``ctx=mx.cpu()`` explicitly (the CPU tests do).
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "num_gpus", "resolve_device"]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu(device_id: int = 0) -> torch.device:
    """The ``device_id``-th CUDA card; raises when there is none."""
    n = num_gpus()
    if device_id >= n:
        raise MXNetError(
            f"gpu({device_id}) requested but {n} CUDA device(s) are "
            "available; pass ctx=mx.cpu() to run on the CPU")
    return torch.device("cuda", device_id)


def resolve_device(ctx=None) -> torch.device:
    """``ctx`` as a concrete ``torch.device``: ``None`` is ``gpu(0)``;
    a ``torch.device`` or a device string is checked the same way."""
    if ctx is None:
        return gpu(0)
    dev = torch.device(ctx)
    if dev.type == "cpu":
        return cpu()
    if dev.type == "cuda":
        return gpu(0 if dev.index is None else dev.index)
    raise MXNetError(f"unsupported device {dev} (the port runs on cuda "
                     "or cpu)")
