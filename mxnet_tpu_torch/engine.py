"""The port's execution engine: its sync points (counterpart of
``mxnet_tpu/engine.py:115`` ``wait_for_all``).

PyTorch queues every CUDA op on the device's current stream and returns,
as the reference engine pushes an op and returns. The sync points are
:func:`wait_for_all` (``mx.nd.waitall``: every card synchronised) and
:func:`wait_to_read` (the stream that last wrote the tensor, which the
port takes to be its device's current stream: the port launches
everything there). An error raised asynchronously on the card comes up
at one of them as :class:`MXNetError`. The reference's bulk segments and
fused-segment cache are XLA devices and wait (ROADMAP.md, port queue 1,
item 4).
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["wait_for_all", "wait_to_read"]


def _sync(fn, what: str) -> None:
    try:
        fn()
    except RuntimeError as e:       # torch's report of a CUDA error
        raise MXNetError(f"{what}: an asynchronous CUDA error: {e}") from e


def wait_for_all() -> None:
    """Block until every card has finished the work queued on it."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        _sync(lambda i=i: torch.cuda.synchronize(i), "waitall")


def wait_to_read(t: torch.Tensor) -> None:
    """Block until the work that writes ``t`` has finished."""
    if t.device.type == "cuda":
        _sync(torch.cuda.current_stream(t.device).synchronize,
              "wait_to_read")
