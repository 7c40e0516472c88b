"""Device contexts (counterpart of ``mxnet_tpu/context.py:37-120``).

``mx.cpu()`` and ``mx.gpu(i)`` return a :class:`Context` (device type
and id, ``==``, ``hash``, ``with ctx:``), which maps onto a
``torch.device``. The port's native context is the CUDA card: entry
points that take ``ctx=None`` resolve it to ``gpu(0)``, and
:func:`current_context` is ``gpu(0)`` unless a ``with ctx:`` scope says
otherwise (the reference's default is ``cpu(0)``). Asking for a GPU
where CUDA is unavailable raises :class:`MXNetError` — there is no
silent fallback to the CPU. The CPU is reached only by passing
``ctx=mx.cpu()`` or by ``with mx.cpu():`` (the CPU tests do).

``mx.cpu_pinned()`` is host memory in page-locked pages
(``Tensor.pin_memory()``): the staging context of the input pipeline
(``gluon.data.DataLoader(pin_memory=True)``, ``io.DeviceFeedIter``),
from which a copy to the card runs asynchronously. As in the reference
(``mxnet_tpu/io/device_feed.py:65-84``), a batch staged onto the card
keeps that label: an NDArray in ``cpu_pinned`` may hold a pinned host
tensor or the card's copy of one.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "num_gpus",
           "current_context", "resolve_device"]


class Context:
    """A device context (reference: ``mxnet_tpu/context.py :: Context``),
    with the reference's device-type ids (``include/mxnet/base.h``:
    kCPU = 1, kGPU = 2, kCPUPinned = 3)."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_typeid,
                                      device_type.device_id)
        if isinstance(device_type, str):
            if device_type not in Context.devstr2type:
                raise MXNetError(f"unknown device type {device_type!r} "
                                 "(the port has cpu and gpu)")
            device_type = Context.devstr2type[device_type]
        self.device_typeid = device_type
        self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return f"{self.device_type}({self.device_id})"

    __repr__ = __str__

    def __enter__(self):
        # the outer scope goes on a per-thread stack, not on the instance,
        # so one Context may be entered twice (nested) or held by many
        # arrays
        d = Context._default_ctx
        if not hasattr(d, "outer"):
            d.outer = []
        d.outer.append(getattr(d, "value", None))
        d.value = self
        return self

    def __exit__(self, ptype, value, trace):
        d = Context._default_ctx
        d.value = d.outer.pop()

    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this context; a GPU context is checked
        against the cards present."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        gpu(self.device_id)             # raises where the card is missing
        return torch.device("cuda", self.device_id)

    @staticmethod
    def from_device(dev: torch.device) -> "Context":
        """The context of a ``torch.device`` (``cuda`` without an index is
        card 0)."""
        if dev.type == "cpu":
            return Context(1, 0)
        if dev.type == "cuda":
            return Context(2, 0 if dev.index is None else dev.index)
        raise MXNetError(f"unsupported device {dev} (the port runs on cuda "
                         "or cpu)")


def cpu(device_id: int = 0) -> Context:
    return Context(1, device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Page-locked host memory, the staging context of the input
    pipeline (reference ``context.py:148``)."""
    return Context(3, device_id)


def num_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu(device_id: int = 0) -> Context:
    """The ``device_id``-th CUDA card; raises when there is none."""
    n = num_gpus()
    if device_id >= n:
        raise MXNetError(
            f"gpu({device_id}) requested but {n} CUDA device(s) are "
            "available; pass ctx=mx.cpu() to run on the CPU")
    return Context(2, device_id)


def current_context() -> Context:
    """The default context: the innermost ``with ctx:`` scope of this
    thread, else ``gpu(0)`` (reference ``context.py:180``, whose default
    is ``cpu(0)``)."""
    ctx = getattr(Context._default_ctx, "value", None)
    return gpu(0) if ctx is None else ctx


def resolve_device(ctx=None) -> torch.device:
    """``ctx`` as a concrete ``torch.device``: ``None`` is ``gpu(0)``; a
    :class:`Context`, a ``torch.device`` or a device string is checked
    the same way."""
    if ctx is None:
        ctx = gpu(0)
    if isinstance(ctx, Context):
        return ctx.torch_device()
    return Context.from_device(torch.device(ctx)).torch_device()
