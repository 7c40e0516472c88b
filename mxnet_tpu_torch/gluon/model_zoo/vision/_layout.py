"""What every vision family of the port shares: its layout's layers, the
NCHW input turned channels-last once, the flatten before a classifier
in one order for both layouts, and the ``pretrained`` getter.

A family built with ``layout="NHWC"`` runs channels-last inside with
NCHW at the API edge, as the ResNets do: every convolution, pool and
BatchNorm gets the layout (BatchNorm ``axis=-1``), a channel
concatenation runs on the last axis, and the weights are the NCHW
model's, so one ``.params`` file serves both. A flatten of a spatial map
into a ``Dense`` (VGG, AlexNet) reads it in channels-first order under
both layouts for that reason.
"""
from __future__ import annotations

import os

import torch

from .... import initializer
from ....ndarray import NDArray
from ...block import HybridBlock
from ... import nn
from .._build import materialize


def nhwc_input(x):
    """NCHW at the API edge, channels-last inside: one reorder into
    torch's ``channels_last`` memory, then the (N, H, W, C) view."""
    t = x._data if isinstance(x, NDArray) else x
    t = t.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    return NDArray(t) if isinstance(x, NDArray) else t


class Layers:
    """Builds one model's layers in its layout (``NCHW`` or ``NHWC``)."""

    def __init__(self, layout, family):
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"{family}: layout {layout!r} is not NCHW or "
                             "NHWC")
        self.layout = layout
        self.last = layout == "NHWC"
        self.axis = -1 if self.last else 1

    def conv(self, *args, **kwargs):
        return nn.Conv2D(*args, layout=self.layout, **kwargs)

    def bn(self, **kwargs):
        return nn.BatchNorm(axis=self.axis, **kwargs)

    def max_pool(self, *args, **kwargs):
        return nn.MaxPool2D(*args, layout=self.layout, **kwargs)

    def avg_pool(self, *args, **kwargs):
        return nn.AvgPool2D(*args, layout=self.layout, **kwargs)

    def global_avg_pool(self):
        return nn.GlobalAvgPool2D(layout=self.layout)

    def flatten(self):
        return ChannelsFirstFlatten(self.last)

    def dense(self, *args, **kwargs):
        return ChannelsFirstDense(self.last, *args, **kwargs)


def _channels_first(F, x):
    return F.transpose(x, axes=(0, 3, 1, 2))


class ChannelsFirstFlatten(nn.Flatten):
    """``Flatten``, of a channels-last map in channels-first order."""

    def __init__(self, channels_last=False, **kwargs):
        super().__init__(**kwargs)
        self._channels_last = channels_last

    def _alias(self):
        return "flatten"

    def hybrid_forward(self, F, x):
        if self._channels_last and len(x.shape) == 4:
            x = _channels_first(F, x)
        return F.Flatten(x)


class ChannelsFirstDense(nn.Dense):
    """``Dense`` whose flatten reads a channels-last map in
    channels-first order, so its weight is the NCHW model's."""

    def __init__(self, channels_last, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._channels_last = channels_last

    def _alias(self):
        return "dense"

    def hybrid_forward(self, F, x, weight, bias=None):
        if self._channels_last and len(x.shape) == 4:
            x = _channels_first(F, x)
        return super().hybrid_forward(F, x, weight, bias)


class Net(HybridBlock):
    """A classifier ``output(features(x))``, NCHW at the edge; a family's
    ``__init__`` builds ``features`` and ``output``, then calls
    :meth:`_finish`."""

    def _finish(self, layout, ctx, dtype, generator):
        self._layout = layout
        materialize(self, ctx, dtype, generator, initializer.Uniform(0.07))

    def hybrid_forward(self, F, x):
        if self._layout == "NHWC":
            x = nhwc_input(x)
        return self.output(self.features(x))


def build(cls, name, args, pretrained=False, ctx=None,
          root=os.path.join("~", ".mxnet", "models"), **kwargs):
    """``cls(*args, **kwargs)``, initialized on ``ctx`` (see
    ``_build.materialize``), or with ``pretrained`` loaded with
    ``name``'s ``.params`` file from the local model store (sha1-checked,
    nothing downloaded) onto ``ctx``."""
    if not pretrained:
        return cls(*args, ctx=ctx, **kwargs)
    from ..model_store import get_model_file

    net = cls(*args, **kwargs)
    net.load_parameters(get_model_file(name, root=root), ctx=ctx)
    return net
