"""Convolution and pooling layers of the ResNet path.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` for ``Conv2D``
(``:91``, ``:160``), ``MaxPool2D`` (``:258``) and ``GlobalAvgPool2D``
(``:329``). As the port's other layers, they are ``nn.Module``s with
their shapes given at construction (``in_channels`` is required) and an
explicit device and dtype.

Layout: each layer takes a ``layout=`` argument (``"NCHW"``, the
default, or ``"NHWC"``); the reference's ``conv_layout(...)`` context,
which changes the default of every layer built inside it, has no
counterpart: a model passes its layout down to each layer (see
``model_zoo.vision.ResNetV1``). The weight is ``(channels,
in_channels, kh, kw)`` in both layouts; under ``"NHWC"`` it is stored in
torch's ``channels_last`` memory format, the order cuDNN reads for a
channels-last input, so no call reorders it.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import nn as ops

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(nn.Module):
    """2-D convolution ``conv(x, weight) + bias``, ungrouped and
    undilated (ROADMAP.md, port queue 1, item 6)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 layout="NCHW", use_bias=True, in_channels=0, device=None,
                 dtype=None):
        super().__init__()
        if not in_channels:
            raise ValueError("Conv2D: in_channels is required (the port "
                             "has no deferred initialisation)")
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"Conv2D: layout {layout!r} is not NCHW or NHWC")
        self._kwargs = {"kernel": _pair(kernel_size),
                        "stride": _pair(strides), "pad": _pair(padding),
                        "num_filter": channels, "layout": layout}
        fmt = torch.channels_last if layout == "NHWC" else \
            torch.contiguous_format
        self.weight = nn.Parameter(torch.empty(
            (channels, in_channels) + self._kwargs["kernel"],
            device=device, dtype=dtype, memory_format=fmt))
        self.bias = (nn.Parameter(torch.zeros(channels, device=device,
                                              dtype=dtype))
                     if use_bias else None)

    def forward(self, x):
        return ops.convolution(x, self.weight, self.bias,
                               no_bias=self.bias is None, **self._kwargs)

    def extra_repr(self):
        k = self._kwargs
        return (f"{self.weight.shape[1]} -> "
                f"{k['num_filter']}, kernel_size={k['kernel']}, "
                f"stride={k['stride']}, padding={k['pad']}, "
                f"layout={k['layout']}")


class MaxPool2D(nn.Module):
    """Max pooling, MXNet's ``"valid"`` convention, padded with -inf."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW"):
        super().__init__()
        pool_size = _pair(pool_size)
        self._kwargs = {"kernel": pool_size,
                        "stride": pool_size if strides is None
                        else _pair(strides),
                        "pad": _pair(padding), "pool_type": "max",
                        "layout": layout}

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)

    def extra_repr(self):
        k = self._kwargs
        return (f"size={k['kernel']}, stride={k['stride']}, "
                f"padding={k['pad']}, layout={k['layout']}")


class GlobalAvgPool2D(nn.Module):
    """The mean over both spatial axes, kept as size 1."""

    def __init__(self, layout="NCHW"):
        super().__init__()
        self._layout = layout

    def forward(self, x):
        return ops.pooling(x, pool_type="avg", global_pool=True,
                           layout=self._layout)

    def extra_repr(self):
        return f"layout={self._layout}"
