"""ResNet v1 for the vision model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` for
``BasicBlockV1`` (``:29``), ``BottleneckV1`` (``:56``), ``ResNetV1``
(``:148``), ``get_resnet`` (``:258``) and ``resnet18_v1`` ...
``resnet152_v1``. In this v1 the bottleneck's stride sits on its first
1x1 convolution (``:62``), not on the 3x3 as in torchvision's "v1.5".
The module tree mirrors the reference's (``features``, ``body``,
``downsample``, ``output``), so
:func:`mxnet_tpu_torch.convert.resnet_params_from_reference` carries a
JAX model's parameters and running statistics across in construction
order.

``layout="NHWC"`` builds the model channels-last inside with NCHW at the
API edge, as the reference: the forward turns the (N, 3, H, W) input
into torch's ``channels_last`` memory format once and runs every layer
on its (N, H, W, C) view (convolution weights stored channels-last
too); ``layout`` is passed down to every layer, there is no
``conv_layout`` context. ResNet v2 waits in ``ROADMAP.md``.
"""
from __future__ import annotations

import torch
from torch import nn

from ....base import MXNetError, torch_dtype
from ....context import resolve_device
from ....ops import nn as ops
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1"]


class _Layers:
    """Builds the layers of one model with its layout, device and dtype."""

    def __init__(self, layout, device, dtype):
        self.layout = layout
        self.kw = {"device": device, "dtype": dtype}

    def conv(self, channels, kernel, stride, pad, in_channels):
        return Conv2D(channels, kernel, stride, pad, use_bias=False,
                      in_channels=in_channels, layout=self.layout,
                      **self.kw)

    def bn(self, channels):
        return BatchNorm(axis=-1 if self.layout == "NHWC" else 1,
                         in_channels=channels, **self.kw)


class BasicBlockV1(nn.Module):
    """Two 3x3 convolutions (18/34-layer v1), the stride on the first."""

    def __init__(self, channels, stride, downsample, in_channels, layers):
        super().__init__()
        self.body = HybridSequential()
        self.body.add(layers.conv(channels, 3, stride, 1, in_channels),
                      layers.bn(channels), Activation("relu"),
                      layers.conv(channels, 3, 1, 1, channels),
                      layers.bn(channels))
        self.downsample = _downsample(channels, stride, in_channels,
                                      layers) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return ops.activation(self.body(x) + residual, act_type="relu")


class BottleneckV1(nn.Module):
    """1x1-3x3-1x1 bottleneck (50/101/152-layer v1), the stride on the
    first 1x1."""

    def __init__(self, channels, stride, downsample, in_channels, layers):
        super().__init__()
        mid = channels // 4
        self.body = HybridSequential()
        self.body.add(layers.conv(mid, 1, stride, 0, in_channels),
                      layers.bn(mid), Activation("relu"),
                      layers.conv(mid, 3, 1, 1, mid), layers.bn(mid),
                      Activation("relu"),
                      layers.conv(channels, 1, 1, 0, mid),
                      layers.bn(channels))
        self.downsample = _downsample(channels, stride, in_channels,
                                      layers) if downsample else None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return ops.activation(self.body(x) + residual, act_type="relu")


def _downsample(channels, stride, in_channels, layers):
    ds = HybridSequential()
    ds.add(layers.conv(channels, 1, stride, 0, in_channels),
           layers.bn(channels))
    return ds


class ResNetV1(nn.Module):
    """ResNet v1 ("Deep Residual Learning for Image Recognition").

    ``block``: :class:`BasicBlockV1` or :class:`BottleneckV1`;
    ``layers``: blocks per stage; ``channels``: the stem's width, then
    each stage's. ``thumbnail`` replaces the 7x7 stride-2 stem, its
    BatchNorm and the max pool by one 3x3 convolution (small images).
    ``forward(x)``: (N, 3, H, W) images in the model's dtype (NCHW in
    both layouts) to (N, classes) logits.

    ``ctx``: the device (default: the card; ``mx.cpu()`` for the CPU).
    ``dtype``: the convolutions' and the classifier's dtype (BatchNorm
    keeps f32). ``generator``: the ``torch.Generator`` (on ``ctx``'s
    device) that draws the initial weights as the reference's default
    initializer does (``net.initialize()``: ``Uniform(0.07)``): every
    weight uniform in [-0.07, 0.07), biases and beta zero, gamma one;
    ``None`` uses torch's default generator."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", ctx=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV1: one channel count per stage, after "
                             "the stem's")
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"ResNetV1: layout {layout!r} is not NCHW or "
                             "NHWC")
        self._layout = layout
        device = resolve_device(ctx)
        mk = _Layers(layout, device, torch_dtype(dtype))
        self.features = HybridSequential()
        if thumbnail:
            self.features.add(mk.conv(channels[0], 3, 1, 1, 3))
        else:
            self.features.add(mk.conv(channels[0], 7, 2, 3, 3),
                              mk.bn(channels[0]), Activation("relu"),
                              MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stage = HybridSequential()
            in_c, out_c = channels[i], channels[i + 1]
            stride = 1 if i == 0 else 2
            stage.add(block(out_c, stride, out_c != in_c, in_c, mk))
            for _ in range(num_layer - 1):
                stage.add(block(out_c, 1, False, out_c, mk))
            self.features.add(stage)
        self.features.add(GlobalAvgPool2D(layout=layout))
        self.output = Dense(classes, channels[-1], **mk.kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        for name, p in self.named_parameters():
            if name.endswith("weight"):
                p.uniform_(-0.07, 0.07, generator=generator)
            elif name.endswith("bias"):
                p.zero_()

    def forward(self, x):
        if self._layout == "NHWC":
            # NCHW at the API edge, channels-last inside: one reorder
            x = x.contiguous(memory_format=torch.channels_last) \
                .permute(0, 2, 3, 1)
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_BLOCKS = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet v``version`` with ``num_layers`` layers (reference
    ``get_resnet``); ``kwargs`` go to :class:`ResNetV1`. Only v1 is
    ported, and no pretrained weights (no model store)."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version != 1:
        raise MXNetError(f"ResNet v{version} is not ported yet (ROADMAP.md, "
                         "port queue 1, item 8)")
    if pretrained:
        raise MXNetError("pretrained weights need the model store, not "
                         "ported yet (ROADMAP.md, port queue 1, item 10)")
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_BLOCKS[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)
