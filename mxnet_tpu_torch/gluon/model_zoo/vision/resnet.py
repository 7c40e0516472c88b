"""ResNet v1 and v2 for the vision model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` for
``BasicBlockV1`` (``:29``), ``BottleneckV1`` (``:56``), ``BasicBlockV2``
(``:87``), ``BottleneckV2`` (``:114``), ``ResNetV1`` (``:148``),
``ResNetV2`` (``:193``), ``get_resnet`` (``:258``), ``resnet18_v1`` ...
``resnet152_v1`` and ``resnet18_v2`` ... ``resnet152_v2``, with the
reference's module tree (``features``, ``body``, ``downsample``,
``output``; stages ``stage1_``...; v2's ``bn1``/``conv1``...) and so its
parameter and structural names. In this v1 the bottleneck's stride sits
on its first 1x1 convolution (``:62``), not on the 3x3 as in
torchvision's "v1.5"; v2 ("Identity Mappings in Deep Residual
Networks") is pre-activation, its stride on the 3x3, its data
normalised by a first BatchNorm without scale or shift.

``layout="NHWC"`` builds the model channels-last inside with NCHW at the
API edge, as the reference: the forward turns the (N, 3, H, W) input
into torch's ``channels_last`` memory format once and runs every layer
on its (N, H, W, C) view (convolution weights stored channels-last too);
``layout`` is passed down to every layer, there is no ``conv_layout``
context. The shapes are given (no deferred ``in_channels``), so
``initialize`` allocates at once. ``ctx=``, ``dtype=`` and
``generator=`` at construction initialize at once as the reference's
default initializer does (``Uniform(0.07)`` weights, zero biases and
beta, unit gamma, running statistics zero and one), BatchNorm in
float32 under a half-precision ``dtype``.
"""
from __future__ import annotations

import os

from .... import initializer
from ....base import MXNetError
from ...block import HybridBlock
from ... import nn
from .._build import materialize
from ._layout import nhwc_input

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BottleneckV1",
           "BasicBlockV2", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]


class _Layers:
    """Builds the layers of one model in its layout."""

    def __init__(self, layout):
        self.layout = layout

    def conv(self, channels, kernel, stride, pad, in_channels):
        return nn.Conv2D(channels, kernel, stride, pad, use_bias=False,
                         in_channels=in_channels, layout=self.layout)

    def bn(self, channels, scale=True, center=True):
        return nn.BatchNorm(axis=-1 if self.layout == "NHWC" else 1,
                            in_channels=channels, scale=scale,
                            center=center)


class _Residual(HybridBlock):
    def hybrid_forward(self, F, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.Activation(self.body(x) + residual, act_type="relu")


def _downsample(channels, stride, in_channels, layers):
    ds = nn.HybridSequential(prefix="")
    ds.add(layers.conv(channels, 1, stride, 0, in_channels),
           layers.bn(channels))
    return ds


class BasicBlockV1(_Residual):
    """Two 3x3 convolutions (18/34-layer v1), the stride on the first."""

    def __init__(self, channels, stride, downsample, in_channels, layers,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(layers.conv(channels, 3, stride, 1, in_channels),
                      layers.bn(channels), nn.Activation("relu"),
                      layers.conv(channels, 3, 1, 1, channels),
                      layers.bn(channels))
        self.downsample = _downsample(channels, stride, in_channels,
                                      layers) if downsample else None


class BottleneckV1(_Residual):
    """1x1-3x3-1x1 bottleneck (50/101/152-layer v1), the stride on the
    first 1x1."""

    def __init__(self, channels, stride, downsample, in_channels, layers,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(layers.conv(mid, 1, stride, 0, in_channels),
                      layers.bn(mid), nn.Activation("relu"),
                      layers.conv(mid, 3, 1, 1, mid), layers.bn(mid),
                      nn.Activation("relu"),
                      layers.conv(channels, 1, 1, 0, mid),
                      layers.bn(channels))
        self.downsample = _downsample(channels, stride, in_channels,
                                      layers) if downsample else None


class _ResidualV2(HybridBlock):
    """Pre-activation: BatchNorm and ReLU before each convolution, the
    downsample taken from the first activation, no ReLU after the
    sum."""

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = self.conv2(F.Activation(self.bn2(x), act_type="relu"))
        if hasattr(self, "conv3"):
            x = self.conv3(F.Activation(self.bn3(x), act_type="relu"))
        return x + residual


class BasicBlockV2(_ResidualV2):
    """Pre-activation residual block (18/34-layer v2), the stride on the
    first 3x3."""

    def __init__(self, channels, stride, downsample, in_channels, layers,
                 **kwargs):
        super().__init__(**kwargs)
        self.bn1 = layers.bn(in_channels)
        self.conv1 = layers.conv(channels, 3, stride, 1, in_channels)
        self.bn2 = layers.bn(channels)
        self.conv2 = layers.conv(channels, 3, 1, 1, channels)
        self.downsample = layers.conv(channels, 1, stride, 0, in_channels) \
            if downsample else None


class BottleneckV2(_ResidualV2):
    """Pre-activation bottleneck (50/101/152-layer v2), the stride on
    the 3x3."""

    def __init__(self, channels, stride, downsample, in_channels, layers,
                 **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = layers.bn(in_channels)
        self.conv1 = layers.conv(mid, 1, 1, 0, in_channels)
        self.bn2 = layers.bn(mid)
        self.conv2 = layers.conv(mid, 3, stride, 1, mid)
        self.bn3 = layers.bn(mid)
        self.conv3 = layers.conv(channels, 1, 1, 0, mid)
        self.downsample = layers.conv(channels, 1, stride, 0, in_channels) \
            if downsample else None


class ResNetV1(HybridBlock):
    """ResNet v1 ("Deep Residual Learning for Image Recognition").

    ``block``: :class:`BasicBlockV1` or :class:`BottleneckV1`;
    ``layers``: blocks per stage; ``channels``: the stem's width, then
    each stage's. ``thumbnail`` replaces the 7x7 stride-2 stem, its
    BatchNorm and the max pool by one 3x3 convolution (small images).
    ``forward(x)``: (N, 3, H, W) images in the model's dtype (NCHW in
    both layouts) to (N, classes) logits. ``ctx``, ``dtype``,
    ``generator``: see the module docstring."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", prefix=None, params=None,
                 ctx=None, dtype=None, generator=None):
        super().__init__(prefix=prefix, params=params)
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV1: one channel count per stage, after "
                             "the stem's")
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"ResNetV1: layout {layout!r} is not NCHW or "
                             "NHWC")
        self._layout = layout
        mk = _Layers(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(mk.conv(channels[0], 3, 1, 1, 3))
            else:
                self.features.add(mk.conv(channels[0], 7, 2, 3, 3),
                                  mk.bn(channels[0]), nn.Activation("relu"),
                                  nn.MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                stage = nn.HybridSequential(prefix=f"stage{i + 1}_")
                in_c, out_c = channels[i], channels[i + 1]
                with stage.name_scope():
                    stage.add(block(out_c, 1 if i == 0 else 2,
                                    out_c != in_c, in_c, mk, prefix=""))
                    for _ in range(num_layer - 1):
                        stage.add(block(out_c, 1, False, out_c, mk,
                                        prefix=""))
                self.features.add(stage)
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1])
        materialize(self, ctx, dtype, generator, initializer.Uniform(0.07))

    def hybrid_forward(self, F, x):
        if self._layout == "NHWC":
            x = nhwc_input(x)
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ResNet v2 ("Identity Mappings in Deep Residual Networks"): the
    input normalised by a BatchNorm without scale or shift, the stem,
    the pre-activation stages, a last BatchNorm and ReLU, global average
    pooling, flatten and the classifier. Arguments as :class:`ResNetV1`
    (``block``: :class:`BasicBlockV2` or :class:`BottleneckV2`); the
    thumbnail stem is one 3x3 convolution."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", prefix=None, params=None,
                 ctx=None, dtype=None, generator=None):
        super().__init__(prefix=prefix, params=params)
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV2: one channel count per stage, after "
                             "the stem's")
        if layout not in ("NCHW", "NHWC"):
            raise ValueError(f"ResNetV2: layout {layout!r} is not NCHW or "
                             "NHWC")
        self._layout = layout
        mk = _Layers(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(mk.bn(3, scale=False, center=False))
            if thumbnail:
                self.features.add(mk.conv(channels[0], 3, 1, 1, 3))
            else:
                self.features.add(mk.conv(channels[0], 7, 2, 3, 3),
                                  mk.bn(channels[0]), nn.Activation("relu"),
                                  nn.MaxPool2D(3, 2, 1, layout=layout))
            in_c = channels[0]
            for i, num_layer in enumerate(layers):
                stage = nn.HybridSequential(prefix=f"stage{i + 1}_")
                out_c = channels[i + 1]
                with stage.name_scope():
                    stage.add(block(out_c, 1 if i == 0 else 2,
                                    out_c != in_c, in_c, mk, prefix=""))
                    for _ in range(num_layer - 1):
                        stage.add(block(out_c, 1, False, out_c, mk,
                                        prefix=""))
                self.features.add(stage)
                in_c = out_c
            self.features.add(mk.bn(in_c), nn.Activation("relu"),
                              nn.GlobalAvgPool2D(layout=layout),
                              nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_c)
        materialize(self, ctx, dtype, generator, initializer.Uniform(0.07))

    def hybrid_forward(self, F, x):
        if self._layout == "NHWC":
            x = nhwc_input(x)
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_VERSIONS = {1: (ResNetV1, {"basic_block": BasicBlockV1,
                            "bottle_neck": BottleneckV1}),
             2: (ResNetV2, {"basic_block": BasicBlockV2,
                            "bottle_neck": BottleneckV2})}


def get_resnet(version, num_layers, pretrained=False, ctx=None,
               root=os.path.join("~", ".mxnet", "models"), **kwargs):
    """ResNet v``version`` (1 or 2) with ``num_layers`` layers
    (reference ``get_resnet``); ``kwargs`` go to :class:`ResNetV1` or
    :class:`ResNetV2`. ``pretrained=True`` loads
    ``resnet{num_layers}_v{version}``'s ``.params`` file through
    :mod:`~mxnet_tpu_torch.gluon.model_zoo.model_store` (a file under
    ``root`` the user already has, sha1-checked; nothing is downloaded)
    onto ``ctx``."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"Invalid number of layers: {num_layers}. Options "
                         f"are {sorted(resnet_spec)}")
    if version not in _VERSIONS:
        raise MXNetError(f"Invalid resnet version: {version}.")
    block_type, layers, channels = resnet_spec[num_layers]
    net_class, blocks = _VERSIONS[version]
    if not pretrained:
        kwargs["ctx"] = ctx
    net = net_class(blocks[block_type], layers, channels, **kwargs)
    if pretrained:
        from ..model_store import get_model_file

        net.load_parameters(
            get_model_file(f"resnet{num_layers}_v{version}", root=root),
            ctx=ctx)
    return net


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


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
