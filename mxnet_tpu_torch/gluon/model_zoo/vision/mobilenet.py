"""MobileNet v1, v2 and v3 for the vision model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py:1-314``:
``ReLU6``, ``HardSigmoid``, ``HardSwish`` (through the ``clip`` op,
``jnp.clip``'s half gradient on a bound), ``MobileNet`` (v1; the
multipliers 1.0, 0.75, 0.5, 0.25), ``LinearBottleneck``/``MobileNetV2``
(the same four) and ``_SEBlock``/``_MBV3Block``/``MobileNetV3`` (large
and small), with the reference's module tree and so its parameter and
structural names. Depthwise convolutions are ``Conv2D`` with ``groups``
equal to the channels (cuDNN's grouped kernels on the card).

Each family takes ``layout`` (``NCHW`` or ``NHWC``, NCHW at the API
edge either way) and ``ctx``, ``dtype``, ``generator`` at construction
as the ResNets do (``resnet.py``); shapes are deferred to the first
forward, as in the reference.
"""
from __future__ import annotations

import os

from ...block import HybridBlock
from ... import nn
from ._layout import Layers, Net, build

__all__ = ["MobileNet", "MobileNetV2", "MobileNetV3", "ReLU6",
           "HardSigmoid", "HardSwish", "LinearBottleneck",
           "mobilenet1_0", "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25", "mobilenet_v3_large", "mobilenet_v3_small",
           "get_mobilenet", "get_mobilenet_v2"]

_ROOT = os.path.join("~", ".mxnet", "models")


class ReLU6(HybridBlock):
    """``clip(x, 0, 6)``."""

    def hybrid_forward(self, F, x):
        return F.clip(x, 0, 6)


class HardSigmoid(HybridBlock):
    """``clip(x + 3, 0, 6) / 6``."""

    def hybrid_forward(self, F, x):
        return F.clip(x + 3.0, 0, 6) / 6.0


class HardSwish(HybridBlock):
    """``x * hard_sigmoid(x)``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.hsig = HardSigmoid()

    def hybrid_forward(self, F, x):
        return x * self.hsig(x)


def _add_conv(out, mk, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(mk.conv(channels, kernel, stride, pad, groups=num_group,
                    use_bias=False))
    out.add(mk.bn())
    if active:
        out.add(ReLU6() if relu6 else nn.Activation("relu"))


def _add_conv_dw(out, mk, dw_channels, channels, stride, relu6=False):
    _add_conv(out, mk, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, mk, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """MobileNet v2's inverted residual: 1x1 expansion by ``t``, a 3x3
    depthwise convolution, a linear 1x1 projection, and the shortcut
    where the stride is 1 and the width kept."""

    def __init__(self, in_channels, channels, t, stride, layout="NCHW",
                 **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "LinearBottleneck")
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, mk, in_channels * t, relu6=True)
            _add_conv(self.out, mk, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True)
            _add_conv(self.out, mk, channels, active=False, relu6=True)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(Net):
    """MobileNet v1 ("MobileNets: Efficient Convolutional Neural Networks
    for Mobile Vision Applications"), width ``multiplier``."""

    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 ctx=None, dtype=None, generator=None, **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "MobileNet")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, mk, channels=int(32 * multiplier),
                          kernel=3, pad=1, stride=2)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2 + [512] * 6
                               + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6
                            + [1024] * 2]
                strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, mk, dw_channels=dwc,
                                 channels=c, stride=s)
                self.features.add(mk.global_avg_pool())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)
        self._finish(layout, ctx, dtype, generator)


class MobileNetV2(Net):
    """MobileNet v2 ("MobileNetV2: Inverted Residuals and Linear
    Bottlenecks"), width ``multiplier``: 17 bottlenecks, a 1x1 to 1280
    (more above a multiplier of 1), global pooling and a 1x1 classifier
    convolution."""

    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 ctx=None, dtype=None, generator=None, **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "MobileNetV2")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, mk, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3
                                     + [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4
                                  + [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] + [1, 2] + [1] * 2 + [2] + [1] * 3 \
                    + [1] * 3 + [2] + [1] * 2 + [1]
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(LinearBottleneck(
                        in_channels=in_c, channels=c, t=t, stride=s,
                        layout=layout))
                last_channels = int(1280 * multiplier) \
                    if multiplier > 1.0 else 1280
                _add_conv(self.features, mk, last_channels, relu6=True)
                self.features.add(mk.global_avg_pool())
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(mk.conv(classes, 1, use_bias=False,
                                        prefix="pred_"))
                self.output.add(nn.Flatten())
        self._finish(layout, ctx, dtype, generator)


class _SEBlock(HybridBlock):
    """Squeeze-and-excitation for MobileNet v3: global pooling, a 1x1
    down by ``reduction`` with ReLU, a 1x1 back with a hard sigmoid, the
    input scaled per channel."""

    def __init__(self, channels, reduction=4, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "_SEBlock")
        self._shape = (0, 1, 1, -1) if mk.last else (0, -1, 1, 1)
        self.pool = mk.global_avg_pool()
        self.fc1 = mk.conv(channels // reduction, 1, use_bias=True)
        self.fc2 = mk.conv(channels, 1, use_bias=True)
        self.hsig = HardSigmoid()

    def hybrid_forward(self, F, x):
        w = F.reshape(self.pool(x), shape=self._shape)
        w = F.Activation(self.fc1(w), act_type="relu")
        w = self.hsig(self.fc2(w))
        return x * w


class _MBV3Block(HybridBlock):
    """MobileNet v3's block: an optional 1x1 expansion, a depthwise
    ``kernel`` convolution, an optional squeeze-and-excitation, a linear
    1x1 projection, the shortcut where the stride is 1 and the width
    kept; ReLU or hard swish (``act``)."""

    def __init__(self, in_channels, exp_channels, out_channels, kernel,
                 stride, se, act, layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "_MBV3Block")
        self.use_shortcut = stride == 1 and in_channels == out_channels

        def act_block():
            return HardSwish() if act == "hswish" else nn.Activation("relu")

        with self.name_scope():
            self.body = nn.HybridSequential()
            if exp_channels != in_channels:
                self.body.add(mk.conv(exp_channels, 1, use_bias=False))
                self.body.add(mk.bn())
                self.body.add(act_block())
            self.body.add(mk.conv(exp_channels, kernel, stride, kernel // 2,
                                  groups=exp_channels, use_bias=False))
            self.body.add(mk.bn())
            self.body.add(act_block())
            if se:
                self.body.add(_SEBlock(exp_channels, layout=layout))
            self.body.add(mk.conv(out_channels, 1, use_bias=False))
            self.body.add(mk.bn())

    def hybrid_forward(self, F, x):
        out = self.body(x)
        if self.use_shortcut:
            out = out + x
        return out


# (kernel, exp, out, se, act, stride)
_V3_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hswish", 2),
    (3, 200, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 184, 80, False, "hswish", 1),
    (3, 480, 112, True, "hswish", 1),
    (3, 672, 112, True, "hswish", 1),
    (5, 672, 160, True, "hswish", 2),
    (5, 960, 160, True, "hswish", 1),
    (5, 960, 160, True, "hswish", 1),
]
_V3_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hswish", 2),
    (5, 240, 40, True, "hswish", 1),
    (5, 240, 40, True, "hswish", 1),
    (5, 120, 48, True, "hswish", 1),
    (5, 144, 48, True, "hswish", 1),
    (5, 288, 96, True, "hswish", 2),
    (5, 576, 96, True, "hswish", 1),
    (5, 576, 96, True, "hswish", 1),
]


class MobileNetV3(Net):
    """MobileNet v3 ("Searching for MobileNetV3"), ``mode`` ``large`` or
    ``small``."""

    def __init__(self, mode="large", classes=1000, layout="NCHW", ctx=None,
                 dtype=None, generator=None, **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "MobileNetV3")
        cfg = _V3_LARGE if mode == "large" else _V3_SMALL
        last_exp = 960 if mode == "large" else 576
        last_ch = 1280 if mode == "large" else 1024
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(mk.conv(16, 3, 2, 1, use_bias=False))
            self.features.add(mk.bn())
            self.features.add(HardSwish())
            in_c = 16
            for k, exp, out, se, act, s in cfg:
                self.features.add(_MBV3Block(in_c, exp, out, k, s, se, act,
                                             layout=layout))
                in_c = out
            self.features.add(mk.conv(last_exp, 1, use_bias=False))
            self.features.add(mk.bn())
            self.features.add(HardSwish())
            self.features.add(mk.global_avg_pool())
            self.features.add(mk.conv(last_ch, 1, use_bias=True))
            self.features.add(HardSwish())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)
        self._finish(layout, ctx, dtype, generator)


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=_ROOT,
                  **kwargs):
    """MobileNet v1 at ``multiplier``; ``pretrained`` loads
    ``mobilenet{multiplier}`` from the local model store."""
    return build(MobileNet, f"mobilenet{multiplier}", (multiplier,),
                 pretrained, ctx, root, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, root=_ROOT,
                     **kwargs):
    """MobileNet v2 at ``multiplier``; ``pretrained`` loads
    ``mobilenetv2_{multiplier}`` from the local model store."""
    return build(MobileNetV2, f"mobilenetv2_{multiplier}", (multiplier,),
                 pretrained, ctx, root, **kwargs)


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)


def mobilenet_v3_large(pretrained=False, ctx=None, root=_ROOT, **kwargs):
    return build(MobileNetV3, "mobilenetv3_large", ("large",), pretrained,
                 ctx, root, **kwargs)


def mobilenet_v3_small(pretrained=False, ctx=None, root=_ROOT, **kwargs):
    return build(MobileNetV3, "mobilenetv3_small", ("small",), pretrained,
                 ctx, root, **kwargs)
