"""SqueezeNet 1.0 and 1.1 (counterpart of ``mxnet_tpu/gluon/model_zoo/
vision/squeezenet.py``): fire modules (a 1x1 squeeze, then 1x1 and 3x3
expands concatenated on the channels) between ``ceil_mode`` max pools
(the ``full`` convention), dropout 0.5, and a 1x1 classifier convolution
with ReLU and global pooling, with the reference's module tree.
``layout``, ``ctx``, ``dtype`` and ``generator`` as the other families
(``mobilenet.py``)."""
from __future__ import annotations

import os

from ...block import HybridBlock
from ... import nn
from ._layout import Layers, Net, build

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1",
           "get_squeezenet"]


def _make_fire(mk, squeeze_channels, expand1x1_channels,
               expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(mk, squeeze_channels, 1))
    out.add(_FireExpand(mk, expand1x1_channels, expand3x3_channels))
    return out


def _make_fire_conv(mk, channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(mk.conv(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    """The fire module's 1x1 and 3x3 expands, concatenated on the
    channels."""

    def __init__(self, mk, expand1x1_channels, expand3x3_channels,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = mk.axis
        self.p1 = _make_fire_conv(mk, expand1x1_channels, 1)
        self.p3 = _make_fire_conv(mk, expand3x3_channels, 3, 1)

    def hybrid_forward(self, F, x):
        return F.concat(self.p1(x), self.p3(x), dim=self._axis)


class SqueezeNet(Net):
    """SqueezeNet ("SqueezeNet: AlexNet-level accuracy with 50x fewer
    parameters and <0.5MB model size"), ``version`` 1.0 or 1.1."""

    def __init__(self, version, classes=1000, layout="NCHW", ctx=None,
                 dtype=None, generator=None, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise ValueError(f"Unsupported SqueezeNet version {version}: "
                             "1.0 or 1.1 expected")
        mk = Layers(layout, "SqueezeNet")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            add = self.features.add
            if version == "1.0":
                add(mk.conv(96, kernel_size=7, strides=2))
                add(nn.Activation("relu"))
                add(mk.max_pool(pool_size=3, strides=2, ceil_mode=True))
                add(_make_fire(mk, 16, 64, 64))
                add(_make_fire(mk, 16, 64, 64))
                add(_make_fire(mk, 32, 128, 128))
                add(mk.max_pool(pool_size=3, strides=2, ceil_mode=True))
                add(_make_fire(mk, 32, 128, 128))
                add(_make_fire(mk, 48, 192, 192))
                add(_make_fire(mk, 48, 192, 192))
                add(_make_fire(mk, 64, 256, 256))
                add(mk.max_pool(pool_size=3, strides=2, ceil_mode=True))
                add(_make_fire(mk, 64, 256, 256))
            else:
                add(mk.conv(64, kernel_size=3, strides=2))
                add(nn.Activation("relu"))
                add(mk.max_pool(pool_size=3, strides=2, ceil_mode=True))
                add(_make_fire(mk, 16, 64, 64))
                add(_make_fire(mk, 16, 64, 64))
                add(mk.max_pool(pool_size=3, strides=2, ceil_mode=True))
                add(_make_fire(mk, 32, 128, 128))
                add(_make_fire(mk, 32, 128, 128))
                add(mk.max_pool(pool_size=3, strides=2, ceil_mode=True))
                add(_make_fire(mk, 48, 192, 192))
                add(_make_fire(mk, 48, 192, 192))
                add(_make_fire(mk, 64, 256, 256))
                add(_make_fire(mk, 64, 256, 256))
            add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(mk.conv(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(mk.global_avg_pool())
            self.output.add(nn.Flatten())
        self._finish(layout, ctx, dtype, generator)


def get_squeezenet(version, pretrained=False, ctx=None,
                   root=os.path.join("~", ".mxnet", "models"), **kwargs):
    """SqueezeNet ``version``; ``pretrained`` loads
    ``squeezenet{version}`` from the local model store."""
    return build(SqueezeNet, f"squeezenet{version}", (version,), pretrained,
                 ctx, root, **kwargs)


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
