"""Inception v3 (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/
inception.py``): the stem, the A/B/C/D/E blocks as ``HybridConcurrent``
branches concatenated on the channels, an 8x8 average pool, dropout 0.5
and the classifier, with the reference's module tree (``A1_`` ...
``E2_``). Its branches' ``AvgPool2D(3, 1, 1)`` count the padding
(MXNet's default). ``layout``, ``ctx``, ``dtype`` and ``generator`` as
the other families (``mobilenet.py``)."""
from __future__ import annotations

import os

from ...block import HybridBlock
from ... import nn
from ...contrib.nn import HybridConcurrent
from ._layout import Layers, Net, build

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(mk, **kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(mk.conv(use_bias=False, **kwargs))
    out.add(mk.bn(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(mk, use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(mk.avg_pool(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(mk.max_pool(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {setting_names[i]: value for i, value in enumerate(setting)
                  if value is not None}
        out.add(_make_basic_conv(mk, **kwargs))
    return out


def _make_A(mk, pool_features, prefix):
    out = HybridConcurrent(axis=mk.axis, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(mk, None, (64, 1, None, None)))
        out.add(_make_branch(mk, None, (48, 1, None, None),
                             (64, 5, None, 2)))
        out.add(_make_branch(mk, None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, None, 1)))
        out.add(_make_branch(mk, "avg", (pool_features, 1, None, None)))
    return out


def _make_B(mk, prefix):
    out = HybridConcurrent(axis=mk.axis, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(mk, None, (384, 3, 2, None)))
        out.add(_make_branch(mk, None, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, 2, None)))
        out.add(_make_branch(mk, "max"))
    return out


def _make_C(mk, channels_7x7, prefix):
    out = HybridConcurrent(axis=mk.axis, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(mk, None, (192, 1, None, None)))
        out.add(_make_branch(mk, None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(mk, None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch(mk, "avg", (192, 1, None, None)))
    return out


def _make_D(mk, prefix):
    out = HybridConcurrent(axis=mk.axis, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(mk, None, (192, 1, None, None),
                             (320, 3, 2, None)))
        out.add(_make_branch(mk, None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch(mk, "max"))
    return out


class _SplitConcat(HybridBlock):
    """A branch whose tail splits into a 1x3 and a 3x1 convolution,
    concatenated on the channels."""

    def __init__(self, mk, head_settings, **kwargs):
        super().__init__(**kwargs)
        self._axis = mk.axis
        self.head = _make_branch(mk, None, *head_settings) \
            if head_settings else None
        self.t1 = _make_branch(mk, None, (384, (1, 3), None, (0, 1)))
        self.t2 = _make_branch(mk, None, (384, (3, 1), None, (1, 0)))

    def hybrid_forward(self, F, x):
        if self.head is not None:
            x = self.head(x)
        return F.concat(self.t1(x), self.t2(x), dim=self._axis)


def _make_E(mk, prefix):
    out = HybridConcurrent(axis=mk.axis, prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(mk, None, (320, 1, None, None)))
        out.add(_SplitConcat(mk, [(384, 1, None, None)]))
        out.add(_SplitConcat(mk, [(448, 1, None, None), (384, 3, None, 1)]))
        out.add(_make_branch(mk, "avg", (192, 1, None, None)))
    return out


class Inception3(Net):
    """Inception v3 ("Rethinking the Inception Architecture for Computer
    Vision"), for 299x299 inputs."""

    def __init__(self, classes=1000, layout="NCHW", ctx=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "Inception3")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            add = self.features.add
            add(_make_basic_conv(mk, channels=32, kernel_size=3, strides=2))
            add(_make_basic_conv(mk, channels=32, kernel_size=3))
            add(_make_basic_conv(mk, channels=64, kernel_size=3, padding=1))
            add(mk.max_pool(pool_size=3, strides=2))
            add(_make_basic_conv(mk, channels=80, kernel_size=1))
            add(_make_basic_conv(mk, channels=192, kernel_size=3))
            add(mk.max_pool(pool_size=3, strides=2))
            add(_make_A(mk, 32, "A1_"))
            add(_make_A(mk, 64, "A2_"))
            add(_make_A(mk, 64, "A3_"))
            add(_make_B(mk, "B_"))
            add(_make_C(mk, 128, "C1_"))
            add(_make_C(mk, 160, "C2_"))
            add(_make_C(mk, 160, "C3_"))
            add(_make_C(mk, 192, "C4_"))
            add(_make_D(mk, "D_"))
            add(_make_E(mk, "E1_"))
            add(_make_E(mk, "E2_"))
            add(mk.avg_pool(pool_size=8))
            add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)
        self._finish(layout, ctx, dtype, generator)


def inception_v3(pretrained=False, ctx=None,
                 root=os.path.join("~", ".mxnet", "models"), **kwargs):
    """Inception v3; ``pretrained`` loads ``inceptionv3`` from the local
    model store."""
    return build(Inception3, "inceptionv3", (), pretrained, ctx, root,
                 **kwargs)
