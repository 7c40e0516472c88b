"""VGG 11/13/16/19, with and without BatchNorm (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``): 3x3 convolutions (Xavier
weights) in five stages each closed by a 2x2 max pool, then two
4096-wide ``Dense`` with ReLU and dropout 0.5 and the classifier (normal
weights), with the reference's module tree. ``layout``, ``ctx``,
``dtype`` and ``generator`` as the other families (``mobilenet.py``);
under NHWC the first ``Dense`` flattens the map in channels-first order,
so the weights are the NCHW model's."""
from __future__ import annotations

import os

from ... import nn
from ._layout import Layers, Net, build

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(Net):
    """VGG ("Very Deep Convolutional Networks for Large-Scale Image
    Recognition"): ``layers`` convolutions per stage of ``filters``
    channels, ``batch_norm`` after each."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 layout="NCHW", ctx=None, dtype=None, generator=None,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("VGG: one filter count per stage")
        mk = Layers(layout, "VGG")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for i, num in enumerate(layers):
                for _ in range(num):
                    self.features.add(mk.conv(
                        filters[i], kernel_size=3, padding=1,
                        weight_initializer="xavier",
                        bias_initializer="zeros"))
                    if batch_norm:
                        self.features.add(mk.bn())
                    self.features.add(nn.Activation("relu"))
                self.features.add(mk.max_pool(strides=2))
            self.features.add(mk.dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")
        self._finish(layout, ctx, dtype, generator)


vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_vgg(num_layers, pretrained=False, ctx=None,
            root=os.path.join("~", ".mxnet", "models"), **kwargs):
    """VGG-``num_layers``; ``pretrained`` loads ``vgg{n}`` (``vgg{n}_bn``
    with ``batch_norm``) from the local model store."""
    layers, filters = vgg_spec[num_layers]
    name = f"vgg{num_layers}" + ("_bn" if kwargs.get("batch_norm") else "")
    return build(VGG, name, (layers, filters), pretrained, ctx, root,
                 **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
