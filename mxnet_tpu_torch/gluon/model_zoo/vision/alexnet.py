"""AlexNet (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/
alexnet.py``): five convolutions with three 3x3 stride-2 max pools, two
4096-wide ``Dense`` with ReLU and dropout 0.5, and the classifier, with
the reference's module tree. ``layout``, ``ctx``, ``dtype`` and
``generator`` as the other families (``mobilenet.py``); under NHWC the
flatten reads the map in channels-first order."""
from __future__ import annotations

import os

from ... import nn
from ._layout import Layers, Net, build

__all__ = ["AlexNet", "alexnet"]


class AlexNet(Net):
    """AlexNet ("One weird trick for parallelizing convolutional neural
    networks")."""

    def __init__(self, classes=1000, layout="NCHW", ctx=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "AlexNet")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(mk.conv(64, kernel_size=11, strides=4,
                                          padding=2, activation="relu"))
                self.features.add(mk.max_pool(pool_size=3, strides=2))
                self.features.add(mk.conv(192, kernel_size=5, padding=2,
                                          activation="relu"))
                self.features.add(mk.max_pool(pool_size=3, strides=2))
                self.features.add(mk.conv(384, kernel_size=3, padding=1,
                                          activation="relu"))
                self.features.add(mk.conv(256, kernel_size=3, padding=1,
                                          activation="relu"))
                self.features.add(mk.conv(256, kernel_size=3, padding=1,
                                          activation="relu"))
                self.features.add(mk.max_pool(pool_size=3, strides=2))
                self.features.add(mk.flatten())
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)
        self._finish(layout, ctx, dtype, generator)


def alexnet(pretrained=False, ctx=None,
            root=os.path.join("~", ".mxnet", "models"), **kwargs):
    """AlexNet; ``pretrained`` loads ``alexnet`` from the local model
    store."""
    return build(AlexNet, "alexnet", (), pretrained, ctx, root, **kwargs)
