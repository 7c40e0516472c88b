"""DenseNet 121/161/169/201 (counterpart of ``mxnet_tpu/gluon/model_zoo/
vision/densenet.py``): a 7x7 stem and max pool, dense blocks whose
layers (BN-ReLU-1x1-BN-ReLU-3x3) concatenate their output to their input
on the channels, transitions (BN-ReLU-1x1, 2x2 average pool) halving the
width, a last BN-ReLU and a 7x7 average pool, with the reference's module
tree. ``layout``, ``ctx``, ``dtype`` and ``generator`` as the other
families (``mobilenet.py``)."""
from __future__ import annotations

import os

from ...block import HybridBlock
from ... import nn
from ._layout import Layers, Net, build

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "get_densenet"]


class _DenseLayer(HybridBlock):
    """BN-ReLU-Conv1x1-BN-ReLU-Conv3x3, its output concatenated to its
    input on the channels."""

    def __init__(self, growth_rate, bn_size, dropout, mk, **kwargs):
        super().__init__(**kwargs)
        self._axis = mk.axis
        self.body = nn.HybridSequential(prefix="")
        self.body.add(mk.bn())
        self.body.add(nn.Activation("relu"))
        self.body.add(mk.conv(bn_size * growth_rate, kernel_size=1,
                              use_bias=False))
        self.body.add(mk.bn())
        self.body.add(nn.Activation("relu"))
        self.body.add(mk.conv(growth_rate, kernel_size=3, padding=1,
                              use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=self._axis)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout, stage_index,
                      mk):
    out = nn.HybridSequential(prefix=f"stage{stage_index}_")
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout, mk))
    return out


def _make_transition(num_output_features, mk):
    out = nn.HybridSequential(prefix="")
    out.add(mk.bn())
    out.add(nn.Activation("relu"))
    out.add(mk.conv(num_output_features, kernel_size=1, use_bias=False))
    out.add(mk.avg_pool(pool_size=2, strides=2))
    return out


class DenseNet(Net):
    """DenseNet ("Densely Connected Convolutional Networks")."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, layout="NCHW", ctx=None,
                 dtype=None, generator=None, **kwargs):
        super().__init__(**kwargs)
        mk = Layers(layout, "DenseNet")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(mk.conv(num_init_features, kernel_size=7,
                                      strides=2, padding=3, use_bias=False))
            self.features.add(mk.bn())
            self.features.add(nn.Activation("relu"))
            self.features.add(mk.max_pool(pool_size=3, strides=2, padding=1))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1, mk))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2,
                                                       mk))
                    num_features = num_features // 2
            self.features.add(mk.bn())
            self.features.add(nn.Activation("relu"))
            self.features.add(mk.avg_pool(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)
        self._finish(layout, ctx, dtype, generator)


# num_init_features, growth_rate, block_config
densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def get_densenet(num_layers, pretrained=False, ctx=None,
                 root=os.path.join("~", ".mxnet", "models"), **kwargs):
    """DenseNet-``num_layers``; ``pretrained`` loads ``densenet{n}`` from
    the local model store."""
    return build(DenseNet, f"densenet{num_layers}",
                 densenet_spec[num_layers], pretrained, ctx, root, **kwargs)


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
