"""Contrib layers (counterpart of ``mxnet_tpu/gluon/contrib/nn``):
``Concurrent`` and ``HybridConcurrent`` (branches concatenated),
``Identity``, ``SyncBatchNorm`` and ``PixelShuffle2D``."""
from __future__ import annotations

from ...block import Block, HybridBlock
from ...nn.basic_layers import BatchNorm

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SyncBatchNorm",
           "PixelShuffle2D"]


class Concurrent(Block):
    """Each child on the same input, the outputs concatenated on
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        from .... import ndarray as F

        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class HybridConcurrent(HybridBlock):
    """:class:`Concurrent` as a hybridizable block."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.concat(*out, dim=self.axis)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class SyncBatchNorm(BatchNorm):
    """Batch normalization whose statistics span the devices of a
    data-parallel step. On one card it is :class:`BatchNorm` over axis 1,
    as the reference's is on one device; ``num_devices`` is kept."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(
            axis=1, momentum=momentum, epsilon=epsilon, center=center,
            scale=scale, use_global_stats=use_global_stats,
            beta_initializer=beta_initializer,
            gamma_initializer=gamma_initializer,
            running_mean_initializer=running_mean_initializer,
            running_variance_initializer=running_variance_initializer,
            in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class PixelShuffle2D(HybridBlock):
    """(n, c f^2, h, w) -> (n, c, h f, w f) through ``depth_to_space``."""

    def __init__(self, factor):
        super().__init__()
        self._factor = factor if isinstance(factor, int) else factor[0]

    def hybrid_forward(self, F, x):
        return F.depth_to_space(x, block_size=self._factor)
