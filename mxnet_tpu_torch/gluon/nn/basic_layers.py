"""Basic layers of the BERT serving path.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` for ``Dense``,
``LayerNorm``, ``Embedding``, ``Dropout`` and ``HybridSequential``. They
are ``nn.Module``s built with an explicit device and dtype, with no
deferred initialisation: every shape is given at construction, so
``in_units`` and ``in_channels`` are required. Parameter names follow
MXNet (``weight``/``bias``, ``gamma``/``beta``), and Dense's weight is
(out, in), the layout ``mxnet_tpu_torch.convert`` carries across as is.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import autograd
from ...ops import nn as ops

__all__ = ["Dense", "LayerNorm", "Embedding", "Dropout", "HybridSequential"]


class Dense(nn.Module):
    """Fully-connected layer ``act(x @ weight.T + bias)``. With a bias
    and ``activation="gelu"`` the bias add and the GELU run as one fused
    kernel after the bias-free product (the JAX Dense's fused route,
    ``basic_layers.py:110-122``)."""

    def __init__(self, units, in_units, activation=None, use_bias=True,
                 flatten=True, device=None, dtype=None):
        super().__init__()
        self._units = int(units)
        self._flatten = bool(flatten)
        self._activation = activation
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(units, in_units, **kw))
        self.bias = (nn.Parameter(torch.zeros(units, **kw)) if use_bias
                     else None)

    def forward(self, x):
        if self.bias is not None and self._activation == "gelu":
            out = ops.fully_connected(x, self.weight, None,
                                      flatten=self._flatten)
            return ops.fused_bias_gelu_op(out, self.bias)
        out = ops.fully_connected(x, self.weight, self.bias,
                                  flatten=self._flatten)
        if self._activation is not None:
            out = ops.activation(out, act_type=self._activation)
        return out

    def extra_repr(self):
        return (f"{self._units}, in_units={self.weight.shape[1]}, "
                f"activation={self._activation}")


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (f32 statistics, the fused kernel on
    a CUDA tensor)."""

    def __init__(self, in_channels, epsilon=1e-5, device=None, dtype=None):
        super().__init__()
        self._epsilon = float(epsilon)
        kw = {"device": device, "dtype": dtype}
        self.gamma = nn.Parameter(torch.ones(in_channels, **kw))
        self.beta = nn.Parameter(torch.zeros(in_channels, **kw))

    def forward(self, x):
        return ops.layer_norm(x, self.gamma, self.beta, eps=self._epsilon)


class Embedding(nn.Module):
    """Lookup table; indices may arrive as floats and are truncated."""

    def __init__(self, input_dim, output_dim, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim,
                                               device=device, dtype=dtype))

    def forward(self, x):
        return ops.embedding(x, self.weight)


class Dropout(nn.Module):
    """Dropout at ``rate``, broadcast along ``axes``: ``ops.dropout`` in
    training mode (``autograd.is_training()``, which ``parallel.TrainStep``
    turns on), the identity otherwise (``basic_layers.py:81-95``)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = float(rate)
        self._axes = tuple(axes)

    def forward(self, x):
        if not autograd.is_training():
            return x
        return ops.dropout(x, p=self._rate, axes=self._axes)

    def extra_repr(self):
        return f"p={self._rate}, axes={self._axes}"


class HybridSequential(nn.Sequential):
    """An ordered container of blocks; children are named ``0``, ``1``,
    ... in the order :meth:`add` receives them."""

    def add(self, *blocks):
        for block in blocks:
            self.append(block)
