"""Basic layers of the BERT, Llama and ResNet paths.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` for ``Dense``,
``LayerNorm``, ``BatchNorm``, ``Embedding``, ``Dropout``, ``Flatten`` and
``HybridSequential``, and of ``activations.py``'s ``Activation``. They
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

__all__ = ["Dense", "LayerNorm", "BatchNorm", "Embedding", "Dropout",
           "Flatten", "Activation", "HybridSequential"]


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


class BatchNorm(nn.Module):
    """Batch normalisation over the channel ``axis`` (1; -1 for a
    channels-last model) with the reference's defaults (momentum 0.9,
    epsilon 1e-5; ``basic_layers.py:166-231``).

    ``gamma`` and ``beta`` are parameters (buffers of ones and zeros
    without ``scale`` / ``center``); ``running_mean`` and
    ``running_var`` are buffers, so ``parallel.TrainStep``, which sweeps
    the parameters that require a gradient, never touches them. They stay
    f32 under a half-precision ``dtype``, as the reference's
    ``BatchNorm.cast`` keeps them. In training mode
    (``autograd.is_training()``, which ``TrainStep`` turns on) the
    forward normalises by the batch statistics and folds them into the
    running ones in place, ``run * m + stat * (1 - m)`` (the reference's
    expression); otherwise it normalises by the running ones and moves
    nothing."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 device=None, dtype=None):
        super().__init__()
        if not in_channels:
            raise ValueError("BatchNorm: in_channels is required (the port "
                             "has no deferred initialisation)")
        self._axis = int(axis)
        self._momentum = float(momentum)
        self._epsilon = float(epsilon)
        self._scale = bool(scale)
        self._use_global_stats = bool(use_global_stats)
        if dtype in (torch.float16, torch.bfloat16):
            dtype = torch.float32
        kw = {"device": device, "dtype": dtype}
        gamma, beta = torch.ones(in_channels, **kw), \
            torch.zeros(in_channels, **kw)
        if scale:
            self.gamma = nn.Parameter(gamma)
        else:
            self.register_buffer("gamma", gamma)
        if center:
            self.beta = nn.Parameter(beta)
        else:
            self.register_buffer("beta", beta)
        self.register_buffer("running_mean", torch.zeros(in_channels, **kw))
        self.register_buffer("running_var", torch.ones(in_channels, **kw))

    def forward(self, x):
        ret = ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)
        if not isinstance(ret, tuple):
            return ret
        out, mean, var = ret
        m = self._momentum
        with torch.no_grad():
            for run, stat in ((self.running_mean, mean),
                              (self.running_var, var)):
                run.copy_(run * m + stat.to(run.dtype) * (1 - m))
        return out

    def extra_repr(self):
        return (f"{self.running_mean.shape[0]}, axis={self._axis}, "
                f"momentum={self._momentum}, eps={self._epsilon}")


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


class Flatten(nn.Module):
    """Every axis after the first folded into one."""

    def forward(self, x):
        return ops.flatten(x)


class Activation(nn.Module):
    """``Activation(act_type)`` (reference ``activations.py:14``) for the
    act_types ``ops.activation`` has."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return ops.activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class HybridSequential(nn.Sequential):
    """An ordered container of blocks; children are named ``0``, ``1``,
    ... in the order :meth:`add` receives them."""

    def add(self, *blocks):
        for block in blocks:
            self.append(block)
