"""Convolution and pooling layers of the port.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py:91-347``: the
``_Conv`` base with ``Conv1D``/``Conv2D``/``Conv3D`` (``dilation``,
``groups``) and ``Conv1DTranspose``/``Conv2DTranspose``/
``Conv3DTranspose`` (``output_padding``), ``MaxPool``/``AvgPool``
``1D``/``2D``/``3D`` (``ceil_mode`` is the ``full`` convention,
``count_include_pad``), ``GlobalMaxPool``/``GlobalAvgPool``
``1D``/``2D``/``3D`` and ``ReflectionPad2D``, with the reference's
signatures, parameter names and a deferred ``in_channels``.

``layout`` is one of the reference's six (``NCW``/``NWC``,
``NCHW``/``NHWC``, ``NCDHW``/``NDHWC``). A convolution's weight is
``(channels, in_channels / groups, *kernel)``, a transposed one's
``(in_channels, channels / groups, *kernel)``, in every layout, so a
checkpoint does not depend on it; under ``NHWC``/``NDHWC`` it is stored
in torch's ``channels_last``/``channels_last_3d`` memory format, the
order cuDNN reads beside a channels-last input, so no call reorders it.
The reference's ``conv_layout(...)`` context has no counterpart: a model
passes its layout to each layer.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ..block import HybridBlock
from .basic_layers import _make_activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}
_WEIGHT_FORMAT = {2: torch.channels_last, 3: torch.channels_last_3d}


def _tup(val, n):
    return (val,) * n if isinstance(val, int) else tuple(val)


def _check_layout(name, layout, ndim) -> bool:
    """Whether ``layout`` (one of ``ndim``'s two) puts channels last."""
    if layout not in _LAYOUTS[ndim]:
        raise MXNetError(f"{name}: layout {layout!r} is not one of "
                         f"{_LAYOUTS[ndim]}")
    return layout.endswith("C")


class _Conv(HybridBlock):
    """``act(conv(x, weight) + bias)`` through the ``Convolution`` or
    ``Deconvolution`` op (``op_name``)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        ndim = len(kernel_size)
        last = _check_layout(type(self).__name__, layout, ndim)
        self._channels = channels
        self._in_channels = in_channels
        self._layout = layout
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        with self.name_scope():
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups
                          if in_channels else 0) + tuple(kernel_size)
            else:
                wshape = (in_channels, channels // groups) + \
                    tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if last and ndim in _WEIGHT_FORMAT:
                self.weight._memory_format = _WEIGHT_FORMAT[ndim]
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None
            self.act = _make_activation(activation, self)

    def _infer_param_shapes(self, x, *rest):
        in_c = x.shape[-1 if self._layout.endswith("C") else 1]
        w = list(self.weight.shape)
        if self._op_name == "Convolution":
            w[1] = in_c // self._kwargs["num_group"]
        else:
            w[0] = in_c
        self.weight._finish_deferred_init(tuple(w))

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        out = op(x, weight, bias, no_bias=bias is None, **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def extra_repr(self):
        k = self._kwargs
        return (f"{self.weight.shape[1]} -> {self._channels}, "
                f"kernel_size={k['kernel']}, stride={k['stride']}, "
                f"padding={k['pad']}, layout={self._layout}")


class Conv1D(_Conv):
    """1-D convolution (layout ``NCW`` or ``NWC``)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    """2-D convolution (layout ``NCHW`` or ``NHWC``)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    """3-D convolution (layout ``NCDHW`` or ``NDHWC``)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    """1-D transposed convolution (the ``Deconvolution`` op)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), _tup(strides, 1),
                         _tup(padding, 1), _tup(dilation, 1), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tup(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    """2-D transposed convolution (the ``Deconvolution`` op)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tup(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    """3-D transposed convolution (the ``Deconvolution`` op)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), _tup(strides, 3),
                         _tup(padding, 3), _tup(dilation, 3), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_tup(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """The ``Pooling`` op with a window, stride (the window's by
    default), padding, ``ceil_mode`` (the ``full`` convention) and, for
    averages, ``count_include_pad``."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        _check_layout(type(self).__name__, layout, len(pool_size))
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else strides,
            "pad": padding, "pool_type": pool_type,
            "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def extra_repr(self):
        k = self._kwargs
        return (f"size={k['kernel']}, stride={k['stride']}, "
                f"padding={k['pad']}, layout={k['layout']}")


def _strides(strides, n):
    return None if strides is None else _tup(strides, n)


class MaxPool1D(_Pooling):
    """Max pooling over one axis, padded with -inf."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 1), _strides(strides, 1),
                         _tup(padding, 1), ceil_mode, False, "max", layout,
                         **kwargs)


class MaxPool2D(_Pooling):
    """Max pooling over two axes, padded with -inf."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2), _strides(strides, 2),
                         _tup(padding, 2), ceil_mode, False, "max", layout,
                         **kwargs)


class MaxPool3D(_Pooling):
    """Max pooling over three axes, padded with -inf."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 3), _strides(strides, 3),
                         _tup(padding, 3), ceil_mode, False, "max", layout,
                         **kwargs)


class AvgPool1D(_Pooling):
    """Average pooling over one axis."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tup(pool_size, 1), _strides(strides, 1),
                         _tup(padding, 1), ceil_mode, False, "avg", layout,
                         count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    """Average pooling over two axes (by default over the whole window,
    padding included, MXNet's ``count_include_pad``)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 2), _strides(strides, 2),
                         _tup(padding, 2), ceil_mode, False, "avg", layout,
                         count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    """Average pooling over three axes."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 3), _strides(strides, 3),
                         _tup(padding, 3), ceil_mode, False, "avg", layout,
                         count_include_pad, **kwargs)


class _GlobalPool(_Pooling):
    def __init__(self, ndim, pool_type, layout, **kwargs):
        super().__init__((1,) * ndim, (1,) * ndim, (0,) * ndim, False, True,
                         pool_type, layout, **kwargs)


class GlobalMaxPool1D(_GlobalPool):
    """The maximum over the spatial axis, kept as size 1."""

    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "max", layout, **kwargs)


class GlobalMaxPool2D(_GlobalPool):
    """The maximum over both spatial axes, kept as size 1."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "max", layout, **kwargs)


class GlobalMaxPool3D(_GlobalPool):
    """The maximum over the three spatial axes, kept as size 1."""

    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "max", layout, **kwargs)


class GlobalAvgPool1D(_GlobalPool):
    """The mean over the spatial axis, kept as size 1."""

    def __init__(self, layout="NCW", **kwargs):
        super().__init__(1, "avg", layout, **kwargs)


class GlobalAvgPool2D(_GlobalPool):
    """The mean over both spatial axes, kept as size 1."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__(2, "avg", layout, **kwargs)


class GlobalAvgPool3D(_GlobalPool):
    """The mean over the three spatial axes, kept as size 1."""

    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__(3, "avg", layout, **kwargs)


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the two spatial axes (``padding`` on every
    side, or MXNet's 8-tuple ``pad_width``)."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
