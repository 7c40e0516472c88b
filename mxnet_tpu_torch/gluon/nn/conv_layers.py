"""Convolution and pooling layers of the port.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py:91-347`` for the 2-D
forms the port's ops run: ``Conv2D``, ``MaxPool2D``, ``AvgPool2D``,
``GlobalMaxPool2D``, ``GlobalAvgPool2D`` and ``ReflectionPad2D``, with
the reference's signatures and a deferred ``in_channels``. ``layout`` is
``"NCHW"`` or ``"NHWC"``; the weight is ``(channels, in_channels, kh,
kw)`` in both (a checkpoint does not depend on the layout), and under
``"NHWC"`` it is stored in torch's ``channels_last`` memory format, the
order cuDNN reads beside a channels-last input, so no call reorders it.
The reference's ``conv_layout(...)`` context has no counterpart: a model
passes its layout to each layer. Groups and dilation, the 1-D and 3-D
layers, the transposed convolutions, ``ceil_mode`` and
``count_include_pad=False`` raise :class:`MXNetError` (ROADMAP.md, port
queue 1, item 4).
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


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _not_ported(what):
    raise MXNetError(f"{what} is not ported yet (ROADMAP.md, port queue 1, "
                     "item 4)")


class Conv2D(HybridBlock):
    """2-D convolution ``act(conv(x, weight) + bias)``."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError(f"Conv2D: layout {layout!r} is not NCHW or "
                             "NHWC")
        if groups != 1 or _pair(dilation) != (1, 1):
            _not_ported("Conv2D with groups or dilation")
        kernel = _pair(kernel_size)
        self._channels = channels
        self._layout = layout
        self._kwargs = {"kernel": kernel, "stride": _pair(strides),
                        "pad": _pair(padding), "num_filter": channels,
                        "layout": layout}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels) + kernel,
                init=weight_initializer, allow_deferred_init=True)
            if layout == "NHWC":
                self.weight._memory_format = torch.channels_last
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer)
            else:
                self.bias = None
            self.act = _make_activation(activation, self)

    def _infer_param_shapes(self, x, *rest):
        in_c = x.shape[-1 if self._layout == "NHWC" else 1]
        self.weight._finish_deferred_init(
            (self._channels, in_c) + self._kwargs["kernel"])

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, no_bias=bias is None,
                            **self._kwargs)
        if self.act is not None:
            out = self.act(out)
        return out

    def extra_repr(self):
        k = self._kwargs
        return (f"{self.weight.shape[1]} -> {self._channels}, "
                f"kernel_size={k['kernel']}, stride={k['stride']}, "
                f"padding={k['pad']}, layout={self._layout}")


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout="NCHW", count_include_pad=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if ceil_mode:
            _not_ported("pooling with ceil_mode")
        if count_include_pad is False:
            _not_ported("average pooling with count_include_pad=False")
        pool_size = _pair(pool_size)
        self._kwargs = {
            "kernel": pool_size,
            "stride": pool_size if strides is None else _pair(strides),
            "pad": _pair(padding), "pool_type": pool_type,
            "global_pool": global_pool, "layout": layout}

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def extra_repr(self):
        k = self._kwargs
        return (f"size={k['kernel']}, stride={k['stride']}, "
                f"padding={k['pad']}, layout={k['layout']}")


class MaxPool2D(_Pooling):
    """Max pooling, MXNet's ``"valid"`` convention, padded with -inf."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "max", layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    """Average pooling over the whole window, padding included."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(pool_size, strides, padding, ceil_mode, False,
                         "avg", layout=layout,
                         count_include_pad=count_include_pad, **kwargs)


class GlobalMaxPool2D(_Pooling):
    """The maximum over both spatial axes, kept as size 1."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    """The mean over both spatial axes, kept as size 1."""

    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), (1, 1), (0, 0), False, True, "avg",
                         layout=layout, **kwargs)


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


def _refusing(name):
    def __init__(self, *args, **kwargs):
        _not_ported(name)

    return type(name, (HybridBlock,), {
        "__init__": __init__,
        "__doc__": f"``{name}``: not ported yet (ROADMAP.md, port queue 1, "
                   "item 4)."})


Conv1D = _refusing("Conv1D")
Conv3D = _refusing("Conv3D")
Conv1DTranspose = _refusing("Conv1DTranspose")
Conv2DTranspose = _refusing("Conv2DTranspose")
Conv3DTranspose = _refusing("Conv3DTranspose")
MaxPool1D = _refusing("MaxPool1D")
MaxPool3D = _refusing("MaxPool3D")
AvgPool1D = _refusing("AvgPool1D")
AvgPool3D = _refusing("AvgPool3D")
GlobalMaxPool1D = _refusing("GlobalMaxPool1D")
GlobalMaxPool3D = _refusing("GlobalMaxPool3D")
GlobalAvgPool1D = _refusing("GlobalAvgPool1D")
GlobalAvgPool3D = _refusing("GlobalAvgPool3D")
