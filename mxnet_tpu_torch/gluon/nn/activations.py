"""Activation blocks of the port.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py:14-82``:
``Activation``, ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``,
``Swish`` and ``SiLU``, over the registered ``Activation`` and
``LeakyReLU`` ops.
"""
from __future__ import annotations

from ... import initializer
from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU", "SiLU"]


class Activation(HybridBlock):
    """``Activation(act_type)``: relu, sigmoid, tanh, softrelu, softsign,
    silu/swish, gelu, gelu_tanh or mish."""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class LeakyReLU(HybridBlock):
    """``x`` where positive, ``alpha * x`` elsewhere."""

    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope per channel (``in_channels``)."""

    def __init__(self, alpha_initializer=None, in_channels=1, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """``alpha * (exp(x) - 1)`` where negative."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class SiLU(Swish):
    pass
