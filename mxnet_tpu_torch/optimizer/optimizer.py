"""Optimizers: the ``Optimizer`` base, ``SGD``, ``Adam`` and ``AdamW``.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py:37-292``, as far as
the fused train step needs it: learning rate and weight decay,
``rescale_grad``, ``clip_gradient``, multi-precision f32 masters,
per-index update counts and the dynamic mode a fused step runs the
optimizer in. The update itself is the fused sweep of
:mod:`.multi_tensor`, which ``parallel.TrainStep`` drives; the
per-parameter ``update`` methods, learning-rate schedules and multipliers
and the other optimizers (LAMB, NAG, ...) wait for the Trainer slice
(ROADMAP.md, port queue 1, item 7).
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create"]

_NOT_PORTED = ("nag", "rmsprop", "adagrad", "adadelta",
               "ftrl", "signum", "sgld", "dcasgd", "lamb", "ftml", "adamax",
               "nadam", "lbsgd")


class Optimizer:
    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, multi_precision=False):
        self.rescale_grad = rescale_grad
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.learning_rate = learning_rate
        self.multi_precision = multi_precision
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        # dynamic mode (see .dynamic()): (t, base_lr) of the fused step
        self._dyn = None

    # -- state ----------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """``(f32 master, create_state(master))`` for a half-precision
        weight under ``multi_precision``, else ``create_state``."""
        if self.multi_precision and weight.dtype in (torch.float16,
                                                     torch.bfloat16):
            w32 = weight.detach().float()
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    # -- counts, lr, wd -------------------------------------------------
    @contextlib.contextmanager
    def dynamic(self, t, base_lr):
        """The fused train step's mode: the step count ``t`` and the
        ``base_lr`` are the step's own values (the JAX step traces them
        as int32/f32 scalars), and the counts advance in the step's
        driver."""
        prev = self._dyn
        self._dyn = (t, base_lr)
        try:
            yield
        finally:
            self._dyn = prev

    def _update_count(self, index):
        if self._dyn is not None:
            return  # counts advance in the fused-step driver
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _t(self, index):
        """Per-index update count (the step's t in dynamic mode)."""
        if self._dyn is not None:
            return self._dyn[0]
        return self._index_update_count[index]

    def _get_lr(self, index):
        return self._dyn[1] if self._dyn is not None else self.learning_rate

    def _get_wd(self, index):
        return self.wd


class SGD(Optimizer):
    """SGD with optional momentum (reference: ``SGD``,
    ``optimizer.py:201-222``): ``mom = momentum * mom - lr * (g + wd * w)``
    and ``w += mom``, or ``w -= lr * (g + wd * w)`` at momentum 0, where
    there is no state. ``lazy_update`` is accepted and means nothing for
    dense gradients. The state is a zero buffer in the weight's dtype (the
    f32 master's under ``multi_precision``)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)


class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate
    (reference: ``Adam.update``); its state is ``(mean, var)`` in the
    weight's dtype (the f32 master's under ``multi_precision``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))


class AdamW(Optimizer):
    """Decoupled weight decay with MXNet's semantics (reference: contrib
    ``adamw.cc``; the JAX ``AdamW``): with ``correct_bias`` the bias
    correction is folded into the learning rate, and the weight decay
    multiplies that corrected rate; a parameter whose gradient is not
    finite is left as it is. Its state is ``(mean, var)`` in f32 whatever
    the weight's dtype."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, dtype=torch.float32),
                torch.zeros_like(weight, dtype=torch.float32))


_REGISTRY = {"sgd": SGD, "adam": Adam, "adamw": AdamW}


def create(name, **kwargs):
    """The optimizer named ``name`` (case-insensitive), built with
    ``kwargs``; an :class:`Optimizer` passes through."""
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key in _NOT_PORTED:
        raise MXNetError(f"optimizer {name!r} is not ported yet; it comes "
                         "with the Trainer slice (ROADMAP.md, port queue 1, "
                         f"item 7). Ported: {sorted(_REGISTRY)}")
    if key not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)
