"""Optimizers: the ``Optimizer`` base, the reference's sixteen optimizers,
the ``Updater`` that holds their states, ``create``, ``register`` and
``get_updater``.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py:32-712``: learning
rate and weight decay with the per-parameter multipliers (a
``param_dict`` of Gluon parameters, index-keyed ``set_lr_mult``/
``set_wd_mult`` dicts or names through ``param_idx2name``), an
``lr_scheduler`` read at ``num_update`` through ``learning_rate``,
``begin_num_update``, ``rescale_grad``, ``clip_gradient``,
multi-precision f32 masters, per-index update counts kept per device
(``_set_current_context``; one device here, one stream, the API kept)
and the dynamic mode a fused step runs the optimizer in.

Each optimizer's ``update(index, weight, grad, state)`` runs over
NDArrays through the update ops of ``mx.nd`` (``ops/optimizer_op.py``)
with ``out=`` write-back, as the reference's does; ``SGLD``, ``DCASGD``,
``Adamax``, ``Nadam`` and ``LBSGD`` write their formulas out, as there.
SGD, Adam, AdamW and LAMB (the exact classes) also have the fused sweep
of :mod:`.multi_tensor`, which ``parallel.TrainStep`` and
``gluon.Trainer`` run instead of the per-parameter loop; the two agree
bit for bit (the ops compute with the sweep's plain expressions; on the card a
LAMB parameter takes the family's kernels over that one parameter, whose
norms torch's sum cannot reproduce). LAMB's bias correction multiplies
by f32 reciprocals outside the dynamic mode (the eager ``Trainer`` and
``Updater``) and divides inside it (``TrainStep``), as the reference's
eager op and traced step do.

``Updater.get_states``/``set_states`` use the reference's v2 envelope,
``("mxnet_tpu_updater_states_v2", {index: numpy state}, counters,
optimizer or None)``, so each package loads the other's states. The port
reads them with a restricted unpickler: numpy arrays, bf16 arrays of
``ml_dtypes`` taken by their bits (the port does not import
``ml_dtypes``), and the port's own optimizer and scheduler classes; a
pickled optimizer of another package raises :class:`MXNetError`. The
port writes bf16 states as f32 arrays (exact), so a reader without
``ml_dtypes`` takes them.
"""
from __future__ import annotations

import contextlib
import io
import math
import pickle
from typing import Dict

import numpy as _np
import torch

from .. import ndarray as nd
from .. import random_state
from ..base import MXNetError
from ..ndarray import NDArray
from ..ops.optimizer_op import (l2_norm, lamb_bias_corrections, lamb_phase1)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "RMSProp", "AdaGrad",
           "AdaDelta", "Ftrl", "Signum", "SGLD", "DCASGD", "LAMB",
           "FTML", "Adamax", "Nadam", "LBSGD",
           "Updater", "create", "register", "get_updater"]

_REGISTRY: Dict[str, type] = {}
_HALF = (torch.float16, torch.bfloat16)


def register(klass):
    """Register ``klass`` under its lower-cased name (``create``'s
    key)."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """The optimizer named ``name`` (case-insensitive), built with
    ``kwargs``; an :class:`Optimizer` passes through."""
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


def _tensor(x) -> torch.Tensor:
    return x._data if isinstance(x, NDArray) else x


def _zeros(weight, dtype=None):
    """Zeros like ``weight`` (its layout kept): an NDArray for an
    NDArray weight, a tensor for a tensor (the fused sweeps' states)."""
    z = torch.zeros_like(_tensor(weight), dtype=dtype)
    return NDArray(z) if isinstance(weight, NDArray) else z


def _copy(weight):
    t = _tensor(weight).detach().clone()
    return NDArray(t) if isinstance(weight, NDArray) else t


class Optimizer:
    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 multi_precision=False, param_dict=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and getattr(lr_scheduler, "base_lr",
                                                None):
            self.lr = lr_scheduler.base_lr
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        # one count stream per device, switched by _set_current_context
        # (reference :125-140): a parameter replicated over N devices
        # advances t once per step on each
        self._all_index_update_counts: Dict[int, Dict[int, int]] = \
            {0: self._index_update_count}
        # seeds the streams created after a restore
        self._count_baseline: Dict[int, int] = {}
        self.idx2name = dict(param_idx2name or {})
        # index -> gluon Parameter, whose lr_mult / wd_mult scale lr / wd
        self.param_dict = dict(param_dict or {})
        self.lr_mult: Dict = {}
        self.wd_mult: Dict = {}
        # dynamic mode (see .dynamic()): (t, base_lr) of the fused step
        self._dyn = None

    def __getstate__(self):
        # a pickled optimizer (get_states(dump_optimizer=True)) leaves its
        # Gluon parameters behind: the Trainer that loads it re-attaches
        # its own
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

    # -- state ----------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """``(f32 master, create_state(master))`` for a half-precision
        weight under ``multi_precision``, else ``create_state``. The
        weight is an NDArray (the per-parameter path) or a tensor (the
        fused sweeps), and the states are of the same kind."""
        if self.multi_precision and _tensor(weight).dtype in _HALF:
            w32 = _tensor(weight).detach().float()
            if isinstance(weight, NDArray):
                w32 = NDArray(w32)
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    # -- counts, lr, wd -------------------------------------------------
    def set_learning_rate(self, lr) -> None:
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when an LRScheduler is "
                             "active")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult) -> None:
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult) -> None:
        self.wd_mult = dict(args_wd_mult)

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

    def _set_current_context(self, device_id) -> None:
        """Switch the per-index count stream to ``device_id``; a new
        stream starts from the restored baseline."""
        if device_id not in self._all_index_update_counts:
            self._all_index_update_counts[device_id] = \
                dict(self._count_baseline)
        self._index_update_count = self._all_index_update_counts[device_id]

    def _restore_update_counts(self, counts) -> None:
        """Install restored per-index counts as every stream's clock."""
        self._count_baseline = dict(counts)
        self._index_update_count = dict(counts)
        self._all_index_update_counts = {0: self._index_update_count}

    def _update_count(self, index):
        if self._dyn is not None:
            return  # counts advance in the fused-step driver
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _t(self, index):
        """Per-index update count (the step's t in dynamic mode)."""
        if self._dyn is not None:
            return self._dyn[0]
        return self._index_update_count[index]

    def _get_lr(self, index):
        if self._dyn is not None:
            lr = self._dyn[1]
        else:
            lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
                else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    # -- updates --------------------------------------------------------
    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """``update`` on the f32 master of a half-precision weight under
        ``multi_precision``, the weight then rounded from it; else
        ``update`` itself."""
        if self.multi_precision and _tensor(weight).dtype in _HALF:
            w32, base_state = state
            g32 = grad.astype("float32")
            self.update(index, w32, g32, base_state)
            weight._assign(w32._data)
        else:
            self.update(index, weight, grad, state)

    def _common_kwargs(self, index):
        kw = {"lr": self._get_lr(index), "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def _scaled_grad(self, grad):
        """``grad * rescale_grad``, clipped: the hand-written updates'
        first step (in the grad's dtype, as the reference's NDArray
        arithmetic)."""
        g = _tensor(grad) * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g


@register
class SGD(Optimizer):
    """SGD with optional momentum (reference ``SGD``): ``mom = momentum
    * mom - lr * (g + wd * w)`` and ``w += mom``, or ``w -= lr * (g + wd
    * w)`` at momentum 0, where there is no state. ``lazy_update`` is
    accepted and means nothing for dense gradients."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            nd.sgd_update(weight, grad, out=weight, **kw)
        else:
            nd.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                              out=[weight, state], **kw)


@register
class NAG(Optimizer):
    """Nesterov momentum (``nag_mom_update``): ``mom = momentum * mom +
    g'`` and ``w -= lr * (g' + momentum * mom)``, with ``g' = g + wd *
    w``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            nd.sgd_update(weight, grad, out=weight, **kw)
        else:
            nd.nag_mom_update(weight, grad, state, momentum=self.momentum,
                              out=[weight, state], **kw)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate; its
    state is ``(mean, var)`` in the weight's dtype."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._t(index)
        kw = self._common_kwargs(index)
        kw["lr"] *= (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean, var = state
        nd.adam_update(weight, grad, mean, var, beta1=self.beta1,
                       beta2=self.beta2, epsilon=self.epsilon,
                       out=[weight, mean, var], **kw)


@register
class AdamW(Optimizer):
    """Decoupled weight decay with MXNet's semantics (contrib
    ``adamw.cc``): with ``correct_bias`` the bias correction is folded
    into the learning rate, and the decay multiplies that corrected rate;
    a parameter whose gradient is not finite is left as it is. Its state
    is ``(mean, var)`` in f32 whatever the weight's dtype."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.correct_bias = correct_bias

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._t(index)
        kw = self._common_kwargs(index)
        wd = kw.pop("wd")
        if self.correct_bias:
            kw["lr"] *= (1.0 - self.beta2 ** t) ** 0.5 \
                / (1.0 - self.beta1 ** t)
        mean, var = state
        nd.adamw_update(weight, grad, mean, var, beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                        eta=1.0, out=[weight, mean, var], **kw)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (``lamb_update_phase1/2``): Adam's
    moments, optionally bias-corrected, give ``upd = m / (sqrt(v) + eps)
    + wd * w``; each parameter then steps by ``lr * r1 / r2 * upd`` with
    ``r1 = ||w||`` (clamped to the bounds that are given) and ``r2 =
    ||upd||``, or by ``lr * upd`` when either norm is 0. Its state is
    ``(mean, var)`` in f32 whatever the weight's dtype. The bias
    correction multiplies by f32 reciprocals, or divides in the fused
    step's dynamic mode (see the module docstring)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._t(index)
        kw = self._common_kwargs(index)
        lr = kw.pop("lr")
        wd = kw.pop("wd")
        mean, var = state
        if self._one_member_sweep(weight, grad, mean, var, t, lr, wd):
            return
        if self._dyn is None:
            upd, new_mean, new_var = nd.lamb_update_phase1(
                weight, grad, mean, var, beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, t=t,
                bias_correction=self.bias_correction, wd=wd, **kw)
            upd, new_mean, new_var = upd._data, new_mean._data, \
                new_var._data
        else:
            bc1, bc2 = lamb_bias_corrections(self.beta1, self.beta2, int(t),
                                             False)
            with torch.no_grad():
                upd, new_mean, new_var = lamb_phase1(
                    weight._data, grad._data, mean._data, var._data,
                    beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                    bias_correction=self.bias_correction, bc1=bc1, bc2=bc2,
                    bc_recip=False, wd=wd,
                    rescale_grad=kw["rescale_grad"],
                    clip_gradient=kw.get("clip_gradient", -1.0))
        mean._assign(new_mean)
        var._assign(new_var)
        with torch.no_grad():
            r1, r2 = l2_norm(weight._data), l2_norm(upd)
        nd.lamb_update_phase2(
            weight, NDArray(upd), NDArray(r1), NDArray(r2), lr=lr,
            lower_bound=-1.0 if self.lower_bound is None
            else self.lower_bound,
            upper_bound=-1.0 if self.upper_bound is None
            else self.upper_bound, out=weight)


    def _one_member_sweep(self, weight, grad, mean, var, t, lr, wd) -> bool:
        """On the card, the update as the family's kernels take it, over
        this one parameter: the trust-ratio norms are sums in the
        kernel's order, which torch's sum does not reproduce, so only
        this keeps the per-parameter update equal to the fused sweep bit
        for bit there (the phases of the plain version equal the
        kernel's given the same norms). False where the kernel does not
        take the parameter, which then takes the ops."""
        from ..kernels import fused_lamb_sweep
        from . import multi_tensor as mt

        w, g = weight._data, grad._data
        if w.device.type != "cuda" or w.dtype != torch.float32 \
                or not mt.sweepable("lamb", w, g, False) \
                or any(s._data.stride() != w.stride() for s in (mean, var)):
            return False
        recip = self._dyn is None
        bc1 = bc2 = None
        if self.bias_correction:
            bc1, bc2 = lamb_bias_corrections(self.beta1, self.beta2, int(t),
                                             recip)
        fused_lamb_sweep(
            [w], [g], [mean._data], [var._data], None, [float(lr)],
            [float(wd)], [bc1], [bc2], beta1=self.beta1, beta2=self.beta2,
            epsilon=self.epsilon, rescale_grad=self.rescale_grad,
            clip_gradient=self.clip_gradient,
            bias_correction=self.bias_correction, bc_recip=recip,
            lower_bound=self.lower_bound, upper_bound=self.upper_bound)
        weight._wrote()
        return True


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        cw = self.clip_weights if self.clip_weights is not None else -1.0
        if self.centered:
            n, g_acc, delta = state
            nd.rmspropalex_update(weight, grad, n, g_acc, delta,
                                  gamma1=self.gamma1, gamma2=self.gamma2,
                                  epsilon=self.epsilon, clip_weights=cw,
                                  out=[weight, n, g_acc, delta], **kw)
        else:
            (n,) = state
            nd.rmsprop_update(weight, grad, n, gamma1=self.gamma1,
                              epsilon=self.epsilon, clip_weights=cw,
                              out=[weight, n], **kw)


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        nd.adagrad_update(weight, grad, state, epsilon=self.float_stable_eps,
                          out=[weight, state], **kw)


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        kw.pop("lr", None)  # AdaDelta has no learning rate
        acc_g, acc_d = state
        nd.adadelta_update(weight, grad, acc_g, acc_d, rho=self.rho,
                           epsilon=self.epsilon, out=[weight, acc_g, acc_d],
                           **kw)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        z, n = state
        nd.ftrl_update(weight, grad, z, n, lamda1=self.lamda1, beta=self.beta,
                       out=[weight, z, n], **kw)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is None:
            nd.signsgd_update(weight, grad, out=weight, **kw)
        else:
            nd.signum_update(weight, grad, state, momentum=self.momentum,
                             wd_lh=self.wd_lh, out=[weight, state], **kw)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w - lr / 2 * (g + wd *
    w) + N(0, sqrt(lr))``. The noise is drawn on the weight's device
    from a generator seeded by ``random_state.next_seed`` (the
    reference's ``nd.random.normal``); :meth:`noise` may be overridden to
    supply it."""

    def create_state(self, index, weight):
        return None

    def noise(self, index, weight, lr) -> torch.Tensor:
        w = _tensor(weight)
        gen = torch.Generator(device=w.device).manual_seed(
            random_state.next_seed(w.device))
        return torch.randn(w.shape, generator=gen, device=w.device,
                           dtype=w.dtype) * math.sqrt(lr)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._scaled_grad(grad)
        w = weight._data
        weight._assign(w - lr / 2 * (g + wd * w) + self.noise(index, weight,
                                                              lr))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD: ``delta = g + wd * w + lamda
    * g * g * (w - w_prev)``; the state is ``(momentum or None,
    previous weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros(weight) if self.momentum != 0.0 else None
        return (mom, _copy(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = self._scaled_grad(grad)
        mom, prev_w = state
        w = weight._data
        delta = g + wd * w + self.lamda * g * g * (w - prev_w._data)
        if mom is not None:
            mom._assign(self.momentum * mom._data - lr * delta)
            upd = mom._data
        else:
            upd = -lr * delta
        new_w = w + upd
        # the previous weight is the weight after this update (in
        # synchronous training the compensation term is zero)
        prev_w._assign(new_w)
        weight._assign(new_w)


@register
class FTML(Optimizer):
    """Follow The Moving Leader (``ftml_update``; states d, v, z)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        clip = kw.pop("clip_gradient", -1.0)
        d, v, z = state
        nd.ftml_update(weight, grad, d, v, z, t=int(self._t(index)),
                       beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, clip_grad=clip,
                       out=[weight, d, v, z], **kw)


@register
class Adamax(Optimizer):
    """Adam with the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._t(index)
        kw = self._common_kwargs(index)
        lr = kw["lr"] / (1.0 - self.beta1 ** t)
        w = weight._data
        g = _tensor(grad) * self.rescale_grad + kw["wd"] * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m, u = state
        m_new = self.beta1 * m._data + (1.0 - self.beta1) * g
        u_new = torch.maximum(self.beta2 * u._data, torch.abs(g))
        m._assign(m_new)
        u._assign(u_new)
        weight._assign(w - lr * m_new / (u_new + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (Dozat's schedule). As in the
    reference, ``m_schedule`` advances on every ``update`` call."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        from ..ops.elemwise import _sqrt

        self._update_count(index)
        t = self._t(index)
        kw = self._common_kwargs(index)
        lr, wd = kw["lr"], kw["wd"]
        w = weight._data
        g = _tensor(grad) * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        m_new = self.beta1 * m._data + (1.0 - self.beta1) * g
        v_new = self.beta2 * v._data + (1.0 - self.beta2) * g * g
        g_prime = g / (1.0 - self.m_schedule)
        m_prime = m_new / (1.0 - m_schedule_next)
        v_prime = v_new / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        m._assign(m_new)
        v._assign(v_new)
        weight._assign(w - lr * m_bar / (_sqrt(v_prime) + self.epsilon))


@register
class LBSGD(Optimizer):
    """Large-batch SGD with LARS's layer-wise trust ratio (the warmup
    strategies collapse to the ``lars`` core, as in the reference):
    ``eta * ||w|| / (||g|| + wd * ||w|| + eps)``, computed on the device,
    scales the learning rate of a momentum update."""

    def __init__(self, learning_rate=0.01, momentum=0.9, eta=0.001,
                 epsilon=1e-8, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        from ..ops.elemwise import _sqrt

        self._update_count(index)
        kw = self._common_kwargs(index)
        lr, wd = kw["lr"], kw["wd"]
        w = weight._data
        g = self._scaled_grad(grad)
        wnorm = _sqrt((w.float() ** 2).sum())
        gnorm = _sqrt((g.float() ** 2).sum())
        lars = torch.where((wnorm > 0) & (gnorm > 0),
                           self.eta * wnorm / (gnorm + wd * wnorm
                                               + self.epsilon),
                           torch.ones_like(wnorm))
        eff_lr = lr * lars.to(w.dtype)
        mom_new = self.momentum * state._data - eff_lr * (g + wd * w)
        state._assign(mom_new)
        weight._assign(w + mom_new)


# ---------------------------------------------------------------------------
# Updater
# ---------------------------------------------------------------------------

try:
    from numpy._core.multiarray import scalar as _np_scalar
except ImportError:                        # numpy < 2
    from numpy.core.multiarray import scalar as _np_scalar


class _BF16:
    """Stands in for ``ml_dtypes.bfloat16`` while a states file is read."""


class _Array:
    """An ndarray of a states file while it is read: ``__setstate__``
    takes numpy's state tuple and keeps a bf16 array as its raw bits."""

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _BF16):
            bits = _np.frombuffer(raw, dtype=_np.int16).reshape(
                shape, order="F" if fortran else "C")
            self.value = torch.from_numpy(bits.copy()) \
                .view(torch.bfloat16)
        else:
            arr = _np.ndarray.__new__(_np.ndarray, (0,), _np.uint8)
            arr.__setstate__(state)
            self.value = arr


def _reconstruct(cls, shape, typecode):
    return _Array()


def _dtype(obj, align=False, copy=False):
    if obj is _BF16:
        return _BF16()
    return _np.dtype(obj, align, copy)


_BF16.__setstate__ = lambda self, state: None


class _StatesUnpickler(pickle.Unpickler):
    """Takes numpy arrays (bf16 ones by their bits), plain containers and
    the port's optimizer and scheduler classes; refuses anything else,
    a pickled optimizer of another package included."""

    _NUMPY = {("numpy._core.multiarray", "_reconstruct"),
              ("numpy.core.multiarray", "_reconstruct")}
    _PORT = ("mxnet_tpu_torch.optimizer.optimizer",
             "mxnet_tpu_torch.lr_scheduler")

    def find_class(self, module, name):
        if (module, name) in self._NUMPY:
            return _reconstruct
        if module == "numpy" and name == "ndarray":
            return _np.ndarray
        if module == "numpy" and name == "dtype":
            return _dtype
        if module in ("numpy._core.multiarray", "numpy.core.multiarray") \
                and name == "scalar":
            return _np_scalar
        if module == "ml_dtypes" and name == "bfloat16":
            return _BF16
        if module in self._PORT:
            return super().find_class(module, name)
        if module == "builtins" and name in ("set", "frozenset", "slice",
                                             "complex"):
            return super().find_class(module, name)
        if module == "collections" and name == "OrderedDict":
            return super().find_class(module, name)
        raise MXNetError(
            f"optimizer states: refusing to unpickle {module}.{name}; the "
            "port reads numpy states and its own optimizer classes only (a "
            "states file with another package's pickled optimizer, "
            "get_states(dump_optimizer=True), does not load here)")


def _unwrap(x):
    """A loaded state with each :class:`_Array` replaced by its numpy
    array (or bf16 tensor)."""
    if isinstance(x, _Array):
        return x.value
    if isinstance(x, tuple):
        return tuple(_unwrap(v) for v in x)
    if isinstance(x, list):
        return [_unwrap(v) for v in x]
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def loads_states(blob: bytes):
    """Unpickle a states payload with the restricted unpickler."""
    return _unwrap(_StatesUnpickler(io.BytesIO(blob)).load())


class Updater:
    """Each parameter index's optimizer state, created lazily by
    ``optimizer.create_state_multi_precision`` (reference ``Updater``,
    ``optimizer.py:500-570``). ``updater(index, grad, weight)`` runs
    the optimizer's per-parameter update on NDArrays; the fused sweeps of
    :mod:`.multi_tensor` keep their states here too (as tensors)."""

    # the v2 envelope marker: the optimizer's update counters ride along
    _STATES_V2 = "mxnet_tpu_updater_states_v2"

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[int, object] = {}
        self.states_synced: Dict[int, bool] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states as the reference's v2 pickle: numpy arrays (bf16 as
        f32), the update counters and, with ``dump_optimizer``, the
        optimizer itself."""
        def to_np(s):
            if s is None:
                return None
            if isinstance(s, tuple):
                return tuple(to_np(x) for x in s)
            if isinstance(s, (NDArray, torch.Tensor)):
                t = _tensor(s).detach()
                if t.dtype == torch.bfloat16:
                    t = t.float()
                return t.to("cpu", copy=True).contiguous().numpy()
            return s

        payload = {k: to_np(v) for k, v in self.states.items()}
        counters = {
            "num_update": self.optimizer.num_update,
            "index_update_count": dict(self.optimizer._index_update_count),
        }
        return pickle.dumps(
            (self._STATES_V2, payload, counters,
             self.optimizer if dump_optimizer else None))

    def set_states(self, states: bytes) -> None:
        """Load :meth:`get_states`'s bytes (the reference's too, and its
        legacy payloads: a bare dict or ``(dict, optimizer)``); the
        states become NDArrays on the current context."""
        from ..ndarray import array

        data = loads_states(states)
        counters = None
        if isinstance(data, tuple) and len(data) == 4 and \
                data[0] == self._STATES_V2:
            _, data, counters, opt_obj = data
            if opt_obj is not None:
                self.optimizer = opt_obj
        elif isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[1], Optimizer):
            data, self.optimizer = data

        def to_nd(s):
            if s is None:
                return None
            if isinstance(s, tuple):
                return tuple(to_nd(x) for x in s)
            if isinstance(s, _np.ndarray):
                return array(s, dtype=s.dtype)
            if isinstance(s, torch.Tensor):
                return array(s)
            return s

        self.states = {k: to_nd(v) for k, v in data.items()}
        if counters is not None:
            self.optimizer.num_update = counters["num_update"]
            self.optimizer._restore_update_counts(
                counters["index_update_count"])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
