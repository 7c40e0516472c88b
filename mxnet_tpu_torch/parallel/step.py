"""The fused training step on one device.

Counterpart of ``mxnet_tpu/parallel/step.py`` (``TrainStep``,
``:48-118`` and ``:894-976``) for a single card: one call advances the
optimizer's update counts, draws the step's seed from the device's
stream (``random_state.next_seed``, as the JAX step draws its key,
``:921``), runs the forward under autograd in training mode with every
dropout site's seed drawn from that step seed in call order
(``random_state.scoped_seed``, as the JAX step's trace splits its ops'
keys off the step key), reduces the loss by the mean in f32, runs the
backward (the port's backward kernels on a CUDA tensor; each dropout
backward regenerates its mask from its seed), and updates every
trainable parameter: for SGD, Adam, AdamW and LAMB (the exact classes)
with one fused optimizer sweep per dtype bucket
(``optimizer/multi_tensor.py``), for any other optimizer, and for a
parameter the sweep cannot take, with the optimizer's per-parameter
``update_multi_precision`` (reference ``:454-513``), all in the dynamic
mode at the step's ``t`` and learning rate (read from
``optimizer.learning_rate``, an ``lr_scheduler`` included, after the
counts advance; ``:908-918``). The states are created as
``create_state_multi_precision`` creates them. Where the JAX step is one
compiled program, the port runs eagerly; the parameters and states are
updated in place.

``remat`` (None, ``"full"`` or ``"dots"``; ``:70-110``, ``:351-362``)
rematerialises the whole net's forward as one span
(``gluon.block.remat_call``), the parameters and the batch its
arguments, the loss head outside it; a model's own per-block remat (the
Llama zoo's ``remat=``) nests inside it.

Meshes over more than one device, sharding rules, sequence sharding and
input donation raise :class:`MXNetError` naming the queue item that
brings them.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
from torch import nn

from .. import autograd
from .. import optimizer as opt_mod
from .. import random_state
from ..base import MXNetError
from ..gluon.block import remat_call, resolve_remat_policy
from ..ndarray import NDArray
from ..optimizer import multi_tensor as mt

__all__ = ["TrainStep"]


def _as_tuple(x):
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def _detach(outs):
    """``outs`` (a tensor or a tuple or list of them) cut from the
    graph."""
    if isinstance(outs, (list, tuple)):
        return type(outs)(_detach(o) for o in outs)
    return outs.detach()


def _mesh_size(mesh) -> int:
    if isinstance(mesh, dict):
        return math.prod(int(v) for v in mesh.values())
    if isinstance(mesh, int):
        return mesh
    size = getattr(mesh, "size", None)
    if isinstance(size, int):
        return size
    return len(list(getattr(mesh, "devices", [None, None])))


def _refuse(mesh, rules, seq_axis, donate_inputs):
    if mesh is not None and _mesh_size(mesh) > 1:
        raise MXNetError(
            f"TrainStep: a mesh over {_mesh_size(mesh)} devices needs the "
            "parallelism slice (ROADMAP.md, port queue 1, item 11); the "
            "port's step runs on one device (data parallelism runs through "
            "gluon.Trainer's kvstore)")
    for name, value, item in (("rules", rules, 11),
                              ("seq_axis", seq_axis, 11)):
        if value is not None:
            raise MXNetError(f"TrainStep: {name}= is not ported yet "
                             f"(ROADMAP.md, port queue 1, item {item})")
    if donate_inputs:
        raise MXNetError("TrainStep: donate_inputs= is not ported yet "
                         "(ROADMAP.md, port queue 1, item 8)")


class TrainStep:
    """Forward, loss, backward and the fused optimizer sweep of ``net``.

    Parameters
    ----------
    net : ``nn.Module`` with its parameters on one device.
    loss : callable ``loss(outputs, *labels)``; its first output is
        reduced by the mean, in f32.
    optimizer : an :class:`~mxnet_tpu_torch.optimizer.Optimizer` or a
        registered name built with ``optimizer_params``.
    loss_only : return ``(loss, None)`` instead of ``(loss, outputs)``.
    remat : None, ``"full"`` or ``"dots"`` (see the module docstring);
        an unknown policy raises ``ValueError``.
    mesh : None, or a mesh of one device; ``rules``, ``seq_axis`` and
        ``donate_inputs`` must keep their defaults (see the module
        docstring).

    ``step(data, label)``: ``data`` and ``label`` are a tensor, a numpy
    array or a tuple of them (moved to the parameters' device); a model
    that takes its labels as data (a fused CE head) is called as
    ``step((tokens, labels), ())``. Returns ``(loss, outputs)`` with the
    loss a 0-d f32 tensor and the outputs, a tensor or a tuple,
    detached.
    """

    def __init__(self, net: nn.Module, loss, optimizer, mesh=None,
                 rules=None, seq_axis=None, optimizer_params=None,
                 loss_only=False, donate_inputs=False, remat=None):
        _refuse(mesh, rules, seq_axis, donate_inputs)
        resolve_remat_policy(remat)
        self.remat = remat
        self.net = net
        self.loss = loss
        self.loss_only = bool(loss_only)
        if not isinstance(optimizer, opt_mod.Optimizer):
            optimizer = opt_mod.create(optimizer,
                                       **(optimizer_params or {}))
        self.optimizer = optimizer
        self._family = mt.family_of(optimizer)
        # trainable parameters, a tied one once, in registration order
        self._params: List[nn.Parameter] = [
            p for p in net.parameters() if p.requires_grad]
        if not self._params:
            raise MXNetError("TrainStep: the net has no trainable "
                             "parameter")
        self._device = self._params[0].device
        if any(p.device != self._device for p in self._params):
            raise MXNetError("TrainStep: every parameter must be on one "
                             "device")
        self._states = None
        self._buckets = None
        self._per_param = None

    def _init_states(self):
        """The states (tensors for the sweep's members, NDArrays for the
        per-parameter ones), the sweep's dtype buckets over its members
        (``Bucket.members`` index ``_params``) and the per-parameter
        indices."""
        opt = self.optimizer
        fused, self._per_param, self._states = [], [], []
        for k, p in enumerate(self._params):
            if self._family is not None and mt.sweepable(
                    self._family, p, p, opt.multi_precision):
                fused.append(k)
                self._states.append(
                    opt.create_state_multi_precision(k, p.detach()))
            else:
                self._per_param.append(k)
                self._states.append(opt.create_state_multi_precision(
                    k, NDArray(p.detach())))
        self._buckets = [
            b._replace(members=tuple(fused[m] for m in b.members))
            for b in mt.plan_buckets(
                [(self._params[k].dtype,) * 2 for k in fused],
                opt.multi_precision)]

    def _to_device(self, x):
        if isinstance(x, NDArray):      # an io batch: its tensor, no copy
            x = x._data
        if isinstance(x, torch.Tensor):
            return x.to(self._device)
        return torch.as_tensor(np.asarray(x), device=self._device)

    def __call__(self, data, label):
        data_t = tuple(self._to_device(x) for x in _as_tuple(data))
        label_t = tuple(self._to_device(x) for x in _as_tuple(label))
        if self._states is None:
            self._init_states()
        opt = self.optimizer
        # advance the counts first, as the reference's fused-step driver
        # does (step.py:913-920): t is the step's num_update
        for k in range(len(self._params)):
            opt._update_count(k)
        t = np.int32(opt.num_update)
        lr = np.float32(opt.learning_rate)

        for p in self._params:
            p.grad = None
        step_seed = random_state.next_seed(self._device)
        with torch.enable_grad(), autograd.train_mode(), \
                random_state.scoped_seed(step_seed):
            if self.remat is not None:
                outs = remat_call(self.net, *data_t, policy=self.remat)
            else:
                outs = self.net(*data_t)
            loss_out = self.loss(outs, *label_t)
            if isinstance(loss_out, (list, tuple)):
                loss_out = loss_out[0]
            loss_val = loss_out.float().mean()
            loss_val.backward()

        # a parameter the loss did not reach has a zero gradient, as in
        # the reference's value_and_grad
        def grad_of(p):
            return p.grad if p.grad is not None else torch.zeros_like(p)

        with torch.no_grad(), opt.dynamic(t, lr):
            if self._buckets:
                # LAMB's bias corrections are divisors in dynamic mode
                static = mt.family_static(opt, self._family)
            for b in self._buckets:
                params = [self._params[k] for k in b.members]
                mt.sweep_bucket(opt, self._family, static, b, b.members,
                                params, [grad_of(p) for p in params],
                                [self._states[k] for k in b.members])
            for k in self._per_param:
                p = self._params[k]
                opt.update_multi_precision(k, NDArray(p.detach()),
                                           NDArray(grad_of(p)),
                                           self._states[k])
        if self.loss_only:
            return loss_val.detach(), None
        return loss_val.detach(), _detach(outs)
