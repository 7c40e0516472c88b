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
trainable parameter with one fused optimizer sweep per dtype bucket
(``optimizer/multi_tensor.py``), the states created as
``create_state_multi_precision`` creates them. Where the JAX step is
one compiled program, the port runs eagerly; the parameters and states
are updated in place.

Meshes over more than one device, sharding rules, sequence sharding,
rematerialisation and input donation raise :class:`MXNetError` naming
the queue item that brings them.
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


def _refuse(mesh, rules, seq_axis, remat, donate_inputs):
    if mesh is not None and _mesh_size(mesh) > 1:
        raise MXNetError(
            f"TrainStep: a mesh over {_mesh_size(mesh)} devices needs the "
            "data-parallel comms and parallelism slices (ROADMAP.md, port "
            "queue 1, items 9 and 11); the port's step runs on one device")
    for name, value, item in (("rules", rules, 11),
                              ("seq_axis", seq_axis, 11),
                              ("remat", remat, 8)):
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
        name (``"sgd"``, ``"adam"``, ``"adamw"``) built with
        ``optimizer_params``.
    loss_only : return ``(loss, None)`` instead of ``(loss, outputs)``.
    mesh : None, or a mesh of one device; ``rules``, ``seq_axis``,
        ``remat`` and ``donate_inputs`` must keep their defaults (see the
        module docstring).

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
        _refuse(mesh, rules, seq_axis, remat, donate_inputs)
        self.net = net
        self.loss = loss
        self.loss_only = bool(loss_only)
        if not isinstance(optimizer, opt_mod.Optimizer):
            optimizer = opt_mod.create(optimizer,
                                       **(optimizer_params or {}))
        self.optimizer = optimizer
        self._family = mt.family_of(optimizer)
        if self._family is None:
            raise MXNetError(f"TrainStep: {type(optimizer).__name__} has "
                             "no fused sweep in the port yet (ROADMAP.md, "
                             "port queue 1, item 7)")
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

    def _init_states(self):
        opt = self.optimizer
        self._states = [opt.create_state_multi_precision(k, p.detach())
                        for k, p in enumerate(self._params)]
        self._buckets = mt.plan_buckets(
            [(p.dtype, p.dtype) for p in self._params], opt.multi_precision)

    def _to_device(self, x):
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
            outs = self.net(*data_t)
            loss_out = self.loss(outs, *label_t)
            if isinstance(loss_out, (list, tuple)):
                loss_out = loss_out[0]
            loss_val = loss_out.float().mean()
            loss_val.backward()

        static = mt.family_static(opt, self._family)
        with torch.no_grad(), opt.dynamic(t, lr):
            for b in self._buckets:
                self._sweep(b, static)
        if self.loss_only:
            return loss_val.detach(), None
        return loss_val.detach(), _detach(outs)

    def _sweep(self, b, static):
        params = [self._params[k] for k in b.members]
        # a parameter the loss did not reach has a zero gradient, as in
        # the reference's value_and_grad
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        states = [self._states[k] for k in b.members]
        if b.mp:
            ins = {"w": [s[0] for s in states], "g": grads}
            base = [s[1] for s in states]
            low = [p.data for p in params]
        else:
            ins = {"w": [p.data for p in params], "g": grads}
            base = states
            low = None
        for ri, role in enumerate(mt.state_roles(self._family,
                                                 dict(static))):
            ins[role] = [_as_tuple(s)[ri] for s in base]
        vecs = mt.collect_scalars(self.optimizer, self._family, b.members)
        mt.packed_apply(self._family, static, ins, vecs,
                        self.optimizer.rescale_grad, low=low)
