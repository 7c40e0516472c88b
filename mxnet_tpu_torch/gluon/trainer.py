"""Gluon ``Trainer`` of the port: the optimizer step of the eager path.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (``:40-104``,
``:366-573``, ``:575-677``) on one device, as MXNet's users wrote it::

    trainer = mx.gluon.Trainer(net.collect_params(), "nag",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "lr_scheduler": CosineScheduler(...)})
    with mx.autograd.record():
        loss = net(data, label)
    mx.autograd.backward(loss)
    trainer.step(batch_size)

``step`` sets ``rescale_grad = 1 / batch_size``, exchanges nothing (one
device: there is nothing to reduce) and updates every parameter whose
``grad_req`` is not ``"null"``: SGD, Adam, AdamW and LAMB (exactly those
classes) through the fused sweep (``_fused_update``: one
``multi_tensor.plan_eager`` and ``apply_eager_plan``, one sweep per dtype
bucket), every other optimizer, a subclass of those four, and a
parameter the sweep cannot take (``multi_tensor.sweepable``) through the
per-parameter ``Updater`` (telemetry ``per_param``), with each
parameter's ``lr_mult``/``wd_mult`` through the optimizer's
``param_dict``. The two paths agree bit for bit. An ``lr_scheduler``
(in ``optimizer_params``) sets each step's learning rate for both.

``check_nonfinite`` (or ``MXNET_CHECK_NONFINITE=1``) skips a step whose
gradients hold NaN or Inf, counts it in ``steps_skipped`` and telemetry
``mxnet_steps_skipped_total{reason="nonfinite_grad"}``, at one
device-to-host read a step. ``save_states``/``load_states`` write and
read the ``Updater``'s v2 states (each package loads the other's),
committed atomically.

Raise :class:`MXNetError`, naming the ROADMAP.md item that brings them:
a kvstore other than None, ``"device"`` or ``"local"``,
``update_on_kvstore=True``, ``compression_params``, ``overlap_comms``,
``partition`` and parameters on more than one device (item 9: the
data-parallel comms and ZeRO).
"""
from __future__ import annotations

import contextlib
import logging
import os
from typing import List

import torch

from .. import optimizer as opt
from .. import telemetry
from ..base import MXNetError
from ..ndarray import NDArray
from ..optimizer import multi_tensor as mt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


def _refuse(kvstore, compression_params, update_on_kvstore, overlap_comms,
            partition) -> None:
    if not (kvstore is None or (isinstance(kvstore, str)
                                and kvstore in _LOCAL_KVSTORES)):
        raise MXNetError(f"Trainer: kvstore={kvstore!r} needs the "
                         "data-parallel comms (ROADMAP.md, port queue 1, "
                         "item 9); on one device use None, 'device' or "
                         "'local'")
    for name, value in (("compression_params", compression_params is not None),
                        ("update_on_kvstore", bool(update_on_kvstore)),
                        ("overlap_comms", bool(overlap_comms)),
                        ("partition", partition is not None)):
        if value:
            raise MXNetError(f"Trainer: {name}= is not ported yet "
                             "(ROADMAP.md, port queue 1, item 9)")


class Trainer:
    """Applies an optimizer to a set of :class:`Parameter`\\ s.

    Parameters
    ----------
    params : a :class:`ParameterDict` (or dict) or a list of
        :class:`Parameter`, all on one device.
    optimizer : a registered name (``"sgd"``, ``"nag"``, ``"adam"``...)
        built with ``optimizer_params``, or an
        :class:`~mxnet_tpu_torch.optimizer.Optimizer` (then
        ``optimizer_params`` must be empty).
    check_nonfinite : skip and count a step with NaN/Inf gradients.
    kvstore, compression_params, update_on_kvstore, overlap_comms,
    partition, partition_rank, partition_world : must keep their
        one-device values (see the module docstring).
    """

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, check_nonfinite=None,
                 overlap_comms=None, partition=None, partition_rank=None,
                 partition_world=None):
        _refuse(kvstore, compression_params, update_on_kvstore,
                overlap_comms, partition)
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._params.append(p)
        devices = {str(p.list_ctx()[0]) for p in self._params}
        if len(devices) > 1:
            raise MXNetError(f"Trainer: parameters on {sorted(devices)}; "
                             "more than one device needs the data-parallel "
                             "comms (ROADMAP.md, port queue 1, item 9)")
        if check_nonfinite is None:
            check_nonfinite = os.environ.get("MXNET_CHECK_NONFINITE",
                                             "0") == "1"
        self._check_nonfinite = bool(check_nonfinite)
        self.steps_skipped = 0
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an instance")
            optimizer.param_dict = param_dict
        else:
            optimizer = opt.create(optimizer, param_dict=param_dict,
                                   **(optimizer_params or {}))
        self._optimizer = optimizer
        self._updater = opt.Updater(optimizer)
        self._scale = 1.0

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr) -> None:
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False) -> None:
        """One optimizer step over the gradients the parameters hold,
        scaled by ``1 / batch_size`` (nothing to reduce first on one
        device); with ``check_nonfinite``, a step with NaN/Inf gradients
        is skipped and counted instead."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._check_nonfinite and self._grads_nonfinite():
            self.steps_skipped += 1
            telemetry.record_step_skipped("nonfinite_grad")
            logging.warning(
                "Trainer.step: non-finite gradient detected, skipping "
                "update (%d skipped so far)", self.steps_skipped)
            return
        self._update(ignore_stale_grad)

    def _grads_nonfinite(self) -> bool:
        """True if any live gradient holds NaN/Inf: every gradient's
        ``isfinite().all()`` folded on the device, one read to the
        host."""
        flags = [torch.isfinite(g).all() for g in (
            p._grad_tensor() for p in self._params if p.grad_req != "null")]
        if not flags:
            return False
        return not bool(torch.stack(flags).all())

    def allreduce_grads(self) -> None:
        """Reduce the gradients over devices: on one device there is
        nothing to reduce."""

    def update(self, batch_size, ignore_stale_grad=False) -> None:
        """The optimizer step alone (after :meth:`allreduce_grads`)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False) -> None:
        items = [(i, p._var, p._grad_tensor())
                 for i, p in enumerate(self._params)
                 if p.grad_req != "null"]
        per_param = self._fused_update(items)
        for i, w, g in per_param:
            telemetry.record_optimizer_dispatch("per_param")
            self._updater(i, NDArray(g), NDArray(w.detach()))

    def _fused_update(self, items) -> list:
        """The fused families' parameters that the sweep takes, one fused
        sweep per dtype bucket (plan all buckets, then advance the counts
        and sweep); returns the items left to the per-parameter loop."""
        family = mt.family_of(self._optimizer)
        if family is None:
            return items
        mp = self._optimizer.multi_precision
        fused, rest = [], []
        for it in items:
            (fused if mt.sweepable(family, it[1], it[2], mp)
             else rest).append(it)
        if fused:
            plan = mt.plan_eager(self._optimizer, self._updater, fused)
            mt.apply_eager_plan(self._optimizer, self._updater, plan, fused)
        return rest

    # ------------------------------------------------------------------
    def save_states(self, fname) -> None:
        """The updater's states (``Updater.get_states``) into ``fname``,
        committed atomically: a crash mid-save leaves the previous file
        whole."""
        from ..checkpoint import atomic_write

        atomic_write(fname, self._updater.get_states(dump_optimizer=False))

    def load_states(self, fname) -> None:
        """Inverse of :meth:`save_states` (and of the reference's): the
        states land on the parameters' device, each in the dtype the
        optimizer creates for its parameter, and the update counters are
        restored onto this trainer's optimizer. A missing or corrupt file
        raises :class:`MXNetError` naming it."""
        from ..checkpoint import apply_state_bytes, read_state_bytes

        states = read_state_bytes(fname, "Trainer.load_states")

        def _apply(blob):
            upd = self._updater
            with self._params[0].context if self._params else \
                    contextlib.nullcontext():
                upd.set_states(blob)
            if upd.optimizer is not self._optimizer:
                # a dump_optimizer=True payload installed its own
                # optimizer: carry its counters onto the live one
                self._optimizer.num_update = upd.optimizer.num_update
                self._optimizer._restore_update_counts(
                    upd.optimizer._index_update_count)
                upd.optimizer = self._optimizer
            self._conform_states()

        apply_state_bytes(states, _apply, fname, "Trainer.load_states")

    def _conform_states(self) -> None:
        """Cast each loaded state to the dtype and memory order the
        optimizer creates for its parameter (a bf16 state travels as an
        f32 array)."""
        for i, st in list(self._updater.states.items()):
            if i >= len(self._params) or st is None:
                continue
            p = self._params[i]
            like = self._optimizer.create_state_multi_precision(
                i, NDArray(p._var.detach()))
            self._updater.states[i] = _conform(st, like)


def _conform(state, like):
    if isinstance(state, tuple) and isinstance(like, tuple):
        return tuple(_conform(s, t) for s, t in zip(state, like))
    if isinstance(state, NDArray) and isinstance(like, NDArray):
        ref = like._data
        if tuple(state.shape) != tuple(ref.shape):
            raise MXNetError(f"Trainer.load_states: a state of shape "
                             f"{tuple(state.shape)} for a parameter whose "
                             f"state has shape {tuple(ref.shape)}")
        out = torch.empty_like(ref)
        out.copy_(state._data)
        return NDArray(out)
    return state
