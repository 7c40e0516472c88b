"""Gluon ``Trainer`` of the port: the optimizer step of the eager path.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (``:40-104``,
``:366-400``, ``:468-573``) on one device, as MXNet's users wrote it::

    trainer = mx.gluon.Trainer(net.collect_params(), "lamb",
                               {"learning_rate": 1e-3, "wd": 0.01})
    with mx.autograd.record():
        loss = net(data, label)
    mx.autograd.backward(loss)
    trainer.step(batch_size)

``step`` sets ``rescale_grad = 1 / batch_size``, exchanges nothing (one
device: there is nothing to reduce) and runs the fused update
(``_fused_update``): one ``multi_tensor.plan_eager`` and
``apply_eager_plan`` over every parameter whose ``grad_req`` is not
``"null"``, one sweep per dtype bucket, with each parameter's
``lr_mult``/``wd_mult`` through the optimizer's ``param_dict``. The
optimizer is SGD, Adam, AdamW or LAMB (exactly those classes).

Raise :class:`MXNetError`, naming the ROADMAP.md item that brings them:
another optimizer (item 7: the per-parameter updates); a kvstore other
than None, ``"device"`` or ``"local"``, ``update_on_kvstore=True``,
``compression_params``, ``overlap_comms`` and ``partition`` (item 9:
data-parallel comms); ``check_nonfinite`` (item 7); parameters on more
than one device (item 9). ``save_states``/``load_states`` wait (item
7).
"""
from __future__ import annotations

from typing import List

from .. import optimizer as opt
from ..base import MXNetError
from ..optimizer import multi_tensor as mt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


def _refuse(kvstore, compression_params, update_on_kvstore,
            check_nonfinite, overlap_comms, partition) -> None:
    if not (kvstore is None or (isinstance(kvstore, str)
                                and kvstore in _LOCAL_KVSTORES)):
        raise MXNetError(f"Trainer: kvstore={kvstore!r} needs the "
                         "data-parallel comms (ROADMAP.md, port queue 1, "
                         "item 9); on one device use None, 'device' or "
                         "'local'")
    for name, value, item in (
            ("compression_params", compression_params is not None, 9),
            ("update_on_kvstore", bool(update_on_kvstore), 9),
            ("overlap_comms", bool(overlap_comms), 9),
            ("partition", partition is not None, 9),
            ("check_nonfinite", bool(check_nonfinite), 7)):
        if value:
            raise MXNetError(f"Trainer: {name}= is not ported yet "
                             f"(ROADMAP.md, port queue 1, item {item})")


class Trainer:
    """Applies an optimizer to a set of :class:`Parameter`\\ s.

    Parameters
    ----------
    params : a :class:`ParameterDict` (or dict) or a list of
        :class:`Parameter`, all on one device.
    optimizer : a name (``"sgd"``, ``"adam"``, ``"adamw"``, ``"lamb"``)
        built with ``optimizer_params``, or an
        :class:`~mxnet_tpu_torch.optimizer.Optimizer` (then
        ``optimizer_params`` must be empty).
    kvstore, compression_params, update_on_kvstore, check_nonfinite,
    overlap_comms, partition, partition_rank, partition_world : must
        keep their one-device values (see the module docstring).
    """

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, check_nonfinite=None,
                 overlap_comms=None, partition=None, partition_rank=None,
                 partition_world=None):
        _refuse(kvstore, compression_params, update_on_kvstore,
                check_nonfinite, overlap_comms, partition)
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
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an instance")
            optimizer.param_dict = param_dict
        else:
            optimizer = opt.create(optimizer, param_dict=param_dict,
                                   **(optimizer_params or {}))
        if mt.family_of(optimizer) is None:
            raise MXNetError(f"Trainer: {type(optimizer).__name__} has no "
                             "fused sweep in the port, and the per-parameter "
                             "update is not ported (ROADMAP.md, port queue "
                             "1, item 7)")
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
        device)."""
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self) -> None:
        """Reduce the gradients over devices: on one device there is
        nothing to reduce."""

    def update(self, batch_size, ignore_stale_grad=False) -> None:
        """The optimizer step alone (after :meth:`allreduce_grads`)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._fused_update()

    def _fused_update(self) -> None:
        """Every dense trainable parameter in one fused sweep per dtype
        bucket: plan all buckets, then advance the counts and sweep."""
        items = [(i, p._var, p._grad_tensor())
                 for i, p in enumerate(self._params)
                 if p.grad_req != "null"]
        if not items:
            return
        plan = mt.plan_eager(self._optimizer, self._updater, items)
        mt.apply_eager_plan(self._optimizer, self._updater, plan, items)
