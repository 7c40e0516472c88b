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

The compilation service (reference ``:111``, ``:700-760``): each batch
signature (the batch tensors' shape, dtype, device and memory order)
has an entry in the step's ``SiteCache("train_step")`` — the settled
parameter shapes, the optimizer states made, the remat plan and the
kernel libraries the path loads. The first call at a signature builds it
(a miss), journals the signature to the manifest when one records, and
the first call of the step marks ``first_train_step``;
``compiler.warm_start(train_steps=[step])`` builds the entry ahead of
time (:meth:`warm_from_spec`, matched by :meth:`warm_ident`) and runs no
update, so the first real step records no miss and computes what a cold
one does, bit for bit.

:meth:`aot_compile` (reference ``:573-660``) runs the same state code
and the forward and backward on a net built under
``gluon.parameter.abstract_init()`` (the ``meta`` device): nothing is
materialised, and the instance refuses to train afterwards
(``:874-900``). :meth:`count_flops` is ``telemetry.xla_cost_analysis``'s
count.

Meshes over more than one device, sharding rules, sequence sharding and
input donation raise :class:`MXNetError` naming the queue item that
brings them.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple

import numpy as np
import torch
from torch import nn

from .. import autograd
from .. import optimizer as opt_mod
from .. import random_state
from ..base import MXNetError, torch_dtype
from ..gluon.block import remat_call, resolve_remat_policy
from ..ndarray import NDArray
from ..optimizer import multi_tensor as mt

__all__ = ["TrainStep", "AotCompiled", "MemoryAnalysis"]


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


# the kernel libraries a step's path launches (the norms, flash forward
# and backward, bias+GELU, dropout, the optimizer sweeps): its entry
# loads them, and no other (a library nothing here launches, or its
# failed build, stays out of the step)
_STEP_LIBS = ("rms_norm.cu", "layer_norm.cu", "flash_attention.cu",
              "flash_attention_bwd.cu", "bias_gelu.cu", "dropout.cu",
              "fused_optimizer.cu")


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
        from ..compiler.service import SiteCache

        self._cache = SiteCache("train_step")
        self._aot_only = False
        self._first_step_marked = False

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

    # -- the compilation service's train_step site ------------------------
    def _key(self, avals):
        from ..compiler import keys

        return keys.signature(
            "train_step", id(self), avals=avals,
            extra=(str(self.remat), self.loss_only),
            platform=keys.platform(self._device))

    def _prepare(self) -> dict:
        """A batch signature's entry: the states made, the kernel
        libraries loaded (on the card), the settled shapes and the remat
        plan."""
        if self._states is None:
            self._init_states()
        libs = ()
        if self._device.type == "cuda":
            from ..kernels import _build

            libs = _STEP_LIBS
            for src in libs:
                _build.load(src)
        return {"shapes": tuple((tuple(p.shape), str(p.dtype))
                                for p in self._params),
                "remat": self.remat, "libs": libs}

    def _entry(self, avals, n: int, record: bool = True):
        """The entry of batch signature ``avals`` (the first ``n`` the
        data's): a hit, or built now and journaled."""
        from ..compiler import manifest

        key = self._key(avals)
        entry = self._cache.lookup(key, record=record)
        if entry is not self._cache.MISS:
            return entry
        entry = self._prepare()
        self._cache.insert(key, entry)
        if manifest.recorder() is not None:
            manifest.record_signature("train_step", {
                "ident": self.warm_ident(),
                "data": tuple((a[0], a[1]) for a in avals[:n]),
                "label": tuple((a[0], a[1]) for a in avals[n:]),
                "routing": key.routing}, key.platform)
        return entry

    def warm_ident(self) -> str:
        """The ident ``train_step`` manifest entries are matched by: the
        net's structure, the optimizer's class and the step's options."""
        from ..compiler import keys

        return keys.fingerprint((keys.graph_ident(self.net),
                                 type(self.optimizer).__name__,
                                 str(self.remat), self.loss_only))

    def warm(self, data, label=()) -> str:
        """Build this step's entry for one batch signature before the
        first call (``data``/``label``: ``(shape, dtype)`` pairs, tensors
        or NDArrays, one or a tuple of them): the states are made and the
        kernel libraries loaded; no update runs. Returns ``"deduped"``
        when the entry was there, else ``"replayed"``."""
        from ..compiler import keys

        if self._aot_only:
            raise MXNetError("this TrainStep was used for aot_compile; "
                             "warm() needs a live step")
        def aval(x):
            if isinstance(x, tuple):        # a (shape, dtype) pair
                shape, dtype = _shape_dtype(x)
                return (tuple(shape), str(dtype).split(".")[-1],
                        str(self._device), False)
            return keys.aval(self._to_device(x))

        data = _as_tuple(data)
        avals = tuple(aval(x) for x in data + _as_tuple(label))
        hit = self._key(avals) in self._cache
        self._entry(avals, len(data), record=False)
        return "deduped" if hit else "replayed"

    def warm_from_spec(self, spec) -> str:
        """``compiler.warm_start``'s ``train_step`` replay."""
        return self.warm(tuple(spec.get("data") or ()),
                         tuple(spec.get("label") or ()))

    def _check_live(self) -> None:
        if self._aot_only:
            raise MXNetError(
                "this TrainStep was used for aot_compile (parameters on "
                "the meta device, no state buffers); build a fresh "
                "TrainStep on a concretely initialized net to train")

    def __call__(self, data, label):
        from ..compiler import keys

        self._check_live()
        data_t = tuple(self._to_device(x) for x in _as_tuple(data))
        label_t = tuple(self._to_device(x) for x in _as_tuple(label))
        self._entry(tuple(keys.aval(t) for t in data_t + label_t),
                    len(data_t))
        opt = self.optimizer
        # advance the counts first, as the reference's fused-step driver
        # does (step.py:913-920): t is the step's num_update
        for k in range(len(self._params)):
            opt._update_count(k)
        t = np.int32(opt.num_update)
        lr = np.float32(opt.learning_rate)

        for p in self._params:
            p.grad = None
        loss_val, outs = self._forward_backward(
            data_t, label_t, random_state.next_seed(self._device))

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
        if not self._first_step_marked:
            self._first_step_marked = True
            from .. import compiler

            compiler.mark_event("first_train_step")
        if self.loss_only:
            return loss_val.detach(), None
        return loss_val.detach(), _detach(outs)

    def _forward_backward(self, data_t, label_t, step_seed):
        """The loss (the f32 mean of the loss head's first output) and its
        backward, in training mode under ``step_seed``; returns ``(loss,
        outputs)``."""
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
        return loss_val, outs

    # -- AOT on the meta device, and the FLOP count ------------------------
    def _batch(self, data, label, meta):
        if meta:
            return (tuple(_meta_template(x) for x in _as_tuple(data)),
                    tuple(_meta_template(x) for x in _as_tuple(label)))
        return (tuple(self._to_device(x) for x in _as_tuple(data)),
                tuple(self._to_device(x) for x in _as_tuple(label)))

    def count_flops(self, data, label=(), meta=True) -> int:
        """The FLOPs of one step's forward and backward on ``(data,
        label)``, counted by ``compiler.flops`` (see
        ``telemetry.xla_cost_analysis``). ``meta``: run on ``meta`` copies
        of the parameters and the batch (nothing computed, nothing of the
        step moved); else on the live tensors (the gradients are written,
        no update runs)."""
        from ..compiler import flops

        data_t, label_t = self._batch(data, label, meta)
        swap = _meta_params(self.net) if meta else contextlib.nullcontext()
        with swap, flops.counting() as counter:
            self._forward_backward(data_t, label_t, 0)
        return counter.total

    def _argument_tensors(self) -> list:
        """The step's arguments: every parameter and buffer of the net
        (each once) and every optimizer-state tensor."""
        seen, out = set(), []
        for t in list(self.net.parameters()) + list(self.net.buffers()):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        return out + _state_tensors(self._states)

    def argument_bytes(self, data, label=()) -> int:
        """Bytes of the step's arguments for a batch of ``(data, label)``:
        the parameters and buffers, the optimizer states (masters and
        moments) and the batch; the states are made if they are not yet."""
        if self._states is None:
            self._init_states()
        batch = [_shape_dtype(x) for x in _as_tuple(data) + _as_tuple(label)]
        return sum(t.nbytes for t in self._argument_tensors()) + sum(
            math.prod(shape) * torch_dtype(dtype).itemsize
            for shape, dtype in batch)

    def state_layout(self) -> list:
        """Per trainable parameter, the shapes of its optimizer state's
        tensors in order (the f32 master first under multi-precision,
        then the moments); the states are made if they are not yet."""
        if self._states is None:
            self._init_states()
        return [[tuple(t.shape) for t in _state_tensors([st])]
                for st in self._states]

    def aot_compile(self, data, label=()) -> "AotCompiled":
        """Run the step's state and forward/backward code on a net
        built under ``gluon.parameter.abstract_init()``, on the ``meta``
        device: no buffer is materialised and no update runs. ``data`` and
        ``label``: one batch as ``(torch.Size, dtype)`` templates, tensors
        or NDArrays. Marks this instance AOT-only (a call then raises
        :class:`MXNetError` naming ``aot_compile``). Returns an
        :class:`AotCompiled`: ``memory_analysis()`` (arguments: the
        parameters, masters, moments and batch; temporaries: the bytes
        autograd saves for the backward under the step's remat policy;
        outputs) and ``cost_analysis()`` (the FLOPs)."""
        from ..compiler import flops

        if any(not t.is_meta for t in self.net.parameters()):
            raise MXNetError(
                "TrainStep.aot_compile runs on a net built and initialized "
                "under gluon.parameter.abstract_init() (parameters on the "
                "meta device)")
        self._aot_only = True
        data_t, label_t = self._batch(data, label, meta=True)
        if self._states is None:
            self._init_states()
        args = self._argument_tensors()
        arg_storages = {t.untyped_storage()._cdata for t in args}
        arg_storages |= {t.untyped_storage()._cdata
                         for t in data_t + label_t}
        saved = {}

        def pack(t):
            sid = t.untyped_storage()._cdata
            if sid not in arg_storages:
                saved[sid] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                flops.counting() as counter:
            loss, outs = self._forward_backward(data_t, label_t, 0)
        out_bytes = loss.nbytes + (0 if self.loss_only else sum(
            t.nbytes for t in _flat_tensors(outs)))
        return AotCompiled(
            MemoryAnalysis(
                argument_size_in_bytes=sum(t.nbytes for t in args) + sum(
                    t.nbytes for t in data_t + label_t),
                temp_size_in_bytes=sum(saved.values()),
                output_size_in_bytes=out_bytes),
            {"flops": float(counter.total)})


class MemoryAnalysis(NamedTuple):
    """Bytes of an AOT step on one device, by kind (the names of XLA's
    ``memory_analysis()``)."""
    argument_size_in_bytes: int
    temp_size_in_bytes: int
    output_size_in_bytes: int


class AotCompiled:
    """What :meth:`TrainStep.aot_compile` returns."""

    def __init__(self, memory: MemoryAnalysis, cost: dict):
        self._memory = memory
        self._cost = cost

    def memory_analysis(self) -> MemoryAnalysis:
        return self._memory

    def cost_analysis(self) -> dict:
        return dict(self._cost)


def _shape_dtype(x):
    """``(shape, dtype)`` of a batch template: a ``(shape, dtype)`` pair,
    a tensor, an NDArray or an array."""
    if isinstance(x, tuple) and len(x) == 2 \
            and isinstance(x[0], (tuple, list, torch.Size)):
        return tuple(x[0]), x[1]
    t = x._data if isinstance(x, NDArray) else x
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), t.dtype
    a = np.asarray(t)
    return a.shape, a.dtype


def _meta_template(x) -> torch.Tensor:
    """A batch template as an empty ``meta`` tensor."""
    shape, dtype = _shape_dtype(x)
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                       device="meta")


def _flat_tensors(x) -> list:
    if isinstance(x, (list, tuple)):
        return [t for o in x for t in _flat_tensors(o)]
    if isinstance(x, NDArray):
        return [x._data]
    return [x] if isinstance(x, torch.Tensor) else []


def _state_tensors(states) -> list:
    """The tensors of optimizer states (tuples in order, None skipped),
    as the JAX package's ``tree_flatten`` lists them."""
    return _flat_tensors(list(states or ()))


@contextlib.contextmanager
def _meta_params(net):
    """Within it, every Gluon parameter of ``net`` reads as a ``meta``
    tensor of its shape and dtype (what a forward on tensors reads,
    ``Parameter.tensor``); the live tensors are put back on exit."""
    if not hasattr(net, "collect_params"):
        raise MXNetError("counting a step on meta copies needs a Gluon "
                         "block (its parameters are swapped)")
    saved = []
    for p in net.collect_params().values():
        if p._var is None:
            continue
        saved.append((p, p._var, p._copies))
        meta = torch.empty_like(p._var, device="meta")
        if isinstance(p._var, nn.Parameter):
            meta = nn.Parameter(meta, requires_grad=p._var.requires_grad)
        p._var, p._copies = meta, [meta]
    try:
        yield
    finally:
        for p, var, copies in saved:
            p._var, p._copies = var, copies
