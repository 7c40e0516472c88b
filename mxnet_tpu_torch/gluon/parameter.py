"""Gluon parameters of the port: ``Parameter``, ``Constant`` and
``ParameterDict``.

Counterpart of ``mxnet_tpu/gluon/parameter.py:32-460``. A
:class:`Parameter` is declared with a name, a shape whose unknown axes
are 0 (``allow_deferred_init``), a dtype and an initializer; its
``initialize`` allocates it on one device, or defers that until the
shape is known (the first forward, ``_finish_deferred_init``), and
``data()``/``grad()`` hand out NDArrays over its own storage, without a
copy.

Once initialized, a parameter owns one tensor: a ``torch.nn.Parameter``
when it is differentiable, a plain tensor (a running statistic) when it
is not. Every :class:`~mxnet_tpu_torch.gluon.Block` that holds the
parameter as an attribute registers that tensor under the attribute's
name, in its ``_parameters`` (or, when not differentiable,
``_buffers``), so ``named_parameters``, ``state_dict``,
``parallel.TrainStep``, the optimizer sweeps and the serving graphs read
the same storage. What replaces the storage (``cast``, ``reset_ctx``, a
deferred initialization finishing) re-registers the new tensor with
every holder and clears their hybridized graphs.

``grad_req``: ``"write"`` or ``"add"`` give the tensor a gradient
buffer (the reference's ``_init_grad``), zeros made at its first use
(``grad()``, a backward, a ``Trainer`` step), so a model that is only
served holds none; ``autograd.backward`` overwrites or adds into it;
``"null"`` turns ``requires_grad`` off and drops it.

A parameter may live on several contexts (``initialize(ctx=[...])``,
``reset_ctx``; reference ``:125``, ``:251-294``): one tensor per
context, each its own leaf with its own gradient buffer, all made from
one initial value. Each context holds its own tensor even where two
contexts share a torch device (``cpu(0)``, ``cpu(1)``). ``data(ctx)``,
``grad(ctx)``, ``list_data()``, ``list_grad()`` and ``list_ctx()`` hand
them out; ``data()`` with no context inside a forward gives the copy of
the context the outermost block call's input lives on
(:func:`replica_scope`), so ``net(x)`` for ``x`` on ``cpu(1)`` runs on
the ``cpu(1)`` copy, and an input on none of the parameter's contexts
raises, as in the reference. A torch tensor names only its device: where
several of the contexts share it (``cpu(0)``, ``cpu(1)``), the read
raises instead of guessing (pass NDArrays, ``split_and_load``). Blocks
register the first context's tensor. A parameter on one context skips
all of this.
``var()`` waits for the symbol API (ROADMAP.md, port queue 1, item 12).

Under :class:`abstract_init` (reference ``:32``, ``:142-175``) a
parameter initializes to a tensor on the ``meta`` device: its shape and
dtype, no storage, no initializer run (a shape still unknown defers as
usual and becomes a meta tensor when it settles, even outside the
context). Such a net runs through ``TrainStep.aot_compile`` and
``telemetry.xla_cost_analysis``; a read of a value (``data()``,
``list_data()``, a save) raises :class:`MXNetError`, as in the
reference.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import weakref
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from .. import initializer
from ..base import MXNetError, torch_dtype
from ..context import Context, cpu, current_context

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "replica_scope", "current_replica",
           "abstract_init"]

_GRAD_REQS = ("write", "add", "null")


class DeferredInitializationError(MXNetError):
    """A parameter was read before its deferred shape was known."""


_abstract_scope = threading.local()


class abstract_init:
    """Within it, parameters initialize on the ``meta`` device: shapes and
    dtypes, never materialised (see the module docstring). For checking a
    recipe too large for the card (``TrainStep.aot_compile``,
    ``tools/pretrain_llama.py --compile-only``)."""

    def __enter__(self):
        self._prev = getattr(_abstract_scope, "on", False)
        _abstract_scope.on = True
        return self

    def __exit__(self, *exc):
        _abstract_scope.on = self._prev
        return False


def dtype_name(dtype) -> str:
    """MXNet's name of ``dtype`` (``"float32"``, ``"bfloat16"``...) for a
    name, a numpy dtype or a ``torch.dtype``."""
    return str(torch_dtype(dtype)).split(".")[-1]


def _ctx(c) -> Context:
    return c if isinstance(c, Context) else Context(c)


def _contexts(ctx) -> List[Context]:
    """``ctx`` (None: :func:`current_context`; a context; a list of them)
    as a list of distinct contexts."""
    if ctx is None:
        return [current_context()]
    if isinstance(ctx, (list, tuple)):
        out = [_ctx(c) for c in ctx]
        if not out:
            raise MXNetError("an empty context list")
        if len(set(out)) != len(out):
            raise MXNetError(f"duplicate contexts in {out}")
        return out
    return [_ctx(ctx)]


_replica = threading.local()
# the parameters that live on more than one context now: while it is
# empty, a block call opens no replica scope
_MULTI_CONTEXT = weakref.WeakSet()


def multi_context_live() -> bool:
    """Whether any parameter lives on several contexts."""
    return bool(_MULTI_CONTEXT)


def current_replica() -> Optional[Context]:
    """The context of the outermost block call's input on this thread,
    or None outside a block call."""
    state = getattr(_replica, "state", None)
    return None if state is None else state[0]


@contextlib.contextmanager
def replica_scope(ctx: Context, from_tensor: bool = False):
    """Within it, a parameter on several contexts hands out its ``ctx``
    copy to ``data()``/``tensor`` (``Block.__call__`` opens it around the
    outermost call; an inner scope leaves an outer one in place).
    ``from_tensor``: ``ctx`` was read off a torch tensor's device, which
    names no one of several contexts on that device."""
    prev = getattr(_replica, "state", None)
    if prev is None:
        _replica.state = (ctx, from_tensor)
    try:
        yield
    finally:
        _replica.state = prev


class Parameter:
    """A named weight of a :class:`~mxnet_tpu_torch.gluon.Block` (see the
    module docstring). ``shape`` axes of 0 are unknown until the first
    forward; ``dtype`` is the weight's dtype; ``init`` its own
    initializer, which takes precedence over the one ``initialize`` is
    given; ``differentiable=False`` makes it a constant (``grad_req``
    ``"null"``) held as a buffer."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if grad_req not in _GRAD_REQS:
            raise MXNetError(f"Parameter {name}: grad_req {grad_req!r} is "
                             f"not one of {_GRAD_REQS}")
        self.name = name
        self._differentiable = bool(differentiable)
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        # as declared, 0 for an axis left to inference (compiler.keys'
        # graph_ident reads it)
        self.declared_shape = self._shape
        self._abstract = False
        self._dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.grad_stype = grad_stype
        self._stype = stype
        self._var: Optional[torch.Tensor] = None
        self._copies: List[torch.Tensor] = []    # one per context
        self._ctxs: List[Context] = []
        self._memory_format = torch.contiguous_format
        self._deferred_init = None          # (init, ctx, default_init)
        self._owners = []     # [(weakref to a block, attribute name)]
        self._nds = {}
        self._grad_nds = {}

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    def __deepcopy__(self, memo):
        # torch copies an nn.Parameter without its gradient buffer and
        # without the attributes set on it: give the copy both again
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k not in ("_owners", "_nds", "_grad_nds"):
                new.__dict__[k] = copy.deepcopy(v, memo)
        new._nds, new._grad_nds = {}, {}
        # the holders are copied with the tree that holds them (memo)
        new._owners = [(weakref.ref(copy.deepcopy(ref(), memo)), name)
                       for ref, name in self._owners if ref() is not None]
        if new._var is not None:
            new._init_grad()
        return new

    # ------------------------------------------------------------------
    # shape, dtype, grad_req
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        # 0 is an unknown axis on either side (a deferred Dense tied to an
        # embedding); keep the more specific size
        if len(self._shape) != len(new_shape) or any(
                s != 0 and n != 0 and s != n
                for s, n in zip(self._shape, new_shape)):
            raise MXNetError(
                f"Parameter {self.name}: cannot overwrite shape "
                f"{self._shape} with incompatible {new_shape}")
        self._shape = tuple(s if n == 0 else n
                            for s, n in zip(self._shape, new_shape))

    @property
    def dtype(self) -> str:
        return self._dtype

    @dtype.setter
    def dtype(self, dtype):
        self._dtype = dtype_name(dtype)

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise MXNetError(f"Parameter {self.name}: grad_req {req!r} is "
                             f"not one of {_GRAD_REQS}")
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._var is not None:
            self._init_grad()

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _shape_known(self) -> bool:
        return self._shape is not None and all(s > 0 for s in self._shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False) -> None:
        """Allocate on ``ctx`` (default: :func:`current_context`) and fill
        by ``init``, else this parameter's own ``init``, else
        ``default_init`` (``Uniform()``). With an unknown shape and
        ``allow_deferred_init`` it waits for the first forward."""
        if self._var is not None and not force_reinit:
            return
        default_init = default_init or initializer.Uniform()
        ctx = _contexts(ctx)
        if getattr(_abstract_scope, "on", False):
            self._abstract = True
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"cannot initialize Parameter {self.name} with unknown "
                f"shape {self._shape}; set allow_deferred_init=True or give "
                "the shape")
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctxs, default_init) -> None:
        from ..ndarray import NDArray

        if self._abstract:
            self._deferred_init = None
            self._set_var(torch.empty(self._shape,
                                      dtype=torch_dtype(self._dtype),
                                      device="meta"), ctxs[:1])
            return
        host = torch.zeros(self._shape, dtype=torch.float32,
                           device=ctxs[0].torch_device())
        if init is not None:
            ini = initializer.create(init)
        elif self.init is not None:
            ini = initializer.create(self.init)
        else:
            ini = default_init
        ini(initializer.InitDesc(self.name, global_init=ini), NDArray(host))
        self._deferred_init = None
        self._set_var(host.to(torch_dtype(self._dtype),
                              memory_format=self._memory_format), ctxs)

    def _finish_deferred_init(self, inferred_shape=None) -> None:
        """Complete a deferred initialization once the shape is known
        (``inferred_shape`` merges into the declared one)."""
        if inferred_shape is not None:
            self.shape = inferred_shape
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f"Parameter {self.name} shape still unknown: {self._shape}")
        self._finish_init(*self._deferred_init)

    def _wrap(self, t: torch.Tensor) -> torch.Tensor:
        return torch.nn.Parameter(t, requires_grad=False) \
            if self._differentiable else t

    def _set_var(self, t: torch.Tensor, ctxs=None) -> None:
        """Own ``t`` (a new storage) on the first of ``ctxs`` (default:
        the contexts held now, when ``t`` is on the first one's device)
        and a copy of it on each other context: wrap each, give each its
        gradient buffer and register the first with every holder."""
        t = t.detach()
        if ctxs is None:
            ctxs = self._ctxs if self._ctxs and (
                self._abstract or self._ctxs[0].torch_device() == t.device) \
                else [Context.from_device(t.device)]
        var = self._wrap(t)
        self._copies = [var] + [
            self._wrap(t.to(c.torch_device(), copy=True))
            for c in ctxs[1:]]
        self._ctxs = list(ctxs)
        self._note_contexts()
        self._adopt(var)
        self._init_grad()

    def _note_contexts(self) -> None:
        if len(self._ctxs) > 1:
            _MULTI_CONTEXT.add(self)
        else:
            _MULTI_CONTEXT.discard(self)

    def _adopt(self, var: torch.Tensor) -> None:
        """Make ``var`` this parameter's storage (its first context's) in
        every holder (a holder whose ``_apply`` moved it already holds
        it) and clear the holders' hybridized graphs."""
        self._var = var
        if not self._copies or var.device != self._copies[0].device:
            # moved to another device (a holder's _apply): one context
            self._copies = [var]
            self._ctxs = [Context.from_device(var.device)]
            self._note_contexts()
        self._copies[0] = var
        self._nds, self._grad_nds = {}, {}
        for block, name in self._holders():
            block._register_var(name, var)
            block._clear_cached_op()

    def _init_grad(self) -> None:
        if not self._differentiable:
            return
        for var in self._copies:
            var.requires_grad_(self._grad_req != "null")
            var._mx_grad_req = self._grad_req   # read by autograd.backward
            if self._grad_req == "null":
                var.grad = None
        self._grad_nds = {}

    def _grad_tensor(self, i: int = 0):
        """The gradient buffer of the ``i``-th context's tensor, zeros
        made at its first use; None with ``grad_req="null"``."""
        var = self._copies[i]
        if self._grad_req == "null":
            return None
        if var.grad is None:
            var.grad = torch.zeros_like(var)
        return var.grad

    def _attach(self, block, name: str) -> None:
        """``block`` holds this parameter as its attribute ``name``. The
        parameter refers to its holders weakly, so a model is freed when
        its last reference goes, without waiting for a cycle collection
        (which would hold a dropped model's device memory until then)."""
        self._owners.append((weakref.ref(block), name))
        block._register_var(name, self._var)

    def _detach(self, block, name: str) -> None:
        self._owners = [(ref, n) for ref, n in self._owners
                        if not (ref() is block and n == name)]

    def _holders(self):
        return [(b, n) for b, n in ((ref(), n) for ref, n in self._owners)
                if b is not None]

    # ------------------------------------------------------------------
    # access
    # ------------------------------------------------------------------
    def _check_initialized(self, ctx=None) -> None:
        if self._abstract and self._var is not None:
            raise MXNetError(
                f"Parameter {self.name} was built under abstract_init() and "
                "holds no values; it can only be used through "
                "TrainStep.aot_compile and telemetry.xla_cost_analysis")
        if self._var is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    "(deferred shape); run a forward pass first")
            raise MXNetError(f"Parameter {self.name} has not been "
                             "initialized; call .initialize() first")
        dev, c0 = self._var.device, self._ctxs[0]
        if dev.type != c0.device_type or (
                dev.type == "cuda" and (dev.index or 0) != c0.device_id):
            # a holder's _apply moved the storage in place (torch swaps a
            # parameter's data): one context, where it now lies
            self._copies = [self._var]
            self._ctxs = [Context.from_device(dev)]
            self._note_contexts()
            self._nds, self._grad_nds = {}, {}
        if ctx is not None and _ctx(ctx) not in self._ctxs:
            raise MXNetError(
                f"Parameter {self.name} was not initialized on context "
                f"{ctx}; it lives on {self._ctxs}")

    def _index(self, ctx=None) -> int:
        """The position of ``ctx``'s copy (None: the current replica's
        inside a block call, else the first)."""
        self._check_initialized(ctx)
        if ctx is not None:
            return self._ctxs.index(_ctx(ctx))
        state = getattr(_replica, "state", None)
        if len(self._ctxs) == 1 or state is None:
            return 0
        ctx, from_tensor = state
        if from_tensor:
            dev = ctx.torch_device()
            on_dev = [i for i, c in enumerate(self._ctxs)
                      if c.torch_device() == dev]
            if len(on_dev) == 1:
                return on_dev[0]
            if on_dev:
                raise MXNetError(
                    f"Parameter {self.name} lives on {self._ctxs}; a torch "
                    f"tensor on {dev} does not say which of "
                    f"{[self._ctxs[i] for i in on_dev]} it is for: pass "
                    "NDArrays (gluon.utils.split_and_load)")
        elif ctx in self._ctxs:
            return self._ctxs.index(ctx)
        raise MXNetError(
            f"Parameter {self.name} was not initialized on context {ctx} "
            f"(the block's input's); it lives on {self._ctxs}")

    @property
    def context(self) -> Context:
        """The first context."""
        self._check_initialized()
        return self._ctxs[0]

    @property
    def tensor(self) -> torch.Tensor:
        """The tensor this parameter owns (its ``nn.Parameter``) on the
        current replica's context (the first outside a block call), for
        code that runs on torch tensors."""
        var = self._var
        if var is not None and len(self._copies) == 1:
            return var
        if var is None and self._deferred_init is not None \
                and self._shape_known():
            self._finish_deferred_init()
        return self._copies[self._index()]

    def data(self, ctx=None):
        """An NDArray over this parameter's storage on ``ctx`` (None: as
        :attr:`tensor` chooses), no copy."""
        from ..ndarray import NDArray

        if self._var is None and self._deferred_init is not None \
                and self._shape_known():
            self._finish_deferred_init()
        i = self._index(ctx)
        var = self._copies[i]
        nd = self._nds.get(i)
        if nd is None or nd._tensor is not var:
            nd = self._nds[i] = NDArray(var, ctx=self._ctxs[i])
        return nd

    def list_data(self) -> list:
        """One NDArray per context, in :meth:`list_ctx` order."""
        self._check_initialized()
        return [self.data(c) for c in self._ctxs]

    def grad(self, ctx=None):
        """An NDArray over the gradient buffer on ``ctx`` (no copy)."""
        from ..ndarray import NDArray

        i = self._index(ctx)
        g = self._grad_tensor(i)
        if g is None:
            raise MXNetError(f"Parameter {self.name} has grad_req='null'; "
                             "no gradient buffer")
        nd = self._grad_nds.get(i)
        if nd is None or nd._tensor is not g:
            nd = self._grad_nds[i] = NDArray(g, ctx=self._ctxs[i])
        return nd

    def list_grad(self) -> list:
        self._check_initialized()
        return [] if self._grad_req == "null" else \
            [self.grad(c) for c in self._ctxs]

    def list_ctx(self) -> List[Context]:
        if self._var is None and self._deferred_init is not None:
            return list(self._deferred_init[1])
        self._check_initialized()
        return list(self._ctxs)

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def set_data(self, data) -> None:
        """Copy ``data`` (an NDArray, a tensor or an array) into the
        storage in place, cast to its dtype; a deferred parameter takes
        data's shape and is allocated first."""
        shape = tuple(data.shape)
        if self._var is None and self._deferred_init is not None:
            self.shape = shape
            self._finish_deferred_init()
        self._check_initialized()
        if shape != tuple(self._var.shape):
            raise MXNetError(
                f"Parameter {self.name}: cannot set data of shape {shape} "
                f"on parameter of shape {tuple(self._var.shape)}")
        src = getattr(data, "_data", data)
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.ascontiguousarray(np.asarray(src)))
        with torch.no_grad():
            for var in self._copies:
                var.copy_(src)

    def zero_grad(self) -> None:
        for var in self._copies:
            if var.grad is not None:
                var.grad.zero_()

    def reset_ctx(self, ctx) -> None:
        """Move to ``ctx`` (a context or a list of them): a new storage on
        each, copied from the first context's value."""
        ctxs = _contexts(ctx)
        if self._var is None and self._deferred_init is not None:
            init, _, default = self._deferred_init
            self._deferred_init = (init, ctxs, default)
            return
        self._check_initialized()
        if ctxs != self._ctxs:
            self._set_var(self._var.detach().to(ctxs[0].torch_device(),
                                                copy=True), ctxs)

    def cast(self, dtype) -> None:
        """Change the dtype (a new storage, its gradient buffer anew;
        nothing when it is the dtype already)."""
        self._dtype = dtype_name(dtype)
        if self._var is None or self._var.dtype == torch_dtype(dtype):
            return
        for var in self._copies:
            var.grad = None
        self._set_var(self._var.detach().to(torch_dtype(self._dtype)))

    def var(self):
        raise MXNetError("Parameter.var: the symbol API is not ported yet "
                         "(ROADMAP.md, port queue 1, item 12)")


class Constant(Parameter):
    """A parameter fixed at ``value`` (no gradient)."""

    def __init__(self, name, value):
        from ..ndarray import NDArray, array

        if not isinstance(value, NDArray):
            value = array(np.asarray(value), ctx=cpu())
        self.value = value
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=dtype_name(value._data.dtype),
                         init=initializer.Constant(value),
                         differentiable=False)


class ParameterDict:
    """An ordered ``name -> Parameter`` map under a name ``prefix``,
    optionally reading the parameters of a ``shared`` dict (reference:
    ``ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __repr__(self):
        lines = [f"{type(self).__name__} ({self._prefix}"]
        lines += [f"  {v}" for v in self.values()]
        return "\n".join(lines) + ")"

    def get(self, name, **kwargs) -> Parameter:
        """The parameter named ``prefix + name``, found here or in the
        shared dict, or created with ``kwargs``; an existing one takes a
        ``shape`` that agrees and an ``init`` it lacks."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None:
                    param.shape = (v,) if isinstance(v, int) else tuple(v)
                elif k == "init" and v is not None and param.init is None:
                    param.init = v
        return param

    def get_constant(self, name, value=None) -> Constant:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError(f"no constant named {name} and no value "
                                 "given")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._params[name]
        return None

    def update(self, other) -> None:
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False) -> None:
        default = initializer.create(init) if init is not None \
            else initializer.Uniform()
        for p in self.values():
            p.initialize(None, ctx, default_init=default,
                         force_reinit=force_reinit)

    def zero_grad(self) -> None:
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value) -> None:
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx) -> None:
        for p in self.values():
            p.reset_ctx(ctx)

    def save(self, filename, strip_prefix="") -> None:
        """Write every parameter to a ``.params`` file under its name
        (less ``strip_prefix``)."""
        from ..ndarray import serialization

        arg_dict = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = p.data().as_in_context(cpu())
        serialization.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix="", cast_dtype=False,
             dtype_source="current") -> None:
        """Set the parameters from a ``.params`` file written by
        :meth:`save` (names ``restore_prefix`` + the file's)."""
        from ..ndarray import serialization

        loaded = serialization.load(filename, ctx=cpu())
        if isinstance(loaded, list):
            raise MXNetError("parameter file holds an unnamed list, not a "
                             "dict")
        data = {restore_prefix + (k[4:] if k.startswith(("arg:", "aux:"))
                                  else k): v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in data:
                    raise MXNetError(
                        f"Parameter {name} missing in file {filename}; set "
                        "allow_missing=True to skip")
        for name, v in data.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        f"file {filename} has extra parameter {name}; set "
                        "ignore_extra=True to skip")
                continue
            p = self._params[name]
            if cast_dtype and dtype_source == "saved":
                p.cast(v._data.dtype)
            if p._var is None and p._deferred_init is None:
                p.initialize(ctx=ctx, default_init=initializer.Zero())
            p.set_data(v)
