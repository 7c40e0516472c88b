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
``"null"`` turns ``requires_grad`` off and drops it. The port runs a parameter on one device: ``initialize`` on
several contexts waits for the data-parallel comms (ROADMAP.md, port
queue 1, item 9), ``var()`` for the symbol API (item 12), and
``abstract_init`` (a meta-device placeholder) is not ported.
"""
from __future__ import annotations

import copy
import weakref
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from .. import initializer
from ..base import MXNetError, torch_dtype
from ..context import Context, cpu, current_context

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]

_GRAD_REQS = ("write", "add", "null")


class DeferredInitializationError(MXNetError):
    """A parameter was read before its deferred shape was known."""


def dtype_name(dtype) -> str:
    """MXNet's name of ``dtype`` (``"float32"``, ``"bfloat16"``...) for a
    name, a numpy dtype or a ``torch.dtype``."""
    return str(torch_dtype(dtype)).split(".")[-1]


def _one_context(ctx) -> Context:
    if ctx is None:
        return current_context()
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(
                f"a parameter lives on one device in the port, not {ctx}; "
                "several devices need the data-parallel comms (ROADMAP.md, "
                "port queue 1, item 9)")
        ctx = ctx[0]
    return ctx if isinstance(ctx, Context) else Context(ctx)


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
        self._dtype = dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.grad_stype = grad_stype
        self._stype = stype
        self._var: Optional[torch.Tensor] = None
        self._memory_format = torch.contiguous_format
        self._deferred_init = None          # (init, ctx, default_init)
        self._owners = []     # [(weakref to a block, attribute name)]
        self._nd = None
        self._grad_nd = None

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    def __deepcopy__(self, memo):
        # torch copies an nn.Parameter without its gradient buffer and
        # without the attributes set on it: give the copy both again
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k != "_owners":
                new.__dict__[k] = copy.deepcopy(v, memo)
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
        ctx = _one_context(ctx)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"cannot initialize Parameter {self.name} with unknown "
                f"shape {self._shape}; set allow_deferred_init=True or give "
                "the shape")
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init) -> None:
        from ..ndarray import NDArray

        host = torch.zeros(self._shape, dtype=torch.float32,
                           device=ctx.torch_device())
        if init is not None:
            ini = initializer.create(init)
        elif self.init is not None:
            ini = initializer.create(self.init)
        else:
            ini = default_init
        ini(initializer.InitDesc(self.name, global_init=ini), NDArray(host))
        self._deferred_init = None
        self._set_var(host.to(torch_dtype(self._dtype),
                              memory_format=self._memory_format))

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

    def _set_var(self, t: torch.Tensor) -> None:
        """Own ``t`` (a new storage): wrap it, give it its gradient buffer
        and register it with every holder."""
        t = t.detach()
        var = torch.nn.Parameter(t, requires_grad=False) \
            if self._differentiable else t
        self._adopt(var)
        self._init_grad()

    def _adopt(self, var: torch.Tensor) -> None:
        """Make ``var`` this parameter's storage in every holder (a
        holder whose ``_apply`` moved it already holds it) and clear the
        holders' hybridized graphs."""
        self._var = var
        self._nd = self._grad_nd = None
        for block, name in self._holders():
            block._register_var(name, var)
            block._clear_cached_op()

    def _init_grad(self) -> None:
        var = self._var
        if not self._differentiable:
            return
        var.requires_grad_(self._grad_req != "null")
        var._mx_grad_req = self._grad_req       # read by autograd.backward
        if self._grad_req == "null":
            var.grad = None
        self._grad_nd = None

    def _grad_tensor(self):
        """The gradient buffer, zeros made at its first use; None with
        ``grad_req="null"``."""
        var = self._var
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
        if self._var is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    "(deferred shape); run a forward pass first")
            raise MXNetError(f"Parameter {self.name} has not been "
                             "initialized; call .initialize() first")
        if ctx is not None and _one_context(ctx) != self.context:
            raise MXNetError(
                f"Parameter {self.name} was not initialized on context "
                f"{ctx}; it lives on {[self.context]}")

    @property
    def context(self) -> Context:
        return Context.from_device(self._var.device)

    @property
    def tensor(self) -> torch.Tensor:
        """The tensor this parameter owns (its ``nn.Parameter``), for code
        that runs on torch tensors."""
        if self._var is None and self._deferred_init is not None \
                and self._shape_known():
            self._finish_deferred_init()
        self._check_initialized()
        return self._var

    def data(self, ctx=None):
        """An NDArray over this parameter's storage (no copy)."""
        from ..ndarray import NDArray

        var = self.tensor
        self._check_initialized(ctx)
        if self._nd is None or self._nd._tensor is not var \
                or self._nd._ctx != self.context:
            self._nd = NDArray(var)
        return self._nd

    def list_data(self) -> list:
        return [self.data()]

    def grad(self, ctx=None):
        """An NDArray over the gradient buffer (no copy)."""
        from ..ndarray import NDArray

        self._check_initialized(ctx)
        g = self._grad_tensor()
        if g is None:
            raise MXNetError(f"Parameter {self.name} has grad_req='null'; "
                             "no gradient buffer")
        if self._grad_nd is None or self._grad_nd._tensor is not g \
                or self._grad_nd._ctx != self.context:
            self._grad_nd = NDArray(g)
        return self._grad_nd

    def list_grad(self) -> list:
        self._check_initialized()
        return [] if self._grad_req == "null" else [self.grad()]

    def list_ctx(self) -> List[Context]:
        if self._var is None and self._deferred_init is not None:
            return [self._deferred_init[1]]
        self._check_initialized()
        return [self.context]

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
            self._var.copy_(src)

    def zero_grad(self) -> None:
        if self._var is not None and self._var.grad is not None:
            self._var.grad.zero_()

    def reset_ctx(self, ctx) -> None:
        """Move to ``ctx`` (a new storage there)."""
        ctx = _one_context(ctx)
        if self._var is None and self._deferred_init is not None:
            init, _, default = self._deferred_init
            self._deferred_init = (init, ctx, default)
            return
        self._check_initialized()
        if ctx != self.context:
            self._set_var(self._var.detach().to(ctx.torch_device(),
                                                copy=True))

    def cast(self, dtype) -> None:
        """Change the dtype (a new storage, its gradient buffer anew;
        nothing when it is the dtype already)."""
        self._dtype = dtype_name(dtype)
        if self._var is None or self._var.dtype == torch_dtype(dtype):
            return
        var = self._var
        var.grad = None
        self._set_var(var.detach().to(torch_dtype(self._dtype)))

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
