"""The ``mx.nd`` namespace of the port: NDArray and the generated op
wrappers (counterpart of ``mxnet_tpu/ndarray/__init__.py``).

Each registered op of ``ops/registry.py`` becomes ``mx.nd.<name>``, as
MXNet generates its wrappers from the C op registry: tensors go
positionally or by name, attributes as keywords (positionals past the
tensors fill the attributes in order, ``nd.clip(x, 0, 6)``), plus
``out=`` and ``ctx=``. ``mx.nd.contrib`` holds every ``_contrib_`` op
under its short name (``mx.nd.contrib.MultiBoxPrior``), as the
reference builds it; the spatial group (``ROIPooling``, ``Correlation``,
``BilinearSampler``, ``SpatialTransformer``, ``GridGenerator``, ``Crop``,
``im2col``, ``col2im``, ``contrib.ROIAlign``, ``contrib.PSROIPooling``,
``contrib.DeformableConvolution``) is here with the reference's aliases.
``random``, ``linalg``, ``image`` and ``sparse`` wait (ROADMAP.md, port
queue 1, item 4 (d)-(h)).
"""
from __future__ import annotations

import sys
import types
from typing import Optional

from ..base import numeric_types
from ..context import Context
from ..ops import contrib as _contrib  # noqa: F401  (registers the ops)
from ..ops import deformable as _deformable  # noqa: F401
from ..ops import elemwise as _elemwise  # noqa: F401
from ..ops import multibox as _multibox  # noqa: F401
from ..ops import nn as _nn  # noqa: F401
from ..ops import optimizer_op as _optimizer_op  # noqa: F401
from ..ops import rnn as _rnn  # noqa: F401
from ..ops import spatial as _spatial  # noqa: F401
from ..ops import tensor as _tensor  # noqa: F401
from ..ops.registry import get_op, list_ops, render_attr_docs
from .ndarray import NDArray, array, empty, imperative_invoke, waitall
from .serialization import load, loads, save

__all__ = ["NDArray", "contrib", "array", "empty", "save", "load", "loads", "waitall",
           "zeros", "ones", "full", "arange", "concat", "zeros_like",
           "ones_like", "moveaxis", "maximum", "minimum", "power", "equal",
           "not_equal", "greater", "lesser"]


def _make_wrapper(opname: str):
    opdef = get_op(opname)

    def wrapper(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        if isinstance(ctx, str):
            ctx = Context(ctx)
        attrs = {}
        if opdef.variadic:
            tensors = list(args)
            attrs.update(kwargs)
        elif opdef.tensor_params:
            tensors = [None] * len(opdef.tensor_params)
            for i, a in enumerate(args):
                if i < len(tensors):
                    tensors[i] = a
                elif i - len(tensors) < len(opdef.attr_params):
                    # past the tensors, positionals fill the attributes
                    attrs[opdef.attr_params[i - len(tensors)]] = a
                else:
                    raise TypeError(f"{opname}: too many positional "
                                    "arguments")
            for k, v in kwargs.items():
                if k in opdef.tensor_params:
                    tensors[opdef.tensor_params.index(k)] = v
                elif k in attrs:
                    raise TypeError(f"{opname}() got multiple values for "
                                    f"argument {k!r}")
                else:
                    attrs[k] = v
            while tensors and tensors[-1] is None:
                tensors.pop()
        else:
            tensors = []
            for i, a in enumerate(args):
                if i < len(opdef.attr_params):
                    attrs[opdef.attr_params[i]] = a
            attrs.update(kwargs)
        tensors = [t if t is None or isinstance(t, (NDArray,) + numeric_types)
                   else array(t, ctx=ctx) for t in tensors]
        return imperative_invoke(opdef, tensors, attrs, out=out, ctx=ctx)

    wrapper.__name__ = opname
    wrapper.__qualname__ = f"nd.{opname}"
    wrapper.__doc__ = (opdef.fn.__doc__ or f"{opname} operator.") \
        + render_attr_docs(opdef)
    return wrapper


_this = sys.modules[__name__]
contrib = types.ModuleType(__name__ + ".contrib")
sys.modules[contrib.__name__] = contrib
for _name in list_ops():
    if not hasattr(_this, _name):
        setattr(_this, _name, _make_wrapper(_name))
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):], getattr(_this, _name))


def zeros(shape, ctx: Optional[Context] = None, dtype=None, **kwargs):
    if isinstance(shape, int):
        shape = (shape,)
    return imperative_invoke(get_op("_zeros"), [], {
        "shape": tuple(shape), "dtype": dtype or "float32"}, ctx=ctx)


def ones(shape, ctx: Optional[Context] = None, dtype=None, **kwargs):
    if isinstance(shape, int):
        shape = (shape,)
    return imperative_invoke(get_op("_ones"), [], {
        "shape": tuple(shape), "dtype": dtype or "float32"}, ctx=ctx)


def full(shape, val, ctx: Optional[Context] = None, dtype=None):
    if isinstance(shape, int):
        shape = (shape,)
    return imperative_invoke(get_op("_full"), [], {
        "shape": tuple(shape), "value": float(val),
        "dtype": dtype or "float32"}, ctx=ctx)


def arange(start, stop=None, step=1.0, repeat=1,
           ctx: Optional[Context] = None, dtype=None):
    return imperative_invoke(get_op("_arange"), [], {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "dtype": dtype or "float32"}, ctx=ctx)


def zeros_like(a, **kw):
    return imperative_invoke(get_op("zeros_like"), [a], {})


def ones_like(a, **kw):
    return imperative_invoke(get_op("ones_like"), [a], {})


def moveaxis(a, source, destination):
    axes = list(range(a.ndim))
    axes.remove(source)
    axes.insert(destination if destination >= 0 else destination + a.ndim,
                source)
    return a.transpose(axes)


def _scalar_or_broadcast(lhs, rhs, scalar_op, rscalar_op, op):
    if isinstance(rhs, numeric_types):
        return imperative_invoke(get_op(scalar_op), [lhs],
                                 {"scalar": float(rhs)})
    if isinstance(lhs, numeric_types):
        return imperative_invoke(get_op(rscalar_op), [rhs],
                                 {"scalar": float(lhs)})
    return imperative_invoke(get_op(op), [lhs, rhs], {})


def equal(lhs, rhs):
    return lhs == rhs


def not_equal(lhs, rhs):
    return lhs != rhs


def greater(lhs, rhs):
    return lhs > rhs


def lesser(lhs, rhs):
    return lhs < rhs


def maximum(lhs, rhs):
    return _scalar_or_broadcast(lhs, rhs, "_maximum_scalar",
                                "_maximum_scalar", "broadcast_maximum")


def minimum(lhs, rhs):
    return _scalar_or_broadcast(lhs, rhs, "_minimum_scalar",
                                "_minimum_scalar", "broadcast_minimum")


def power(lhs, rhs):
    return _scalar_or_broadcast(lhs, rhs, "_power_scalar", "_rpower_scalar",
                                "broadcast_power")


# the fluent methods: every one forwards to its mx.nd wrapper, which owns
# the positional-to-attribute mapping (reference ndarray.py:930+)
def _attach_fluent(name):
    def method(self, *args, **kw):
        return getattr(_this, name)(self, *args, **kw)

    method.__name__ = name
    method.__doc__ = f"Fluent form of ``mx.nd.{name}``."
    if not hasattr(NDArray, name):
        setattr(NDArray, name, method)


for _name in ["sort", "round", "rint", "floor", "ceil", "trunc", "fix",
              "log2", "log10", "rsqrt", "cbrt", "sin", "cos", "tan",
              "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
              "arcsinh", "arccosh", "arctanh", "degrees", "radians",
              "sigmoid", "relu", "zeros_like", "ones_like", "shape_array",
              "size_array", "diag", "pad", "broadcast_to", "split", "abs",
              "sign", "sqrt", "square", "exp", "log"]:
    _attach_fluent(_name)
