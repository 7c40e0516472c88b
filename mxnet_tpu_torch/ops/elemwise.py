"""Elementwise and broadcast operators (counterpart of
``mxnet_tpu/ops/elemwise.py``).

MXNet's ``elemwise_*`` family requires equal shapes and its
``broadcast_*`` family broadcasts; PyTorch broadcasts natively, so both
share one implementation and the ``elemwise_`` ops keep the shape check.
Three rules follow the reference rather than PyTorch's habit:

* a scalar operand is cast to the array's dtype first (``:93-96``,
  ``jnp.asarray(scalar, dtype=data.dtype)``): a bf16 ``x * 0.1``
  multiplies by bf16(0.1) and an int32 ``x * 2.5`` by 2, where PyTorch
  would use the exact scalar and promote the int array to float;
* comparisons return the input's dtype with 0/1 values (``:54-68``,
  ``:113-118``), where PyTorch returns ``bool``;
* ``mod`` takes the sign of the divisor, as ``jnp.mod`` does
  (``torch.remainder``, not ``fmod``).
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register

__all__ = ["cast_scalar"]

# ---------------------------------------------------------------------------
# binary arithmetic
# ---------------------------------------------------------------------------


def _binary(name, aliases, fn, strict_shape=False):
    def impl(lhs, rhs):
        if strict_shape and lhs.shape != rhs.shape:
            raise ValueError(
                f"{name}: shapes {tuple(lhs.shape)} and {tuple(rhs.shape)} "
                f"must match (use broadcast_"
                f"{name.replace('elemwise_', '')} for broadcasting)")
        return fn(lhs, rhs)

    impl.__name__ = name
    register(name, aliases=aliases)(impl)


_binary("broadcast_add", ["broadcast_plus"], torch.add)
_binary("broadcast_sub", ["broadcast_minus"], torch.sub)
_binary("broadcast_mul", [], torch.mul)
_binary("broadcast_div", [], torch.true_divide)
_binary("broadcast_mod", [], torch.remainder)
_binary("broadcast_power", ["broadcast_pow"], torch.pow)
_binary("broadcast_maximum", [], torch.maximum)
_binary("broadcast_minimum", [], torch.minimum)
_binary("broadcast_hypot", [], torch.hypot)
_binary("elemwise_add", ["_plus", "_add"], torch.add, strict_shape=True)
_binary("elemwise_sub", ["_minus", "_sub"], torch.sub, strict_shape=True)
_binary("elemwise_mul", ["_mul"], torch.mul, strict_shape=True)
_binary("elemwise_div", ["_div"], torch.true_divide, strict_shape=True)


def _cmp(name, fn):
    def impl(lhs, rhs):
        return fn(lhs, rhs).to(lhs.dtype)

    impl.__name__ = name
    register(name, aliases=[name.replace("broadcast_", "_")])(impl)


_cmp("broadcast_equal", torch.eq)
_cmp("broadcast_not_equal", torch.ne)
_cmp("broadcast_greater", torch.gt)
_cmp("broadcast_greater_equal", torch.ge)
_cmp("broadcast_lesser", torch.lt)
_cmp("broadcast_lesser_equal", torch.le)


def _logical(name, fn):
    def impl(lhs, rhs):
        return fn(lhs != 0, rhs != 0).to(lhs.dtype)

    impl.__name__ = name
    register(name)(impl)


_logical("broadcast_logical_and", torch.logical_and)
_logical("broadcast_logical_or", torch.logical_or)
_logical("broadcast_logical_xor", torch.logical_xor)


@register("logical_not")
def logical_not(data):
    return (data == 0).to(data.dtype)


# ---------------------------------------------------------------------------
# scalar ops (the attribute carries the scalar)
# ---------------------------------------------------------------------------

_NP_FLOATS = {torch.float16: _np.float16, torch.float32: _np.float32,
              torch.float64: _np.float64}


def cast_scalar(scalar, dtype: torch.dtype):
    """``scalar`` rounded to ``dtype`` and back to a Python number (the
    reference's ``jnp.asarray(scalar, dtype=...)``): to the nearest value
    of a float dtype, truncated toward zero for an integer one."""
    if dtype in _NP_FLOATS:
        return float(_NP_FLOATS[dtype](scalar))
    if dtype.is_floating_point:             # bf16: numpy has no such type
        return torch.tensor(float(scalar), dtype=dtype).item()
    if dtype == torch.bool:
        return bool(scalar)
    return int(scalar)


def _scalar_op(name, fn):
    def impl(data, *, scalar=1.0):
        return fn(data, cast_scalar(scalar, data.dtype))

    impl.__name__ = name
    register(name)(impl)


_scalar_op("_plus_scalar", lambda d, s: d + s)
_scalar_op("_minus_scalar", lambda d, s: d - s)
_scalar_op("_rminus_scalar", lambda d, s: s - d)
_scalar_op("_mul_scalar", lambda d, s: d * s)
_scalar_op("_div_scalar", lambda d, s: d / s)
_scalar_op("_rdiv_scalar", lambda d, s: s / d)
_scalar_op("_mod_scalar", torch.remainder)
_scalar_op("_rmod_scalar", lambda d, s: torch.remainder(s, d))
_scalar_op("_power_scalar", torch.pow)
_scalar_op("_rpower_scalar", lambda d, s: torch.pow(s, d))
_scalar_op("_maximum_scalar", torch.clamp_min)
_scalar_op("_minimum_scalar", torch.clamp_max)
_scalar_op("_equal_scalar", lambda d, s: (d == s).to(d.dtype))
_scalar_op("_not_equal_scalar", lambda d, s: (d != s).to(d.dtype))
_scalar_op("_greater_scalar", lambda d, s: (d > s).to(d.dtype))
_scalar_op("_greater_equal_scalar", lambda d, s: (d >= s).to(d.dtype))
_scalar_op("_lesser_scalar", lambda d, s: (d < s).to(d.dtype))
_scalar_op("_lesser_equal_scalar", lambda d, s: (d <= s).to(d.dtype))
_scalar_op("_hypot_scalar", lambda d, s: torch.hypot(d, torch.full_like(d, s)))

# ---------------------------------------------------------------------------
# unary math
# ---------------------------------------------------------------------------


def _unary(name, fn, aliases=()):
    def impl(data):
        return fn(data)

    impl.__name__ = name
    register(name, aliases=list(aliases))(impl)


def _sqrt(x):
    # torch's vectorised CPU sqrt is not always correctly rounded (an f32
    # ulp off now and then, torch 2.13); XLA's and CUDA's are. On the CPU
    # it is taken in f64 and rounded to f32, then to x's dtype
    if x.device.type == "cpu" and x.dtype in (torch.float32, torch.float16,
                                              torch.bfloat16):
        return torch.sqrt(x.double()).float().to(x.dtype)
    return torch.sqrt(x)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", torch.round)
_unary("rint", torch.round)         # both round half to even
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", _sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", F.softsign)
_unary("relu", torch.relu)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("reciprocal", lambda x: 1.0 / x)
_unary("negative", torch.negative, aliases=["_np_negative"])
# the output is a fresh array, as every op's is (imperative_invoke copies
# an output that aliases an input)
_unary("identity", lambda x: x, aliases=["_copy"])


@register("clip")
def clip(data, *, a_min=None, a_max=None):
    return torch.clamp(data, a_min, a_max)


@register("Cast", aliases=["cast", "amp_cast"])
def cast(data, *, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("where")
def where(condition, x, y):
    return torch.where(condition != 0, x, y)


@register("add_n", aliases=["ElementWiseSum", "_sum"])
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("isnan")
def isnan(data):
    return torch.isnan(data).to(torch.float32)


@register("isinf")
def isinf(data):
    return torch.isinf(data).to(torch.float32)


@register("isfinite")
def isfinite(data):
    return torch.isfinite(data).to(torch.float32)
