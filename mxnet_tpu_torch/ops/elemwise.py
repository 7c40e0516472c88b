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

Where PyTorch's own op gives another value or gradient than the
reference at an edge (ties, kinks, +-0, +-inf, NaN, integer dtypes), the
op here is written so that it gives the reference's: ``s / x`` correctly
rounded; integer ``mod`` by zero 0; integer ``power`` by ``jnp``'s
binary exponentiation over the exponent's low 6 bits; ``hypot`` of
integers in float; ``cbrt`` taken in f32 and rounded once; ``sign`` of
NaN NaN and of -0 -0; -0 ordered below +0 by ``maximum``, ``minimum``
and ``clip``, as XLA orders them (torch keeps the first zero); half the
gradient at the ties of ``maximum``, ``minimum`` and ``clip`` and none
at NaN; ``abs``'s gradient 1 at +-0;
``relu`` +0 at -0 with no gradient at NaN; the gradient of ``gamma`` and
``gammaln`` NaN at +-0; the gradients of
``power`` and ``hypot`` at 0 as ``jnp``'s; ``Cast`` of a float to an
integer type saturating, NaN to 0.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import register

__all__ = ["cast_scalar", "relu", "maximum", "minimum", "signed_zeros",
           "max_zero_sign", "min_zero_sign"]

# ---------------------------------------------------------------------------
# binary arithmetic
# ---------------------------------------------------------------------------


def _int(t) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


def _mod(a, b):
    """``jnp.mod``: the sign of the divisor; an integer divisor of 0 gives
    0 (torch raises)."""
    if not _int(b):
        return torch.remainder(a, b)
    zero = b == 0
    r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros_like(r), r)


def _pow_int(x, y):
    """``jnp.power`` of integers (``_pow_int_int``): binary
    exponentiation over the low 6 bits of the exponent, wrapping as the
    dtype does (a negative exponent raises in torch)."""
    x, y = torch.broadcast_tensors(x, y)
    acc = torch.where((x == 0) & (y != 0), torch.zeros_like(x),
                      torch.ones_like(x))
    for k in range(6):
        acc = torch.where(((y >> k) & 1) != 0, acc * x, acc)
        x = x * x
    return acc


class _Pow(torch.autograd.Function):
    """``x ** y`` whose gradients are ``jnp.power``'s: ``y * x ** (y - 1)``
    (NaN at x = 0, y = 0, where torch gives 0) and ``log(x) * x ** y``
    (0 where x = 0)."""

    @staticmethod
    def forward(ctx, x, y):
        out = torch.pow(x, y)
        ctx.save_for_backward(x, y, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (g * y * torch.pow(x, y - 1)).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            lx = torch.log(torch.where(x == 0, torch.ones_like(x), x))
            gy = (g * lx * out).sum_to_size(y.shape)
        return gx, gy


def _power(x, y):
    if _int(x) and _int(y):
        return _pow_int(x, y)
    return _Pow.apply(x, y)


_POW_IN_F64 = (torch.float32, torch.float16, torch.bfloat16)


def _cpow(x, s):
    """``x ** s`` for a float scalar ``s``, with C's ``pow`` at -inf and
    +-0 for an exponent that is not an odd integer (torch takes +-0.5
    through sqrt/rsqrt: -inf ** 0.5 would be NaN, -0 ** 0.5 -0).

    An f32, f16 or bf16 ``x`` is raised in f64 and rounded once to f32
    (then to its own dtype, as the reference's f32 pow is): torch's f32
    pow is not correctly rounded, and its +-0.5 rewrite to sqrt/rsqrt
    puts 7 ** -0.5 one ulp off ``jnp.power``'s."""
    if x.dtype in _POW_IN_F64:
        out = torch.pow(x.double(), s).float().to(x.dtype)
    else:
        out = torch.pow(x, s)
    if not (float(s).is_integer() and int(s) % 2 == 1):
        pos = torch.tensor([float("inf"), 0.0], dtype=x.dtype,
                           device=x.device).pow(s)
        out = torch.where(x == float("-inf"), pos[0], out)
        out = torch.where(x == 0, pos[1], out)
    return out


class _PowScalar(torch.autograd.Function):
    """``x ** s`` for a float scalar ``s`` whose gradient is
    ``jnp.power``'s, ``s * x ** (s - 1)`` by C's ``pow`` (inf at x = 0 for
    s < 1; NaN there for s = 0, where torch gives 0)."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.save_for_backward(x)
        ctx.s = s
        return _cpow(x, s)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * (ctx.s * _cpow(x, ctx.s - 1)), None


def _power_scalar(x, s):
    """``x ** s`` for a scalar ``s`` of x's dtype (see :func:`_cpow`)."""
    if _int(x):
        return _pow_int(x, torch.full_like(x, s))
    return _PowScalar.apply(x, s)


class _Hypot(torch.autograd.Function):
    """``hypot`` correctly rounded, with ``jnp.hypot``'s gradients: x / h
    and y / h, 1/2 each where h = 0 (torch gives NaN), 0 where h is
    infinite."""

    @staticmethod
    def forward(ctx, x, y):
        h = torch.hypot(x, y)
        ctx.save_for_backward(x, y, h)
        return h

    @staticmethod
    def backward(ctx, g):
        x, y, h = ctx.saved_tensors
        zero, inf = h == 0, torch.isinf(h)
        safe = torch.where(zero | inf, torch.ones_like(h), h)

        def part(v):
            d = torch.where(zero, torch.full_like(h, 0.5), v / safe)
            return torch.where(inf, torch.zeros_like(d), d)

        return ((g * part(x)).sum_to_size(x.shape),
                (g * part(y)).sum_to_size(y.shape))


def _hypot(x, y):
    """``jnp.hypot``: integers are taken in float (float64 for int64, as
    the reference's x64 promotion gives; float32 otherwise)."""
    if _int(x):
        f = torch.float64 if x.dtype == torch.int64 else torch.float32
        x, y = x.to(f), y.to(f)
    return _Hypot.apply(x, y)


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def signed_zeros(x, negative: bool, dtype=torch.bool):
    """Where the float ``x`` holds a zero of the given sign (-0 if
    ``negative``), as ``dtype`` 1s and 0s, in one pass: +0's bits are
    all clear, -0's only the sign bit."""
    bits = x.detach().view(_INT_OF_SIZE[x.element_size()])
    zero = torch.iinfo(bits.dtype).min if negative else 0
    if dtype == torch.bool:
        return bits == zero
    return torch.eq(bits, zero, out=torch.empty_like(bits, dtype=dtype))


def max_zero_sign(out, plus0):
    """``out``, a max, with XLA's sign of a zero max: +0 where ``plus0``
    (a +0 took part), else the zero as it is. Adding +0 turns only -0
    into +0 and adding -0 changes nothing, so the gradient is
    untouched."""
    return out + torch.where(plus0, out.new_zeros(()),
                             out.new_full((), -0.0))


def min_zero_sign(out, minus0):
    """``out``, a min, with XLA's sign of a zero min: -0 where ``minus0``
    (a -0 took part); see :func:`max_zero_sign`."""
    return -(max_zero_sign(-out, minus0))


class _Extremum(torch.autograd.Function):
    """``jnp.maximum``/``jnp.minimum`` of two arrays, or of an array and
    a scalar of its dtype: NaN wins, and -0 orders below +0 (torch keeps
    ``a``'s zero at a tie of zeros); each operand's gradient is 1 where
    it alone is the result, half at a tie, 0 where it lost or the result
    is NaN (torch passes the gradient to a NaN operand). The scalar form
    saves only the array."""

    @staticmethod
    def forward(ctx, a, b, upper):
        scalar = not torch.is_tensor(b)
        other = a.new_full((), b) if scalar else b
        zeros = signed_zeros(a, not upper) | signed_zeros(other, not upper)
        if upper:
            out = max_zero_sign(torch.maximum(a, other), zeros)
        else:
            out = min_zero_sign(torch.minimum(a, other), zeros)
        ctx.upper, ctx.s = upper, b if scalar else None
        if scalar:
            ctx.save_for_backward(a)
        else:
            ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.s is not None:
            (d,), s = ctx.saved_tensors, ctx.s
            wins = d > s if ctx.upper else d < s
            w = torch.where(wins, 1.0, torch.where(d == s, 0.5, 0.0))
            return g * w.to(g.dtype), None, None
        a, b, out = ctx.saved_tensors

        def share(x, other, needed):
            if not needed:
                return None
            w = torch.where(x == out, torch.where(other == out, 0.5, 1.0),
                            0.0)
            return (g * w.to(g.dtype)).sum_to_size(x.shape)

        return (share(a, b, ctx.needs_input_grad[0]),
                share(b, a, ctx.needs_input_grad[1]), None)


def _extremum(a, b, upper):
    if not torch.result_type(a, b).is_floating_point:
        if not torch.is_tensor(b):
            b = torch.full_like(a, b)
        return torch.maximum(a, b) if upper else torch.minimum(a, b)
    return _Extremum.apply(a, b, upper)


def maximum(a, b):
    """``jnp.maximum`` of two arrays, or of an array and a scalar of its
    dtype (:class:`_Extremum`; integers: torch's)."""
    return _extremum(a, b, True)


def minimum(a, b):
    """``jnp.minimum``; see :func:`maximum`."""
    return _extremum(a, b, False)


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
_binary("broadcast_mod", [], _mod)
_binary("broadcast_power", ["broadcast_pow"], _power)
_binary("broadcast_maximum", [], maximum)
_binary("broadcast_minimum", [], minimum)
_binary("broadcast_hypot", [], _hypot)
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
# s / x as a division of two tensors: torch takes a scalar over a tensor
# as s * (1 / x), up to one ulp off the correctly rounded quotient
_scalar_op("_rdiv_scalar", lambda d, s: torch.full_like(d, s) / d)
_scalar_op("_mod_scalar", lambda d, s: _mod(d, torch.full_like(d, s)))
_scalar_op("_rmod_scalar", lambda d, s: _mod(torch.full_like(d, s), d))
_scalar_op("_power_scalar", _power_scalar)
_scalar_op("_rpower_scalar", lambda d, s: _power(torch.full_like(d, s), d))



_scalar_op("_maximum_scalar", maximum)
_scalar_op("_minimum_scalar", minimum)
_scalar_op("_equal_scalar", lambda d, s: (d == s).to(d.dtype))
_scalar_op("_not_equal_scalar", lambda d, s: (d != s).to(d.dtype))
_scalar_op("_greater_scalar", lambda d, s: (d > s).to(d.dtype))
_scalar_op("_greater_equal_scalar", lambda d, s: (d >= s).to(d.dtype))
_scalar_op("_lesser_scalar", lambda d, s: (d < s).to(d.dtype))
_scalar_op("_lesser_equal_scalar", lambda d, s: (d <= s).to(d.dtype))
_scalar_op("_hypot_scalar", lambda d, s: _hypot(d, torch.full_like(d, s)))

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


class _Cbrt(torch.autograd.Function):
    """``jnp.cbrt``: the cube root taken in f32 (f64 for f64) with x's
    sign (-0 stays -0), rounded once to x's dtype; the gradient ``1/3 *
    y**-2`` in x's dtype, inf at +-0."""

    @staticmethod
    def forward(ctx, x):
        w = x.double() if x.dtype == torch.float64 else x.float()
        y = torch.copysign(torch.abs(w).pow(1.0 / 3.0), w).to(x.dtype)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        third = torch.tensor(1.0 / 3.0, dtype=y.dtype, device=y.device)
        return g * (third * (1.0 / (y * y)))


def _cbrt(x):
    if _int(x):
        x = x.float()
    return _Cbrt.apply(x)


def true_div(x, n):
    """``x / n`` for a Python number ``n``, rounded as one division on
    every device, as XLA's and the CPU's: torch's CUDA kernels multiply by
    a Python scalar's reciprocal instead, an ulp off the quotient, which
    moves a ``floor`` or ``ceil`` at an integer."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


class _Abs(torch.autograd.Function):
    """``|x|`` whose gradient is ``jnp.abs``'s: +g where x >= 0 (so 1 at
    +-0, where torch gives 0), -g elsewhere."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x):
    return torch.abs(x) if _int(x) else _Abs.apply(x)


class _Relu(torch.autograd.Function):
    """``jax.nn.relu``: +0.0 at -0.0 (torch keeps -0.0), NaN at NaN, and
    the gradient 1 where x > 0 only (torch passes it at NaN)."""

    @staticmethod
    def forward(ctx, x):
        # threshold's test is x <= 0 ? 0 : x, one pass as torch.relu:
        # -0.0 gives +0.0 and NaN stays NaN
        y = F.threshold(x, 0.0, 0.0)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))


def relu(x):
    """``relu`` as the reference's (``mxnet_tpu/ops/elemwise.py:175``)."""
    return torch.relu(x) if _int(x) else _Relu.apply(x)


class _Digamma(torch.autograd.Function):
    """``lgamma`` (``log_gamma=True``) or ``exp(lgamma)`` whose gradient
    is NaN at +-0, as ``jax.scipy.special.digamma``'s pole (torch's
    digamma gives -inf at +0 and +inf at -0)."""

    @staticmethod
    def forward(ctx, x, log_gamma):
        y = torch.lgamma(x)
        if not log_gamma:
            y = torch.exp(y)
        ctx.save_for_backward(x, y)
        ctx.log_gamma = log_gamma
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        psi = torch.where(x == 0, float("nan"), torch.digamma(x))
        return g * (psi if ctx.log_gamma else psi * y), None


def _sign(x):
    """``jnp.sign``: NaN for NaN and -0 for -0 (torch gives 0 and +0);
    the gradient 0."""
    if _int(x):
        return torch.sign(x)
    keep = (x == 0) | torch.isnan(x)
    return torch.where(keep, x.detach(), torch.sign(x))


_unary("abs", _abs)
_unary("sign", _sign)
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
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))     # 1 / -0 = -inf
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
_unary("relu", relu)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: _Digamma.apply(x, False))
_unary("gammaln", lambda x: _Digamma.apply(x, True))
_unary("reciprocal", lambda x: 1.0 / x)
_unary("negative", torch.negative, aliases=["_np_negative"])
# the output is a fresh array, as every op's is (imperative_invoke copies
# an output that aliases an input)
_unary("identity", lambda x: x, aliases=["_copy"])


class _Clip(torch.autograd.Function):
    """``jnp.clip``, ``minimum(maximum(x, lo), hi)`` in one clamp: a zero
    bound orders -0 below +0 as XLA does (``clip(-0, 0, 6)`` is +0); the
    gradient is g strictly inside the bounds, g/2 on one, 0 outside and
    at NaN (the product of ``maximum``'s and ``minimum``'s)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        out = torch.clamp(x, lo, hi)
        if lo == 0 and math.copysign(1.0, lo) > 0:
            out.add_(0.0)                    # -0 -> +0, nothing else
        if hi == 0 and math.copysign(1.0, hi) < 0:
            out.neg_().add_(0.0).neg_()      # +0 -> -0, nothing else
        ctx.save_for_backward(x, out)
        ctx.bounds = (lo, hi)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        lo, hi = ctx.bounds
        if lo is None or hi is None or lo < hi:
            # x == out inside or on a bound (not outside, not NaN)
            on = (x == lo) if hi is None else (x == hi) if lo is None \
                else (x == lo) | (x == hi)
            return torch.where(x == out, torch.where(on, g * 0.5, g),
                               0.0).to(g.dtype), None, None
        # lo >= hi: the composition's product of the two weights
        w = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
        y = torch.clamp(x, min=lo)
        w = w * torch.where(y < hi, 1.0, torch.where(y == hi, 0.5, 0.0))
        return g * w.to(g.dtype), None, None


@register("clip")
def clip(data, *, a_min=None, a_max=None):
    """``jnp.clip`` (:class:`_Clip`), the bounds rounded to the data's
    dtype first; integers keep ``clamp``."""
    if _int(data):
        return torch.clamp(data, a_min, a_max)
    lo = None if a_min is None else cast_scalar(a_min, data.dtype)
    hi = None if a_max is None else cast_scalar(a_max, data.dtype)
    return _Clip.apply(data, lo, hi)


@register("Cast", aliases=["cast", "amp_cast"])
def cast(data, *, dtype="float32"):
    """``astype``, saturating as XLA's convert does where a float goes to
    an integer type: out-of-range values (and +-inf) to the type's
    bounds, NaN to 0 (torch's conversion wraps there)."""
    to = torch_dtype(dtype)
    if data.dtype.is_floating_point and not to.is_floating_point \
            and to != torch.bool:
        info = torch.iinfo(to)
        x = torch.nan_to_num(data.double(), nan=0.0)
        out = x.clamp(info.min, info.max).to(to)
        # float64 cannot hold int64's top: 2**63 would wrap
        return torch.where(x >= float(info.max),
                           torch.full_like(out, info.max), out)
    return data.to(to)


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
