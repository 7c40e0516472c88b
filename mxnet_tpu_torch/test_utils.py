"""``mx.test_utils`` — the public testing surface (counterpart of
``mxnet_tpu/test_utils.py``; reference ``python/mxnet/test_utils.py``):
tolerance-aware comparison that locates the worst mismatch, the
central-difference gradient check and the cross-context consistency
check, over NDArrays, tensors and numpy alike. ``default_context()`` is
the card when one is present, else the CPU; ``check_consistency`` runs
the CPU against the card by default.
"""
from __future__ import annotations

import numpy as _np
import torch

from .context import Context, cpu, gpu

__all__ = ["default_context", "set_default_context", "rand_ndarray",
           "assert_almost_equal", "almost_equal", "same",
           "check_numeric_gradient", "check_consistency", "rand_shape_2d",
           "rand_shape_3d", "rand_shape_nd", "effective_dtype",
           "default_rtols", "default_atols"]

_DEFAULT_RTOL = {
    _np.dtype(_np.float16): 1e-2, _np.dtype(_np.float32): 1e-4,
    _np.dtype(_np.float64): 1e-6,
}
_DEFAULT_ATOL = {
    _np.dtype(_np.float16): 1e-3, _np.dtype(_np.float32): 1e-5,
    _np.dtype(_np.float64): 1e-8,
}


def default_rtols():
    return dict(_DEFAULT_RTOL)


def default_atols():
    return dict(_DEFAULT_ATOL)


def default_context() -> Context:
    """The innermost ``with ctx:`` scope, else the card when one is
    present, else the CPU."""
    ctx = getattr(Context._default_ctx, "value", None)
    if ctx is not None:
        return ctx
    return gpu(0) if torch.cuda.is_available() else cpu(0)


def set_default_context(ctx: Context):
    Context._default_ctx.value = ctx


def effective_dtype(arr):
    """The dtype tolerances are judged at (bf16 counts as f16)."""
    dt = getattr(arr, "dtype", None)
    if str(dt).replace("torch.", "") == "bfloat16":
        return _np.dtype(_np.float16)
    if isinstance(dt, torch.dtype):
        dt = str(dt).replace("torch.", "")
    try:
        return _np.dtype(dt)
    except TypeError:
        return _np.dtype(_np.float64)


def _as_np(a):
    if hasattr(a, "asnumpy"):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return _np.asarray(a)


def rand_shape_2d(dim0=10, dim1=10):
    return tuple(_np.random.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(_np.random.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_np.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, dtype="float32", ctx=None):
    from .ndarray import array

    return array(_np.random.randn(*shape).astype(dtype),
                 ctx=ctx or default_context())


def same(a, b):
    return _np.array_equal(_as_np(a), _as_np(b))


def _tols(a, b, rtol, atol):
    dt = max(effective_dtype(a), effective_dtype(b),
             key=lambda d: _DEFAULT_RTOL.get(d, 1e-6))
    rtol = rtol if rtol is not None else _DEFAULT_RTOL.get(dt, 1e-5)
    atol = atol if atol is not None else _DEFAULT_ATOL.get(dt, 1e-6)
    return rtol, atol


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    rtol, atol = _tols(a, b, rtol, atol)
    return _np.allclose(_as_np(a).astype(_np.float64),
                        _as_np(b).astype(_np.float64),
                        rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Tolerance-aware comparison with a located mismatch report
    (reference: test_utils.assert_almost_equal)."""
    rtol, atol = _tols(a, b, rtol, atol)
    a_np = _as_np(a).astype(_np.float64)
    b_np = _as_np(b).astype(_np.float64)
    if _np.allclose(a_np, b_np, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    diff = _np.abs(a_np - b_np)
    denom = _np.abs(b_np) + atol / max(rtol, 1e-300)
    rel = diff / _np.maximum(denom, 1e-300)
    idx = _np.unravel_index(_np.argmax(rel), rel.shape) if rel.size else ()
    raise AssertionError(
        f"{names[0]} and {names[1]} differ beyond rtol={rtol} atol={atol}: "
        f"max rel err {rel.max():.3g} at {tuple(int(i) for i in idx)} "
        f"({names[0]}={a_np[idx]!r}, {names[1]}={b_np[idx]!r}); "
        f"max abs err {diff.max():.3g}")


def _wrap_like(x, ctx):
    """``x`` (numpy) as the kind of array a test function takes: an
    NDArray on ``ctx``."""
    from .ndarray import array

    return array(x, ctx=ctx, dtype=x.dtype)


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-4,
                           ctx=None):
    """Central-difference gradient oracle for ``fn`` over NDArrays (a
    non-scalar output is summed), held against ``autograd`` in float64
    on ``ctx`` (default: :func:`default_context`; the inputs may be
    NDArrays, tensors or numpy). Reference: check_numeric_gradient."""
    from . import autograd

    ctx = ctx or default_context()
    base = [_as_np(x).astype(_np.float64) for x in inputs]
    xs = [_wrap_like(b, ctx) for b in base]
    for x in xs:
        x.attach_grad()
    with autograd.record():
        out = fn(*xs)
        if out.shape not in ((), (1,)):
            out = out.sum()
    out.backward()
    for k, x in enumerate(xs):
        num = _np.zeros_like(base[k])
        flat = base[k].reshape(-1)
        for i in range(flat.size):
            for sgn in (+1, -1):
                pert = flat.copy()
                pert[i] += sgn * eps
                val = fn(*[_wrap_like(pert.reshape(base[k].shape), ctx)
                           if j == k else xs[j]
                           for j in range(len(xs))])
                val = val.sum() if val.shape not in ((), (1,)) else val
                num.reshape(-1)[i] += sgn * float(_as_np(val).reshape(()))
        num /= 2 * eps
        assert_almost_equal(x.grad, num, rtol=rtol, atol=atol,
                            names=(f"autograd[{k}]", f"numeric[{k}]"))


def check_consistency(fn, inputs, ctx_list=None, rtol=None, atol=None):
    """Run ``fn`` on each context's copy of ``inputs`` (NDArrays) and
    compare every result with the first context's (reference:
    check_consistency; default ``[cpu(0), the card]``, the card only when
    one is present)."""
    from .ndarray import array

    if ctx_list is None:
        ctx_list = [cpu(0)] + ([gpu(0)] if torch.cuda.is_available() else [])
    results = []
    for ctx in ctx_list:
        xs = [array(_as_np(x), ctx=ctx) for x in inputs]
        out = fn(*xs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        results.append([_as_np(o) for o in outs])
    first = results[0]
    for ctx, res in zip(ctx_list[1:], results[1:]):
        for i, (a, b) in enumerate(zip(first, res)):
            assert_almost_equal(
                a, b, rtol=rtol, atol=atol,
                names=(f"{ctx_list[0]}[{i}]", f"{ctx}[{i}]"))
    return results
