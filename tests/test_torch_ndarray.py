"""The port's ``mx.nd`` NDArray held against the JAX package's on the CPU.

Each case of ``tests/test_ndarray.py`` (creation through iteration, and
the fluent methods) runs the same calls on both packages, the port under
``with mx.cpu():``, and compares what comes back: bit for bit for add,
sub, mul, div, sqrt, the comparisons, the scalar ops (bf16 included) and
every case that moves or indexes data; to 1e-6 relative for the
transcendental functions and the reductions (the reduction's error
measured against the largest magnitude of its output); to 1e-5 for
``dot`` and ``batch_dot`` (f32 sums in another order). Then the points
where the port follows the reference rather than PyTorch's habit, or
differs from it by design (ROADMAP.md, port queue 3), each its own test.

Inputs are drawn with numpy ``RandomState`` inside each case, so both
packages see the same numbers.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError


def _value(v):
    if hasattr(v, "asnumpy"):
        a = v.asnumpy()
        return a.astype(np.float32) if str(a.dtype) == "bfloat16" else a
    return np.asarray(v)


def _dtype(v):
    return str(v.dtype) if hasattr(v, "dtype") else type(v).__name__


def both(case):
    """``case(mx)`` run on the JAX package and on the port (on the CPU)."""
    want = case(jmx)
    with mx.cpu():
        got = case(mx)
    return want, got


def check(case, rtol=0.0):
    want, got = both(case)
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        wv, gv = _value(w), _value(g)
        assert _dtype(w) == _dtype(g), (i, _dtype(w), _dtype(g))
        assert wv.shape == gv.shape, (i, wv.shape, gv.shape)
        if rtol == 0.0:
            np.testing.assert_array_equal(gv, wv, err_msg=f"result {i}")
        else:
            scale = max(float(np.abs(wv).max()), np.finfo(np.float32).tiny) \
                if wv.size else 1.0
            err = float(np.abs(gv.astype(np.float64) - wv).max()) \
                if wv.size else 0.0
            assert err <= rtol * scale, (i, err, scale)


def _rand(shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# tests/test_ndarray.py, case by case
# ---------------------------------------------------------------------------


def _creation(mx):
    return [mx.nd.zeros((2, 3)), mx.nd.ones((4,), dtype="int32"),
            mx.nd.full((2, 2), 3.5),
            mx.nd.array([[1, 2], [3, 4]], dtype="float32"),
            mx.nd.arange(2, 11, 3), mx.nd.array(np.array([1.0, 2.0])),
            mx.nd.array(np.array([1, 2], dtype=np.int64)),
            mx.nd.zeros_like(mx.nd.ones((2, 2))),
            mx.nd.array([[1, 2], [3, 4]]).size,
            mx.nd.array([[1, 2], [3, 4]]).ndim]


def _arithmetic(mx):
    x, y = mx.nd.array(_rand((3, 4))), mx.nd.array(_rand((3, 4), 1))
    return [x + y, y - x, x * y, y / x, x + 1, 2 * x, 1 - x, 8 / x, -x,
            x + mx.nd.array(_rand((4,), 2)), abs(x)]


def _inplace(mx):
    x = mx.nd.array(_rand((2, 2)))
    out = []
    for step in (lambda v: v.__iadd__(1), lambda v: v.__imul__(3),
                 lambda v: v.__itruediv__(2), lambda v: v.__isub__(1)):
        x = step(x)
        out.append(x.copy())
    return out


def _comparisons(mx):
    x, y = mx.nd.array([1, 2, 3.5]), mx.nd.array([3, 2, 1])
    return [x == y, x != y, x > y, x >= 2, x < y, x <= 2,
            mx.nd.array([1, 2, 3], dtype="int32") > 1]


def _indexing(mx):
    x = mx.nd.array(np.arange(24).reshape(2, 3, 4))
    return [x[0], x[1, 2], x[0, 1, 2], x[:, 1], x[0, :, 1:3], x[-1],
            x[mx.nd.array([1, 0])]]


def _setitem(mx):
    x = mx.nd.zeros((3, 3))
    x[1] = 1
    x[0, 2] = 5
    a = x.copy()
    x[:] = 9
    x[0:2, 0:2] = mx.nd.ones((2, 2)) * 7
    x[2] = np.array([1.5, 2.5, 3.5])
    return [a, x]


def _view_write_through(mx):
    x = mx.nd.array(np.arange(6).reshape(2, 3))
    v = x[0]
    v[:] = -1
    a = x.copy()
    x[0, 1] = 42
    return [a, v, x]


def _reshape(mx):
    x = mx.nd.array(np.arange(6))
    r = x.reshape(2, 3)
    r[0, 0] = 99
    y = mx.nd.zeros((2, 3, 4))
    return [x, r, mx.nd.Reshape(y, shape=(0, -1)),
            mx.nd.Reshape(y, shape=(-2,)), mx.nd.Reshape(y, shape=(-3, 4)),
            mx.nd.Reshape(y, shape=(-4, 1, 2, -2)), y.reshape((6, -1))]


def _astype_copy(mx):
    x = mx.nd.array([1.5, 2.5, -3.7])
    c = x.copy()
    c[0] = 100
    return [x.astype("int32"), x.astype("float16"), x, c,
            x.astype("bfloat16")]


def _scalars(mx):
    x = mx.nd.array([3.5])
    return [float(x), x.asscalar(), int(mx.nd.array([7], dtype="int32")),
            len(mx.nd.ones((3, 2)))]


def _out_kwarg(mx):
    x = mx.nd.array(np.abs(_rand((5,))))
    out = mx.nd.zeros((5,))
    mx.nd.sqrt(x, out=out)
    return [out, mx.nd.sqrt(x)]


def _concat_split_stack(mx):
    a, b = mx.nd.array(_rand((2, 3))), mx.nd.array(_rand((2, 3), 1))
    parts = mx.nd.split(mx.nd.concat(a, b, dim=0), num_outputs=2, axis=0)
    return [mx.nd.concat(a, b, dim=0), mx.nd.concat(a, b, dim=1), *parts,
            mx.nd.stack(a, b, axis=0), mx.nd.stack(a, b, axis=2)]


def _broadcast(mx):
    x, y = mx.nd.array(_rand((2, 1, 3))), mx.nd.array(_rand((1, 4, 3), 1))
    return [mx.nd.broadcast_add(x, y), mx.nd.broadcast_mul(x, y),
            mx.nd.broadcast_to(mx.nd.array(_rand((1, 3))), shape=(5, 3)),
            mx.nd.broadcast_to(mx.nd.array(_rand((1, 3))), shape=(0, 3))]


def _take_pick_onehot(mx):
    x = mx.nd.array(np.arange(12).reshape(3, 4))
    return [mx.nd.take(x, mx.nd.array([0, 2], dtype="int32")),
            mx.nd.take(x, mx.nd.array([0, 5])),
            mx.nd.pick(x, mx.nd.array([1, 0, 3]), axis=1),
            mx.nd.pick(x, mx.nd.array([1, 0, 7]), axis=1, mode="wrap"),
            mx.nd.one_hot(mx.nd.array([0, 2]), depth=3),
            mx.nd.one_hot(mx.nd.array([1, 0]), depth=3, on_value=5.0,
                          off_value=-1.0)]


def _shape_ops(mx):
    x = mx.nd.array(_rand((2, 3, 4)))
    return [x.T, x.transpose((1, 0, 2)), x.swapaxes(0, 2),
            x.expand_dims(1), mx.nd.ones((1, 3, 1)).squeeze(),
            x.flatten(), x.flip(1), x.tile((2, 1, 1)),
            mx.nd.repeat(x, repeats=2, axis=1),
            x.slice(begin=(0, 1), end=(2, 3)), x.slice_axis(2, 1, 3),
            mx.nd.moveaxis(x, 0, -1), x.clip(-0.5, 0.5),
            mx.nd.where(x > 0, x, -x), mx.nd.add_n(x, x, x),
            mx.nd.maximum(x, 0.25), mx.nd.minimum(x, x * 0.5)]


def _more_shape_ops(mx):
    x = mx.nd.array(_rand((2, 3, 4)))
    img = mx.nd.array(_rand((1, 2, 3, 4), 4))
    return [*mx.nd.split_v2(x, sections=2, axis=2),
            *mx.nd.split_v2(x, indices=(1,), axis=1),
            mx.nd.split(x, num_outputs=3, axis=1, squeeze_axis=True)[1],
            mx.nd.broadcast_axis(mx.nd.ones((1, 3)), axis=0, size=4),
            mx.nd.Pad(img, mode="constant", pad_width=(0, 0, 0, 0, 1, 1, 2, 2),
                      constant_value=1.5),
            mx.nd.Pad(img, mode="edge", pad_width=(0, 0, 0, 0, 1, 0, 0, 2)),
            mx.nd.Pad(img, mode="reflect", pad_width=(0, 0, 0, 0, 1, 1, 1, 1)),
            mx.nd.reshape_like(x, mx.nd.zeros((4, 6))),
            mx.nd.slice_like(x, mx.nd.zeros((1, 2, 3)), axes=(0, 2)),
            mx.nd.Reshape(x, shape=(-1, 0), reverse=True)]


def _ordering(mx):
    x = mx.nd.array(np.random.RandomState(3).permutation(24).reshape(4, 6)
                    .astype(np.float32))
    return [x.argmax(axis=1), x.argmin(axis=0), x.argmax(),
            x.topk(k=2), x.topk(k=3, ret_typ="value", is_ascend=True),
            x.topk(axis=0, k=2, ret_typ="mask"), x.sort(),
            mx.nd.sort(x, is_ascend=False), x.argsort(),
            x.argsort(axis=0, is_ascend=False)]


def _bf16_matmul(mx):
    x = mx.nd.ones((4, 4), dtype="bfloat16")
    return [mx.nd.dot(x, x)]


def _iter_len(mx):
    x = mx.nd.array([[1, 2], [3, 4], [5, 6]])
    return [r for r in x]


def _fluent_exact(mx):
    a = mx.nd.array([[4.0, 1.0], [2.0, 3.0]])
    return [a.sort(), a.floor(), a.ceil(), a.round(), a.relu(),
            a.zeros_like(), a.ones_like(),
            mx.nd.ones((1, 2)).broadcast_to((3, 2)),
            mx.nd.ones((1, 2)).broadcast_like(mx.nd.zeros((3, 2))),
            mx.nd.ones((4, 4)).slice_like(mx.nd.zeros((2, 3))),
            *mx.nd.ones((2, 4)).split(num_outputs=2, axis=1),
            a.pick(mx.nd.array([0.0, 1.0])), a.square(), a.sqrt(), a.abs(),
            a.sign(), a.diag(), a.shape_array(), a.size_array()]


EXACT = {"creation": _creation, "arithmetic": _arithmetic,
         "inplace": _inplace, "comparisons": _comparisons,
         "indexing": _indexing, "setitem": _setitem,
         "view_write_through": _view_write_through, "reshape": _reshape,
         "astype_copy": _astype_copy, "scalars": _scalars,
         "out_kwarg": _out_kwarg, "concat_split_stack": _concat_split_stack,
         "broadcast": _broadcast, "take_pick_onehot": _take_pick_onehot,
         "shape_ops": _shape_ops, "more_shape_ops": _more_shape_ops,
         "ordering": _ordering,
         "bf16_matmul": _bf16_matmul, "iter_len": _iter_len,
         "fluent": _fluent_exact}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_bit_exact_cases(name):
    check(EXACT[name])


_UNARY = ["exp", "log", "log2", "log10", "log1p", "expm1", "sin", "cos",
          "tan", "arcsin", "arctan", "sinh", "cosh", "tanh", "sigmoid",
          "rsqrt", "cbrt", "erf", "gammaln", "softsign", "degrees",
          "arcsinh"]


@pytest.mark.parametrize("op", _UNARY)
def test_transcendental(op):
    lo = 0.05 if op in ("log", "log2", "log10", "rsqrt", "cbrt",
                        "gammaln") else -0.9
    check(lambda mx: [getattr(mx.nd, op)(
        mx.nd.array(_rand((4, 5), 7, lo, 0.95)))], rtol=1e-6)


def _reductions(mx):
    x = mx.nd.array(_rand((3, 4, 5)))
    return [x.sum(), mx.nd.sum(x, axis=1), mx.nd.mean(x, axis=(0, 2)),
            mx.nd.max(x, axis=2, keepdims=True), mx.nd.min(x, axis=0),
            mx.nd.norm(x), x.norm(ord=1, axis=1),
            mx.nd.sum(x, axis=1, exclude=True), x.prod(axis=2),
            x.mean(keepdims=True), mx.nd.softmax(x), x.log_softmax(axis=1),
            x ** 2, mx.nd.power(2.0, x)]


def _products(mx):
    rs = np.random.RandomState(5)
    a, b = rs.randn(3, 4).astype(np.float32), rs.randn(4, 5).astype(
        np.float32)
    x, y = rs.randn(2, 3, 4).astype(np.float32), rs.randn(2, 4, 5).astype(
        np.float32)
    return [mx.nd.dot(mx.nd.array(a), mx.nd.array(b)),
            mx.nd.dot(mx.nd.array(a), mx.nd.array(b.T), transpose_b=True),
            mx.nd.dot(mx.nd.array(a.T), mx.nd.array(b), transpose_a=True),
            mx.nd.dot(mx.nd.array(x), mx.nd.array(b)),
            mx.nd.batch_dot(mx.nd.array(x), mx.nd.array(y)),
            mx.nd.batch_dot(mx.nd.array(x), mx.nd.array(x),
                            transpose_b=True)]


def test_reductions():
    check(_reductions, rtol=1e-6)


def test_dot_batch_dot():
    check(_products, rtol=1e-5)


def test_context_movement():
    with mx.cpu():
        x = mx.nd.ones((2, 2))
    assert x.context == mx.cpu(0) and str(x.context) == "cpu(0)"
    assert x.as_in_context(mx.cpu(0)) is x
    z = x.copyto(mx.cpu(0))
    assert z is not x and np.array_equal(z.asnumpy(), x.asnumpy())
    w = mx.nd.zeros((2, 2), ctx=mx.cpu())
    x.copyto(w)
    assert (w.asnumpy() == 1).all()
    assert hash(mx.cpu(0)) == hash(mx.Context("cpu", 0))


def test_dlpack_interchange():
    x = mx.nd.array([1.0, 2.0], ctx=mx.cpu())
    assert torch.equal(torch.from_dlpack(x), x._data)


def test_wait_and_waitall():
    with mx.cpu():
        y = mx.nd.ones((10, 10)) * 2
    y.wait_to_read()
    mx.nd.waitall()
    assert (y.asnumpy() == 2).all()


def test_strict_elemwise_shapes():
    with pytest.raises(ValueError):
        jmx.nd.elemwise_add(jmx.nd.ones((2, 3)), jmx.nd.ones((3,)))
    with mx.cpu(), pytest.raises(ValueError):
        mx.nd.elemwise_add(mx.nd.ones((2, 3)), mx.nd.ones((3,)))


def test_attach_grad_detach_and_fluent_grads():
    def case(m, ag):
        a = m.nd.array([0.3, 0.7, -1.2])
        a.attach_grad()
        assert a.grad is not None and (a.grad.asnumpy() == 0).all()
        assert a.detach()._grad_req == "null"
        with ag.record():
            loss = (a.sin() * a).sum()
        loss.backward()
        return a.grad.asnumpy()

    want = case(jmx, jag)
    with mx.cpu():
        got = case(mx, mx.autograd)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the points of the reference that PyTorch's habit would break
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_scalar_is_cast_first(dtype):
    """A scalar operand takes the array's dtype before the op
    (elemwise.py:93-96): bf16 x * 0.1 is x * bf16(0.1), bit for bit."""
    def case(mx):
        x = mx.nd.array(_rand((64,), 11, 0.1, 3.0), dtype=dtype)
        return [x * 0.1, x + 0.3, x - 0.7, 0.5 - x, 2.0 / x, x % 0.3,
                x ** 2.0, mx.nd.maximum(x, 1.1)]
    check(case)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_scalar_division(dtype):
    """x / s divides by dtype(s), correctly rounded, as MXNet's mshadow
    div does. The JAX package's eager op bakes s in as a constant and
    XLA rewrites x / c to x * (1 / c) (seen in its compiled HLO), which
    can differ by one ulp of x's dtype: held to that ulp, and the port
    bit for bit against IEEE division of the same operands."""
    x_np = _rand((64,), 11, 0.1, 3.0)
    want, got = both(lambda mx: [mx.nd.array(x_np, dtype=dtype) / 3.0])
    g, w = _value(got[0]), _value(want[0])
    ulp = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10,
           "float32": 2.0 ** -23}[dtype]
    assert np.all(np.abs(g - w) <= ulp * np.abs(w))
    xt = torch.from_numpy(x_np).to(getattr(torch, dtype))
    ieee = (xt.double() / 3.0).float().to(xt.dtype).float().numpy() \
        if dtype == "bfloat16" else (xt / 3.0).float().numpy()
    np.testing.assert_array_equal(g, ieee)


def test_int_scalar_truncates():
    def case(mx):
        x = mx.nd.array([1, 2, 3, -4], dtype="int32")
        return [x * 2.5, x + 1.9, x - 2.7, x * -1.5]
    want, got = both(case)
    for w, g in zip(want, got):
        assert _dtype(g) == _dtype(w) == "int32"
        np.testing.assert_array_equal(_value(g), _value(w))
    np.testing.assert_array_equal(_value(got[0]), [2, 4, 6, -8])


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_comparisons_keep_the_input_dtype(dtype):
    def case(mx):
        x = mx.nd.array([1, 2, 3], dtype=dtype)
        y = mx.nd.array([3, 2, 1], dtype=dtype)
        return [x == y, x != 2, x > y, x <= 2.0]
    want, got = both(case)
    for w, g in zip(want, got):
        assert _dtype(g) == _dtype(w) == dtype
        np.testing.assert_array_equal(_value(g), _value(w))


def test_mod_takes_the_sign_of_the_divisor():
    def case(mx):
        x = mx.nd.array([-7.0, -2.5, 2.5, 7.0])
        return [x % 3, x % -3, mx.nd.broadcast_mod(x, mx.nd.array([-2.0])),
                5 % x]
    check(case)
    with mx.cpu():
        got = (mx.nd.array([-7.0, 7.0]) % 3).asnumpy()
    np.testing.assert_array_equal(got, [2.0, 1.0])


def test_views_write_through_and_ndarray_index_copies():
    with mx.cpu():
        x = mx.nd.array(np.arange(12).reshape(3, 4))
        r = x.reshape(4, 3)
        v = x[1:3, 1]
        c = x[mx.nd.array([0, 1])]
        r[0, 0] = -1
        v[:] = 50
        c[:] = 0
        x[2] = 7
    got = x.asnumpy()
    want = np.arange(12).reshape(3, 4).astype(np.float32)
    want[0, 0], want[1:3, 1], want[2] = -1, 50, 7
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(v.asnumpy(), [50, 7])
    np.testing.assert_array_equal(r.asnumpy().reshape(3, 4), want)
    with mx.cpu(), pytest.raises(MXNetError, match="not a view"):
        x[:, 1:3].reshape(6)


def test_inplace_outside_record_writes_a_leaf():
    """MXNet's manual update, w[:] = w - lr * w.grad, on an array with a
    gradient attached: PyTorch refuses an in-place write to a leaf that
    requires a gradient unless grad mode is off, as it is outside
    record()."""
    def case(m, ag):
        w = m.nd.array(_rand((3,), 4))
        w.attach_grad()
        with ag.record():
            loss = (w * w).sum()
        loss.backward()
        w[:] = w - 0.1 * w.grad
        w -= 0.1 * w.grad
        return w.asnumpy()

    want = case(jmx, jag)
    with mx.cpu():
        got = case(mx, mx.autograd)
    np.testing.assert_array_equal(got, want)


def test_inplace_inside_record_raises_at_the_write():
    for m, ag, err in ((jmx, jag, jmx.base.MXNetError),
                       (mx, mx.autograd, MXNetError)):
        with mx.cpu():
            w = m.nd.array([1.0, 2.0])
            w.attach_grad()
            with ag.record():
                y = w * 2
                with pytest.raises(err, match="in-place"):
                    y += 1
                with pytest.raises(err, match="in-place"):
                    w[0] = 5.0
                z = m.nd.ones((2,))         # not on the tape: allowed
                z[:] = 3.0
            assert (z.asnumpy() == 3).all()


def test_write_after_record_copies_on_write():
    """A write outside record() to an array a live graph saved: the base
    array swaps in a fresh tensor (the reference's functional swap), so
    backward differentiates what was recorded and the array holds what
    was written; the same write through a view raises."""
    def case(m, ag):
        w = m.nd.array(_rand((4,), 9))
        w.attach_grad()
        x = m.nd.array(_rand((4,), 10))
        with ag.record():
            loss = (w * x).sum()
        x[:] = 100.0               # x was saved, as dloss/dw
        w[:] = 0.0                 # w was saved, as dloss/dx's factor
        loss.backward()
        return [w.grad.asnumpy(), x.asnumpy(), w.asnumpy()]

    want = case(jmx, jag)
    with mx.cpu():
        got = case(mx, mx.autograd)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    with mx.cpu():
        x = mx.nd.array(_rand((2, 4), 12))
        w = mx.nd.array(_rand((4,), 13))
        w.attach_grad()
        view = x[0]
        with mx.autograd.record():
            loss = (w * x).sum()
        with pytest.raises(MXNetError, match="view"):
            view[:] = 1.0
        loss.backward()
        view[:] = 1.0              # the graph is gone: allowed
    assert (x.asnumpy()[0] == 1).all()


def test_copy_on_write_keeps_views_on_the_base():
    with mx.cpu():
        x = mx.nd.array(_rand((2, 3), 14))
        w = mx.nd.array(_rand((3,), 15))
        w.attach_grad()
        v = x[1]
        with mx.autograd.record():
            loss = (x * w).sum()
        x[:] = 2.0                  # swaps x's tensor
        assert (v.asnumpy() == 2).all()   # the view follows the swap
        loss.backward()
    np.testing.assert_allclose(w.grad.asnumpy(),
                               _rand((2, 3), 14).sum(axis=0), rtol=1e-6)


def test_default_context_is_the_card():
    """mx.nd.array with no ctx goes to current_context(): gpu(0) in the
    port, cpu(0) in the reference (context.py:180-183)."""
    assert jmx.nd.array([1.0]).context == jmx.cpu(0)
    with mx.cpu():
        assert mx.current_context() == mx.cpu(0)
        assert mx.nd.array([1.0]).context == mx.cpu(0)
    if torch.cuda.is_available():
        assert mx.nd.array([1.0]).context == mx.gpu(0)
    else:
        with pytest.raises(MXNetError, match="gpu"):
            mx.nd.array([1.0])
        with pytest.raises(MXNetError, match="gpu"):
            mx.nd.zeros((2,))


def test_bf16_asnumpy_gives_float32():
    with mx.cpu():
        x = mx.nd.array(np.array([1.0, 2.5, 3.0e-3], np.float32),
                        dtype="bfloat16")
    assert x.dtype == "bfloat16" and x._data.dtype == torch.bfloat16
    a = x.asnumpy()
    assert a.dtype == np.float32
    want = jmx.nd.array(np.array([1.0, 2.5, 3.0e-3], np.float32),
                        dtype="bfloat16").asnumpy().astype(np.float32)
    np.testing.assert_array_equal(a, want)


def test_asnumpy_is_a_copy_and_array_copies_its_source():
    src = np.arange(4, dtype=np.float32)
    with mx.cpu():
        x = mx.nd.array(src)
    src[0] = 9
    a = x.asnumpy()
    a[1] = 9
    np.testing.assert_array_equal(x.asnumpy(), [0, 1, 2, 3])


def test_ndarray_wraps_a_tensor_without_a_copy():
    t = torch.zeros(3)
    x = mx.nd.NDArray(t)
    x[:] = 2.0
    assert (t == 2).all() and x.context == mx.cpu()
    with pytest.raises(TypeError):
        mx.nd.NDArray(np.zeros(3))


def test_nd_and_rtc_import_no_jax():
    code = ("import sys\nimport mxnet_tpu_torch as mx\n"
            "import mxnet_tpu_torch.ndarray, mxnet_tpu_torch.rtc\n"
            "assert mx.nd.NDArray and mx.rtc.CudaModule\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# edge inputs where torch's own op differs from the reference: ties, +-0,
# +-inf, NaN, non-power-of-two scalars, integer dtypes (each case runs the
# same numpy inputs through both packages)
# ---------------------------------------------------------------------------


def check_bits(case):
    """``check``, and each zero's sign as the reference's (NaN's sign
    bit is not compared)."""
    check(case)
    want, got = both(case)
    for i, (w, g) in enumerate(zip(want, got)):
        wv, gv = _value(w), _value(g)
        if wv.dtype.kind == "f":
            z = wv == 0
            np.testing.assert_array_equal(np.signbit(gv[z]), np.signbit(wv[z]),
                                          err_msg=f"zero signs, result {i}")


def _ag(m):
    return jag if m is jmx else mx.autograd


def _grads(m, f, *arrays, dtype="float32"):
    """The gradients of sum(f(m, *xs)) for each array of ``arrays``."""
    xs = [m.nd.array(np.asarray(a, dtype=np.float32), dtype=dtype)
          for a in arrays]
    for x in xs:
        x.attach_grad()
    with _ag(m).record():
        loss = f(m, *xs).sum()
    loss.backward()
    return [x.grad for x in xs]


_SPECIALS = [0.0, -0.0, np.inf, -np.inf, np.nan, 7.0, -2.5]

_RDIV = {
    "f32_3_over_7": ("float32", 3.0, [7.0, 7.0, 11.0, 0.7, 13.0]),
    "f16_neg1.5_over_2.5": ("float16", -1.5, [2.5, 2.5, 0.3, 7.0]),
    "bf16_3_over_x": ("bfloat16", 3.0, _rand((64,), 21, 0.1, 9.0)),
    "f32_specials": ("float32", 3.0, _SPECIALS),
    "bf16_specials": ("bfloat16", -0.7, _SPECIALS),
}


@pytest.mark.parametrize("name", sorted(_RDIV))
def test_rdiv_scalar_is_correctly_rounded(name):
    """``s / x`` divides two operands of x's dtype, correctly rounded
    (torch takes a scalar over a tensor as s * (1 / x))."""
    dtype, s, x = _RDIV[name]
    check_bits(lambda m: [s / m.nd.array(np.asarray(x, np.float32),
                                         dtype=dtype)])


_TIES = np.array([[5, 5, 5, 1], [0, 0, 0, 0]], dtype=np.float32)


@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("ret_typ", ["indices", "value", "mask", "both"])
def test_topk_breaks_ties_in_index_order(ret_typ, is_ascend):
    def case(m):
        out = m.nd.topk(m.nd.array(_TIES), k=2, ret_typ=ret_typ,
                        is_ascend=is_ascend)
        return list(out) if ret_typ == "both" else [out]
    check(case)


@pytest.mark.parametrize("is_ascend", [False, True])
def test_topk_value_gradient_at_ties(is_ascend):
    check(lambda m: _grads(m, lambda m, x: m.nd.topk(
        x, k=2, ret_typ="value", is_ascend=is_ascend), _TIES))


_CBRT_IN = [1e38, 1e-30, 1e3, 0.0, -0.0, np.nan, -27.0, 5.0, -1e-3]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("op", ["cbrt", "rcbrt"])
def test_cbrt_rounds_once_and_keeps_the_sign_of_zero(op, dtype):
    """The cube root taken in f32 and rounded once to x's dtype: bf16 bit
    for bit (a power taken in bf16 is 6% off at 1e38). XLA's
    own f16 and f32 cube roots are not correctly rounded (cbrt(1000) is
    9.99 in f16; up to 9e-7 relative in f32), so f16 is held to two ulps
    (rcbrt divides the reference's ulp-off root, rounding once more) and
    f32 to 2**-20. -0 stays -0 and rcbrt(-0) is -inf."""
    def case(m):
        return [getattr(m.nd, op)(m.nd.array(np.asarray(_CBRT_IN,
                                                        np.float32),
                                             dtype=dtype))]
    want, got = both(case)
    wv, gv = _value(want[0]), _value(got[0])
    assert _dtype(got[0]) == _dtype(want[0])
    if dtype == "bfloat16":
        np.testing.assert_array_equal(gv, wv)
    else:
        rtol = 2.0 ** -9 if dtype == "float16" else 2.0 ** -20
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=0)
    z = (wv == 0) | np.isinf(wv)
    np.testing.assert_array_equal(np.signbit(gv[z]), np.signbit(wv[z]))


@pytest.mark.parametrize("op", ["cbrt", "rcbrt"])
def test_cbrt_gradient_at_zero(op):
    """inf (cbrt) and -inf (rcbrt) at +-0, as jnp.cbrt's 1/3 * y**-2."""
    want, got = both(lambda m: _grads(
        m, lambda m, x: getattr(m.nd, op)(x), [0.0, -0.0, 8.0, -1.0, 2.0]))
    np.testing.assert_allclose(_value(got[0]), _value(want[0]), rtol=1e-6)


_ARANGE = {f"{a}_{b}_{s}_{dt}": (a, b, s, dt, 1)
           for a, b, s in ((0, 10, 0.1), (-3, 3, 0.7))
           for dt in ("float32", "float16", "bfloat16")}
_ARANGE["repeat"] = (0, 1, 0.3, "float32", 2)
_ARANGE["repeat_bf16"] = (-1, 2, 0.45, "bfloat16", 3)


@pytest.mark.parametrize("name", sorted(_ARANGE))
def test_arange_with_a_fractional_step(name):
    """start + i * step computed in the output dtype (np.arange's fill),
    not each value in f64 and then rounded."""
    a, b, s, dt, rep = _ARANGE[name]
    check(lambda m: [m.nd.arange(a, b, s, repeat=rep, dtype=dt)])


_NEG_STEP = {
    "rows_and_every_other_column": (slice(None, None, -1),
                                    slice(None, None, -2)),
    "rows": slice(None, None, -1),
    "from_row_1_down": slice(1, None, -1),
    "columns_by_3": (slice(None), slice(None, None, -3)),
    "rows_by_2_one_column": (slice(None, None, -2), 1),
    "ellipsis": (Ellipsis, slice(None, None, -1)),
    "past_the_end": slice(5, 0, -1),
    "empty": slice(0, 2, -1),
}


@pytest.mark.parametrize("name", sorted(_NEG_STEP))
def test_negative_step_getitem(name):
    key = _NEG_STEP[name]
    check(lambda m: [m.nd.array(np.arange(12, dtype=np.float32)
                                .reshape(3, 4))[key]])


@pytest.mark.parametrize("value", ["ndarray", "scalar", "numpy", "row"])
def test_negative_step_setitem(value):
    def case(m):
        x = m.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        v = {"ndarray": m.nd.array(np.arange(100, 106, dtype=np.float32)
                                   .reshape(3, 2)),
             "scalar": 7.0,
             "numpy": np.arange(50, 56, dtype=np.float32).reshape(3, 2),
             "row": m.nd.array(np.array([1.0, 2.0], np.float32))}[value]
        x[::-1, ::-2] = v
        return [x]
    check(case)


def test_negative_step_gradient():
    w = _rand((3, 2), 5)
    check(lambda m: _grads(m, lambda m, x: x[::-1, ::-2] * m.nd.array(w),
                           np.arange(12, dtype=np.float32).reshape(3, 4)))


_INT_EDGES = {
    "broadcast_mod_by_zero": lambda m, x: m.nd.broadcast_mod(
        m.nd.array([5, -5, 0, 7, 3, 9, -9], dtype="int32"), x),
    "mod_scalar_zero": lambda m, x: x % 0,
    "rmod_scalar_by_zero": lambda m, x: 5 % x,
    "broadcast_hypot": lambda m, x: m.nd.broadcast_hypot(x, x + 1),
    "hypot_scalar": lambda m, x: m.nd._hypot_scalar(x, scalar=3),
    "power_scalar_minus_2": lambda m, x: x ** -2.0,
    "power_scalar_minus_1": lambda m, x: x ** -1.0,
    "power_scalar_70": lambda m, x: x ** 70.0,
    "broadcast_power": lambda m, x: m.nd.broadcast_power(x, -x),
}


@pytest.mark.parametrize("name", sorted(_INT_EDGES))
def test_integer_edge_cases(name):
    """int32: a zero divisor gives 0; hypot gives float32; a negative
    exponent gives jnp's binary exponentiation over the exponent's low
    six bits (wrapping as int32 does)."""
    check(lambda m: [_INT_EDGES[name](
        m, m.nd.array([1, 0, -3, 7, 0, 2, -1], dtype="int32"))])


@pytest.mark.parametrize("s", [0.5, -0.5, 1.5, -1.5, 3.0, -1.0, 2.0])
def test_power_scalar_at_minus_inf_and_zero(s):
    """C's pow at -inf and +-0: (-inf) ** 0.5 is +inf, (-0) ** 0.5 +0
    (torch takes +-0.5 through sqrt/rsqrt)."""
    check_bits(lambda m: [m.nd.array(np.asarray(_SPECIALS[:5], np.float32))
                          ** s])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_sign_of_nan_and_negative_zero(dtype):
    check_bits(lambda m: [m.nd.sign(m.nd.array(
        np.asarray(_SPECIALS, np.float32), dtype=dtype))])


_KINKS = {
    "clip_at_bounds": (lambda m, x: m.nd.clip(x, a_min=-1.0, a_max=1.0),
                       [[-1.0, 1.0, 0.5, 2.0, -3.0]]),
    "maximum_scalar_tie": (lambda m, x: m.nd._maximum_scalar(x, scalar=1.0),
                           [[1.0, 0.5, 2.0]]),
    "minimum_scalar_tie": (lambda m, x: m.nd._minimum_scalar(x, scalar=1.0),
                           [[1.0, 0.5, 2.0]]),
    "abs_at_zero": (lambda m, x: m.nd.abs(x),
                    [[0.0, -0.0, -1.0, 2.0, np.nan]]),
    "power_at_zero": (lambda m, x, y: m.nd.broadcast_power(x, y),
                      [[0.0, 1.5, 0.0, 0.0], [0.0, 0.0, 2.0, 0.5]]),
    "hypot_at_zero": (lambda m, x, y: m.nd.broadcast_hypot(x, y),
                      [[0.0, -0.0, 4.0, 2.0], [0.0, 0.0, 3.0, -0.0]]),
    "sign": (lambda m, x: m.nd.sign(x), [[0.0, -0.0, 2.0, np.nan]]),
    "power_scalar_half_at_zero": (lambda m, x: x ** 0.5, [_SPECIALS]),
    "power_scalar_minus_half_at_zero": (lambda m, x: x ** -0.5, [_SPECIALS]),
    "power_scalar_minus_2_at_zero": (lambda m, x: x ** -2.0, [_SPECIALS]),
    "power_scalar_2_at_minus_inf": (lambda m, x: x ** 2.0, [_SPECIALS]),
    "power_scalar_0_at_zero": (lambda m, x: x ** 0.0, [_SPECIALS]),
}


@pytest.mark.parametrize("name", sorted(_KINKS))
def test_gradient_at_ties_and_kinks(name):
    """The reference's gradients: half at the ties of maximum, minimum
    and clip; abs 1 at +-0; power(x, 0) NaN at x = 0; hypot 1/2 at
    (0, 0); x ** s as s * x ** (s - 1) by C's pow at +-0 and -inf."""
    f, arrays = _KINKS[name]
    want, got = both(lambda m: _grads(m, f, *arrays))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_value(g), _value(w), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32", "int64"])
def test_cast_saturates(dtype):
    """A float out of the integer type's range goes to its bound, NaN to
    0, as XLA's convert does (torch's conversion wraps)."""
    check(lambda m: [m.nd.Cast(m.nd.array(np.array(
        [300.7, -300.7, np.nan, 1e10, -1e10, np.inf, -np.inf, -0.5, 2.5],
        np.float32)), dtype=dtype)])


def _pow_sweep():
    """12,000 finite positive f32 values spread over e**-80 .. e**80
    (seeded), 7.0, then 0, -0, +-inf and NaN."""
    rs = np.random.RandomState(12)
    sweep = np.exp(rs.uniform(-80.0, 80.0, 12000)).astype(np.float32)
    return np.concatenate([sweep, np.array(
        [7.0, 0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)])


def _pow_correctly_rounded(x, s):
    """``x ** s`` for finite positive f32 ``x``, rounded once to f32 from
    a 200-bit value (mpmath), ties to even."""
    import mpmath

    out = np.empty_like(x)
    with mpmath.workprec(200):
        se = mpmath.mpf(float(s))
        for i, v in enumerate(x.tolist()):
            exact = mpmath.mpf(v) ** se
            y = np.float32(float(exact))
            cands = [np.nextafter(y, np.float32(-np.inf)), y,
                     np.nextafter(y, np.float32(np.inf))]
            errs = [abs(mpmath.mpf(float(c)) - exact) for c in cands]
            best = min(errs)
            picks = [c for c, e in zip(cands, errs) if e == best]
            out[i] = min(picks, key=lambda c: int(c.view(np.int32)) & 1)
    return out


# inputs of _pow_sweep where jnp.power (XLA:CPU's f32 pow) is not
# correctly rounded: a difference by design (ROADMAP.md, queue 3)
_POW_REFERENCE_MISROUNDS = {0.5: 0, -0.5: 10, 1.0 / 3.0: 4}


@pytest.mark.parametrize("s", sorted(_POW_REFERENCE_MISROUNDS))
def test_power_scalar_matches_jnp_power_bit_for_bit(s):
    """``x ** s`` through ``**`` and ``mx.nd.power``: raised in f64 and
    rounded once, so +-0.5 never takes torch's sqrt/rsqrt rewrite (7 **
    -0.5 was one ulp off). Every value equals the reference's bits except
    where the reference is not correctly rounded (pinned by count); there
    the port is."""
    x = _pow_sweep()
    want, got = both(lambda m: [m.nd.array(x) ** s,
                                m.nd.power(m.nd.array(x), s)])
    w, g, g2 = _value(want[0]), _value(got[0]), _value(got[1])
    np.testing.assert_array_equal(g2.view(np.int32), g.view(np.int32))
    np.testing.assert_array_equal(_value(want[1]).view(np.int32),
                                  w.view(np.int32))
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan)
    finite = np.isfinite(x) & (x > 0)
    oracle = _pow_correctly_rounded(x[finite], np.float32(s))
    misround = oracle.view(np.int32) != w[finite].view(np.int32)
    assert int(misround.sum()) == _POW_REFERENCE_MISROUNDS[s]
    np.testing.assert_array_equal(g[finite].view(np.int32),
                                  oracle.view(np.int32))
    agree = ~nan
    agree[np.flatnonzero(finite)[misround]] = False
    np.testing.assert_array_equal(g[agree].view(np.int32),
                                  w[agree].view(np.int32))


# ---------------------------------------------------------------------------
# queue 3, second round: the branch of LeakyReLU, relu at -0 and NaN,
# erf-GELU at +inf, Embedding out of range, norm(ord=1) at 0; and the
# decided differences (half-precision activations, poles, underflow)
# ---------------------------------------------------------------------------

_BRANCH_X = [0.0, -0.0, np.nan, 1e-30, -1e-30, 1.5, -2.0]


def _leaky(act_type):
    def f(m, x):
        if act_type == "prelu":
            return m.nd.LeakyReLU(x, m.nd.array(np.array([0.2], np.float32),
                                                dtype=x.dtype),
                                  act_type="prelu")
        return m.nd.LeakyReLU(x, act_type=act_type,
                              slope=0.3 if act_type == "elu" else 0.1)
    return f


def _value_and_grad(m, f, x, dtype):
    a = m.nd.array(np.asarray(x, np.float32), dtype=dtype)
    a.attach_grad()
    with _ag(m).record():
        y = f(m, a)
        loss = y.sum()
    loss.backward()
    return [y, a.grad]


def _same_bits(want, got, what):
    for i, (w, g) in enumerate(zip(want, got)):
        wv, gv = _value(w), _value(g)
        assert _dtype(w) == _dtype(g), (what, i)
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv),
                                      err_msg=f"{what} NaNs, result {i}")
        ok = ~np.isnan(wv)
        np.testing.assert_array_equal(gv[ok], wv[ok],
                                      err_msg=f"{what}, result {i}")
        z = ok & (wv == 0)
        np.testing.assert_array_equal(np.signbit(gv[z]), np.signbit(wv[z]),
                                      err_msg=f"{what} zero signs, {i}")


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("act_type",
                         ["leaky", "prelu", "elu", "selu", "rrelu"])
def test_leaky_relu_takes_the_negative_branch_at_zero_and_nan(act_type,
                                                              dtype):
    """``data > 0`` picks the branch, as the reference's
    (``mxnet_tpu/ops/nn.py:856-873``): at +-0, NaN and, in f16,
    +-1e-30 (which rounds to 0) the value and the gradient are the
    negative side's, bit for bit."""
    f = _leaky(act_type)
    want, got = both(lambda m: _value_and_grad(m, f, _BRANCH_X, dtype))
    x = _value(mx.nd.array(np.asarray(_BRANCH_X, np.float32), dtype=dtype,
                           ctx=mx.cpu()))
    at = (x == 0) | np.isnan(x)              # the branch points
    assert at[:3].all() and at[3:5].all() == (dtype == "float16")
    _same_bits([_value(w)[at] for w in want], [_value(g)[at] for g in got],
               act_type)
    # elsewhere two roundings of the dtype apart at most (the port takes
    # a half expm1 in f32 and rounds once)
    tol = {"float32": 0.0, "float16": 2e-3, "bfloat16": 1.6e-2}[dtype]
    for w, g in zip(want, got):
        np.testing.assert_allclose(_value(g)[~at], _value(w)[~at], rtol=tol,
                                   atol=0.0)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_leaky_relu_gelu_at_zero_and_nan(dtype):
    """``LeakyReLU(gelu)``: the gradient 0.5 at +-0 and NaN at NaN, as
    the reference's; the values to one rounding of the dtype (the port
    computes a half input in f32 and rounds once, ROADMAP.md queue 3)."""
    want, got = both(lambda m: _value_and_grad(m, _leaky("gelu"),
                                               _BRANCH_X, dtype))
    tol = {"float32": 1e-6, "float16": 1e-3, "bfloat16": 8e-3}[dtype]
    for w, g in zip(want, got):
        wv, gv = _value(w), _value(g)
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
        ok = ~np.isnan(wv)
        np.testing.assert_allclose(gv[ok], wv[ok], rtol=tol, atol=1e-30)
    np.testing.assert_array_equal(_value(got[1])[:2], [0.5, 0.5])


_RELU_OPS = {
    "relu": lambda m, x: m.nd.relu(x),
    "Activation_relu": lambda m, x: m.nd.Activation(x, act_type="relu"),
    "maximum_scalar_0": lambda m, x: m.nd._maximum_scalar(x, scalar=0.0),
    "minimum_scalar_0": lambda m, x: m.nd._minimum_scalar(x, scalar=0.0),
    "gluon_relu": lambda m, x: m.gluon.nn.Activation("relu")(x),
}


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_RELU_OPS))
def test_relu_at_negative_zero_and_nan(name, dtype):
    """``relu(-0.0)`` is +0.0 (``jax.nn.relu``; torch keeps -0.0), and no
    gradient passes at NaN through relu or ``_maximum_scalar(x, 0)``
    (torch passes it whole); half at the tie of the scalar ops."""
    x = [0.0, -0.0, np.nan, 1.0, -1.0, np.inf, -np.inf]
    want, got = both(lambda m: _value_and_grad(m, _RELU_OPS[name], x, dtype))
    _same_bits(want, got, name)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("op", ["Activation", "LeakyReLU"])
def test_erf_gelu_at_infinity(op, dtype):
    """Erf-GELU is +inf at +inf and NaN at -inf and NaN, as the
    reference's ``x * (erf(x / sqrt2) + 1) / 2``; torch's vectorised CPU
    ``F.gelu`` gave NaN at +inf (the array is long enough to take the
    vector path). The gradients are the reference's too: NaN at +-inf."""
    x = np.tile(np.array([np.inf, -np.inf, np.nan, 0.0, 3.0, -3.0],
                         np.float32), 11)
    want, got = both(lambda m: _value_and_grad(
        m, lambda m, a: getattr(m.nd, op)(a, act_type="gelu"), x, dtype))
    # finite points: the reference's bf16 erf(x) + 1 cancels at -3 and
    # loses 2.3% (the port rounds the f32 value once); in f32 the two
    # erf implementations' ulps, amplified by the same cancellation
    tol = {"float32": 1e-5, "float16": 2e-3, "bfloat16": 3e-2}[dtype]
    for w, g in zip(want, got):
        wv, gv = _value(w), _value(g)
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
        ok = ~np.isnan(wv)
        np.testing.assert_array_equal(gv[ok & ~np.isfinite(wv)],
                                      wv[ok & ~np.isfinite(wv)])
        np.testing.assert_allclose(gv[ok], wv[ok], rtol=tol)
    assert _value(got[0])[0] == np.inf


_EMBED_IDX = {
    "int_ids": ("int32", [0, 4, 5, -1, -6]),
    "float_ids": ("float32", [0.0, 4.7, 5.0, -1.0, -6.0, 2.0]),
    "far_out": ("int32", [100000, -100000, 3, -5]),
}


@pytest.mark.parametrize("name", sorted(_EMBED_IDX))
def test_embedding_out_of_range_gives_nan_rows(name):
    """``Embedding`` as ``jnp.take``: an index in [-5, 0) counts from the
    end, one outside [-5, 5) gives a NaN row (the port gathered through
    ``F.embedding``, an IndexError here and a device-side assert on the
    card), and the weight's gradient skips the bad rows."""
    dtype, ids = _EMBED_IDX[name]
    w = np.arange(15, dtype=np.float32).reshape(5, 3)

    def case(m):
        weight = m.nd.array(w)
        weight.attach_grad()
        with _ag(m).record():
            out = m.nd.Embedding(m.nd.array(np.asarray(ids), dtype=dtype),
                                 weight, input_dim=5, output_dim=3)
            loss = (out * m.nd.array(np.arange(out.size, dtype=np.float32)
                                     .reshape(out.shape))).sum()
        loss.backward()
        return [out, weight.grad]

    want, got = both(case)
    _same_bits(want, got, name)
    if name == "int_ids":
        g = _value(got[0])
        np.testing.assert_array_equal(g[[0, 1, 3]], w[[0, 4, 4]])
        assert np.isnan(g[[2, 4]]).all()


def test_gluon_embedding_out_of_range():
    """The Gluon ``nn.Embedding`` reaches the same op: NaN rows."""
    emb = mx.gluon.nn.Embedding(5, 3)
    with mx.cpu():
        emb.initialize(ctx=mx.cpu())
        out = emb(mx.nd.array([0, 7, -1], dtype="int32")).asnumpy()
    assert np.isnan(out[1]).all() and np.isfinite(out[[0, 2]]).all()


@pytest.mark.parametrize("keepdims", [False, True])
def test_norm_ord1_gradient_at_zero(keepdims):
    """``norm(ord=1)`` takes the registered ``abs``: gradient 1 at +-0,
    as ``jnp.abs``'s (torch's ``abs`` gives 0)."""
    check(lambda m: _grads(m, lambda m, x: m.nd.norm(
        x, ord=1, axis=-1, keepdims=keepdims),
        [[0.0, -0.0, 1.0], [-2.0, 0.0, 3.0]]))


# the decided differences: pinned, ROADMAP.md "Differences by design"

@pytest.mark.parametrize("op", ["gamma", "gammaln"])
def test_gamma_gradient_is_nan_at_zero(op):
    """The gradient of ``gamma``/``gammaln`` at +-0 and at the poles is
    NaN, the reference's digamma (torch's gives -inf at +0, +inf at
    -0); elsewhere to 1e-5."""
    x = [0.0, -0.0, -1.0, -2.0, np.nan, 0.5, 1.0, 3.5]
    want, got = both(lambda m: _grads(m, lambda m, a: getattr(m.nd, op)(a),
                                      x))
    wv, gv = _value(want[0]), _value(got[0])
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
    assert np.isnan(gv[:5]).all()
    np.testing.assert_allclose(gv[5:], wv[5:], rtol=1e-5)


@pytest.mark.parametrize("act_type", ["silu", "swish", "mish"])
def test_silu_mish_gradient_is_plus_zero_below_minus_88(act_type):
    """At x <= -88 the reference's f32 sigmoid flushes to zero, and the
    gradient of silu/swish/mish there is +0.0; the port's follows (torch
    gives -0.0 or a subnormal)."""
    x = [-88.0, -88.5, -100.0, -1e4, -np.inf]
    want, got = both(lambda m: _grads(
        m, lambda m, a: m.nd.Activation(a, act_type=act_type), x))
    _same_bits(want, got, act_type)
    assert not np.signbit(_value(got[0])[:4]).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_type", ["silu", "mish"])
def test_silu_mish_gradient_above_minus_88_is_atens(act_type, dtype):
    """Above -88 the flushed gradient is ATen's, bit for bit, and the
    second-order gradient (``create_graph``) is torch's: the flush
    changes nothing else."""
    from mxnet_tpu_torch.ops.nn import _ACTIVATIONS

    fn = {"silu": torch.nn.functional.silu,
          "mish": torch.nn.functional.mish}[act_type]
    x0 = torch.from_numpy(np.random.RandomState(4).randn(257)
                          .astype(np.float32) * 20.0).clamp(min=-87.5)
    x0 = x0.to(getattr(torch, dtype))
    g = torch.linspace(-2.0, 3.0, 257).to(x0.dtype)
    outs = []
    for f in (_ACTIVATIONS[act_type], fn):
        x = x0.clone().requires_grad_()
        (gx,) = torch.autograd.grad(f(x), x, g, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.sum(), x)
        outs.append((gx.detach(), ggx))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _rounded(x64, dtype):
    import ml_dtypes

    np_dt = {"float16": np.float16, "bfloat16": ml_dtypes.bfloat16}[dtype]
    return x64.astype(np_dt).astype(np.float32)


def _f64_activation(act_type, x):
    x = x.astype(np.float64)
    from scipy.special import erf

    sp = np.logaddexp(0.0, x)
    return {"sigmoid": 1.0 / (1.0 + np.exp(-x)),
            "softrelu": sp,
            "silu": x / (1.0 + np.exp(-x)),
            "gelu": 0.5 * x * (1.0 + erf(x / np.sqrt(2.0))),
            "gelu_tanh": 0.5 * x * (1.0 + np.tanh(
                np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3))),
            "mish": x * np.tanh(sp),
            "tanh": np.tanh(x),
            "softsign": x / (1.0 + np.abs(x))}[act_type]


# (points of 2001 in [-6, 6] off the correctly rounded value: the port,
# the reference); the port computes in f32 and rounds once, the
# reference in the dtype, by design (ROADMAP.md, queue 3)
_HALF_ACT_OFF = {
    ("sigmoid", "float16"): (0, 708), ("sigmoid", "bfloat16"): (0, 754),
    ("softrelu", "float16"): (0, 346), ("softrelu", "bfloat16"): (0, 318),
    ("silu", "float16"): (0, 773), ("silu", "bfloat16"): (0, 800),
    ("gelu", "float16"): (202, 796), ("gelu", "bfloat16"): (234, 422),
    ("gelu_tanh", "float16"): (146, 914), ("gelu_tanh", "bfloat16"): (275, 960),
    ("mish", "float16"): (0, 611), ("mish", "bfloat16"): (0, 470),
    ("tanh", "float16"): (0, 0), ("tanh", "bfloat16"): (0, 0),
    ("softsign", "float16"): (292, 292), ("softsign", "bfloat16"): (302, 302),
}


@pytest.mark.parametrize("act_type,dtype", sorted(_HALF_ACT_OFF))
def test_half_precision_activations_against_an_f64_oracle(act_type, dtype):
    """Over 2001 points of [-6, 6] in the dtype, each package's
    activation against the f64 value rounded once to the dtype: the
    counts of points off it are pinned, and the port is never further
    off than the reference."""
    x = _rounded(np.linspace(-6.0, 6.0, 2001), dtype)
    oracle = _rounded(_f64_activation(act_type, x), dtype)
    want, got = both(lambda m: [m.nd.Activation(
        m.nd.array(x, dtype=dtype), act_type=act_type)])
    off = (int((_value(got[0]) != oracle).sum()),
           int((_value(want[0]) != oracle).sum()))
    assert off == _HALF_ACT_OFF[(act_type, dtype)], off
    assert off[0] <= off[1]


# ---------------------------------------------------------------------------
# the sign of a zero max or min: XLA orders -0 below +0 (ROADMAP.md, queue
# 3, F1). Each case puts -0 before and after +0; values compared with
# their signs, gradients to the reference's (half at a tie, split over
# the ties of a reduction, 0 at NaN in clip)
# ---------------------------------------------------------------------------

_Z = [-0.0, 0.0, 0.0, -0.0, -0.0, -0.0, 0.0, 0.0, 1.5, np.nan, -2.0, 6.0]
_Z2 = [0.0, -0.0, -0.0, 0.0, -0.0, 0.0, -0.0, 0.0, 1.5, 3.0, -2.0, -np.inf]

_SIGNED_ZERO_CASES = {
    "broadcast_maximum": (lambda m, x, y: m.nd.broadcast_maximum(x, y),
                          [_Z, _Z2]),
    "broadcast_minimum": (lambda m, x, y: m.nd.broadcast_minimum(x, y),
                          [_Z, _Z2]),
    "maximum_broadcast": (lambda m, x, y: m.nd.maximum(
        x.reshape((3, 4)), y.reshape((3, 4))[:1]), [_Z, _Z2]),
    "clip_0_6": (lambda m, x: m.nd.clip(x, 0, 6), [_Z]),
    "clip_minus0_plus0": (lambda m, x: m.nd.clip(x, -0.0, 0.0), [_Z2]),
    "clip_upper_minus0": (lambda m, x: m.nd.clip(x, -3.0, -0.0), [_Z]),
    "clip_upper_only": (lambda m, x: m.nd.clip(x, a_max=0.0), [_Z]),
    "hard_sigmoid": (lambda m, x: m.nd.hard_sigmoid(x, alpha=1.0,
                                                     beta=-0.0), [_Z]),
    "max": (lambda m, x: m.nd.max(x.reshape((6, 2)), axis=1), [_Z]),
    "max_axis_keepdims": (lambda m, x: m.nd.max_axis(
        x.reshape((2, 6)), axis=0, keepdims=True), [_Z2]),
    "min": (lambda m, x: m.nd.min(x.reshape((6, 2)), axis=1), [_Z2]),
    "min_axis_all": (lambda m, x: m.nd.min_axis(x[:8]), [_Z2]),
    "max_all": (lambda m, x: m.nd.max(x[:8]), [_Z]),
}


def _with_signs(v):
    a = _value(v)
    return a, np.signbit(a)


@pytest.mark.parametrize("name", sorted(_SIGNED_ZERO_CASES))
def test_signed_zero_extrema_are_the_references(name):
    f, arrays = _SIGNED_ZERO_CASES[name]
    want, got = both(lambda m: [f(m, *[m.nd.array(np.array(a, np.float32))
                                       for a in arrays])])
    (wv, ws), (gv, gs) = _with_signs(want[0]), _with_signs(got[0])
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gs, ws)
    want, got = both(lambda m: _grads(m, f, *arrays))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_value(g), _value(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu6_and_hard_sigmoid_blocks_give_plus_zero(dtype):
    """MobileNet's ReLU6 and HardSigmoid (``clip``) at -0, +0, the bounds
    and NaN: the reference's values and signs, its gradient (half at a
    bound, 0 at NaN)."""
    from mxnet_tpu.gluon.model_zoo.vision import mobilenet as jmob
    from mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet as pmob

    x = [-0.0, 0.0, 6.0, -3.0, 3.0, np.nan, 7.5, -0.0]
    for jblk, pblk in ((jmob.ReLU6(), pmob.ReLU6()),
                       (jmob.HardSigmoid(), pmob.HardSigmoid())):
        want = _grads(jmx, lambda m, a: jblk(a), x, dtype=dtype)
        with mx.cpu():
            got = _grads(mx, lambda m, a: pblk(a), x, dtype=dtype)
            out = pblk(mx.nd.array(np.array(x, np.float32), dtype=dtype))
        ref = jblk(jmx.nd.array(np.array(x, np.float32), dtype=dtype))
        np.testing.assert_array_equal(_value(out), _value(ref))
        np.testing.assert_array_equal(np.signbit(_value(out)),
                                      np.signbit(_value(ref)))
        np.testing.assert_array_equal(_value(got[0]), _value(want[0]))


@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("order", ["minus_first", "plus_first"])
def test_topk_orders_minus_zero_below_plus_zero(order, is_ascend):
    z = [-0.0, 0.0] if order == "minus_first" else [0.0, -0.0]
    x = np.array([[-1.0] + z + [-2.0], [z[0], 3.0, z[1], z[0]]],
                 np.float32)
    for k in (1, 2, 3):
        want, got = both(lambda m: list(m.nd.topk(
            m.nd.array(x), k=k, ret_typ="both", is_ascend=is_ascend)))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(_value(g), _value(w))
            np.testing.assert_array_equal(np.signbit(_value(g)),
                                          np.signbit(_value(w)))


# ---------------------------------------------------------------------------
# names of what the port computes (ROADMAP.md, queue 1, item 4 (a))
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alias,op", [
    ("activation", "Activation"), ("convolution", "Convolution"),
    ("dropout", "Dropout"), ("fully_connected", "FullyConnected"),
    ("pooling", "Pooling")])
def test_lowercase_aliases_are_the_ops(alias, op):
    from mxnet_tpu.ops.registry import get_op as jget
    from mxnet_tpu_torch.ops.registry import get_op as pget

    assert pget(alias) is pget(op) and jget(alias) is jget(op)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 3, 6, 6).astype(np.float32)
    w = rs.randn(4, 3, 3, 3).astype(np.float32)
    fc = rs.randn(4, 108).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    calls = {
        "activation": lambda m: [m.nd.activation(m.nd.array(x),
                                                 act_type="tanh")],
        "convolution": lambda m: [m.nd.convolution(
            m.nd.array(x), m.nd.array(w), m.nd.array(b), kernel=(3, 3),
            num_filter=4, pad=(1, 1))],
        "dropout": lambda m: [m.nd.dropout(m.nd.array(x), p=0.5)],
        "fully_connected": lambda m: [m.nd.fully_connected(
            m.nd.array(x), m.nd.array(fc), m.nd.array(b), num_hidden=4)],
        "pooling": lambda m: [m.nd.pooling(m.nd.array(x), kernel=(2, 2),
                                           stride=(2, 2), pool_type="avg")],
    }
    check(calls[alias], rtol=1e-5)


@pytest.mark.parametrize("name", ["equal", "not_equal", "greater", "lesser"])
def test_comparison_wrappers(name):
    a = np.array([[1.0, 2.0, np.nan], [0.0, -0.0, 5.0]], np.float32)
    b = np.array([[2.0, 2.0, np.nan], [-0.0, 1.0, 5.0]], np.float32)
    check(lambda m: [getattr(m.nd, name)(m.nd.array(a), m.nd.array(b)),
                     getattr(m.nd, name)(m.nd.array(a), 2.0),
                     getattr(m.nd, name)(m.nd.array(a), m.nd.array(b[0]))])


def test_ndarray_and_optimizer_at_the_top_level():
    assert mx.NDArray is mx.nd.NDArray and jmx.NDArray is jmx.nd.NDArray
    assert mx.Optimizer is mx.optimizer.Optimizer
    assert jmx.Optimizer is jmx.optimizer.Optimizer
    assert {"NDArray", "Optimizer"} <= set(mx.__all__)
    opt = mx.optimizer.create("sgd", learning_rate=0.5)
    assert isinstance(opt, mx.Optimizer) and opt.learning_rate == 0.5
