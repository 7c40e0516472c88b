"""``mx.autograd``'s ``grad`` (to third order with ``create_graph``),
``mark_variables`` and ``Function`` against the JAX package's, on the
CPU (the cases of ``tests/test_autograd.py`` for them): the same NDArray
programs through both packages, gradients to 1e-5 relative."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


PKGS = ((jmx, jag), (mx, autograd))


def _both(fn):
    out = [fn(m, ag) for m, ag in PKGS]
    for a, b in zip(out[1], out[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    return out[1]


def test_autograd_grad_function():
    def run(m, ag):
        x = m.nd.array([1.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = (x ** 3).sum()
        (gx,) = ag.grad(y, [x])
        return [gx.asnumpy(), x.grad.asnumpy()]

    gx, xg = _both(run)
    np.testing.assert_allclose(gx, 3 * np.array([1.0, 4.0]))
    np.testing.assert_array_equal(xg, 0.0)     # grad() leaves .grad alone


def test_grad_of_a_single_variable_and_head_grads():
    def run(m, ag):
        x = m.nd.array([0.5, -1.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = x * x
        g = ag.grad(y, x, head_grads=m.nd.array([1.0, 2.0, 3.0]))
        return [g.asnumpy()]

    _both(run)


def test_second_derivative_sin():
    def run(m, ag):
        x = m.nd.array([0.3, 1.1, -0.7])
        x.attach_grad()
        with ag.record():
            y = m.nd.sin(x)
            dx = ag.grad(y, [x], create_graph=True)[0]
            loss = dx.sum()
        loss.backward()
        return [x.grad.asnumpy(), dx.asnumpy()]

    xg, dx = _both(run)
    x = np.array([0.3, 1.1, -0.7])
    np.testing.assert_allclose(xg, -np.sin(x), rtol=1e-5)
    np.testing.assert_allclose(dx, np.cos(x), rtol=1e-5)


def test_gradient_penalty():
    def run(m, ag):
        w = m.nd.array([[2.0]])
        w.attach_grad()
        xv = m.nd.array([[3.0]])
        with ag.record():
            y = m.nd.dot(xv, w) * m.nd.dot(xv, w)
            g = ag.grad(y, [w], create_graph=True)[0]
            pen = (g * g).sum()
        pen.backward()
        return [g.asnumpy(), w.grad.asnumpy()]

    g, wg = _both(run)
    np.testing.assert_allclose(g, [[36.0]], rtol=1e-5)
    np.testing.assert_allclose(wg, [[1296.0]], rtol=1e-5)


def test_third_order():
    def run(m, ag):
        x = m.nd.array([2.0])
        x.attach_grad()
        with ag.record():
            y = x * x * x * x
            g1 = ag.grad(y, [x], create_graph=True)[0]
            g2 = ag.grad(g1, [x], create_graph=True)[0]
            s = g2.sum()
        s.backward()
        return [g1.asnumpy(), g2.asnumpy(), x.grad.asnumpy()]

    g1, g2, g3 = _both(run)
    np.testing.assert_allclose([g1[0], g2[0], g3[0]], [32.0, 48.0, 48.0],
                               rtol=1e-5)


def test_gradient_penalty_through_dense():
    """d(out)/dx_i of ``sum(Dense(x))`` is W's row, so the penalty
    ``sum |dx|^2`` over 4 rows is ``4 |W|^2`` and its gradient ``8 W``."""
    def run(m, ag):
        net = m.gluon.nn.Dense(1, in_units=2)
        net.initialize()
        net.weight.set_data(m.nd.array([[0.6, -1.2]]))
        xi = m.nd.array(np.random.RandomState(0).randn(4, 2).astype("f"))
        xi.attach_grad()
        with ag.record():
            out = net(xi).sum()
            gi = ag.grad(out, [xi], create_graph=True)[0]
            gp = (gi * gi).sum()
        gp.backward()
        return [net.weight.grad().asnumpy()]

    (wg,) = _both(run)
    np.testing.assert_allclose(wg, 8 * np.array([[0.6, -1.2]]), rtol=1e-5)


def test_grad_of_an_unreached_variable_raises():
    x, z = mx.nd.array([1.0]), mx.nd.array([2.0])
    x.attach_grad()
    z.attach_grad()
    with autograd.record():
        y = x * 2
    with pytest.raises(mx.MXNetError, match="not part of the recorded"):
        autograd.grad(y, [z])
    with pytest.raises(mx.MXNetError, match="not on the tape"):
        autograd.grad(mx.nd.array([1.0]), [x])


def test_mark_variables():
    """``mark_variables`` attaches the given buffers: backward writes
    into them ("write") or adds ("add"), in both packages."""
    def run(m, ag):
        x = m.nd.array([1.0, 2.0, 3.0])
        g = m.nd.zeros((3,))
        h = m.nd.array([4.0, 5.0])
        gh = m.nd.ones((2,))
        ag.mark_variables([x, h], [g, gh], ["write", "add"])
        for _ in range(2):
            with ag.record():
                y = (x * x).sum() + (h * 3).sum()
            y.backward()
        return [g.asnumpy(), gh.asnumpy(), x.grad.asnumpy()]

    g, gh, xg = _both(run)
    np.testing.assert_allclose(g, [2.0, 4.0, 6.0])
    np.testing.assert_allclose(gh, [7.0, 7.0])
    np.testing.assert_allclose(xg, g)


def test_custom_function():
    def run(m, ag):
        class Sigmoid(ag.Function):
            def forward(self, x):
                y = m.nd.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)

        x = m.nd.array([0.0, 1.0, -2.0])
        x.attach_grad()
        f = Sigmoid()
        with ag.record():
            y = f(x)
            z = (y * 3).sum()
        z.backward()
        return [y.asnumpy(), x.grad.asnumpy()]

    y, xg = _both(run)
    s = 1 / (1 + np.exp(-np.array([0.0, 1.0, -2.0])))
    np.testing.assert_allclose(xg, 3 * s * (1 - s), rtol=1e-5)


def test_custom_function_with_two_outputs_and_outside_record():
    class SplitScale(autograd.Function):
        def forward(self, x, y):
            self.save_for_backward(x, y)
            return x * y, x + y

        def backward(self, da, db):
            x, y = self.saved_tensors
            return da * y + db, da * x + db

    x, y = mx.nd.array([1.0, 2.0]), mx.nd.array([3.0, 4.0])
    for a in (x, y):
        a.attach_grad()
    with autograd.record():
        p, q = SplitScale()(x, y)
        loss = (p + 2 * q).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), [5.0, 6.0])
    np.testing.assert_allclose(y.grad.asnumpy(), [3.0, 4.0])
    p, q = SplitScale()(x, y)                  # outside record: forward only
    np.testing.assert_allclose(p.asnumpy(), [3.0, 8.0])


def test_custom_function_under_create_graph():
    """A custom Function's gradient under ``create_graph`` is first-order
    correct and stays on the tape, as the reference's contract asks."""
    class Sq(autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 2 * x * dy

    x = mx.nd.array([3.0])
    x.attach_grad()
    with autograd.record():
        y = Sq()(x)
        g = autograd.grad(y, [x], create_graph=True)[0]
        assert abs(float(g.asnumpy()[0]) - 6.0) < 1e-6
        z = (g * g).sum()
    z.backward()
    assert x.grad is not None
