"""The imperative slice as a whole, on the CPU, against the JAX package:
the verify recipe's "Imperative API" in both packages. A 2-layer MLP in
``mx.nd`` ops (``FullyConnected``, ``Activation``, ``log_softmax``,
``pick``, ``mean``), ``attach_grad``, ``autograd.record()``,
``loss.backward()`` and a manual ``w[:] = w - lr * w.grad``, ten steps
from the same numpy weights: each loss to 1e-6 relative, each final
weight to 1e-5 (f32 products and sums in another order), and the
port's ``.params`` file of the trained weights, loaded by the JAX
package, bit for bit.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag

import mxnet_tpu_torch as mx

N, D, H, C = 64, 20, 32, 4
STEPS = 10
LR = 0.5


def _data():
    rs = np.random.RandomState(0)
    centers = rs.randn(C, D).astype(np.float32) * 2
    y = rs.randint(0, C, N)
    x = centers[y] + rs.randn(N, D).astype(np.float32) * 0.5
    params = {"w1": rs.randn(H, D).astype(np.float32) * 0.2,
              "b1": np.zeros(H, np.float32),
              "w2": rs.randn(C, H).astype(np.float32) * 0.2,
              "b2": np.zeros(C, np.float32)}
    return x, y.astype(np.float32), params


def train(m, ag, tmp_path=None):
    x_np, y_np, init = _data()
    x, y = m.nd.array(x_np), m.nd.array(y_np)
    params = {k: m.nd.array(v) for k, v in init.items()}
    for p in params.values():
        p.attach_grad()
    losses = []
    for _ in range(STEPS):
        with ag.record():
            h = m.nd.Activation(m.nd.FullyConnected(
                x, params["w1"], params["b1"], num_hidden=H), act_type="relu")
            out = m.nd.FullyConnected(h, params["w2"], params["b2"],
                                      num_hidden=C)
            loss = -m.nd.mean(m.nd.pick(m.nd.log_softmax(out, axis=-1), y,
                                        axis=-1))
        loss.backward()
        for p in params.values():
            p[:] = p - LR * p.grad
        losses.append(float(loss.asscalar()))
    acc = float((m.nd.argmax(out, axis=1) == y).mean().asscalar())
    if tmp_path is not None:
        m.nd.save(str(tmp_path), {k: v for k, v in params.items()})
    return losses, {k: v.asnumpy() for k, v in params.items()}, acc


def test_mlp_matches_the_jax_package(tmp_path):
    want_losses, want_params, want_acc = train(jmx, jag,
                                               tmp_path / "jax.params")
    with mx.cpu():
        losses, params, acc = train(mx, mx.autograd,
                                    tmp_path / "port.params")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    for k in want_params:
        np.testing.assert_allclose(params[k], want_params[k], rtol=1e-5,
                                   atol=1e-5)
    assert losses[-1] < losses[0] * 0.5
    assert acc == pytest.approx(want_acc) and acc > 0.95
    back = jmx.nd.load(str(tmp_path / "port.params"))
    for k in want_params:
        np.testing.assert_array_equal(back[k].asnumpy(), params[k])
