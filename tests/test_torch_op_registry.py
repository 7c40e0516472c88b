"""The port's operator registry held against the JAX package's on the CPU:
typed attributes (``AttrSpec``) raising the reference's messages word
for word where ``tests/test_op_attrs.py`` pins them, their docs in the
generated ``mx.nd`` wrappers, and the wrappers' calling convention
(tensors positionally or by name, positionals past the tensors filling
the attributes, ``out=``, ``ctx=``).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as preg


def _raised(m, err, fn):
    with pytest.raises(err) as info:
        fn(m)
    return str(info.value)


def _x(m, shape):
    return m.nd.array(np.ones(shape, np.float32), ctx=m.cpu())


# the calls tests/test_op_attrs.py pins, and FullyConnected's specs
BAD_CALLS = {
    "pool_type_choice": lambda m: m.nd.Pooling(
        _x(m, (1, 2, 4, 4)), kernel=(2, 2), pool_type="maxx"),
    "dropout_range": lambda m: m.nd.Dropout(_x(m, (2, 4)), p=1.5,
                                            mode="always"),
    "num_filter_type": lambda m: m.nd.Convolution(
        _x(m, (1, 2, 4, 4)), _x(m, (3, 2, 3, 3)), kernel=(3, 3),
        num_filter="three", no_bias=True),
    "negative_pad": lambda m: m.nd.Convolution(
        _x(m, (1, 2, 4, 4)), _x(m, (3, 2, 3, 3)), kernel=(3, 3),
        num_filter=3, pad=(-1, 0), no_bias=True),
    "num_hidden_type": lambda m: m.nd.FullyConnected(
        _x(m, (2, 4)), _x(m, (3, 4)), num_hidden="3", no_bias=True),
    "num_hidden_bool": lambda m: m.nd.FullyConnected(
        _x(m, (2, 4)), _x(m, (3, 4)), num_hidden=True, no_bias=True),
    "num_hidden_range": lambda m: m.nd.FullyConnected(
        _x(m, (2, 4)), _x(m, (3, 4)), num_hidden=-1, no_bias=True),
}


@pytest.mark.parametrize("name", sorted(BAD_CALLS))
def test_attribute_errors_match_the_reference(name):
    want = _raised(jmx, jmx.base.MXNetError, BAD_CALLS[name])
    got = _raised(mx, MXNetError, BAD_CALLS[name])
    assert got == want


def test_activation_choice():
    # the reference declares no spec for act_type (a KeyError there); the
    # port's spec names the choices
    with pytest.raises(MXNetError, match="act_type=.relu6. must be str, one of"):
        mx.nd.Activation(_x(mx, (2,)), act_type="relu6")


def test_docs_flow_into_the_wrappers():
    for op in ("FullyConnected", "Dropout"):
        assert preg.render_attr_docs(preg.get_op(op)) == \
            jreg.render_attr_docs(jreg.get_op(op))
        assert getattr(mx.nd, op).__doc__.endswith(
            preg.render_attr_docs(preg.get_op(op)))
    doc = mx.nd.Convolution.__doc__
    assert "Attributes" in doc and "Spatial kernel size" in doc
    assert "num_filter" in doc and "range [1, inf]" in doc
    assert "NHWC" in doc


def test_validate_attrs_directly():
    op = preg.OpDef("T", lambda x: x, ("x",), frozenset(), ("k",), False,
                    {"k": preg.attr("k", tuple, low=1),
                            "f": preg.attr("f", float, high=2.0),
                            "s": preg.attr("s", str, choices=("a", "b"))})
    preg.validate_attrs(op, {"k": (1, 2), "f": 1, "s": "a", "other": 9})
    preg.validate_attrs(op, {"k": np.int64(3)})
    for bad, msg in (({"k": (0, 2)}, "below"), ({"f": 2.5}, "above"),
                     ({"s": "c"}, "one of 'a', 'b'"),
                     ({"k": "x"}, "has type str")):
        with pytest.raises(MXNetError, match=msg):
            preg.validate_attrs(op, bad)
    assert preg.attr("k", tuple, low=1).describe() == \
        jreg.attr("k", tuple, low=1).describe()


def test_register_splits_tensors_and_attributes():
    want = jreg.get_op("FullyConnected")
    got = preg.get_op("FullyConnected")
    assert got.tensor_params == want.tensor_params
    assert got.optional_tensor_params == want.optional_tensor_params
    assert got.attr_params == want.attr_params
    assert preg.get_op("Concat").variadic and preg.get_op("add_n").variadic
    assert preg.has_op("broadcast_add") and not preg.has_op("no_such_op")
    with pytest.raises(NotImplementedError, match="no_such_op"):
        preg.get_op("no_such_op")
    missing = {"Reshape", "transpose", "sum", "dot", "batch_dot", "take",
               "pick", "one_hot", "topk", "softmax", "log_softmax",
               "FullyConnected", "Activation", "_plus_scalar",
               "broadcast_equal", "Cast"} - set(preg.list_ops())
    assert not missing


def _wrapper_calls(m):
    x = m.nd.array(np.array([-3.0, 0.5, 8.0], np.float32), ctx=m.cpu())
    out = m.nd.zeros((3,), ctx=m.cpu())
    m.nd.clip(x, 0, 6, out=out)
    return [m.nd.clip(x, 0, 6), m.nd.clip(x, a_min=-1, a_max=1), out,
            m.nd.clip(data=x, a_min=0, a_max=1),
            m.nd.broadcast_add(x, rhs=x), m.nd.full((2,), 7, ctx=m.cpu()),
            m.nd._zeros(shape=(2, 2), ctx="cpu"),
            m.nd.broadcast_add(x, [1.0, 2.0, 3.0], ctx=m.cpu()),
            m.nd.FullyConnected(m.nd.ones((2, 3), ctx=m.cpu()),
                                m.nd.ones((4, 3), ctx=m.cpu()),
                                m.nd.ones((4,), ctx=m.cpu()), num_hidden=4),
            m.nd.FullyConnected(m.nd.ones((2, 3), ctx=m.cpu()),
                                m.nd.ones((4, 3), ctx=m.cpu()),
                                num_hidden=4, no_bias=True)]


def test_wrapper_calling_convention():
    want = _wrapper_calls(jmx)
    got = _wrapper_calls(mx)
    for w, g in zip(want, got):
        assert str(g.dtype) == str(w.dtype) and g.context == mx.cpu()
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def test_wrapper_argument_errors():
    x = mx.nd.ones((3,), ctx=mx.cpu())
    for m, xx in ((jmx, jmx.nd.ones((3,))), (mx, x)):
        with pytest.raises(TypeError, match="too many positional"):
            m.nd.clip(xx, 0, 6, 7)
        with pytest.raises(TypeError, match="multiple values"):
            m.nd.clip(xx, 0, a_min=1)
