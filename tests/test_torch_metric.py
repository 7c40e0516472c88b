"""The port's ``mx.metric`` held against the JAX package's on the CPU.

Every metric class gets the same seeded numpy labels and predictions in
both packages, over two updates, through ``get``, ``get_global``,
``get_name_value`` and ``reset_local``: the values equal the reference's
(1e-12 relative: both are numpy on the same float32 inputs), ties in
the argmax included (``np.argmax`` takes the first, in both), with
``ignore_label``, and an empty ``get()`` (NaN). The port also takes
torch tensors and NDArrays. A bfloat16 prediction reaches numpy as
float32 in the port, where the reference does the arithmetic in ml_dtypes
bfloat16: a difference by design, pinned by its size on MSE.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import metric as jmetric

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import metric as pmetric
from mxnet_tpu_torch.base import MXNetError


def _cls_inputs(seed, n=12, k=4, ties=False):
    rs = np.random.RandomState(seed)
    pred = rs.rand(n, k).astype(np.float32)
    pred /= pred.sum(1, keepdims=True)
    if ties:
        pred[::3, 1] = pred[::3, 2] = pred[::3].max(1) + 0.1
    label = rs.randint(0, k, (n,)).astype(np.float32)
    return label, pred


def _bin_inputs(seed, n=16):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 2, (n,)).astype(np.float32)
    pred = rs.rand(n, 2).astype(np.float32)
    return label, pred


def _reg_inputs(seed, n=10):
    rs = np.random.RandomState(seed)
    return (rs.randn(n).astype(np.float32),
            rs.randn(n, 1).astype(np.float32))


_CASES = {
    "Accuracy": ("accuracy", {}, _cls_inputs),
    "Accuracy_ties": ("acc", {}, lambda s: _cls_inputs(s, ties=True)),
    "TopKAccuracy": ("topkaccuracy", {"top_k": 2}, _cls_inputs),
    "TopKAccuracy_ties": ("topkaccuracy", {"top_k": 3},
                          lambda s: _cls_inputs(s, ties=True)),
    "F1": ("f1", {}, _bin_inputs),
    "MCC": ("mcc", {}, _bin_inputs),
    "MAE": ("mae", {}, _reg_inputs),
    "MSE": ("mse", {}, _reg_inputs),
    "RMSE": ("rmse", {}, _reg_inputs),
    "CrossEntropy": ("ce", {}, _cls_inputs),
    "NegativeLogLikelihood": ("nll_loss", {}, _cls_inputs),
    "Perplexity": ("perplexity", {"ignore_label": None}, _cls_inputs),
    "Perplexity_ignore_label": ("perplexity", {"ignore_label": 2},
                                _cls_inputs),
    "PearsonCorrelation": ("pearsoncorrelation", {}, _reg_inputs),
    "Loss": ("loss", {}, _reg_inputs),
    "Torch": ("torch", {}, _reg_inputs),
    "Caffe": ("caffe", {}, _reg_inputs),
    "PCC": ("pcc", {}, _cls_inputs),
    "PCC_binary": ("pcc", {}, _bin_inputs),
}


def _feed(mod, m, inputs, kind):
    for label, pred in inputs:
        if mod is jmx:
            m.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
        elif kind == "torch":
            m.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
        else:
            with mx.cpu():
                m.update([mx.nd.array(label)], [mx.nd.array(pred)])


def _close(a, b):
    if isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    if isinstance(b, str):
        assert a == b
        return
    if math.isnan(b):
        assert math.isnan(a)
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("kind", ["ndarray", "torch"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_every_metric_matches_the_reference(case, kind):
    name, kw, make = _CASES[case]
    j, p = jmetric.create(name, **kw), pmetric.create(name, **kw)
    assert type(p).__name__ == type(j).__name__ and p.name == j.name
    _close(p.get(), j.get())                 # empty: NaN
    inputs = [make(1), make(2)]
    _feed(jmx, j, inputs[:1], kind)
    _feed(mx, p, inputs[:1], kind)
    _close(p.get(), j.get())
    j.reset_local()
    p.reset_local()
    _feed(jmx, j, inputs[1:], kind)
    _feed(mx, p, inputs[1:], kind)
    for fn in ("get", "get_global", "get_name_value"):
        _close(list(getattr(p, fn)()), list(getattr(j, fn)()))
    j.reset()
    p.reset()
    _close(p.get(), j.get())


def test_composite_custom_np_and_create():
    label, pred = _cls_inputs(3)

    def feval(lab, prd):
        return float((prd.argmax(1) == lab).sum()), lab.size

    for mod, m_mx in ((jmetric, jmx), (pmetric, mx)):
        comp = mod.create(["acc", "ce", feval])
        assert isinstance(comp, mod.CompositeEvalMetric)
        with mx.cpu():
            comp.update([m_mx.nd.array(label)], [m_mx.nd.array(pred)])
        if mod is jmetric:
            want = comp.get()
        else:
            got = comp.get()
    _close(got[1], want[1])
    assert got[0] == ["accuracy", "cross-entropy", "custom(feval)"]
    npm = pmetric.np(lambda lab, prd: float(np.abs(lab - prd).sum()))
    npm.update([np.ones(3)], [np.zeros(3)])
    assert npm.get()[1] == 3.0
    with pytest.raises(MXNetError, match="unknown metric"):
        pmetric.create("no_such_metric")


def test_register_and_the_class_set():
    @pmetric.register
    class MyMetric(pmetric.EvalMetric):
        def __init__(self):
            super().__init__("mine")

    assert isinstance(pmetric.create("mymetric"), MyMetric)
    assert set(pmetric.__all__) == set(jmetric.__all__)
    classes = [n for n in pmetric.__all__ if n[0].isupper()
               and n != "EvalMetric"]
    assert len(classes) == 17


def test_label_count_mismatch_raises():
    for mod, m_mx in ((jmetric, jmx), (pmetric, mx)):
        with mx.cpu():
            with pytest.raises(Exception, match="differ|count"):
                mod.Accuracy().update([m_mx.nd.array([1.0, 0.0])],
                                      [m_mx.nd.array([[0.2, 0.8]])])


@pytest.mark.parametrize("name", ["MSE", "Loss"])
def test_bf16_inputs_reach_numpy_as_f32(name):
    """bf16 labels and predictions: the port reads them as f32 and
    computes in f32, as its asnumpy does (torch tensors and NDArrays
    alike); the reference does the arithmetic in ml_dtypes bfloat16,
    which rounds each step to bf16. The port equals the f32 arithmetic
    on the bf16 values exactly; the reference is off it by a pinned
    share (seeded inputs, 64 values)."""
    rs = np.random.RandomState(6)
    label = torch.from_numpy(rs.randn(64).astype(np.float32)).bfloat16()
    pred = torch.from_numpy(rs.randn(64, 1).astype(np.float32)).bfloat16()
    lf, pf = label.float().numpy(), pred.float().numpy()
    want = float(((lf.reshape(pf.shape) - pf) ** 2).mean()) \
        if name == "MSE" else float(pf.sum()) / pf.size
    p = getattr(pmetric, name)()
    p.update([label], [pred])
    with mx.cpu():
        p2 = getattr(pmetric, name)()
        p2.update([mx.nd.NDArray(label)], [mx.nd.NDArray(pred)])
    j = getattr(jmetric, name)()
    j.update([jmx.nd.array(lf).astype("bfloat16")],
             [jmx.nd.array(pf).astype("bfloat16")])
    assert p.get()[1] == p2.get()[1] == pytest.approx(want, rel=1e-6)
    off = (j.get()[1] - want) / want
    assert off == pytest.approx({"MSE": -0.006609, "Loss": 0.004451}[name],
                                abs=2e-6)
