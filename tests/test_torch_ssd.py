"""SSD in the port against the JAX package's on the CPU: the box ops
(``box_iou``, ``box_nms``, ``bipartite_matching``), the MultiBox ops
(``MultiBoxPrior``, ``MultiBoxTarget``, ``MultiBoxDetection``), and
``ssd_toy`` with its loss and an Adam step, the reference's weights
carried by a ``.params`` file; then the reference's own SSD tests
(``tests/test_ssd.py``) run in the port.

Inputs are drawn with numpy and handed to both packages. Bit for bit:
the anchors, the IoUs, the NMS rows (their suppression through the
kernel's plain version), the matchings, the targets' classes and masks,
the detections' ids and scores. To a tolerance: ``loc_target`` within
1e-6 of its largest magnitude and the detected boxes within 1e-6 (XLA
divides by a constant variance as a product with its reciprocal, and
its ``exp`` is not torch's: an ulp or two); the model's outputs within
1e-5 of their largest and its loss within 1e-5 relative (f32 sums in
other orders), one Adam step's deltas within 1e-3 by norm ratio
(but for the convolution biases that feed a BatchNorm, whose gradient is
0 up to rounding: those gradients are held to rounding instead).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import contrib as jcontrib
from mxnet_tpu.ops import multibox as jmb
from mxnet_tpu.ops import spatial as jsp

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.kernels import box_nms_sorted, nms_plan
from mxnet_tpu_torch.kernels.box_nms import SMEM_LIMIT
from mxnet_tpu_torch.ops import multibox as pmb
from mxnet_tpu_torch.ops import spatial as psp
from test_torch_cuda_ssd import nms_rows


def _bits_equal(got, want, what=""):
    """Equal bit for bit (the sign of a zero included), any NaN equal to
    any NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
        view = {4: np.uint32, 8: np.uint64}[got.dtype.itemsize]
        got, want = got[~nan].view(view), want[~nan].view(view)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _close_to_max(got, want, rtol, what):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor)
                     else got)
    want = np.asarray(want)
    top = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert got.shape == want.shape and err <= rtol * max(top, 1e-30), \
        (what, err, top)


# ---------------------------------------------------------------------------
# MultiBoxPrior and box_iou
# ---------------------------------------------------------------------------

PRIOR_CASES = {
    "default": dict(hw=(3, 5)),
    "sizes_ratios": dict(hw=(4, 4), sizes=(0.9, 0.4, 0.33),
                         ratios=(1.0, 2.0, 0.5, 3.0)),
    "first_ratio_not_1": dict(hw=(2, 3), sizes=(0.25, 0.6),
                              ratios=(0.7, 1.3)),
    "steps_offsets": dict(hw=(5, 7), sizes=(0.3,), ratios=(1.0, 2.0),
                          steps=(0.13, 0.07), offsets=(0.25, 0.6)),
    "clip": dict(hw=(6, 4), sizes=(0.95, 0.45), ratios=(1.0, 3.0, 1 / 3),
                 clip=True),
    "ssd_38": dict(hw=(38, 38), sizes=(0.2, 0.3), ratios=(1.0, 2.0, 0.5)),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_multibox_prior_is_the_references_bits(case):
    kw = dict(PRIOR_CASES[case])
    h, w = kw.pop("hw")
    x = np.zeros((2, 3, h, w), np.float32)
    want = np.asarray(jmb.multibox_prior(jnp.asarray(x), **kw))
    got = pmb.multibox_prior(torch.from_numpy(x), **kw)
    _bits_equal(got.numpy(), want, case)


def _boxes(rs, n, fmt, degenerate=True):
    """Corner boxes in [0, 1] (or their center form), some of them
    empty, inverted or repeated."""
    a = rs.rand(n, 2).astype(np.float32)
    b = a + rs.rand(n, 2).astype(np.float32) * 0.6
    boxes = np.concatenate([a, b], axis=1)
    if degenerate:
        boxes[::7, 2] = boxes[::7, 0]             # zero width
        boxes[3::11, 3] = boxes[3::11, 1] - 0.1   # inverted
        boxes[5::13] = boxes[0]                   # repeated
    if fmt == "center":
        boxes = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2,
                          (boxes[:, 1] + boxes[:, 3]) / 2,
                          boxes[:, 2] - boxes[:, 0],
                          boxes[:, 3] - boxes[:, 1]], axis=1)
    return boxes.astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_is_the_references_bits(fmt):
    rs = np.random.RandomState(1 if fmt == "corner" else 2)
    lhs = np.stack([_boxes(rs, 40, fmt), _boxes(rs, 40, fmt)])
    rhs = np.stack([_boxes(rs, 30, fmt), _boxes(rs, 30, fmt)])
    want = np.asarray(jsp.box_iou(jnp.asarray(lhs), jnp.asarray(rhs),
                                  format=fmt))
    got = psp.box_iou(torch.from_numpy(lhs), torch.from_numpy(rhs),
                      format=fmt)
    _bits_equal(got.numpy(), want, fmt)
    assert (want > 0.3).sum() > 5 and (want == 0).sum() > 5


# ---------------------------------------------------------------------------
# box_nms: the crafted rows
# ---------------------------------------------------------------------------


NMS_CASES = {
    "per_class": dict(id_index=0),
    "one_class": dict(),
    "force": dict(id_index=0, force_suppress=True),
    "topk": dict(id_index=0, topk=17),
    "topk_above_n": dict(id_index=0, topk=500),
    "zeros_valid": dict(id_index=0, valid_thresh=-0.5),
    "thresh_0_7": dict(id_index=0, overlap_thresh=0.7, valid_thresh=0.15),
    "center_in_out": dict(id_index=0, in_format="center",
                          out_format="center", fmt="center"),
    "center_to_corner": dict(id_index=0, in_format="center",
                             out_format="corner", fmt="center"),
    "corner_to_center": dict(id_index=0, out_format="center"),
    "lead_axes": dict(id_index=0, lead=(2, 3), topk=25),
    "unbatched": dict(id_index=0, lead=()),
    "n_65": dict(id_index=0, n=65),
    # the boundaries of the kernels' routes (nms_plan): one full word, the
    # first row count of the two-launch route, the sweep's removed bits
    # past 32 words
    "n_64": dict(id_index=0, n=64),
    "n_1857": dict(id_index=0, n=1857, lead=(1,)),
    "n_2049": dict(id_index=0, n=2049, lead=(1,)),
    "seven_columns": dict(id_index=1, score_index=2, coord_start=3,
                          pad=True, out_format="center"),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_box_nms_is_the_references_bits(case):
    kw = dict(NMS_CASES[case])
    gen = {k: kw.pop(k) for k in ("fmt", "lead", "n", "pad") if k in kw}
    rows = nms_rows(len(case), **gen)
    want = np.asarray(jsp.box_nms(jnp.asarray(rows), **kw))
    got = psp.box_nms(torch.from_numpy(rows), **kw)
    _bits_equal(got.numpy(), want, case)
    score = kw.get("score_index", 1)
    kept = (want[..., score] != -1).sum()
    assert 0 < kept < (rows[..., score] > kw.get("valid_thresh", 0.0)).sum()


# m: (route, shared bytes of the sweeping launch, scratch bytes at batch
# 32, kernels a call)
PLAN_CASES = {
    1: ("shared", 6736, 0, 1),
    64: ("shared", 6736, 0, 1),
    65: ("shared", 7776, 0, 1),
    129: ("shared", 9328, 0, 1),
    400: ("shared", 20656, 0, 1),
    1856: ("shared", 229392, 0, 1),
    1857: ("global", 480, 7618560, 2),
    2048: ("global", 512, 8650752, 2),
    2049: ("global", 792, 9191424, 2),
    7620: ("global", 2880, 118947840, 2),
}


@pytest.mark.parametrize("m", sorted(PLAN_CASES))
def test_box_nms_route_is_planned_from_m(m):
    """The route at each of its boundaries: one launch while an image's
    triangle of 64 x 64 tiles (512 bytes each) and the fixed 6,208 bytes
    fit a CTA's 232,448, two above with the triangles as scratch (the
    sweep's removed bits in shared memory past 32 words). The same route
    at any batch, its scratch in proportion."""
    plan = nms_plan(m, 32)
    assert tuple(plan) == PLAN_CASES[m]
    assert plan.shared_bytes <= SMEM_LIMIT
    words = -(-m // 64)
    assert (plan.route == "shared") == (
        words * (words + 1) // 2 * 512 + 16 * words + 6208 <= SMEM_LIMIT)
    one = nms_plan(m, 1)
    assert one.route == plan.route and one.kernels == plan.kernels
    assert one.scratch_bytes * 32 == plan.scratch_bytes


def test_box_ops_carry_no_gradient():
    rows = torch.from_numpy(nms_rows(4)).requires_grad_()
    assert not psp.box_nms(rows, id_index=0).requires_grad
    assert not any(t.requires_grad for t in psp.bipartite_matching(rows))
    anchors = pmb.multibox_prior(torch.zeros(1, 1, 3, 3), sizes=(0.5,))
    labels = torch.tensor([[[0, 0.1, 0.1, 0.6, 0.5]]])
    cls_pred = torch.zeros(1, 2, anchors.shape[1], requires_grad=True)
    assert not any(t.requires_grad for t in pmb.multibox_target(
        anchors, labels, cls_pred, negative_mining_ratio=3.0))


def test_box_nms_sorted_refuses_what_it_cannot_take():
    rows = torch.from_numpy(nms_rows(3)[0][None])
    with pytest.raises(MXNetError, match="format"):
        box_nms_sorted(rows, 60, overlap_thresh=0.5, valid_thresh=0.0,
                       coord_start=2, score_index=1, id_index=0,
                       in_format="xywh")
    with pytest.raises(MXNetError, match="device"):
        box_nms_sorted(rows.to("meta"), 60, overlap_thresh=0.5,
                       valid_thresh=0.0, coord_start=2, score_index=1,
                       id_index=0)


# ---------------------------------------------------------------------------
# bipartite_matching
# ---------------------------------------------------------------------------

MATCH_CASES = {
    "descend": dict(),
    "ascend": dict(is_ascend=True),
    "threshold": dict(threshold=0.45),
    "ascend_threshold": dict(is_ascend=True, threshold=0.3),
    "topk": dict(topk=3),
    "wide": dict(shape=(2, 4, 9)),
    "lead_axes": dict(shape=(2, 3, 6, 5), threshold=0.2),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_bipartite_matching_is_the_references_bits(case):
    kw = dict(MATCH_CASES[case])
    shape = kw.pop("shape", (3, 7, 5))
    rs = np.random.RandomState(len(case))
    data = np.round(rs.rand(*shape), 1).astype(np.float32)  # many ties
    want = jcontrib.bipartite_matching(jnp.asarray(data), **kw)
    got = psp.bipartite_matching(torch.from_numpy(data), **kw)
    for g, w, what in zip(got, want, ("row", "col")):
        _bits_equal(g.numpy(), np.asarray(w), f"{case} {what}")


# ---------------------------------------------------------------------------
# MultiBoxTarget and MultiBoxDetection
# ---------------------------------------------------------------------------


def _anchors(h=4, w=4, sizes=(0.4, 0.2), ratios=(1.0, 2.0)):
    x = np.zeros((1, 1, h, w), np.float32)
    return np.array(jmb.multibox_prior(jnp.asarray(x), sizes=sizes,
                                       ratios=ratios))


def _labels():
    """Three images: two truths sharing their best anchor, one truth
    beside padding, and all padding but one."""
    pad = [-1.0] * 5
    return np.array([
        [[0, 0.02, 0.02, 0.48, 0.48], [1, 0.10, 0.10, 0.60, 0.60],
         [2, 0.55, 0.5, 0.95, 0.9]],
        [[1, 0.3, 0.3, 0.7, 0.65], pad, pad],
        [pad, pad, [0, 0.0, 0.6, 0.35, 1.0]]], np.float32)


TARGET_CASES = {
    "plain": dict(),
    "mining": dict(negative_mining_ratio=3.0),
    "mining_min_neg": dict(negative_mining_ratio=0.5,
                           minimum_negative_samples=7, ignore_label=-2.0,
                           negative_mining_thresh=0.3),
    "threshold": dict(overlap_threshold=0.3, negative_mining_ratio=2.0,
                      variances=(0.2, 0.1, 0.3, 0.25)),
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_multibox_target_matches_the_reference(case):
    kw = TARGET_CASES[case]
    anchors = _anchors()
    n = anchors.shape[1]
    labels = _labels()
    rs = np.random.RandomState(7)
    cls_pred = rs.randn(3, 4, n).astype(np.float32)
    cls_pred[:, 0, ::5] = 0.25                   # tied background scores
    want = jmb.multibox_target(jnp.asarray(anchors), jnp.asarray(labels),
                               jnp.asarray(cls_pred), **kw)
    got = pmb.multibox_target(torch.from_numpy(anchors),
                              torch.from_numpy(labels),
                              torch.from_numpy(cls_pred), **kw)
    loc_t, loc_m, cls_t = (np.asarray(w) for w in want)
    _bits_equal(got[2].numpy(), cls_t, "cls_target")
    _bits_equal(got[1].numpy(), loc_m, "loc_mask")
    _close_to_max(got[0].numpy(), loc_t, 1e-6, "loc_target")
    # both truths sharing a best anchor are matched in the first image
    assert (cls_t[0] == 1).any() and (cls_t[0] == 2).any()
    if "negative_mining_ratio" in kw:
        assert (cls_t == kw.get("ignore_label", -1.0)).any()


DETECT_CASES = {
    "default": dict(),
    "topk_force": dict(nms_topk=20, force_suppress=True),
    "background_last": dict(background_id=-1, threshold=0.2,
                            nms_threshold=0.3),
    "background_middle": dict(background_id=2, clip=False),
    "negative_threshold": dict(threshold=-0.5, nms_topk=30,
                               variances=(0.2, 0.2, 0.1, 0.1)),
}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_multibox_detection_matches_the_reference(case):
    kw = DETECT_CASES[case]
    anchors = _anchors(5, 5)
    n = anchors.shape[1]
    rs = np.random.RandomState(len(case))
    logits = rs.randn(2, 5, n).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    prob = prob.astype(np.float32)
    loc = (rs.randn(2, n * 4) * 0.5).astype(np.float32)
    want = np.asarray(jmb.multibox_detection(
        jnp.asarray(prob), jnp.asarray(loc), jnp.asarray(anchors), **kw))
    got = pmb.multibox_detection(torch.from_numpy(prob),
                                 torch.from_numpy(loc),
                                 torch.from_numpy(anchors), **kw).numpy()
    _bits_equal(got[..., :2], want[..., :2], "ids and scores")
    np.testing.assert_array_equal(got[..., 0] >= 0, want[..., 0] >= 0)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-6)
    assert 0 < (want[..., 0] >= 0).sum() < want[..., 0].size


# ---------------------------------------------------------------------------
# ssd_toy against the reference
# ---------------------------------------------------------------------------


def _draw(net, seed):
    rs = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        s = p.shape
        if name.endswith("gamma"):
            a = 1.0 + 0.1 * rs.randn(*s)
        elif name.endswith("running_var"):
            a = 1.0 + 0.5 * rs.rand(*s)
        elif name.endswith(("beta", "running_mean", "bias")):
            a = 0.1 * rs.randn(*s)
        else:
            a = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        p.set_data(jmx.nd.array(a.astype(np.float32)))


def _scene(batch=4, size=32, seed=11):
    rs = np.random.RandomState(seed)
    x = rs.rand(batch, 3, size, size).astype(np.float32)
    labels = np.full((batch, 3, 5), -1.0, np.float32)
    labels[0, :2] = [[0, 0.1, 0.1, 0.55, 0.6], [1, 0.4, 0.3, 0.9, 0.95]]
    labels[1, :1] = [[1, 0.2, 0.25, 0.7, 0.8]]
    labels[2:, 0] = [[0, 0.3, 0.05, 0.8, 0.5], [1, 0.05, 0.5, 0.45, 0.9]]
    return x, labels


_BIAS_BEFORE_BN = ("trunk.0.bias", "trunk.3.bias", "trunk.6.bias",
                   "stage1.0.bias", "stage2.0.bias")


def test_ssd_toy_matches_the_reference(tmp_path):
    """ssd_toy(num_classes=2) at 32x32 from the reference's weights: the
    forward, the targets and the loss, then one Adam step."""
    x, labels = _scene()
    path = tmp_path / "ssd.params"
    jnet = jvision.ssd_toy(num_classes=2)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    _draw(jnet, 5)
    jnet.save_parameters(str(path))
    net = vision.ssd_toy(num_classes=2)
    net.load_parameters(str(path), ctx=mx.cpu())
    assert sorted(net._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())

    want = [o.asnumpy() for o in jnet(jmx.nd.array(x))]
    got = net(mx.nd.array(x, ctx=mx.cpu()))
    for g, w, what in zip(got, want, ("anchors", "cls", "box")):
        _close_to_max(g.asnumpy(), w, 1e-5, what)

    def step(pkg, model, ag, trainer_cls, nd_x, nd_lab):
        loss_fn = pkg.gluon.model_zoo.vision.SSDMultiBoxLoss()
        trainer = trainer_cls(model.collect_params(), "adam",
                              {"learning_rate": 1e-3})
        before = {k: p.data().asnumpy().copy() for k, p in
                  model._collect_params_with_prefix().items()}
        with ag.record():
            an, cp, bp = model(nd_x)
            lt, lm, ct = model.targets(an, nd_lab, cp)
            loss = loss_fn(cp, bp, ct, lt, lm)
        loss.backward()
        params = model._collect_params_with_prefix()
        grads = {k: params[k].grad().asnumpy().copy()
                 for k in _BIAS_BEFORE_BN}
        trainer.step(1)
        after = {k: p.data().asnumpy() for k, p in params.items()}
        return (float(loss.asnumpy()), ct.asnumpy(), lm.asnumpy(),
                {k: after[k] - before[k] for k in before}, grads,
                max(float(np.abs(p.grad().asnumpy()).max())
                    for p in params.values() if p.grad_req != "null"))

    jl, jct, jlm, jd, jg, top_grad = step(
        jmx, jnet, jag, jmx.gluon.Trainer, jmx.nd.array(x),
        jmx.nd.array(labels))
    pl, pct, plm, pd, pg, _ = step(mx, net, autograd, Trainer,
                                   mx.nd.array(x, ctx=mx.cpu()),
                                   mx.nd.array(labels, ctx=mx.cpu()))
    np.testing.assert_array_equal(pct, jct)
    np.testing.assert_array_equal(plm, jlm)
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    for k in jd:
        if k in _BIAS_BEFORE_BN:
            continue
        ref = np.linalg.norm(jd[k])
        assert np.linalg.norm(pd[k] - jd[k]) <= 1e-3 * ref, k
    # a convolution's bias feeding a batch-statistics BatchNorm has a
    # gradient of 0 up to rounding, so Adam's first step there is the
    # sign of that rounding (lr * g / (|g| + eps)) in either package:
    # both gradients must be rounding, nothing more
    for k in _BIAS_BEFORE_BN:
        for grads in (jg, pg):
            assert np.abs(grads[k]).max() <= 1e-5 * top_grad, k


# ---------------------------------------------------------------------------
# the reference's SSD tests (tests/test_ssd.py), in the port
# ---------------------------------------------------------------------------


def _nd(a):
    return mx.nd.array(np.asarray(a, np.float32), ctx=mx.cpu())


def test_prior_geometry_and_count():
    an = mx.nd.contrib.MultiBoxPrior(_nd(np.ones((1, 1, 2, 2))),
                                     sizes=(0.5,), ratios=(1.0,))
    a = an.asnumpy()[0]
    assert a.shape == (4, 4)
    np.testing.assert_allclose(a[0], [0.0, 0.0, 0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(a[3], [0.5, 0.5, 1.0, 1.0], atol=1e-6)
    an = mx.nd.contrib.MultiBoxPrior(_nd(np.ones((1, 1, 3, 5))),
                                     sizes=(0.9, 0.4),
                                     ratios=(1.0, 2.0, 0.5), clip=True)
    assert an.shape == (1, 3 * 5 * 4, 4)
    assert an.asnumpy().min() >= 0.0 and an.asnumpy().max() <= 1.0
    an = mx.nd.contrib.MultiBoxPrior(_nd(np.ones((1, 1, 1, 1))),
                                     sizes=(0.4, 0.2), ratios=(1.0, 4.0))
    a = an.asnumpy()[0]
    np.testing.assert_allclose(a[:, 2] - a[:, 0], [0.4, 0.2, 0.8],
                               atol=1e-6)
    np.testing.assert_allclose(a[:, 3] - a[:, 1], [0.4, 0.2, 0.2],
                               atol=1e-6)


def test_encode_decode_recovers_the_truth():
    an = mx.nd.contrib.MultiBoxPrior(_nd(np.ones((1, 1, 4, 4))),
                                     sizes=(0.4,), ratios=(1.0, 2.0))
    n = an.shape[1]
    gt = np.array([[[1, 0.22, 0.31, 0.58, 0.66]]], "float32")
    loc_t, loc_m, cls_t = mx.nd.contrib.MultiBoxTarget(
        an, _nd(gt), _nd(np.zeros((1, 3, n))))
    ct = cls_t.asnumpy()[0]
    assert (ct == 2).sum() >= 1
    probs = np.zeros((1, 3, n), "float32")
    probs[0, 0, :] = 1.0
    matched = ct > 0
    probs[0, 0, matched] = 0.0
    probs[0, 2, matched] = 1.0
    det = mx.nd.contrib.MultiBoxDetection(
        _nd(probs), loc_t, an, threshold=0.5, nms_threshold=0.5) \
        .asnumpy()[0]
    kept = det[det[:, 0] >= 0]
    assert len(kept) >= 1
    np.testing.assert_allclose(kept[0, 2:6], gt[0, 0, 1:5], atol=1e-3)
    assert kept[0, 0] == 1.0


def test_hard_negative_mining_and_shared_best_anchor():
    an = mx.nd.contrib.MultiBoxPrior(_nd(np.ones((1, 1, 4, 4))),
                                     sizes=(0.4,), ratios=(1.0,))
    n = an.shape[1]
    gt = np.array([[[0, 0.2, 0.2, 0.6, 0.6]]], "float32")
    cls_pred = _nd(np.random.RandomState(0).randn(1, 2, n))
    c = mx.nd.contrib.MultiBoxTarget(an, _nd(gt), cls_pred,
                                     negative_mining_ratio=3.0)[2] \
        .asnumpy()[0]
    n_pos, n_neg = (c > 0).sum(), (c == 0).sum()
    assert n_pos >= 1 and (c == -1).sum() > 0 and n_neg <= 3 * n_pos + 1
    an = mx.nd.contrib.MultiBoxPrior(_nd(np.ones((1, 1, 2, 2))),
                                     sizes=(0.5,), ratios=(1.0,))
    gt = np.array([[[0, 0.02, 0.02, 0.48, 0.48],
                    [1, 0.10, 0.10, 0.60, 0.60]]], "float32")
    c = mx.nd.contrib.MultiBoxTarget(an, _nd(gt), _nd(np.zeros(
        (1, 3, an.shape[1]))))[2].asnumpy()[0]
    assert (c == 1).sum() >= 1 and (c == 2).sum() >= 1, c


def test_zoo_shapes_and_tensor_calls():
    net = vision.get_model("ssd_toy", num_classes=3)
    net.initialize(ctx=mx.cpu())
    x = np.ones((2, 3, 64, 64), np.float32)
    an, cp, bp = net(_nd(x))
    assert an.shape[0] == 1 and an.shape[2] == 4
    assert cp.shape == (2, an.shape[1], 4)
    assert bp.shape == (2, an.shape[1] * 4)
    assert net.detect(_nd(x)).shape == (2, an.shape[1], 6)
    net.eval()
    with torch.no_grad():
        t_an, t_cp, t_bp = net(torch.from_numpy(x))
        det = net.detect(torch.from_numpy(x))
    assert isinstance(det, torch.Tensor) and det.shape == (2, an.shape[1],
                                                           6)
    _bits_equal(t_an.numpy(), an.asnumpy(), "anchors")
    _bits_equal(t_cp.numpy(), cp.asnumpy(), "cls")


def test_training_learns_a_fixed_scene():
    """The reference's ``test_training_learns_fixed_scene``: 40 Adam steps
    on one image with one box, then a detection overlapping it."""
    mx.random.seed(3)
    net = vision.ssd_toy(num_classes=2)
    net.initialize(ctx=mx.cpu())
    loss_fn = vision.SSDMultiBoxLoss()
    rs = np.random.RandomState(4)
    img = rs.rand(1, 3, 32, 32).astype("float32")
    img[:, :, 8:24, 8:24] += 2.0
    x = _nd(img)
    label = _nd(np.array([[[0, 0.25, 0.25, 0.75, 0.75]]], "float32"))
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 5e-3})
    first = last = None
    for _ in range(40):
        with autograd.record():
            anchors, cls_preds, box_preds = net(x)
            loc_t, loc_m, cls_t = net.targets(anchors, label, cls_preds)
            loss = loss_fn(cls_preds, box_preds, cls_t, loc_t, loc_m)
        loss.backward()
        trainer.step(1)
        v = float(loss.asnumpy())
        first = v if first is None else first
        last = v
    assert last < first * 0.5, (first, last)
    det = net.detect(x, threshold=0.3).asnumpy()[0]
    kept = det[det[:, 0] >= 0]
    assert len(kept) >= 1
    bx = kept[0, 2:6]
    ix = max(0, min(bx[2], 0.75) - max(bx[0], 0.25)) * \
        max(0, min(bx[3], 0.75) - max(bx[1], 0.25))
    union = (bx[2] - bx[0]) * (bx[3] - bx[1]) + 0.25 - ix
    assert ix / union > 0.3, kept[0]
