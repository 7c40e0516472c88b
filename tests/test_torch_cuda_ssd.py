"""SSD's ops on the card against their plain versions and the CPU: the
``box_nms`` kernels (``kernels/csrc/box_nms.cu``) against their plain
version on the same card over crafted rows (score ties, +-0 and NaN
scores, shared and distinct ids, ``force_suppress``, ``topk``, the
center format in and out, leading axes), random rows at SSD's n = 7,620
with ``topk`` 400 and at the op's default ``topk=-1``, counts of rows at
each boundary of the kernels' design (63/64/65 and 128 rows, 2,048/2,049
where the sweep's removed bits leave registers, the last row count of
the one-launch route and the first of the two-launch one), rows all
kept, none valid and all overlapping, bit for bit; a CUDA graph's
replays of each route against the eager call; kernels per call and
shared memory against ``nms_plan``; ``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection``
on the card against the CPU; and the pooling and extremum faults of
ROADMAP.md's queue 3 (the sign of a zero max, integer pooling, the max
pool's selection where a window's max is not finite) on CUDA tensors
against the CPU, which the CPU tests hold against the reference.

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_ssd.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import (box_nms_sorted,
                                     box_nms_sorted_reference, nms_plan)
from mxnet_tpu_torch.ops import multibox, spatial
from mxnet_tpu_torch.ops import nn as ops_nn
from mxnet_tpu_torch.ops.registry import get_op


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


def _same_bits(a, b):
    """Equal bit for bit, the sign of a zero included; NaN equal to
    NaN."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    nan = torch.isnan(b)
    if not torch.equal(torch.isnan(a), nan):
        return False
    view = {4: torch.int32, 2: torch.int16, 8: torch.int64}[a.element_size()]
    return torch.equal(a[~nan].view(view), b[~nan].view(view))


def nms_rows(seed, n=60, lead=(2,), fmt="corner", ids=3, layout="cluster",
             pad=False):
    """(*lead, n, 6) rows [id, score, box] whose boxes cluster, so that
    many pairs overlap (``layout="grid"``: no two boxes overlap;
    ``"same"``: every box is one box); scores with ties, +-0 and NaN; ids
    shared and distinct. ``pad``: a seventh column of -3 first, so that
    the id, the score and the box start at columns 1, 2 and 3.
    ``tests/test_torch_ssd.py`` draws its rows here too."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(int(np.prod(lead))):
        centers = rs.rand(5, 2) * 0.6 + 0.2
        a = (centers[rs.randint(0, 5, n)] + rs.randn(n, 2) * 0.04) \
            .astype(np.float32)
        size = (0.15 + rs.rand(n, 2) * 0.1).astype(np.float32)
        if layout == "grid":
            side = int(np.ceil(np.sqrt(n)))
            cell = np.stack([np.arange(n) % side, np.arange(n) // side], 1)
            a = ((cell + 0.5) / side).astype(np.float32)
            size = np.full((n, 2), 0.5 / side, np.float32)
        elif layout == "same":
            a = np.full((n, 2), 0.5, np.float32)
            size = np.full((n, 2), 0.3, np.float32)
        boxes = np.concatenate([a, size] if fmt == "center"
                               else [a - size / 2, a + size / 2], axis=1)
        score = np.round(rs.rand(n), 1).astype(np.float32)
        score[::9] = 0.0
        score[4::9] = -0.0
        score[7::17] = np.nan
        score[2::19] = -0.25
        cls = rs.randint(0, ids, n).astype(np.float32)
        cls[11::23] = -1.0
        out.append(np.concatenate([cls[:, None], score[:, None], boxes],
                                  axis=1))
    rows = np.stack(out).reshape(tuple(lead) + (n, 6)).astype(np.float32)
    if pad:
        rows = np.concatenate([np.full_like(rows[..., :1], -3.0), rows], -1)
    return rows


# the most sorted rows the one-launch (shared) route takes
LAST_SHARED_M = max(m for m in range(64, 8193, 64)
                    if nms_plan(m).route == "shared")

NMS_CASES = {
    "per_class": dict(id_index=0),
    "one_class": dict(),
    "force": dict(id_index=0, force_suppress=True),
    "topk": dict(id_index=0, topk=17),
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
    "n_1000": dict(id_index=0, n=1000, lead=(3,)),
    "n_1000_no_ids": dict(n=1000, lead=(2,), overlap_thresh=0.3),
    "n_3000_mask_in_memory": dict(id_index=0, n=3000, lead=(2,)),
    "ssd_7620_topk_400": dict(id_index=0, n=7620, lead=(32,), topk=400,
                              overlap_thresh=0.45, valid_thresh=0.01),
    # where the kernels' design branches: one word (63, 64), a second
    # word, two full words, the words crossing 32 on the global route
    # (2,048 / 2,049), and the last row count of the shared route and the
    # first of the global one
    "n_63": dict(id_index=0, n=63),
    "n_64": dict(id_index=0, n=64),
    "n_128": dict(id_index=0, n=128),
    "n_2048": dict(id_index=0, n=2048, lead=(2,)),
    "n_2049": dict(id_index=0, n=2049, lead=(2,)),
    "n_last_shared_route": dict(id_index=0, n=LAST_SHARED_M, lead=(2,)),
    "n_first_global_route": dict(id_index=0, n=LAST_SHARED_M + 1,
                                 lead=(2,)),
    # rows all kept, none valid, all overlapping (one kept an image)
    "all_kept": dict(id_index=0, layout="grid", expect="all_valid"),
    "none_valid": dict(id_index=0, valid_thresh=2.0, expect="none"),
    "all_overlap": dict(layout="same", expect="one_an_image"),
    "topk_1": dict(id_index=0, topk=1, expect="one_an_image"),
    "n_out_equals_m": dict(id_index=0, topk=60),
    # other columns: the id, the score and the box at 1, 2 and 3 of 7
    "seven_columns": dict(id_index=1, score_index=2, coord_start=3,
                          pad=True, out_format="center"),
    # the op's default topk = -1 at SSD's row count
    "ssd_7620_default_topk": dict(id_index=0, n=7620, lead=(4,),
                                  overlap_thresh=0.45, valid_thresh=0.01),
}


def _sorted_rows(rows, kw):
    flat = rows.reshape(-1, *rows.shape[-2:])
    n, k = flat.shape[1:]
    m = n if kw.get("topk", -1) <= 0 else min(n, kw["topk"])
    order = torch.argsort(-flat[..., kw.get("score_index", 1)], dim=-1,
                          stable=True)
    return flat.gather(1, order[:, :m, None].expand(-1, -1, k)) \
        .contiguous(), n


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_box_nms_kernel_is_its_plain_version(case):
    """The kernel against its plain version on the same card, and the
    op on the card against the op on the CPU, bit for bit."""
    _require_card()
    kw = dict(NMS_CASES[case])
    gen = {k: kw.pop(k) for k in ("fmt", "lead", "n", "layout", "pad")
           if k in kw}
    expect = kw.pop("expect", "some")
    rows = torch.from_numpy(nms_rows(len(case), **gen))
    sorted_rows, n = _sorted_rows(rows.cuda(), kw)
    args = _nms_args(kw)
    before = box_nms_sorted.launches
    got = box_nms_sorted(sorted_rows, n, **args)
    torch.cuda.synchronize()
    assert box_nms_sorted.launches == before + 1
    want = box_nms_sorted_reference(sorted_rows, n, **args)
    assert _same_bits(got, want), case
    card = spatial.box_nms(rows.cuda(), **kw)
    cpu = spatial.box_nms(rows, **kw)
    assert _same_bits(card, cpu), case
    kept = int((cpu[..., args["score_index"]] != -1).sum())
    valid = sorted_rows[..., args["score_index"]].cpu() > \
        args["valid_thresh"]
    if expect == "some":
        assert 0 < kept < rows[..., 1].numel()
    elif expect == "none":
        assert kept == 0
    elif expect == "all_valid":
        assert kept == int(valid.sum()) > 0
    else:
        assert kept == int(valid.any(dim=1).sum()) > 0


def _nms_args(kw):
    """box_nms_sorted's arguments for an op's keywords."""
    return dict(overlap_thresh=kw.get("overlap_thresh", 0.5),
                valid_thresh=kw.get("valid_thresh", 0.0),
                coord_start=kw.get("coord_start", 2),
                score_index=kw.get("score_index", 1),
                id_index=-1 if kw.get("force_suppress")
                else kw.get("id_index", -1),
                in_format=kw.get("in_format", "corner"),
                out_format=kw.get("out_format", "corner"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [400, 2049])
def test_box_nms_graph_replays_are_the_eager_call(n):
    """Each route captured into a CUDA graph (the global route's scratch
    from the graph's pool) and replayed 12 times over a zeroed output:
    every replay the eager call's bits."""
    _require_card()
    rows = torch.from_numpy(nms_rows(n, n=n, lead=(3,))).cuda()
    sorted_rows, _ = _sorted_rows(rows, {})
    args = _nms_args(dict(id_index=0))
    eager = box_nms_sorted(sorted_rows, n + 7, **args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        box_nms_sorted(sorted_rows, n + 7, **args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = box_nms_sorted(sorted_rows, n + 7, **args)
    for _ in range(12):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64, 65, 400, 1856, 1857, 2048, 2049])
def test_box_nms_kernels_and_shared_memory_are_the_plan(m):
    """Kernels a call enqueues (a graph capture's kernel nodes) as
    ``nms_plan`` states them, and the sweeping launch's shared memory: the
    kernel's entry point takes the plan's bytes and refuses bytes that
    differ from its own layout by a word either way."""
    _require_card()
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels.box_nms import _ARGS

    plan = nms_plan(m, 2)
    rows = torch.from_numpy(nms_rows(m, n=m, lead=(2,))).cuda()
    sorted_rows, _ = _sorted_rows(rows, {})
    args = _nms_args(dict(id_index=0))
    box_nms_sorted(sorted_rows, m, **args)
    assert _build.kernels_per_call(
        lambda: box_nms_sorted(sorted_rows, m, **args)) == plan.kernels
    fn = _build.load("box_nms.cu").mx_box_nms
    fn.argtypes = _ARGS
    out = torch.empty_like(sorted_rows)
    scratch = torch.empty(max(plan.scratch_bytes // 8, 1), dtype=torch.int64,
                          device="cuda")

    def launch(shared_bytes):
        return fn(sorted_rows.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                  2, m, m, 6, 2, 1, 0, 0, 0, args["overlap_thresh"],
                  args["valid_thresh"],
                  int(plan.route == "global"), shared_bytes,
                  torch.cuda.current_stream().cuda_stream)

    bad = 1  # cudaErrorInvalidValue
    assert launch(plan.shared_bytes - 8) == bad
    assert launch(plan.shared_bytes + 8) == bad
    assert launch(plan.shared_bytes) == 0
    torch.cuda.synchronize()
    assert _same_bits(out, box_nms_sorted(sorted_rows, m, **args))


@pytest.mark.cuda
def test_box_nms_kernel_takes_no_host_sync():
    """One call under torch's sync-debug mode "error": the sort, the
    gather and the two launches read nothing back, so a CUDA graph can
    hold them."""
    _require_card()
    rows = torch.from_numpy(nms_rows(5, n=300, lead=(4,))).cuda()
    spatial.box_nms(rows, id_index=0, topk=100)
    torch.cuda.set_sync_debug_mode("error")
    try:
        spatial.box_nms(rows, id_index=0, topk=100)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _anchors(h, w, dev):
    x = torch.zeros(1, 1, h, w, device=dev)
    return multibox.multibox_prior(x, sizes=(0.4, 0.2),
                                   ratios=(1.0, 2.0, 0.5))


@pytest.mark.cuda
def test_multibox_ops_on_the_card_are_the_cpus():
    """The prior bit for bit; the targets' classes and masks bit for bit
    and their offsets within 1e-6 of the largest; the detections' ids,
    scores and kept set bit for bit, their boxes within 1e-6."""
    _require_card()
    for h, w in ((38, 38), (7, 5)):
        assert _same_bits(_anchors(h, w, "cuda"), _anchors(h, w, "cpu"))
    rs = np.random.RandomState(3)
    an = _anchors(10, 10, "cpu")
    n = an.shape[1]
    labels = np.full((4, 8, 5), -1.0, np.float32)
    for b in range(4):
        for j in range(b + 2):
            c = rs.rand(2) * 0.6 + 0.1
            labels[b, j] = [rs.randint(0, 20), c[0], c[1],
                            c[0] + 0.1 + rs.rand() * 0.3,
                            c[1] + 0.1 + rs.rand() * 0.3]
    labels[0, 1, 1:] = labels[0, 0, 1:] + 0.01    # a shared best anchor
    cls_pred = torch.from_numpy(rs.randn(4, 21, n).astype(np.float32))
    lab = torch.from_numpy(labels)
    cpu = multibox.multibox_target(an, lab, cls_pred,
                                   negative_mining_ratio=3.0)
    card = multibox.multibox_target(an.cuda(), lab.cuda(), cls_pred.cuda(),
                                    negative_mining_ratio=3.0)
    assert _same_bits(card[2], cpu[2]) and _same_bits(card[1], cpu[1])
    err = float((card[0].cpu() - cpu[0]).abs().max())
    assert err <= 1e-6 * float(cpu[0].abs().max()), err
    prob = torch.softmax(cls_pred, dim=1)
    loc = torch.from_numpy((rs.randn(4, n * 4) * 0.5).astype(np.float32))
    for kw in (dict(nms_topk=400, nms_threshold=0.45),
               dict(background_id=3, force_suppress=True, threshold=0.05)):
        cpu = multibox.multibox_detection(prob, loc, an, **kw)
        card = multibox.multibox_detection(prob.cuda(), loc.cuda(),
                                           an.cuda(), **kw).cpu()
        assert _same_bits(card[..., :2], cpu[..., :2]), kw
        assert float((card[..., 2:] - cpu[..., 2:]).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# queue 3's faults on CUDA tensors, against the CPU
# ---------------------------------------------------------------------------


def _card_and_cpu(fn, x, grad=True):
    outs = {}
    for dev in ("cuda", "cpu"):
        t = x.clone().to(dev)
        if grad:
            t.requires_grad_()
        y = fn(t)
        if grad:
            y.backward(torch.arange(1.0, y.numel() + 1.0).reshape(y.shape)
                       .to(dev))
        outs[dev] = (y.detach(), t.grad if grad else None)
    return outs["cuda"], outs["cpu"]


_ZEROS = torch.tensor([[-0.0, 0.0, 0.0, -0.0], [-0.0, -0.0, 0.0, 0.0]])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["broadcast_maximum", "broadcast_minimum",
                                "clip", "max", "min", "topk"])
def test_signed_zero_extrema_on_the_card(op):
    _require_card()
    other = _ZEROS.flip(1)
    fns = {
        "broadcast_maximum": lambda t: get_op(op).fn(t, other.to(t.device)),
        "broadcast_minimum": lambda t: get_op(op).fn(t, other.to(t.device)),
        "clip": lambda t: get_op(op).fn(t, a_min=0.0, a_max=6.0),
        "max": lambda t: get_op(op).fn(t, axis=1),
        "min": lambda t: get_op(op).fn(t, axis=1),
        "topk": lambda t: get_op(op).fn(t, k=2, ret_typ="value"),
    }
    (cy, cg), (py, pg) = _card_and_cpu(fns[op], _ZEROS)
    assert _same_bits(cy, py) and _same_bits(cg, pg), op


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("global_pool", [False, True])
@pytest.mark.parametrize("convention", ["valid", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_zero_sign_and_selection_on_the_card(layout, global_pool,
                                                      convention, dtype):
    """The sign of a zero max, and the selection of a window whose max
    is NaN or -inf, with overlapping padded windows (torch's pools
    padded, and padded by the port for the full convention); bfloat16's
    forward only (its gradients' sums round in the card's order)."""
    _require_card()
    rs = np.random.RandomState(1)
    pool = np.array([np.nan, np.inf, -np.inf, -np.inf, 1.0, 1.0, 0.0,
                     -0.0], np.float32)
    x = torch.from_numpy(rs.choice(pool, size=(2, 3, 9, 9)))
    x[0, 1, :3, :3] = -np.inf
    x[1, 2] = torch.where(torch.arange(81).reshape(9, 9) % 2 == 0,
                          -0.0, 0.0)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    grad = dtype == "float32"
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
              global_pool=global_pool, layout=layout,
              pooling_convention=convention)
    (cy, cg), (py, pg) = _card_and_cpu(lambda t: ops_nn.pooling(t, **kw),
                                       x.to(getattr(torch, dtype)), grad)
    assert _same_bits(cy, py) and (not grad or _same_bits(cg, pg))


@pytest.mark.cuda
@pytest.mark.parametrize("pool_type", ["avg", "sum"])
@pytest.mark.parametrize("pad", [0, 1])
def test_integer_pooling_on_the_card(pool_type, pad):
    _require_card()
    x = torch.arange(2 * 3 * 8 * 8, dtype=torch.int32).reshape(2, 3, 8, 8) \
        - 100
    kw = dict(kernel=(2, 2), stride=(2, 2), pad=(pad, pad),
              pool_type=pool_type)
    card = ops_nn.pooling(x.cuda(), **kw)
    cpu = ops_nn.pooling(x, **kw)
    assert card.dtype == cpu.dtype and _same_bits(card, cpu)
