"""The port's eager training path held against the JAX package on the CPU:
the LAMB sweep (plain version against ``packed_apply("lamb",
interpret=True)`` and the eager ``_LambSweep``), LAMB's bias-correction
scalars, ``autograd.record``/``pause``/``backward``, ``Parameter`` and
``Block.collect_params``, and ``gluon.Trainer`` over ten steps for each
sweep family against the JAX ``Trainer``; then one ``Trainer`` + LAMB
step of a 2-layer ``BERTForPretrainFused`` against the JAX eager step
and the port's ``TrainStep(..., "lamb")``, and that ``TrainStep``
against the JAX ``TrainStep``.

Inputs and weights are drawn with numpy ``RandomState`` and handed to
both packages. The CUDA kernel runs only on the card:
tests/test_torch_cuda_kernels.py holds it against the plain version
there.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.loss import L2Loss
from mxnet_tpu.gluon.model_zoo.nlp import bert as jbert
from mxnet_tpu.optimizer import multi_tensor as jmt
from mxnet_tpu.optimizer import optimizer as jopt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import bert_pretrain_params_from_reference
from mxnet_tpu_torch.gluon import Parameter, ParameterDict, Trainer
from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused
from mxnet_tpu_torch.gluon.nn import Dense, HybridSequential
from mxnet_tpu_torch.kernels import fused_lamb_sweep, lamb_sweep_reference
from mxnet_tpu_torch.optimizer import LAMB
from mxnet_tpu_torch.optimizer import multi_tensor as pmt
from mxnet_tpu_torch.parallel import TrainStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    """A torch or jax array (or a port NDArray) as float32 numpy."""
    if isinstance(x, mx.nd.NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the LAMB sweep
# ---------------------------------------------------------------------------

SHAPES = [(4, 5), (7,), (2, 3, 2), (33, 17), (6,), (3, 4), (9,)]
LRS = [0.01, 0.005, 0.02, 0.01, 0.03, 0.04, 0.01]
WDS = [0.01, 0.0, 0.01, 0.1, 0.01, 0.05, 0.01]
ZERO_MEMBER, NAN_MEMBER, INF_MEMBER = 1, 4, 5
T = 3                                   # the update count of the step
LAMB_STATIC = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
               "clip_gradient": None}


def _lamb_members(rs, bf16_grads):
    ws = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    ws[ZERO_MEMBER][:] = 0.0
    gs = [(3 * rs.randn(*s)).astype(np.float32) for s in SHAPES]
    ms = [0.1 * rs.randn(*s).astype(np.float32) for s in SHAPES]
    vs = [rs.rand(*s).astype(np.float32) for s in SHAPES]
    if bf16_grads:
        gs = [np.array(jnp.asarray(g).astype(jnp.bfloat16)
                       .astype(jnp.float32)) for g in gs]
    gs[NAN_MEMBER].flat[2] = np.nan
    gs[INF_MEMBER].flat[5] = np.inf
    return ws, gs, ms, vs


def _bc(mode):
    """(bias_correction, bc_recip, bc1s, bc2s) at step T, as
    collect_scalars ships them in each mode."""
    if mode == "none":
        return False, True, None, None
    b1, b2 = 1.0 - 0.9 ** T, 1.0 - 0.999 ** T
    if mode == "recip":
        b1 = float(np.float32(1.0) / np.float32(b1))
        b2 = float(np.float32(1.0) / np.float32(b2))
    n = len(SHAPES)
    return True, mode == "recip", [b1] * n, [b2] * n


LAMB_CASES = [("f32", "recip", None), ("f32", "div", None),
              ("f32", "none", None), ("f32", "recip", (0.5, 2.0)),
              ("bf16-mp", "recip", None), ("bf16-mp", "div", (0.5, 2.0))]


@pytest.mark.parametrize("bucket,mode,bounds", LAMB_CASES)
def test_lamb_sweep_plain_matches_jax_packed_apply(bucket, mode, bounds):
    """The plain sweep against ``packed_apply("lamb", interpret=True)``
    (the Pallas sweep in interpret mode) and against the eager
    ``_LambSweep`` (the three jitted programs the JAX Trainer runs on the
    CPU), over an f32 bucket and a bf16 multi-precision one (f32 masters,
    bf16 grads, the bf16 weights written in the same pass), in each
    bias-correction mode (the f32 reciprocals of the eager path, the
    divisors of the fused step, none), with and without bounds, with a
    member whose weights are all zero (r1 = 0: ratio 1, or the lower
    bound over r2), one whose grad holds a NaN and one an inf (r2 is NaN:
    ratio 1, and the NaN reaches the weight). Phase 1 (the moments and
    ``upd``) at the Adam sweep's rtol 1e-6 / atol 1e-7 (XLA contracts
    FMAs); the weights at rtol 1e-6 plus 1e-6 of each member's largest
    step, since r1 and r2 are f32 sums taken in another order than
    XLA's (a relative difference d in lr * ratio moves an element by d
    times its step)."""
    mp = bucket == "bf16-mp"
    rs = np.random.RandomState(71)
    ws, gs, ms, vs = _lamb_members(rs, mp)
    bias_correction, bc_recip, bc1s, bc2s = _bc(mode)
    lo, hi = bounds or (None, None)
    static = dict(LAMB_STATIC, bias_correction=bias_correction,
                  bc_recip=bc_recip, lower_bound=lo, upper_bound=hi)
    vecs = {"lr": LRS, "wd": WDS}
    if bias_correction:
        vecs.update(bc1=bc1s, bc2=bc2s)
    ins = {"w": [jnp.asarray(a) for a in ws],
           "g": [jnp.asarray(a) for a in gs],
           "mean": [jnp.asarray(a) for a in ms],
           "var": [jnp.asarray(a) for a in vs]}
    want = jmt.packed_apply("lamb", static, SHAPES, ins, vecs, 0.5,
                            low_dtype=jnp.bfloat16 if mp else None,
                            platform="cpu", interpret=True)
    # the eager reference: _LambSweep's three programs
    names = sorted(vecs)
    sweep = jmt._LambSweep(tuple(sorted(static.items())), SHAPES,
                           jnp.bfloat16, mp, names)
    jw = [jnp.asarray(a) for a in ws]
    jg = [jnp.asarray(a).astype(jnp.bfloat16 if mp else jnp.float32)
          for a in gs]
    jm, jv = [jnp.asarray(a) for a in ms], [jnp.asarray(a) for a in vs]
    jvecs = [jmt._as_vec(vecs[k]) for k in names]
    lows = [w.astype(jnp.bfloat16) for w in jw] if mp else []
    eager = sweep(*(lows if mp else jw), *jg, *(jw if mp else []), *jm,
                  *jv, *jvecs, np.float32(0.5))
    n = len(SHAPES)
    e_w = eager[n:2 * n] if mp else eager[:n]
    e_m, e_v = eager[-2 * n:-n], eager[-n:]
    upd_want, _, _ = sweep._phase1(jw, jg, jm, jv, dict(zip(names, jvecs)),
                                   np.float32(0.5))

    t = {"w": [torch.from_numpy(a.copy()) for a in ws],
         "g": [torch.from_numpy(a.copy()) for a in gs],
         "mean": [torch.from_numpy(a.copy()) for a in ms],
         "var": [torch.from_numpy(a.copy()) for a in vs]}
    if mp:
        t["g"] = [g.to(torch.bfloat16) for g in t["g"]]
    low = [torch.zeros(s, dtype=torch.bfloat16) for s in SHAPES] \
        if mp else None
    before = fused_lamb_sweep.launches
    upds, norms = fused_lamb_sweep(
        t["w"], t["g"], t["mean"], t["var"], low, LRS, WDS, bc1s, bc2s,
        beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=0.5,
        bias_correction=bias_correction, bc_recip=bc_recip, lower_bound=lo,
        upper_bound=hi)
    assert fused_lamb_sweep.launches == before      # CPU: plain version
    assert norms.shape == (n, 2) and norms.dtype == torch.float32
    np.testing.assert_allclose(
        np.concatenate([_np(u).ravel() for u in upds]), _np(upd_want),
        rtol=1e-6, atol=1e-7)
    for role, ref in (("mean", want["mean"]), ("var", want["var"]),
                      ("mean", e_m), ("var", e_v)):
        for a, b in zip(t[role], ref):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7,
                                       err_msg=role)
    for ref in (want["w"], e_w):
        for j, (a, b) in enumerate(zip(t["w"], ref)):
            step = np.nan_to_num(np.abs(_np(b) - ws[j]), posinf=0.0).max()
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       atol=1e-6 * step + 1e-7,
                                       err_msg=f"w[{j}]")
    assert np.isnan(_np(t["w"][NAN_MEMBER])).sum() == 1
    assert np.isnan(_np(t["w"][INF_MEMBER])).sum() == 1
    if mp:
        for a, w in zip(low, t["w"]):        # as bits: NaNs compare
            assert torch.equal(a.view(torch.int16),
                               w.to(torch.bfloat16).view(torch.int16))


def test_lamb_sweep_zero_member_and_norms():
    """A member whose weights are all zero takes ratio 1 (``w = -lr *
    upd``); the returned norms are the f32 sums of squares' roots, before
    the bounds; ``norms=`` replaces them in phase 2 (how the card test
    feeds the kernel's norms to the plain version)."""
    rs = np.random.RandomState(5)
    w = [torch.zeros(6), torch.from_numpy(rs.randn(5).astype(np.float32))]
    g = [torch.from_numpy(rs.randn(6).astype(np.float32)),
         torch.from_numpy(rs.randn(5).astype(np.float32))]
    m = [torch.zeros(6), torch.zeros(5)]
    v = [torch.zeros(6), torch.zeros(5)]
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
              lower_bound=0.1, upper_bound=10.0)
    w0 = [x.clone() for x in w]
    upds, norms = lamb_sweep_reference(w, g, m, v, None, [0.1, 0.1],
                                       [0.0, 0.0], [10.0, 10.0],
                                       [1000.0, 1000.0], **kw)
    assert float(norms[0, 0]) == 0.0
    np.testing.assert_allclose(float(norms[1, 0]), float(w0[1].norm()),
                               rtol=1e-6)
    np.testing.assert_allclose(float(norms[1, 1]), float(upds[1].norm()),
                               rtol=1e-6)
    # the lower bound lifts r1 = 0 to 0.1: ratio 0.1 / r2
    r = 0.1 / float(norms[0, 1])
    np.testing.assert_allclose(_np(w[0]), _np(-0.1 * r * upds[0]),
                               rtol=1e-6)
    # phase 2 on given norms: r1 = r2 gives ratio 1
    w = [x.clone() for x in w0]
    m = [torch.zeros(6), torch.zeros(5)]
    v = [torch.zeros(6), torch.zeros(5)]
    upds, _ = lamb_sweep_reference(w, g, m, v, None, [0.1, 0.1], [0.0, 0.0],
                                   [10.0, 10.0], [1000.0, 1000.0],
                                   norms=torch.ones(2, 2), **kw)
    for a, a0, u in zip(w, w0, upds):
        np.testing.assert_allclose(_np(a), _np(a0 - 0.1 * u), rtol=1e-6)


@pytest.mark.parametrize("t", [1, 2, 7, 1000])
def test_lamb_bias_correction_scalars_match_jax(t):
    """``collect_scalars``' ``bc1``/``bc2``: on the eager path the f32
    reciprocal of the f32-rounded ``1 - beta**t``, bit for bit with the
    JAX values; under ``dynamic`` (the fused step) ``1 - beta**t``, equal
    to the JAX step's once both are read as f32 (the sweep's
    ``_as_vec``); lr and wd carry each parameter's multipliers."""
    ports = LAMB(learning_rate=0.01, wd=0.1)
    refs = jopt.LAMB(learning_rate=0.01, wd=0.1)
    for o in (ports, refs):
        for _ in range(t):
            o._update_count(0)
            o._update_count(1)
    got = pmt.collect_scalars(ports, "lamb", [0, 1])
    want = jmt.collect_scalars(refs, "lamb", [0, 1])
    assert sorted(got) == sorted(want) == ["bc1", "bc2", "lr", "wd"]
    for k in got:
        assert [np.float32(x).tobytes() for x in got[k]] \
            == [np.float32(x).tobytes() for x in want[k]], k
    with ports.dynamic(np.int32(t), np.float32(0.01)), \
            refs.dynamic(jnp.int32(t), jnp.float32(0.01)):
        got = pmt.collect_scalars(ports, "lamb", [0])
        want = jmt.collect_scalars(refs, "lamb", [0])
        assert pmt.family_static(ports, "lamb") \
            == jmt.family_static(refs, "lamb")
    for k in ("bc1", "bc2", "lr"):
        assert np.float32(got[k][0]) == np.asarray(
            jnp.asarray(want[k][0], jnp.float32)), k
    assert dict(pmt.family_static(ports, "lamb"))["bc_recip"]
    no_bc = LAMB(bias_correction=False)
    no_bc._update_count(0)
    assert sorted(pmt.collect_scalars(no_bc, "lamb", [0])) == ["lr", "wd"]


# ---------------------------------------------------------------------------
# Trainer against the JAX Trainer: two Dense layers, an L2 loss
# ---------------------------------------------------------------------------

def _dtypes(dtype, mixed):
    """Each of the four parameters' dtype: ``dtype``, or with ``mixed``
    every second one the other of f32 and bf16."""
    other = "bfloat16" if dtype == "float32" else "float32"
    return [other if mixed and i % 2 else dtype for i in range(4)]


def _jax_run(optname, okw, steps, dtype, mp, grad_req=None, mixed=False,
             double_backward=False, mults=None):
    """The JAX eager Trainer (``tests/test_optimizer.py:150-199``'s
    model): returns the losses, the weights and the flattened states."""
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(16, in_units=32), jgluon.nn.Dense(8, in_units=16))
    net.initialize()
    rs = np.random.RandomState(7)
    params = list(net.collect_params().values())
    for i, (p, dt) in enumerate(zip(params, _dtypes(dtype, mixed))):
        p.cast(dt)
        p.set_data(jmx.nd.array(rs.randn(*p.shape).astype(np.float32))
                   .astype(dt))
        if grad_req is not None and i == 1:
            p.grad_req = grad_req
    for i, (lr_mult, wd_mult) in (mults or {}).items():
        params[i].lr_mult, params[i].wd_mult = lr_mult, wd_mult
    if isinstance(optname, type):     # an optimizer class, built here
        tr = jgluon.Trainer(net.collect_params(),
                            optname(**dict(okw, multi_precision=mp)))
    else:
        tr = jgluon.Trainer(net.collect_params(), optname,
                            dict(okw, multi_precision=mp))
    rs2 = np.random.RandomState(11)
    x = jmx.nd.array(rs2.randn(8, 32).astype(np.float32)).astype(dtype)
    y = jmx.nd.array(rs2.randn(8, 8).astype(np.float32)).astype(dtype)
    losses = []
    for _ in range(steps):
        for _ in range(2 if double_backward else 1):
            with jag.record():
                loss = L2Loss()(net(x), y)
            loss.backward()
        tr.step(8)
        losses.append(_np(loss.data))
    states = {i: [_np(leaf.data) for leaf in jax.tree_util.tree_leaves(
        st, is_leaf=lambda z: z is None or hasattr(z, "asnumpy"))
        if leaf is not None] for i, st in tr._updaters[0].states.items()}
    return losses, [_np(p.data().data) for p in params], states


def _port_net(dtype="float32", mixed=False):
    net = HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(Dense(16, in_units=32, prefix="0_"),
                Dense(8, in_units=16, prefix="1_"))
    net.initialize(ctx=mx.cpu())
    rs = np.random.RandomState(7)
    for p, dt in zip(net.collect_params().values(), _dtypes(dtype, mixed)):
        p.set_data(rs.randn(*p.shape).astype(np.float32))
        p.cast(dt)
    return net


def _port_run(optname, okw, steps, dtype, mp, grad_req=None, mixed=False,
              double_backward=False, mults=None):
    """The same run through the port's Trainer."""
    net = _port_net(dtype, mixed)
    params = list(net.collect_params().values())
    if grad_req is not None:
        params[1].grad_req = grad_req
    for i, (lr_mult, wd_mult) in (mults or {}).items():
        params[i].lr_mult, params[i].wd_mult = lr_mult, wd_mult
    if isinstance(optname, type):
        tr = Trainer(net.collect_params(),
                     optname(**dict(okw, multi_precision=mp)))
    else:
        tr = Trainer(net.collect_params(), optname,
                     dict(okw, multi_precision=mp))
    rs2 = np.random.RandomState(11)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rs2.randn(8, 32).astype(np.float32)).to(dt)
    y = torch.from_numpy(rs2.randn(8, 8).astype(np.float32)).to(dt)
    losses = []
    for _ in range(steps):
        for _ in range(2 if double_backward else 1):
            with mx.autograd.record():
                loss = (0.5 * torch.square(y - net(x))).mean(dim=1)
            mx.autograd.backward(loss)
        tr.step(8)
        losses.append(_np(loss))
    states = {i: [_np(t) for t in _leaves(st)]
              for i, st in tr._updater.states.items()}
    return losses, [_np(p.data()) for p in params], states, tr


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, mx.nd.NDArray):
        return [state._data]
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in _leaves(s)]


def _close(a, b, tol, what):
    """|a - b| <= tol * max|b| elementwise, NaNs where b has them."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(b)
    err = float(np.abs(a - b)[ok].max(initial=0.0))
    assert err <= tol * float(np.abs(b)[ok].max(initial=0.0)), (what, err)


def _compare(port, ref, tol, what=""):
    """Losses, weights and states of two runs, each within ``tol`` of its
    largest magnitude."""
    (pl, pw, ps), (jl, jw, js) = port[:3], ref
    _close(np.stack(pl), np.stack(jl), tol, f"{what} losses")
    for j, (a, b) in enumerate(zip(pw, jw)):
        _close(a, b, tol, f"{what} weight {j}")
    assert sorted(ps) == sorted(js), what
    for i in ps:
        assert len(ps[i]) == len(js[i]), (what, i)
        for a, b in zip(ps[i], js[i]):
            _close(a, b, tol, f"{what} state {i}")


# f32: the two frameworks sum the products in other orders (measured over
# ten steps: <= 5e-7 of each tensor's largest magnitude); bf16 with f32
# masters: the forward and backward round to bf16 at other places, one
# bf16 ulp (2**-8) in the grads at the first step, up to 1.4 * 2**-6
# (SGD's momentum) over ten steps
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
GATE = [("adam", {"learning_rate": 0.01}),
        ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
        ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
        ("lamb", {"learning_rate": 0.01, "wd": 0.01}),
        ("lamb", {"learning_rate": 0.01, "wd": 0.01, "lower_bound": 0.1,
                  "upper_bound": 10.0})]


@pytest.mark.parametrize("dtype,mp", [("float32", False), ("bfloat16", True)])
@pytest.mark.parametrize("optname,okw", GATE)
def test_trainer_ten_steps_match_the_jax_trainer(optname, okw, dtype, mp):
    """ROADMAP queue 1 item 7's gate: ten ``Trainer`` steps (record,
    ``autograd.backward`` of the per-sample L2 loss, ``step(8)``) from
    the same weights and batch as the JAX ``Trainer``'s, for adam,
    sgd with momentum, adamw and lamb (with and without bounds), in f32
    and in bf16 with f32 masters: losses, weights and every state leaf
    (masters, moments) within :data:`TOL` of their largest magnitude."""
    port = _port_run(optname, okw, 10, dtype, mp)
    _compare(port, _jax_run(optname, okw, 10, dtype, mp), TOL[dtype],
             optname)
    tr = port[3]
    assert tr.optimizer.num_update == 10
    assert tr.learning_rate == okw["learning_rate"]
    if mp:
        for p in tr._params:
            w32 = tr._updater.states[tr._params.index(p)][0]
            assert torch.equal(p.data()._data, w32.to(torch.bfloat16))


@pytest.mark.parametrize("optname", ["adam", "lamb"])
def test_mixed_set_with_a_null_parameter(optname):
    """f32 weights beside bf16 ones with f32 masters (two dtype buckets,
    one sweep each) and the first bias at ``grad_req="null"``: it gets
    no gradient, no state and no update, and the rest match the JAX
    Trainer's five steps."""
    okw = {"learning_rate": 0.01}
    port = _port_run(optname, okw, 5, "float32", True, grad_req="null",
                     mixed=True)
    _compare(port, _jax_run(optname, okw, 5, "float32", True,
                            grad_req="null", mixed=True),
             TOL["bfloat16"], optname)
    tr = port[3]
    null = tr._params[1]
    assert null.grad_req == "null" and not null._var.requires_grad
    assert null._var.grad is None and 1 not in tr._updater.states
    with pytest.raises(mx.MXNetError, match="grad_req='null'"):
        null.grad()
    np.testing.assert_array_equal(port[1][1], _np(_port_net(
        "float32", mixed=True)[0].bias.data()))
    items = [(i, p._var, p._var.grad) for i, p in enumerate(tr._params)
             if p.grad_req != "null"]
    plan = pmt.plan_eager(tr.optimizer, tr._updater, items)
    assert [(b.members, b.wdtype, b.mp) for b in plan.buckets] == \
        [((0, 1), torch.float32, False), ((2,), torch.bfloat16, True)]


def test_grad_req_add_accumulates_two_backwards_per_step():
    """``grad_req="add"`` on the first bias: two backwards a step add into
    its buffer (never zeroed, as in the reference), the others are
    overwritten; five Adam steps match the JAX Trainer's."""
    okw = {"learning_rate": 0.01}
    port = _port_run("adam", okw, 5, "float32", False, grad_req="add",
                     double_backward=True)
    _compare(port, _jax_run("adam", okw, 5, "float32", False,
                            grad_req="add", double_backward=True),
             TOL["float32"], "add")


def test_multipliers_through_collect_params_select():
    """``lr_mult``/``wd_mult`` set on what ``collect_params(select)``
    returns reach the sweep, as the JAX Trainer's ``param_dict`` carries
    them: the biases at ``wd_mult=0`` (GluonNLP's BERT scripts) and the
    second weight at ``lr_mult=2``, three LAMB steps at wd 0.1. The
    select is a regex matched from the prefixed name's start, the same
    Parameter object comes back from every call, and ``get`` of a name
    the dict lacks creates it under the dict's prefix, as the
    reference's does."""
    net = _port_net()
    first = net.collect_params()
    biases = net.collect_params(".*bias")
    assert list(biases.keys()) == ["net_0_bias", "net_1_bias"]
    assert biases["net_0_bias"] is first["net_0_bias"]
    assert list(net.collect_params("net_0").keys()) == ["net_0_weight",
                                                        "net_0_bias"]
    assert list(net.collect_params("bias").keys()) == []
    assert isinstance(first, ParameterDict)
    assert first.get("1_weight") is first["net_1_weight"]
    created = first.get("nosuch", shape=(2,))
    assert isinstance(created, Parameter) and created.name == "net_nosuch"
    assert first["net_nosuch"] is created
    okw = {"learning_rate": 0.01, "wd": 0.1}
    mults = {1: (1.0, 0.0), 3: (1.0, 0.0), 2: (2.0, 1.0)}
    port = _port_run("lamb", okw, 3, "float32", False, mults=mults)
    _compare(port, _jax_run("lamb", okw, 3, "float32", False, mults=mults),
             TOL["float32"], "mults")
    plain = _port_run("lamb", okw, 3, "float32", False)
    assert not np.allclose(port[1][2], plain[1][2])
    # set through one collect_params call, read through the next
    for p in net.collect_params(".*bias").values():
        p.wd_mult = 0.0
    tr = Trainer(net.collect_params(), "lamb", okw)
    assert [tr.optimizer._get_wd(i) for i in range(4)] == [0.1, 0.0, 0.1,
                                                           0.0]


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def test_record_and_pause_set_the_flags_and_grad_mode():
    """``record()`` turns recording, training and torch's grad mode on,
    ``pause()`` turns recording and grad mode off (and predict mode
    unless asked), each restoring what it found, as the reference's
    scopes do; ``train_mode``/``predict_mode`` leave recording alone."""
    ag = mx.autograd
    assert not ag.is_recording() and not ag.is_training()
    with torch.no_grad(), ag.record():
        assert ag.is_recording() and ag.is_training()
        assert torch.is_grad_enabled()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
            assert not torch.is_grad_enabled()
            with ag.train_mode():
                assert ag.is_training() and not ag.is_recording()
        with ag.pause(train_mode=True):
            assert ag.is_training() and not ag.is_recording()
        assert ag.is_recording() and torch.is_grad_enabled()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()
    assert not ag.is_recording() and not ag.is_training()
    assert ag.set_recording(True) is False
    assert ag.set_recording(False) is True
    with jag.record():
        assert jag.is_recording() and jag.is_training()


def _jax_dense(rs_seed=3, units=4, in_units=6):
    net = jgluon.nn.Dense(units, in_units=in_units)
    net.initialize()
    rs = np.random.RandomState(rs_seed)
    for p in net.collect_params().values():
        p.set_data(jmx.nd.array(rs.randn(*p.shape).astype(np.float32)))
    return net


def _port_dense(rs_seed=3, units=4, in_units=6):
    net = Dense(units, in_units=in_units)
    net.initialize(ctx=mx.cpu())
    rs = np.random.RandomState(rs_seed)
    for p in net.collect_params().values():
        p.set_data(rs.randn(*p.shape).astype(np.float32))
    return net


def test_backward_head_grads_and_write_against_add():
    """``backward(y, head_grads=hg)`` against the JAX ``backward``;
    without ``head_grads`` the head gradient is ones (a vector head is
    differentiated as its sum). Two backwards: ``"write"`` keeps the
    second gradient, ``"add"`` the sum, in both packages."""
    rs = np.random.RandomState(4)
    x = rs.randn(5, 6).astype(np.float32)
    hg = rs.randn(5, 4).astype(np.float32)
    jnet, pnet = _jax_dense(), _port_dense()
    jp, pp = list(jnet.collect_params().values()), \
        list(pnet.collect_params().values())
    jp[1].grad_req = pp[1].grad_req = "add"
    for scale in (1.0, 2.0):
        with jag.record():
            jy = jnet(jmx.nd.array(scale * x))
        jag.backward(jy, head_grads=jmx.nd.array(hg))
        with mx.autograd.record():
            py = pnet(torch.from_numpy(scale * x))
        mx.autograd.backward(py, head_grads=torch.from_numpy(hg))
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(_np(a.grad()), _np(b.grad().data),
                                   rtol=1e-5, atol=1e-5, err_msg=a.name)
    # write: the second backward's gradient, which is 2x the first's
    want_w = hg.T @ (2.0 * x)
    np.testing.assert_allclose(_np(pp[0].grad()), want_w, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(pp[1].grad()), 2 * hg.sum(0), rtol=1e-5)
    # head gradient of ones
    with mx.autograd.record():
        py = pnet(torch.from_numpy(x))
    mx.autograd.backward(py)
    np.testing.assert_allclose(_np(pp[0].grad()),
                               np.ones((5, 4), np.float32).T @ x, rtol=1e-5,
                               atol=1e-5)


def test_unreached_parameter_keeps_its_gradient_and_is_stepped():
    """A parameter the heads do not reach keeps the gradient it holds (a
    zero buffer from the start, then the last one written), and the
    Trainer steps it with that gradient, as the JAX Trainer does: two SGD
    steps, the first through both layers, the second through the first
    alone."""
    rs = np.random.RandomState(6)
    x = rs.randn(3, 6).astype(np.float32)
    okw = {"learning_rate": 0.1, "momentum": 0.5}
    jnets = [_jax_dense(1), _jax_dense(2)]
    pnets = [_port_dense(1), _port_dense(2)]
    jtr = jgluon.Trainer(
        {k: v for n in jnets for k, v in n.collect_params().items()},
        "sgd", okw)
    params = [p for n in pnets for p in n.collect_params().values()]
    ptr = Trainer(params, "sgd", okw)
    assert all(float(p.grad().abs().sum()) == 0.0 for p in params)
    for use in (2, 1):
        with jag.record():
            jl = sum(n(jmx.nd.array(x)).sum() for n in jnets[:use])
        jl.backward()
        jtr.step(3)
        with mx.autograd.record():
            pl = sum(n(torch.from_numpy(x)).sum() for n in pnets[:use])
        mx.autograd.backward(pl)
        ptr.step(3)
    jw = [p.data().data for n in jnets for p in n.collect_params().values()]
    for a, b in zip(params, jw):
        np.testing.assert_allclose(_np(a.data()), _np(b), rtol=1e-5,
                                   atol=1e-6, err_msg=a.name)
    assert ptr.optimizer.num_update == 2


def test_heads_outside_record():
    """Pinned difference (ROADMAP queue 3): torch records whenever its
    grad mode is on, so a head computed outside ``record()`` is on the
    tape and ``backward`` gives the same gradients as inside it, where
    the reference raises; a head computed under ``pause()`` or
    ``torch.no_grad()`` is not, and ``backward`` raises in both
    packages."""
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(3, 6).astype(np.float32))
    net = _port_dense()
    w = net.collect_params()[net.weight.name]
    with mx.autograd.record():
        y = net(x)
    mx.autograd.backward(y)
    inside = w.grad()._data.clone()
    w.zero_grad()
    mx.autograd.backward(net(x))
    assert torch.equal(w.grad()._data, inside)
    for scope in (mx.autograd.pause, torch.no_grad):
        with scope():
            y = net(x)
        with pytest.raises(mx.MXNetError, match="not on the tape"):
            mx.autograd.backward(y)
    jnet = _jax_dense()
    jy = jnet(jmx.nd.array(x.numpy()))
    with pytest.raises(jmx.MXNetError, match="not on the tape"):
        jag.backward(jy)


# ---------------------------------------------------------------------------
# BERT masked-LM pretraining through the eager entry points
# ---------------------------------------------------------------------------

CFG = dict(vocab_size=512, max_length=128, num_layers=2, units=64,
           hidden_size=128, num_heads=4, dropout=0.0, chunk=128)
BATCH, SEQ = 4, 128
NO_WD = ".*beta|.*gamma|.*bias"          # GluonNLP's BERT scripts
BERT_OPT = {"learning_rate": 1e-3, "wd": 0.01}


@pytest.fixture(scope="module")
def bert_weights():
    """Numpy weights of a 2-layer JAX BERTForPretrainFused, by name."""
    jnet = jbert.BERTForPretrainFused(**CFG)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8)), jmx.nd.zeros((1, 8)))
    rs = np.random.RandomState(31)
    named = {}
    for name, p in jnet.collect_params().items():
        if name.endswith("gamma"):
            arr = 1.0 + 0.1 * rs.randn(*p.shape)
        elif name.endswith(("beta", "bias")):
            arr = 0.1 * rs.randn(*p.shape)
        else:
            arr = rs.randn(*p.shape) / np.sqrt(p.shape[-1])
        named[name] = arr.astype(np.float32)
    return named


def _bert_batch():
    rs = np.random.RandomState(2)
    return (rs.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32),
            rs.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32))


def _jax_bert(named):
    jnet = jbert.BERTForPretrainFused(**CFG)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8)), jmx.nd.zeros((1, 8)))
    # each JAX block instance has its own name prefix
    by_suffix = {n[n.index("_") + 1:]: a for n, a in named.items()}
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(by_suffix[name[name.index("_") + 1:]]))
    return jnet


def _jax_params(jnet, named):
    """The JAX net's weights under ``named``'s names."""
    prefix = next(iter(named))[:next(iter(named)).index("_") + 1]
    return {prefix + n[n.index("_") + 1:]: p.data().asnumpy()
            for n, p in jnet.collect_params().items()}


def _jax_trainer_step(named):
    jnet = _jax_bert(named)
    for p in jnet.collect_params(NO_WD).values():
        p.wd_mult = 0.0
    tr = jgluon.Trainer(jnet.collect_params(), "lamb", dict(BERT_OPT))
    tok, lab = _bert_batch()
    with jag.record():
        loss = jnet(jmx.nd.array(tok), jmx.nd.array(lab))
    loss.backward()
    tr.step(loss.size)
    return float(loss.asnumpy().mean()), _jax_params(jnet, named)


def _jax_trainstep(named, steps):
    jnet = _jax_bert(named)
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step = jpar.TrainStep(jnet, lambda outs, *a: outs, "lamb", mesh=mesh,
                          loss_only=True, optimizer_params=dict(BERT_OPT))
    tok, lab = _bert_batch()
    batch = (jmx.nd.array(tok), jmx.nd.array(lab))
    losses = [float(step(batch, ())[0].asnumpy()) for _ in range(steps)]
    return losses, _jax_params(jnet, named)


def _port_bert(named):
    net = BERTForPretrainFused(ctx=mx.cpu(), **CFG)
    net.load_state_dict(bert_pretrain_params_from_reference(named))
    return net


def _port_trainer_step(named):
    net = _port_bert(named)
    for p in net.collect_params(NO_WD).values():
        p.wd_mult = 0.0
    tr = Trainer(net.collect_params(), "lamb", dict(BERT_OPT))
    tok, lab = (torch.from_numpy(a) for a in _bert_batch())
    with mx.autograd.record():
        loss = net(tok, lab)
    mx.autograd.backward(loss)
    tr.step(loss.numel())
    return float(loss.detach().mean()), net


def _port_trainstep(named, steps, no_wd=True):
    net = _port_bert(named)
    params = net.collect_params()
    if no_wd:
        for p in net.collect_params(NO_WD).values():
            p.wd_mult = 0.0
    # TrainStep indexes the parameters in collect_params' order
    opt = LAMB(param_dict=dict(enumerate(params.values())), **BERT_OPT)
    step = TrainStep(net, lambda outs, *a: outs, opt, loss_only=True)
    tok, lab = _bert_batch()
    losses = [float(step((tok, lab), ())[0]) for _ in range(steps)]
    return losses, net


def _sd(x):
    """A port net's weights, or named JAX weights carried across, as a
    port state dict of numpy arrays."""
    if isinstance(x, dict):
        x = bert_pretrain_params_from_reference(x)
    else:
        x = x.state_dict()
    return {k: _np(v) for k, v in x.items()}


def _delta_ratios(named, got, want):
    """Per parameter ‖Δw_got − Δw_want‖ / ‖Δw_want‖ from the weights
    ``named`` (``got``, ``want``: port nets or named JAX weights), with
    the key third of each QKV bias set aside: softmax ignores a constant
    added to every key, so its gradient is f32 noise, which LAMB turns
    into steps of either sign. Returns the ratios and the largest |Δ| of
    that key part on either side."""
    start, got, want = _sd(named), _sd(got), _sd(want)
    units = CFG["units"]
    ratios, key_bias = {}, 0.0
    for key, w0 in start.items():
        dg, dw = got[key] - w0, want[key] - w0
        if key.endswith("qkv_proj.bias"):
            part = slice(units, 2 * units)
            key_bias = max(key_bias, float(np.abs(dg[part]).max()),
                           float(np.abs(dw[part]).max()))
            dg, dw = np.delete(dg, part), np.delete(dw, part)
        norm = float(np.linalg.norm(dw))
        if norm == 0.0:
            assert float(np.linalg.norm(dg)) == 0.0, key
            continue
        ratios[key] = float(np.linalg.norm(dg - dw)) / norm
    return ratios, key_bias


def test_bert_trainer_lamb_step_matches_jax_and_trainstep(bert_weights,
                                                        monkeypatch):
    """One step of the eager path (``record``, the per-position loss,
    ``autograd.backward`` with a head gradient of ones, ``Trainer(...,
    "lamb").step(loss.numel())``, ``wd_mult = 0`` on every
    beta/gamma/bias) from the same weights and batch as the JAX eager
    Trainer's step and the port's ``TrainStep(..., LAMB)`` step, which
    reduces the loss by its mean and divides by ``1 - beta**t`` where
    the Trainer multiplies by its f32 reciprocal. The losses agree to
    1e-6 relative; each parameter's delta to 1e-3 of its norm (measured:
    <= 1.6e-4 against the JAX step, the median 0: at t = 1 LAMB's
    ``m / sqrt(v)`` is about ``sign(g)``, so only elements whose
    gradient is near ``epsilon`` move apart), the key third of each QKV
    bias set aside and held to moving less than 1% of lr."""
    named = bert_weights
    modes = []
    packed_apply = pmt.packed_apply

    def spy(family, static, ins, vecs, rescale, low=None):
        modes.append((dict(static)["bc_recip"], vecs["bc1"][0]))
        return packed_apply(family, static, ins, vecs, rescale, low=low)

    monkeypatch.setattr(pmt, "packed_apply", spy)
    jloss, jw = _jax_trainer_step(named)
    ploss, pnet = _port_trainer_step(named)
    (sloss,), snet = _port_trainstep(named, 1)
    assert modes == [(True, float(np.float32(1) / np.float32(1 - 0.9))),
                     (False, 1 - 0.9)]
    np.testing.assert_allclose([ploss, sloss], [jloss, jloss], rtol=1e-6)
    for got, want in ((pnet, jw), (snet, jw), (pnet, snet)):
        ratios, key_bias = _delta_ratios(named, got, want)
        worst = max(ratios, key=ratios.get)
        assert ratios[worst] < 1e-3, (worst, ratios[worst])
        assert key_bias < 0.01 * BERT_OPT["learning_rate"], key_bias


def test_trainstep_lamb_matches_the_jax_trainstep(bert_weights):
    """``TrainStep`` with ``"lamb"`` (dynamic mode: the bias corrections
    divide) against the JAX ``TrainStep`` with ``"lamb"``, three f32
    steps from the same weights and batch at wd 0.01 on every parameter:
    losses to 1e-5 relative, each parameter's delta to 1e-4 of its norm
    (measured: 1.2e-5), the key bias part set aside as above."""
    named = bert_weights
    jlosses, jw = _jax_trainstep(named, 3)
    plosses, net = _port_trainstep(named, 3, no_wd=False)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    assert plosses[0] > plosses[1] > plosses[2]
    ratios, key_bias = _delta_ratios(named, net, jw)
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] < 1e-4, (worst, ratios[worst])
    assert key_bias < 0.01 * 3 * BERT_OPT["learning_rate"], key_bias
    # bias_correction=False and the bounds reach the dynamic sweep too
    net = _port_bert(named)
    step = TrainStep(net, lambda outs, *a: outs, "lamb", loss_only=True,
                     optimizer_params=dict(BERT_OPT, bias_correction=False,
                                           lower_bound=0.5,
                                           upper_bound=4.0))
    tok, lab = _bert_batch()
    assert np.isfinite(float(step((tok, lab), ())[0]))


def test_backward_reaches_every_parameter_of_bert(bert_weights):
    """``autograd.backward`` of the 2-layer BERT's per-position loss
    finds every parameter the loss reaches by one walk of the graph (all
    but the unused token-type table) and writes each one's gradient,
    equal to torch's own backward of the loss's sum; the persistent
    buffers are the same tensors before and after."""
    net = _port_bert(bert_weights)
    params = net.collect_params()
    buffers = {n: p.grad() for n, p in params.items()}
    tok, lab = (torch.from_numpy(a) for a in _bert_batch())
    with mx.autograd.record():
        loss = net(tok, lab)
    leaves = mx.autograd._leaves([loss])
    assert len(leaves) == len(params) - 1
    assert {id(v) for v in leaves} == {
        id(p._var) for n, p in params.items()
        if not n.endswith("bert_token_type_embed_weight")}
    mx.autograd.backward(loss)
    ref = _port_bert(bert_weights)
    ref(tok, lab).sum().backward()
    for (n, p), q in zip(params.items(), ref.parameters()):
        assert p.grad() is buffers[n], n
        want = torch.zeros_like(q) if q.grad is None else q.grad
        np.testing.assert_allclose(_np(p.grad()), _np(want), rtol=1e-5,
                                   atol=1e-7, err_msg=n)


def test_trainer_refuses_what_needs_a_later_slice():
    """What the Trainer does not take raises: the kvstore types the
    reference refuses, ``update_on_kvstore`` without a store, an unknown
    partition mode; the data-parallel options (ROADMAP.md, queue 1, item
    9) are taken, and so are the local kvstores and an optimizer
    instance."""
    net = _port_dense()
    params = net.collect_params()
    # a store is made for several contexts (or a collective type name)
    params.reset_ctx([mx.cpu(0), mx.cpu(1)])
    for kw, what in (({"kvstore": "dist_async"}, "dist_async"),
                     ({"kvstore": "horovod"}, "horovod"),
                     ({"update_on_kvstore": True, "kvstore": None},
                      "requires a kvstore")):
        with pytest.raises(mx.MXNetError, match=what):
            Trainer(params, "sgd", **kw).step(1)
    params.reset_ctx(mx.cpu())
    with pytest.raises(mx.MXNetError, match="partition mode"):
        Trainer(params, "sgd", partition="zero3")
    for kw in ({"kvstore": "tpu_sync"}, {"kvstore": "nccl"},
               {"update_on_kvstore": True, "kvstore": "tpu_sync"},
               {"compression_params": {"type": "2bit"}, "kvstore": "nccl"},
               {"overlap_comms": True}, {"partition": "zero1"}):
        Trainer(params, "sgd", **kw).step(1)
    # ported in this slice: check_nonfinite, every optimizer, and a
    # subclass of a fused family (the per-parameter path)
    assert Trainer(params, "sgd", check_nonfinite=True)._check_nonfinite
    assert isinstance(Trainer(params, "nag").optimizer,
                      mx.optimizer.NAG)

    class MyLamb(LAMB):
        pass

    assert pmt.family_of(Trainer(params, MyLamb()).optimizer) is None
    with pytest.raises(mx.MXNetError, match="must be None"):
        Trainer(params, LAMB(), {"learning_rate": 0.1})
    with pytest.raises(mx.MXNetError, match="list or dict"):
        Trainer(object(), "sgd")
    for kv in (None, "device", "local"):
        Trainer(params, "sgd", kvstore=kv)
    opt = LAMB(learning_rate=0.5)
    tr = Trainer(list(params.values()), opt)
    assert tr.optimizer is opt and tr.learning_rate == 0.5
    assert set(opt.param_dict) == {0, 1}
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == 0.25
    tr.allreduce_grads()
    tr.update(4)
    assert opt.rescale_grad == 0.25 and opt.num_update == 1
    with pytest.raises(mx.MXNetError, match="grad_req"):
        params[net.weight.name].grad_req = "sometimes"


def test_trainer_module_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, mxnet_tpu_torch.gluon.trainer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# the per-parameter path, check_nonfinite, trainer states
# ---------------------------------------------------------------------------

class _JaxSGDSub(jopt.SGD):
    pass


class _PortSGDSub(mx.optimizer.SGD):
    pass


PER_PARAM = [
    ("nag", "nag", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("rmsprop", "rmsprop", {"learning_rate": 0.01, "gamma1": 0.95}),
    ("sgd_subclass", (_JaxSGDSub, _PortSGDSub),
     {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
]


@pytest.mark.parametrize("dtype,mp", [("float32", False), ("bfloat16", True)])
@pytest.mark.parametrize("case,optname,okw", PER_PARAM,
                         ids=[c[0] for c in PER_PARAM])
def test_per_parameter_path_matches_the_jax_trainer(case, optname, okw,
                                                    dtype, mp):
    """Three ``Trainer`` steps of NAG, RMSProp and a subclass of
    SGD (the per-parameter ``Updater``, no sweep), in f32 and in bf16 with
    f32 masters, against the JAX Trainer's: losses, weights and states
    within :data:`TOL`; one ``per_param`` dispatch per parameter a step
    and no fused sweep."""
    jname, pname = optname if isinstance(optname, tuple) else (optname,
                                                               optname)
    telemetry = mx.telemetry
    telemetry.reset()
    telemetry.enable()
    try:
        port = _port_run(pname, okw, 3, dtype, mp)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
        telemetry.reset()
    _compare(port, _jax_run(jname, okw, 3, dtype, mp), TOL[dtype], case)
    assert pmt.family_of(port[3].optimizer) is None
    got = _dispatches(snap)
    assert got == {"per_param": 12.0}, got


def _dispatches(snap):
    fam = snap["metrics"].get("mxnet_optimizer_dispatch_total",
                              {"samples": []})
    return {tuple(x["labels"].values())[0]: x["value"]
            for x in fam["samples"]}


def test_fused_and_unsweepable_parameters_split():
    """Under LAMB, a parameter the sweep cannot take (a bf16 weight
    without ``multi_precision``: LAMB's kernel takes f32 targets) goes
    through the per-parameter update, the rest through one sweep per
    dtype bucket."""
    net = _port_net("float32", mixed=True)
    tr = Trainer(net.collect_params(), "lamb", {"learning_rate": 0.01})
    x = torch.ones(8, 32)
    mx.telemetry.reset()
    mx.telemetry.enable()
    try:
        with mx.autograd.record():
            loss = (net(x) ** 2).mean(dim=1)
        mx.autograd.backward(loss)
        tr.step(8)
        got = _dispatches(mx.telemetry.snapshot())
    finally:
        mx.telemetry.disable()
        mx.telemetry.reset()
    assert got == {"fused_sweep": 1.0, "per_param": 2.0}, got
    assert isinstance(tr._updater.states[1][0], mx.nd.NDArray)
    assert isinstance(tr._updater.states[0][0], torch.Tensor)


def test_check_nonfinite_skips_and_counts(monkeypatch):
    """A step whose gradients hold NaN or Inf is skipped (weights and
    states untouched, the counts not advanced) and counted in
    ``steps_skipped`` and telemetry, as the JAX Trainer does; a finite
    step after it goes on from where the run was. The environment
    variable turns the guard on too."""
    results = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            net = _port_net()
            tr = Trainer(net.collect_params(), "adam",
                         {"learning_rate": 0.01}, check_nonfinite=True)
            params = list(net.collect_params().values())
        else:
            jnet = jgluon.nn.HybridSequential()
            jnet.add(jgluon.nn.Dense(16, in_units=32),
                     jgluon.nn.Dense(8, in_units=16))
            jnet.initialize()
            rs = np.random.RandomState(7)
            params = list(jnet.collect_params().values())
            for p in params:
                p.set_data(jmx.nd.array(rs.randn(*p.shape)
                                        .astype(np.float32)))
            tr = jgluon.Trainer(jnet.collect_params(), "adam",
                                {"learning_rate": 0.01},
                                check_nonfinite=True)
            net = jnet
        rs2 = np.random.RandomState(11)
        xs = rs2.randn(8, 32).astype(np.float32)
        weights = []
        for step in range(3):
            x = xs.copy()
            if step == 1:
                x[0, 0] = np.nan if pkg == "port" else np.inf
            if pkg == "port":
                with mx.autograd.record():
                    loss = (net(torch.from_numpy(x)) ** 2).mean(dim=1)
                mx.autograd.backward(loss)
            else:
                with jag.record():
                    loss = (net(jmx.nd.array(x)) ** 2).mean(axis=1)
                loss.backward()
            tr.step(8)
            weights.append([_np(p.data()) for p in params])
        results[pkg] = (weights, tr.steps_skipped,
                        tr.optimizer.num_update)
    (pw, pskip, pn), (jw, jskip, jn) = results["port"], results["jax"]
    assert pskip == jskip == 1 and pn == jn == 2
    for a, b in zip(pw[1], pw[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pw[2], jw[2]):
        _close(a, b, TOL["float32"], "after the skipped step")
    monkeypatch.setenv("MXNET_CHECK_NONFINITE", "1")
    assert Trainer(_port_net().collect_params(), "sgd")._check_nonfinite
    mx.telemetry.reset()
    mx.telemetry.enable()
    try:
        net = _port_net()
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
        for p in net.collect_params().values():
            p._grad_tensor().fill_(float("inf"))
        tr.step(1)
        fam = mx.telemetry.snapshot()["metrics"][
            "mxnet_steps_skipped_total"]
        assert fam["samples"][0]["value"] == 1.0
        assert tr.steps_skipped == 1
    finally:
        mx.telemetry.disable()
        mx.telemetry.reset()


def _port_steps(net, tr, steps, start=0):
    rs2 = np.random.RandomState(11)
    xs = [rs2.randn(8, 32).astype(np.float32) for _ in range(start + steps)]
    for x in xs[start:]:
        with mx.autograd.record():
            loss = (0.5 * torch.square(net(torch.from_numpy(x)))).mean(dim=1)
        mx.autograd.backward(loss)
        tr.step(8)


def _jax_net():
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(16, in_units=32), jgluon.nn.Dense(8, in_units=16))
    jnet.initialize()
    rs = np.random.RandomState(7)
    for p in jnet.collect_params().values():
        p.set_data(jmx.nd.array(rs.randn(*p.shape).astype(np.float32)))
    return jnet


def _jax_steps(jnet, tr, steps, start=0):
    rs2 = np.random.RandomState(11)
    xs = [rs2.randn(8, 32).astype(np.float32) for _ in range(start + steps)]
    for x in xs[start:]:
        with jag.record():
            loss = (0.5 * jnet(jmx.nd.array(x)) ** 2).mean(axis=1)
        loss.backward()
        tr.step(8)


def _sched():
    return mx.lr_scheduler.CosineScheduler(max_update=10, base_lr=0.05,
                                           warmup_steps=2,
                                           warmup_begin_lr=0.01)


@pytest.mark.parametrize("optname,okw,dtype", [
    ("nag", {"momentum": 0.9, "wd": 1e-4, "multi_precision": True},
     "bfloat16"),
    ("adam", {"wd": 1e-3}, "float32"),
    ("lamb", {"wd": 0.01, "multi_precision": True}, "bfloat16"),
])
def test_save_load_states_resume_bit_for_bit(tmp_path, optname, okw, dtype):
    """Two steps, ``save_parameters`` and ``save_states``; a fresh model
    and Trainer loaded from both take step 3 equal bit for bit to the
    uninterrupted run's, the scheduler and the counts resumed."""
    def trainer(net):
        return Trainer(net.collect_params(), optname,
                       dict(okw, lr_scheduler=_sched()))

    net = _port_net(dtype)
    tr = trainer(net)
    _port_steps(net, tr, 2)
    net.save_parameters(str(tmp_path / "w.params"))
    tr.save_states(str(tmp_path / "t.states"))
    _port_steps(net, tr, 1, start=2)
    net2 = _port_net(dtype)
    net2.load_parameters(str(tmp_path / "w.params"), ctx=mx.cpu())
    tr2 = trainer(net2)
    tr2.load_states(str(tmp_path / "t.states"))
    assert tr2.optimizer.num_update == 2
    assert tr2.optimizer._index_update_count == {i: 2 for i in range(4)}
    _port_steps(net2, tr2, 1, start=2)
    assert tr2.learning_rate == tr.learning_rate
    for p, q in zip(net.collect_params().values(),
                    net2.collect_params().values()):
        assert torch.equal(p.tensor, q.tensor), p.name
    for i in tr._updater.states:
        for a, b in zip(_leaves(tr._updater.states[i]),
                        _leaves(tr2._updater.states[i])):
            assert a.dtype == b.dtype and torch.equal(a, b), i
    with pytest.raises(mx.MXNetError, match="cannot read"):
        tr2.load_states(str(tmp_path / "missing.states"))
    (tmp_path / "bad.states").write_bytes(b"not a pickle")
    with pytest.raises(mx.MXNetError, match="not a valid optimizer state"):
        tr2.load_states(str(tmp_path / "bad.states"))


@pytest.mark.parametrize("optname,okw", [
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
])
def test_trainer_states_cross_load_with_the_jax_trainer(tmp_path, optname,
                                                        okw):
    """Two steps in one package, its ``save_states`` loaded by the other
    package's Trainer over the same weights, a third step there: equal
    to the first package's third step within :data:`TOL`, both ways."""
    # the port first, the reference resumes
    net = _port_net()
    tr = Trainer(net.collect_params(), optname, dict(okw))
    _port_steps(net, tr, 2)
    tr.save_states(str(tmp_path / "p.states"))
    w2 = [_np(p.data()).copy() for p in net.collect_params().values()]
    _port_steps(net, tr, 1, start=2)
    jnet = _jax_net()
    for p, w in zip(jnet.collect_params().values(), w2):
        p.set_data(jmx.nd.array(w))
    jtr = jgluon.Trainer(jnet.collect_params(), optname, dict(okw))
    jtr.load_states(str(tmp_path / "p.states"))
    assert jtr.optimizer.num_update == 2
    _jax_steps(jnet, jtr, 1, start=2)
    for p, q in zip(net.collect_params().values(),
                    jnet.collect_params().values()):
        _close(_np(p.data()), _np(q.data().data), TOL["float32"], p.name)
    # the reference first, the port resumes
    jnet = _jax_net()
    jtr = jgluon.Trainer(jnet.collect_params(), optname, dict(okw))
    _jax_steps(jnet, jtr, 2)
    jtr.save_states(str(tmp_path / "j.states"))
    jw2 = [_np(p.data().data) for p in jnet.collect_params().values()]
    _jax_steps(jnet, jtr, 1, start=2)
    net = _port_net()
    for p, w in zip(net.collect_params().values(), jw2):
        p.set_data(w)
    tr = Trainer(net.collect_params(), optname, dict(okw))
    tr.load_states(str(tmp_path / "j.states"))
    assert tr.optimizer.num_update == 2
    _port_steps(net, tr, 1, start=2)
    for p, q in zip(net.collect_params().values(),
                    jnet.collect_params().values()):
        _close(_np(p.data()), _np(q.data().data), TOL["float32"], p.name)


def test_checkpoint_bundle_with_trainer_states_loads_in_each_package(
        tmp_path):
    """``CheckpointManager.save(params=, trainer=)`` writes
    ``trainer.states`` beside the parameters; each package's
    ``restore(block=, trainer=)`` takes the other's bundle, and the
    restored states equal the saved ones."""
    from mxnet_tpu import checkpoint as jckpt

    net = _port_net()
    tr = Trainer(net.collect_params(), "nag",
                 {"learning_rate": 0.05, "momentum": 0.9})
    _port_steps(net, tr, 2)
    mx.checkpoint.CheckpointManager(str(tmp_path / "p")).save(
        2, params=net, trainer=tr)
    jnet = _jax_net()
    jtr = jgluon.Trainer(jnet.collect_params(), "nag",
                         {"learning_rate": 0.05, "momentum": 0.9})
    meta = jckpt.CheckpointManager(str(tmp_path / "p")).restore(
        block=jnet, trainer=jtr, restore_rng=False)
    assert meta["step"] == 2 and jtr.optimizer.num_update == 2
    for i, st in tr._updater.states.items():
        np.testing.assert_array_equal(
            _np(jtr._updaters[0].states[i].data), _np(st))
    # and back: the reference's bundle restores the port's trainer
    _jax_steps(jnet, jtr, 1, start=2)
    jckpt.CheckpointManager(str(tmp_path / "j")).save(3, params=jnet,
                                                      trainer=jtr)
    net2 = _port_net()
    tr2 = Trainer(net2.collect_params(), "nag",
                  {"learning_rate": 0.05, "momentum": 0.9})
    mx.checkpoint.CheckpointManager(str(tmp_path / "j")).restore(
        block=net2, trainer=tr2, restore_rng=False)
    assert tr2.optimizer.num_update == 3
    for i, st in jtr._updaters[0].states.items():
        np.testing.assert_array_equal(_np(tr2._updater.states[i]),
                                      _np(st.data))
    for p, q in zip(net2.collect_params().values(),
                    jnet.collect_params().values()):
        np.testing.assert_array_equal(_np(p.data()), _np(q.data().data))


@pytest.mark.parametrize("optname", ["adam", "lamb", "sgd"])
def test_fused_sweeps_read_the_scheduler(optname):
    """An ``lr_scheduler`` in ``optimizer_params``: the fused sweeps read
    each step's rate from it (``Optimizer.learning_rate`` at the advanced
    count), five steps against the JAX Trainer with the same cosine
    schedule and warmup, within :data:`TOL`."""
    from mxnet_tpu import lr_scheduler as jls

    kw = dict(max_update=6, base_lr=0.05, final_lr=0.001, warmup_steps=2,
              warmup_begin_lr=0.005)
    okw = {"momentum": 0.9} if optname == "sgd" else {}
    port = _port_run(optname, dict(
        okw, lr_scheduler=mx.lr_scheduler.CosineScheduler(**kw)), 5,
        "float32", False)
    ref = _jax_run(optname, dict(okw, lr_scheduler=jls.CosineScheduler(
        **kw)), 5, "float32", False)
    _compare(port, ref, TOL["float32"], optname)
    tr = port[3]
    assert pmt.family_of(tr.optimizer) == optname
    assert tr.learning_rate == jls.CosineScheduler(**kw)(5)
