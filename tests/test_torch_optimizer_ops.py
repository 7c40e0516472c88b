"""The 31 optimizer update ops of ``mx.nd`` (``ops/optimizer_op.py``)
against the JAX package's (``mxnet_tpu/ops/optimizer_op.py``) on the CPU.

Each op gets the same seeded numpy weights, gradients and states in f32
(the ``mp_`` variants also with bf16 weights and gradients beside f32
masters), with ±0, NaN and ±inf among the gradients, and runs with a
non-power-of-two learning rate, weight decay, ``rescale_grad`` and,
where the op takes one, ``clip_gradient``. Every output must have the
reference's dtype and shape, NaN where the reference has NaN, the same
infinities, and finite values equal to the reference's bit for bit,
except LAMB's first stage (``CLOSE``): the port's op multiplies the
moments by the f32 reciprocals of ``1 - beta**t``, as the port's eager
sweep does, so that the per-parameter update equals the fused one bit
for bit, where the reference's function divides (and its compiled eager
op, which contracts FMAs, agrees with neither bit for bit); ``upd`` sums
two terms that may cancel, so it is held to ``CLOSE_TOL`` of the value
and of the output's largest magnitude. ``multi_sum_sq`` sums in
another order than XLA, and is held so too.

Then the ``out=`` write-back contract, the aliases, and the
per-parameter updates of the four fused families against the fused
sweep bit for bit.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import optimizer_op as jops

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops.registry import get_op

SHAPE = (7, 33)
LR = 0.0123
WD = 0.017
RESCALE = 0.37
CLIP = 0.9
# LAMB's first stage, which the reference's op and the port's take in
# different forms (see the module docstring); every other op is held bit
# for bit
CLOSE = {"lamb_update_phase1", "mp_lamb_update_phase1", "multi_sum_sq"}
CLOSE_TOL = 2e-6


def _check(name, got, want, ulps=None):
    """Each output against the reference's: bit for bit, or for the ops
    in ``CLOSE`` within ``CLOSE_TOL`` of the value and of the output's
    largest magnitude (see the module docstring)."""
    assert len(got) == len(want), name
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(jnp.asarray(w, jnp.float32)) \
            if str(w.dtype) == "bfloat16" else np.asarray(w)
        g32 = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        assert g.shape == tuple(w.shape), (name, k)
        w32 = w.astype(np.float32)
        nan = np.isnan(w32)
        np.testing.assert_array_equal(np.isnan(g32), nan,
                                      err_msg=f"{name}[{k}] NaN positions")
        inf = np.isinf(w32)
        np.testing.assert_array_equal(g32[inf], w32[inf],
                                      err_msg=f"{name}[{k}] infinities")
        fin = ~nan & ~inf
        if name not in CLOSE:
            np.testing.assert_array_equal(g32[fin], w32[fin],
                                          err_msg=f"{name}[{k}]")
        elif fin.any():
            np.testing.assert_allclose(
                g32[fin], w32[fin], rtol=CLOSE_TOL,
                atol=CLOSE_TOL * float(np.abs(w32[fin]).max()),
                err_msg=f"{name}[{k}]")


def _inputs(seed, n_states, dtype=np.float32, special=True,
            positive_states=()):
    rs = np.random.RandomState(seed)
    w = rs.randn(*SHAPE).astype(np.float32)
    g = rs.randn(*SHAPE).astype(np.float32) * 2.0
    if special:
        g[0, :6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5.0]
    states = []
    for i in range(n_states):
        s = rs.randn(*SHAPE).astype(np.float32) * 0.1
        if i in positive_states:
            s = np.abs(s) + 0.01
        states.append(s)
    return w, g, states


def _to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _to_jax(a, dtype=jnp.float32):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _run(name, tensors, attrs, jtensors=None):
    """The port's op through ``mx.nd`` on CPU NDArrays, and the
    reference's pure function on jnp arrays."""
    with mx.cpu():
        args = [mx.nd.NDArray(t) for t in tensors]
        out = getattr(mx.nd, name)(*args, **attrs)
    out = out if isinstance(out, (list, tuple)) else [out]
    jt = jtensors if jtensors is not None else [_to_jax(t.numpy())
                                                for t in tensors]
    ref = getattr(jops, name.lstrip("_").replace("contrib_", "")
                  if not hasattr(jops, name) else name)(*jt, **attrs)
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    return [o._data for o in out], ref


# name, number of states, attrs, positive states
SINGLE = [
    ("sgd_update", 0, dict(lr=LR, wd=WD, rescale_grad=RESCALE,
                           clip_gradient=CLIP), ()),
    ("sgd_mom_update", 1, dict(lr=LR, wd=WD, momentum=0.9,
                               rescale_grad=RESCALE), ()),
    ("nag_mom_update", 1, dict(lr=LR, wd=WD, momentum=0.9,
                               rescale_grad=RESCALE, clip_gradient=CLIP),
     ()),
    ("adam_update", 2, dict(lr=LR, wd=WD, beta1=0.9, beta2=0.999,
                            epsilon=1e-8, rescale_grad=RESCALE,
                            clip_gradient=CLIP), (1,)),
    ("_contrib_adamw_update", 2, dict(lr=LR, wd=WD, beta1=0.9, beta2=0.95,
                                      epsilon=1e-6, eta=1.0,
                                      rescale_grad=RESCALE), (1,)),
    ("rmsprop_update", 1, dict(lr=LR, wd=WD, gamma1=0.9, epsilon=1e-8,
                               rescale_grad=RESCALE, clip_gradient=CLIP,
                               clip_weights=2.5), (0,)),
    ("rmspropalex_update", 3, dict(lr=LR, wd=WD, gamma1=0.9, gamma2=0.8,
                                   epsilon=1e-8, rescale_grad=RESCALE,
                                   clip_gradient=CLIP), (0,)),
    ("ftrl_update", 2, dict(lr=LR, wd=WD, lamda1=0.01, beta=1.0,
                            rescale_grad=RESCALE, clip_gradient=CLIP),
     (1,)),
    ("signsgd_update", 0, dict(lr=LR, wd=WD, rescale_grad=RESCALE,
                               clip_gradient=CLIP), ()),
    ("signum_update", 1, dict(lr=LR, wd=WD, momentum=0.9, wd_lh=0.01,
                              rescale_grad=RESCALE), ()),
    ("adagrad_update", 1, dict(lr=LR, wd=WD, epsilon=1e-7,
                               rescale_grad=RESCALE, clip_gradient=CLIP),
     (0,)),
    ("adadelta_update", 2, dict(wd=WD, rho=0.9, epsilon=1e-5,
                                rescale_grad=RESCALE, clip_gradient=CLIP),
     (0, 1)),
    ("ftml_update", 3, dict(lr=LR, wd=WD, beta1=0.6, beta2=0.999,
                            epsilon=1e-8, t=3, rescale_grad=RESCALE,
                            clip_grad=CLIP), (1,)),
    ("lamb_update_phase1", 2, dict(beta1=0.9, beta2=0.999, epsilon=1e-6,
                                   t=3, bias_correction=True, wd=WD,
                                   rescale_grad=RESCALE,
                                   clip_gradient=CLIP), (1,)),
]


@pytest.mark.parametrize("special", [False, True],
                         ids=["finite", "nan_inf_zero"])
@pytest.mark.parametrize("name,n_states,attrs,pos", SINGLE,
                         ids=[c[0] for c in SINGLE])
def test_single_op_matches_reference(name, n_states, attrs, pos, special):
    w, g, states = _inputs(zlib.crc32(name.encode()) % 1000, n_states,
                           special=special,
                           positive_states=pos)
    tensors = [_to_torch(a) for a in [w, g] + states]
    got, want = _run(name, tensors, attrs)
    _check(name, got, want)


def test_ops_without_clip_match_reference():
    """The same ops with clipping off (-1) and rescale 1."""
    for name, n_states, attrs, pos in SINGLE:
        attrs = {k: v for k, v in attrs.items()
                 if k not in ("clip_gradient", "clip_grad", "rescale_grad")}
        w, g, states = _inputs(7, n_states, special=False,
                               positive_states=pos)
        got, want = _run(name, [_to_torch(a) for a in [w, g] + states],
                         attrs)
        _check(name, got, want)


def test_lamb_phase2_matches_reference():
    w, g, _ = _inputs(3, 0, special=False)
    for lb, ub in ((-1.0, -1.0), (0.5, 3.0), (20.0, -1.0)):
        for r1, r2 in ((4.2, 1.7), (0.0, 1.0), (1.0, 0.0)):
            attrs = dict(lr=LR, lower_bound=lb, upper_bound=ub)
            tensors = [_to_torch(w), _to_torch(g),
                       torch.tensor([r1]), torch.tensor([r2])]
            got, want = _run("lamb_update_phase2", tensors, attrs)
            _check("lamb_update_phase2", got, want)


# -- multi-precision variants in bf16 -----------------------------------------

MP = [
    ("mp_sgd_update", 0, dict(lr=LR, wd=WD, rescale_grad=RESCALE,
                              clip_gradient=CLIP)),
    ("mp_sgd_mom_update", 1, dict(lr=LR, wd=WD, momentum=0.9,
                                  rescale_grad=RESCALE)),
    ("mp_nag_mom_update", 1, dict(lr=LR, wd=WD, momentum=0.9,
                                  rescale_grad=RESCALE)),
    ("mp_lamb_update_phase1", 2, dict(beta1=0.9, beta2=0.999, epsilon=1e-6,
                                      t=5, wd=WD, rescale_grad=RESCALE)),
]


@pytest.mark.parametrize("name,n_states,attrs", MP, ids=[c[0] for c in MP])
def test_mp_op_matches_reference_in_bf16(name, n_states, attrs):
    w, g, states = _inputs(11, n_states, special=True,
                           positive_states=(1,))
    w_bf = _to_torch(w, torch.bfloat16)
    g_bf = _to_torch(g, torch.bfloat16)
    w32 = w_bf.float()                       # the master of the bf16 weight
    tensors = [w_bf, g_bf] + [_to_torch(s) for s in states] + [w32]
    jt = [_to_jax(w_bf.float().numpy(), jnp.bfloat16),
          _to_jax(g_bf.float().numpy(), jnp.bfloat16)] \
        + [_to_jax(s) for s in states] + [_to_jax(w32.numpy())]
    got, want = _run(name, tensors, attrs, jt)
    for k, (a, b) in enumerate(zip(got, want)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), (name, k)
    _check(name, got, want, )


def test_mp_lamb_phase2_in_bf16():
    w, g, _ = _inputs(12, 0, special=False)
    w_bf = _to_torch(w, torch.bfloat16)
    w32 = w_bf.float()
    tensors = [w_bf, _to_torch(g), torch.tensor([3.0]), torch.tensor([2.0]),
               w32]
    jt = [_to_jax(w32.numpy(), jnp.bfloat16), _to_jax(g),
          jnp.asarray([3.0], jnp.float32), jnp.asarray([2.0], jnp.float32),
          _to_jax(w32.numpy())]
    got, want = _run("mp_lamb_update_phase2", tensors, dict(lr=LR), jt)
    assert got[0].dtype == torch.bfloat16
    _check("mp_lamb_update_phase2", got, want)


# -- multi-tensor ops ---------------------------------------------------------

def _members(n, per, seed, mp=False, positive=()):
    rs = np.random.RandomState(seed)
    shapes = [(3, 5), (17,), (4, 4, 2)][:n]
    rows = []
    for shp in shapes:
        row = [rs.randn(*shp).astype(np.float32) for _ in range(per)]
        for i in positive:
            row[i] = np.abs(row[i]) + 0.01
        rows.append(row)
    return rows


MULTI = [
    ("multi_sgd_update", 2, False, ()),
    ("multi_sgd_mom_update", 3, False, ()),
    ("multi_mp_sgd_update", 3, True, ()),
    ("multi_mp_sgd_mom_update", 4, True, ()),
    ("multi_lamb_update", 4, False, (3,)),
    ("multi_mp_lamb_update", 5, True, (3,)),
]


# the SGD ops also in their preloaded form (the reference has no
# preloaded LAMB op)
MULTI_CASES = [c + (False,) for c in MULTI] + [
    c + (True,) for c in MULTI if "lamb" not in c[0]]


@pytest.mark.parametrize("name,per,mp,pos,preloaded", MULTI_CASES,
                         ids=[("preloaded_" if c[4] else "") + c[0]
                              for c in MULTI_CASES])
def test_multi_op_matches_reference(name, per, mp, pos, preloaded):
    rows = _members(3, per, 5, mp, pos)
    lrs, wds = (0.011, 0.023, 0.0071), (0.01, 0.0, 0.1)
    tensors, jt = [], []
    for row in rows:
        for i, a in enumerate(row):
            if mp and i == per - 1:          # the f32 master
                a = row[0]
            tensors.append(_to_torch(a))
            jt.append(_to_jax(a))
    attrs = dict(rescale_grad=RESCALE, num_weights=3)
    if "mom" in name:
        attrs["momentum"] = 0.9
    if "lamb" in name:
        attrs.update(t=4, beta1=0.9, beta2=0.999)
    if preloaded:
        name = "preloaded_" + name
        tensors += [torch.tensor(lrs), torch.tensor(wds)]
        jt += [jnp.asarray(lrs, jnp.float32), jnp.asarray(wds, jnp.float32)]
    else:
        attrs.update(lrs=lrs, wds=wds)
    got, want = _run(name, tensors, attrs, jt)
    _check(name, got, want, )


def test_multi_sum_sq_matches_reference():
    rows = _members(3, 1, 9)
    tensors = [_to_torch(r[0]) for r in rows]
    got, want = _run("multi_sum_sq", tensors, dict(num_arrays=3))
    _check("multi_sum_sq", got, want, )


# -- the registry and the out= contract ---------------------------------------

ALL_31 = ["sgd_update", "sgd_mom_update", "mp_sgd_update",
          "mp_sgd_mom_update", "nag_mom_update", "mp_nag_mom_update",
          "adam_update", "_contrib_adamw_update", "rmsprop_update",
          "rmspropalex_update", "ftrl_update", "signsgd_update",
          "signum_update", "adagrad_update", "adadelta_update",
          "ftml_update", "lamb_update_phase1", "lamb_update_phase2",
          "mp_lamb_update_phase1", "mp_lamb_update_phase2",
          "multi_sgd_update", "multi_sgd_mom_update", "multi_mp_sgd_update",
          "multi_mp_sgd_mom_update", "multi_lamb_update",
          "multi_mp_lamb_update", "preloaded_multi_sgd_update",
          "preloaded_multi_sgd_mom_update", "preloaded_multi_mp_sgd_update",
          "preloaded_multi_mp_sgd_mom_update", "multi_sum_sq"]


def test_every_reference_name_is_registered():
    from mxnet_tpu.ops import registry as jreg

    assert len(ALL_31) == 31
    for name in ALL_31 + ["adamw_update", "_sparse_adagrad_update"]:
        assert jreg.get_op(name) is not None
        assert hasattr(mx.nd, name), name
        get_op(name)
    assert get_op("adamw_update") is get_op("_contrib_adamw_update")
    assert get_op("_sparse_adagrad_update") is get_op("adagrad_update")


def test_out_writes_in_place():
    """``out=`` writes the results into the given arrays and returns
    them; the inputs are left as they were otherwise."""
    w, g, (m,) = _inputs(2, 1, special=False)
    with mx.cpu():
        wn, gn, mn = (mx.nd.array(a) for a in (w, g, m))
        w_t, m_t = wn._data, mn._data
        ret = mx.nd.sgd_mom_update(wn, gn, mn, lr=LR, momentum=0.9, wd=WD,
                                   out=[wn, mn])
        assert ret[0] is wn and ret[1] is mn
        assert wn._data is w_t and mn._data is m_t   # the same storage
        ref_w, ref_m = jops.sgd_mom_update(_to_jax(w), _to_jax(g),
                                           _to_jax(m), lr=LR, momentum=0.9,
                                           wd=WD)
        _check("sgd_mom_update", [wn._data, mn._data], [ref_w, ref_m])
        np.testing.assert_array_equal(gn.asnumpy(), g)
        fresh = mx.nd.sgd_update(mx.nd.array(w), gn, lr=LR)
        assert isinstance(fresh, mx.nd.NDArray)


# -- the four families: per-parameter == fused sweep, bit for bit -------------

def _family_net(seed, dtype):
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.Dense(4, in_units=16))
    net.initialize(mx.init.Normal(0.3), ctx=mx.cpu())
    if dtype != "float32":
        net.cast(dtype)
    return net


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9, wd=0.01)),
    ("sgd", dict(wd=0.01, clip_gradient=0.05)),
    ("adam", dict(wd=0.01)),
    ("adamw", dict(wd=0.05, beta2=0.95)),
    ("lamb", dict(wd=0.01, lower_bound=0.01, upper_bound=5.0)),
])
def test_per_parameter_equals_fused_sweep(name, kw, dtype):
    """Five ``Trainer`` steps of each fused family through its sweep and
    through the per-parameter ``Updater`` (a subclass takes that path),
    with ``multi_precision`` under bf16: every weight, master and state
    equal bit for bit."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.optimizer import optimizer as popt

    cls = type(popt.create(name))
    sub = type("Per" + cls.__name__, (cls,), {})
    kw = dict(kw, learning_rate=0.0137,
              multi_precision=dtype != "float32")
    rs = np.random.RandomState(4)
    x = rs.randn(6, 8).astype(np.float32)
    nets, trainers = [], []
    for opt in (cls(**kw), sub(**kw)):
        net = _family_net(3, dtype)
        if nets:
            net.load_state_dict(nets[0].state_dict())
        nets.append(net)
        trainers.append(Trainer(net.collect_params(), opt))
    with mx.cpu():
        for step in range(5):
            for net, tr in zip(nets, trainers):
                xx = mx.nd.array(x * (step + 1), dtype=dtype)
                with mx.autograd.record():
                    loss = (net(xx) ** 2).sum()
                loss.backward()
                tr.step(6)
    assert pmt.family_of(trainers[0].optimizer) == name
    assert pmt.family_of(trainers[1].optimizer) is None
    for (k, p), (_, q) in zip(nets[0].collect_params().items(),
                              nets[1].collect_params().items()):
        assert torch.equal(p.tensor, q.tensor), k
    s0, s1 = trainers[0]._updater.states, trainers[1]._updater.states

    def leaves(s):
        if s is None:
            return []
        if isinstance(s, tuple):
            return [x for v in s for x in leaves(v)]
        return [s._data if isinstance(s, mx.nd.NDArray) else s]

    for i in s0:
        for a, b in zip(leaves(s0[i]), leaves(s1[i])):
            assert torch.equal(a, b), i


from mxnet_tpu_torch.optimizer import multi_tensor as pmt  # noqa: E402
