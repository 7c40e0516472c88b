"""The port's sixteen optimizers through ``Updater`` against the JAX
package's on the CPU, and ``Updater.get_states``/``set_states`` across
the two packages.

Each optimizer runs five updates of three parameters (one of them bf16
under ``multi_precision`` where the optimizer takes it) from the same
seeded numpy weights and gradients in both packages; weights and states
must agree within ``RTOL``/``ATOL`` after each step (the reference's
eager ops are compiled programs, whose contracted FMAs round otherwise
than PyTorch's one op per step; tests/test_torch_optimizer_ops.py holds
each op bit for bit against the reference's function). The multipliers
come by ``param_dict``, by index (``set_lr_mult``/``set_wd_mult``) and by
name through ``param_idx2name``; ``begin_num_update`` and an
``lr_scheduler`` are covered. SGLD's deterministic part is compared with
its noise supplied to both, and its noise by its distribution.
"""
import io
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu.lr_scheduler as jls
from mxnet_tpu.optimizer import optimizer as jopt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.optimizer import optimizer as popt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(5, 7), (11,), (3, 4)]
RTOL, ATOL = 2e-5, 1e-6

KWARGS = {
    "sgd": dict(learning_rate=0.05, momentum=0.9, wd=0.01),
    "nag": dict(learning_rate=0.05, momentum=0.9, wd=0.01),
    "adam": dict(learning_rate=0.01, wd=0.001),
    "adamw": dict(learning_rate=0.01, wd=0.05),
    "lamb": dict(learning_rate=0.01, wd=0.01, lower_bound=0.001,
                 upper_bound=10.0),
    "rmsprop": dict(learning_rate=0.01, centered=False, clip_weights=3.0),
    "adagrad": dict(learning_rate=0.05, wd=0.001),
    "adadelta": dict(rho=0.9, epsilon=1e-5, wd=0.001),
    "ftrl": dict(learning_rate=0.1, lamda1=0.01, beta=1.0),
    "signum": dict(learning_rate=0.01, momentum=0.9, wd_lh=0.001),
    "dcasgd": dict(learning_rate=0.05, momentum=0.9, lamda=0.04),
    "ftml": dict(learning_rate=0.01, beta1=0.6, beta2=0.999),
    "adamax": dict(learning_rate=0.01, wd=0.001),
    "nadam": dict(learning_rate=0.01),
    "lbsgd": dict(learning_rate=0.05, momentum=0.9, wd=0.001),
}
# the optimizers whose updates go through an op with a multi-precision
# contract (the others compute in the weight's dtype)
MP_OK = ("sgd", "nag", "adam", "adamw", "lamb", "rmsprop", "adagrad",
         "ftml", "signum")


def _arrays(seed, step):
    rs = np.random.RandomState(seed * 100 + step)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def _np(x):
    if isinstance(x, mx.nd.NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x.data if hasattr(x, "data") and not
                                  isinstance(x, np.ndarray) else x,
                                  jnp.float32))


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, tuple):
        return [x for v in s for x in _leaves(v)]
    return [s]


class _Param:
    def __init__(self, lr_mult=1.0, wd_mult=1.0):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult


def _pair(name, kw, mp=False, mult_mode="param_dict", scheduler=None,
          begin=0):
    """The same optimizer in both packages, with multipliers for index 1
    given by ``mult_mode``."""
    kw = dict(kw, multi_precision=mp, begin_num_update=begin)
    out = []
    for pkg, sched_mod in ((jopt, jls), (popt, mx.lr_scheduler)):
        k = dict(kw)
        if scheduler is not None:
            k["lr_scheduler"] = getattr(sched_mod, scheduler[0])(
                **scheduler[1])
        if mult_mode == "param_dict":
            k["param_dict"] = {1: _Param(0.5, 2.0)}
        elif mult_mode == "idx2name":
            k["param_idx2name"] = {0: "w0", 1: "w1", 2: "w2"}
        opt = pkg.create(name, **k)
        if mult_mode == "index":
            opt.set_lr_mult({1: 0.5})
            opt.set_wd_mult({1: 2.0})
        elif mult_mode == "idx2name":
            opt.set_lr_mult({"w1": 0.5})
            opt.set_wd_mult({"w1": 2.0})
        out.append(opt)
    return out


def _run_both(jo, po, steps=5, mp=False, seed=0, compare=True):
    ju, pu = jopt.Updater(jo), popt.Updater(po)
    dts = ["float32", "bfloat16" if mp else "float32", "float32"]
    w0 = _arrays(seed, 0)
    jw = [jmx.nd.array(w, dtype=dt) for w, dt in zip(w0, dts)]
    with mx.cpu():
        pw = [mx.nd.array(w, dtype=dt) for w, dt in zip(w0, dts)]
        for step in range(1, steps + 1):
            gs = _arrays(seed, step)
            for i in range(len(SHAPES)):
                ju(i, jmx.nd.array(gs[i], dtype=dts[i]), jw[i])
                pu(i, mx.nd.array(gs[i], dtype=dts[i]), pw[i])
            if compare:
                for i in range(len(SHAPES)):
                    np.testing.assert_allclose(
                        _np(pw[i]), _np(jw[i]), rtol=RTOL, atol=ATOL,
                        err_msg=f"step {step} weight {i}")
                    for a, b in zip(_leaves(pu.states[i]),
                                    _leaves(ju.states[i])):
                        np.testing.assert_allclose(
                            _np(a), _np(b), rtol=RTOL, atol=ATOL,
                            err_msg=f"step {step} state {i}")
    return ju, pu, jw, pw


@pytest.mark.parametrize("name", sorted(KWARGS))
def test_optimizer_matches_reference(name):
    jo, po = _pair(name, KWARGS[name])
    _run_both(jo, po)
    assert po.num_update == jo.num_update == 5
    assert po._index_update_count == jo._index_update_count


@pytest.mark.parametrize("name", MP_OK)
def test_multi_precision_matches_reference(name):
    jo, po = _pair(name, KWARGS[name], mp=True)
    ju, pu, _, _ = _run_both(jo, po, mp=True)
    w32, _ = pu.states[1]
    assert w32._data.dtype == torch.float32


@pytest.mark.parametrize("mode", ["param_dict", "index", "idx2name"])
@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "ftml"])
def test_multipliers_match_reference(name, mode):
    jo, po = _pair(name, KWARGS[name], mult_mode=mode)
    assert po._get_lr(1) == jo._get_lr(1) != po._get_lr(0)
    assert po._get_wd(1) == jo._get_wd(1)
    _run_both(jo, po)


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb", "nag"])
def test_scheduler_and_begin_num_update_match_reference(name):
    sched = ("CosineScheduler", dict(max_update=12, base_lr=0.05,
                                     final_lr=0.001, warmup_steps=3,
                                     warmup_begin_lr=0.005))
    jo, po = _pair(name, KWARGS[name], scheduler=sched, begin=4)
    _run_both(jo, po)
    assert po.num_update == jo.num_update == 9
    assert po.learning_rate == jo.learning_rate


def test_sgld_deterministic_part_and_noise():
    """With the noise supplied, SGLD equals the reference; its own noise
    is N(0, sqrt(lr)) on the weight's device."""
    rs = np.random.RandomState(5)
    noise = [rs.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
    calls = {"j": 0}

    def jnoise(loc, scale, shape=None, ctx=None, **kw):
        i = calls["j"] % len(SHAPES)
        calls["j"] += 1
        return jmx.nd.array(noise[i])

    class Supplied(popt.SGLD):
        def noise(self, index, weight, lr):
            return torch.from_numpy(noise[index])

    jo = jopt.SGLD(learning_rate=0.02, wd=0.01)
    po = Supplied(learning_rate=0.02, wd=0.01)
    orig = jopt.nd.random.normal
    jopt.nd.random.normal = jnoise
    try:
        _run_both(jo, po)
    finally:
        jopt.nd.random.normal = orig
    lr = 0.04
    sg = popt.SGLD(learning_rate=lr)
    with mx.cpu():
        w = mx.nd.zeros((400, 500))
        mx.random.seed(3)
        sg.update(0, w, mx.nd.zeros((400, 500)), None)
    x = w.asnumpy()
    assert abs(float(x.mean())) < 3e-3
    assert abs(float(x.std()) - np.sqrt(lr)) < 3e-3


# ---------------------------------------------------------------------------
# Updater states across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mp", [("adam", False), ("sgd", True),
                                     ("lamb", True), ("rmsprop", False),
                                     ("dcasgd", False)])
def test_states_cross_load_both_ways(name, mp):
    """Three steps, the states saved by one package and loaded by the
    other, two more steps: equal to five uninterrupted steps, in both
    directions."""
    for src in ("ref", "port"):
        jo, po = _pair(name, KWARGS[name], mp=mp)
        ju, pu, jw, pw = _run_both(jo, po, steps=3, mp=mp, seed=1,
                                   compare=False)
        fresh_j, fresh_p = _pair(name, KWARGS[name], mp=mp)
        if src == "ref":
            blob = ju.get_states()
            with mx.cpu():
                pu2 = popt.Updater(fresh_p)
                pu2.set_states(blob)
            ju2 = ju
        else:
            blob = pu.get_states()
            ju2 = jopt.Updater(fresh_j)
            ju2.set_states(blob)
            pu2 = pu
        assert pu2.optimizer.num_update == ju2.optimizer.num_update == 3
        # two more steps on each side from the crossed states
        dts = ["float32", "bfloat16" if mp else "float32", "float32"]
        with mx.cpu():
            for step in (4, 5):
                gs = _arrays(1, step)
                for i in range(len(SHAPES)):
                    ju2(i, jmx.nd.array(gs[i], dtype=dts[i]), jw[i])
                    pu2(i, mx.nd.array(gs[i], dtype=dts[i]), pw[i])
        jref, pref = _pair(name, KWARGS[name], mp=mp)
        _, _, jw5, pw5 = _run_both(jref, pref, steps=5, mp=mp, seed=1,
                                   compare=False)
        for i in range(len(SHAPES)):
            np.testing.assert_allclose(_np(pw[i]), _np(pw5[i]), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(_np(jw[i]), _np(jw5[i]), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(_np(pw[i]), _np(jw[i]), rtol=RTOL,
                                       atol=ATOL)


def test_port_states_resume_bit_for_bit():
    """Within the port, get_states/set_states resumes bit for bit (bf16
    states travel as f32 arrays and come back exact)."""
    name, kw = "sgd", dict(KWARGS["sgd"])
    po = popt.create(name, **kw)
    with mx.cpu():
        w = mx.nd.array(np.arange(12, dtype=np.float32) / 7,
                        dtype="bfloat16")
        u = popt.Updater(po)
        for s in range(3):
            u(0, mx.nd.array(np.ones(12) * (s + 1), dtype="bfloat16"), w)
        blob = u.get_states()
        u2 = popt.Updater(popt.create(name, **kw))
        u2.set_states(blob)
        assert torch.equal(u2.states[0]._data.to(torch.bfloat16),
                           u.states[0]._data)
        w2 = w.copy()
        u2.states[0] = mx.nd.NDArray(u2.states[0]._data.to(torch.bfloat16))
        g = mx.nd.array(np.ones(12), dtype="bfloat16")
        u(0, g, w)
        u2(0, g, w2)
        assert torch.equal(w._data, w2._data)


def test_reference_bf16_states_load_by_bits():
    """A reference states file with ml_dtypes bf16 arrays (SGD momentum
    of a bf16 weight without multi_precision) loads as bf16 tensors with
    the same bits."""
    jo = jopt.SGD(learning_rate=0.1, momentum=0.9)
    ju = jopt.Updater(jo)
    w = jmx.nd.array(np.linspace(-1, 1, 10), dtype="bfloat16")
    for s in range(2):
        ju(0, jmx.nd.array(np.ones(10) * (s + 0.3), dtype="bfloat16"), w)
    blob = ju.get_states()
    with mx.cpu():
        pu = popt.Updater(popt.SGD(learning_rate=0.1, momentum=0.9))
        pu.set_states(blob)
    got = pu.states[0]._data
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(ju.states[0].data, jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_pickled_reference_optimizer_is_refused():
    jo = jopt.Adam(learning_rate=0.01)
    ju = jopt.Updater(jo)
    w = jmx.nd.array(np.ones(4))
    ju(0, jmx.nd.array(np.ones(4)), w)
    blob = ju.get_states(dump_optimizer=True)
    with mx.cpu():
        pu = popt.Updater(popt.Adam(learning_rate=0.01))
        with pytest.raises(mx.MXNetError, match="refusing to unpickle"):
            pu.set_states(blob)
    # the port's own pickled optimizer loads
    po = popt.Adam(learning_rate=0.03)
    with mx.cpu():
        pu = popt.Updater(po)
        pu(0, mx.nd.array(np.ones(4)), mx.nd.array(np.ones(4)))
        blob = pu.get_states(dump_optimizer=True)
        pu2 = popt.Updater(popt.Adam())
        pu2.set_states(blob)
    assert isinstance(pu2.optimizer, popt.Adam)
    assert pu2.optimizer.lr == 0.03 and pu2.optimizer.num_update == 1


def test_states_reader_imports_neither_jax_nor_the_reference():
    """In a fresh interpreter, reading a reference states file (with a
    pickled reference optimizer, refused, and with bf16 arrays, taken)
    leaves ``jax``, ``mxnet_tpu`` and ``ml_dtypes`` out of
    ``sys.modules``."""
    jo = jopt.SGD(learning_rate=0.1, momentum=0.9)
    ju = jopt.Updater(jo)
    w = jmx.nd.array(np.ones(6), dtype="bfloat16")
    ju(0, jmx.nd.array(np.ones(6), dtype="bfloat16"), w)
    blobs = [ju.get_states(dump_optimizer=True), ju.get_states()]
    code = (
        "import pickle, sys\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch.optimizer import optimizer as popt\n"
        "blobs = pickle.loads(sys.stdin.buffer.read())\n"
        "u = popt.Updater(popt.SGD(momentum=0.9))\n"
        "try:\n"
        "    u.set_states(blobs[0])\n"
        "    print('LOADED')\n"
        "except mx.MXNetError:\n"
        "    print('REFUSED')\n"
        "with mx.cpu():\n"
        "    u.set_states(blobs[1])\n"
        "print(u.states[0]._data.dtype)\n"
        "print(sorted(m for m in ('jax', 'mxnet_tpu', 'ml_dtypes') "
        "if m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code],
                         input=pickle.dumps(blobs), capture_output=True,
                         env=env, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr.decode()
    lines = out.stdout.decode().split()
    assert lines[0] == "REFUSED"
    assert lines[1] == "torch.bfloat16"
    assert lines[2] == "[]"


def test_create_and_registry():
    assert sorted(popt._REGISTRY) == sorted(jopt._REGISTRY)
    assert len(popt._REGISTRY) == 16
    with pytest.raises(mx.MXNetError, match="unknown optimizer"):
        mx.optimizer.create("nosuch")

    @popt.register
    class MyOpt(popt.SGD):
        pass

    try:
        assert isinstance(mx.optimizer.create("myopt"), MyOpt)
        assert isinstance(mx.optimizer.get_updater(MyOpt()),
                          popt.Updater)
    finally:
        del popt._REGISTRY["myopt"]
