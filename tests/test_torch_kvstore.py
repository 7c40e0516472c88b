"""The port's kvstore, 2-bit compression and multi-context Trainer held
against the JAX package on the CPU (``mxnet_tpu.kvstore``,
``mxnet_tpu.gluon.Trainer`` on ``cpu(0)``/``cpu(1)``).

The same numpy inputs go through both packages:

* ``plan_buckets`` and ``plan_pushpull`` give the reference's buckets
  (mixed dtypes, a key over the cap, priorities), bit for bit;
* push, pull and the bucketed ``pushpull`` of ``local``/``device``/
  ``tpu_sync``/``nccl`` stores: bit for bit with 2 copies (one add, one
  rounding in both); with 3 and 4 copies the port's per-key and
  bucketed exchanges agree bit for bit, and the port is within one
  rounding per add of the reference (which may sum in f32 before
  rounding a bf16 result): ``|d| <= (copies - 1) * ulp`` of the largest
  magnitude, in the values' dtype;
* the 2-bit quantizer's plain version against the reference's ``_q``,
  bit for bit (NaN positions equal), on seeded values and the edge
  values t, t +- 1 ulp, +-0, NaN, +-inf, in bf16/f16/f32 over 5 steps;
  an int32 gradient raises in both; residual states cross-load;
* a transient fault at ``kvstore.push``/``kvstore.pull`` is retried and
  changes nothing; a server-side optimizer's states cross-load;
* a 2-context ``Trainer`` for 3 steps, kvstore ``device``/``local``/
  ``nccl``/``tpu_sync``/``dist_sync``/``dist_device_sync`` (one process),
  ``update_on_kvstore`` True/False, overlap on/off, compression: the
  weights of both contexts bit for bit with the reference's. The model
  is elementwise (``x * w``, 2 rows per context) and SGD runs at
  power-of-two lr, momentum, wd and rescale, so no sum of more than
  two terms and no contractible product arises: the frameworks compute
  the same rounding of every operation.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kvstore as jkv
from mxnet_tpu.kvstore import bucketing as jb
from mxnet_tpu.kvstore import gradient_compression as jgc

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kvstore as pkv
from mxnet_tpu_torch.kernels import twobit_quantize_reference
from mxnet_tpu_torch.kvstore import bucketing as pb
from mxnet_tpu_torch.kvstore import gradient_compression as pgc

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "float16": torch.float16}


def _np(x):
    """An NDArray of either package (or a tensor / jax array) as numpy in
    its own dtype (bf16 as float32, exactly)."""
    if isinstance(x, mx.nd.NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if hasattr(x, "data") and not isinstance(x, np.ndarray):
        x = x.data
    a = jnp.asarray(x)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _same_bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(a)
    np.testing.assert_array_equal(a[ok].view(np.uint8 if a.dtype.itemsize
                                               == 1 else f"u{a.dtype.itemsize}"),
                                  b[ok].view(f"u{b.dtype.itemsize}"),
                                  err_msg=what)


@pytest.fixture
def bucket_mb(monkeypatch):
    def set_(mb):
        monkeypatch.setenv("MXNET_KV_BUCKET_MB", str(mb))
    return set_


# ---------------------------------------------------------------------------
# the bucket plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(300,), (50, 50), (10,), (3000,), (7, 3), (40,), (2, 2, 5),
               (1,), (600,), (33,)]
PLAN_DTYPES = ["float32", "bfloat16", "float32", "float32", "bfloat16",
               "float16", "float32", "bfloat16", "float32", "float16"]


@pytest.mark.parametrize("partition,world", [(None, 1), ("zero1", 3),
                                             ("zero2", 4)])
@pytest.mark.parametrize("cap", [0, 2048, 4096, 1 << 20])
def test_plan_buckets_match_the_reference(partition, world, cap):
    """Mixed dtypes, a (3000,) f32 key over the 4 KiB cap, and the given
    order: the same members, shapes, bytes and shard plans."""
    def entries(tdt):
        out = []
        for i, (s, dt) in enumerate(zip(PLAN_SHAPES, PLAN_DTYPES)):
            n = int(np.prod(s)) * np.dtype(
                "float32" if dt == "bfloat16" else dt).itemsize // (
                    2 if dt == "bfloat16" else 1)
            out.append((i, s, tdt(dt), (str(tdt(dt)), 1, "d0"), n))
        return out

    want = jb.plan_buckets(entries(lambda d: d), cap, partition, world)
    got = pb.plan_buckets(entries(lambda d: _TDT[d]), cap, partition, world)
    assert [(b.indices, b.shapes, b.nbytes, b.shard_plan) for b in got] == \
        [(b.indices, b.shapes, b.nbytes, b.shard_plan) for b in want]
    assert pb.bucket_cap_bytes() == jb.bucket_cap_bytes()
    for b in got:
        if cap and len(b) > 1:
            assert b.nbytes <= cap


def _copies(rs, shape, dtype, n):
    return [(rs.randn(*shape) * 3).astype(np.float32) for _ in range(n)]


def _jnd(a, dtype, ctx):
    return jmx.nd.array(a, ctx=ctx).astype(dtype)


def _pnd(a, dtype, ctx):
    return mx.nd.array(a, ctx=ctx).astype(dtype)


def test_plan_pushpull_groups_match_the_reference():
    rs = np.random.RandomState(3)
    keys = list(range(len(PLAN_SHAPES)))
    prio = list(rs.permutation(len(keys)) - 5)
    jvals, pvals = [], []
    for s, dt in zip(PLAN_SHAPES, PLAN_DTYPES):
        cs = _copies(rs, s, dt, 2)
        jvals.append([_jnd(c, dt, jmx.cpu(i)) for i, c in enumerate(cs)])
        pvals.append([_pnd(c, dt, mx.cpu(i)) for i, c in enumerate(cs)])
    for cap in (0, 4096, 1 << 20):
        js, ps = jkv.create("device"), pkv.create("device")
        js._bucket_bytes = ps._bucket_bytes = cap
        assert ps.plan_pushpull(keys, pvals, prio) == \
            js.plan_pushpull(keys, jvals, prio)


# ---------------------------------------------------------------------------
# push / pull / pushpull
# ---------------------------------------------------------------------------

STORE_SHAPES = [(5, 7), (33,), (2, 3, 4), (129,), (1,), (64, 3)]
STORE_DTYPES = ["float32", "bfloat16", "float32", "float32", "bfloat16",
                "float32"]


def _exchange(pkg, store_type, ncopies, mode, bucket_cap, seed=0):
    """Init, then one exchange of every key: ``mode`` "push_pull" (per
    key), or "pushpull" (the batched entry); returns the pulled outs and
    the store entries, as numpy."""
    rs = np.random.RandomState(seed)
    nd, cpu = (_jnd, jmx.cpu) if pkg == "jax" else (_pnd, mx.cpu)
    store = (jkv if pkg == "jax" else pkv).create(store_type)
    store._bucket_bytes = bucket_cap
    keys = list(range(len(STORE_SHAPES)))
    vals, outs = [], []
    for k, (s, dt) in enumerate(zip(STORE_SHAPES, STORE_DTYPES)):
        cs = _copies(rs, s, dt, ncopies)
        store.init(k, nd(np.zeros(s, np.float32), dt, cpu(0)))
        vals.append([nd(c, dt, cpu(i)) for i, c in enumerate(cs)])
        outs.append([nd(np.zeros(s, np.float32), dt, cpu(i))
                     for i in range(ncopies)])
    if mode == "push_pull":
        for k in keys:
            store.push(k, vals[k])
            store.pull(k, outs[k])
    else:
        store.pushpull(keys, vals, out=outs, priority=[-k for k in keys])
    return ([[_np(o) for o in os_] for os_ in outs],
            [_np(store._store[k]) for k in keys])


@pytest.mark.parametrize("store_type", ["local", "device", "tpu_sync", "nccl"])
@pytest.mark.parametrize("mode,cap", [("push_pull", 1 << 20),
                                      ("pushpull", 1 << 20),
                                      ("pushpull", 256), ("pushpull", 0)])
def test_two_copies_bit_for_bit_with_the_reference(store_type, mode, cap):
    got = _exchange("port", store_type, 2, mode, cap)
    want = _exchange("jax", store_type, 2, mode, cap)
    for k, (go, wo) in enumerate(zip(got[0], want[0])):
        for a, b in zip(go, wo):
            _same_bits(a, b, f"out {k}")
    for k, (a, b) in enumerate(zip(got[1], want[1])):
        _same_bits(a, b, f"store {k}")


@pytest.mark.parametrize("ncopies", [3, 4])
@pytest.mark.parametrize("store_type", ["device", "tpu_sync"])
def test_more_copies_per_key_equals_bucketed_and_near_the_reference(
        store_type, ncopies):
    per_key = _exchange("port", store_type, ncopies, "push_pull", 1 << 20)
    for cap in (1 << 20, 256, 0):
        bucketed = _exchange("port", store_type, ncopies, "pushpull", cap)
        for go, wo in zip(bucketed[0], per_key[0]):
            for a, b in zip(go, wo):
                _same_bits(a, b, f"cap {cap}")
    want = _exchange("jax", store_type, ncopies, "pushpull", 1 << 20)
    for k, (go, wo) in enumerate(zip(per_key[0], want[0])):
        ulp = 2.0 ** -8 if STORE_DTYPES[k] == "bfloat16" else 2.0 ** -24
        for a, b in zip(go, wo):
            tol = (ncopies - 1) * ulp * float(np.abs(b).max()) * 2
            assert float(np.abs(a - b).max()) <= tol, (k, ncopies)


def test_pushed_value_is_snapshotted_and_updater_on_the_store():
    """A pushed array written afterwards does not change the store; a
    server-side optimizer steps the stored value (per key) as the
    reference's does."""
    for pkg, kvm, nd in (("port", pkv, _pnd), ("jax", jkv, _jnd)):
        cpu = mx.cpu if pkg == "port" else jmx.cpu
        store = kvm.create("tpu_sync")
        store.init(1, nd(np.zeros(3, np.float32), "float32", cpu(0)))
        g = nd(np.ones(3, np.float32), "float32", cpu(0))
        store.push(1, g)
        g += 41
        out = nd(np.zeros(3, np.float32), "float32", cpu(0))
        store.pull(1, out)
        np.testing.assert_array_equal(_np(out), np.ones(3, np.float32))
    outs = []
    for pkg, kvm, nd, o in (("port", pkv, _pnd, mx.optimizer),
                            ("jax", jkv, _jnd, jmx.optimizer)):
        cpu = mx.cpu if pkg == "port" else jmx.cpu
        store = kvm.create("local")
        store.set_optimizer(o.create("sgd", learning_rate=0.25,
                                     momentum=0.5))
        store.init("w", nd(np.full(4, 2.0, np.float32), "float32", cpu(0)))
        for _ in range(3):
            store.push("w", [nd(np.arange(4, dtype=np.float32), "float32",
                                cpu(i)) for i in range(2)])
        assert "w" in store._updater.states
        out = nd(np.zeros(4, np.float32), "float32", cpu(0))
        store.pull("w", out)
        outs.append(_np(out))
    _same_bits(outs[0], outs[1], "server-side sgd")


# ---------------------------------------------------------------------------
# 2-bit compression
# ---------------------------------------------------------------------------

T = 0.5


def _edges(dtype):
    t = np.array(T, dtype=np.float32)
    if dtype == "bfloat16":
        up, down = np.float32(0.50390625), np.float32(0.498046875)
    else:
        dt = np.dtype(dtype)
        up = np.nextafter(t.astype(dt), dt.type(np.inf)).astype(np.float32)
        down = np.nextafter(t.astype(dt), dt.type(0)).astype(np.float32)
    return np.array([T, -T, up, down, -up, -down, 0.0, -0.0, np.nan,
                     np.inf, -np.inf], np.float32)


def _grads(rs, dtype, n=257):
    g = (rs.randn(n) * 0.6).astype(np.float32)
    e = _edges(dtype)
    g[:len(e)] = e
    return g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_twobit_plain_version_bit_for_bit_with_the_reference_q(dtype):
    rs = np.random.RandomState(5)
    q_ref = jgc.GradientCompression(T)._q
    jr = jnp.zeros(257, jnp.float32)
    pr = torch.zeros(257)
    for step in range(5):
        g = _grads(rs, dtype)
        jq, jr = q_ref(jnp.asarray(g).astype(dtype), jr)
        pq = twobit_quantize_reference(torch.from_numpy(g).to(_TDT[dtype]),
                                       pr, T)
        assert pq.dtype == _TDT[dtype]
        _same_bits(_np(pq), _np(jq), f"q step {step}")
        _same_bits(_np(pr), _np(jr), f"r step {step}")


def test_twobit_edge_values():
    g = torch.tensor([0.5, 0.49, -0.5, float("nan"), float("inf"),
                      float("-inf"), -0.0])
    r = torch.zeros(7)
    q = twobit_quantize_reference(g, r, 0.5)
    assert q[:3].tolist() == [0.5, 0.0, -0.5] and q[3] == 0
    assert q[4] == 0.5 and q[5] == -0.5 and not torch.signbit(q[6])
    assert torch.isnan(r[3]) and r[4] == float("inf") \
        and r[5] == float("-inf")
    # bf16: q carries t rounded to bf16, the residual the unrounded f32 t
    t = 0.3
    q = twobit_quantize_reference(torch.tensor([1.0], dtype=torch.bfloat16),
                                  r[:1].zero_(), t)
    assert q.item() == float(torch.tensor(t, dtype=torch.bfloat16))
    assert r[0].item() == float(np.float32(1.0) - np.float32(t))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_integer_gradient_raises(pkg):
    if pkg == "port":
        comp = pgc.GradientCompression(0.5)
        g = mx.nd.array(np.arange(4, dtype=np.int32), ctx=mx.cpu(),
                        dtype="int32")
        with pytest.raises(mx.MXNetError, match="float gradients"):
            comp.compress("k", 0, g)
        with pytest.raises(mx.MXNetError, match="float gradients"):
            comp.compress_flat((1, 2), 0, torch.arange(4, dtype=torch.int32))
    else:
        comp = jgc.GradientCompression(0.5)
        with pytest.raises(jmx.base.MXNetError, match="float gradients"):
            comp.compress("k", 0, jmx.nd.array(np.arange(4), dtype="int32"))
    with pytest.raises(Exception, match="type"):
        (pgc if pkg == "port" else jgc).create_compression({"type": "1bit"})


def _comp_steps(comp, pkg, grads, key="w"):
    outs = []
    for g in grads:
        if pkg == "port":
            outs.append(_np(comp.compress(key, 0, mx.nd.array(g, ctx=mx.cpu()))))
        else:
            outs.append(_np(comp.compress(key, 0, jmx.nd.array(g))))
    return outs


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_residual_states_cross_load(direction):
    rs = np.random.RandomState(9)
    grads = [_grads(rs, "float32") for _ in range(5)]
    full = {"port": pgc.GradientCompression(T),
            "jax": jgc.GradientCompression(T)}
    want = _comp_steps(full["port"], "port", grads)
    _same_bits(np.stack(want), np.stack(_comp_steps(full["jax"], "jax",
                                                    grads)), "5 steps")
    src, dst = direction.split("_to_")
    first = {"port": pgc.GradientCompression(T),
             "jax": jgc.GradientCompression(T)}[src]
    _comp_steps(first, src, grads[:2])
    second = {"port": pgc.GradientCompression(T),
              "jax": jgc.GradientCompression(T)}[dst]
    second.set_state(first.get_state())
    _same_bits(np.stack(_comp_steps(second, dst, grads[2:])),
               np.stack(want[2:]), "resumed")
    with pytest.raises(Exception, match="threshold"):
        {"port": pgc, "jax": jgc}[dst].GradientCompression(0.25).set_state(
            first.get_state())


# ---------------------------------------------------------------------------
# the 2-context Trainer
# ---------------------------------------------------------------------------

FEAT = 8
SGD = {"learning_rate": 0.25, "momentum": 0.5, "wd": 2.0 ** -7}


def _scale_block(pkg):
    """``x * w1 * w2``: elementwise, so both frameworks round every
    operation the same way."""
    base = jgluon.HybridBlock if pkg == "jax" else mx.gluon.HybridBlock

    class Scale(base):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.w1 = self.params.get("w1", shape=(FEAT,))
                self.w2 = self.params.get("w2", shape=(FEAT,))

        def hybrid_forward(self, F, x, w1, w2):
            return F.broadcast_mul(F.broadcast_mul(x, w1), w2)

    return Scale(prefix="scale_")


def _run_trainer(pkg, kvstore, steps=3, **kw):
    gl, ag, ctx = (jgluon, jag, jmx.cpu) if pkg == "jax" else \
        (mx.gluon, mx.autograd, mx.cpu)
    ctxs = [ctx(0), ctx(1)]
    net = _scale_block(pkg)
    net.initialize(ctx=ctxs)
    rs = np.random.RandomState(4)
    for p in net.collect_params().values():
        p.set_data((jmx if pkg == "jax" else mx).nd.array(
            rs.randn(FEAT).astype(np.float32), ctx=ctxs[0]))
    tr = gl.Trainer(net.collect_params(), "sgd", dict(SGD),
                    kvstore=kvstore, **kw)
    loss = gl.loss.L2Loss()
    rs2 = np.random.RandomState(6)
    for _ in range(steps):
        x = rs2.randn(4, FEAT).astype(np.float32)
        y = rs2.randn(4, FEAT).astype(np.float32)
        xs = gl.utils.split_and_load(x, ctxs)
        ys = gl.utils.split_and_load(y, ctxs)
        with ag.record():
            ls = [loss(net(a), b) for a, b in zip(xs, ys)]
        ag.backward(ls)
        tr.step(8)
    ws = [[_np(d) for d in p.list_data()]
          for p in net.collect_params().values()]
    return ws, tr


TRAINER_CASES = [
    ("device", {}), ("device", {"update_on_kvstore": True}), ("local", {}),
    ("dist_sync", {}), ("dist_device_sync", {"update_on_kvstore": False}),
    ("nccl", {}), ("nccl", {"update_on_kvstore": False}),
    ("tpu_sync", {}),
    ("device", {"overlap_comms": True}),
    ("tpu_sync", {"overlap_comms": True}),
    ("device", {"compression_params": {"type": "2bit", "threshold": 0.05}}),
    ("tpu_sync", {"compression_params": {"type": "2bit", "threshold": 0.05},
                  "overlap_comms": True}),
]


@pytest.mark.parametrize("kvstore,kw", TRAINER_CASES)
def test_two_context_trainer_bit_for_bit_with_the_reference(kvstore, kw):
    got, tr = _run_trainer("port", kvstore, **kw)
    want, jtr = _run_trainer("jax", kvstore, **kw)
    for pw, jw in zip(got, want):
        _same_bits(pw[0], pw[1], "the two contexts")
        for a, b in zip(pw, jw):
            _same_bits(a, b, f"{kvstore} {kw}")
    assert tr._update_on_kvstore == jtr._update_on_kvstore
    if kw.get("overlap_comms") and not tr._update_on_kvstore:
        assert tr.last_overlap_stats == jtr.last_overlap_stats
        assert tr.last_overlap_stats["dispatched_in_backward"] >= 1


@pytest.mark.parametrize("bucket", [0, 25])
def test_bucketed_per_key_and_overlap_agree_in_the_port(bucket, bucket_mb):
    bucket_mb(bucket)
    base, _ = _run_trainer("port", "device")
    for kw in ({"overlap_comms": True}, {"partition": "zero1"},
               {"partition": "zero2"}):
        store = "tpu_sync" if "partition" in kw else "device"
        got, _ = _run_trainer("port", store, **kw)
        for pw, bw in zip(got, base):
            for a, b in zip(pw, bw):
                _same_bits(a, b, str(kw))


def test_trainer_compression_states_cross_load(tmp_path):
    """A compressing 2-context trainer saved by one package resumes in the
    other, residuals included, bit for bit."""
    comp = {"compression_params": {"type": "2bit", "threshold": 0.05}}
    for src, dst in (("port", "jax"), ("jax", "port")):
        _, tr = _run_trainer(src, "device", steps=2, **comp)
        f = str(tmp_path / f"{src}.states")
        tr.save_states(f)
        _, tr2 = _run_trainer(dst, "device", steps=0, **comp)
        tr2.load_states(f)
        c1 = tr._kvstore._compression.get_state()["residual"]
        c2 = tr2._kvstore._compression.get_state()["residual"]
        assert sorted(map(str, c1)) == sorted(map(str, c2))
        for k in c1:
            _same_bits(np.asarray(c1[k]), np.asarray(c2[k]), str(k))


def test_weights_cross_through_params_files(tmp_path):
    """A multi-context port model saves a ``.params`` file the reference
    loads onto its contexts, and back."""
    _, _ = _run_trainer("port", "device", steps=1)
    net = _scale_block("port")
    net.initialize(ctx=[mx.cpu(0), mx.cpu(1)])
    rs = np.random.RandomState(2)
    for p in net.collect_params().values():
        p.set_data(rs.randn(FEAT).astype(np.float32))
    f = str(tmp_path / "m.params")
    net.save_parameters(f)
    jnet = _scale_block("jax")
    jnet.initialize(ctx=[jmx.cpu(0), jmx.cpu(1)])
    jnet.load_parameters(f, ctx=[jmx.cpu(0), jmx.cpu(1)])
    for p, q in zip(net.collect_params().values(),
                    jnet.collect_params().values()):
        for a, b in zip(p.list_data(), q.list_data()):
            _same_bits(_np(a), _np(b))
    jnet.save_parameters(str(tmp_path / "j.params"))
    net2 = _scale_block("port")
    net2.initialize(ctx=[mx.cpu(0), mx.cpu(1)])
    net2.load_parameters(str(tmp_path / "j.params"))
    for p, q in zip(net.collect_params().values(),
                    net2.collect_params().values()):
        for a, b in zip(p.list_data(), q.list_data()):
            _same_bits(_np(a), _np(b))


def test_multi_context_parameter_api():
    p = mx.gluon.Parameter("w", shape=(3,))
    ctxs = [mx.cpu(0), mx.cpu(1)]
    p.initialize(mx.init.One(), ctx=ctxs)
    assert p.list_ctx() == ctxs
    assert [d.context for d in p.list_data()] == ctxs
    assert [g.context for g in p.list_grad()] == ctxs
    assert p.data(mx.cpu(1))._data is p.list_data()[1]._data
    with pytest.raises(mx.MXNetError, match="not initialized on context"):
        p.data(mx.cpu(2))
    p.set_data(np.array([1.0, 2.0, 3.0], np.float32))
    for d in p.list_data():
        np.testing.assert_array_equal(d.asnumpy(), [1, 2, 3])
    p.reset_ctx([mx.cpu(0), mx.cpu(1), mx.cpu(2)])
    assert len(p.list_data()) == 3
    pd = mx.gluon.ParameterDict("x_")
    pd.get("a", shape=(2,))
    pd.initialize(ctx=ctxs)
    pd.reset_ctx(mx.cpu(3))
    assert pd["x_a"].list_ctx() == [mx.cpu(3)]
    parts = mx.gluon.utils.split_and_load(np.arange(8, dtype=np.float32),
                                          ctxs)
    assert [s.context for s in parts] == ctxs
    tr = mx.gluon.Trainer([p], "sgd", kvstore="device")
    q = mx.gluon.Parameter("q", shape=(3,))
    q.initialize(ctx=ctxs)
    tr2 = mx.gluon.Trainer([p, q], "sgd")
    with pytest.raises(mx.MXNetError, match="same set of contexts"):
        tr2.step(1)
    assert tr._updater is tr._updaters[0]


def test_multi_context_forward_takes_each_inputs_copy_and_refuses_a_guess():
    """Parameters on cpu(0) and cpu(1): each NDArray slice runs on its own
    context's copy and writes that copy's gradient. A torch tensor, which
    names only the host, and an NDArray on a third context raise instead
    of running on copy 0 (whose use would leave cpu(1)'s gradient buffer
    stale for the exchange); a one-context block beside them takes a
    torch tensor as before."""
    net = _scale_block("port")
    ctxs = [mx.cpu(0), mx.cpu(1)]
    net.initialize(mx.init.One(), ctx=ctxs)
    x = np.ones((2, FEAT), np.float32)
    parts = mx.gluon.utils.split_and_load(np.concatenate([x, 3 * x]), ctxs)
    with mx.autograd.record():
        ys = [net(p).sum() for p in parts]
    mx.autograd.backward(ys)
    for p in net.collect_params().values():
        g0, g1 = [g.asnumpy() for g in p.list_grad()]
        np.testing.assert_array_equal(g0, np.full(FEAT, 2.0, np.float32))
        np.testing.assert_array_equal(g1, np.full(FEAT, 6.0, np.float32))
    with pytest.raises(mx.MXNetError, match="does not say which"):
        net(torch.from_numpy(x))
    with pytest.raises(mx.MXNetError,
                       match=r"not initialized on context cpu\(2\)"):
        net(mx.nd.array(x, ctx=mx.cpu(2)))
    single = _scale_block("port")
    single.initialize(mx.init.One(), ctx=mx.cpu())
    np.testing.assert_array_equal(
        single(torch.from_numpy(x)).detach().numpy(), x)


def test_watch_grad_ready_fires_inside_backward():
    """Each watched parameter's callback sees its gradient already
    written, before ``backward`` returns; a dead owner is pruned and
    ``grad()`` fires nothing."""
    net = _scale_block("port")
    net.initialize(ctx=mx.cpu())
    seen = []

    class Owner:
        def cb(self, arr):
            seen.append((arr is w1, float(arr.grad.asnumpy().sum())
                         if arr.grad is not None else None))

    w1 = net.w1.data()
    owner = Owner()
    mx.autograd.watch_grad_ready([w1, net.w2.data()], owner.cb)
    x = mx.nd.array(np.ones((2, FEAT), np.float32), ctx=mx.cpu())
    with mx.autograd.record():
        y = net(x).sum()
    mx.autograd.backward(y)
    assert len(seen) == 2 and any(s[0] for s in seen)
    seen.clear()
    x.attach_grad()
    with mx.autograd.record():
        y = net(x).sum()
    mx.autograd.grad(y, [x], create_graph=True)
    assert seen == []                   # grad() writes no buffer
    del owner
    with mx.autograd.record():
        y = net(x).sum()
    mx.autograd.backward(y)
    assert seen == []
    mx.autograd.unwatch_grad_ready([w1])


# ---------------------------------------------------------------------------
# fault sites and optimizer states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["kvstore.push", "kvstore.pull"])
def test_injected_fault_is_retried_and_changes_nothing(site):
    """A transient fault at the kvstore's push or pull sites (the
    reference's) is retried; the exchange's result is the clean one."""
    from mxnet_tpu_torch import fault

    want = _exchange("port", "device", 2, "pushpull", 1 << 20)
    with fault.inject(f"{site}=once"):
        got = _exchange("port", "device", 2, "pushpull", 1 << 20)
        assert fault.stats()[site]["injected"] == 1
    for go, wo in zip(got[0], want[0]):
        for a, b in zip(go, wo):
            _same_bits(a, b, site)


def test_server_side_optimizer_states_save_and_cross_load(tmp_path):
    """``save_optimizer_states``/``load_optimizer_states`` of a store with
    a server-side optimizer: the port's file loads into the reference's
    store and back, the momentum unchanged."""
    def run(kvm, nd, cpu, o, pushes):
        store = kvm.create("local")
        store.set_optimizer(o.create("sgd", learning_rate=0.25,
                                     momentum=0.5))
        store.init(3, nd(np.full(4, 2.0, np.float32), "float32", cpu(0)))
        for _ in range(pushes):
            store.push(3, nd(np.arange(4, dtype=np.float32), "float32",
                             cpu(0)))
        return store

    port = run(pkv, _pnd, mx.cpu, mx.optimizer, 2)
    f = str(tmp_path / "port.states")
    port.save_optimizer_states(f)
    ref = run(jkv, _jnd, jmx.cpu, jmx.optimizer, 0)
    ref.load_optimizer_states(f)
    _same_bits(_np(ref._updater.states[3]), _np(port._updater.states[3]))
    g = str(tmp_path / "ref.states")
    ref.save_optimizer_states(g)
    back = run(pkv, _pnd, mx.cpu, mx.optimizer, 0)
    back.load_optimizer_states(g)
    _same_bits(_np(back._updater.states[3]), _np(port._updater.states[3]))
    with pytest.raises(mx.MXNetError, match="no optimizer"):
        pkv.create("local").save_optimizer_states(f)
