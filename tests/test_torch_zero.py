"""The port's ZeRO-sharded optimizer state (``mxnet_tpu_torch/optimizer/
zero.py``) on the CPU, mirroring ``tests/test_zero.py``, and held
against the JAX package's ``ZeroEngine`` where the two meet: the
partition plan and manifest, and the sharded state files.

* zero1 and zero2 training is bit-identical to the replicated fused path
  (losses and weights) for SGD with momentum and Adam, on 1, 2 and 3
  contexts, and the replicated copies stay identical to each other;
* each rank holds at most ``1/world`` (plus its padding) of the state;
* LAMB warns and trains replicated; multi-precision members fall back;
* the identity from ``MXNET_ZERO_WORLD``/``MXNET_ZERO_RANK``, the
  partition from ``MXNET_ZERO_PARTITION``; ``update_on_kvstore`` is
  refused; a ``CheckpointManager`` bundle carries the partition manifest;
* strict save/load round trips bit for bit; mismatched plans and a
  missing source rank raise ``PartitionMismatchError``;
* virtual-mode state saved at world 4 re-shards into world 3, 5 and 1
  bit for bit;
* across packages: the same model gives the same partition manifest; a
  bundle's ``zero.json`` written by either package is read by the other;
  per-rank state files written by either are re-sharded by the other
  with every state value unchanged (bit for bit).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.checkpoint import CheckpointManager as JCheckpointManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.optimizer import zero as zero_mod

SGD_MOM = ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01})
ADAM = ("adam", {"learning_rate": 0.01})


def make_model(seed, nctx, opt_name, opt_kw, partition=None,
               kvstore="tpu_sync", pkg="port", **tkw):
    """The reference test's two-layer net, weights seeded by structural
    name, in either package."""
    m, gl = (mx, gluon) if pkg == "port" else (jmx, jgluon)
    ctxs = [m.cpu(i) for i in range(nctx)]
    net = gl.nn.HybridSequential()
    net.add(gl.nn.Dense(37, in_units=13))
    net.add(gl.nn.Dense(5, in_units=37))
    net.initialize(ctx=ctxs)
    rs = np.random.RandomState(seed)
    for _, p in sorted(net._collect_params_with_prefix().items()):
        p.set_data(m.nd.array(rs.uniform(-1, 1, p.shape).astype(np.float32),
                              ctx=ctxs[0]))
    tr = gl.Trainer(net.collect_params(), opt_name, dict(opt_kw),
                    kvstore=kvstore, partition=partition, **tkw)
    return net, tr, ctxs


def _batch(step, data_seed):
    rs = np.random.RandomState(data_seed * 1000 + step)
    return (rs.uniform(-1, 1, (6, 13)).astype(np.float32),
            rs.uniform(-1, 1, (6, 5)).astype(np.float32))


def train_step(net, tr, ctxs, step, data_seed):
    xh, yh = _batch(step, data_seed)
    per = 6 // len(ctxs)
    loss_fn = gluon.loss.L2Loss()
    xs = [mx.nd.array(xh[i * per:(i + 1) * per], ctx=c)
          for i, c in enumerate(ctxs)]
    ys = [mx.nd.array(yh[i * per:(i + 1) * per], ctx=c)
          for i, c in enumerate(ctxs)]
    with autograd.record():
        ls = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
    autograd.backward(ls)
    tr.step(6)
    return [float(l.sum().asnumpy()) for l in ls]


def train(net, tr, ctxs, steps, data_seed=11, start=0):
    return [train_step(net, tr, ctxs, s, data_seed)
            for s in range(start, start + steps)]


def weights_of(net, ctx):
    return {k: p.data(ctx).asnumpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


def assert_same(tag, la, lb, wa, wb):
    assert la == lb, f"{tag}: losses diverge {la} vs {lb}"
    for k in wa:
        assert np.array_equal(wa[k], wb[k]), f"{tag}: weight {k} differs"


@pytest.mark.parametrize("opt", [SGD_MOM, ADAM], ids=["sgd_mom", "adam"])
@pytest.mark.parametrize("nctx", [1, 2, 3])
@pytest.mark.parametrize("mode", ["zero1", "zero2"])
def test_sharded_matches_replicated(opt, nctx, mode):
    kv = "tpu_sync" if nctx > 1 else "device"
    net0, tr0, c0 = make_model(3, nctx, *opt, kvstore=kv)
    net1, tr1, c1 = make_model(3, nctx, *opt, partition=mode, kvstore=kv)
    l0 = train(net0, tr0, c0, 4)
    l1 = train(net1, tr1, c1, 4)
    assert tr1.partition == mode and tr1._zero.world == max(1, nctx)
    for c in range(nctx):
        assert_same(f"{mode} x{nctx}", l0, l1, weights_of(net0, c0[c]),
                    weights_of(net1, c1[c]))
    if mode == "zero1":
        # the reduced gradient is written back, as the replicated path has it
        for p0, p1 in zip(net0.collect_params().values(),
                          net1.collect_params().values()):
            for g0, g1 in zip(p0.list_grad(), p1.list_grad()):
                assert np.array_equal(g0.asnumpy(), g1.asnumpy())


def test_replicated_adam_device_copies_stay_identical():
    net, tr, ctxs = make_model(3, 3, *ADAM)
    train(net, tr, ctxs, 3)
    w = [weights_of(net, c) for c in ctxs]
    for other in w[1:]:
        for k in w[0]:
            assert np.array_equal(w[0][k], other[k])


def test_state_bytes_at_most_one_world_th():
    telemetry.enable()
    try:
        net, tr, ctxs = make_model(3, 3, *ADAM, partition="zero1")
        tr._init_kvstore()
        per_rank, replicated = tr._zero._state_bytes
        nb = len(tr._zero._buckets)
        assert per_rank <= replicated / 3 + 2 * 4 * 3 * nb
        text = telemetry.prom_text()
        assert 'mxnet_optimizer_state_bytes{mode="zero1"}' in text
    finally:
        telemetry.disable()
        telemetry.reset()


def test_lamb_warns_and_trains_replicated():
    opt = ("lamb", {"learning_rate": 0.01})
    net0, tr0, c0 = make_model(3, 2, *opt)
    with pytest.warns(UserWarning, match="ignored"):
        net1, tr1, c1 = make_model(3, 2, *opt, partition="zero1")
        tr1._init_kvstore()
    assert tr1.partition is None
    assert_same("lamb", train(net0, tr0, c0, 2), train(net1, tr1, c1, 2),
                weights_of(net0, c0[0]), weights_of(net1, c1[0]))


def test_multi_precision_members_fall_back():
    net, tr, ctxs = make_model(3, 2, "adam", {"learning_rate": 0.01,
                                              "multi_precision": True},
                               partition="zero1")
    p0 = list(net.collect_params().values())[0]
    p0.cast("bfloat16")
    with pytest.warns(UserWarning, match="fell outside"):
        tr._init_kvstore()
    assert tr._zero.fallback_reasons == {0: "zero_multi_precision"}
    net0, tr0, c0 = make_model(3, 2, "adam", {"learning_rate": 0.01,
                                              "multi_precision": True})
    list(net0.collect_params().values())[0].cast("bfloat16")
    assert_same("mp fallback", train(net0, tr0, c0, 2),
                train(net, tr, ctxs, 2), weights_of(net0, c0[1]),
                weights_of(net, ctxs[1]))


def test_env_identity_and_manifest(monkeypatch):
    monkeypatch.setenv("MXNET_ZERO_WORLD", "4")
    monkeypatch.setenv("MXNET_ZERO_RANK", "2")
    net, tr, _ = make_model(3, 1, *ADAM, partition="zero1",
                            kvstore="device")
    tr._init_kvstore()
    assert tr._zero.world == 4 and tr._zero.rank == 2
    man = tr.partition_manifest()
    assert man["mode"] == "zero1" and man["world"] == 4 and man["rank"] == 2


def test_partition_env_engages_engine(monkeypatch):
    monkeypatch.setenv("MXNET_ZERO_PARTITION", "zero2")
    net, tr, _ = make_model(3, 2, *SGD_MOM)
    tr._init_kvstore()
    assert tr.partition == "zero2"


def test_update_on_kvstore_conflicts_and_bad_modes():
    net, tr, _ = make_model(3, 1, *SGD_MOM, partition="zero1",
                            update_on_kvstore=True)
    with pytest.raises(MXNetError, match="update_on_kvstore"):
        tr._init_kvstore()
    with pytest.raises(MXNetError, match="partition mode"):
        make_model(3, 1, *SGD_MOM, partition="zero3")
    net, tr, _ = make_model(3, 2, *SGD_MOM, partition="zero1",
                            kvstore="device")
    with pytest.raises(MXNetError, match="collective kvstore"):
        tr._init_kvstore()


def test_checkpoint_bundle_carries_partition_manifest(tmp_path):
    net, tr, cxs = make_model(3, 1, *ADAM, partition="zero1",
                              kvstore="device", partition_world=2,
                              partition_rank=0)
    train(net, tr, cxs, 1)
    mgr = CheckpointManager(str(tmp_path), prefix="r0")
    mgr.save(0, params=net, trainer=tr)
    man = mgr.partition_manifest(0)
    assert man["mode"] == "zero1" and man["world"] == 2
    assert mgr.load(0)["zero"] == man
    assert mgr.states_path(0).endswith("trainer.states")


def test_strict_roundtrip_bit_exact(tmp_path):
    net, tr, cxs = make_model(3, 2, *SGD_MOM, partition="zero1")
    train(net, tr, cxs, 3)
    f = str(tmp_path / "states")
    tr.save_states(f)
    w_at_save = weights_of(net, cxs[0])
    cont_a = train(net, tr, cxs, 2, start=3)
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(w_at_save[k])
    tr.load_states(f)
    assert cont_a == train(net, tr, cxs, 2, start=3)


def test_plan_mismatches_raise(tmp_path):
    net, tr, cxs = make_model(3, 2, *SGD_MOM, partition="zero1")
    train(net, tr, cxs, 1)
    sharded = str(tmp_path / "sharded")
    tr.save_states(sharded)
    net0, tr0, c0 = make_model(3, 2, *SGD_MOM)
    train(net0, tr0, c0, 1)
    replicated = str(tmp_path / "replicated")
    tr0.save_states(replicated)
    with pytest.raises(zero_mod.PartitionMismatchError, match="unpartitioned"):
        tr0.load_states(sharded)
    with pytest.raises(zero_mod.PartitionMismatchError, match="zero1"):
        tr.load_states(replicated)
    net3, tr3, c3 = make_model(3, 3, *SGD_MOM, partition="zero1")
    tr3._init_kvstore()
    with pytest.raises(zero_mod.PartitionMismatchError, match="world=2"):
        tr3.load_states(sharded)


def test_missing_source_rank_raises_typed(tmp_path):
    net, tr, cxs = make_model(3, 1, *ADAM, partition="zero1",
                              kvstore="device", partition_world=4,
                              partition_rank=0)
    train(net, tr, cxs, 2)
    f = str(tmp_path / "r0-only")
    tr.save_states(f)
    net2, tr2, _ = make_model(3, 1, *ADAM, partition="zero1",
                              kvstore="device", partition_world=2,
                              partition_rank=0)
    tr2._init_kvstore()
    with pytest.raises(zero_mod.PartitionMismatchError, match="rank"):
        tr2.load_states_resharded([f])


def _virtual_model(seed, world, rank=0, pkg="port"):
    return make_model(seed, 1, *ADAM, partition="zero1", kvstore="device",
                      partition_world=world, partition_rank=rank, pkg=pkg)


def _save_rank_shards(tr, paths, world):
    for r, f in enumerate(paths):
        tr.zero_reconfigure(r, world)
        tr.save_states(f)
    tr.zero_reconfigure(0, world)


@pytest.mark.parametrize("m", [3, 5, 1])
def test_world_4_reshards_bit_exact(tmp_path, m):
    neta, tra, cxa = _virtual_model(3, world=4)
    train(neta, tra, cxa, 4, data_seed=31)
    files = [str(tmp_path / f"rank{r}") for r in range(4)]
    _save_rank_shards(tra, files, 4)
    wa = weights_of(neta, cxa[0])
    netb, trb, cxb = _virtual_model(99, world=m, rank=min(1, m - 1))
    for k, p in netb._collect_params_with_prefix().items():
        p.set_data(wa[k])
    trb.load_states_resharded(files)
    la = train(neta, tra, cxa, 3, data_seed=31, start=4)
    lb = train(netb, trb, cxb, 3, data_seed=31, start=4)
    assert_same(f"reshard 4->{m}", la, lb, weights_of(neta, cxa[0]),
                weights_of(netb, cxb[0]))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _jax_train(net, tr, ctxs, steps, data_seed=11):
    for s in range(steps):
        xh, yh = _batch(s, data_seed)
        with jag.record():
            loss = jgluon.loss.L2Loss()(net(jmx.nd.array(xh)),
                                        jmx.nd.array(yh))
        loss.backward()
        tr.step(6)


def test_partition_manifest_matches_the_reference(tmp_path):
    """The same model at world 4 gives the same plan in both packages,
    and each package reads the other's bundle manifest."""
    net, tr, cxs = _virtual_model(3, world=4, rank=1)
    jnet, jtr, jcx = _virtual_model(3, world=4, rank=1, pkg="jax")
    train(net, tr, cxs, 1)
    _jax_train(jnet, jtr, jcx, 1)
    man, jman = tr.partition_manifest(), jtr.partition_manifest()
    assert man == jman
    CheckpointManager(str(tmp_path / "p"), prefix="r1").save(
        0, params=net, trainer=tr)
    JCheckpointManager(str(tmp_path / "j"), prefix="r1").save(
        0, params=jnet, trainer=jtr)
    assert JCheckpointManager(str(tmp_path / "p"), prefix="r1") \
        .partition_manifest(0) == man
    assert CheckpointManager(str(tmp_path / "j"), prefix="r1") \
        .partition_manifest(0) == jman


def _states(export):
    return {(b, r, role): np.asarray(v, np.float32)
            for b, per in export["shards"].items()
            for r, rm in per.items() for role, v in rm.items()}


@pytest.mark.parametrize("src", ["port", "jax"])
def test_rank_state_files_cross_load(tmp_path, src):
    """Per-rank state files saved at world 4 by one package re-shard into
    world 2 in the other; every state value arrives unchanged."""
    net, tr, cxs = _virtual_model(3, world=4, pkg=src)
    if src == "port":
        train(net, tr, cxs, 2)
    else:
        _jax_train(net, tr, cxs, 2)
    files = [str(tmp_path / f"rank{r}") for r in range(4)]
    _save_rank_shards(tr, files, 4)
    dst = "jax" if src == "port" else "port"
    net2, tr2, _ = _virtual_model(99, world=2, pkg=dst)
    tr2.load_states_resharded(files)
    want = tr._zero.export_state(all_ranks=True)
    got = tr2._zero.export_state(all_ranks=True)
    roles = want["roles"]
    for b, bw in enumerate(want["plan"]):
        for role in roles:
            a = np.concatenate([np.asarray(want["shards"][b][r][role],
                                           np.float32)
                                for r in range(4)])[:bw["total"]]
            c = np.concatenate([np.asarray(got["shards"][b][r][role],
                                           np.float32)
                                for r in range(2)])[:bw["total"]]
            np.testing.assert_array_equal(a.view(np.uint32),
                                          c.view(np.uint32))
    assert got["clock"] == want["clock"]
