"""The port's hot reload and checkpoint bundles held against the JAX
package on the CPU: ``CheckpointManager`` bundles cross-loaded bit for
bit both ways, ``poll_newest``, ``Server.reload``/``swap_model``, a
failed reload that keeps the old model, the watcher that retries after
a failed reload, serving through a swap, a transient fault at
``serving.reload``, and the decode engine's static-buffer step against
its eager forward across batch sizes, a defrag and a weight refresh —
the contracts of ``tests/test_serving.py`` and ``tests/test_checkpoint.py``
on ``llama_tiny`` with f32 weights carried by ``mxnet_tpu_torch.convert``.
"""
import os
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jcheckpoint
from mxnet_tpu.gluon.model_zoo.nlp import llama_tiny as jax_llama_tiny

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint, fault, telemetry
from mxnet_tpu_torch.convert import llama_params_from_reference
from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_tiny
from mxnet_tpu_torch.ndarray.ndarray import NDArray
from mxnet_tpu_torch.serving import PagePool, Server

pytestmark = pytest.mark.serving

PROMPT = np.array([3, 1, 4, 1, 5], dtype=np.int32)
PAGE = 4


def _weights(seed):
    """(jax net, numpy params by JAX name) of ``llama_tiny``, drawn from
    ``seed`` at a scale that spreads the logits."""
    jnet = jax_llama_tiny()
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 2), dtype="int32"))
    rs = np.random.RandomState(seed)
    named = {}
    for name, p in jnet.collect_params().items():
        if name.endswith("norm_weight"):
            arr = 1.0 + 0.1 * rs.randn(*p.shape)
        else:
            arr = rs.randn(*p.shape) / np.sqrt(p.shape[-1])
        named[name] = arr.astype(np.float32)
        p.set_data(jmx.nd.array(named[name]))
    return jnet, named


def port_net(seed):
    net = llama_tiny(ctx=mx.cpu())
    net.load_state_dict(llama_params_from_reference(_weights(seed)[1]))
    return net


@torch.no_grad()
def oracle(net, prompt, n_new):
    toks = [int(t) for t in prompt]
    for _ in range(n_new):
        toks.append(int(torch.argmax(net(torch.tensor([toks]))[0, -1])))
    return np.asarray(toks[len(prompt):], dtype=np.int32)


def factory(path):
    net = llama_tiny(ctx=mx.cpu())
    net.load_parameters(os.path.join(path, "params.params"))
    return net


def server(net, **kw):
    base = dict(batch_buckets=(1, 2), slo_ms=60000.0, dtype="int32",
                decode_pages=64, page_size=PAGE, len_buckets=(8, 16),
                ctx=mx.cpu())
    base.update(kw)
    return Server(net, **base)


# ---------------------------------------------------------------------------
# checkpoint bundles
# ---------------------------------------------------------------------------

def _as_f32(a):
    a = a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)
    return a.astype(np.float32) if str(a.dtype) == "bfloat16" else a


def test_bundles_cross_load_bit_for_bit_both_ways(tmp_path):
    jnet, named = _weights(7)
    pnet = port_net(7)
    bf16 = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)
                       ).to(torch.bfloat16)
    # the JAX package saves, the port loads and restores
    jmgr = jcheckpoint.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save(5, params=jnet, epoch=2, extra={"note": "jax"})
    pmgr = checkpoint.CheckpointManager(str(tmp_path / "jax"))
    assert pmgr.steps() == [5] and pmgr.is_valid(5)
    got = pmgr.load()
    want = jmgr.load()
    assert got["epoch"] == 2 and got["extra"] == {"note": "jax"}
    assert sorted(got["params"]) == sorted(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_array_equal(
            got["params"][k].asnumpy().view(np.int32),
            v.asnumpy().view(np.int32))
    fresh = llama_tiny(ctx=mx.cpu(),
                       generator=torch.Generator().manual_seed(3))
    pmgr.restore(block=fresh)
    for (k, a), b in zip(pnet.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    # the port saves (a block, and a dict holding bf16), the JAX
    # package loads and restores
    pmgr2 = checkpoint.CheckpointManager(str(tmp_path / "port"))
    pmgr2.save(9, params=pnet, extra={"note": "port"})
    pmgr2.save(10, params={"w": bf16, "x": NDArray(torch.arange(6.0))})
    jmgr2 = jcheckpoint.CheckpointManager(str(tmp_path / "port"))
    assert jmgr2.steps() == [10, 9]
    assert all(jmgr2.is_valid(s) for s in (9, 10))
    loaded = jmgr2.load(9)
    assert loaded["extra"] == {"note": "port"}
    for k, v in pmgr2.load(9)["params"].items():
        np.testing.assert_array_equal(loaded["params"][k].asnumpy(),
                                      v.asnumpy())
    jfresh = jax_llama_tiny()
    jfresh.initialize()
    jfresh(jmx.nd.zeros((1, 2), dtype="int32"))
    jmgr2.restore(block=jfresh, step=9)     # the port's rng.pkl too
    for p, w in zip(jfresh.collect_params().values(), named.values()):
        np.testing.assert_array_equal(p.data().asnumpy().view(np.int32),
                                      w.view(np.int32))
    b = jmgr2.load(10)["params"]
    np.testing.assert_array_equal(_as_f32(b["w"]), bf16.float().numpy())
    np.testing.assert_array_equal(_as_f32(b["x"]), np.arange(6.0,
                                                             dtype=np.float32))


def test_manager_retention_polling_and_refusals(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep_last=2)
    assert mgr.poll_newest("t") is None
    net = port_net(7)
    for step in (1, 2, 3):
        mgr.save(step, params=net)
    assert mgr.steps() == [3, 2]                  # keep_last
    assert mgr.poll_newest("t") == 3
    assert mgr.poll_newest("t") is None           # unchanged
    mgr.save(3, params=net)                       # re-save the step
    assert mgr.poll_newest("t") == 3
    assert mgr.poll_newest("other") == 3          # per-tag state
    mgr.poll_reset("t")
    assert mgr.poll_newest("t") == 3
    # a corrupt payload drops the bundle from discovery
    with open(os.path.join(mgr.path(3), "params.params"), "r+b") as f:
        f.seek(40)
        f.write(b"\xff")
    assert mgr.latest_step() == 2 and not mgr.is_valid(3)
    stale = tmp_path / ".ckpt-00000009.staging-x"
    stale.mkdir()
    os.utime(stale, (0, 0))
    mgr.save(4, params=net)
    assert not stale.exists()                     # the staging sweep
    # trainer= is ported: a bundle without trainer.states refuses to
    # restore a trainer (tests/test_torch_trainer.py holds the states)
    with pytest.raises(mx.MXNetError, match="no trainer.states"):
        mgr.restore(block=net, trainer=object())
    with pytest.raises(mx.MXNetError, match="fails checksum"):
        mgr.restore(block=net, step=3)


def test_rng_streams_round_trip_through_a_bundle(tmp_path):
    from mxnet_tpu_torch import random_state

    mgr = checkpoint.CheckpointManager(str(tmp_path))
    random_state.seed(42)
    random_state.next_seed()
    mgr.save(1, params={"x": torch.zeros(2)})
    after = [random_state.next_seed() for _ in range(3)]
    random_state.seed(7)
    mgr.restore()
    assert [random_state.next_seed() for _ in range(3)] == after


# ---------------------------------------------------------------------------
# reload and swap
# ---------------------------------------------------------------------------

def test_reload_swaps_in_the_bundle(tmp_path):
    old, new = port_net(7), port_net(11)
    want_old, want_new = oracle(old, PROMPT, 5), oracle(new, PROMPT, 5)
    assert not np.array_equal(want_old, want_new)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(7, params=new)
    with server(old) as srv:
        np.testing.assert_array_equal(
            srv.submit_generate(PROMPT, 5).result(60), want_old)
        assert srv.reload(mgr, factory) == 7
        assert srv.loaded_step == 7 and srv.model_version == 1
        np.testing.assert_array_equal(
            srv.submit_generate(PROMPT, 5).result(60), want_new)
        # the old block is left as it was (kept for a rollback)
        np.testing.assert_array_equal(oracle(old, PROMPT, 5), want_old)
        st = srv.stats()
    assert st["reloads"] == 1 and st["errors"] == 0


def test_a_failed_reload_keeps_the_old_model(tmp_path):
    old = port_net(7)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, params=old)

    def bad_factory(path):
        raise mx.MXNetError("factory exploded")

    with server(old) as srv:
        with pytest.raises(mx.MXNetError, match="factory exploded"):
            srv.reload(mgr, bad_factory)
        np.testing.assert_array_equal(
            srv.submit_generate(PROMPT, 4).result(60),
            oracle(old, PROMPT, 4))
        assert srv.loaded_step is None and srv.model_version == 0
    empty = checkpoint.CheckpointManager(str(tmp_path / "none"))
    with server(old) as srv:
        with pytest.raises(mx.MXNetError, match="no checksum-valid"):
            srv.reload(empty, factory)


def test_a_transient_reload_fault_is_retried(tmp_path):
    old, new = port_net(7), port_net(11)
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    was = telemetry.enabled()
    telemetry.reset()
    telemetry.enable()
    try:
        mgr.save(3, params=new)
        with server(old) as srv:
            with fault.inject("serving.reload=once") as st:
                assert srv.reload(mgr, factory) == 3
                assert st()["serving.reload"]["injected"] == 1
            np.testing.assert_array_equal(
                srv.submit_generate(PROMPT, 4).result(60),
                oracle(new, PROMPT, 4))
        text = telemetry.prom_text()
    finally:
        telemetry.reset()
        if not was:
            telemetry.disable()
    assert 'mxnet_serving_reloads_total{outcome="ok"} 1' in text
    assert ('mxnet_retry_total{site="serving.reload",outcome="recovered"} 1'
            in text)
    assert "mxnet_checkpoint_write_seconds_count 1" in text


def test_the_watcher_retries_after_a_failed_reload(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep_last=2)
    old, new = port_net(7), port_net(11)
    mgr.save(0, params=old)
    attempts = []

    def flaky_factory(path):
        attempts.append(path)
        if len(attempts) == 1:
            raise mx.MXNetError("factory exploded once")
        return factory(path)

    with server(old) as srv:
        srv.enable_hot_reload(mgr, flaky_factory, interval_s=0.02)
        with pytest.raises(mx.MXNetError, match="already enabled"):
            srv.enable_hot_reload(mgr, factory)
        mgr.save(1, params=new)
        deadline = time.time() + 30
        while srv.loaded_step != 1 and time.time() < deadline:
            time.sleep(0.02)
        # poll_reset offered the bundle again after the failed attempt
        assert srv.loaded_step == 1 and len(attempts) >= 2
        np.testing.assert_array_equal(
            srv.submit_generate(PROMPT, 4).result(60),
            oracle(new, PROMPT, 4))
    assert srv._watcher is None         # stop() tore the watcher down


def test_serving_through_a_swap_each_stream_runs_one_version(tmp_path):
    """Streams in flight while the watcher swaps the model: each
    completion is all old-model tokens or all new-model tokens (a
    completion runs on one model version), and the last is new."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep_last=2)
    old, new = port_net(7), port_net(11)
    want_old, want_new = oracle(old, PROMPT, 12), oracle(new, PROMPT, 12)
    mgr.save(0, params=old)
    outs = []
    with server(old) as srv:
        srv.enable_hot_reload(mgr, factory, interval_s=0.02)
        outs.append(srv.submit_generate(PROMPT, 12).result(60))
        live = srv.submit_generate(PROMPT, 12)
        assert live.next_token(1, timeout=60) is not None
        mgr.save(1, params=new)
        deadline = time.time() + 30
        while srv.loaded_step != 1 and time.time() < deadline:
            outs.append(srv.submit_generate(PROMPT, 12).result(60))
        outs.append(live.result(60))
        assert srv.loaded_step == 1
        outs.append(srv.submit_generate(PROMPT, 12).result(60))
    for o in outs:
        assert np.array_equal(o, want_old) or np.array_equal(o, want_new)
    np.testing.assert_array_equal(outs[-1], want_new)


# ---------------------------------------------------------------------------
# the decode engine's static-buffer step
# ---------------------------------------------------------------------------

def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def test_static_buffer_step_equals_eager_forward_across_a_chain():
    """Batch sizes 8 -> 5 -> 8 through bucket 8's static buffers (the
    5-row step pads rows 5-7 with length 0 and a zero page table), then
    a defrag, then a weight refresh: each step's logits equal the eager
    ``forward`` on the same inputs, bit for bit."""
    net, net2 = port_net(7), port_net(11)
    pool = PagePool(100, PAGE)
    engine = net.decode_engine(pool, dtype="float32")
    width = pool.pages_for(40)
    engine.capture((8,), width)
    assert engine.captures == 1
    rs = np.random.RandomState(5)
    holes = pool.alloc("hole", 40)
    assert holes
    table = np.zeros((8, width), np.int32)
    lengths = rs.randint(3, 12, size=8).astype(np.int32)
    prompts = np.zeros((8, 16), np.int32)
    for i in range(8):
        table[i] = pool.alloc(("row", i), 40)
        prompts[i, :lengths[i]] = rs.randint(0, 256, size=lengths[i])
    nxt = np.argmax(engine.prefill(prompts, lengths, table), -1)

    def step(n):
        nonlocal nxt, lengths
        lengths = lengths + (np.arange(8) < n)
        tk = np.where(np.arange(8) < n, nxt, 0).astype(np.int32)
        ln = np.where(np.arange(8) < n, lengths, 0).astype(np.int32)
        t = np.where((np.arange(8) < n)[:, None], table, 0).astype(np.int32)
        want = engine.decode_step_eager(tk, ln, t)
        got = engine.decode_step(tk, ln, t)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        nxt = np.where(np.arange(8) < n, np.argmax(got, -1), nxt)
        return got

    for n in (8, 8, 5, 5, 8):
        step(n)
    pool.free("hole")
    moves = pool.defrag()
    assert moves
    engine.apply_defrag(moves)
    for i in range(8):
        table[i] = pool.owned(("row", i))
    step(8)
    engine.refresh_params(net2)
    assert engine.captures == 2 and engine.replays == 0
    step(8)
    step(5)


def test_load_parameters_refuses_missing_extra_and_misshapen_names(tmp_path):
    from mxnet_tpu_torch.ndarray import serialization

    net = port_net(7)
    good = {name: NDArray(p.tensor.detach().clone())
            for name, p in net._collect_params_with_prefix().items()}
    assert "layer1.mlp.down.weight" in good      # the JAX package's names
    cases = {"missing": dict(good), "extra": dict(good),
             "shape": dict(good)}
    del cases["missing"]["layer0.attn_norm.weight"]
    cases["extra"]["layer0.attention.bias"] = NDArray(torch.zeros(4))
    cases["shape"]["norm.weight"] = NDArray(torch.zeros(3))
    for name, arrays in cases.items():
        path = str(tmp_path / f"{name}.params")
        serialization.save(path, arrays)
        with pytest.raises(mx.MXNetError, match=name if name != "shape"
                           else "has shape"):
            port_net(11).load_parameters(path)
    path = str(tmp_path / "good.params")
    serialization.save(path, good)
    other = port_net(11)
    other.load_parameters(path)
    for a, b in zip(net.parameters(), other.parameters()):
        assert torch.equal(a, b)
