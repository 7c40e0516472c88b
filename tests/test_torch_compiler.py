"""The port's compilation service (``mxnet_tpu_torch/compiler/``) on the
CPU, held against the JAX package's (``mxnet_tpu/compiler/``, whose
``keys``, ``manifest`` and ``service`` modules import no JAX) where both
answer: the cases of ``tests/test_compile_service.py`` that mean
something off the TPU.

* keys: equal and hashable; every component distinguishes; the codec
  round-trips; ``encode``/``decode``/``fingerprint`` give the
  reference's strings for the same tuples; ``graph_ident`` matches
  factory twins only (a changed width or forward does not);
  ``callable_ident`` sees bytecode; ``aval`` sees the memory order;
* the ``SiteCache`` LRU: one sequence of lookups and inserts gives the
  reference's hits, misses and evictions;
* the ``ExecutableTable``: single flight, a failed build's slot;
* the manifest: round trip, dedupe, corrupt and stale lines (one written
  by the JAX package's ``Manifest``), a missing file, the env recorder;
* warm start: unmatched providers skipped, a ``TrainStep`` warmed from a
  manifest taking its first step with no miss and the cold step's loss
  bit for bit, a CPU Llama server's decode buckets seated from the
  manifest (no miss, the cold tokens), concurrent ``warm_start`` calls;
* ``mark_event`` first occurrence only; ``first_train_step`` marked;
* the disk tier: collection past the cap in ``tmp_path``, never the live
  build directory; the NVRTC tier's key and its atomic write, with fake
  CUBIN bytes;
* the package imports neither ``jax`` nor ``mxnet_tpu``.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu.compiler import keys as jkeys
from mxnet_tpu.compiler import manifest as jmanifest
from mxnet_tpu.compiler import service as jservice

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compiler, rtc, telemetry
from mxnet_tpu_torch.compiler import keys, persistent, service
from mxnet_tpu_torch.compiler import manifest as manifest_mod
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.parallel import TrainStep

REPO = pathlib.Path(__file__).resolve().parents[1]


def _counter(snap, name, **labels):
    fam = snap["metrics"].get(name)
    if not fam:
        return 0.0
    return sum(s["value"] for s in fam["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _make_net(width=16, seed=0):
    mx.random.seed(seed)
    net = nn.HybridSequential(prefix="svc_")
    with net.name_scope():
        net.add(nn.Dense(width, activation="relu"))
        net.add(nn.Dense(4))
    net.initialize(ctx=mx.cpu())
    return net


def _make_step(width=16, seed=0):
    net = _make_net(width=width, seed=seed)
    return TrainStep(net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
                     optimizer_params={"learning_rate": 0.1})


def _batch(b=4):
    rs = np.random.RandomState(0)
    return (torch.from_numpy(rs.rand(b, 8).astype("float32")),
            torch.from_numpy((np.arange(b) % 4).astype("float32")))


@pytest.fixture
def recording(tmp_path):
    m = compiler.enable_recording(str(tmp_path / "m.jsonl"))
    try:
        yield m
    finally:
        compiler.disable_recording()


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def test_same_signature_is_equal_and_hashable():
    k1 = compiler.signature("cached_op", "g", avals=((2, 2),),
                            attrs=(("a", 1),), platform="cpu",
                            extra=(2, False))
    k2 = compiler.signature("cached_op", "g", avals=((2, 2),),
                            attrs=(("a", 1),), platform="cpu",
                            extra=(2, False))
    assert k1 == k2 and hash(k1) == hash(k2)
    assert compiler.fingerprint(k1) == compiler.fingerprint(k2)
    assert k1.routing == compiler.routing_knobs()


def test_every_site_component_distinguishes():
    base = dict(avals=((2, 2),), attrs=(("k", 1),), platform="cpu",
                routing=(False,), extra=(True,))
    k = compiler.signature("cached_op", "g", **base)
    for field, mutated in [
            ("avals", ((4, 4),)), ("attrs", (("k", 2),)),
            ("platform", "cuda:sm_90"), ("routing", (True,)),
            ("extra", (False,))]:
        other = dict(base, **{field: mutated})
        assert compiler.signature("cached_op", "g", **other) != k
    assert compiler.signature("train_step", "g", **base) != k
    assert compiler.signature("cached_op", "h", **base) != k


def test_routing_knobs_are_the_build_torch_cuda_and_card():
    build, torch_version, cuda, sm = compiler.routing_knobs()
    assert build == _build.build_dir().name == keys.build_key()
    assert torch_version == torch.__version__
    assert cuda == str(torch.version.cuda)
    assert sm == ("cpu" if not torch.cuda.is_available() else sm)
    assert keys.platform(torch.device("cpu")) == "cpu"
    assert keys.platform(torch.device("meta")) == "meta"


def test_codec_round_trips_tuples_exactly():
    obj = ((1, 2), "a", [3.5, None], {"k": (True, "x")},
           ("s", ("r", 0, 1)))
    dec = keys.decode(keys.encode(obj))
    assert dec == obj
    assert isinstance(dec[0], tuple) and isinstance(dec[2], list)


@pytest.mark.parametrize("obj", [
    ((1, 2), "a", [3.5, None], {"k": (True, "x")}, ("s", ("r", 0, 1))),
    ("cached_op", "g", (((2, 8), "float32", "cpu", False),), (), (),
     "cpu", ("b", "2.13", "None", "cpu"), ((("16", 8),), False)),
    {"graph": "abc", "args": (((32, 128), "float32", False), None),
     "training": False},
    (np.float32(1.5), torch.float32, 7, -0.0, "x" * 40),
])
def test_encode_decode_fingerprint_are_the_references(obj):
    assert keys.encode(obj) == jkeys.encode(obj)
    assert keys.fingerprint(obj) == jkeys.fingerprint(obj)
    assert keys.decode(keys.encode(obj)) == jkeys.decode(jkeys.encode(obj))
    k = keys.signature("train_step", "i", avals=((4, 8),), platform="cpu",
                       routing=(1, 2), extra=(1,))
    j = jkeys.signature("train_step", "i", avals=((4, 8),), platform="cpu",
                        routing=(1, 2), extra=(1,))
    assert keys.fingerprint(k) == jkeys.fingerprint(j)
    assert keys.fingerprint(("cached_op", keys.encode(obj))) \
        == jkeys.fingerprint(("cached_op", jkeys.encode(obj)))


def test_graph_ident_matches_factory_twins_only():
    a, b = _make_net(seed=0), _make_net(seed=1)
    assert compiler.graph_ident(a) == compiler.graph_ident(b)
    # settled or not, the twins match (declared shapes, not inferred)
    fresh = nn.HybridSequential(prefix="svc_")
    with fresh.name_scope():
        fresh.add(nn.Dense(16, activation="relu"))
        fresh.add(nn.Dense(4))
    a(mx.nd.array(np.ones((2, 8), np.float32), ctx=mx.cpu()))
    assert compiler.graph_ident(fresh) == compiler.graph_ident(a)
    # a changed width does not match
    assert compiler.graph_ident(_make_net(width=32)) \
        != compiler.graph_ident(a)

    class Custom(nn.HybridSequential):
        def hybrid_forward(self, F, x):
            return super().hybrid_forward(F, x) * 2

    c = Custom(prefix="svc_")
    with c.name_scope():
        c.add(nn.Dense(16, activation="relu"))
        c.add(nn.Dense(4))
    # same children, another forward's bytecode: another ident
    assert compiler.graph_ident(c) != compiler.graph_ident(a)


def test_callable_ident_sees_bytecode():
    f1 = lambda x: x + 1            # noqa: E731
    f2 = lambda x: x + 1            # noqa: E731
    g = lambda x: x * 3             # noqa: E731
    assert keys.callable_ident(f1).split(":")[-1] \
        == keys.callable_ident(f2).split(":")[-1]
    assert keys.callable_ident(f1) != keys.callable_ident(g)
    assert keys.callable_ident(f1) == jkeys.callable_ident(f1)


def test_aval_sees_dtype_device_and_memory_order():
    x = torch.zeros(2, 3, 4, 5)
    last = x.contiguous(memory_format=torch.channels_last)
    assert keys.aval(x) == ((2, 3, 4, 5), "float32", "cpu", False)
    assert keys.aval(last) == ((2, 3, 4, 5), "float32", "cpu", True)
    assert keys.aval(x.bfloat16())[1] == "bfloat16"
    # a tensor both row-major and channels-last (C = 1) is row-major
    assert keys.aval(torch.zeros(2, 1, 4, 5).contiguous(
        memory_format=torch.channels_last))[3] is False
    assert keys.aval(mx.nd.zeros((2, 2), ctx=mx.cpu())) \
        == ((2, 2), "float32", "cpu", False)


# ---------------------------------------------------------------------------
# site caches + executable table
# ---------------------------------------------------------------------------

_OPS = [("lookup", "a"), ("insert", "a"), ("insert", "b"), ("lookup", "a"),
        ("insert", "c"), ("lookup", "b"), ("lookup", "c"), ("insert", "b"),
        ("lookup", "a"), ("insert", "d"), ("lookup", "c"), ("lookup", "d")]


def _drive(cache):
    out = []
    for op, key in _OPS:
        if op == "insert":
            cache.insert(key, key.upper())
        else:
            got = cache.lookup(key)
            out.append(None if got is cache.MISS else got)
    return out, sorted(cache.keys())


def test_site_cache_lru_matches_the_reference():
    jtelemetry.enable()
    telemetry.enable()
    try:
        jbase, base = jtelemetry.snapshot(), telemetry.snapshot()
        jc = jservice.SiteCache("svc_lru", maxsize=2)
        c = service.SiteCache("svc_lru", maxsize=2)
        assert _drive(c) == _drive(jc)
        jsnap, snap = jtelemetry.snapshot(), telemetry.snapshot()
    finally:
        jtelemetry.disable()
        telemetry.disable()
    for name, labels in (("mxnet_jit_cache_total", {"result": "hit"}),
                         ("mxnet_jit_cache_total", {"result": "miss"}),
                         ("mxnet_jit_cache_evictions_total", {})):
        want = _counter(jsnap, name, cache="svc_lru", **labels) \
            - _counter(jbase, name, cache="svc_lru", **labels)
        got = _counter(snap, name, cache="svc_lru", **labels) \
            - _counter(base, name, cache="svc_lru", **labels)
        assert got == want, name
    assert (c.hits, c.misses, c.evictions) == (
        _counter(jsnap, "mxnet_jit_cache_total", cache="svc_lru",
                 result="hit") - _counter(jbase, "mxnet_jit_cache_total",
                                          cache="svc_lru", result="hit"),
        _counter(jsnap, "mxnet_jit_cache_total", cache="svc_lru",
                 result="miss") - _counter(jbase, "mxnet_jit_cache_total",
                                           cache="svc_lru", result="miss"),
        _counter(jsnap, "mxnet_jit_cache_evictions_total", cache="svc_lru")
        - _counter(jbase, "mxnet_jit_cache_evictions_total",
                   cache="svc_lru"))


def test_site_cache_eviction_hook_and_round_trip():
    gone = []
    c = service.SiteCache("svc_hook", maxsize=1,
                          on_evict=lambda k, v: gone.append((k, v)))
    assert c.lookup("k") is c.MISS
    c.insert("k", "v")
    assert c.lookup("k") == "v" and "k" in c and len(c) == 1
    c.insert("j", "w")
    assert gone == [("k", "v")] and c.keys() == ["j"]
    assert c.pop("j") == "w" and len(c) == 0 and gone == [("k", "v")]


def test_shared_cache_is_one_per_site():
    a = service.shared_cache("svc_shared")
    assert service.shared_cache("svc_shared") is a
    assert service.site_caches()["svc_shared"] is a


def test_single_flight_dedupes_concurrent_builds():
    t = service.ExecutableTable()
    builds = []

    def build():
        time.sleep(0.02)
        builds.append(1)
        return object()

    results = []
    threads = [threading.Thread(
        target=lambda: results.append(t.get_or_build("fp", build)))
        for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert len(builds) == 1
    assert len(results) == 8 and all(r is results[0] for r in results)
    assert t.stats()["dedup_hits"] == 7 and t.stats()["entries"] == 1


def test_failed_build_releases_the_slot():
    t = service.ExecutableTable()
    with pytest.raises(RuntimeError):
        t.get_or_build("fp", lambda: (_ for _ in ()).throw(
            RuntimeError("boom")))
    assert t.stats()["entries"] == 0 and t.stats()["builds"] == 0
    assert t.get_or_build("fp", lambda: "ok") == "ok"


def test_guarded_exec_replays_only_what_it_accepts():
    calls = []
    g = service.GuardedExec(lambda x: ("graph", x),
                            lambda: lambda x: calls.append(x) or "eager",
                            accepts=lambda x: x == 1)
    assert g(1) == ("graph", 1)
    assert g(2) == "eager" and g(3) == "eager" and calls == [2, 3]
    g.compiled = None                       # an evicted entry
    assert g(1) == "eager"


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def test_manifest_round_trip_and_dedupe(tmp_path):
    m = compiler.Manifest(str(tmp_path / "sig.jsonl"))
    spec = {"graph": "g", "args": (((3, 4), "float32", False),),
            "training": False}
    assert m.record("cached_op", spec) is not None
    assert m.record("cached_op", spec) is None       # dedupe
    m.record("train_step", {"ident": "x", "data": (((2,), "float32"),)})
    loaded = compiler.Manifest(str(tmp_path / "sig.jsonl")).entries()
    assert [e["site"] for e in loaded] == ["cached_op", "train_step"]
    assert loaded[0]["spec"] == spec    # tuples restored exactly
    assert loaded[0]["platform"] == keys.platform()
    # the fingerprint is the reference's for the same site and spec
    assert loaded[0]["fp"] == jkeys.fingerprint(
        ("cached_op", jkeys.encode(spec)))


def test_corrupt_and_stale_lines_are_skipped(tmp_path):
    path = str(tmp_path / "sig.jsonl")
    m = compiler.Manifest(path)
    m.record("cached_op", {"graph": "g"})
    # a line of the JAX package's own manifest: no platform, no build
    jmanifest.Manifest(path).record("cached_op", {"graph": "jax"})
    good = json.loads(open(path).readline())
    with open(path, "a") as f:
        f.write("{not json\n")
        f.write(json.dumps(dict(good, v=99, fp="z")) + "\n")
        f.write(json.dumps(dict(good, site="no_such_site", fp="y")) + "\n")
        f.write(json.dumps({k: v for k, v in good.items() if k != "fp"})
                + "\n")
        f.write(json.dumps(dict(good, platform="cuda:sm_00", fp="w")) + "\n")
        f.write(json.dumps(dict(good, build="another", fp="u")) + "\n")
    m2 = compiler.Manifest(path)
    assert [e["spec"] for e in m2.entries()] == [{"graph": "g"}]
    assert m2.n_skipped == 1 + 6


def test_missing_file_is_empty_not_fatal(tmp_path):
    m = compiler.Manifest(str(tmp_path / "absent.jsonl"))
    assert m.entries() == [] and len(m) == 0


def test_env_recorder_gating(monkeypatch, tmp_path):
    monkeypatch.setattr(manifest_mod, "_env_checked", False)
    monkeypatch.setattr(manifest_mod._recorder, "manifest", None)
    monkeypatch.setenv("MXNET_COMPILE_MANIFEST", "0")
    assert compiler.recorder() is None
    monkeypatch.setattr(manifest_mod, "_env_checked", False)
    monkeypatch.setenv("MXNET_COMPILE_MANIFEST", str(tmp_path / "m.jsonl"))
    rec = compiler.recorder()
    assert rec is not None and rec.path.endswith("m.jsonl")
    monkeypatch.setattr(manifest_mod, "_env_checked", False)
    monkeypatch.setenv("MXNET_COMPILE_MANIFEST", "1")
    monkeypatch.setenv("MXNET_XLA_CACHE_DIR", str(tmp_path / "tier"))
    assert compiler.recorder().path == str(
        tmp_path / "tier" / "manifests" / "signatures.jsonl")
    manifest_mod.disable_recording()
    assert compiler.recorder() is None


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------

def test_unmatched_providers_are_skipped_not_fatal(tmp_path):
    m = compiler.Manifest(str(tmp_path / "m.jsonl"))
    m.record("cached_op", {"graph": "nope",
                           "args": (((1,), "float32", False),),
                           "training": False})
    m.record("train_step", {"ident": "nope", "data": ()})
    m.record("serving_decode", {"graph": "nope", "batch": 1, "width": 2,
                                "dtype": "float32", "page_size": 16})
    report = compiler.warm_start(m)
    assert report == {"replayed": 0, "deduped": 0, "skipped": 3,
                      "failed": 0, "entries": 3,
                      "seconds": report["seconds"]}
    assert "warm_start_done" in compiler.events()


def test_cached_op_on_the_cpu_is_skipped(tmp_path, recording):
    net = _make_net()
    recording.record("cached_op", {
        "graph": compiler.graph_ident(net),
        "args": (((2, 8), "float32", False),), "training": False})
    report = compiler.warm_start(recording, blocks=[net])
    assert report["skipped"] == 1 and report["failed"] == 0
    assert net.cached_graph is None          # no CUDA graph on the CPU


def test_train_step_warm_means_no_miss_and_bit_identity(recording):
    x, y = _batch()
    cold = _make_step()
    loss_cold = cold(x, y)[0].numpy().copy()
    specs = [e for e in recording.entries() if e["site"] == "train_step"]
    assert len(specs) == 1
    assert specs[0]["spec"]["data"] == (((4, 8), "float32"),)
    assert specs[0]["spec"]["label"] == (((4,), "float32"),)

    warm = _make_step()
    report = compiler.warm_start(recording, train_steps=[warm])
    assert report["failed"] == 0 and report["replayed"] == 1
    assert warm._states is not None           # made ahead, no update run
    assert warm.optimizer.num_update == 0
    telemetry.enable()
    try:
        base = telemetry.snapshot()
        misses = warm._cache.misses
        loss_warm = warm(x, y)[0].numpy()
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
    assert warm._cache.misses == misses and warm._cache.hits == 1
    assert _counter(snap, "mxnet_jit_cache_total", cache="train_step",
                    result="miss") == _counter(
        base, "mxnet_jit_cache_total", cache="train_step", result="miss")
    assert loss_warm.tobytes() == loss_cold.tobytes()


def _serve_tiny_llama(warm, manifest=None, seed=2):
    """Two generate requests, one after the other, from a tiny Llama on
    the CPU behind a server with decode steps per batch bucket (1, 2);
    with ``warm`` the server starts with no warm-up and ``warm_start``
    seats the recorded buckets first. Returns (tokens, decode misses
    after warm-up, warm_start's report)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import LlamaModel

    net = LlamaModel(vocab_size=256, num_layers=2, units=64,
                     hidden_size=128, num_heads=4, num_kv_heads=2,
                     ctx=mx.cpu(), generator=torch.Generator().manual_seed(
                         seed))
    srv = mx.serving.Server(net, ctx=mx.cpu(), decode_pages=32,
                            page_size=16, batch_buckets=(1, 2),
                            len_buckets=(32,), warmup=not warm)
    with srv:
        report = compiler.warm_start(manifest, blocks=[net]) if warm \
            else None
        cache = srv.engine._cache
        misses = cache.misses
        rs = np.random.RandomState(0)
        tokens = [srv.submit_generate(rs.randint(0, 256, size=n).astype(
            np.int32), 5).result(60) for n in (7, 19)]
        buckets = srv.engine.buckets()
    return [list(map(int, t)) for t in tokens], cache.misses - misses, \
        report, buckets


def test_decode_buckets_warm_from_the_manifest(recording):
    cold, _, _, buckets = _serve_tiny_llama(warm=False)
    specs = [e["spec"] for e in recording.entries()
             if e["site"] == "serving_decode"]
    assert sorted((s["batch"], s["width"]) for s in specs) == buckets
    assert len(buckets) == 2
    compiler.disable_recording()
    tokens, misses, report, warm_buckets = _serve_tiny_llama(
        warm=True, manifest=recording)
    assert report["replayed"] == 2 and report["failed"] == 0
    assert misses == 0 and warm_buckets == buckets
    assert tokens == cold
    # another seed's weights, one structure: matched and warmed alike
    _, misses, report, _ = _serve_tiny_llama(warm=True, manifest=recording,
                                             seed=3)
    assert report["replayed"] == 2 and misses == 0


def test_a_decode_engines_steps_leave_with_it():
    """The decode steps live in the engine's own site cache: a freed
    engine takes them with it, and a second engine of the same model
    seats its own (a step binds its engine's buffers)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import LlamaModel
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import LlamaDecodeEngine
    from mxnet_tpu_torch.serving.kvcache import PagePool

    net = LlamaModel(vocab_size=256, num_layers=1, units=64,
                     hidden_size=128, num_heads=4, num_kv_heads=2,
                     ctx=mx.cpu(), generator=torch.Generator().manual_seed(
                         0))
    one = LlamaDecodeEngine(net, PagePool(8, 16))
    one.capture((1, 2), 2)
    two = LlamaDecodeEngine(net, PagePool(8, 16))
    two.capture((1,), 2)
    assert len(one._cache) == 2 and len(two._cache) == 1
    assert one._cache.misses == 2 and two._cache.misses == 1
    assert one._cache.site == two._cache.site == "serving_decode"
    steps = [weakref.ref(s) for s in one._cache.values()]
    del one
    assert all(ref() is None for ref in steps)
    assert len(two._cache) == 1


def test_concurrent_warm_start_is_thread_safe(recording):
    x, y = _batch()
    _make_step()(x, y)
    warm = _make_step()
    reports = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: reports.append(
                compiler.warm_start(recording, train_steps=[warm])))
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(reports) == 8 and all(r["failed"] == 0 for r in reports)
    assert sum(r["replayed"] for r in reports) == 1
    assert len(warm._cache) == 1            # one signature, once
    loss, _ = warm(x, y)
    assert np.isfinite(loss.numpy()).all()


# ---------------------------------------------------------------------------
# cold-start events
# ---------------------------------------------------------------------------

def test_mark_event_records_first_occurrence_only():
    name = f"svc_test_event_{os.getpid()}"
    t1 = service.mark_event(name)
    assert t1 is not None and 0 <= t1 <= service.seconds_since_import()
    assert service.mark_event(name) is None
    assert service.events()[name] == t1


def test_a_step_entry_loads_its_path_libraries_only(monkeypatch):
    """A step's entry on the card loads the libraries its path launches:
    a library it never launches (nvJPEG's codec), even one whose build
    failed, stays out of it. The ``kernels`` replay loads the recorded
    library alone."""
    step = _make_step()
    x, y = _batch()
    step(x, y)                          # the states, made on the CPU
    loaded = []

    def load(src):
        if src == "jpeg_codec.cu":
            raise mx.MXNetError("CUDA kernel build failed: jpeg_codec.cu")
        loaded.append(src)

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(step, "_device", torch.device("cuda", 0))
    entry = step._prepare()
    assert sorted(loaded) == sorted(entry["libs"])
    assert {"rms_norm.cu", "layer_norm.cu", "flash_attention.cu",
            "flash_attention_bwd.cu", "bias_gelu.cu", "dropout.cu",
            "fused_optimizer.cu"} == set(loaded)
    monkeypatch.setattr(_build, "build_dir", lambda: pathlib.Path("b0"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    loaded.clear()
    assert _build.warm_spec({"build": "b0", "lib": "rms_norm.cu"}) \
        == "replayed"
    assert loaded == ["rms_norm.cu"]
    with pytest.raises(mx.MXNetError, match="jpeg_codec"):
        _build.warm_spec({"build": "b0", "lib": "jpeg_codec.cu"})
    assert _build.warm_spec({"build": "b1", "lib": "rms_norm.cu"}) \
        == "skipped"
    assert loaded == ["rms_norm.cu"]


def test_first_train_step_event_is_marked():
    x, y = _batch()
    _make_step()(x, y)
    assert "first_train_step" in compiler.events()


# ---------------------------------------------------------------------------
# the disk tier
# ---------------------------------------------------------------------------

def _fill(path: pathlib.Path, nbytes: int, used: float) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"x" * nbytes)
    os.utime(path, (used, used))


def test_gc_evicts_least_recently_used_past_cap(tmp_path):
    for i in range(4):
        d = tmp_path / "kernels" / f"build{i}"
        _fill(d / "libk.so", 100, 10 + i)
        _fill(d / persistent.USED_STAMP, 0, 10 + i)
    for i in range(3):
        _fill(tmp_path / "nvrtc" / "sm_90-12.8" / f"fp{i}.cubin", 100,
              20 + i)
    # the live build is the oldest, and is kept
    removed = persistent.gc_cache(max_bytes=350, directory=tmp_path,
                                  keep={"build0"})
    assert removed == 4
    left = sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*") if p.is_file()
                  and p.name != persistent.USED_STAMP)
    assert left == ["kernels/build0/libk.so", "nvrtc/sm_90-12.8/fp1.cubin",
                    "nvrtc/sm_90-12.8/fp2.cubin"]
    assert persistent.stats(tmp_path) == {"dir": str(tmp_path),
                                          "entries": 3, "bytes": 300}


def test_gc_keeps_the_running_sources_build(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_XLA_CACHE_DIR", str(tmp_path))
    live = _build.build_dir()
    assert live.parent == tmp_path / "kernels"
    _fill(live / "librms_norm.so", 1000, 1)
    _fill(tmp_path / "kernels" / "old" / "librms_norm.so", 10, 5)
    assert persistent.gc_cache(max_bytes=1) == 1
    assert live.exists() and not (tmp_path / "kernels" / "old").exists()
    assert persistent.gc_cache(max_bytes=0) == 0     # 0: no collection


def test_nvrtc_key_distinguishes_every_component():
    base = ("src", ("-O3",), ("k<float>",), "sm_90a", "sm_90", "12.8")
    k = rtc.cubin_key(*base)
    for i, other in enumerate([("src2",), (("-O2",),), (("k<int>",),),
                               ("sm_80",), ("sm_80",), ("12.9",)]):
        mutated = list(base)
        mutated[i] = other[0]
        assert rtc.cubin_key(*mutated) != k
    assert rtc.cubin_key(*base) == k


def test_nvrtc_tier_round_trip_and_atomic_write(tmp_path, monkeypatch):
    import ctypes

    monkeypatch.setenv("MXNET_XLA_CACHE_DIR", str(tmp_path))
    fp = rtc.cubin_key("src", (), ("k<float>",), rtc.ARCH, "sm_90", "12.8")
    path = rtc.cubin_path(fp, "sm_90", "12.8")
    assert path == tmp_path / "nvrtc" / "sm_90-12.8" / f"{fp}.cubin"
    assert rtc._read_image(path, ["k<float>"]) is None
    cubin = ctypes.create_string_buffer(b"\x7fELF fake cubin" * 3)
    rtc._write_image(path, cubin, {"k<float>": b"_Z1kIfEvv"})
    got, lowered = rtc._read_image(path, ["k<float>"])
    assert got.raw == cubin.raw and lowered == {"k<float>": b"_Z1kIfEvv"}
    # an entry without its names is incomplete: read as absent
    path.with_suffix(".names").unlink()
    assert rtc._read_image(path, ["k<float>"]) is None
    assert rtc._read_image(path, [])[0].raw == cubin.raw

    # writers racing on one entry: every read is one whole payload
    payloads = [bytes([i]) * 65536 for i in range(8)]
    seen = []

    def write(p):
        for _ in range(20):
            persistent.write_atomic(path, p)

    def read():
        for _ in range(200):
            data = persistent.read_entry(path)
            if data is not None:
                seen.append(data)

    threads = [threading.Thread(target=write, args=(p,)) for p in payloads]
    threads.append(threading.Thread(target=read))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert seen and all(s in payloads for s in seen)
    assert sorted(p.name for p in path.parent.iterdir()) == [path.name]


def test_loading_a_kernel_library_takes_no_lock_twice(tmp_path,
                                                      monkeypatch):
    """``_build.load`` holds the build lock over ``build_dir()``, which
    reads the ``nvcc`` version: that read must not wait on the same lock.
    Without ``nvcc`` here the load ends in an MXNetError (no compiler),
    not in a wait."""
    import shutil

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is here: a load would build the kernels")
    monkeypatch.setenv("MXNET_XLA_CACHE_DIR", str(tmp_path))
    raised = []

    def run():
        try:
            _build.load("rms_norm.cu")
        except mx.MXNetError as err:
            raised.append(err)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "load() waits on its own lock"
    assert raised and "nvcc" in str(raised[0])


def test_disk_tier_knobs(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_XLA_CACHE_DIR", str(tmp_path))
    assert persistent.base_dir() == tmp_path
    assert persistent.kernels_dir() == tmp_path / "kernels"
    monkeypatch.setenv("MXNET_XLA_CACHE", "0")
    assert persistent.cache_dir() is None
    monkeypatch.delenv("MXNET_XLA_CACHE_DIR")
    assert persistent.base_dir() == REPO / "build"
    monkeypatch.setenv("MXNET_XLA_CACHE_MIN_COMPILE_S", "0.5")
    assert persistent.min_compile_s() == 0.5


# ---------------------------------------------------------------------------
# the package stands alone
# ---------------------------------------------------------------------------

def test_compiler_package_imports_no_jax():
    pkg = REPO / "mxnet_tpu_torch" / "compiler"
    for path in sorted(pkg.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "mxnet_tpu"), (path, n)
    code = ("import sys, mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch.compiler import keys, manifest, "
            "persistent, service, flops\n"
            "mx.compiler.warm_start([])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
