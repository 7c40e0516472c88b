"""The port's data-parallel comms across processes, on the CPU: gloo
workers started by the port's own launcher
(``python -m mxnet_tpu_torch.tools.launch``).

The workers import neither ``jax`` nor ``mxnet_tpu`` (each reports it);
the rendezvous port is picked by binding port 0 and every launch has its
own timeout. The contracts:

* at world 3 (where a plain ``dist.all_reduce`` sums a flat bucket and a
  key alone in different orders), the per-key, bucketed, zero1 and zero2
  exchanges give bit-identical parameters after 3 Adam steps, on every
  rank;
* world-2 ``Trainer(kvstore='dist_device_sync')`` steps equal the in-process
  2-context steps (``cpu(0)``, ``cpu(1)``) bit for bit;
* a zero1 state saved per rank at world 3 resumes at world 2
  (``load_states_resharded``), and its next step equals the in-process
  2-context zero1 trainer's that loaded the same files;
* a barrier a rank never reaches raises ``BarrierTimeoutError`` naming
  it within its bound;
* the launcher's fail-fast exit code, restart, ``--report`` and ssh mode
  (a stub ``ssh``), and the refusal of ``dist_async``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one source for the workers and for the in-process runs of this file
WORKER = r'''
import hashlib, json, os, sys, warnings
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.loss import L2Loss

GLOBAL_BATCH = 6
ADAM = ("adam", {"learning_rate": 0.01, "wd": 0.001})
SGD = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.001})


def build(ctx):
    """A two-layer MLP of about 1M parameters (sizes the worlds 2 and 3
    do not divide), weights from a fixed seed, on ``ctx``."""
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(1001, in_units=997, activation="relu"),
                nn.Dense(7, in_units=1001))
        net.initialize(ctx=ctx)
        rs = np.random.RandomState(0)
        for p in net.collect_params().values():
            p.set_data((rs.randn(*p.shape) * 0.05).astype(np.float32))
    return net


def batch(step):
    rs = np.random.RandomState(100 + step)
    return (rs.randn(GLOBAL_BATCH, 997).astype(np.float32),
            rs.randn(GLOBAL_BATCH, 7).astype(np.float32))


def weights(net, ctx=None):
    return [p.data(ctx).asnumpy().copy()
            for p in net.collect_params().values()]


def digest(ws):
    h = hashlib.sha256()
    for w in ws:
        h.update(np.ascontiguousarray(w).tobytes())
    return h.hexdigest()


def step(net, tr, s, parts):
    """One step on this process's contexts: ``parts`` = [(ctx, lo, hi)]
    slices of the global batch."""
    x, y = batch(s)
    lf = L2Loss()
    with autograd.record():
        ls = [lf(net(mx.nd.array(x[lo:hi], ctx=c)),
                 mx.nd.array(y[lo:hi], ctx=c)) for c, lo, hi in parts]
    autograd.backward(ls)
    tr.step(GLOBAL_BATCH)


def train(kvstore, ctxs, parts, steps, opt=ADAM, bucket_mb=25,
          partition=None, net=None, tr=None, first=0):
    os.environ["MXNET_KV_BUCKET_MB"] = str(bucket_mb)
    net = net or build(ctxs)
    tr = tr or gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]),
                             kvstore=kvstore, partition=partition)
    for s in range(first, first + steps):
        step(net, tr, s, parts)
    return net, tr


def rank_parts(world, rank):
    n = GLOBAL_BATCH // world
    return [(mx.cpu(), rank * n, (rank + 1) * n)]


def inproc_parts(n):
    k = GLOBAL_BATCH // n
    return [(mx.cpu(i), i * k, (i + 1) * k) for i in range(n)]


def main():
    warnings.simplefilter("ignore")
    mode, out_dir = sys.argv[1], sys.argv[2]
    rank = int(os.environ["DMLC_WORKER_ID"])
    world = int(os.environ["DMLC_NUM_WORKER"])
    res = {"rank": rank, "world": world,
           "foreign": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "mxnet_tpu"))}
    parts = rank_parts(world, rank)
    if mode == "modes":
        res["digests"] = {}
        for name, kw in (("per_key", {"bucket_mb": 0}), ("bucketed", {}),
                         ("zero1", {"partition": "zero1"}),
                         ("zero2", {"partition": "zero2"})):
            net, tr = train("dist_sync", mx.cpu(), parts, 3, **kw)
            res["digests"][name] = digest(weights(net))
            if name == "zero1":
                tr.save_states(os.path.join(out_dir, f"zero-{rank}.states"))
                if rank == 0:
                    net.save_parameters(os.path.join(out_dir, "w3.params"))
                res["zero_world"] = tr._zero.world
    elif mode == "trainer":
        net, _ = train("dist_device_sync", mx.cpu(), parts, 3, opt=SGD)
        res["digest"] = digest(weights(net))
        if rank == 0:
            np.savez(os.path.join(out_dir, "w2.npz"), *weights(net))
    elif mode == "resume":
        net = build(mx.cpu())
        net.load_parameters(os.path.join(out_dir, "w3.params"))
        tr = gluon.Trainer(net.collect_params(), ADAM[0], dict(ADAM[1]),
                           kvstore="dist_sync", partition="zero1")
        tr.load_states_resharded(
            [os.path.join(out_dir, f"zero-{r}.states") for r in range(3)])
        train(None, None, parts, 1, net=net, tr=tr, first=3)
        if rank == 0:
            np.savez(os.path.join(out_dir, "resumed.npz"), *weights(net))
        res["zero_world"] = tr._zero.world
    elif mode == "barrier":
        import time
        store = mx.kv.create("dist_sync")
        if rank == 0:
            t0 = time.monotonic()
            try:
                store.barrier(site="probe", timeout=1.5)
                res["raised"] = None
            except mx.kvstore.BarrierTimeoutError as e:
                res["raised"] = str(e)
            res["elapsed"] = time.monotonic() - t0
        else:
            time.sleep(2.5)
    # one write per line: the ranks share the launcher's stdout
    sys.stdout.write("RESULT " + json.dumps(res) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
'''


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MXNET_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["MXNET_KV_BARRIER_TIMEOUT"] = "60"
    env["MXNET_KV_EXIT_BARRIER_TIMEOUT"] = "5"
    return env


def _launch(args, timeout=120, env=None):
    # by its path: ``-m mxnet_tpu_torch.tools.launch`` would import the
    # package (and torch) into the supervisor first
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "mxnet_tpu_torch", "tools",
                                      "launch.py"), *args],
        cwd=REPO, env=env or _env(), capture_output=True, text=True,
        timeout=timeout)


def _results(out, world):
    res = [json.loads(line[len("RESULT "):])
           for line in out.stdout.splitlines() if line.startswith("RESULT ")]
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert sorted(r["rank"] for r in res) == list(range(world)), \
        out.stdout[-3000:] + out.stderr[-3000:]
    for r in res:
        assert r["foreign"] == [], r
    return sorted(res, key=lambda r: r["rank"])


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    path = d / "worker.py"
    path.write_text(WORKER)
    return d, path


@pytest.fixture(scope="module")
def world3(worker):
    d, path = worker
    out = _launch(["-n", "3", sys.executable, str(path), "modes", str(d)],
                  timeout=240)
    return d, _results(out, 3)


def _inproc():
    ns = {"__name__": "dist_worker"}
    exec(compile(WORKER, "dist_worker", "exec"), ns)
    return ns


def test_world3_per_key_bucketed_zero1_zero2_bit_identical(world3):
    _, res = world3
    for r in res:
        d = r["digests"]
        assert d["per_key"] == d["bucketed"] == d["zero1"] == d["zero2"], r
        assert r["zero_world"] == 3
    assert len({r["digests"]["per_key"] for r in res}) == 1


def test_world2_trainer_equals_inprocess_two_contexts(worker):
    d, path = worker
    res = _results(_launch(["-n", "2", sys.executable, str(path),
                            "trainer", str(d)]), 2)
    assert res[0]["digest"] == res[1]["digest"]
    ns = _inproc()
    mx = ns["mx"]
    net, _ = ns["train"]("device", [mx.cpu(0), mx.cpu(1)],
                         ns["inproc_parts"](2), 3, opt=ns["SGD"])
    got = np.load(d / "w2.npz")
    for i, w in enumerate(ns["weights"](net)):
        np.testing.assert_array_equal(got[f"arr_{i}"], w)
    assert ns["digest"](ns["weights"](net, mx.cpu(1))) == res[0]["digest"]


def test_world3_zero_state_resumes_at_world2(world3):
    d, _ = world3
    path = d / "worker.py"
    res = _results(_launch(["-n", "2", sys.executable, str(path), "resume",
                            str(d)]), 2)
    assert all(r["zero_world"] == 2 for r in res)
    ns = _inproc()
    mx, gluon = ns["mx"], ns["gluon"]
    ctxs = [mx.cpu(0), mx.cpu(1)]
    net = ns["build"](ctxs)
    net.load_parameters(str(d / "w3.params"), ctx=ctxs)
    tr = gluon.Trainer(net.collect_params(), ns["ADAM"][0],
                       dict(ns["ADAM"][1]), kvstore="tpu_sync",
                       partition="zero1")
    tr.load_states_resharded([str(d / f"zero-{r}.states") for r in range(3)])
    ns["train"](None, None, ns["inproc_parts"](2), 1, net=net, tr=tr,
                first=3)
    got = np.load(d / "resumed.npz")
    for i, w in enumerate(ns["weights"](net)):
        np.testing.assert_array_equal(got[f"arr_{i}"], w)


def test_barrier_names_the_missing_rank_within_its_bound(worker):
    d, path = worker
    res = _results(_launch(["-n", "2", sys.executable, str(path), "barrier",
                            str(d)]), 2)
    msg = res[0]["raised"]
    assert msg is not None and "missing ranks [1]" in msg and "probe" in msg
    assert res[0]["elapsed"] < 10.0


_TRIVIAL = r'''
import json, os, sys, time
rank = int(os.environ["DMLC_WORKER_ID"])
inc = int(os.environ.get("MXNET_ELASTIC_RESTART", "0"))
mode = sys.argv[1]
def say(line):                          # one write: the ranks share stdout
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
say("ENV " + json.dumps({k: os.environ[k] for k in os.environ
                         if k.startswith("DMLC_")}))
if mode == "fail" and rank == 1:
    time.sleep(1.0)                     # rank 0 has printed by then
    sys.exit(3)
if mode == "fail":
    time.sleep(60)
if mode == "restart" and rank == 1 and inc == 0:
    sys.exit(1)
say(f"DONE {rank} {inc}")
'''


@pytest.fixture(scope="module")
def trivial(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch")
    (d / "w.py").write_text(_TRIVIAL)
    return d


def test_launcher_fails_fast_with_the_failing_rank_code(trivial):
    out = _launch(["-n", "2", "--term-window", "2", sys.executable,
                   str(trivial / "w.py"), "fail"], timeout=60)
    assert out.returncode == 3, out.stdout + out.stderr
    env = [json.loads(line[4:]) for line in out.stdout.splitlines()
           if line.startswith("ENV ")]
    assert {e["DMLC_WORKER_ID"] for e in env} == {"0", "1"}, out.stdout
    assert all(e["DMLC_NUM_WORKER"] == "2" and int(e["DMLC_PS_ROOT_PORT"]) > 0
               for e in env)


def test_launcher_restarts_and_writes_its_report(trivial):
    report = trivial / "report.json"
    out = _launch(["-n", "2", "--max-restarts", "1", "--restart-backoff",
                   "0.1", "--report", str(report), sys.executable,
                   str(trivial / "w.py"), "restart"], timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DONE 1 1" in out.stdout and "DONE 0 0" in out.stdout
    rep = json.loads(report.read_text())
    text = json.dumps(rep)
    assert '"restarts": 1' in text and '"exit_code": 1' in text


def test_launcher_ssh_mode_dry_run(trivial):
    hostfile = trivial / "hosts"
    hostfile.write_text("127.0.0.1\n127.0.0.1\n")
    stub = trivial / "ssh"
    stub.write_text(
        "#!/bin/sh\n"
        'while [ "$1" = "-o" ]; do shift 2; done\n'
        "host=$1; shift\n"
        'echo "SSH_STUB host=$host" 1>&2\n'
        'exec /bin/sh -c "$*"\n')
    stub.chmod(0o755)
    env = _env()
    env["PATH"] = str(trivial) + os.pathsep + env.get("PATH", "")
    out = _launch(["-n", "2", "-H", str(hostfile), sys.executable,
                   str(trivial / "w.py"), "ok"], timeout=60, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stderr.count("SSH_STUB host=127.0.0.1") == 2
    assert "DONE 0 0" in out.stdout and "DONE 1 0" in out.stdout


def test_dist_async_is_refused():
    import mxnet_tpu_torch as mx

    with pytest.raises(mx.MXNetError, match="dist_async"):
        mx.kv.create("dist_async")
    for name in ("horovod", "byteps", "nope"):
        with pytest.raises(mx.MXNetError):
            mx.kv.create(name)
