"""The port's pretraining driver fed from a record file and writing
checkpoints (``--data <path.rec>``, ``--save-dir``, ``--save-every``),
held against the JAX package's ``tools/pretrain_llama.py`` on the CPU at
the ``tiny`` config.

* the batches equal the JAX tool's ``_make_data`` over the same record
  file, past its end (records shorter than seq + 1 skipped, a partial
  batch at the end dropped, the file reopened);
* the ``.params`` file loads into the JAX package's ``LlamaModel`` with
  the port's weights bit for bit;
* the ``.states`` leaves, after one step from the same weights on the
  same batch, are the JAX ``TrainStep``'s ``_state_leaf_nds`` in order
  and shape exactly, and in value to 1e-4 of each leaf's norm in f32
  (sums in other orders) and 5e-2 in bf16 with f32 masters (the two
  frameworks round the bf16 forward at other places; each master within
  2 lr of theirs, where a near-zero gradient's sign flips, and to 5e-3
  of their norm);
* the driver runs end to end with both flags and prints the JAX tool's
  "saved checkpoint" lines.
"""
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.model_zoo.nlp import llama as jllama

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.recordio import MXRecordIO
from mxnet_tpu_torch.tools import pretrain_llama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = pretrain_llama.CONFIGS["tiny"]
SEQ, BATCH = 16, 2
OPT = {"learning_rate": 3e-4, "wd": 0.1, "beta1": 0.9, "beta2": 0.95,
       "multi_precision": True}


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "_jax_pretrain_llama", os.path.join(REPO, "tools",
                                            "pretrain_llama.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_tokens(path, n=11, seed=0):
    """``n`` records of seeded int32 ids, some shorter than seq + 1."""
    rs = np.random.RandomState(seed)
    w = MXRecordIO(str(path), "w")
    for i in range(n):
        length = SEQ - 3 if i in (2, 7) else SEQ + 1 + rs.randint(0, 5)
        w.write(rs.randint(0, TINY["vocab_size"], length)
                .astype(np.int32).tobytes())
    w.close()


def test_record_batches_are_the_jax_tools(tmp_path):
    rec = tmp_path / "tokens.rec"
    _write_tokens(rec)
    ref = _reference_tool()._make_data(jmx, str(rec), BATCH, SEQ,
                                       TINY["vocab_size"], int_labels=True)
    got = pretrain_llama._make_data(str(rec), BATCH, SEQ,
                                    TINY["vocab_size"], torch.device("cpu"))
    for _ in range(11):                 # 4 batches a pass: over 2 reopens
        jt, jl = next(ref)
        pt, pl = next(got)
        assert pt.dtype == pl.dtype == torch.int32
        np.testing.assert_array_equal(pt.numpy(), jt.asnumpy())
        np.testing.assert_array_equal(pl.numpy(), jl.asnumpy())


def test_synthetic_batches_are_the_jax_tools():
    ref = _reference_tool()._make_data(jmx, "synthetic", BATCH, SEQ,
                                       TINY["vocab_size"], int_labels=True)
    jt, jl = next(ref)
    pt, pl = next(pretrain_llama._make_data(
        "synthetic", BATCH, SEQ, TINY["vocab_size"], torch.device("cpu")))
    np.testing.assert_array_equal(pt.numpy(), jt.asnumpy())
    np.testing.assert_array_equal(pl.numpy(), jl.asnumpy())


def test_a_file_without_a_full_batch_raises(tmp_path):
    rec = tmp_path / "short.rec"
    w = MXRecordIO(str(rec), "w")
    w.write(np.arange(SEQ, dtype=np.int32).tobytes())
    w.close()
    with pytest.raises(mx.MXNetError, match="no 2 records"):
        next(pretrain_llama._make_data(str(rec), BATCH, SEQ, 256,
                                       torch.device("cpu")))


def _named_weights(net):
    return {k: p.tensor.detach().float().numpy()
            for k, p in net._collect_params_with_prefix().items()}


def _jax_step_states(params_file, dtype, tok, lab):
    jnet = jllama.LlamaModel(**TINY, fused_ce=True)
    jnet.initialize()
    z = jmx.nd.zeros((1, 4), dtype="int32")
    jnet(z, z)
    jnet.load_parameters(params_file)
    if dtype != "float32":
        jnet.cast(dtype)
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step = jpar.TrainStep(jnet, lambda outs, *a: outs, "adamw", mesh=mesh,
                          loss_only=True, optimizer_params=dict(OPT))
    step((jmx.nd.array(tok, dtype="int32"),
          jmx.nd.array(lab, dtype="int32")), ())
    return ([s.asnumpy().astype(np.float32) for s in step._state_leaf_nds],
            step.optimizer.num_update)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_files_are_the_jax_tools(tmp_path, dtype):
    """One step from the same weights on the same batch in each package;
    the port writes its two files through the driver's ``_save``."""
    net, step = pretrain_llama.build("tiny", ctx=mx.cpu(), dtype=dtype)
    w0 = str(tmp_path / "w0.params")
    net.save_parameters(w0)
    rs = np.random.RandomState(9)
    toks = rs.randint(0, TINY["vocab_size"], (BATCH, SEQ + 1))
    tok = toks[:, :-1].astype(np.int32)
    lab = toks[:, 1:].astype(np.int32)
    step((torch.from_numpy(tok), torch.from_numpy(lab)), ())
    paths = pretrain_llama._save(net, step, str(tmp_path / "ckpt"), 1)
    assert [os.path.basename(p) for p in paths] == [
        "llama-0000001.params", "llama-0000001.states"]

    # .params: the JAX model loads the port's weights bit for bit
    jnet = jllama.LlamaModel(**TINY, fused_ce=True)
    jnet.initialize()
    z = jmx.nd.zeros((1, 4), dtype="int32")
    jnet(z, z)
    jnet.load_parameters(paths[0])
    want = _named_weights(net)
    got = {k: p.data().asnumpy().astype(np.float32)
           for k, p in jnet._collect_params_with_prefix().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # .states: the JAX step's leaves, in order and shape
    with open(paths[1], "rb") as f:
        saved = pickle.load(f)
    jleaves, jn = _jax_step_states(w0, dtype, tok, lab)
    assert saved["num_update"] == jn == 1
    leaves = saved["leaves"]
    assert [a.shape for a in leaves] == [a.shape for a in jleaves]
    assert all(a.dtype == np.float32 for a in leaves)
    per = 3 if dtype == "bfloat16" else 2
    assert len(leaves) == per * len(list(net.parameters()))
    for i, (a, b) in enumerate(zip(leaves, jleaves)):
        if per == 3 and i % 3 == 0:            # the f32 master
            # AdamW's first step moves each weight by about +-lr; where a
            # gradient is near 0 its sign can differ between the two
            # bf16 forwards: within 2 lr, and most masters equal
            d = np.abs(a - b)
            assert d.max() <= 2 * OPT["learning_rate"] + 1e-6, (i, d.max())
            err = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert err <= 5e-3, (i, err)
            continue
        tol = 1e-4 if dtype == "float32" else 5e-2
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= tol, (i, err)


def test_the_driver_trains_from_records_and_saves(tmp_path):
    """``python -m mxnet_tpu_torch.tools.pretrain_llama --config tiny
    --ctx cpu --data <rec> --save-dir <dir> --save-every 2 --steps 3``:
    finite losses, the first one the loss of the file's first batch, and
    checkpoints at steps 2 and 3 (the last)."""
    rec = tmp_path / "tokens.rec"
    rs = np.random.RandomState(1)
    w = MXRecordIO(str(rec), "w")
    for _ in range(8):
        w.write(rs.randint(0, 256, 129).astype(np.int32).tobytes())
    w.close()
    ckpt = tmp_path / "ckpt"
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.pretrain_llama",
         "--config", "tiny", "--steps", "3", "--ctx", "cpu", "--data",
         str(rec), "--save-dir", str(ckpt), "--save-every", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert f"saved checkpoint @ step 2 -> {ckpt}" in lines
    assert f"saved checkpoint @ step 3 -> {ckpt}" in lines
    rec_out = json.loads(lines[-1])
    assert len(rec_out["losses"]) == 3 and all(np.isfinite(rec_out["losses"]))
    assert sorted(os.listdir(ckpt)) == [
        "llama-0000002.params", "llama-0000002.states",
        "llama-0000003.params", "llama-0000003.states"]
    # the first loss is the first batch's, from the seed-0 weights
    net, step = pretrain_llama.build("tiny", ctx=mx.cpu())
    tok, lab = next(pretrain_llama._make_data(str(rec), 2, 128, 256,
                                              torch.device("cpu")))
    assert float(step((tok, lab), ())[0]) == rec_out["losses"][0]


def test_a_checkpoint_inside_the_span_keeps_the_steps_time(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """``--steps 4 --save-every 1``: the saves at steps 3 and 4 fall in
    the synced span (steps 3-4). On a clock that moves only where the
    host waits for the device (each step queues 1 s of device time; a
    save first waits for the queued steps, as the host copy of the
    weights does, then writes for 5 s), tokens/s is batch * seq a
    second: each step's time stays in the span and only the writes
    leave it."""
    import types

    clock = {"t": 0.0, "queued": 0.0}

    def drain():
        clock["t"] += clock["queued"]
        clock["queued"] = 0.0

    real_build = pretrain_llama.build

    def build(*args, **kw):
        net, step = real_build(*args, **kw)

        def queued(*a, **k):
            clock["queued"] += 1.0
            return step(*a, **k)
        return net, queued

    saved = []

    def save(net, step, save_dir, i):
        drain()
        clock["t"] += 5.0
        saved.append(i)

    monkeypatch.setattr(pretrain_llama, "build", build)
    monkeypatch.setattr(pretrain_llama, "_save", save)
    monkeypatch.setattr(pretrain_llama, "_sync", lambda device: drain())
    monkeypatch.setattr(pretrain_llama, "time", types.SimpleNamespace(
        perf_counter=lambda: clock["t"]))
    assert pretrain_llama.main(["--config", "tiny", "--ctx", "cpu",
                                "--steps", "4", "--save-dir",
                                str(tmp_path), "--save-every", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert saved == [2, 3, 4]
    assert rec["tokens_per_sec"] == 2 * 128          # batch 2 x seq 128


class _Built(Exception):
    pass


@pytest.mark.parametrize("flags,want", [
    ([], "full"), (["--no-remat"], None), (["--remat"], "full"),
    (["--remat", "dots"], "dots")])
def test_the_remat_flags_reach_the_model(flags, want, monkeypatch):
    """``--no-remat`` on a config whose default is remat builds the model
    without it (the driver resolved the flag, then ``build`` took the
    resolved None for "absent" and turned remat back on)."""
    seen = []

    def spy(config, **kw):
        seen.append(pretrain_llama.resolve_remat(config, kw["remat"]))
        raise _Built

    monkeypatch.setattr(pretrain_llama, "build", spy)
    with pytest.raises(_Built):
        pretrain_llama.main(["--config", "proxy1b", "--ctx", "cpu",
                             "--steps", "1"] + flags)
    assert seen == [want]
