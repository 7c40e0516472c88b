"""``gluon.parameter.abstract_init`` and ``TrainStep.aot_compile`` of the
port on the ``meta`` device, the port's ``tests/test_aot_compile.py`` at
the same tiny Llama (vocab 256, 2 layers, units 64, GQA 4/2, remat):

* nothing is materialised: every parameter is a ``meta`` tensor before
  and after ``aot_compile``, and a read of a value raises;
* the AOT instance refuses to train, naming ``aot_compile``;
* the AOT state layout equals the port's live ``TrainStep``'s and the
  JAX package's live ``TrainStep``'s on one CPU device (its
  ``_state_meta`` and state leaves; the JAX package's own
  ``aot_compile`` tests need an 8-device mesh, so its live step is the
  oracle);
* the argument bytes are the parameters, masters, moments and batch;
* ``telemetry.xla_cost_analysis`` equals the analytic count on the CPU
  and on ``meta`` (every weight matrix's 6·tokens, the causal flash
  forward and backward 6·B·S²·units a layer), with no update run, and
  the AOT step's ``cost_analysis`` is the same count;
* ``first_train_step`` is marked; ``--compile-only`` prints its line.
"""
import json
import pathlib
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
from mxnet_tpu_torch import compiler, telemetry
from mxnet_tpu_torch.gluon.model_zoo.nlp import LlamaModel
from mxnet_tpu_torch.gluon.parameter import abstract_init
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.tools import pretrain_llama

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=256, num_layers=2, units=64, hidden_size=128,
           num_heads=4, num_kv_heads=2)
BATCH, SEQ = 4, 128
OPT = {"learning_rate": 1e-4, "multi_precision": True}
TOK = (torch.Size([BATCH, SEQ]), torch.int32)


def _abstract_net(remat=True):
    with abstract_init():
        net = LlamaModel(**CFG, remat=remat, fused_ce=True,
                         dtype=torch.bfloat16, ctx=mx.cpu())
    return net


def _step(net):
    return TrainStep(net, pretrain_llama._FusedLossPassthrough(), "adamw",
                     loss_only=True, optimizer_params=dict(OPT))


def _aot(remat=True):
    net = _abstract_net(remat)
    step = _step(net)
    return net, step, step.aot_compile((TOK, TOK), ())


def _live_net(seed=0):
    return LlamaModel(**CFG, fused_ce=True, dtype=torch.bfloat16,
                      ctx=mx.cpu(),
                      generator=torch.Generator().manual_seed(seed))


def _tokens():
    rs = np.random.RandomState(3)
    toks = rs.randint(0, CFG["vocab_size"], (BATCH, SEQ + 1))
    return (torch.from_numpy(toks[:, :-1].astype(np.int32)),
            torch.from_numpy(toks[:, 1:].astype(np.int32)))


def _analytic_flops(batch=BATCH, seq=SEQ):
    """6·tokens per weight-matrix element (forward 2, backward 4; the
    embedding table is a gather, the norm weights elementwise) and the
    causal flash forward and backward, 2 + 4 of B·S²·units a layer."""
    u, h, v = CFG["units"], CFG["hidden_size"], CFG["vocab_size"]
    kv = CFG["num_kv_heads"] * (u // CFG["num_heads"])
    matrices = CFG["num_layers"] * (u * u + u * 2 * kv + u * u
                                    + 2 * u * h + h * u) + v * u
    return (6 * matrices * batch * seq
            + 6 * CFG["num_layers"] * batch * seq * seq * u)


def test_abstract_init_never_materializes():
    net, step, _ = _aot()
    params = list(net.collect_params().values())
    assert len(params) == 4 + CFG["num_layers"] * 7 - 1
    for p in params:
        assert p.tensor.is_meta and p._abstract
        with pytest.raises(mx.MXNetError, match="abstract_init"):
            p.data()
    assert all(t.is_meta for t in step._argument_tensors())
    with pytest.raises(mx.MXNetError, match="abstract_init"):
        net.save_parameters(str(REPO / "build" / "never.params"))


def test_a_shape_settled_outside_the_context_stays_abstract():
    with abstract_init():
        d = mx.gluon.nn.Dense(8)
        d.initialize(ctx=mx.cpu())
    assert d.weight._var is None                 # deferred: in_units = 0
    out = d(torch.zeros(2, 5, device="meta"))    # settles after the scope
    assert out.is_meta and d.weight.tensor.is_meta
    assert d.weight.tensor.shape == (8, 5)


def test_aot_instance_refuses_to_train():
    _, step, _ = _aot()
    tok, lab = _tokens()
    with pytest.raises(mx.MXNetError, match="aot_compile"):
        step((tok, lab), ())
    with pytest.raises(mx.MXNetError, match="aot_compile"):
        step.warm((TOK, TOK))


def test_aot_compile_needs_an_abstract_net():
    step = _step(_live_net())
    with pytest.raises(mx.MXNetError, match="abstract_init"):
        step.aot_compile((TOK, TOK), ())


def _jax_state_layout():
    """Per trainable parameter (by name without the model prefix), the
    shapes of the JAX package's live TrainStep's state leaves, on one
    CPU device, bf16 with f32 masters."""
    jnet = jllama.LlamaModel(**CFG, fused_ce=True)
    jnet.initialize()
    tok = jmx.nd.zeros((1, 4), dtype="int32")
    jnet(tok, tok)
    jnet.cast("bfloat16")
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step = jpar.TrainStep(jnet, lambda outs, *a: outs, "adamw", mesh=mesh,
                          loss_only=True, optimizer_params=dict(OPT))
    batch = (jmx.nd.zeros((BATCH, SEQ), dtype="int32"),
             jmx.nd.zeros((BATCH, SEQ), dtype="int32"))
    step(batch, ())
    names = list(jnet.collect_params().keys())
    leaves = [tuple(s.shape) for s in step._state_leaf_nds]
    out, at = {}, 0
    for i, (_, present, _) in zip(step._trainable, step._state_meta):
        n = sum(present)
        out[names[i][names[i].index("_") + 1:]] = leaves[at:at + n]
        at += n
    assert at == len(leaves)
    return out


def _port_layout(net, step):
    names = {id(p.tensor): n[n.index("_") + 1:]
             for n, p in net.collect_params().items()}
    return {names[id(p)]: shapes
            for p, shapes in zip(step._params, step.state_layout())}


def test_aot_state_layout_matches_live_training():
    net, step, _ = _aot()
    aot = _port_layout(net, step)
    live_net = _live_net()
    live = _step(live_net)
    live(_tokens(), ())
    assert aot == _port_layout(live_net, live)
    assert aot == _jax_state_layout()
    # bf16 weights: an f32 master and two f32 moments each
    assert all(len(s) == 3 for s in aot.values())
    assert all(t.dtype == torch.float32 for st in live._states
               for t in (st[0], *st[1]))


def test_aot_argument_bytes_are_params_states_and_batch():
    net, step, compiled = _aot()
    mem = compiled.memory_analysis()
    n = pretrain_llama.param_count(dict(CFG, rope_theta=1e4))
    assert sum(p.numel() for p in net.parameters()) == n
    assert mem.argument_size_in_bytes == n * 14 + 2 * BATCH * SEQ * 4
    live = _step(_live_net())
    assert live.argument_bytes((TOK, TOK), ()) == mem.argument_size_in_bytes
    assert mem.output_size_in_bytes == 4          # the f32 loss
    # remat saves less for the backward than no remat
    _, _, plain = _aot(remat=False)
    assert 0 < mem.temp_size_in_bytes \
        < plain.memory_analysis().temp_size_in_bytes


def test_flop_count_is_analytic_on_the_cpu_and_on_meta():
    want = _analytic_flops()
    _, _, compiled = _aot()
    assert compiled.cost_analysis() == {"flops": float(want)}
    live_net = _live_net()
    step = _step(live_net)
    before = [p.detach().clone() for p in step._params]
    assert telemetry.xla_cost_analysis(step, (_tokens(), ())) \
        == {"flops": float(want)}
    # no update ran, nothing of the step moved
    assert step.optimizer.num_update == 0 and step._states is None
    assert all(torch.equal(a, p) for a, p in zip(before, step._params))
    assert step.count_flops(_tokens(), (), meta=False) == want
    # remat's recompute is not counted
    remat_step = _step(LlamaModel(**CFG, fused_ce=True, remat=True,
                                  dtype=torch.bfloat16, ctx=mx.cpu(),
                                  generator=torch.Generator().manual_seed(0)))
    assert remat_step.count_flops(_tokens(), (), meta=False) == want
    tt = telemetry.TrainingTelemetry.for_step(step, (_tokens(), ()),
                                              batch_size=BATCH)
    assert tt.flops_per_step == want


def test_first_train_step_is_marked():
    step = _step(_live_net())
    loss, _ = step(_tokens(), ())
    assert np.isfinite(float(loss))
    assert "first_train_step" in compiler.events()


def test_compile_only_prints_the_references_line():
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.pretrain_llama",
         "--config", "tiny", "--compile-only", "--ctx", "cpu", "--batch",
         str(BATCH), "--seq", str(SEQ)], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    for k in ("config", "compile_only", "params", "mesh", "batch", "seq",
              "remat", "compile_s", "argument_bytes_per_device",
              "temp_bytes_per_device"):
        assert k in rec, k
    n = pretrain_llama.param_count(pretrain_llama.CONFIGS["tiny"])
    assert rec["params"] == rec["params_in_net"] == n
    assert rec["mesh"] == {} and rec["compile_only"] is True
    assert rec["argument_bytes_per_device"] == n * 14 + 2 * BATCH * SEQ * 4
    assert rec["flops_per_step"] == _analytic_flops()
    assert rec["fits"] is None and rec["device"] == "cpu"
