"""Rematerialisation (``gluon.block.remat_call``, ``TrainStep(remat=)``,
``LlamaModel(remat=)``) and ``LlamaModel(tie_weights=)`` on the CPU.

Under either policy a step must equal the step without remat bit for
bit: the same ops run on the same inputs, the recompute draws the
forward's dropout seeds again and BatchNorm folds each batch into its
running statistics once. That is checked for a 2-layer Llama (per-block
remat, the whole-net span, and both nested), a 2-layer BERT at dropout
0.1 / 0.1 and ``resnet18_v1`` with its running statistics. The
recompute is seen to run (each block's forward is entered twice a step).
Against the JAX package: the Llama with ``remat`` in each form and the
BERT at dropout 0 against the JAX ``TrainStep(remat=...)`` at the
tolerances of their no-remat tests (losses to 1e-5 relative, each
parameter's delta to 1e-4 of its norm: f32 sums in other orders); the
BERT at dropout 0.1 against the JAX step is
tests/test_torch_dropout.py's, which this file's bit-for-bit equality
carries over to remat.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.model_zoo.nlp import llama as jllama

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import random_state
from mxnet_tpu_torch.convert import (bert_pretrain_params_from_reference,
                                     llama_params_from_reference)
from mxnet_tpu_torch.gluon.block import remat_call, resolve_remat_policy
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.nlp import (BERTForPretrainFused,
                                                 LlamaModel)
from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import LlamaBlock
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet18_v1
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.tools import pretrain_llama

import test_torch_bert_train as bt
import test_torch_llama_train as lt

POLICIES = ["full", "dots"]


def _llama(remat=False, seed=0, **kw):
    return LlamaModel(**lt.TINY, fused_ce=True, remat=remat, ctx=mx.cpu(),
                      generator=torch.Generator().manual_seed(seed), **kw)


def _llama_run(net, steps=3, remat=None, opt="adamw"):
    step = TrainStep(net, pretrain_llama._FusedLossPassthrough(), opt,
                     loss_only=True, optimizer_params=dict(lt.OPT),
                     remat=remat)
    tok, lab = lt._batch(7)
    losses = [step((tok, lab), ())[0] for _ in range(steps)]
    return losses, step


def _same(a_net, b_net, what):
    for (k, a), (_, b) in zip(a_net.state_dict().items(),
                              b_net.state_dict().items()):
        assert torch.equal(a, b), (what, k)


def _count_blocks(net, kind):
    calls = []
    for m in net.modules():
        if isinstance(m, kind):
            m.register_forward_pre_hook(lambda mod, inp: calls.append(1))
    return calls


# ---------------------------------------------------------------------------
# bit for bit against the step without remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,whole", [("full", None), ("dots", None),
                                         (None, "full"), (None, "dots"),
                                         ("full", "full")])
def test_llama_remat_equals_no_remat_bit_for_bit(block, whole):
    """Three f32 AdamW steps of a 2-layer Llama: per-block remat, the
    whole-net span of TrainStep, or both nested, against no remat:
    every loss, gradient and parameter equal bit for bit; each block's
    forward runs twice a step under remat (once in the backward)."""
    ref = _llama()
    plain, pstep = _llama_run(ref, remat=None)
    net = _llama(remat=block or False)
    calls = _count_blocks(net, LlamaBlock)
    got, step = _llama_run(net, remat=whole)
    assert [float(x) for x in got] == [float(x) for x in plain]
    _same(net, ref, (block, whole))
    for p, q in zip(step._params, pstep._params):
        assert torch.equal(p.grad, q.grad)
    layers = lt.TINY["num_layers"]
    per_step = 2 * layers if (block or whole) else layers
    if block and whole:                 # the outer recompute re-enters
        per_step = 3 * layers           # each block, whose own span is
    assert len(calls) == 3 * per_step   # rebuilt, not recomputed again


@pytest.mark.parametrize("policy", POLICIES)
def test_bert_at_dropout_remat_equals_no_remat_bit_for_bit(policy):
    """A 2-layer BERTForPretrainFused at dropout 0.1 / 0.1 under
    ``TrainStep(remat=...)``: the recompute hands every dropout site the
    seed it drew in the forward, so the losses and parameters after
    three Adam steps equal the step without remat bit for bit; the
    recompute hands out no seed the forward did not."""
    cfg = dict(bt.CFG, dropout=0.1, attn_dropout=0.1)
    jnet = bt.jbert.BERTForPretrainFused(**bt.CFG)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8)), jmx.nd.zeros((1, 8)))
    named = bt._draw(jnet, 31)
    tok, lab = bt._batch()
    runs = []
    for remat in (None, policy):
        net = BERTForPretrainFused(ctx=mx.cpu(), **cfg)
        net.load_state_dict(bert_pretrain_params_from_reference(named))
        mx.random.seed(77)
        step = TrainStep(net, lambda outs, *a: outs, "adam", loss_only=True,
                         optimizer_params={"learning_rate": 1e-3},
                         remat=remat)
        drawn = []
        real = random_state.next_seed

        def counting(*a):
            drawn.append(real(*a))
            return drawn[-1]

        random_state.next_seed = counting
        try:
            losses = [float(step((tok, lab), ())[0]) for _ in range(3)]
        finally:
            random_state.next_seed = real
        runs.append((losses, net, drawn))
    (l0, n0, d0), (l1, n1, d1) = runs
    assert l1 == l0
    _same(n1, n0, policy)
    # the recompute hands the forward's seeds out again, one per site
    sites = 1 + 4 * cfg["num_layers"]
    assert set(d1) == set(d0) and len(d1) == len(d0) + 3 * sites
    # dropout acted: the loss differs from the step at dropout 0
    net = BERTForPretrainFused(ctx=mx.cpu(), **bt.CFG)
    net.load_state_dict(bert_pretrain_params_from_reference(named))
    step = TrainStep(net, lambda outs, *a: outs, "adam", loss_only=True,
                     optimizer_params={"learning_rate": 1e-3})
    assert abs(float(step((tok, lab), ())[0]) - l0[0]) > 1e-4


@pytest.mark.parametrize("policy", POLICIES)
def test_resnet_remat_updates_running_statistics_once(policy):
    """resnet18_v1 (thumbnail, 10 classes) under ``TrainStep(remat=...)``
    with SGD momentum: three steps equal the steps without remat bit for
    bit, the running means and variances included: BatchNorm folds each
    batch in once, not again in the recompute."""
    rs = np.random.RandomState(3)
    x = rs.randn(4, 3, 16, 16).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.float32)
    nets = []
    for remat in (None, policy):
        net = resnet18_v1(classes=10, thumbnail=True, ctx=mx.cpu(),
                          generator=torch.Generator().manual_seed(4))
        before = {k: v.clone() for k, v in net.state_dict().items()
                  if "running" in k}
        step = TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                         optimizer_params={"learning_rate": 0.05,
                                           "momentum": 0.9},
                         remat=remat)
        losses = [float(step(x, y)[0]) for _ in range(3)]
        nets.append((losses, net, before))
    (l0, n0, b0), (l1, n1, _) = nets
    assert l1 == l0
    _same(n1, n0, policy)
    moved = [k for k, v in n0.state_dict().items()
             if "running" in k and not torch.equal(v, b0[k])]
    assert len(moved) == len(b0)


def test_remat_is_a_plain_call_unless_autograd_records():
    """Under ``torch.no_grad()``, on NDArrays, or with nothing requiring
    grad, ``remat_call`` is the block's call (no second forward); an
    unknown policy raises the reference's ValueError everywhere."""
    net = _llama(remat="full")
    calls = _count_blocks(net, LlamaBlock)
    tok, lab = lt._batch(3)
    tok, lab = torch.from_numpy(tok), torch.from_numpy(lab)
    with torch.no_grad():
        a = net(tok, lab)
    for p in net.parameters():
        p.requires_grad_(False)
    b = net(tok, lab)
    assert torch.equal(a, b) and len(calls) == 2 * lt.TINY["num_layers"]
    blk = net.blocks[0]
    x = torch.randn(1, 4, lt.TINY["units"])
    assert torch.equal(remat_call(blk, x, policy="dots"), blk(x))
    for bad in ("sometimes", 3):
        with pytest.raises(ValueError, match="unknown remat policy"):
            resolve_remat_policy(bad)
        with pytest.raises(ValueError, match="unknown remat policy"):
            remat_call(blk, x, policy=bad)
        with pytest.raises(ValueError, match="unknown remat policy"):
            TrainStep(net, pretrain_llama._FusedLossPassthrough(), "sgd",
                      remat=bad)
    # the model takes a bool or a policy name, as the reference's does
    with pytest.raises(ValueError, match="unknown remat policy"):
        _llama(remat="sometimes")
    with pytest.raises(ValueError, match="unknown remat policy"):
        jpar.TrainStep(jllama.LlamaModel(**lt.TINY), lambda o, *a: o,
                       "sgd", remat="sometimes")


def test_pretrain_tool_remat_flags():
    """``--remat`` defaults as the JAX tool's (on for every config but
    tiny), ``--remat dots`` picks the policy, ``--no-remat`` turns it
    off; the model built carries it."""
    assert pretrain_llama.resolve_remat("proxy1b", None) == "full"
    assert pretrain_llama.resolve_remat("tiny", None) is None
    assert pretrain_llama.resolve_remat("tiny", True) == "full"
    assert pretrain_llama.resolve_remat("proxy1b", "dots") == "dots"
    assert pretrain_llama.resolve_remat("proxy1b", False) is None
    net, _ = pretrain_llama.build("tiny", ctx=mx.cpu(), dtype="float32",
                                  remat="dots")
    assert net._remat == "dots"


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _jax_llama_train(named, steps, remat_model, remat_step):
    jnet = jllama.LlamaModel(**lt.TINY, fused_ce=True, remat=remat_model)
    jnet.initialize()
    tok0 = jmx.nd.zeros((1, 4), dtype="int32")
    jnet(tok0, tok0)
    by_suffix = {n[n.index("_") + 1:]: a for n, a in named.items()}
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(by_suffix[name[name.index("_") + 1:]]))
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step = jpar.TrainStep(jnet, lambda outs, *a: outs, "adamw", mesh=mesh,
                          loss_only=True, optimizer_params=dict(lt.OPT),
                          remat=remat_step)
    tok, lab = lt._batch(7)
    batch = (jmx.nd.array(tok, dtype="int32"),
             jmx.nd.array(lab, dtype="int32"))
    losses = [float(step(batch, ())[0].asnumpy()) for _ in range(steps)]
    params = {n: p.data().asnumpy().astype(np.float32)
              for n, p in jnet.collect_params().items()}
    prefix = next(iter(named))[:next(iter(named)).index("_") + 1]
    return losses, {prefix + n[n.index("_") + 1:]: a
                    for n, a in params.items()}


def _deltas_close(named, want_params, net, carry):
    sd = carry(named)
    moved = carry(want_params)
    got = net.state_dict()
    for key, w0 in sd.items():
        dj = moved[key].numpy() - w0.numpy()
        dp = got[key].detach().numpy() - w0.numpy()
        norm = float(np.linalg.norm(dj))
        if norm == 0.0:
            continue
        assert float(np.linalg.norm(dp - dj)) / norm < 1e-4, key


@pytest.mark.parametrize("remat_model,remat_step", [
    (True, None), ("dots", None), (False, "full"), (False, "dots")])
def test_llama_remat_matches_the_jax_trainstep(remat_model, remat_step):
    _, named = lt._jax_llama(fused_ce=True)
    jlosses, jparams = _jax_llama_train(named, 3, remat_model, remat_step)
    net = LlamaModel(**lt.TINY, fused_ce=True, remat=remat_model,
                     ctx=mx.cpu())
    net.load_state_dict(llama_params_from_reference(named))
    plosses, _ = _llama_run(net, remat=remat_step)
    np.testing.assert_allclose([float(x) for x in plosses], jlosses,
                               rtol=1e-5)
    _deltas_close(named, jparams, net, llama_params_from_reference)


@pytest.mark.parametrize("policy", POLICIES)
def test_bert_remat_matches_the_jax_trainstep(policy):
    jnet = bt.jbert.BERTForPretrainFused(**bt.CFG)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8)), jmx.nd.zeros((1, 8)))
    named = bt._draw(jnet, 31)
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = jpar.TrainStep(jnet, lambda outs, *a: outs, "adam", mesh=mesh,
                           loss_only=True,
                           optimizer_params={"learning_rate": 1e-3},
                           remat=policy)
    tok, lab = bt._batch()
    jlosses = [float(jstep((jmx.nd.array(tok), jmx.nd.array(lab)),
                           ())[0].asnumpy()) for _ in range(2)]
    jparams = {n: p.data().asnumpy() for n, p in
               jnet.collect_params().items()}
    net = BERTForPretrainFused(ctx=mx.cpu(), **bt.CFG)
    net.load_state_dict(bert_pretrain_params_from_reference(named))
    step = TrainStep(net, lambda outs, *a: outs, "adam", loss_only=True,
                     optimizer_params={"learning_rate": 1e-3}, remat=policy)
    plosses = [float(step((tok, lab), ())[0]) for _ in range(2)]
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    sd0 = bert_pretrain_params_from_reference(named)
    want = bert_pretrain_params_from_reference(jparams)
    got = net.state_dict()
    units = bt.CFG["units"]
    for key, w0 in sd0.items():
        dj = want[key].numpy() - w0.numpy()
        dp = got[key].detach().numpy() - w0.numpy()
        if key.endswith("qkv_proj.bias"):
            # the key third's true gradient is 0: Adam moves it on noise
            k_part = slice(units, 2 * units)
            dj, dp = np.delete(dj, k_part), np.delete(dp, k_part)
        norm = float(np.linalg.norm(dj))
        if norm:
            assert float(np.linalg.norm(dp - dj)) / norm < 1e-4, key


# ---------------------------------------------------------------------------
# tied head
# ---------------------------------------------------------------------------

def test_tie_weights_matches_the_reference():
    """``LlamaModel(tie_weights=True)``: the head is the embedding's
    parameter (``..._embed_weight``, once in ``collect_params``, as in
    the JAX model), the converter maps the reference's weights onto it,
    the logits agree with the JAX model's, and three AdamW steps agree
    with the JAX TrainStep's (the tied weight moves by the sum of both
    uses' gradients)."""
    jnet = jllama.LlamaModel(**lt.TINY, tie_weights=True, fused_ce=True)
    jnet.initialize()
    tok0 = jmx.nd.zeros((1, 4), dtype="int32")
    jnet(tok0, tok0)
    rs = np.random.RandomState(8)
    named = {}
    for name, p in jnet.collect_params().items():
        arr = (1.0 + 0.1 * rs.randn(*p.shape) if name.endswith("norm_weight")
               else rs.randn(*p.shape) / np.sqrt(p.shape[-1]))
        named[name] = arr.astype(np.float32)
        p.set_data(jmx.nd.array(named[name]))
    net = LlamaModel(**lt.TINY, tie_weights=True, fused_ce=True,
                     ctx=mx.cpu())
    jn = [n[n.index("_"):] for n in jnet.collect_params()]
    pn = [n[n.index("_"):] for n in net.collect_params()]
    assert jn == pn and not any("lm_head" in n for n in pn)
    assert net.lm_head.weight is net.embed.weight
    assert sum(p.numel() for p in net.parameters()) == sum(
        a.size for a in named.values())
    net.load_state_dict(llama_params_from_reference(named))
    tok, lab = lt._batch(9)
    want = jnet(jmx.nd.array(tok, dtype="int32"),
                jmx.nd.array(lab, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(tok), torch.from_numpy(lab)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = jpar.TrainStep(jnet, lambda outs, *a: outs, "adamw", mesh=mesh,
                           loss_only=True, optimizer_params=dict(lt.OPT))
    tok, lab = lt._batch(7)
    jlosses = [float(jstep((jmx.nd.array(tok, dtype="int32"),
                            jmx.nd.array(lab, dtype="int32")),
                           ())[0].asnumpy()) for _ in range(3)]
    jparams = {n: p.data().asnumpy() for n, p in
               jnet.collect_params().items()}
    plosses, _ = _llama_run(net)
    np.testing.assert_allclose([float(x) for x in plosses], jlosses,
                               rtol=1e-5)
    _deltas_close(named, jparams, net, llama_params_from_reference)
