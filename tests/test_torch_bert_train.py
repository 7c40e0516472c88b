"""The port's BERT pretraining slice held against the JAX package on the
CPU: the weight carrier for ``BERTForPretrainFused``, its per-position
loss, and ``parallel.TrainStep`` with the fused Adam sweep (f32 and
bf16 multi-precision) against the JAX ``TrainStep`` from the same
weights.

Weights are drawn once with numpy, set on a narrow 2-layer JAX model
(64 units, 4 heads, vocab 512, sequence 128, CE chunk 128) and carried
into the port by ``mxnet_tpu_torch.convert``; tokens and labels come
from ``RandomState``. Dropout is 0 here; tests/test_torch_dropout.py
holds a step at dropout 0.1 / 0.1 against the JAX step.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.model_zoo.nlp import bert as jbert

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import bert_pretrain_params_from_reference
from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTForPretrainFused
from mxnet_tpu_torch.optimizer import Adam, multi_tensor
from mxnet_tpu_torch.parallel import TrainStep

CFG = dict(vocab_size=512, max_length=128, num_layers=2, units=64,
           hidden_size=128, num_heads=4, dropout=0.0, chunk=128)
BATCH, SEQ = 4, 128
LR = 1e-3


def _draw(jnet, seed):
    """Numpy weights for every parameter of ``jnet``, set on it."""
    rs = np.random.RandomState(seed)
    named = {}
    for name, p in jnet.collect_params().items():
        shape = p.shape
        if name.endswith("gamma"):
            arr = 1.0 + 0.1 * rs.randn(*shape)
        elif name.endswith(("beta", "bias")):
            arr = 0.1 * rs.randn(*shape)
        else:
            arr = rs.randn(*shape) / np.sqrt(shape[-1])
        arr = arr.astype(np.float32)
        p.set_data(jmx.nd.array(arr))
        named[name] = arr
    return named


def _jax_net(seed=31):
    jnet = jbert.BERTForPretrainFused(**CFG)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8)), jmx.nd.zeros((1, 8)))
    return jnet, _draw(jnet, seed)


def _port_net(named, dtype=torch.float32):
    net = BERTForPretrainFused(ctx=mx.cpu(), **CFG)
    net.load_state_dict(bert_pretrain_params_from_reference(named))
    return net.to(dtype)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32),
            rs.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32))


@pytest.fixture(scope="module")
def reference():
    return _jax_net()


# ---------------------------------------------------------------------------
# the weight carrier
# ---------------------------------------------------------------------------

def test_convert_maps_every_name_and_keeps_the_tie(reference):
    _, named = reference
    sd = bert_pretrain_params_from_reference(named)
    net = BERTForPretrainFused(ctx=mx.cpu(), **CFG)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    for key, t in net.state_dict().items():
        assert torch.equal(sd[key], t), key
    # the projection is the word embedding itself: no weight of its own
    assert not any("decoder" in k and "weight" in k and "transform" not in k
                   for k in sd)
    assert set(n for n, _ in net.named_parameters()) == set(sd)
    prefix = next(n for n in named if n.endswith("bert_word_embed_weight"))
    np.testing.assert_array_equal(
        net.bert.word_embed.weight.tensor.detach().numpy(), named[prefix])


def test_convert_raises_on_a_bad_name_shape_or_missing_head(reference):
    _, named = reference
    prefix = next(n for n in named if n.endswith("bert_word_embed_weight"))[
        :-len("bert_word_embed_weight")]
    missing = dict(named)
    missing.pop(prefix + "decoder_bias")
    extra = dict(named)
    extra[prefix + "decoder_weight"] = np.zeros((512, 64), np.float32)
    foreign = dict(named)
    foreign["othermodel0_decoder_bias"] = np.zeros(512, np.float32)
    bad_shape = dict(named)
    bad_shape[prefix + "decoder_transform_weight"] = np.zeros((64, 32),
                                                              np.float32)
    backbone_head = dict(named)
    backbone_head[prefix + "bert_pooler_weight"] = np.zeros((64, 64),
                                                            np.float32)
    backbone_head[prefix + "bert_pooler_bias"] = np.zeros(64, np.float32)
    no_layer = {n: a for n, a in named.items()
                if "enc_layer1_ffn_ffn2_bias" not in n}
    for case in (missing, extra, foreign, bad_shape, backbone_head,
                 no_layer):
        with pytest.raises(mx.MXNetError):
            bert_pretrain_params_from_reference(case)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_per_position_loss_matches_jax(reference):
    """The (B, L) f32 loss of the same weights and batch; the two
    frameworks sum the same products in other orders (f32)."""
    jnet, named = reference
    net = _port_net(named)
    tok, lab = _batch(1)
    want = jnet(jmx.nd.array(tok), jmx.nd.array(lab)).asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(tok), torch.from_numpy(lab))
    assert got.shape == (BATCH, SEQ) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _jax_train(named, steps, dtype="float32"):
    jnet = jbert.BERTForPretrainFused(**CFG)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8)), jmx.nd.zeros((1, 8)))
    # each JAX block instance has its own name prefix
    by_suffix = {n[n.index("_") + 1:]: a for n, a in named.items()}
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(by_suffix[name[name.index("_") + 1:]]))
    if dtype != "float32":
        jnet.cast(dtype)
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step = jpar.TrainStep(jnet, lambda outs, *a: outs, "adam", mesh=mesh,
                          loss_only=True,
                          optimizer_params={"learning_rate": LR,
                                            "multi_precision": True})
    tok, lab = _batch(2)
    batch = (jmx.nd.array(tok), jmx.nd.array(lab))
    losses = [float(step(batch, ())[0].asnumpy()) for _ in range(steps)]
    params = {n: p.data().asnumpy().astype(np.float32)
              for n, p in jnet.collect_params().items()}
    prefix = next(iter(named))[:next(iter(named)).index("_") + 1]
    params = {prefix + n[n.index("_") + 1:]: a for n, a in params.items()}
    return losses, params


def _port_train(named, steps, dtype=torch.float32):
    net = _port_net(named, dtype)
    step = TrainStep(net, lambda outs, *a: outs, "adam", loss_only=True,
                     optimizer_params={"learning_rate": LR,
                                       "multi_precision": True})
    tok, lab = _batch(2)
    losses = []
    for _ in range(steps):
        loss, outs = step((tok, lab), ())
        assert outs is None and loss.dtype == torch.float32
        losses.append(float(loss))
    return losses, net, step


def _deltas(named, jparams, net):
    """Per parameter ‖Δw_port − Δw_jax‖ / ‖Δw_jax‖ over the run, and
    the largest |Δw| of each side on the key third of every QKV bias."""
    sd = bert_pretrain_params_from_reference(named)
    got = {k: v.detach().float().numpy() for k, v in net.state_dict().items()}
    carried = bert_pretrain_params_from_reference(jparams)
    units = CFG["units"]
    ratios, key_bias = {}, []
    for key, w0 in sd.items():
        dj = carried[key].float().numpy() - w0.numpy()
        dp = got[key] - w0.numpy()
        if key.endswith("qkv_proj.bias"):
            # softmax is unchanged by a constant added to every key, so
            # the key bias's gradient is 0 up to f32 noise, which Adam
            # turns into steps of either sign: set it aside
            k_part = slice(units, 2 * units)
            key_bias.append((float(np.abs(dj[k_part]).max()),
                             float(np.abs(dp[k_part]).max())))
            dj, dp = np.delete(dj, k_part), np.delete(dp, k_part)
        norm = float(np.linalg.norm(dj))
        if norm == 0.0:
            # a parameter the loss never reaches stays where it was
            assert float(np.linalg.norm(dp)) == 0.0, key
            continue
        ratios[key] = float(np.linalg.norm(dp - dj)) / norm
    return ratios, key_bias


def test_trainstep_f32_matches_jax_trainstep(reference):
    """Five f32 Adam steps (lr 1e-3) from the same weights on the same
    batch. Losses agree to 1e-5 relative (f32 sums in other orders), and
    each parameter's delta to 1e-4 of its norm (measured: <= 1e-5).
    Adam's m / (sqrt(v) + eps) is about sign(g) in the first steps, so
    an element whose gradient is pure f32 noise moves by +-lr either
    way: the key part of each QKV bias, whose true gradient is 0, is
    held instead to moving by less than 1% of what the other biases
    move (measured on both sides: ~1e-5 against ~5e-3)."""
    _, named = reference
    jlosses, jparams = _jax_train(named, 5)
    plosses, net, step = _port_train(named, 5)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    assert plosses[-1] < plosses[0]
    ratios, key_bias = _deltas(named, jparams, net)
    assert len(ratios) >= len(named) - 2       # token types are unused
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] < 1e-4, (worst, ratios[worst])
    assert len(key_bias) == CFG["num_layers"]
    assert max(max(pair) for pair in key_bias) < 0.01 * 5 * LR
    # one sweep per dtype bucket, with the counts at the step's t
    assert len(step._buckets) == 1 and not step._buckets[0].mp
    assert step.optimizer.num_update == 5


def test_trainstep_bf16_multi_precision_loosely_matches_jax(reference):
    """bf16 weights with f32 masters and moments: the forward and backward
    round at other places in the two frameworks (the fused add+norm sums
    in f32 here), so the losses agree to 2e-2 and both fall; the masters
    stay f32 and the bf16 weights are their rounding."""
    _, named = reference
    jlosses, _ = _jax_train(named, 3, dtype="bfloat16")
    plosses, net, step = _port_train(named, 3, dtype=torch.bfloat16)
    assert all(np.isfinite(plosses))
    np.testing.assert_allclose(plosses, jlosses, rtol=2e-2)
    assert plosses[-1] < plosses[0]
    b = step._buckets[0]
    assert len(step._buckets) == 1 and b.mp and b.wdtype == torch.bfloat16
    for k, p in enumerate(step._params):
        w32, (m, v) = step._states[k]
        assert p.dtype == torch.bfloat16
        assert w32.dtype == m.dtype == v.dtype == torch.float32
        assert torch.equal(p.detach(), w32.to(torch.bfloat16))


def test_tied_projection_gradient_reaches_unused_vocab_rows():
    """``tests/test_fused_ce_head.py:54-82`` on the port: ten steps at lr
    5e-3 lower the loss, and vocab rows no token looks up still move,
    which only the CE head's dW (the softmax over the whole vocab) can
    cause."""
    net = BERTForPretrainFused(vocab_size=128, max_length=32, num_layers=1,
                               units=32, hidden_size=64, num_heads=2,
                               dropout=0.0, chunk=64, ctx=mx.cpu(),
                               generator=torch.Generator().manual_seed(0))
    step = TrainStep(net, lambda outs, *a: outs, "adam", loss_only=True,
                     optimizer_params={"learning_rate": 5e-3})
    rs = np.random.RandomState(0)
    tok = rs.randint(0, 128, (4, 32)).astype(np.int32)
    lab = rs.randint(0, 128, (4, 32)).astype(np.int32)
    emb = net.bert.word_embed.weight.tensor
    w0 = emb.detach().clone()
    losses = [float(step((tok, lab), ())[0]) for _ in range(10)]
    assert losses[-1] < losses[0], losses
    used = set(tok.ravel().tolist())
    unused = [r for r in range(128) if r not in used][:20]
    assert unused and not torch.allclose(emb.detach()[unused], w0[unused])


def test_trainstep_returns_outputs_unless_loss_only(reference):
    _, named = reference
    net = _port_net(named)
    step = TrainStep(net, lambda outs, *a: outs, "adam",
                     optimizer_params={"learning_rate": LR})
    tok, lab = _batch(3)
    loss, outs = step((torch.from_numpy(tok), torch.from_numpy(lab)), ())
    assert outs.shape == (BATCH, SEQ) and outs.grad_fn is None
    np.testing.assert_allclose(float(loss), float(outs.float().mean()),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# what the slice refuses
# ---------------------------------------------------------------------------

def _tiny(**kw):
    cfg = dict(vocab_size=64, max_length=16, num_layers=1, units=16,
               hidden_size=32, num_heads=2, dropout=0.0, chunk=32,
               ctx=mx.cpu())
    cfg.update(kw)
    return BERTForPretrainFused(**cfg)


@pytest.mark.parametrize("kwargs,item", [
    ({"mesh": {"dp": 2}}, "item 11"),
    ({"rules": object()}, "item 11"),
    ({"seq_axis": "sp"}, "item 11"),
    ({"donate_inputs": True}, "item 8"),
])
def test_trainstep_refuses_what_needs_a_later_slice(kwargs, item):
    with pytest.raises(mx.MXNetError, match=item):
        TrainStep(_tiny(), lambda o, *a: o, "adam", **kwargs)
    # a mesh of one device is the single-device step itself
    TrainStep(_tiny(), lambda o, *a: o, "adam", mesh={"dp": 1})


def test_trainstep_refuses_dropout_and_unported_optimizers():
    """A model with dropout is no longer refused: TrainStep trains it,
    with its dropout sites drawing from the step's scoped seeds (tests/
    test_torch_dropout.py holds the step against the JAX one). The
    optimizers without a fused sweep, and a subclass of a fused one, are
    no longer refused either: they take the per-parameter update
    (tests/test_torch_optimizers.py holds them against the reference)."""
    for kw in ({"dropout": 0.1}, {"attn_dropout": 0.1}):
        step = TrainStep(_tiny(**kw), lambda o, *a: o, "adam",
                         loss_only=True)
        rs = np.random.RandomState(0)
        tok = rs.randint(0, 64, (2, 16)).astype(np.int32)
        loss = step((tok, tok), ())[0]
        assert torch.isfinite(loss)
    step = TrainStep(_tiny(), lambda o, *a: o, "nag", loss_only=True,
                     optimizer_params={"momentum": 0.9})
    tok = np.random.RandomState(1).randint(0, 64, (2, 16)).astype(np.int32)
    assert torch.isfinite(step((tok, tok), ())[0])
    assert step._per_param and not step._buckets
    with pytest.raises(mx.MXNetError, match="unknown optimizer"):
        mx.optimizer.create("nosuch")

    class MyAdam(Adam):
        pass

    assert multi_tensor.family_of(MyAdam()) is None
    step = TrainStep(_tiny(), lambda o, *a: o, MyAdam(), loss_only=True)
    assert torch.isfinite(step((tok, tok), ())[0])
    assert not step._buckets
