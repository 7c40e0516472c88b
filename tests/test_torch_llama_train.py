"""The port's Llama pretraining slice held against the JAX package on the
CPU: the RMSNorm backward and its autograd Function, the AdamW sweep
with its overflow scan and bias-corrected rate, ``LlamaModel.forward``
(logits and the fused-CE per-token loss), ``parallel.TrainStep`` with
multi-precision AdamW against the JAX ``TrainStep``, the slice's
refusals, and the port of ``tools/pretrain_llama.py``.

Inputs and weights are drawn with numpy and handed to both packages; the
JAX Pallas kernels run in interpret mode (``jax.vjp`` of
``fused_rms_norm(..., interpret=True)``, ``packed_apply(...,
interpret=True)``). The CUDA kernels run only on the card:
tests/test_torch_cuda_kernels.py holds them against these plain
versions there.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.model_zoo.nlp import llama as jllama
from mxnet_tpu.optimizer import multi_tensor as jmt
from mxnet_tpu.pallas_kernels import fused_layers as jfl

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import llama_params_from_reference
from mxnet_tpu_torch.gluon.model_zoo.nlp import LlamaModel, llama_proxy1b
from mxnet_tpu_torch.kernels import (adamw_sweep_reference,
                                     fused_adamw_sweep, fused_rms_norm,
                                     fused_rms_norm_bwd,
                                     fused_rms_norm_bwd_reference,
                                     fused_rms_norm_reference)
from mxnet_tpu_torch.optimizer import AdamW
from mxnet_tpu_torch.optimizer import multi_tensor as pmt
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.tools import pretrain_llama

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = pretrain_llama.CONFIGS["tiny"]
# the pretraining tool's optimizer (tools/pretrain_llama.py:129-137)
OPT = {"learning_rate": 3e-4, "wd": 0.1, "beta1": 0.9, "beta2": 0.95,
       "multi_precision": True}
BATCH, SEQ = 2, 32


def _np(x):
    """A torch or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a, dtype):
    """The same numpy values as a (jax, torch) pair in ``dtype``."""
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    t = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return j, t


def _within_one_bf16_ulp_of_max(got, want, what):
    """max |got - want| <= one bf16 ulp of max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    top = float(np.max(np.abs(want)))
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = float(np.max(np.abs(got - want)))
    assert err <= ulp, (what, err, ulp)


# ---------------------------------------------------------------------------
# the RMSNorm backward
# ---------------------------------------------------------------------------

def _rms_inputs(rows, d, seed):
    rs = np.random.RandomState(seed)
    x = (1.5 * rs.randn(rows, d)).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(d)).astype(np.float32)
    dy = rs.randn(rows, d).astype(np.float32)
    return x, w, dy


def _jax_rms_vjp(jx, jw, jdy, eps):
    """(dx, dw) of the Pallas kernel's own VJP (``_rms_bwd``), in
    interpret mode."""
    _, vjp = jax.vjp(lambda a, b: jfl.fused_rms_norm(
        a, b, eps=eps, interpret=True), jx, jw)
    return vjp(jdy)


@pytest.mark.parametrize("d", [64, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_bwd_plain_matches_the_pallas_vjp(d, dtype):
    """The plain backward from the plain forward's rstd against
    ``jax.vjp`` of ``fused_rms_norm(..., interpret=True)``: an unrounded
    f32 xhat on both sides (the autodiff of the plain op would
    differentiate the rounded one). f32: rtol 1e-5, atol 1e-6; bf16: one
    ulp of each output's largest magnitude (one rounding of f32 values
    summed in other orders)."""
    x, w, dy = _rms_inputs(16, d, 7 + d)
    (jx, tx), (jw, tw), (jdy, tdy) = (_pair(a, dtype) for a in (x, w, dy))
    out, rstd = fused_rms_norm_reference(tx, tw, eps=1e-5,
                                         return_rstd=True)
    assert rstd.shape == (16,) and rstd.dtype == torch.float32
    before = fused_rms_norm_bwd.launches
    dx, dw = fused_rms_norm_bwd(tx, tw, rstd, tdy)
    assert fused_rms_norm_bwd.launches == before        # CPU: plain version
    jdx, jdw = _jax_rms_vjp(jx, jw, jdy, 1e-5)
    assert dx.dtype == tx.dtype and dw.dtype == tw.dtype
    assert str(dx.dtype).split(".")[-1] == str(jdx.dtype)
    if dtype == "float32":
        for got, want, name in ((dx, jdx, "dx"), (dw, jdw, "dw")):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    else:
        _within_one_bf16_ulp_of_max(dx, jdx, "dx")
        _within_one_bf16_ulp_of_max(dw, jdw, "dw")
    # the wrapper's plain route is the plain version itself
    got = fused_rms_norm_bwd_reference(tx, tw, rstd, tdy)
    assert torch.equal(got[0], dx) and torch.equal(got[1], dw)


def test_rms_norm_autograd_matches_jax_in_f32():
    """``fused_rms_norm`` on tensors that require grad goes through the
    ``_RMSNorm`` Function (plain forward and plain backward on the CPU);
    its x and weight gradients against the JAX kernel's VJP, f32, over a
    3-D input; without grad the output is the same tensor."""
    x, w, dy = _rms_inputs(24, 128, 3)
    x3, dy3 = x.reshape(2, 12, 128), dy.reshape(2, 12, 128)
    tx = torch.from_numpy(x3).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = fused_rms_norm(tx, tw, eps=1e-6)
    assert type(out.grad_fn).__name__ == "_RMSNormBackward"
    out.backward(torch.from_numpy(dy3))
    jdx, jdw = _jax_rms_vjp(jnp.asarray(x3), jnp.asarray(w),
                            jnp.asarray(dy3), 1e-6)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tw.grad), _np(jdw), rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        plain = fused_rms_norm(tx, tw, eps=1e-6)
    assert torch.equal(plain, out.detach())


# ---------------------------------------------------------------------------
# the AdamW sweep
# ---------------------------------------------------------------------------

ADAMW_STATIC = {"beta1": 0.9, "beta2": 0.95, "epsilon": 1e-6,
                "clip_gradient": None}
SHAPES = [(4, 5), (7,), (2, 3, 2), (33, 17), (6,), (3, 4)]
LRS = [0.1, 0.05, 0.02, 0.01, 0.03, 0.04]
WDS = [0.0, 0.1, 0.01, 0.1, 0.1, 0.05]
NAN_MEMBER, INF_MEMBER = 4, 5


def _adamw_members(rs, bf16_grads):
    ws = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [(3 * rs.randn(*s)).astype(np.float32) for s in SHAPES]
    ms = [0.1 * rs.randn(*s).astype(np.float32) for s in SHAPES]
    vs = [rs.rand(*s).astype(np.float32) for s in SHAPES]
    if bf16_grads:
        gs = [np.array(jnp.asarray(g).astype(jnp.bfloat16)
                       .astype(jnp.float32)) for g in gs]
    gs[NAN_MEMBER].flat[2] = np.nan
    gs[INF_MEMBER].flat[5] = np.inf
    return ws, gs, ms, vs


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("bucket", ["f32", "bf16-mp", "bf16"])
def test_adamw_sweep_plain_matches_jax_packed_apply(bucket, clip):
    """The plain sweep against ``packed_apply("adamw", interpret=True)``,
    the Pallas sweep in interpret mode, at the Adam test's rtol 1e-6 /
    atol 1e-7: an f32 bucket, a bf16 multi-precision one (f32 masters,
    bf16 grads, the bf16 weights written in the same pass) and a bf16
    one without masters (f32 moments). The member whose gradient holds a
    NaN keeps its weight and moments bit for bit; the one holding an inf
    does without a clip and is updated with clip 1.0 (the clip turns
    the inf into 1.0)."""
    mp, low_dt = bucket == "bf16-mp", bucket != "f32"
    rs = np.random.RandomState(61)
    ws, gs, ms, vs = _adamw_members(rs, low_dt)
    if bucket == "bf16":
        ws = [np.array(jnp.asarray(w).astype(jnp.bfloat16)
                       .astype(jnp.float32)) for w in ws]
    static = dict(ADAMW_STATIC, clip_gradient=clip)
    wdt = jnp.bfloat16 if bucket == "bf16" else jnp.float32
    ins = {"w": [jnp.asarray(a).astype(wdt) for a in ws],
           "g": [jnp.asarray(a) for a in gs],
           "mean": [jnp.asarray(a) for a in ms],
           "var": [jnp.asarray(a) for a in vs]}
    want = jmt.packed_apply("adamw", static, SHAPES, ins,
                            {"lr": LRS, "wd": WDS}, 0.5,
                            low_dtype=jnp.bfloat16 if mp else None,
                            platform="cpu", interpret=True)
    tw = torch.bfloat16 if bucket == "bf16" else torch.float32
    t_ins = {"w": [torch.from_numpy(a.copy()).to(tw) for a in ws],
             "g": [torch.from_numpy(a.copy()) for a in gs],
             "mean": [torch.from_numpy(a.copy()) for a in ms],
             "var": [torch.from_numpy(a.copy()) for a in vs]}
    if low_dt:
        t_ins["g"] = [g.to(torch.bfloat16) for g in t_ins["g"]]
    low = [torch.zeros(s, dtype=torch.bfloat16) for s in SHAPES] \
        if mp else None
    w0 = [w.clone() for w in t_ins["w"]]
    before = (fused_adamw_sweep.launches, fused_adamw_sweep.scan_launches)
    got = pmt.packed_apply("adamw", tuple(sorted(static.items())), t_ins,
                           {"lr": LRS, "wd": WDS}, 0.5, low=low)
    assert (fused_adamw_sweep.launches,
            fused_adamw_sweep.scan_launches) == before   # CPU: plain version
    for role in ("w", "mean", "var"):
        for a, b in zip(got[role], want[role]):
            assert str(a.dtype).split(".")[-1] == str(b.dtype), role
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7,
                                       err_msg=role)
    if mp:
        for a, b in zip(got["w_low"], want["w_low"]):
            assert a.dtype == torch.bfloat16
            # the same f32 master up to 1e-6, rounded once to bf16
            np.testing.assert_allclose(_np(a), _np(b), rtol=2.0 ** -7,
                                       atol=1e-7)
    skipped = [NAN_MEMBER] + ([INF_MEMBER] if clip is None else [])
    for j in range(len(SHAPES)):
        same = torch.equal(got["w"][j], w0[j]) and np.array_equal(
            _np(got["mean"][j]), ms[j]) and np.array_equal(
            _np(got["var"][j]), vs[j])
        assert same == (j in skipped), j
        if mp:
            assert torch.equal(got["w_low"][j], got["w"][j].to(
                torch.bfloat16))


def test_adamw_sweep_has_no_wd_in_the_moments():
    """The decoupled decay: the moments see the rescaled grad alone, and
    the decay multiplies the bias-corrected lr (one member, by hand)."""
    rs = np.random.RandomState(62)
    w, g = (torch.from_numpy(rs.randn(32).astype(np.float32))
            for _ in range(2))
    m, v = torch.zeros(32), torch.zeros(32)
    w0 = w.clone()
    adamw_sweep_reference([w], [g], [m], [v], None, [0.01], [0.1],
                          beta1=0.9, beta2=0.95, epsilon=1e-6,
                          rescale_grad=1.0)
    assert torch.equal(m, (1 - 0.9) * g)
    assert torch.equal(v, (1 - 0.95) * (g * g))
    step = 0.01 * m / (torch.sqrt(v) + 1e-6) + float(
        np.float32(0.1) * np.float32(0.01)) * w0
    assert torch.equal(w, w0 - step)


@pytest.mark.parametrize("correct_bias", [True, False])
def test_adamw_lr_matches_the_jax_step(correct_bias):
    """The JAX step folds the bias correction into lr from its traced
    int32 t and f32 lr in f64 (``collect_scalars``, ``:154-158``, under
    x64); the port in Python doubles. Rounded to f32, as the sweep reads
    them, lr and wd are equal over t = 1..50; without ``correct_bias``
    the lr is the base rate."""
    kw = dict(learning_rate=3e-4, wd=0.1, beta1=0.9, beta2=0.95,
              correct_bias=correct_bias)
    jopt = jmx.optimizer.create("adamw", **kw)
    popt = mx.optimizer.create("adamw", **kw)
    assert isinstance(popt, AdamW) and popt.epsilon == 1e-6
    assert pmt.family_of(popt) == "adamw"

    @jax.jit
    def jscalars(t, lr):
        with jopt.dynamic(t, lr):
            out = jmt.collect_scalars(jopt, "adamw", [0])
            return out["lr"][0], out["wd"][0]

    for t in range(1, 51):
        want = [np.float32(x) for x in jscalars(np.int32(t),
                                                np.float32(3e-4))]
        with popt.dynamic(np.int32(t), np.float32(3e-4)):
            got = pmt.collect_scalars(popt, "adamw", [0])
        assert [np.float32(got["lr"][0]), np.float32(got["wd"][0])] \
            == want, t
        if not correct_bias:
            assert got["lr"][0] == float(np.float32(3e-4))


# ---------------------------------------------------------------------------
# LlamaModel.forward and TrainStep against the JAX package
# ---------------------------------------------------------------------------

def _jax_llama(fused_ce, seed=23):
    """A JAX ``LlamaModel`` at ``llama_tiny`` widths (GQA 4/2) with numpy
    weights; returns it and the named weights."""
    jnet = jllama.LlamaModel(**TINY, fused_ce=fused_ce)
    jnet.initialize()
    tok = jmx.nd.zeros((1, 4), dtype="int32")
    jnet(tok, tok) if fused_ce else jnet(tok)
    rs = np.random.RandomState(seed)
    named = {}
    for name, p in jnet.collect_params().items():
        if name.endswith("norm_weight"):
            arr = 1.0 + 0.1 * rs.randn(*p.shape)
        else:
            arr = rs.randn(*p.shape) / np.sqrt(p.shape[-1])
        arr = arr.astype(np.float32)
        p.set_data(jmx.nd.array(arr))
        named[name] = arr
    return jnet, named


def _port_llama(named, fused_ce, dtype=torch.float32):
    net = LlamaModel(**TINY, fused_ce=fused_ce, ctx=mx.cpu())
    net.load_state_dict(llama_params_from_reference(named))
    return net.to(dtype)


def _batch(seed=5):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, TINY["vocab_size"], (BATCH, SEQ + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@pytest.fixture(scope="module")
def reference():
    return _jax_llama(fused_ce=True)


def test_forward_logits_and_fused_ce_loss_match_jax(reference):
    """f32 logits of ``LlamaModel(fused_ce=False)`` and the per-token
    loss of ``fused_ce=True`` against the JAX models with the same
    weights (the fused-CE JAX model's head has an explicit ``in_units``;
    the weight carrier maps it unchanged). f32 sums in other orders."""
    jnet_ce, named = reference
    jnet, _ = _jax_llama(fused_ce=False)
    # the same numpy weights on the logits model
    by_suffix = {n[n.index("_") + 1:]: a for n, a in named.items()}
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(by_suffix[name[name.index("_") + 1:]]))
    tok, lab = _batch(6)
    want_logits = jnet(jmx.nd.array(tok, dtype="int32")).asnumpy()
    want_loss = jnet_ce(jmx.nd.array(tok, dtype="int32"),
                        jmx.nd.array(lab, dtype="int32")).asnumpy()
    with torch.no_grad():
        logits = _port_llama(named, False)(torch.from_numpy(tok))
        loss = _port_llama(named, True)(torch.from_numpy(tok),
                                        torch.from_numpy(lab))
    assert logits.shape == (BATCH, SEQ, TINY["vocab_size"])
    assert loss.shape == (BATCH, SEQ) and loss.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=2e-5,
                               atol=2e-5)


def _jax_train(named, steps, dtype="float32"):
    jnet, _ = _jax_llama(fused_ce=True)
    by_suffix = {n[n.index("_") + 1:]: a for n, a in named.items()}
    for name, p in jnet.collect_params().items():
        p.set_data(jmx.nd.array(by_suffix[name[name.index("_") + 1:]]))
    if dtype != "float32":
        jnet.cast(dtype)
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    step = jpar.TrainStep(jnet, lambda outs, *a: outs, "adamw", mesh=mesh,
                          loss_only=True, optimizer_params=dict(OPT))
    tok, lab = _batch(7)
    batch = (jmx.nd.array(tok, dtype="int32"),
             jmx.nd.array(lab, dtype="int32"))
    losses = [float(step(batch, ())[0].asnumpy()) for _ in range(steps)]
    params = {n: p.data().asnumpy().astype(np.float32)
              for n, p in jnet.collect_params().items()}
    prefix = next(iter(named))[:next(iter(named)).index("_") + 1]
    params = {prefix + n[n.index("_") + 1:]: a for n, a in params.items()}
    return losses, params


def _port_train(named, steps, dtype=torch.float32):
    net = _port_llama(named, True, dtype)
    step = TrainStep(net, pretrain_llama._FusedLossPassthrough(), "adamw",
                     loss_only=True, optimizer_params=dict(OPT))
    tok, lab = _batch(7)
    losses = []
    for _ in range(steps):
        loss, outs = step((tok, lab), ())
        assert outs is None and loss.dtype == torch.float32
        losses.append(float(loss))
    return losses, net, step


def test_trainstep_f32_adamw_matches_jax_trainstep(reference):
    """Three f32 AdamW steps with the pretraining tool's optimizer (lr 3e-4, wd
    0.1, beta 0.9 / 0.95, multi-precision) from the same weights on the
    same batch, at the tolerances of the BERT step's test: losses to
    1e-5 relative (f32 sums in other orders), each parameter's delta to
    1e-4 of its norm."""
    _, named = reference
    jlosses, jparams = _jax_train(named, 3)
    plosses, net, step = _port_train(named, 3)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    assert plosses[-1] < plosses[0]
    sd = llama_params_from_reference(named)
    moved = llama_params_from_reference(jparams)
    got = net.state_dict()
    for key, w0 in sd.items():
        dj = moved[key].numpy() - w0.numpy()
        dp = got[key].numpy() - w0.numpy()
        ratio = float(np.linalg.norm(dp - dj)) / float(np.linalg.norm(dj))
        assert ratio < 1e-4, (key, ratio)
    assert len(step._buckets) == 1 and not step._buckets[0].mp
    assert step.optimizer.num_update == 3
    assert all(s[0].dtype == torch.float32 for s in step._states)


def test_trainstep_bf16_multi_precision_adamw_loosely_matches_jax(reference):
    """bf16 weights with f32 masters and moments: the two frameworks round
    at other places, so the losses agree to 2e-2 and both fall; the
    masters stay f32 and the bf16 weights are their rounding."""
    _, named = reference
    jlosses, _ = _jax_train(named, 3, dtype="bfloat16")
    plosses, net, step = _port_train(named, 3, dtype=torch.bfloat16)
    assert all(np.isfinite(plosses))
    np.testing.assert_allclose(plosses, jlosses, rtol=2e-2)
    assert plosses[-1] < plosses[0] and jlosses[-1] < jlosses[0]
    b = step._buckets[0]
    assert len(step._buckets) == 1 and b.mp and b.wdtype == torch.bfloat16
    for k, p in enumerate(step._params):
        w32, (m, v) = step._states[k]
        assert p.dtype == torch.bfloat16
        assert w32.dtype == m.dtype == v.dtype == torch.float32
        assert torch.equal(p.detach(), w32.to(torch.bfloat16))


def test_trainstep_returns_tuple_outputs_detached():
    """A net that returns a tuple: ``TrainStep`` reduces its first leaf
    and hands every leaf back cut from the graph."""
    class Pair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3))

        def forward(self, x):
            return (x * self.w, x + self.w)

    step = TrainStep(Pair(), lambda outs, *a: outs, "adamw")
    loss, outs = step(torch.arange(3.0), ())
    assert isinstance(outs, tuple) and len(outs) == 2
    assert all(o.grad_fn is None for o in outs)
    assert float(loss) == pytest.approx(float(outs[0].mean()))


# ---------------------------------------------------------------------------
# what the slice refuses, and the pretraining tool
# ---------------------------------------------------------------------------

def test_llama_refuses_remat_and_a_mesh():
    for remat in (True, "full", "dots"):
        with pytest.raises(mx.MXNetError, match="item 8"):
            LlamaModel(**TINY, remat=remat, ctx=mx.cpu())
    for remat in (False, None):
        LlamaModel(**TINY, remat=remat, ctx=mx.cpu())
    net = LlamaModel(**TINY, fused_ce=True, ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="items 9 and 11"):
        TrainStep(net, lambda o, *a: o, "adamw", mesh={"dp": 2})
    with pytest.raises(ValueError, match="labels"):
        net(torch.zeros(1, 4, dtype=torch.int32))
    with pytest.warns(UserWarning, match="a dividing chunk exists"):
        LlamaModel(**dict(TINY, vocab_size=1024), fused_ce=True,
                   ce_chunk=1000, ctx=mx.cpu())


def test_proxy1b_preset_and_ce_chunk():
    """``llama_proxy1b`` has the pretraining tool's proxy1b widths (built with one
    layer here, to keep the test small); its CE chunk is 8192, the
    largest divisor of 32768 up to 8192, and the tool counts the full
    config's 700.5M parameters."""
    cfg = dict(pretrain_llama.CONFIGS["proxy1b"], num_layers=1)
    net = llama_proxy1b(num_layers=1, fused_ce=True, ctx=mx.cpu(),
                        dtype=torch.bfloat16)
    assert net._ce_chunk == 8192
    keys = ("vocab_size", "units", "num_heads", "num_kv_heads",
            "rope_theta")
    assert {k: net._decode_cfg[k] for k in keys} == {k: cfg[k]
                                                     for k in keys}
    assert net.blocks[0].mlp.down.weight.shape == (2048, 7168)
    assert sum(p.numel() for p in net.parameters()) \
        == pretrain_llama.param_count(cfg)
    assert pretrain_llama.param_count(
        pretrain_llama.CONFIGS["proxy1b"]) == 700_491_776


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "dp=2"], "items 9 and 11"),
    (["--compile-only"], "item 10"),
    (["--data", "tokens.rec"], "item 10"),
    (["--save-dir", "ckpt"], "item 10"),
    (["--remat"], "item 8"),
    (["--no-fused-ce"], "item 6"),
])
def test_pretrain_tool_refuses_what_is_not_ported(flag, item):
    with pytest.raises(mx.MXNetError, match=item):
        pretrain_llama.main(["--config", "tiny", "--steps", "1",
                             "--ctx", "cpu"] + flag)


def test_pretrain_tool_runs_on_the_cpu():
    """``python -m mxnet_tpu_torch.tools.pretrain_llama --config tiny
    --steps 3 --ctx cpu`` prints finite, falling losses in its last
    line."""
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.pretrain_llama",
         "--config", "tiny", "--steps", "3", "--ctx", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    losses = rec["losses"]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[0] > losses[1] > losses[2]
    assert rec["device"] == "cpu" and rec["mfu"] is None
    assert rec["params"] == pretrain_llama.param_count(TINY)
