"""The recurrent stack on the card: the ``RNN`` op's cuDNN route against
its plain step loop on the CPU.

Every mode and direction in f32 with TF32 off (outputs, states and every
gradient to 1e-5 of the largest magnitude for ``rnn_relu``; 5e-5 for the
modes whose cells call sigmoid and tanh, whose cuDNN versions read up to
2.0e-5 against an f64 step loop on an H100, where the f32 step loop
reads 1.1e-6) and in bf16 (outputs, states and gradients no farther
from the f64 step loop than 2^-7 of the largest magnitude, or than 1.5
times the bf16 step loop's own distance where that is larger: a 35-step
recurrence that rounds its state to bf16 at every step drifts past 2^-7
on either route); the route's counter moving once per layer per call
and the step loop never running for a CUDA tensor; the inter-layer hash
dropout's seeds and masks the CPU's bit for bit; a hybridized LSTM's
CUDA graph against its eager forward bit for bit, one capture per
signature; and ``depth_to_space`` and the ``Sequence*`` ops on the card
against the CPU.

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_rnn.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, random_state
from mxnet_tpu_torch.gluon import rnn
from mxnet_tpu_torch.kernels import hash_dropout, hash_dropout_reference
from mxnet_tpu_torch.ops import rnn as prnn
from mxnet_tpu_torch.ops import tensor as ptensor

MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")
SEQ, BATCH, INPUT, HIDDEN, LAYERS = 35, 8, 48, 64, 2
F32_LIMIT = {"rnn_relu": 1e-5, "rnn_tanh": 5e-5, "lstm": 5e-5, "gru": 5e-5}


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _inputs(mode, bidirectional, seed, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    dirs = 2 if bidirectional else 1
    n = prnn.rnn_param_size(mode, LAYERS, INPUT, HIDDEN, bidirectional)
    arrays = [rs.randn(SEQ, BATCH, INPUT), rs.randn(n) * 0.1,
              rs.randn(LAYERS * dirs, BATCH, HIDDEN),
              rs.randn(LAYERS * dirs, BATCH, HIDDEN)]
    if mode != "lstm":
        arrays = arrays[:3]
    heads = [rs.randn(SEQ, BATCH, HIDDEN * dirs),
             rs.randn(LAYERS * dirs, BATCH, HIDDEN),
             rs.randn(LAYERS * dirs, BATCH, HIDDEN)]
    as_t = [torch.from_numpy(a).to(dtype) for a in arrays]
    return as_t, [torch.from_numpy(h).to(dtype) for h in heads]


def _run(inputs, heads, device, dtype, **kw):
    ts = [t.to(device, dtype).requires_grad_() for t in inputs]
    outs = prnn.rnn(*ts, **kw)
    torch.autograd.backward(outs, [h.to(device, dtype)
                                   for h in heads[:len(outs)]])
    return ([o.detach().float().cpu() for o in outs],
            [t.grad.float().cpu() for t in ts])


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cudnn_route_matches_the_step_loop_f32(mode, bidirectional, no_tf32):
    _require_card()
    inputs, heads = _inputs(mode, bidirectional, seed=1)
    kw = dict(state_size=HIDDEN, num_layers=LAYERS, mode=mode,
              bidirectional=bidirectional)
    before = prnn.cudnn_rnn_layer.launches
    got, got_g = _run(inputs, heads, "cuda", torch.float32, **kw)
    assert prnn.cudnn_rnn_layer.launches - before == LAYERS
    want, want_g = _run(inputs, heads, "cpu", torch.float32, **kw)
    for g, w in zip(got + got_g, want + want_g):
        assert _rel(g, w) <= F32_LIMIT[mode]


@pytest.mark.cuda
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cudnn_route_matches_the_step_loop_bf16(mode, bidirectional):
    _require_card()
    inputs, heads = _inputs(mode, bidirectional, seed=2,
                            dtype=torch.bfloat16)
    kw = dict(state_size=HIDDEN, num_layers=LAYERS, mode=mode,
              bidirectional=bidirectional)
    truth = _run(inputs, heads, "cpu", torch.float64, **kw)
    card = _run(inputs, heads, "cuda", torch.bfloat16, **kw)
    loop = _run(inputs, heads, "cpu", torch.bfloat16, **kw)
    for c, lp, t in zip(card[0] + card[1], loop[0] + loop[1],
                        truth[0] + truth[1]):
        assert _rel(c, t) <= max(2.0 ** -7, 1.5 * _rel(lp, t))


@pytest.mark.cuda
def test_a_cuda_tensor_never_runs_the_step_loop(monkeypatch):
    _require_card()

    def refuse(*a, **k):
        raise AssertionError("the step loop ran for a CUDA tensor")

    monkeypatch.setattr(prnn, "_plain_layer", refuse)
    inputs, _ = _inputs("gru", True, seed=3)
    with torch.no_grad():
        out, h_n = prnn.rnn(*[t.cuda() for t in inputs], state_size=HIDDEN,
                            num_layers=LAYERS, mode="gru",
                            bidirectional=True)
    assert out.is_cuda and h_n.shape == (4, BATCH, HIDDEN)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_inter_layer_masks_are_the_cpus(mode, no_tf32):
    """Under one step seed both devices draw the same inter-layer seeds,
    the kernel's masks are the plain version's bit for bit, and the
    outputs and gradients agree to the f32 limits (they could not with
    one mask element apart)."""
    _require_card()
    inputs, heads = _inputs(mode, True, seed=4)
    kw = dict(state_size=HIDDEN, num_layers=3, mode=mode,
              bidirectional=True, p=0.5)
    rs = np.random.RandomState(5)
    n = prnn.rnn_param_size(mode, 3, INPUT, HIDDEN, True)
    inputs[1] = torch.from_numpy(rs.randn(n) * 0.1).float()
    inputs[2:] = [torch.from_numpy(rs.randn(6, BATCH, HIDDEN)).float()
                  for _ in inputs[2:]]
    heads[1:] = [torch.from_numpy(rs.randn(6, BATCH, HIDDEN)).float()
                 for _ in heads[1:]]
    runs = {}
    for device in ("cuda", "cpu"):
        with autograd.train_mode(), random_state.scoped_seed(1234), \
                random_state.seed_tape() as seeds:
            runs[device] = _run(inputs, heads, device, torch.float32, **kw)
        runs[device] += (list(seeds),)
    assert runs["cuda"][2] == runs["cpu"][2] and len(runs["cpu"][2]) == 2
    for seed in runs["cpu"][2]:
        ones = torch.ones(SEQ, BATCH, 2 * HIDDEN)
        card = hash_dropout(ones.cuda(), 0.5, seed).cpu()
        assert torch.equal(card, hash_dropout_reference(ones, 0.5, seed))
    for g, w in zip(runs["cuda"][0] + runs["cuda"][1],
                    runs["cpu"][0] + runs["cpu"][1]):
        assert _rel(g, w) <= F32_LIMIT[mode]


def _bits(outs):
    return [o._data.detach().contiguous().view(torch.uint8).cpu().numpy()
            .tobytes() for o in outs]


@pytest.mark.cuda
def test_hybridized_lstm_graph_equals_eager():
    """Predict mode through the hybridized layer: one CUDA graph per
    signature (with and without states, two sequence lengths), none
    after, and the graph's outputs the eager forward's bit for bit; each
    replay moves the cuDNN route's counter by the layers it ran."""
    _require_card()
    layer = rnn.LSTM(HIDDEN, num_layers=LAYERS, dropout=0.5,
                     input_size=INPUT)
    layer.initialize(mx.init.Uniform(0.1), ctx=mx.gpu(0))
    rs = np.random.RandomState(6)
    gpu = mx.gpu(0)
    sigs = []
    for seq in (SEQ, 20):
        x = mx.nd.array(rs.randn(seq, BATCH, INPUT), ctx=gpu)
        states = [mx.nd.array(rs.randn(LAYERS, BATCH, HIDDEN), ctx=gpu)
                  for _ in range(2)]
        sigs += [(x,), (x, states)]
    eager = [_bits([o] if isinstance(o, mx.nd.NDArray) else [o[0]] + o[1])
             for o in (layer(*a) for a in sigs)]
    layer.hybridize()
    for rep in range(3):
        before = prnn.cudnn_rnn_layer.launches
        for args, want in zip(sigs, eager):
            out = layer(*args)
            flat = [out] if isinstance(out, mx.nd.NDArray) \
                else [out[0]] + out[1]
            assert _bits(flat) == want
        # a capture's warm-up call runs eagerly, then its graph replays
        calls = LAYERS * len(sigs) * (2 if rep == 0 else 1)
        assert prnn.cudnn_rnn_layer.launches - before == calls
        assert layer.cached_graph.captures == len(sigs)
    assert layer.cached_graph.replays == 3 * len(sigs)


@pytest.mark.cuda
def test_sequence_and_depth_ops_on_the_card():
    _require_card()
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(6, 4, 3)).float()
    lens = torch.tensor([0.0, 1.0, 6.0, 3.0])
    for axis in (0, 1):
        xa = x if axis == 0 else x.transpose(0, 1).contiguous()
        for fn in (ptensor.sequence_mask, ptensor.sequence_last,
                   ptensor.sequence_reverse):
            want = fn(xa, lens, use_sequence_length=True, axis=axis)
            got = fn(xa.cuda(), lens.cuda(), use_sequence_length=True,
                     axis=axis)
            assert torch.equal(got.cpu(), want)
    y = torch.from_numpy(rs.randn(2, 12, 5, 7)).float()
    assert torch.equal(ptensor.depth_to_space(y.cuda(), block_size=2).cpu(),
                       ptensor.depth_to_space(y, block_size=2))
    z = torch.from_numpy(rs.randn(2, 3, 6, 4)).float()
    assert torch.equal(ptensor.space_to_depth(z.cuda(), block_size=2).cpu(),
                       ptensor.space_to_depth(z, block_size=2))
