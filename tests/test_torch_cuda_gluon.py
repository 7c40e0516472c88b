"""A hybridized Gluon block's CUDA graphs on the card (``_CachedGraph``).

A hybridized block called with CUDA NDArrays outside ``record()`` runs one
captured graph per signature: its outputs are held bit for bit against
the same block's eager forward at three signatures (two shapes of a
2-layer BERT, and one with a ragged ``valid_length``); each signature is
captured once; ``cast`` and a ``load_parameters`` that reallocates
recapture, an in-place ``load_parameters`` or ``Trainer.step`` does not
(the graph reads the new weights where they lie); the launch counters
tick per replay by the graph's own kernel nodes; and a capture that
fails raises instead of running eagerly.

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_gluon.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo.nlp import bert_12_768_12
from mxnet_tpu_torch.kernels import (flash_attention, fused_bias_gelu,
                                     fused_layer_norm)
from mxnet_tpu_torch.kernels._build import graph_kernel_names

CFG = dict(num_layers=2, units=128, hidden_size=256, num_heads=2,
           vocab_size=512, max_length=128, dropout=0.1, attn_dropout=0.1)
SIGS = ((4, 32, False), (8, 64, False), (4, 32, True))


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


def _net(seed=0, dtype=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return bert_12_768_12(ctx=mx.gpu(0), dtype=dtype, generator=gen,
                          use_decoder=False, **CFG)


def _inputs(b, l, ragged, seed=1):
    rs = np.random.RandomState(seed + b + l)
    gpu = mx.gpu(0)
    args = [mx.nd.array(rs.randint(1, 512, (b, l)), ctx=gpu,
                        dtype="float32"),
            mx.nd.array(rs.randint(0, 2, (b, l)), ctx=gpu, dtype="float32")]
    if ragged:
        args.append(mx.nd.array(rs.randint(1, l + 1, (b,)), ctx=gpu,
                                dtype="float32"))
    return args


def _bits(outs):
    return [o._data.detach().contiguous().view(torch.uint8).cpu().numpy()
            for o in outs]


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_bits(a), _bits(b)))


@pytest.mark.cuda
def test_graph_equals_eager_bit_for_bit_once_per_signature():
    _require_card()
    net = _net()
    eager = {sig: net(*_inputs(*sig)) for sig in SIGS}
    net.hybridize(static_alloc=True, static_shape=True)
    for _ in range(2):
        for sig in SIGS:
            got = net(*_inputs(*sig))
            assert all(isinstance(o, mx.nd.NDArray) for o in got)
            assert _same(got, eager[sig]), sig
    graph = net.cached_graph
    assert graph.captures == len(SIGS) and graph.replays == 2 * len(SIGS)
    # a held result is not overwritten by a later replay
    first = net(*_inputs(*SIGS[0]))
    kept = _bits(first)
    net(*_inputs(*SIGS[0], seed=7))
    assert all(np.array_equal(a, b) for a, b in zip(_bits(first), kept))


def _kernel_nodes(names):
    """The graph's kernel nodes of the LayerNorm forward, the flash
    forward and the bias+GELU forward, by the wrapper that launches
    each."""
    return {fused_layer_norm: sum("ln_vec_kernel" in n
                                  or "ln_scalar_kernel" in n
                                  for n in names),
            flash_attention: sum("flash_fwd" in n for n in names),
            fused_bias_gelu: sum("bias_gelu_vec_kernel" in n
                                 or "bias_gelu_scalar_kernel" in n
                                 for n in names)}


@pytest.mark.cuda
def test_launch_counters_tick_per_replay_by_the_graphs_kernel_nodes():
    _require_card()
    net = _net()
    net.hybridize()
    args = _inputs(4, 32, False)
    net(*args)
    entry = next(iter(net.cached_graph._graphs.values()))
    layers = CFG["num_layers"]
    want = {fused_layer_norm: 2 * layers + 1, flash_attention: layers,
            fused_bias_gelu: layers}
    assert _kernel_nodes(graph_kernel_names(entry.graph)) == want
    assert {fn: n for (fn, attr), n in entry.launches.items()
            if attr == "launches" and fn in want} == want
    before = {fn: fn.launches for fn in want}
    for _ in range(3):
        net(*args)
    assert {fn: fn.launches - before[fn] for fn in want} == \
        {fn: 3 * n for fn, n in want.items()}


@pytest.mark.cuda
def test_cast_and_a_reallocating_load_recapture(tmp_path):
    _require_card()
    net = _net()
    net.hybridize()
    args = _inputs(4, 32, False)
    net(*args)
    net.cast("bfloat16")
    assert net.cached_graph is None
    got = net(*args)
    assert net.cached_graph.captures == 1
    net.hybridize(False)
    assert _same(got, net(*args))
    net.hybridize()
    path = str(tmp_path / "bert.params")
    _net(seed=3).save_parameters(path)          # f32 weights
    net(*args)
    graph = net.cached_graph
    net.load_parameters(path, cast_dtype=True, dtype_source="saved")
    got = net(*args)
    assert graph.captures == 2, "a reallocating load recaptures"
    net.hybridize(False)
    assert _same(got, net(*args))


@pytest.mark.cuda
def test_in_place_updates_need_no_recapture(tmp_path):
    _require_card()
    net, other = _net(), _net(seed=5)
    path = str(tmp_path / "other.params")
    other.save_parameters(path)
    net.hybridize()
    args = _inputs(4, 32, False)
    net(*args)
    graph = net.cached_graph
    net.load_parameters(path)                   # same dtype: in place
    assert _same(net(*args), other(*args))
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3})
    labels = mx.nd.array(np.arange(4) % 2, ctx=mx.gpu(0))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(*args)[2], labels)
    loss.backward()
    trainer.step(4)
    got = net(*args)
    assert graph.captures == 1 and net.cached_graph is graph
    net.hybridize(False)
    assert _same(got, net(*args))


@pytest.mark.cuda
def test_a_failed_capture_raises_and_never_runs_eagerly():
    _require_card()

    class Syncing(nn.HybridBlock):
        def hybrid_forward(self, F, x):
            float(x.sum().asscalar())            # a host sync
            return x * 2

    blk = Syncing()
    blk.hybridize()
    x = mx.nd.ones((4, 4), ctx=mx.gpu(0))
    for _ in range(2):
        with pytest.raises(MXNetError, match="capturing the hybridized"):
            blk(x)
    assert blk.cached_graph.captures == 0 and blk.cached_graph.replays == 0
    torch.cuda.synchronize()
    seq = nn.HybridSequential()
    seq.add(nn.Dense(4, in_units=4))
    seq.initialize(ctx=mx.gpu(0))
    seq.hybridize()
    assert seq(x).shape == (4, 4) and seq.cached_graph.captures == 1


@pytest.mark.cuda
def test_warmup_captures_ahead_of_the_first_call():
    _require_card()
    net = _net()
    with pytest.raises(MXNetError, match="hybridize"):
        net.warmup([[(4, 32), (4, 32)]])
    net.hybridize()
    assert net.warmup([[(4, 32), (4, 32)], [(8, 64), (8, 64)]]) == 2
    assert net.warmup([[(4, 32), (4, 32)]]) == 0
    got = net(*_inputs(4, 32, False))
    assert net.cached_graph.captures == 2
    net.hybridize(False)
    assert _same(got, net(*_inputs(4, 32, False)))
