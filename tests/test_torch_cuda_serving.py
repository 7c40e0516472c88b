"""The Llama decode engine's CUDA graphs on the card: one graph per
(batch bucket, page-table width), replayed for every decode step.

Each graph's logits are held bit for bit against the eager step
(``LlamaDecodeEngine.decode_step_eager``) on the same inputs and arenas,
at every bucket with padding rows, after a defrag and after a weight
swap; the server captures each bucket once at ``start()`` and once more
per swap; the kernel wrappers' launch counters tick per replay by the
graph's own kernel nodes of those kernels; and a capture that fails
raises instead of running eagerly.

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_serving.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.nlp import LlamaModel
from mxnet_tpu_torch.gluon.model_zoo.nlp import llama as llama_mod
from mxnet_tpu_torch.kernels import fused_rms_norm, paged_attention_kernel
from mxnet_tpu_torch.kernels._build import graph_kernel_names
from mxnet_tpu_torch.serving import PagePool, Server

PAGE = 16
BUCKETS = (1, 2, 4, 8)
# the smallest config the paged kernel takes: head dim 64, GQA 2:1
CFG = dict(vocab_size=512, num_layers=2, units=256, hidden_size=512,
           num_heads=4, num_kv_heads=2, rope_theta=10000.0)


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


def _net(dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return LlamaModel(ctx=mx.gpu(0), dtype=dtype, generator=gen, **CFG)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _prefilled(engine, rs, n_rows, width):
    """``n_rows`` streams prefilled with prompts of 5-40 tokens; returns
    (page table (n_rows, width), lengths, next tokens)."""
    table = np.zeros((n_rows, width), np.int32)
    lengths = rs.randint(5, 40, size=n_rows).astype(np.int32)
    tokens = np.zeros((n_rows, 64), np.int32)
    for i in range(n_rows):
        table[i, :engine.pool.pages_for(80)] = engine.pool.alloc(
            ("row", i, rs.rand()), 80)
        tokens[i, :lengths[i]] = rs.randint(0, CFG["vocab_size"],
                                            size=lengths[i])
    nxt = np.argmax(engine.prefill(tokens, lengths, table), -1)
    return table, lengths + 1, nxt.astype(np.int32)


def _padded(n, cap, table, lengths, tokens):
    """Rows [0, n) of the streams in a bucket of ``cap`` rows: padding
    rows have length 0 and an all-scratch page table."""
    t = np.zeros((cap, table.shape[1]), np.int32)
    ln = np.zeros((cap,), np.int32)
    tk = np.zeros((cap,), np.int32)
    t[:n], ln[:n], tk[:n] = table[:n], lengths[:n], tokens[:n]
    return tk, ln, t


def _graph_vs_eager(engine, tk, ln, t):
    """The eager step, then the graph step, on the same inputs (the
    second rewrites the same K/V values into the same slots)."""
    want = engine.decode_step_eager(tk, ln, t)
    got = engine.decode_step(tk, ln, t)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_equals_eager_at_every_bucket(dtype):
    _require_card()
    net = _net(dtype, 1)
    engine = net.decode_engine(PagePool(64, PAGE), dtype=dtype)
    width = engine.pool.pages_for(80)
    engine.capture(BUCKETS, width)
    assert engine.captures == len(BUCKETS)
    rs = np.random.RandomState(0)
    table, lengths, nxt = _prefilled(engine, rs, 8, width)
    # a full batch first, so the smaller buckets' padding rows follow a
    # fuller batch through the same static buffers
    for cap, n in ((8, 8), (8, 5), (4, 3), (2, 2), (1, 1), (8, 8)):
        tk, ln, t = _padded(n, cap, table, lengths, nxt)
        got, want = _graph_vs_eager(engine, tk, ln, t)
        assert got.shape == (cap, CFG["vocab_size"])
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=f"bucket {cap}, {n} rows")
        assert np.isfinite(got).all()
    assert engine.replays == 6 and engine.captures == len(BUCKETS)


@pytest.mark.cuda
def test_graph_equals_eager_after_a_defrag():
    _require_card()
    net = _net(torch.bfloat16, 2)
    pool = PagePool(96, PAGE)
    engine = net.decode_engine(pool, dtype=torch.bfloat16)
    width = pool.pages_for(80)
    rs = np.random.RandomState(1)
    holes = [pool.alloc(("hole", i), 80) for i in range(4)]
    assert holes
    table, lengths, nxt = _prefilled(engine, rs, 4, width)
    arena_ptr = engine.k_arena.data_ptr()
    tk, ln, t = _padded(4, 4, table, lengths, nxt)
    before = engine.decode_step(tk, ln, t)
    for i in range(4):
        pool.free(("hole", i))
    moves = pool.defrag()
    assert moves
    engine.apply_defrag(moves)
    assert engine.k_arena.data_ptr() == arena_ptr      # moved in place
    owners = [o for o in list(pool._owned) if o[0] == "row"]
    for i, o in enumerate(sorted(owners, key=lambda o: o[1])):
        pages = pool.owned(o)
        t[i] = 0
        t[i, :len(pages)] = pages
    got, want = _graph_vs_eager(engine, tk, ln, t)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the packed pages hold the same K/V: the step's logits do not move
    np.testing.assert_array_equal(_bits(got), _bits(before))


@pytest.mark.cuda
def test_refresh_recaptures_once_per_bucket_and_leaves_the_old_block():
    _require_card()
    old, new = _net(torch.bfloat16, 3), _net(torch.bfloat16, 4)
    kept = [p.detach().clone() for p in old.parameters()]
    engine = old.decode_engine(PagePool(64, PAGE), dtype=torch.bfloat16)
    width = engine.pool.pages_for(80)
    engine.capture(BUCKETS, width)
    rs = np.random.RandomState(2)
    table, lengths, nxt = _prefilled(engine, rs, 8, width)
    tk, ln, t = _padded(6, 8, table, lengths, nxt)
    old_logits = engine.decode_step(tk, ln, t)
    engine.refresh_params(new)
    assert engine.captures == 2 * len(BUCKETS)
    got, want = _graph_vs_eager(engine, tk, ln, t)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.array_equal(got, old_logits)       # the new weights
    for p, k in zip(old.parameters(), kept):
        assert torch.equal(p, k)                     # never written into


@pytest.mark.cuda
def test_launch_counters_tick_per_replay_by_the_graphs_kernel_nodes():
    _require_card()
    net = _net(torch.bfloat16, 5)
    engine = net.decode_engine(PagePool(64, PAGE), dtype=torch.bfloat16)
    width = engine.pool.pages_for(80)
    rs = np.random.RandomState(3)
    table, lengths, nxt = _prefilled(engine, rs, 8, width)
    tk, ln, t = _padded(8, 8, table, lengths, nxt)
    engine.capture((8,), width)
    graph, per_replay = engine.graph(8, width)
    names = graph_kernel_names(graph)
    rms_nodes = sum("rms_norm" in n for n in names)
    split_nodes = sum("paged_split_kernel" in n for n in names)
    layers = CFG["num_layers"]
    assert rms_nodes == 2 * layers + 1 and split_nodes == layers
    assert per_replay == {(fused_rms_norm, "launches"): rms_nodes,
                          (paged_attention_kernel, "launches"): split_nodes}
    r0, p0 = fused_rms_norm.launches, paged_attention_kernel.launches
    for _ in range(3):
        engine.decode_step(tk, ln, t)
    assert fused_rms_norm.launches - r0 == 3 * rms_nodes
    assert paged_attention_kernel.launches - p0 == 3 * split_nodes


@pytest.mark.cuda
def test_a_failed_capture_raises_and_never_runs_eagerly(monkeypatch):
    _require_card()
    net = _net(torch.float32, 6)
    engine = net.decode_engine(PagePool(32, PAGE), dtype=torch.float32)
    width = engine.pool.pages_for(80)
    body = llama_mod._DecodeStep.body

    def syncing_body(self, e):
        out = body(self, e)
        float(out.sum())            # a host sync: illegal in a capture
        return out

    monkeypatch.setattr(llama_mod._DecodeStep, "body", syncing_body)
    counts = fused_rms_norm.launches
    for _ in range(2):
        with pytest.raises(MXNetError, match="capturing the decode graph"):
            engine.decode_step(np.zeros(2, np.int32), np.zeros(2, np.int32),
                               np.zeros((2, width), np.int32))
    assert engine.captures == 0 and engine.replays == 0
    # the side-stream warm-up ran each time; the capture added nothing
    assert fused_rms_norm.launches - counts == 2 * (2 * 2 + 1)
    monkeypatch.setattr(llama_mod._DecodeStep, "body", body)
    torch.cuda.synchronize()
    out = engine.decode_step(np.zeros(2, np.int32), np.zeros(2, np.int32),
                             np.zeros((2, width), np.int32))
    assert out.shape == (2, CFG["vocab_size"]) and engine.captures == 1


@pytest.mark.cuda
def test_server_captures_each_bucket_once_and_once_more_per_swap():
    _require_card()
    old, new = _net(torch.bfloat16, 7), _net(torch.bfloat16, 8)
    prompt = np.arange(3, 40, dtype=np.int32)
    kw = dict(dtype="bfloat16", batch_buckets=BUCKETS, len_buckets=(64,),
              decode_pages=64, page_size=PAGE, ctx=mx.gpu(0))
    with Server(old, **kw) as srv:
        engine = srv.engine
        assert engine.captures == len(BUCKETS)
        first = srv.submit_generate(prompt, 8).result(120)
        assert engine.captures == len(BUCKETS) and engine.replays == 7
        srv.swap_model(new)
        second = srv.submit_generate(prompt, 8).result(120)
        assert engine.captures == 2 * len(BUCKETS)
        srv.swap_model(old)
        third = srv.submit_generate(prompt, 8).result(120)
        assert engine.captures == 3 * len(BUCKETS)
        assert srv.stats()["errors"] == 0
    np.testing.assert_array_equal(first, third)
    assert not np.array_equal(first, second)
