"""The port's BERT serving slice held against the JAX package on the CPU:
weight conversion, the 2-layer BERT model on every output, and the
one-shot ``Server.submit`` batcher (its outputs against the JAX
``Server``'s, its close reasons, rejections, cancellation and failure
handling).

Weights are drawn once with numpy, set on a narrow 2-layer JAX
``BERTModel`` and carried into the port by ``mxnet_tpu_torch.convert``;
both packages run in float32 on the CPU.
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon.model_zoo.nlp import bert as jbert

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import bert_params_from_reference
from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTModel, bert_12_768_12
from mxnet_tpu_torch.serving import Server

pytestmark = pytest.mark.serving

CFG = dict(vocab_size=100, max_length=64, num_layers=2, units=64,
           hidden_size=128, num_heads=4, dropout=0.0)
# f32 outputs of a 2-layer model: the two frameworks sum the same
# products in other orders (GEMM blocking, the softmax and LayerNorm
# reductions); measured differences are ~2e-6 on outputs of order 1-4
OUT_TOL = 2e-5


@pytest.fixture(scope="module")
def nets():
    """(jax net, port net, numpy params) with identical weights."""
    jnet = jbert.BERTModel(**CFG)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 8)))
    rs = np.random.RandomState(21)
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
    pnet = BERTModel(ctx=mx.cpu(), **CFG)
    pnet.load_state_dict(bert_params_from_reference(named))
    return jnet, pnet, named


def _ids(rs, n, length):
    return rs.randint(1, CFG["vocab_size"], size=(n, length)).astype(
        np.float32)


def _close(got, want, tol=OUT_TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.asnumpy() if hasattr(w, "asnumpy") else np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# weight carrier
# ---------------------------------------------------------------------------

def test_convert_maps_every_name_and_ties_the_decoder(nets):
    _, pnet, named = nets
    sd = bert_params_from_reference(named)
    assert set(sd) == set(pnet.state_dict())
    for key, t in pnet.state_dict().items():
        assert torch.equal(sd[key], t), key
    assert pnet.decoder.weight is pnet.word_embed.weight
    # without the masked-LM head there is no decoder weight to tie
    prefix = next(n for n in named if n.endswith("word_embed_weight"))[
        :-len("word_embed_weight")]
    no_head = {n: a for n, a in named.items()
               if not n[len(prefix):].startswith(("decoder_",
                                                  "word_embed_bias"))}
    plain = BERTModel(ctx=mx.cpu(), use_decoder=False, **CFG)
    assert set(bert_params_from_reference(no_head)) == \
        set(plain.state_dict())


def test_convert_raises_on_a_bad_name_shape_or_head(nets):
    _, _, named = nets
    prefix = next(n for n in named if n.endswith("word_embed_weight"))[
        :-len("word_embed_weight")]
    missing = dict(named)
    missing.pop(prefix + "enc_layer1_ffn_ffn2_bias")
    extra = dict(named)
    extra[prefix + "enc_layer0_attn_q_weight"] = np.zeros((4, 4),
                                                          np.float32)
    foreign = dict(named)
    foreign["othermodel0_pooler_bias"] = np.zeros(64, np.float32)
    bad_shape = dict(named)
    bad_shape[prefix + "enc_layer0_attn_qkv_weight"] = np.zeros(
        (64, 64), np.float32)
    half_head = dict(named)
    half_head.pop(prefix + "decoder_ln_beta")
    for case in (missing, extra, foreign, bad_shape, half_head):
        with pytest.raises(mx.MXNetError):
            bert_params_from_reference(case)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_bert_every_output_matches_jax(nets):
    """Sequence, pooled, classifier and masked-LM outputs, with and
    without token types and a valid-length mask (the masked path goes
    through the dense attention reference, the mask-free one through
    flash attention's plain version)."""
    jnet, pnet, _ = nets
    rs = np.random.RandomState(5)
    ids = _ids(rs, 3, 24)
    types = (rs.rand(3, 24) > 0.5).astype(np.float32)
    valid = np.ones((3, 24), np.float32)
    valid[1, 10:] = 0
    with torch.no_grad():
        _close(pnet(torch.from_numpy(ids)), jnet(jmx.nd.array(ids)))
        _close(pnet(torch.from_numpy(ids), torch.from_numpy(types),
                    torch.from_numpy(valid)),
               jnet(jmx.nd.array(ids), jmx.nd.array(types),
                    jmx.nd.array(valid)))
    out = pnet(torch.from_numpy(ids))
    assert [tuple(o.shape) for o in out] == [(3, 24, 64), (3, 64), (3, 2),
                                             (3, 24, 100)]


def test_bert_heads_are_optional_and_seeded_init_is_reproducible():
    def make(**kw):
        return BERTModel(ctx=mx.cpu(), generator=torch.Generator()
                         .manual_seed(3), **dict(CFG, **kw))

    a, b = make(), make()
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    seq_only = make(use_pooler=False, use_decoder=False)
    out = seq_only(torch.ones(2, 5))
    assert isinstance(out, torch.Tensor) and out.shape == (2, 5, 64)
    # BERT-base's published widths (depth cut to one layer here)
    base = bert_12_768_12(ctx=mx.cpu(), num_layers=1, use_decoder=False)
    assert base.config == {"vocab_size": 30522, "max_length": 512,
                           "num_layers": 1, "units": 768,
                           "hidden_size": 3072, "num_heads": 12}


def test_bf16_model_runs_and_returns_bf16():
    net = BERTModel(ctx=mx.cpu(), dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(0), **CFG)
    out = net(torch.ones(2, 6))
    assert all(o.dtype == torch.bfloat16 for o in out)
    assert all(torch.isfinite(o.float()).all() for o in out)


# ---------------------------------------------------------------------------
# Server.submit
# ---------------------------------------------------------------------------

def _server_kw(**kw):
    base = dict(batch_buckets=(1, 2, 4), shape_buckets=[(16,), (32,)],
                slo_ms=200.0, dtype="float32")
    base.update(kw)
    return base


def test_submit_matches_jax_server(nets):
    jnet, pnet, _ = nets
    rs = np.random.RandomState(8)
    samples = [_ids(rs, 1, n)[0] for n in (5, 16, 9, 30, 17, 3, 32)]
    with Server(pnet, ctx=mx.cpu(), **_server_kw()) as srv:
        got = [f.result(60) for f in [srv.submit(s) for s in samples]]
        stats = srv.stats()
    with jserving.Server(jnet, warmup=False, **_server_kw()) as jsrv:
        want = [f.result(60) for f in [jsrv.submit(s) for s in samples]]
    for s, g, w in zip(samples, got, want):
        bucket = 16 if len(s) <= 16 else 32
        assert isinstance(g, tuple) and len(g) == 4
        assert g[0].shape == (bucket, 64) and g[3].shape == (bucket, 100)
        assert all(leaf.dtype == np.float32 for leaf in g)
        _close(g, w)
    assert stats["requests"] == len(samples) and stats["errors"] == 0
    assert stats["warmup_forwards"] == 6          # 3 batch x 2 shape
    assert stats["batch_rows"] == len(samples)
    assert sum(stats["close_reasons"].values()) == stats["batches"]


def test_submit_pads_and_each_sample_gets_its_own_row(nets):
    """A served sample equals a batch-1 forward of its padded sample."""
    _, pnet, _ = nets
    rs = np.random.RandomState(9)
    samples = [_ids(rs, 1, n)[0] for n in (4, 11, 16)]
    with Server(pnet, ctx=mx.cpu(), **_server_kw(slo_ms=2000.0,
                                                 batch_timeout_ms=50.0)
                ) as srv:
        futs = [srv.submit(s) for s in samples]
        got = [f.result(60) for f in futs]
    for s, g in zip(samples, got):
        padded = np.zeros((1, 16), np.float32)
        padded[0, :len(s)] = s
        with torch.no_grad():
            alone = pnet(torch.from_numpy(padded))
        _close(g, [o[0].numpy() for o in alone], tol=1e-5)


class _Probe(nn.Module):
    """A tiny model for the batcher's control flow: doubles its input,
    raises on a negative first element, and records each batch shape."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(2.0))
        self.shapes = []

    def forward(self, x):
        self.shapes.append(tuple(x.shape))
        if float(x.reshape(-1)[0]) < 0:
            raise ValueError("probe: negative input")
        return x * self.scale, x.sum(dim=-1)


def _probe_server(probe, **kw):
    base = dict(batch_buckets=(1, 2, 4), shape_buckets=[(4,), (8,)],
                ctx=mx.cpu(), warmup=False)
    base.update(kw)
    return Server(probe, **base)


@pytest.mark.parametrize("reason", ["full", "deadline", "timeout", "drain"])
def test_close_reasons(reason):
    probe = _Probe()
    # the waits are long enough that both submits land before any close,
    # even on a loaded machine
    kw = {"full": dict(slo_ms=30000.0),
          "deadline": dict(slo_ms=400.0, close_margin_ms=100.0),
          "timeout": dict(slo_ms=30000.0, batch_timeout_ms=300.0),
          "drain": dict(slo_ms=30000.0)}[reason]
    srv = _probe_server(probe, **kw).start()
    try:
        n = 4 if reason == "full" else 2
        t0 = time.perf_counter()
        futs = [srv.submit(np.full(3, i + 1.0)) for i in range(n)]
        if reason == "drain":
            time.sleep(0.05)
            assert not any(f.done() for f in futs)
            srv.stop(drain=True, timeout=60)
        outs = [f.result(60) for f in futs]
        waited = time.perf_counter() - t0
    finally:
        if srv.is_running:
            srv.stop(timeout=60)
    stats = srv.stats()
    assert stats["close_reasons"][reason] == 1, stats
    assert stats["batches"] == 1 and stats["batch_rows"] == n
    assert probe.shapes == [(n, 4)]
    for i, (doubled, total) in enumerate(outs):
        np.testing.assert_array_equal(doubled, [2 * (i + 1.0)] * 3 + [0.0])
        assert total == pytest.approx(3 * (i + 1.0))
    if reason == "deadline":
        assert waited >= 0.3           # slo - margin
    if reason == "timeout":
        assert 0.3 <= waited < 10


def test_tightest_deadline_closes_the_batch():
    """A short per-request deadline behind a lazy head closes the batch
    at the short deadline, with the head riding along."""
    srv = _probe_server(_Probe(), slo_ms=30000.0).start()
    try:
        lazy = srv.submit(np.ones(2))
        urgent = srv.submit(np.ones(2), deadline_ms=300.0)
        assert lazy.result(10) is not None and urgent.result(10) is not None
        assert srv.stats()["close_reasons"]["deadline"] == 1
    finally:
        srv.stop(timeout=60)


def test_rejections_are_typed_and_synchronous():
    probe = _Probe()
    srv = _probe_server(probe, slo_ms=30000.0, max_queue=1)
    with pytest.raises(mx.MXNetError, match="not running"):
        srv.submit(np.ones(3))
    srv.start()
    try:
        with pytest.raises(mx.MXNetError, match="no shape bucket"):
            srv.submit(np.ones(9))
        with pytest.raises(mx.MXNetError, match="no shape bucket"):
            srv.submit(np.ones((2, 2)))
        queued = srv.submit(np.ones(3))
        with pytest.raises(mx.MXNetError, match="queue full"):
            srv.submit(np.ones(3))
        with pytest.raises(mx.MXNetError, match="decode is not enabled"):
            srv.submit_generate(np.ones(3, np.int32), 1)
    finally:
        srv.stop(drain=False, timeout=60)
    with pytest.raises(mx.MXNetError, match="stopped"):
        queued.result(10)
    assert probe.shapes == []          # nothing was ever dispatched


def test_a_cancelled_future_is_skipped():
    probe = _Probe()
    with _probe_server(probe, slo_ms=30000.0) as srv:
        doomed = srv.submit(np.full(2, 7.0))
        assert doomed.cancel()
        futs = [srv.submit(np.full(2, i + 1.0)) for i in range(3)]
        outs = [f.result(60) for f in futs]     # 4 queued -> "full"
        stats = srv.stats()
    assert doomed.cancelled()
    assert stats["cancelled"] == 1 and stats["batch_rows"] == 3
    assert probe.shapes == [(4, 4)]             # 3 live rows -> bucket 4
    assert [float(o[1]) for o in outs] == [2.0, 4.0, 6.0]


def test_a_dispatch_error_fails_the_batch_not_the_server():
    with _probe_server(_Probe(), slo_ms=20.0, close_margin_ms=1.0) as srv:
        bad = srv.submit(-np.ones(3))
        with pytest.raises(ValueError, match="negative"):
            bad.result(60)
        good = srv.submit(np.ones(3))
        assert float(good.result(60)[1]) == 3.0
        stats = srv.stats()
    assert stats["errors"] == 1 and stats["batches"] == 1
    assert stats["requests"] == 2


def test_concurrent_submitters_all_resolve():
    probe = _Probe()
    got = {}
    with _probe_server(probe, slo_ms=100.0, batch_timeout_ms=5.0) as srv:
        def client(c):
            futs = [srv.submit(np.full(5, c * 10.0 + i + 1))
                    for i in range(8)]
            got[c] = [float(f.result(60)[1]) for f in futs]

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        stats = srv.stats()
    for c in range(4):
        assert got[c] == [5 * (c * 10.0 + i + 1) for i in range(8)]
    assert stats["requests"] == 32 and stats["batch_rows"] == 32
    assert stats["batch_slots"] >= 32
    assert all(shape[1] == 8 for shape in probe.shapes)   # (5,) -> (8,)


def test_bf16_server_returns_float32_leaves():
    net = BERTModel(ctx=mx.cpu(), dtype=torch.bfloat16, use_decoder=False,
                    generator=torch.Generator().manual_seed(1), **CFG)
    with Server(net, ctx=mx.cpu(), batch_buckets=(1, 2),
                shape_buckets=[(8,)], slo_ms=50.0) as srv:
        seq, pooled, cls = srv.submit(np.arange(1, 6)).result(60)
    assert seq.dtype == pooled.dtype == cls.dtype == np.float32
    assert seq.shape == (8, 64) and np.isfinite(seq).all()


def test_default_device_bert_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(mx.MXNetError):
        BERTModel(**CFG).initialize()
