"""The input pipeline and queue 3's fixes on the card.

* ``io.DeviceFeedIter`` at ``depth=2`` with a step slower than the copy
  (each consumed batch read after a sleep kernel queued on the
  consumer's stream, then dropped): every batch read equals its source
  bit for bit, so the copy stream never writes into a buffer the step
  has yet to read (the event wait and ``record_stream``);
* ``DataLoader(pin_memory=True)``: each batch on the card, labelled
  ``cpu_pinned``, bit for bit the ``num_workers=0`` CPU batch, in
  every worker mode; a staged batch read back through ``mx.cpu()``
  with a slow kernel queued ahead is its source bit for bit; a fork worker given a sample on the card, or
  making one, fails with ``MXNetError`` and does not hang;
* erf-GELU is +inf at +inf and ``relu(-0.0)`` is +0.0 on the card
  (torch 2.11 there), ``Embedding`` out of range gives NaN rows with no
  device-side assert, and silu's and mish's gradients are +0.0 at
  finite x <= -88;
* a served Llama request with a token id past the vocabulary returns,
  and the server answers the next request as a fresh server does.

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_data.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as mio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data as gdata

pytestmark = pytest.mark.cuda


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


@pytest.mark.parametrize("transform", [False, True])
def test_device_feed_never_overwrites_a_batch_the_step_has_not_read(
        transform):
    _require_card()
    rs = np.random.RandomState(0)
    n, bs = 12, 16
    x = rs.randint(0, 256, (n * bs, 3, 64, 64)).astype(np.uint8)
    y = rs.randint(0, 10, (n * bs,)).astype(np.float32)
    tf = mio.make_normalize_transform([120.0, 110.0, 100.0],
                                      [60.0, 55.0, 50.0], "bfloat16") \
        if transform else None
    feed = mio.DeviceFeedIter(mio.NDArrayIter(x, y, batch_size=bs),
                              shardings=mx.gpu(0), depth=2,
                              device_transform=tf)
    reads = []
    for b in feed:
        torch.cuda._sleep(20_000_000)       # a step slower than the copy
        reads.append((b.data[0]._data.clone(), b.label[0]._data.clone()))
        del b
    torch.cuda.synchronize()
    feed.close()
    assert len(reads) == n
    for k, (gx, gy) in enumerate(reads):
        src = torch.from_numpy(x[k * bs:(k + 1) * bs])
        want = tf(src)[0] if transform else src
        assert torch.equal(gx.cpu(), want), k
        assert torch.equal(gy.cpu(), torch.from_numpy(y[k * bs:(k + 1) * bs]))


@pytest.mark.parametrize("mode", ["inline", "threads", "fork"])
def test_pinned_dataloader_batches_bit_for_bit(mode, monkeypatch):
    _require_card()
    rs = np.random.RandomState(1)
    x = rs.randn(40, 3, 8, 8).astype(np.float32)
    y = rs.randint(0, 10, (40,)).astype(np.int32)
    ds = gdata.ArrayDataset(x, y)
    if mode == "fork":
        monkeypatch.setenv("MXNET_TPU_FORK_WORKERS", "1")
    workers = 0 if mode == "inline" else 3
    got = list(gdata.DataLoader(ds, 8, num_workers=workers,
                                pin_memory=True))
    monkeypatch.delenv("MXNET_TPU_FORK_WORKERS", raising=False)
    want = list(gdata.DataLoader(ds, 8))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.context == mx.cpu_pinned() and a._data.is_cuda
            assert torch.equal(a._data.cpu(), b._data)
            c = a.as_in_context(mx.gpu(0))
            assert c.context == mx.gpu(0)
            assert c._data.data_ptr() == a._data.data_ptr()


def test_a_staged_batch_read_back_on_the_host_is_its_source():
    """A staged batch (``cpu_pinned``, its tensor on the card) taken to
    ``mx.cpu()`` while a slow kernel is queued ahead of the copy: the
    host bytes read are the batch's (the copy back to the host is
    synchronous), bit for bit; a pinned host array taken to ``mx.cpu()``
    is a copy of its own."""
    _require_card()
    rs = np.random.RandomState(3)
    src = [rs.randint(1, 256, (64, 3, 32, 32)).astype(np.uint8),
           rs.rand(64, 10).astype(np.float32) + 1.0]
    staged = mio.stage_on_device([mx.nd.array(s, dtype=s.dtype,
                                              ctx=mx.cpu()) for s in src])
    torch.cuda._sleep(200_000_000)      # the copy back waits behind this
    for a, s in zip(staged, src):
        assert a.context == mx.cpu_pinned() and a._data.is_cuda
        h = a.as_in_context(mx.cpu())
        assert h.context == mx.cpu() and not h._data.is_cuda
        np.testing.assert_array_equal(h.asnumpy(), s)
    pinned = mx.nd.NDArray(torch.arange(4.0).pin_memory(),
                           ctx=mx.cpu_pinned())
    h = pinned.as_in_context(mx.cpu())
    assert h._data.data_ptr() != pinned._data.data_ptr()
    pinned[:] = 7.0
    assert h.asnumpy().tolist() == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_type", ["silu", "mish"])
def test_silu_mish_gradient_flush_on_the_card(act_type, dtype):
    """On the card, as on the CPU: the gradient is +0.0 at finite x <=
    -88, NaN at -inf and NaN, and ATen's elsewhere."""
    _require_card()
    from mxnet_tpu_torch.ops.nn import _ACTIVATIONS

    fn = {"silu": torch.nn.functional.silu,
          "mish": torch.nn.functional.mish}[act_type]
    dt = getattr(torch, dtype)
    x = torch.tensor([-88.0, -88.5, -100.0, -110.0, -1e4, -float("inf"),
                      float("nan"), -87.5, -1.0, 0.0, 3.0] * 2,
                     device="cuda", dtype=dt).requires_grad_()
    g = torch.tensor([1.0] * 11 + [-1.5] * 11, device="cuda", dtype=dt)
    (got,) = torch.autograd.grad(_ACTIVATIONS[act_type](x), x, g)
    (want,) = torch.autograd.grad(fn(x), x, g)
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    for k in (0, 11):
        flushed = got[k:k + 5]
        assert (flushed == 0).all() and not np.signbit(flushed).any()
        assert np.isnan(got[k + 5:k + 7]).all()
        np.testing.assert_array_equal(got[k + 7:k + 11], want[k + 7:k + 11])


class _OnTheCard(gdata.Dataset):
    """``held``: returns an array made on the card before the fork (the
    worker refuses it without touching the card); else makes one in the
    worker (torch refuses to initialise CUDA there)."""

    def __init__(self, held):
        self._held = mx.nd.ones((2,), ctx=mx.gpu(0)) if held else None

    def __len__(self):
        return 4

    def __getitem__(self, i):
        if self._held is not None:
            return self._held
        return mx.nd.ones((2,), ctx=mx.gpu(0))


@pytest.mark.parametrize("held,match", [
    (True, "forked DataLoader worker"),
    (False, "Cannot re-initialize CUDA in forked subprocess")])
def test_a_fork_worker_fails_loudly_on_the_card(held, match, monkeypatch):
    _require_card()
    monkeypatch.setenv("MXNET_TPU_FORK_WORKERS", "1")
    loader = gdata.DataLoader(_OnTheCard(held), 2, num_workers=2,
                              timeout=60)
    with pytest.raises(MXNetError, match=match):
        next(iter(loader))


def test_erf_gelu_relu_and_embedding_edges_on_the_card():
    _require_card()
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, 3.0,
                      -0.0] * 11, device="cuda")
    with mx.gpu(0):
        a = mx.nd.NDArray(x)
        for op in ("Activation", "LeakyReLU"):
            g = getattr(mx.nd, op)(a, act_type="gelu").asnumpy()
            assert g[0] == np.inf and np.isnan(g[1]) and np.isnan(g[2])
        r = mx.nd.relu(a).asnumpy()
        assert r[5] == 0.0 and not np.signbit(r[5]) and np.isnan(r[2])
        w = mx.nd.array(np.arange(15, dtype=np.float32).reshape(5, 3))
        e = mx.nd.Embedding(mx.nd.array([0, 4, 5, -1, -6], dtype="int32"),
                            w, input_dim=5, output_dim=3).asnumpy()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(e[[0, 1, 3]], [[0, 1, 2], [12, 13, 14],
                                                 [12, 13, 14]])
    assert np.isnan(e[[2, 4]]).all()


def test_a_token_past_the_vocabulary_does_not_end_the_server():
    _require_card()
    from mxnet_tpu_torch.gluon.model_zoo.nlp.llama import LlamaModel
    from mxnet_tpu_torch.serving import Server

    cfg = dict(vocab_size=512, num_layers=2, units=256, hidden_size=512,
               num_heads=4, num_kv_heads=2, rope_theta=10000.0)
    net = LlamaModel(ctx=mx.gpu(0), dtype=torch.bfloat16,
                     generator=torch.Generator(device="cuda").manual_seed(3),
                     **cfg)
    kw = dict(dtype="bfloat16", batch_buckets=(1, 2), len_buckets=(64,),
              decode_pages=32, page_size=16, ctx=mx.gpu(0))
    good = np.arange(3, 30, dtype=np.int32)
    bad = np.array([5, 600, 7, 10 ** 6], np.int32)
    with Server(net, **kw) as srv:
        want = srv.submit_generate(good, 8).result(120)
    with Server(net, **kw) as srv:
        out = srv.submit_generate(bad, 6).result(120)
        assert len(out) == 6
        got = srv.submit_generate(good, 8).result(120)
        again = srv.submit_generate(good, 8).result(120)
        assert srv.stats()["errors"] == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(again, want)
