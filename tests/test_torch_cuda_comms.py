"""The data-parallel comms on the card: the ``twobit_quantize`` kernel,
the bucket pack/unpack, the overlapped Trainer and a one-rank NCCL
group under :mod:`mxnet_tpu_torch.kvstore.comm`.

* ``twobit_quantize`` against its plain version, bit for bit (NaN
  positions equal), in f32, bf16 and f16, on seeded values with the edge
  values (t, t +- 1 ulp, +-0, NaN, +-inf) placed in them, over five
  error-feedback steps, on the 16-byte route and the one-element route
  (a length not a multiple of 4, an offset view); one kernel per call;
* ``pack`` of CUDA members into the kept flat buffer and ``unpacker``'s
  views, bit for bit;
* a Trainer on ``gpu(0)`` with ``kvstore='nccl'`` (one worker: pack and
  unpack only), overlap on and off, and ``kvstore=None``: the same
  weights bit for bit;
* a one-rank NCCL group: ``reduce_scatter``, ``allreduce`` and
  ``all_gather`` over CUDA buckets hand back the bits they were given.

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_comms.py -m cuda --noconftest
"""
import socket

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import (twobit_quantize,
                                     twobit_quantize_reference)
from mxnet_tpu_torch.kernels._build import kernels_per_call
from mxnet_tpu_torch.kvstore import bucketing, comm

pytestmark = pytest.mark.cuda

T = 0.5


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


def _edges(dtype):
    t = torch.tensor(T, dtype=dtype)
    up = torch.nextafter(t, torch.tensor(float("inf"), dtype=dtype))
    down = torch.nextafter(t, torch.tensor(0.0, dtype=dtype))
    vals = [t, -t, up, down, -up, -down, torch.tensor(0.0, dtype=dtype),
            torch.tensor(-0.0, dtype=dtype),
            torch.tensor(float("nan"), dtype=dtype),
            torch.tensor(float("inf"), dtype=dtype),
            torch.tensor(float("-inf"), dtype=dtype)]
    return torch.stack(vals).float()


def _grad(gen, n, dtype):
    g = torch.randn(n, generator=gen) * 0.6
    e = _edges(dtype)
    idx = torch.randint(0, n, (len(e),), generator=gen)
    g[idx] = e
    return g.to(dtype)


def _same(a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    assert torch.equal(na, nb)
    ia = a[~na].contiguous().view(torch.uint8)
    ib = b[~nb].contiguous().view(torch.uint8)
    assert torch.equal(ia, ib)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,offset", [(4096, 0), (1 << 20, 0), (1027, 0),
                                      (4096, 1)])
def test_twobit_kernel_matches_plain(dtype, n, offset):
    _require_card()
    gen = torch.Generator().manual_seed(n + offset)
    r_card = torch.zeros(n, device="cuda")
    r_cpu = torch.zeros(n)
    for _ in range(5):
        g = _grad(gen, n + offset, dtype)
        gc = g.cuda()[offset:]
        q_card = twobit_quantize(gc, r_card, T)
        q_cpu = twobit_quantize_reference(g[offset:], r_cpu, T)
        torch.cuda.synchronize()
        _same(q_card, q_cpu)
        _same(r_card, r_cpu)
    before = twobit_quantize.launches
    r2 = r_card.clone()
    q2 = twobit_quantize(gc, r2, T)
    assert twobit_quantize.launches == before + 1
    assert kernels_per_call(lambda: twobit_quantize(gc, r2, T,
                                                    out=q2)) == 1


def test_twobit_kernel_checks_its_arguments():
    _require_card()
    g = torch.ones(8, device="cuda")
    with pytest.raises(mx.MXNetError, match="residual"):
        twobit_quantize(g, torch.zeros(8, device="cuda",
                                       dtype=torch.bfloat16), T)
    with pytest.raises(mx.MXNetError, match="threshold"):
        twobit_quantize(g, torch.zeros(8, device="cuda"), 0.0)
    with pytest.raises(mx.MXNetError, match="dtype"):
        twobit_quantize(g.int(), torch.zeros(8, device="cuda"), T)


def test_pack_unpack_on_the_card():
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(33, 7), (5,), (2, 3, 4), (1,)]
    members = [torch.randn(s, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for s in shapes]
    owned = {}
    flat = bucketing.pack(members, owned, slot=0)
    again = bucketing.pack(members, owned, slot=0)
    assert flat.data_ptr() == again.data_ptr()
    other = bucketing.pack(members, owned, slot=1)
    assert other.data_ptr() != flat.data_ptr()
    assert len(owned) == 2
    for m, v in zip(members, bucketing.unpacker(shapes)(flat)):
        assert v.data_ptr() >= flat.data_ptr()
        _same(m, v)


def _card_run(kvstore, overlap, steps=3):
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.loss import L2Loss

    gpu = mx.gpu(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(64, in_units=32, activation="relu"),
            nn.Dense(8, in_units=64))
    net.initialize(ctx=gpu)
    rs = np.random.RandomState(0)
    for p in net.collect_params().values():
        p.set_data((rs.randn(*p.shape) * 0.2).astype(np.float32))
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 0.01}, kvstore=kvstore,
                          overlap_comms=overlap)
    rs2 = np.random.RandomState(1)
    for _ in range(steps):
        x = mx.nd.array(rs2.randn(16, 32).astype(np.float32), ctx=gpu)
        y = mx.nd.array(rs2.randn(16, 8).astype(np.float32), ctx=gpu)
        with mx.autograd.record():
            loss = L2Loss()(net(x), y)
        mx.autograd.backward(loss)
        tr.step(16)
    return [p.data()._data.clone() for p in net.collect_params().values()], tr


def test_overlap_on_off_and_no_store_bit_for_bit():
    _require_card()
    base, _ = _card_run(None, False)
    for kv, ov in (("nccl", False), ("nccl", True)):
        got, tr = _card_run(kv, ov)
        for a, b in zip(got, base):
            _same(a, b)
        if ov:
            assert tr.last_overlap_stats["dispatched_in_backward"] >= 1


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_one_rank_nccl_primitives_keep_the_bits():
    _require_card()
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        assert comm.world() == 1 and comm.rank() == 0
        gen = torch.Generator(device="cuda").manual_seed(3)
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.randn(1 << 20, generator=gen, device="cuda",
                               dtype=dtype)
            rs = comm.reduce_scatter(flat)
            _same(rs, flat)
            _same(comm.allreduce(flat), flat)
            _same(comm.all_gather(rs, flat.numel()), flat)
    finally:
        dist.destroy_process_group()
    assert comm.world() == 1 and comm._dist() is None
