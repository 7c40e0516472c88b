"""The compilation service on the card.

* Warm start in a fresh process: a process records a manifest while a
  hybridized BERT (2 layers) predicts at two signatures and a tiny Llama
  serves two generate requests with decode graphs per batch bucket; a
  fresh process calls ``compiler.warm_start(manifest, blocks=[...])``
  before its first request and then records zero ``cached_op`` and
  ``serving_decode`` misses and gives the first process's outputs and
  tokens bit for bit.
* An evicted graph frees its buffers: the block's cache at capacity 1,
  a second signature evicts the first, whose graph and static tensors
  are freed (no reference left; the card's allocated bytes fall) and
  whose next call captures it again, bit for bit.
* A CUBIN on disk skips NVRTC: a module compiled once, the table
  cleared, the same source again is read from the disk tier with no
  NVRTC compile and launches to the same bits.
* The FLOP count on the card equals the count on ``meta`` and on the CPU
  (the kernels launched on the card count their formulas).

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_compiler.py -m cuda --noconftest
"""
import json
import os
import pathlib
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compiler, telemetry
from mxnet_tpu_torch.compiler import service
from mxnet_tpu_torch.gluon.model_zoo.nlp import (BERTForPretrainFused,
                                                 BERTModel, LlamaModel)
from mxnet_tpu_torch.parallel import TrainStep
from mxnet_tpu_torch.tools import pretrain_llama

REPO = pathlib.Path(__file__).resolve().parents[1]
BERT = dict(vocab_size=1000, num_layers=2, units=256, hidden_size=512,
            num_heads=4, max_length=128, use_pooler=True,
            use_classifier=True, use_decoder=False)
LLAMA = dict(vocab_size=512, num_layers=2, units=256, hidden_size=512,
             num_heads=4, num_kv_heads=2, rope_theta=10000.0)

CHILD = r'''
import hashlib, json, sys
import numpy as np, torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compiler
from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTModel, LlamaModel

warm, manifest = sys.argv[1] == "warm", sys.argv[2]
bert = BERTModel(**BERT, dtype=torch.bfloat16, ctx=mx.gpu(0),
                 generator=torch.Generator("cuda").manual_seed(1))
bert.hybridize()
llama = LlamaModel(**LLAMA, dtype=torch.bfloat16, ctx=mx.gpu(0),
                   generator=torch.Generator("cuda").manual_seed(2))
srv = mx.serving.Server(llama, dtype="bfloat16", decode_pages=64,
                        page_size=16, batch_buckets=(1, 2),
                        len_buckets=(32,), warmup=not warm)
srv.start()
report = compiler.warm_start(manifest, blocks=[bert, llama]) if warm \
    else None
decode, cached = srv.engine._cache, bert._graph()._cache
misses = (decode.misses, cached.misses)
rs = np.random.RandomState(0)
tokens = [[int(t) for t in srv.submit_generate(
    rs.randint(0, 512, size=n).astype(np.int32), 6).result(300)]
    for n in (9, 20)]
h = hashlib.sha256()
for b, l in ((4, 64), (4, 128)):
    args = [mx.nd.array(rs.randint(1, 1000, (b, l)), ctx=mx.gpu(0)),
            mx.nd.array(rs.randint(0, 2, (b, l)), ctx=mx.gpu(0))]
    for o in bert(*args):
        h.update(o._data.float().cpu().numpy().tobytes())
srv.stop()
print(json.dumps({"report": report, "tokens": tokens,
                  "bert": h.hexdigest(),
                  "misses": [decode.misses - misses[0],
                             cached.misses - misses[1]],
                  "buckets": srv.engine.buckets(),
                  "captures": [srv.engine.captures,
                               bert._graph().captures]}))
'''


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


def _child(regime, manifest):
    env = dict(os.environ, MXNET_COMPILE_MANIFEST=str(manifest)
               if regime == "cold" else "0")
    code = f"BERT = {BERT!r}\nLLAMA = {LLAMA!r}\n" + CHILD
    proc = subprocess.run([sys.executable, "-c", code, regime,
                           str(manifest)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_warm_start_in_a_fresh_process_misses_nothing(tmp_path):
    _require_card()
    manifest = tmp_path / "m.jsonl"
    cold = _child("cold", manifest)
    sites = sorted(e["site"] for e in compiler.Manifest(
        str(manifest)).entries())
    assert sites.count("cached_op") == 2
    assert sites.count("serving_decode") == 2     # buckets 1 and 2
    assert "kernels" in sites
    warm = _child("warm", manifest)
    assert warm["report"]["failed"] == 0
    # the graphs, and each library the cold process loaded
    assert warm["report"]["replayed"] == 4 + sites.count("kernels")
    assert warm["misses"] == [0, 0]
    assert warm["captures"] == [2, 2] and warm["buckets"] == cold["buckets"]
    assert warm["tokens"] == cold["tokens"]
    assert warm["bert"] == cold["bert"]
    # the cold process captured the BERT graphs at their first call
    assert cold["misses"][1] == 2


def _bert_inputs(b, l, seed):
    rs = np.random.RandomState(seed)
    return [mx.nd.array(rs.randint(1, 1000, (b, l)), ctx=mx.gpu(0)),
            mx.nd.array(rs.randint(0, 2, (b, l)), ctx=mx.gpu(0))]


def _bits(outs):
    return [o._data.float().cpu().numpy().tobytes() for o in outs]


@pytest.mark.cuda
def test_an_evicted_graph_frees_its_buffers():
    _require_card()
    net = BERTModel(**BERT, dtype=torch.bfloat16, ctx=mx.gpu(0),
                    generator=torch.Generator("cuda").manual_seed(3))
    net.hybridize()
    graph = net._graph()
    big, small = _bert_inputs(32, 128, 0), _bert_inputs(1, 8, 1)
    first = _bits(net(*big))
    graph._cache.maxsize = 1
    (entry,) = graph._cache.values()
    gone = [weakref.ref(t) for t in entry.outputs + entry.inputs]
    gone.append(weakref.ref(entry.graph))
    static = sum(t.untyped_storage().nbytes()
                 for t in entry.outputs + entry.inputs)
    # every capture warms up on the device's one warm-up stream, so no
    # capture leaves a cuBLAS workspace behind: the bytes compared are the
    # graphs'
    torch.cuda.synchronize()
    with_big = torch.cuda.memory_allocated()
    net(*small)
    torch.cuda.synchronize()
    assert graph._cache.evictions == 1 and len(graph._cache) == 1
    assert entry.graph is None and entry.outputs is None
    assert all(ref() is None for ref in gone)
    freed = with_big - torch.cuda.memory_allocated()
    # the (32, 128) graph's static outputs and inputs went back to the
    # pool, the (1, 8) graph's came out of it
    assert freed >= static // 2 > 0, (freed, static)
    assert _bits(net(*big)) == first
    assert graph.captures == 3 and graph._cache.misses == 3
    graph.clear()
    assert graph._pool is None and len(graph._cache) == 0


SCALE = r"""
extern "C" __global__ void twice(const float *x, float *y, int n)
{
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = 2.0f * x[i] + 1.0f;
}
"""


@pytest.mark.cuda
def test_a_cubin_on_disk_skips_nvrtc(tmp_path, monkeypatch):
    _require_card()
    monkeypatch.setenv("MXNET_XLA_CACHE_DIR", str(tmp_path))
    src = SCALE + f"// {tmp_path.name}\n"      # a source no run has seen
    x = mx.nd.array(np.arange(1000, dtype=np.float32), ctx=mx.gpu(0))

    def run(mod):
        y = mx.nd.zeros((1000,), ctx=mx.gpu(0))
        mod.get_kernel("twice", "const float *x, float *y, int n").launch(
            [x, y, 1000], mx.gpu(0), (4,), (256,))
        return y.asnumpy()

    compiles, loads = mx.rtc.CudaModule.compiles, mx.rtc.CudaModule.disk_loads
    first = mx.rtc.CudaModule(src)
    assert first.image_source == "nvrtc"
    assert mx.rtc.CudaModule.compiles == compiles + 1
    assert list((tmp_path / "nvrtc").rglob("*.cubin"))
    again = mx.rtc.CudaModule(src)              # the table's copy
    assert again.image_source == "table"
    service.exec_table.clear()
    fresh = mx.rtc.CudaModule(src)
    assert fresh.image_source == "disk"
    assert mx.rtc.CudaModule.compiles == compiles + 1
    assert mx.rtc.CudaModule.disk_loads == loads + 1
    want = 2.0 * np.arange(1000, dtype=np.float32) + 1.0
    for mod in (first, again, fresh):
        np.testing.assert_array_equal(run(mod), want)


def _llama_step(device):
    net = LlamaModel(**LLAMA, fused_ce=True, dtype=torch.bfloat16,
                     ctx=device, generator=torch.Generator(
                         device.type if device.type == "cuda" else "cpu")
                     .manual_seed(4))
    return TrainStep(net, pretrain_llama._FusedLossPassthrough(), "adamw",
                     loss_only=True,
                     optimizer_params={"learning_rate": 1e-4,
                                       "multi_precision": True})


def _bert_step(device):
    net = BERTForPretrainFused(vocab_size=1000, num_layers=2, units=256,
                               hidden_size=512, num_heads=4, max_length=128,
                               dropout=0.1, attn_dropout=0.1, chunk=500,
                               dtype=torch.bfloat16, ctx=device,
                               generator=torch.Generator(
                                   device.type).manual_seed(5))
    return TrainStep(net, lambda outs, *a: outs, "adam", loss_only=True,
                     optimizer_params={"learning_rate": 1e-4,
                                       "multi_precision": True})


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_llama_step, _bert_step])
def test_flop_count_on_the_card_equals_meta_and_the_cpu(make):
    _require_card()
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 500, (4, 129))
    batch = ((torch.from_numpy(toks[:, :-1].astype(np.int32)),
              torch.from_numpy(toks[:, 1:].astype(np.int32))), ())
    card = make(torch.device("cuda", 0))
    on_card = card.count_flops(*batch, meta=False)
    on_meta = telemetry.xla_cost_analysis(card, batch)["flops"]
    on_cpu = make(torch.device("cpu")).count_flops(*batch, meta=False)
    assert on_card == on_meta == on_cpu > 0
    assert card.optimizer.num_update == 0


@pytest.mark.cuda
def test_recaptures_leave_no_workspace_behind():
    """Twenty recaptures of one block leave the card's allocated bytes
    where the second capture left them: every capture's warm-up call runs
    on one stream per device, which holds one cuBLAS workspace (a new
    stream per capture left 32 MB more at each)."""
    _require_card()
    net = BERTModel(**BERT, dtype=torch.bfloat16, ctx=mx.gpu(0),
                    generator=torch.Generator("cuda").manual_seed(4))
    args = _bert_inputs(4, 32, 2)
    allocated = []
    for _ in range(20):
        net.hybridize()                 # drops the graph and its pool
        net(*args)
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    assert net._graph().captures == 1
    assert allocated[1:] == [allocated[1]] * 19, allocated
