"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

Imported as ``import mxnet_tpu_torch as mx``. It runs on an NVIDIA H100
(``mx.gpu()``, the default context of every entry point) with its hot
kernels written by hand in CUDA C++ for Hopper (``kernels/csrc``); a CPU
context (``mx.cpu()``) runs each kernel's plain PyTorch version. It
imports ``torch`` and never ``jax`` or ``mxnet_tpu``.

Ported so far: two serving paths and two training entry points.
One-shot BERT serving, ``mx.serving.Server(net, shape_buckets=...)
.submit(...)`` over ``mx.gluon.model_zoo.nlp.bert_12_768_12``; paged-KV
Llama generation, ``mx.serving.Server(net, decode_pages=...)
.submit_generate(...)`` over ``mx.gluon.model_zoo.nlp.llama_3_8b``, its
decode steps replaying one CUDA graph per batch bucket; either server
multi-tenant (``register_model``, ``model=``/``priority=``) and hot
reloaded from ``mx.checkpoint.CheckpointManager`` bundles, with
``mx.fault``, ``mx.tracing`` and ``mx.telemetry`` as in the reference; the
fused step ``mx.parallel.TrainStep(net, loss, optimizer, ...)`` (BERT
masked-LM pretraining over
``mx.gluon.model_zoo.nlp.BERTForPretrainFused`` at BERT's published
dropout, Llama pretraining through
``mxnet_tpu_torch.tools.pretrain_llama`` with remat, ResNet v1 and v2
training), with every optimizer of the reference (SGD, Adam, AdamW and
LAMB through fused sweeps, the others per parameter) and
``mx.lr_scheduler``; and MXNet's eager Gluon loop::

    trainer = mx.gluon.Trainer(net.collect_params(), "lamb",
                               {"learning_rate": 1e-3, "wd": 0.01})
    with mx.autograd.record():
        loss = net(tokens, labels)
    mx.autograd.backward(loss)
    trainer.step(loss.numel())

with ``mx.gluon.Parameter``/``ParameterDict`` (``lr_mult``,
``wd_mult``, ``grad_req``) and ``mx.gluon.Block.collect_params``. Dropout
is seeded by ``mx.random.seed``. Data parallelism as MXNet's users write
it: parameters on several contexts (``initialize(ctx=[...])``,
``gluon.utils.split_and_load``), ``mx.kv.create`` and the ``Trainer``'s
``kvstore=`` (``device``/``local``, ``nccl``/``tpu_sync``,
``dist_sync``/``dist_device_sync`` across processes started by
``python -m mxnet_tpu_torch.tools.launch``), with ``update_on_kvstore``,
2-bit ``compression_params``, ``overlap_comms`` and ZeRO
``partition="zero1"|"zero2"``.

Training from files as MXNet scripts feed it: ``mx.recordio`` record
files (read and written by a native scanner built with ``g++``),
``mx.gluon.data`` (datasets, samplers, the ``DataLoader`` with thread or
fork workers and ``pin_memory``, the vision datasets and transforms),
``mx.io`` (``NDArrayIter``, ``CSVIter``, ``MNISTIter``,
``PrefetchingIter`` and ``DeviceFeedIter``, which copies batches to the
card on a stream of its own ahead of the step), ``mx.metric`` and
``mx.callback``; images as the reference reads them: ``mx.image``
(``imdecode``, the augmenters, ``ImageIter``, ``ImageDetIter``) decoding
JPEG on the card with nvJPEG and augmenting there, ``io.ImageRecordIter``,
the image datasets and ``pretrained=True`` from a local model store.
The runtime's instruments: ``mx.profiler`` over ``torch.profiler``,
``mx.monitor``, ``mx.storage``, ``mx.runtime`` and ``mx.test_utils``.

The imperative half of MXNet: ``mx.nd`` (``NDArray`` over one
``torch.Tensor``, on ``mx.current_context()``, the card by default; the
registered ops, ``attach_grad``/``backward``, ``.params`` files
byte-identical to the JAX package's) and ``mx.rtc.CudaModule``, a
user's CUDA source compiled by NVRTC and launched on NDArrays::

    x = mx.nd.array(np_x)                   # on gpu(0)
    mod = mx.rtc.CudaModule(source, options=["--fmad=false"])
    mod.get_kernel("axpy", "const float *x, float *y, float a") \
        .launch([x, y, 2.5], mx.gpu(0), (n // 256,), (256,))

The compilation service, ``mx.compiler``: signature keys, site caches
over the CUDA graphs and the steps' entries, a manifest of every
signature (``MXNET_COMPILE_MANIFEST``) that ``mx.compiler.warm_start``
replays before the first traffic, and a disk tier for the ``nvcc``
outputs and NVRTC CUBINs; ``gluon.parameter.abstract_init`` with
``TrainStep.aot_compile`` checks a recipe on the ``meta`` device.
"""
import time as _time

# the cold-start clock's zero (compiler.seconds_since_import)
_IMPORT_T0 = _time.monotonic()

from . import (autograd, base, callback, checkpoint, compiler,  # noqa: E402
               context, convert, engine, fault, gluon, image, init,
               initializer, io, kernels, kvstore, lr_scheduler, metric,
               monitor, ndarray, ops, optimizer, parallel, profiler,
               random, random_state, recordio, rtc, runtime, serving,
               storage, telemetry, test_utils, tracing)
from . import kvstore as kv  # noqa: E402
from . import ndarray as nd  # noqa: E402
from .base import MXNetError  # noqa: E402
from .context import (Context, cpu, cpu_pinned, current_context,  # noqa: E402
                      gpu, num_gpus)
from .ndarray import NDArray  # noqa: E402
from .optimizer import Optimizer  # noqa: E402

__all__ = ["MXNetError", "NDArray", "Optimizer", "Context", "cpu", "cpu_pinned", "gpu", "num_gpus",
           "current_context", "autograd", "base", "callback", "checkpoint",
           "compiler", "context", "convert", "engine", "fault", "gluon",
           "image", "init", "initializer", "io", "kernels", "kv", "kvstore",
           "lr_scheduler", "metric", "monitor", "nd", "ndarray", "ops",
           "optimizer", "parallel", "profiler", "random", "random_state",
           "recordio", "rtc", "runtime", "serving", "storage", "telemetry",
           "test_utils", "tracing"]
