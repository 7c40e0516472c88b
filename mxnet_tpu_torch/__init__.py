"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

Imported as ``import mxnet_tpu_torch as mx``. It runs on an NVIDIA H100
(``mx.gpu()``, the default context of every entry point) with its hot
kernels written by hand in CUDA C++ for Hopper (``kernels/csrc``); a CPU
context (``mx.cpu()``) runs each kernel's plain PyTorch version. It
imports ``torch`` and never ``jax`` or ``mxnet_tpu``.

Ported so far: two serving paths and one training path. One-shot BERT
serving, ``mx.serving.Server(net, shape_buckets=...).submit(...)`` over
``mx.gluon.model_zoo.nlp.bert_12_768_12``; paged-KV Llama generation,
``mx.serving.Server(net, decode_pages=...).submit_generate(...)`` over
``mx.gluon.model_zoo.nlp.llama_3_8b``; and BERT masked-LM pretraining,
``mx.parallel.TrainStep(net, lambda outs, *a: outs, "adam",
loss_only=True)`` over ``mx.gluon.model_zoo.nlp.BERTForPretrainFused``,
at BERT's published dropout (0.1 hidden, 0.1 attention) through the
position-hash dropout, seeded by ``mx.random.seed``.
"""
from . import (autograd, base, context, convert, gluon, kernels, ops,
               optimizer, parallel, random, random_state, serving)
from .base import MXNetError
from .context import cpu, gpu, num_gpus

__all__ = ["MXNetError", "cpu", "gpu", "num_gpus", "autograd", "base",
           "context", "convert", "gluon", "kernels", "ops", "optimizer",
           "parallel", "random", "random_state", "serving"]
