"""KVStore of the port: parameter synchronization for data parallelism
(counterpart of ``mxnet_tpu/kvstore``; reference
``src/kvstore/kvstore.cc :: KVStore::Create`` and
``python/mxnet/kvstore.py``).

``local``/``device`` (:class:`KVStoreLocal`) sum the copies of several
contexts of one process; ``tpu_sync``, ``nccl``, ``dist_sync`` and
``dist_device_sync`` (:class:`KVStoreTPUSync`) also sum across processes
over ``torch.distributed``, bootstrapped from the ``DMLC_*`` variables
that :mod:`mxnet_tpu_torch.tools.launch` exports. Every reduction, per
key, per bucket or per ZeRO shard, sums each element in one fixed order
(:mod:`.comm`), so the three agree bit for bit at any world. The fused
``pushpull`` coalesces keys into ``MXNET_KV_BUCKET_MB`` flat buckets
(:mod:`.bucketing`), 2-bit compression with error feedback runs the
``twobit_quantize`` kernel (:mod:`.gradient_compression`), and barriers
are bounded (``MXNET_KV_BARRIER_TIMEOUT``), raising
:class:`BarrierTimeoutError` naming the site and the missing ranks.
``dist_async`` is refused, as the reference refuses it without its
emulation flag; ``horovod``/``byteps`` raise.
"""
from .bucketing import (Bucket, PARTITION_MODES, ShardPlan,  # noqa: F401
                        bucket_cap_bytes, plan_buckets, shard_layout)
from .kvstore import (BarrierTimeoutError, KVStore,  # noqa: F401
                      KVStoreLocal, KVStoreTPUSync, create)
