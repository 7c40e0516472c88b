"""Serving stack of the port (counterpart of ``mxnet_tpu/serving``): the
SLO batcher for one-shot requests and the continuous-batching generate
server over a paged KV cache."""
from .buckets import DEFAULT_LEN_BUCKETS, BucketGrid, TokenBucket
from .kvcache import (CacheFull, PagePool, Preempted, apply_defrag,
                      make_kv_arena)
from .server import GenerateHandle, Server

__all__ = ["Server", "GenerateHandle", "BucketGrid", "TokenBucket",
           "DEFAULT_LEN_BUCKETS", "PagePool", "CacheFull", "Preempted",
           "make_kv_arena", "apply_defrag"]
