"""Serving stack of the port (counterpart of ``mxnet_tpu/serving``): the
SLO batcher for one-shot requests and the continuous-batching generate
server over a paged KV cache, multi-tenant with priority preemption and
hot reload from checkpoints. The fleet (router, workers, ingress,
controller, wire) is not ported yet."""
from .buckets import DEFAULT_LEN_BUCKETS, BucketGrid, TokenBucket
from .health import HALF_OPEN, OPEN, CLOSED, CircuitBreaker, Heartbeat
from .kvcache import (CacheFull, PagePool, Preempted, apply_defrag,
                      make_kv_arena)
from .reload import ReloadWatcher
from .server import (DEFAULT_MODEL, GenerateHandle, Server, TenantThrottled,
                     live_servers)

__all__ = ["Server", "GenerateHandle", "TenantThrottled", "live_servers",
           "DEFAULT_MODEL", "BucketGrid", "TokenBucket",
           "DEFAULT_LEN_BUCKETS", "PagePool", "CacheFull", "Preempted",
           "make_kv_arena", "apply_defrag", "ReloadWatcher",
           "CircuitBreaker", "Heartbeat", "CLOSED", "OPEN", "HALF_OPEN"]
