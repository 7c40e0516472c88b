"""``mxnet_tpu_torch.compiler`` — the compilation service on the card.

Counterpart of ``mxnet_tpu/compiler/``. One subsystem owns everything
that turns a signature into something the card runs:

* **signature keying** (:mod:`.keys`) — the canonical key of every site
  (ident + the inputs' shape, dtype, device and memory order + routing
  knobs + platform);
* **site caches** (:class:`SiteCache`) — LRU with hit, miss and eviction
  telemetry: a hybridized block's CUDA graphs (``cached_op``), the decode
  engine's graphs per batch bucket (``serving_decode``), a
  ``TrainStep``'s entry per batch signature (``train_step``);
* **executable table** (:class:`ExecutableTable`) — single-flight builds
  of NVRTC modules and the ``nvcc`` kernel build, keyed by fingerprint;
* **signature manifest** (:mod:`.manifest`) — the append-only JSONL
  journal of every signature captured or built
  (``MXNET_COMPILE_MANIFEST``);
* **warm start** (:func:`warm_start`) — replay a manifest before the
  first traffic: the graphs are captured, the modules loaded, the
  steps' states made;
* **disk tier** (:mod:`.persistent`) — ``nvcc`` outputs and NVRTC
  CUBINs under ``MXNET_XLA_CACHE_DIR``, collected past a size cap.

Importing this package imports :mod:`.keys` only; the rest loads on
first use.
"""
from __future__ import annotations

from . import keys
from .keys import SigKey, fingerprint, graph_ident, routing_knobs, signature

__all__ = [
    "SigKey", "signature", "fingerprint", "graph_ident", "routing_knobs",
    "Manifest", "enable_recording", "disable_recording", "recorder",
    "record_signature", "default_manifest_path",
    "SiteCache", "ExecutableTable", "GuardedExec", "exec_table",
    "warm_start", "mark_event", "events", "seconds_since_import",
    "cache_dir", "gc_cache", "keys",
]

_LAZY = {
    "Manifest": ("manifest", "Manifest"),
    "enable_recording": ("manifest", "enable_recording"),
    "disable_recording": ("manifest", "disable_recording"),
    "recorder": ("manifest", "recorder"),
    "record_signature": ("manifest", "record_signature"),
    "default_manifest_path": ("manifest", "default_path"),
    "SiteCache": ("service", "SiteCache"),
    "ExecutableTable": ("service", "ExecutableTable"),
    "GuardedExec": ("service", "GuardedExec"),
    "exec_table": ("service", "exec_table"),
    "warm_start": ("service", "warm_start"),
    "mark_event": ("service", "mark_event"),
    "events": ("service", "events"),
    "seconds_since_import": ("service", "seconds_since_import"),
    "cache_dir": ("persistent", "cache_dir"),
    "gc_cache": ("persistent", "gc_cache"),
}


def __getattr__(name):
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    mod = importlib.import_module(f".{modname}", __name__)
    value = getattr(mod, attr)
    globals()[name] = value
    return value
