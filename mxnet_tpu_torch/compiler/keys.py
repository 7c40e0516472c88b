"""Canonical signature keys for every cache of the port that turns a
signature into something executable on the card.

Counterpart of ``mxnet_tpu/compiler/keys.py``. A signature is one
canonical shape::

    SigKey(site, ident, avals, attrs, shardings, platform, routing, extra)

* ``site``     — which cache family owns the entry (``cached_op``: a
  hybridized block's CUDA graphs; ``serving_decode``: the decode
  engine's graphs per batch bucket; ``train_step``: a ``TrainStep``'s
  entry per batch signature; ``nvrtc``: an ``mx.rtc`` module's CUBIN);
* ``ident``    — what is being captured or built;
* ``avals``    — the inputs' :func:`aval` descriptors: shape, dtype,
  device and whether the tensor is channels-last contiguous (a graph
  captured over NCHW strides must not replay NHWC input);
* ``attrs``    — static attributes;
* ``shardings``— kept for the reference's layout; the port runs on one
  card per process and leaves it empty;
* ``platform`` — ``"cuda:sm_90"`` or ``"cpu"`` (:func:`platform`);
* ``routing``  — :func:`routing_knobs`: what changes the code a
  signature runs on this card (the kernel build, torch and CUDA, the
  card's ``sm_XY``);
* ``extra``    — site-specific residue.

Every field is a hashable tree of primitives, so a SigKey is a dict key,
and :func:`fingerprint` gives the stable hex digest the manifest keys
on. :func:`encode`, :func:`decode` and :func:`fingerprint` are the
reference's, string for string, so either package reads the other's
manifest lines (and skips them as stale: their platform and build key
are not this process's).
"""
from __future__ import annotations

import hashlib
import json
import threading
from typing import NamedTuple, Optional

__all__ = ["SigKey", "signature", "fingerprint", "routing_knobs",
           "graph_ident", "callable_ident", "encode", "decode", "aval",
           "platform", "build_key"]

_lock = threading.Lock()
_knobs: Optional[tuple] = None
_platforms = {}         # card index -> "cuda:sm_XY", read once


def _sm(index: int = 0) -> str:
    import torch

    major, minor = torch.cuda.get_device_capability(index)
    return f"sm_{major}{minor}"


def platform(device=None) -> str:
    """``"cuda:sm_XY"`` for a CUDA device (None: the card when there is
    one) and ``"cpu"`` for the host; another device type (``meta``) is
    its type's name."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index or 0
    name = _platforms.get(index)
    if name is None:
        name = _platforms[index] = f"cuda:{_sm(index)}"
    return name


def build_key() -> str:
    """The kernel build's key: the name of ``kernels/_build.build_dir()``
    (a hash of every source, header, flag and the ``nvcc`` version)."""
    from ..kernels import _build

    return _build.build_dir().name


def routing_knobs() -> tuple:
    """What changes the code a signature runs on this card: the kernel
    build key, the torch and CUDA versions and the card's ``sm_XY``
    (``"cpu"`` without a card). Read once per process: none of it
    changes while the process runs."""
    global _knobs
    with _lock:
        if _knobs is None:
            import torch

            _knobs = (build_key(), torch.__version__,
                      str(torch.version.cuda),
                      _sm(0) if torch.cuda.is_available() else "cpu")
        return _knobs


class SigKey(NamedTuple):
    site: str
    ident: object
    avals: tuple = ()
    attrs: tuple = ()
    shardings: tuple = ()
    platform: Optional[str] = None
    routing: tuple = ()
    extra: tuple = ()


def signature(site: str, ident, avals=(), attrs=(), shardings=(),
              platform=None, routing=None, extra=()) -> SigKey:
    """Build the canonical key. ``routing=None`` means this process's
    :func:`routing_knobs`; pass an explicit tuple only when replaying a
    recorded signature."""
    return SigKey(site, ident, tuple(avals), tuple(attrs), tuple(shardings),
                  platform, routing_knobs() if routing is None
                  else tuple(routing), tuple(extra))


def aval(t) -> tuple:
    """``(shape, dtype, device, channels_last)`` of a tensor (an
    NDArray's tensor is read through ``_data``): the part of a tensor a
    captured graph or a built entry depends on. ``channels_last`` is
    True for a 4-D tensor in ``torch.channels_last`` memory order that
    is not also row-major."""
    import torch

    t = getattr(t, "_data", t)
    last = (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))
    return (tuple(t.shape), str(t.dtype).split(".")[-1], str(t.device),
            bool(last))


# ---------------------------------------------------------------------------
# Tagged JSON codec (the reference's): SigKeys and replay specs are
# nested tuples of primitives; JSON has no tuple, so tuples are tagged and
# restored exactly (tuple-vs-list identity matters — keys compare by ==).
# ---------------------------------------------------------------------------

def _enc(obj):
    if isinstance(obj, tuple):
        return {"t": [_enc(x) for x in obj]}
    if isinstance(obj, list):
        return {"l": [_enc(x) for x in obj]}
    if isinstance(obj, dict):
        return {"d": [[_enc(k), _enc(v)] for k, v in obj.items()]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    # dtype objects, np scalars, ... — degrade to their canonical string
    return {"s": str(obj)}


def _dec(obj):
    if isinstance(obj, dict):
        if "t" in obj:
            return tuple(_dec(x) for x in obj["t"])
        if "l" in obj:
            return [_dec(x) for x in obj["l"]]
        if "d" in obj:
            return {_dec(k): _dec(v) for k, v in obj["d"]}
        if "s" in obj:
            return obj["s"]
    return obj


def encode(obj) -> str:
    """Deterministic JSON text for a primitive tree (tuples tagged)."""
    return json.dumps(_enc(obj), sort_keys=True, separators=(",", ":"))


def decode(text: str):
    return _dec(json.loads(text))


def fingerprint(obj) -> str:
    """Stable hex digest of a key / replay spec — the manifest's dedupe
    and lookup handle. Accepts a SigKey, tuple tree, or encoded str."""
    if not isinstance(obj, str):
        obj = encode(tuple(obj) if isinstance(obj, SigKey) else obj)
    return hashlib.sha256(obj.encode()).hexdigest()[:24]


# ---------------------------------------------------------------------------
# Graph identity: a structural fingerprint of a Block, so manifest entries
# recorded against one process's model match a fresh process's model built
# from the same factory.
# ---------------------------------------------------------------------------

def graph_ident(block) -> str:
    """Structural fingerprint of a Gluon block: its class tree (with each
    class's forward bytecode), every registered parameter's name, dtype,
    gradient mode and declared shape (0 for an axis left to inference),
    and the hybridize flags. Two blocks built by one factory with one
    configuration match whatever their weights and whether their shapes
    have settled; a changed width does not. A match only routes: the
    replay captures against the live block."""
    parts = []

    def walk(b, path):
        cls = type(b)
        parts.append((path, f"{cls.__module__}.{cls.__qualname__}",
                      callable_ident(getattr(cls, "hybrid_forward", None)
                                     or getattr(cls, "forward", None))))
        for name, p in sorted(getattr(b, "_reg_params", {}).items()):
            parts.append((path, name, str(p.dtype),
                          getattr(p, "grad_req", "write"),
                          getattr(p, "grad_stype", "default"),
                          tuple(getattr(p, "declared_shape", None) or ())))
        for name, child in getattr(b, "_children", {}).items():
            walk(child, f"{path}/{name}")

    walk(block, "")
    # falsy flags are the defaults: a fresh block ({}) and a plain
    # hybridize() ({'static_alloc': False, ...}) share an ident
    flags = tuple(sorted(
        (k, v) for k, v in (getattr(block, "_flags", None) or {}).items()
        if v))
    return fingerprint(encode((tuple(parts), flags)))


def callable_ident(fn) -> str:
    """Behavioral fingerprint of a callable: qualified name + bytecode
    hash (a subclass that overrode forward, or an edited loss lambda,
    must not share an entry with the original)."""
    if fn is None:
        return "none"
    target = getattr(fn, "__func__", fn)
    code = getattr(target, "__code__", None)
    name = f"{getattr(target, '__module__', '')}." \
           f"{getattr(target, '__qualname__', type(fn).__qualname__)}"
    if code is None:
        # callable object: identify by its class's __call__ bytecode
        call = getattr(type(fn), "__call__", None)
        code = getattr(call, "__code__", None)
        if code is None:
            return name
    return name + ":" + hashlib.sha256(code.co_code).hexdigest()[:12]
