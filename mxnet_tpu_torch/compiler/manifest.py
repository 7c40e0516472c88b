"""Signature manifest — the on-disk journal of everything this process
captured or built, replayable by :func:`mxnet_tpu_torch.compiler.
warm_start`.

Counterpart of ``mxnet_tpu/compiler/manifest.py``. Format: append-only
JSONL, one object per line::

    {"v": 1, "site": "cached_op", "fp": "<hex>", "spec": <tagged tree>,
     "platform": "cuda:sm_90", "build": "<kernel build key>"}

``spec`` is the site's replay recipe (a block's graph ident and input
signature for ``cached_op``, a decode bucket for ``serving_decode``, a
step's ident and batch signature for ``train_step``, an ``mx.rtc``
module's source and options for ``nvrtc``, the build key and a
library's source for ``kernels``), encoded with the tagged tuple codec of :mod:`.keys`.

Durability: the file is created through ``checkpoint.atomic_write``; each
further record appends ONE fsynced line. A crash mid-append can tear at
most that line, and reading tolerates torn or corrupt lines, hand edits,
unknown sites, other versions, and lines whose platform is not one of
this process's or whose kernel build is not this checkout's (a manifest
written by the JAX package has neither, so it is skipped, not fatal):
each is skipped and counted. A stale manifest warms less; it never
breaks startup. A missing file reads as empty.

Location: ``MXNET_COMPILE_MANIFEST`` names the file (``1`` = the default
``<MXNET_XLA_CACHE_DIR>/manifests/signatures.jsonl``; ``0`` or unset =
recording off).
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional

from . import keys

__all__ = ["Manifest", "default_path", "recorder", "enable_recording",
           "disable_recording", "record_signature", "KNOWN_SITES",
           "MANIFEST_VERSION", "live_platforms"]

_log = logging.getLogger(__name__)

MANIFEST_VERSION = 1

# the sites warm_start replays; an entry of any other site is stale
KNOWN_SITES = ("cached_op", "serving_decode", "train_step", "nvrtc",
               "kernels")


def default_path() -> str:
    from . import persistent

    return os.path.join(str(persistent.base_dir()), "manifests",
                        "signatures.jsonl")


def live_platforms() -> set:
    """The platforms this process runs signatures on: the host and each
    visible card's ``cuda:sm_XY``."""
    import torch

    out = {"cpu"}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out.add(keys.platform(torch.device("cuda", i)))
    return out


class Manifest:
    """One signature journal file: load-tolerant reader + atomic recorder."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_path()
        self._lock = threading.Lock()
        self._entries: Optional[List[Dict]] = None   # loaded lazily
        self._fps = set()
        self.n_skipped = 0          # corrupt/stale lines seen at load

    # -- read ----------------------------------------------------------
    def _load_locked(self) -> List[Dict]:
        if self._entries is not None:
            return self._entries
        entries: List[Dict] = []
        self.n_skipped = 0
        try:
            with open(self.path, encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            lines = []
        platforms = live_platforms() if lines else set()
        build = keys.build_key() if lines else None
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                raw = json.loads(line)
                if (raw.get("v") != MANIFEST_VERSION
                        or raw.get("site") not in KNOWN_SITES
                        or not isinstance(raw.get("fp"), str)
                        or raw.get("platform") not in platforms
                        or raw.get("build") != build):
                    raise ValueError("stale or malformed entry")
                entry = {"v": raw["v"], "site": raw["site"],
                         "fp": raw["fp"], "platform": raw["platform"],
                         "spec": keys._dec(raw.get("spec"))}
            except (ValueError, TypeError, AttributeError, KeyError):
                self.n_skipped += 1
                continue
            if entry["fp"] in self._fps:
                continue
            self._fps.add(entry["fp"])
            entries.append(entry)
        self._entries = entries
        if self.n_skipped:
            _log.debug("manifest %s: skipped %d corrupt/stale line(s)",
                       self.path, self.n_skipped)
        return entries

    def entries(self) -> List[Dict]:
        with self._lock:
            return list(self._load_locked())

    def __len__(self) -> int:
        return len(self.entries())

    # -- write ---------------------------------------------------------
    def record(self, site: str, spec, platform: Optional[str] = None
               ) -> Optional[str]:
        """Journal one signature of ``site`` run on ``platform`` (default:
        this process's card, else the host); returns its fingerprint, or
        None when it was already journaled (dedupe by fingerprint).

        The journal is created through ``checkpoint.atomic_write``; each
        later record APPENDS one fsynced line (O(1) per miss; a torn tail
        line is what the tolerant reader skips)."""
        fp = keys.fingerprint((site, keys.encode(spec)))
        with self._lock:
            self._load_locked()
            if fp in self._fps:
                return None
            self._fps.add(fp)
            entry = {"v": MANIFEST_VERSION, "site": site, "fp": fp,
                     "platform": platform or keys.platform(), "spec": spec}
            self._entries.append(entry)
            line = json.dumps(
                {"v": entry["v"], "site": site, "fp": fp,
                 "platform": entry["platform"], "build": keys.build_key(),
                 "spec": keys._enc(spec)}, sort_keys=True) + "\n"
            try:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                if not os.path.exists(self.path):
                    from ..checkpoint import atomic_write

                    atomic_write(self.path, line.encode())
                else:
                    with open(self.path, "a", encoding="utf-8") as f:
                        f.write(line)
                        f.flush()
                        os.fsync(f.fileno())
            except OSError:
                # journaling is best-effort: a read-only directory must
                # not break a capture (the entry stays recorded in memory)
                _log.debug("manifest %s: record failed", self.path,
                           exc_info=True)
        return fp


# ---------------------------------------------------------------------------
# Process-wide recorder: sites call record_signature() on every miss; it
# does nothing unless recording was enabled (environment or API).
# ---------------------------------------------------------------------------

class _Recorder:
    __slots__ = ("manifest",)

    def __init__(self):
        self.manifest: Optional[Manifest] = None


_recorder = _Recorder()
_recorder_lock = threading.Lock()
_env_checked = False


def _check_env() -> None:
    global _env_checked
    if _env_checked:
        return
    with _recorder_lock:
        if _env_checked:
            return
        spec = os.environ.get("MXNET_COMPILE_MANIFEST", "")
        if spec and spec != "0":
            path = default_path() if spec == "1" else spec
            _recorder.manifest = Manifest(path)
        _env_checked = True


def enable_recording(path: Optional[str] = None) -> Manifest:
    """Start journaling signatures to ``path`` (default: the disk tier's
    layout). Returns the live Manifest."""
    global _env_checked
    with _recorder_lock:
        _recorder.manifest = Manifest(path)
        _env_checked = True
        return _recorder.manifest


def disable_recording() -> None:
    global _env_checked
    with _recorder_lock:
        _recorder.manifest = None
        _env_checked = True


def recorder() -> Optional[Manifest]:
    """The active manifest recorder, or None when recording is off."""
    _check_env()
    return _recorder.manifest


def record_signature(site: str, spec, platform: Optional[str] = None
                     ) -> None:
    """Journal one signature (nothing when recording is off). Called by
    every cache site on a miss."""
    m = recorder()
    if m is None:
        return
    m.record(site, spec, platform)
