"""The compilation service's disk tier: what the card's compilers produce,
kept on disk so the next process loads it instead of building it.

Counterpart of ``mxnet_tpu/compiler/persistent.py``, whose disk tier is
jax's executable cache. On the card three things turn source into
something executable: ``nvcc`` builds of ``kernels/csrc/*.cu`` (minutes
for all of them), NVRTC compiles of ``mx.rtc`` modules (tens of
milliseconds each) and CUDA graph captures, which bind one process's
buffers and cannot outlive it (``warm_start`` replays them from the
manifest instead). The first two share one layout::

    <MXNET_XLA_CACHE_DIR>/            the repository's build/ by default
        kernels/<build hash>/         nvcc outputs (kernels/_build.py)
        nvrtc/<sm>-<nvrtc version>/<fingerprint>.cubin
        manifests/*.jsonl             signature manifests (manifest.py)

The reference's knobs keep their names and meanings:

* ``MXNET_XLA_CACHE``            — 0 turns the NVRTC tier and the
  collection off (the kernels still build under ``kernels/``);
* ``MXNET_XLA_CACHE_DIR``        — the base directory;
* ``MXNET_XLA_CACHE_MIN_COMPILE_S`` — persist a CUBIN only when its
  compile took at least this long (default 0: an NVRTC compile takes
  tens of milliseconds, a load from disk a fraction of one);
* ``MXNET_XLA_CACHE_MAX_BYTES``  — the size cap of the layout's entries
  (default 4 GiB, 0 = no collection): :func:`gc_cache` evicts the least
  recently used ones past it, never the build directory of the running
  sources.

Writes are atomic (a temporary file, then ``os.replace``), so two
processes writing one entry never tear it; a read touches the entry, so
its modification time is its last use.
"""
from __future__ import annotations

import logging
import os
import threading
from pathlib import Path
from typing import Optional

_log = logging.getLogger(__name__)

__all__ = ["enabled", "base_dir", "kernels_dir", "nvrtc_dir", "cache_dir",
           "setup", "write_atomic", "read_entry", "stats", "gc_cache",
           "USED_STAMP"]

REPO_ROOT = Path(__file__).resolve().parents[2]
USED_STAMP = ".used"          # touched in a build directory at each load

_setup_lock = threading.Lock()
_setup_done = False


def enabled() -> bool:
    return os.environ.get("MXNET_XLA_CACHE", "1") != "0"


def base_dir() -> Path:
    return Path(os.environ.get("MXNET_XLA_CACHE_DIR")
                or REPO_ROOT / "build")


def kernels_dir() -> Path:
    return base_dir() / "kernels"


def nvrtc_dir(sm: str, nvrtc_version: str) -> Path:
    return base_dir() / "nvrtc" / f"{sm}-{nvrtc_version}"


def _env_number(name: str, default, kind):
    try:
        return kind(os.environ.get(name, default))
    except ValueError:
        return kind(default)


def min_compile_s() -> float:
    return _env_number("MXNET_XLA_CACHE_MIN_COMPILE_S", "0", float)


def cache_dir() -> Optional[str]:
    """The tier's base directory, or None when it is off; the first call
    creates it and collects past the cap (:func:`setup`)."""
    if not enabled():
        return None
    setup()
    return str(base_dir())


def setup() -> Optional[str]:
    """Create the base directory and collect it past the cap, once per
    process. Best-effort: an unwritable directory leaves the tier off for
    this process's writes, never an error."""
    global _setup_done
    with _setup_lock:
        if _setup_done or not enabled():
            return str(base_dir()) if enabled() else None
        _setup_done = True
    try:
        base_dir().mkdir(parents=True, exist_ok=True)
        gc_cache()
    except OSError:
        _log.debug("disk tier %s: setup failed", base_dir(), exc_info=True)
    return str(base_dir())


def write_atomic(path, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temporary file in the same
    directory and ``os.replace``: a reader sees the old entry or the new
    one, never part of one."""
    from ..checkpoint import atomic_write

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_write(os.fspath(path), data)


def read_entry(path) -> Optional[bytes]:
    """The bytes of entry ``path`` (None when it is absent), its use
    recorded as its modification time."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        os.utime(path)
    except OSError:
        pass
    return data


def _entries(base: Path) -> list:
    """``(last use, bytes, paths, name)`` of every entry of the layout: a
    kernel build directory, or one NVRTC CUBIN with its sidecar."""
    out = []
    kdir = base / "kernels"
    for d in (kdir.iterdir() if kdir.is_dir() else ()):
        if not d.is_dir():
            continue
        files = [p for p in d.rglob("*") if p.is_file()]
        stamp = d / USED_STAMP
        try:
            used = stamp.stat().st_mtime if stamp.exists() \
                else d.stat().st_mtime
        except OSError:
            continue
        out.append((used, sum(p.stat().st_size for p in files), [d],
                    d.name))
    ndir = base / "nvrtc"
    for sub in (ndir.iterdir() if ndir.is_dir() else ()):
        for cubin in (sub.glob("*.cubin") if sub.is_dir() else ()):
            side = cubin.with_suffix(".names")
            paths = [cubin] + ([side] if side.exists() else [])
            try:
                out.append((cubin.stat().st_mtime,
                            sum(p.stat().st_size for p in paths), paths,
                            cubin.name))
            except OSError:
                continue
    return out


def stats(directory=None) -> dict:
    """Entry count and total bytes of the layout under ``directory``
    (default: the base directory)."""
    d = Path(directory) if directory is not None else base_dir()
    ents = _entries(d)
    return {"dir": str(d), "entries": len(ents),
            "bytes": sum(e[1] for e in ents)}


def _remove(path: Path) -> None:
    import shutil

    if path.is_dir():
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            path.unlink()
        except OSError:
            pass


def gc_cache(max_bytes: Optional[int] = None, directory=None,
             keep=None) -> int:
    """Delete the least recently used entries of the layout until it fits
    ``max_bytes`` (default ``MXNET_XLA_CACHE_MAX_BYTES``, 4 GiB; 0 or less
    collects nothing). ``keep``: build-directory names never evicted
    (default: the running sources' build directory). Returns the number
    of entries removed."""
    if max_bytes is None:
        max_bytes = _env_number("MXNET_XLA_CACHE_MAX_BYTES", str(4 << 30),
                                int)
    if max_bytes <= 0:
        return 0
    if keep is None:
        from ..kernels import _build

        keep = {_build.build_dir().name}
    base = Path(directory) if directory is not None else base_dir()
    ents = sorted(_entries(base), key=lambda e: e[0])
    total = sum(e[1] for e in ents)
    removed = 0
    for used, size, paths, name in ents:
        if total <= max_bytes:
            break
        if paths[0].is_dir() and name in keep:
            continue
        for p in paths:
            _remove(p)
        total -= size
        removed += 1
        _log.debug("disk tier gc: evicted %s (%d bytes)", paths[0], size)
    if removed:
        from .. import telemetry

        telemetry.record_cache_eviction("persistent", removed)
    return removed
