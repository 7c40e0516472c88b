"""Native (C++) components of the port, built on first use with the
system's ``g++`` (counterpart of ``mxnet_tpu/_native/__init__.py``).

Each ``<name>.cpp`` here is compiled into ``build/native/<hash>/
lib<name>.so`` at the repository root (listed in ``.gitignore``), where
``<hash>`` covers the source and the flags, as ``kernels/_build.py``
builds the CUDA kernels; the reference writes its ``.so`` beside the
source. A build or load failure raises :class:`MXNetError`: there is no
quiet fallback. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["load", "recordio_lib", "build_dir"]

HERE = Path(__file__).resolve().parent
REPO_ROOT = HERE.parents[1]
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs = {}


def build_dir(name: str) -> Path:
    """``build/native/<hash>`` for ``<name>.cpp`` and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((HERE / f"{name}.cpp").read_bytes())
    return REPO_ROOT / "build" / "native" / h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """Compile (once) and load ``<name>.cpp``; raise :class:`MXNetError`
    naming the failure."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = build_dir(name)
        so = out / f"lib{name}.so"
        try:
            if not so.exists():
                out.mkdir(parents=True, exist_ok=True)
                # a per-process name, published atomically: processes that
                # build at once do not clobber each other's output
                tmp = out / f".lib{name}.{os.getpid()}.so"
                proc = subprocess.run(
                    ["g++", *CXX_FLAGS, str(HERE / f"{name}.cpp"), "-o",
                     str(tmp)], capture_output=True, text=True, timeout=120)
                if proc.returncode != 0:
                    raise MXNetError(f"g++ failed (rc={proc.returncode}) on "
                                     f"{name}.cpp:\n{proc.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError(f"cannot build or load the native {name} "
                             f"library ({so}): {e!r}") from e
        _libs[name] = lib
        return lib


def recordio_lib() -> ctypes.CDLL:
    """The record-file scanner (``recordio.cpp``) with its signatures."""
    lib = load("recordio")
    if not getattr(lib, "_sigs_set", False):
        u64, p = ctypes.c_uint64, ctypes.c_void_p
        lib.rio_open.restype = p
        lib.rio_open.argtypes = [ctypes.c_char_p]
        lib.rio_create.restype = p
        lib.rio_create.argtypes = [ctypes.c_char_p]
        lib.rio_close.argtypes = [p]
        lib.rio_seek.argtypes = [p, u64]
        lib.rio_tell.argtypes = [p]
        lib.rio_tell.restype = u64
        lib.rio_next.argtypes = [p, ctypes.POINTER(
            ctypes.POINTER(ctypes.c_uint8))]
        lib.rio_next.restype = u64
        lib.rio_write.argtypes = [p, ctypes.c_char_p, u64]
        lib.rio_write.restype = u64
        lib.rio_flush.argtypes = [p]
        lib._sigs_set = True
    return lib
