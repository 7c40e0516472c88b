"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is one kernel library with a plain C interface,
compiled by ``nvcc`` into its own shared object and loaded with
``ctypes``. Builds happen at first use, from the checkout's own sources,
into ``build/kernels/<hash>/`` at the repository root (listed in
``.gitignore``), where ``<hash>`` covers every source, header and flag:
an edited source gets a fresh directory, an unchanged one is reused.
All sources compile in parallel, one ``nvcc`` process each.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "build_dir", "load", "check", "call"]

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCES = ("rms_norm.cu", "paged_attention.cu", "layer_norm.cu",
           "bias_gelu.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "fused_optimizer.cu", "dropout.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
last_build_seconds = None   # wall time of this process's build, if any


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise MXNetError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels cannot be built")


def build_dir() -> Path:
    """``build/kernels/<hash>`` for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return REPO_ROOT / "build" / "kernels" / h.hexdigest()[:16]


def _lib_path(out: Path, src: str) -> Path:
    return out / ("lib" + Path(src).stem + ".so")


def build_all() -> Path:
    """Compile every missing kernel library, all ``nvcc`` processes
    started together; raise :class:`MXNetError` naming each failure.
    Returns the build directory."""
    global last_build_seconds
    out = build_dir()
    todo = [s for s in SOURCES if not _lib_path(out, s).exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out / f".{Path(src).stem}.{os.getpid()}.so"
        log = open(out / (Path(src).stem + ".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src} (nvcc rc={rc}):\n"
                          + (out / (Path(src).stem + ".log")).read_text())
            continue
        os.replace(tmp, _lib_path(out, src))    # atomic publish
    last_build_seconds = time.perf_counter() - t0
    if failed:
        raise MXNetError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(src: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<src>`` (building all
    kernel libraries first if needed)."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(build_all(), src)))
            lib.mx_error_string.argtypes = [ctypes.c_int]
            lib.mx_error_string.restype = ctypes.c_char_p
            _libs[src] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.mx_error_string(rc).decode(errors="replace")
        raise MXNetError(f"{what}: CUDA error {rc} ({msg})")


def call(src: str, name: str, argtypes, what: str, *args) -> None:
    """Call the C entry point ``name`` of ``csrc/<src>``, declaring its
    ``argtypes`` (an int return) on first use, and raise
    :class:`MXNetError` naming ``what`` when it returns a CUDA error."""
    lib = load(src)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    check(lib, fn(*args), what)
