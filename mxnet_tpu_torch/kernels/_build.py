"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is one kernel library with a plain C interface,
compiled by ``nvcc`` into its own shared object and loaded with
``ctypes``. Builds happen at first use, from the checkout's own sources,
into ``<disk tier>/kernels/<hash>/`` (the compilation service's layout,
``compiler/persistent.py``: ``build/kernels/<hash>/`` at the repository
root by default, listed in ``.gitignore``), where ``<hash>`` covers
every source, header and flag and the ``nvcc`` version: an edited
source or another compiler gets a fresh directory, an unchanged one is
reused. All sources compile in parallel, one ``nvcc`` process each; the
build runs once per process through the service's single-flight table,
and each load touches the directory's ``.used`` stamp, so the tier's
collection (``compiler.gc_cache``) keeps what is in use.

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

from torch.autograd import _profiler_enabled
from torch.profiler import record_function as _record_function

from ..base import MXNetError
from ..compiler.persistent import USED_STAMP

__all__ = ["SOURCES", "build_all", "build_dir", "load", "check", "call",
           "kernels_per_call", "graph_kernel_names", "capture_graph",
           "replay_counts", "nvcc_version"]

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCES = ("rms_norm.cu", "paged_attention.cu", "layer_norm.cu",
           "bias_gelu.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "fused_optimizer.cu", "dropout.cu", "gradient_compression.cu",
           "jpeg_codec.cu", "box_nms.cu", "roi_align.cu", "correlation.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# libraries of the CUDA toolkit a source links against (nvcc finds them
# beside itself, in the toolkit's lib64)
LINK_FLAGS = {"jpeg_codec.cu": ("-lnvjpeg",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_version_lock = threading.Lock()    # load() holds _lock over build_dir()
_nvcc_version = []          # read once per process
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


def nvcc_version() -> str:
    """``nvcc --version``'s output (``"none"`` where there is no
    ``nvcc``), read once per process."""
    with _version_lock:
        if not _nvcc_version:
            try:
                out = subprocess.run([_nvcc(), "--version"],
                                     capture_output=True, text=True,
                                     timeout=60, check=True).stdout
            except (MXNetError, OSError, subprocess.SubprocessError):
                out = "none"
            _nvcc_version.append(out.strip())
        return _nvcc_version[0]


def build_dir() -> Path:
    """``<disk tier>/kernels/<hash>`` for the current sources, flags and
    ``nvcc``."""
    from ..compiler import persistent

    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(LINK_FLAGS.items())).encode())
    h.update(nvcc_version().encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return persistent.kernels_dir() / h.hexdigest()[:16]


def _lib_path(out: Path, src: str) -> Path:
    return out / ("lib" + Path(src).stem + ".so")


def build_all() -> Path:
    """Compile every missing kernel library, all ``nvcc`` processes
    started together, once per process (concurrent callers share the
    one build; a failed one is tried again by the next caller); raise
    :class:`MXNetError` naming each failure. Returns the build
    directory."""
    from ..compiler.service import exec_table

    out = build_dir()
    return exec_table.get_or_build("kernels:" + out.name,
                                   lambda: _build_all(out))


def _build_all(out: Path) -> Path:
    global last_build_seconds
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
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src),
               *LINK_FLAGS.get(src, ())]
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
    kernel libraries first if needed). Another source's failed build
    does not stop this one's library from loading; its own does."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            try:
                out = build_all()
            except MXNetError:
                out = build_dir()
                if not _lib_path(out, src).exists():
                    raise
            lib = ctypes.CDLL(str(_lib_path(out, src)))
            lib.mx_error_string.argtypes = [ctypes.c_int]
            lib.mx_error_string.restype = ctypes.c_char_p
            _loaded(out, src)
            _libs[src] = lib
        return lib


def _loaded(out: Path, src: str) -> None:
    """Record this process's load of library ``src`` from build directory
    ``out``: the disk tier's stamp (the directory's last use, for the
    collection; at the first load) and the manifest's ``kernels`` entry
    of the library."""
    from ..compiler import keys, manifest

    if not _libs:
        try:
            (out / USED_STAMP).touch()
        except OSError:
            pass
    manifest.record_signature("kernels", {"build": out.name, "lib": src},
                              keys.platform())


def warm_spec(spec) -> str:
    """``compiler.warm_start``'s ``kernels`` replay: build what is missing
    and load the recorded library (one the recording process loaded, and
    no other), before its first launch."""
    src = spec.get("lib")
    if spec.get("build") != build_dir().name or src not in SOURCES:
        return "skipped"
    import torch

    if not torch.cuda.is_available():
        return "skipped"
    fresh = src not in _libs
    load(src)
    return "replayed" if fresh else "deduped"


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.mx_error_string(rc).decode(errors="replace")
        raise MXNetError(f"{what}: CUDA error {rc} ({msg})")


def call(src: str, name: str, argtypes, what: str, *args) -> None:
    """Call the C entry point ``name`` of ``csrc/<src>``, declaring its
    ``argtypes`` (an int return) on first use, and raise
    :class:`MXNetError` naming ``what`` when it returns a CUDA error.
    Under ``torch.profiler`` the call is a range named ``name``, so a
    profile attributes each kernel to its entry point (``mx.profiler``'s
    device section)."""
    lib = load(src)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if _profiler_enabled():
        with _record_function(name):
            rc = fn(*args)
    else:
        rc = fn(*args)
    check(lib, rc, what)


def kernels_per_call(fn) -> int:
    """How many kernels one call of ``fn`` enqueues on the current CUDA
    device. The call is captured into a CUDA graph, not run, and the
    graph's kernel nodes are counted (a memset or a copy is another kind
    of node). A host sync inside ``fn`` fails the capture."""
    import torch

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return len(_kernel_nodes(_driver(), graph))


def _driver():
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    return cu


def _driver_check(rc, what) -> None:
    if rc != 0:
        raise MXNetError(f"CUDA driver error {rc} in {what}")


def _kernel_nodes(cu, graph) -> list:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (made
    with ``keep_graph=True``)."""
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _driver_check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)),
                  "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _driver_check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
                  "cuGraphGetNodes")
    out, kind = [], ctypes.c_int()
    for node in nodes:
        _driver_check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
                      "cuGraphNodeGetType")
        if kind.value == 0:               # CU_GRAPH_NODE_TYPE_KERNEL
            out.append(node)
    return out


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of the driver API."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernel_names(graph) -> list:
    """The (mangled) function name of every kernel node of a captured
    ``torch.cuda.CUDAGraph`` (made with ``keep_graph=True``), read
    through the driver API; memset and copy nodes are left out."""
    cu = _driver()
    cu.cuGraphKernelNodeGetParams_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]
    cu.cuFuncGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_void_p]
    cu.cuKernelGetName.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_void_p]
    names = []
    for node in _kernel_nodes(cu, graph):
        params = _KernelNodeParams()
        _driver_check(cu.cuGraphKernelNodeGetParams_v2(
            node, ctypes.byref(params)), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            _driver_check(cu.cuFuncGetName(ctypes.byref(name), params.func),
                          "cuFuncGetName")
        else:
            _driver_check(cu.cuKernelGetName(ctypes.byref(name),
                                             params.kern), "cuKernelGetName")
        names.append(name.value.decode(errors="replace"))
    return names


_WARMUP_STREAMS = {}


def _warmup_stream(device):
    """The one side stream of ``device`` that every capture's warm-up
    call runs on. torch keeps a cuBLAS workspace per (handle, stream), so
    a new stream per capture would leave one more workspace behind at
    each capture."""
    import torch

    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    side = _WARMUP_STREAMS.get(index)
    if side is None:
        side = _WARMUP_STREAMS[index] = torch.cuda.Stream(index)
    return side


def capture_graph(body, device, pool, what):
    """Capture ``body()`` into a ``torch.cuda.CUDAGraph`` on ``device``,
    in the memory pool ``pool``: every graph of the port is captured so.
    One eager call on the device's warm-up stream comes first (cuBLAS
    workspaces, every kernel module loaded: a lazy load inside a capture
    stalls); the
    capture runs with the cyclic GC off (a graph freed inside another
    capture, ``cudaGraphExecDestroy``, would invalidate it). A capture
    launches nothing, so the kernel wrappers' launch counters are put
    back, and each replay adds the capture's delta
    (:func:`replay_counts`). Returns ``(graph, outputs, delta)``. A
    failed capture raises :class:`MXNetError` as ``"{what} failed:
    ..."``; nothing runs eagerly in its place."""
    import gc

    import torch

    from . import launch_counters

    side = _warmup_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = launch_counters()
    gc_was = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = body()
    except Exception as err:  # noqa: BLE001 - re-raised typed
        raise MXNetError(f"{what} failed: {err}") from err
    finally:
        if gc_was:
            gc.enable()
        after = launch_counters()
        for (fn, attr) in after:            # a capture launches nothing
            setattr(fn, attr, before.get((fn, attr), 0))
    graph.instantiate()
    return graph, out, {k: n - before.get(k, 0) for k, n in after.items()
                        if n != before.get(k, 0)}


def replay_counts(delta) -> None:
    """Move the launch counters by one replay of a graph whose capture
    returned ``delta`` (:func:`capture_graph`)."""
    for (fn, attr), n in delta.items():
        setattr(fn, attr, getattr(fn, attr) + n)
