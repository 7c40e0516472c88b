"""``mx.rtc`` of the port: a user's CUDA kernels compiled at run time by
NVRTC and launched on NDArrays (counterpart of ``mxnet_tpu/rtc.py``,
whose ``PallasKernel._build`` wraps a user's Pallas kernel in a
``pallas_call``, ``:62``; reference: upstream MXNet's
``python/mxnet/rtc.py`` and ``src/common/rtc.cc``)::

    mod = mx.rtc.CudaModule(source, options=(), exports=())
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    k.launch([x, y, 3.0], mx.gpu(0), grid_dims, block_dims, shared_mem=0)

``launch`` writes through the pointers it is given and returns None.
There is no CPU route, as upstream has none: a ``CudaModule`` on a
machine without a card or without NVRTC, and a launch on ``mx.cpu()``,
raise :class:`MXNetError`. ``PallasModule`` raises, pointing here (the
mirror of the reference's ``CudaModule``, ``rtc.py:119-123``).

Where the trouble lies, and what this module does about it:

* Finding the libraries: ``$CUDA_HOME/lib64/libnvrtc.so.12`` first (CUDA
  at ``/usr/local/cuda`` when ``CUDA_HOME`` is unset), then whatever
  ``libnvrtc.so.12`` the loader finds (torch's CUDA wheels bring one),
  and the driver's ``libcuda.so.1``, all through ``ctypes``. A miss
  raises naming every path tried; nothing falls back.
* Compiling: to a CUBIN for ``sm_90a`` (``nvrtcGetCUBIN``), not to PTX
  for a later JIT, with ``-std=c++17`` and ``-I$CUDA_HOME/include`` (for
  ``cuda_fp16.h`` and ``cuda_bf16.h``); the user's ``options`` come
  after these. A failed compile raises with NVRTC's log.
* Templates: each name in ``exports`` (``"axpy<float>"``) is added with
  ``nvrtcAddNameExpression`` before the compile and looked up with
  ``nvrtcGetLoweredName`` after it; ``extern "C"`` kernels need neither.
* The CUDA context: PyTorch owns each card's primary context. Loading
  and launching make it current in the calling thread
  (``cuDevicePrimaryCtxRetain``, ``cuCtxSetCurrent``), since a server
  thread is not the thread that built the module; one ``CUmodule`` is
  cached per card, as upstream caches one per ``Context``.
* Signatures are parsed as upstream's ``get_kernel`` parses them:
  ``const``, a type, an optional ``*``, a name. A pointer takes an
  NDArray, a value a Python scalar.
* Before ``cuLaunchKernel``: each NDArray is on the launch context, has
  the signature's dtype and is contiguous (a strided view raises rather
  than being copied: the kernel writes through the pointer); grid and
  block are at most three positive ints within the card's limits, a
  block at most 1024 threads; dynamic shared memory above 48 KiB is
  enabled with ``cuFuncSetAttribute`` first and above 227 KiB raises.
  A non-zero return of ``cuLaunchKernel`` raises: a refused launch never
  runs, and a later synchronise would not report it.
* ``kernelParams`` is an array of ``void*``, each pointing to a ctypes
  value of the declared C type (an ``__half`` or ``__nv_bfloat16``
  scalar as the ``uint16`` of its bits), all kept alive over the call.
* The launch goes on PyTorch's current stream of the card, with no
  synchronisation, so the kernel is ordered with the NDArray ops before
  and after it, as the reference engine orders an rtc launch.
* The disk tier and the table: a module's CUBIN is keyed by the
  fingerprint of (source, options, name expressions, target arch, the
  card's ``sm_XY``, the NVRTC version) (:func:`cubin_key`). It is built
  once per process through the compilation service's single-flight
  ``ExecutableTable``, and read back from
  ``<MXNET_XLA_CACHE_DIR>/nvrtc/<sm>-<nvrtc version>/<fingerprint>.cubin``
  (the lowered names beside it, ``.names``) before NVRTC is asked, then
  loaded with ``cuModuleLoadData``; a compile writes both atomically.
  ``CudaModule.compiles`` and ``CudaModule.disk_loads`` count the two
  ways a process got its images. Each module is journaled (site
  ``nvrtc``) for ``compiler.warm_start``.
* Writes: a non-``const`` pointer argument is written as any NDArray
  write is (raising under ``autograd.record()`` for an array on the
  tape, copying on write where a live graph saved it), and its versions
  (PyTorch's counter and the NDArray's) are bumped after the launch.
"""
from __future__ import annotations

import ctypes
import json
import logging
import os
import re
import threading
import time
import weakref
from typing import Dict, List, NamedTuple, Sequence

import torch

from .base import MXNetError, integer_types, numeric_types
from .context import Context

_log = logging.getLogger(__name__)

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "parse_signature",
           "check_dims", "check_shared_mem", "check_args", "cubin_key",
           "cubin_path", "live_kernels"]

# upstream's _DTYPE_CPP_TO_NP, and __nv_bfloat16 for the bf16 arrays
_CPP_DTYPES = {
    "float": torch.float32, "double": torch.float64, "__half": torch.float16,
    "uint8_t": torch.uint8, "int": torch.int32, "int32_t": torch.int32,
    "int8_t": torch.int8, "char": torch.int8, "int64_t": torch.int64,
    "__nv_bfloat16": torch.bfloat16,
}
_CTYPES = {
    torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
    torch.float16: ctypes.c_uint16, torch.bfloat16: ctypes.c_uint16,
    torch.uint8: ctypes.c_uint8, torch.int32: ctypes.c_int32,
    torch.int8: ctypes.c_int8, torch.int64: ctypes.c_int64,
}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

ARCH = "sm_90a"
MAX_THREADS = 1024
MAX_BLOCK = (1024, 1024, 64)
MAX_GRID = (2 ** 31 - 1, 65535, 65535)
STATIC_SMEM = 48 << 10              # what a launch gets without opting in
MAX_SMEM = 232448                   # 227 KiB, the most a block may have
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8


class Arg(NamedTuple):
    """One kernel parameter: ``const``, its element or value dtype, and
    whether it is a pointer."""
    const: bool
    dtype: torch.dtype
    pointer: bool


def parse_signature(signature: str) -> List[Arg]:
    """The parameters of a kernel signature such as ``"const float *x,
    float *y, float alpha"`` (upstream ``CudaModule.get_kernel``)."""
    out = []
    for text in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(text)
        if not m or m.group(2) == "const":
            raise MXNetError(f'invalid kernel parameter "{text.strip()}": '
                             'must be of the form "(const) type (*) (name)"')
        if m.group(2) not in _CPP_DTYPES:
            raise MXNetError(f'unsupported kernel parameter type in '
                             f'"{text.strip()}"; supported: '
                             f'{", ".join(_CPP_DTYPES)}')
        out.append(Arg(bool(m.group(1)), _CPP_DTYPES[m.group(2)],
                       bool(m.group(3))))
    return out


def _dims(name, dims) -> tuple:
    if isinstance(dims, int):
        dims = (dims,)
    ok = isinstance(dims, (tuple, list)) and 1 <= len(dims) <= 3
    for d in dims if ok else ():
        if not isinstance(d, integer_types) or isinstance(d, bool) or d <= 0:
            ok = False
    if not ok:
        raise MXNetError(f"{name} must be a tuple of one to three positive "
                         f"ints, not {dims!r}")
    return tuple(int(d) for d in dims) + (1,) * (3 - len(dims))


def check_dims(grid_dims, block_dims) -> tuple:
    """``(grid, block)`` as 3-tuples; raises for dims that are not one to
    three positive ints, a block of more than 1024 threads, or dims
    beyond the card's limits."""
    grid = _dims("grid_dims", grid_dims)
    block = _dims("block_dims", block_dims)
    threads = block[0] * block[1] * block[2]
    if threads > MAX_THREADS:
        raise MXNetError(f"block_dims {block} is {threads} threads; a block "
                         f"has at most {MAX_THREADS}")
    for name, dims, limits in (("grid_dims", grid, MAX_GRID),
                               ("block_dims", block, MAX_BLOCK)):
        if any(d > lim for d, lim in zip(dims, limits)):
            raise MXNetError(f"{name} {dims} exceeds the card's limits "
                             f"{limits}")
    return grid, block


def check_shared_mem(shared_mem) -> int:
    if not isinstance(shared_mem, int) or shared_mem < 0:
        raise MXNetError(f"shared_mem must be a non-negative int, not "
                         f"{shared_mem!r}")
    if shared_mem > MAX_SMEM:
        raise MXNetError(f"shared_mem {shared_mem} B is above the "
                         f"{MAX_SMEM} B (227 KiB) a block may have")
    return shared_mem


def _bits16(value, dtype) -> int:
    t = torch.tensor(float(value), dtype=dtype)
    return t.view(torch.int16).item() & 0xFFFF


def _scalar(value, arg: Arg, i: int):
    """The ctypes value of a scalar argument."""
    if not isinstance(value, numeric_types) or isinstance(value, bool):
        raise MXNetError(f"argument {i} is a {arg.dtype} value: it takes a "
                         f"Python scalar, not {type(value).__name__}")
    if arg.dtype in (torch.float16, torch.bfloat16):
        return ctypes.c_uint16(_bits16(value, arg.dtype))
    if not arg.dtype.is_floating_point:
        if float(value) != int(value):
            raise MXNetError(f"argument {i} is a {arg.dtype} value; "
                             f"{value!r} is not an integer")
        value = int(value)
    return _CTYPES[arg.dtype](value)


def check_args(sig: Sequence[Arg], args, ctx: Context) -> list:
    """Check the launch arguments against the signature: each pointer an
    NDArray on ``ctx`` of the signature's dtype and contiguous, each
    value a Python scalar. Returns the ctypes value of each scalar and
    None for each pointer."""
    from .ndarray import NDArray

    if len(args) != len(sig):
        raise MXNetError(f"the kernel takes {len(sig)} arguments, "
                         f"{len(args)} were given")
    out = []
    for i, (a, arg) in enumerate(zip(args, sig)):
        if not arg.pointer:
            out.append(_scalar(a, arg, i))
            continue
        if not isinstance(a, NDArray):
            raise MXNetError(f"argument {i} is a pointer: it takes an "
                             f"NDArray, not {type(a).__name__}")
        if a.context != ctx:
            raise MXNetError(f"argument {i} is on {a.context}, the launch "
                             f"on {ctx}")
        t = a._data
        if t.dtype != arg.dtype:
            raise MXNetError(f"argument {i} is {t.dtype}, the signature "
                             f"says {arg.dtype}")
        if not t.is_contiguous():
            raise MXNetError(
                f"argument {i} is not contiguous (a strided view): the "
                "kernel writes through its pointer, so it is not copied; "
                "pass a contiguous array")
        out.append(None)
    return out


# ---------------------------------------------------------------------------
# NVRTC and the driver API, through ctypes
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_NVRTC_API = {
    "nvrtcCreateProgram": [_PP, ctypes.c_char_p, ctypes.c_char_p,
                           ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                           ctypes.POINTER(ctypes.c_char_p)],
    "nvrtcAddNameExpression": [_P, ctypes.c_char_p],
    "nvrtcCompileProgram": [_P, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_char_p)],
    "nvrtcGetProgramLogSize": [_P, ctypes.POINTER(ctypes.c_size_t)],
    "nvrtcGetProgramLog": [_P, ctypes.c_char_p],
    "nvrtcGetCUBINSize": [_P, ctypes.POINTER(ctypes.c_size_t)],
    "nvrtcGetCUBIN": [_P, ctypes.c_char_p],
    "nvrtcGetLoweredName": [_P, ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_char_p)],
    "nvrtcDestroyProgram": [_PP],
    "nvrtcVersion": [ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_int)],
}
_CUDA_API = {
    "cuInit": [ctypes.c_uint],
    "cuDeviceGet": [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
    "cuDevicePrimaryCtxRetain": [_PP, ctypes.c_int],
    "cuCtxSetCurrent": [_P],
    "cuModuleLoadData": [_PP, _P],
    "cuModuleUnload": [_P],
    "cuModuleGetFunction": [_PP, _P, ctypes.c_char_p],
    "cuFuncSetAttribute": [_P, ctypes.c_int, ctypes.c_int],
    "cuLaunchKernel": [_P, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_uint, _P, _PP, _PP],
    "cuGetErrorString": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)],
}


class _Driver:
    """NVRTC and the CUDA driver, loaded once per process, and each
    card's primary context."""

    def __init__(self):
        cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        self.include = os.path.join(cuda_home, "include")
        self.nvrtc = self._open(
            "NVRTC", [os.path.join(cuda_home, "lib64", "libnvrtc.so.12"),
                      "libnvrtc.so.12"], _NVRTC_API)
        self.nvrtc.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        self.nvrtc.nvrtcGetErrorString.restype = ctypes.c_char_p
        self.cuda = self._open("the CUDA driver", ["libcuda.so.1"],
                               _CUDA_API)
        self.cu("cuInit", 0)
        self._contexts: Dict[int, ctypes.c_void_p] = {}

    @staticmethod
    def _open(what, paths, api):
        tried = []
        for path in paths:
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                tried.append(f"{path} ({e})")
                continue
            for name, argtypes in api.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            return lib
        raise MXNetError(f"mx.rtc: {what} not found; tried "
                         + "; ".join(tried))

    def version(self) -> str:
        """NVRTC's ``major.minor``."""
        major, minor = ctypes.c_int(), ctypes.c_int()
        self.rtc("nvrtcVersion", ctypes.byref(major), ctypes.byref(minor))
        return f"{major.value}.{minor.value}"

    def rtc(self, name, *args) -> None:
        rc = getattr(self.nvrtc, name)(*args)
        if rc != 0:
            msg = self.nvrtc.nvrtcGetErrorString(rc).decode()
            raise MXNetError(f"mx.rtc: {name} failed: {msg} ({rc})")

    def error(self, rc: int) -> str:
        msg = ctypes.c_char_p()
        self.cuda.cuGetErrorString(rc, ctypes.byref(msg))
        return f"{(msg.value or b'unknown error').decode()} ({rc})"

    def cu(self, name, *args) -> None:
        rc = getattr(self.cuda, name)(*args)
        if rc != 0:
            raise MXNetError(f"mx.rtc: {name} failed: {self.error(rc)}")

    def make_current(self, device: int) -> None:
        """Make the card's primary context (PyTorch's) current in this
        thread."""
        ctx = self._contexts.get(device)
        if ctx is None:
            torch.cuda.init()
            dev = ctypes.c_int()
            self.cu("cuDeviceGet", ctypes.byref(dev), device)
            ctx = ctypes.c_void_p()
            self.cu("cuDevicePrimaryCtxRetain", ctypes.byref(ctx), dev)
            self._contexts[device] = ctx
        self.cu("cuCtxSetCurrent", ctx)


_driver_lock = threading.Lock()
_driver_instance = None


def _driver() -> _Driver:
    global _driver_instance
    with _driver_lock:
        if _driver_instance is None:
            _driver_instance = _Driver()
        return _driver_instance


def cubin_key(source: str, options: Sequence[str], exports: Sequence[str],
              arch: str, sm: str, nvrtc_version: str) -> str:
    """The fingerprint a module's CUBIN is kept under: everything that
    decides the image NVRTC would produce."""
    from .compiler import keys

    return keys.fingerprint(("nvrtc", source, tuple(options),
                             tuple(exports), arch, sm, nvrtc_version))


def cubin_path(fp: str, sm: str, nvrtc_version: str):
    """Where the disk tier keeps the CUBIN of fingerprint ``fp``."""
    from .compiler import persistent

    return persistent.nvrtc_dir(sm, nvrtc_version) / f"{fp}.cubin"


def _read_image(path, exports):
    """``(cubin buffer, lowered names)`` from the disk tier, or None when
    the entry is absent or incomplete."""
    from .compiler import persistent

    data = persistent.read_entry(path)
    if data is None:
        return None
    lowered = {}
    if exports:
        names = persistent.read_entry(path.with_suffix(".names"))
        try:
            stored = json.loads(names.decode()) if names else None
        except ValueError:
            stored = None
        if not isinstance(stored, dict) or set(stored) != set(exports):
            return None
        lowered = {k: v.encode() for k, v in stored.items()}
    return ctypes.create_string_buffer(data, len(data)), lowered


def _write_image(path, cubin, lowered) -> None:
    """Keep a compiled image: the names first, the CUBIN last, each
    written atomically, so a reader that finds the CUBIN finds both."""
    from .compiler import persistent

    if lowered:
        persistent.write_atomic(path.with_suffix(".names"), json.dumps(
            {k: v.decode() for k, v in lowered.items()}).encode())
    persistent.write_atomic(path, cubin.raw)


_live_kernels = weakref.WeakSet()


def live_kernels() -> list:
    """The :class:`CudaKernel` objects alive now (their launch counters
    are ``kernels.launch_counters()``'s too)."""
    return list(_live_kernels)


class CudaModule:
    """A CUDA source compiled by NVRTC (reference: upstream
    ``mx.rtc.CudaModule``). ``options`` are NVRTC options added after the
    port's own; ``exports`` the template instantiations to compile and
    look up by name (``"axpy<float>"``). The time to get the image (a
    compile, a read from the disk tier, or the table's copy) is kept in
    ``compile_ms``, where it came from in ``image_source`` (``"nvrtc"``,
    ``"disk"`` or ``"table"``)."""

    compiles = 0        # NVRTC compiles this process ran
    disk_loads = 0      # images read back from the disk tier

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not torch.cuda.is_available():
            raise MXNetError("mx.rtc.CudaModule compiles CUDA kernels for a "
                             "card, and torch.cuda.is_available() is False "
                             "(there is no CPU route)")
        self._drv = _driver()
        self.options = [f"--gpu-architecture={ARCH}", "-std=c++17",
                        f"-I{self._drv.include}", *options]
        self.exports = list(exports)
        t0 = time.perf_counter()
        (self._cubin, self._lowered), self.image_source = _image(
            self._drv, source, self.options, self.exports)
        self.compile_ms = (time.perf_counter() - t0) * 1e3
        from .compiler import keys, manifest

        manifest.record_signature(
            "nvrtc", {"source": source, "options": tuple(options),
                      "exports": tuple(self.exports)}, keys.platform())
        self._lock = threading.Lock()
        self._modules: Dict[int, ctypes.c_void_p] = {}
        self._functions: Dict[tuple, ctypes.c_void_p] = {}

    @staticmethod
    def _compile(drv, source: str, options, exports):
        CudaModule.compiles += 1
        prog = ctypes.c_void_p()
        drv.rtc("nvrtcCreateProgram", ctypes.byref(prog), source.encode(),
                b"mx_rtc.cu", 0, None, None)
        try:
            for name in exports:
                drv.rtc("nvrtcAddNameExpression", prog, name.encode())
            opts = (ctypes.c_char_p * len(options))(
                *[o.encode() for o in options])
            rc = drv.nvrtc.nvrtcCompileProgram(prog, len(options), opts)
            if rc != 0:
                size = ctypes.c_size_t()
                drv.rtc("nvrtcGetProgramLogSize", prog, ctypes.byref(size))
                log = ctypes.create_string_buffer(size.value)
                drv.rtc("nvrtcGetProgramLog", prog, log)
                raise MXNetError(
                    "mx.rtc: NVRTC failed to compile the module ("
                    + drv.nvrtc.nvrtcGetErrorString(rc).decode() + "):\n"
                    + log.value.decode(errors="replace"))
            size = ctypes.c_size_t()
            drv.rtc("nvrtcGetCUBINSize", prog, ctypes.byref(size))
            cubin = ctypes.create_string_buffer(size.value)
            drv.rtc("nvrtcGetCUBIN", prog, cubin)
            lowered = {}
            for name in exports:
                out = ctypes.c_char_p()
                drv.rtc("nvrtcGetLoweredName", prog, name.encode(),
                        ctypes.byref(out))
                lowered[name] = out.value
            return cubin, lowered
        finally:
            drv.nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` (an ``extern "C"`` name, or one of
        ``exports``) with its parameters declared by ``signature``."""
        return CudaKernel(self, name, parse_signature(signature))

    def _function(self, device: int, name: str) -> ctypes.c_void_p:
        """The kernel on the card, its module loaded there on first use;
        the card's context is made current in this thread."""
        self._drv.make_current(device)
        fn = self._functions.get((device, name))
        if fn is not None:
            return fn
        with self._lock:
            mod = self._modules.get(device)
            if mod is None:
                mod = ctypes.c_void_p()
                self._drv.cu("cuModuleLoadData", ctypes.byref(mod),
                             ctypes.cast(self._cubin, ctypes.c_void_p))
                self._modules[device] = mod
            fn = ctypes.c_void_p()
            symbol = self._lowered.get(name, name.encode())
            self._drv.cu("cuModuleGetFunction", ctypes.byref(fn), mod, symbol)
            self._functions[(device, name)] = fn
        return fn


def _image(drv, source, options, exports):
    """``((cubin, lowered names), where from)`` for a module: the table's
    copy, else the disk tier's, else an NVRTC compile (kept on disk when
    the tier is on and the compile took at least
    ``MXNET_XLA_CACHE_MIN_COMPILE_S``)."""
    from .compiler import keys, persistent
    from .compiler.service import exec_table

    version = drv.version()
    sm = keys.platform().split(":")[-1]
    fp = cubin_key(source, options, exports, ARCH, sm, version)
    path = cubin_path(fp, sm, version) if persistent.cache_dir() else None
    where = []

    def build():
        if path is not None:
            got = _read_image(path, exports)
            if got is not None:
                CudaModule.disk_loads += 1
                where.append("disk")
                return got
        t0 = time.perf_counter()
        cubin, lowered = CudaModule._compile(drv, source, options, exports)
        if path is not None and \
                time.perf_counter() - t0 >= persistent.min_compile_s():
            try:
                _write_image(path, cubin, lowered)
            except OSError:
                # the tier is best-effort: an unwritable directory costs
                # the next process a compile, never this one its module
                _log.debug("mx.rtc: CUBIN not kept at %s", path,
                           exc_info=True)
        where.append("nvrtc")
        return cubin, lowered

    image = exec_table.get_or_build("nvrtc:" + fp, build)
    return image, (where[0] if where else "table")


def warm_spec(spec) -> str:
    """``compiler.warm_start``'s ``nvrtc`` replay: get the module's image
    into the table (from disk, else NVRTC) without loading it."""
    if not torch.cuda.is_available():
        return "skipped"
    drv = _driver()
    options = [f"--gpu-architecture={ARCH}", "-std=c++17",
               f"-I{drv.include}", *spec["options"]]
    _, where = _image(drv, spec["source"], options, list(spec["exports"]))
    return "deduped" if where == "table" else "replayed"


class CudaKernel:
    """A kernel of a :class:`CudaModule` with its declared parameters
    (reference: upstream ``mx.rtc.CudaKernel``). ``launches`` counts the
    launches made."""

    def __init__(self, module: CudaModule, name: str, sig: List[Arg]):
        self._module = module
        self.name = name
        self.signature = sig
        self.launches = 0
        self._smem_enabled: Dict[int, int] = {}
        _live_kernels.add(self)

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU context) over ``grid_dims`` blocks of
        ``block_dims`` threads with ``shared_mem`` bytes of dynamic shared
        memory, on PyTorch's current stream; returns None."""
        ctx = ctx if isinstance(ctx, Context) else Context(ctx)
        if ctx.device_type != "gpu":
            raise MXNetError(f"mx.rtc kernels launch on a GPU context, not "
                             f"{ctx}: there is no CPU route")
        grid, block = check_dims(grid_dims, block_dims)
        smem = check_shared_mem(shared_mem)
        values = check_args(self.signature, args, ctx)
        written = []
        for i, (a, arg) in enumerate(zip(args, self.signature)):
            if arg.pointer:
                if arg.const:
                    t = a._data
                else:
                    t = a._prepare_write()
                    written.append((a, t))
                values[i] = ctypes.c_void_p(t.data_ptr())
        device = ctx.device_id
        fn = self._module._function(device, self.name)
        if smem > STATIC_SMEM and self._smem_enabled.get(device, 0) < smem:
            self._module._drv.cu(
                "cuFuncSetAttribute", fn,
                _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, smem)
            self._smem_enabled[device] = smem
        params = (ctypes.c_void_p * len(values))(
            *[ctypes.addressof(v) for v in values])
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._module._drv.cuda.cuLaunchKernel(
            fn, *grid, *block, smem, stream, params, None)
        if rc != 0:
            raise MXNetError(f"mx.rtc: launch of {self.name} refused: "
                             f"{self._module._drv.error(rc)}")
        self.launches += 1
        for a, t in written:
            torch.autograd.graph.increment_version(t)
            a._wrote()


class PallasModule:
    def __init__(self, *a, **k):
        raise MXNetError(
            "mx.rtc.PallasModule compiles Pallas kernels for a TPU; on the "
            "GPU write the kernel in CUDA C++ and compile it with "
            "mx.rtc.CudaModule")
