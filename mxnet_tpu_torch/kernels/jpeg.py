"""JPEG decode and encode on the card through nvJPEG.

The C side is ``csrc/jpeg_codec.cu``, a plain C interface over the CUDA
toolkit's nvJPEG, built with the kernels (linked with ``-lnvjpeg``) and
loaded with ``ctypes``. It ports no TPU kernel: the reference decodes
with Pillow on the host (``mxnet_tpu/image/__init__.py:81``); the CPU
path of ``mx.image`` still does, and this module is the card's.

* :func:`decode` one file (``nvjpegDecode``, the hybrid backend), as
  ``mx.image.imdecode`` on the card;
* :func:`decode_batch` a batch in one call (``nvjpegDecodeBatched``), as
  ``ImageIter`` on the card: on the hardware decoder (the H100's NVJPG
  engines) when it takes every file of the batch, else on the GPU-hybrid
  backend; :data:`last_backend` says which ran;
* :func:`encode` an image (``nvjpegEncodeImage``, 4:2:0 as Pillow's
  default for RGB), as ``recordio.pack_img`` on the card.

Outputs are tensors allocated by torch on the image's device and written
on ``torch.cuda.current_stream()``. One nvJPEG handle per device and
backend; one decode state per thread, device, backend and stream, and
one encoder state per thread and device (nvJPEG's states are not
thread-safe, and a state's pinned and device buffers serve one stream's
decodes in order: two streams never share one, so an iterator on a
stream of its own and a decode on the current stream cannot overwrite
each other's buffers). There is no fallback: a missing
library, a file nvJPEG refuses or a failed call raises
:class:`MXNetError`; nothing hands a card image to the CPU.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from . import _build

__all__ = ["decode", "decode_batch", "encode", "image_info", "version",
           "last_backend"]

_SRC = "jpeg_codec.cu"
# nvjpegBackend_t
_DEFAULT, _GPU_HYBRID, _HARDWARE = 0, 2, 3
# nvjpegOutputFormat_t
_FORMATS = {"RGB": 5, "BGR": 6, "Y": 2}
# the chroma of 4:2:x files is upsampled with interpolation, as libjpeg's
# "fancy upsampling" (Pillow's decoder) does, not by repeating samples
_FLAGS = 1 << 5                    # NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION
SUBSAMPLING = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0", 3: "4:4:0", 4: "4:1:1",
               5: "4:1:0", 6: "gray", 7: "4:1:0v", -1: "unknown"}
# nvjpegChromaSubsampling_t for encode
_CSS_420 = 2

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIG = {
    "mx_jpeg_version": [ctypes.POINTER(ctypes.c_int)],
    "mx_jpeg_create": [ctypes.c_int, ctypes.c_uint, _PP],
    "mx_jpeg_state_create": [_P, _PP],
    "mx_jpeg_info": [_P, ctypes.c_char_p, ctypes.c_size_t]
                    + [ctypes.POINTER(ctypes.c_int)] * 4,
    "mx_jpeg_batched_supported": [_P, ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_int)],
    "mx_jpeg_decode": [_P, _P, ctypes.c_char_p, ctypes.c_size_t,
                       ctypes.c_int, _P, ctypes.c_size_t, _P],
    "mx_jpeg_decode_batched": [_P, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                               _P, _P, ctypes.c_int, _P],
    "mx_jpeg_encoder_create": [_P, _P, _PP],
    "mx_jpeg_encode": [_P, _P, _P, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _P, ctypes.c_char_p, ctypes.c_size_t,
                       ctypes.POINTER(ctypes.c_size_t)],
}

_lock = threading.Lock()
_handles = {}                 # (device index, backend) -> handle or None
hardware_refusal = None       # why the hardware backend was refused
_local = threading.local()    # per thread: states and encoders by key
last_backend = None           # "hardware" or "gpu_hybrid", last batch's


def _call(name, what, *args) -> None:
    _build.call(_SRC, name, _SIG[name], what, *args)


def _check_jpeg(data) -> bytes:
    data = bytes(data)
    if data[:2] != b"\xff\xd8":                 # JPEG's SOI marker
        raise MXNetError(
            "the card decodes JPEG only (nvJPEG); this buffer is not a JPEG "
            "file. PNG and the other codecs the reference reads through "
            "Pillow are ROADMAP.md queue 1 item 10 (image codecs); decode "
            "it on the CPU (ctx=mx.cpu())")
    return data


def _index(device) -> int:
    device = torch.device(device)
    if device.type != "cuda":
        raise MXNetError(f"nvJPEG decodes on a CUDA device, not {device}")
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _handle(dev: int, backend: int):
    """The device's handle of ``backend``, made once; ``None`` when the
    library or the card does not offer that backend (asked again never)."""
    global hardware_refusal
    key = (dev, backend)
    with _lock:
        if key not in _handles:
            h = ctypes.c_void_p()
            with torch.cuda.device(dev):
                lib = _build.load(_SRC)
                fn = lib.mx_jpeg_create
                fn.argtypes, fn.restype = _SIG["mx_jpeg_create"], ctypes.c_int
                rc = fn(backend, _FLAGS, ctypes.byref(h))
            if rc != 0 and backend == _HARDWARE:
                hardware_refusal = lib.mx_error_string(rc).decode()
                _handles[key] = None       # no NVJPG engine on this card
            else:
                _build.check(lib, rc, f"nvjpegCreateEx(backend {backend})")
                _handles[key] = h.value
        return _handles[key]


def _state(dev: int, backend: int, stream: int):
    """This thread's decode state for ``backend`` on ``stream`` of card
    ``dev``: ``[state, (n, format) the batch was initialised for]``. At
    most one per stream, and torch hands out streams from a fixed pool,
    so a thread holds a bounded number."""
    states = getattr(_local, "states", None)
    if states is None:
        states = _local.states = {}
    key = (dev, backend, stream)
    if key not in states:
        s = ctypes.c_void_p()
        _call("mx_jpeg_state_create", "nvjpegJpegStateCreate",
              _handle(dev, backend), ctypes.byref(s))
        states[key] = [s.value, None]     # state, (n, format) initialised
    return states[key]


def version() -> str:
    v = ctypes.c_int()
    _call("mx_jpeg_version", "nvjpegGetProperty", ctypes.byref(v))
    return f"{v.value // 1000}.{v.value // 10 % 100}.{v.value % 10}"


def image_info(data, device=None) -> tuple:
    """``(components, subsampling, width, height)`` from the header;
    ``subsampling`` is a name of :data:`SUBSAMPLING`."""
    data = _check_jpeg(data)
    dev = _index(device if device is not None else "cuda")
    c, s, w, h = (ctypes.c_int() for _ in range(4))
    _call("mx_jpeg_info", "nvjpegGetImageInfo", _handle(dev, _DEFAULT),
          data, len(data), ctypes.byref(c), ctypes.byref(s), ctypes.byref(w),
          ctypes.byref(h))
    return c.value, SUBSAMPLING.get(s.value, "unknown"), w.value, h.value


def _out(data, dev, fmt):
    _, _, w, h = image_info(data, dev)
    c = 1 if fmt == "Y" else 3
    return torch.empty((h, w, c), dtype=torch.uint8,
                       device=torch.device("cuda", dev))


def _fmt(fmt: str) -> int:
    if fmt not in _FORMATS:
        raise MXNetError(f"output format {fmt!r} is not one of "
                         f"{sorted(_FORMATS)}")
    return _FORMATS[fmt]


def decode(data, device=None, fmt: str = "RGB") -> torch.Tensor:
    """Decode one JPEG file into an ``(H, W, 3)`` uint8 tensor (``fmt``
    "RGB" or "BGR") or ``(H, W, 1)`` ("Y", the luma plane) on ``device``
    (default: the current card), on its current stream."""
    data = _check_jpeg(data)
    dev = _index(device if device is not None else "cuda")
    code = _fmt(fmt)
    out = _out(data, dev, fmt)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("mx_jpeg_decode", "nvjpegDecode", _handle(dev, _DEFAULT),
              _state(dev, _DEFAULT, stream)[0], data, len(data), code,
              out.data_ptr(), out.stride(0), stream)
    decode.launches += 1
    return out


decode.launches = 0


def _batch_backend(dev, datas) -> int:
    """The hardware decoder when the card has one and it takes every
    file, else the GPU-hybrid backend."""
    h = _handle(dev, _HARDWARE)
    if h is None:
        return _GPU_HYBRID
    ok = ctypes.c_int()
    for d in datas:
        _call("mx_jpeg_batched_supported", "nvjpegDecodeBatchedSupported",
              h, d, len(d), ctypes.byref(ok))
        if not ok.value:
            return _GPU_HYBRID
    return _HARDWARE


def decode_batch(datas, device=None, fmt: str = "RGB") -> list:
    """Decode a list of JPEG files in one batched nvJPEG call; returns
    their tensors, each as :func:`decode` gives it. The hardware decoder
    takes the batch when the card has one and it takes every file, else
    the GPU-hybrid backend; ``last_backend`` records the backend that
    ran."""
    global last_backend
    datas = [_check_jpeg(d) for d in datas]
    if not datas:
        return []
    dev = _index(device if device is not None else "cuda")
    code = _fmt(fmt)
    outs = [_out(d, dev, fmt) for d in datas]
    backend = _batch_backend(dev, datas)
    n = len(datas)
    bufs = (ctypes.c_char_p * n)(*datas)
    lens = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    pitches = (ctypes.c_size_t * n)(*[o.stride(0) for o in outs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        state = _state(dev, backend, stream)
        init = int(state[1] != (n, code))
        _call("mx_jpeg_decode_batched", "nvjpegDecodeBatched",
              _handle(dev, backend), state[0], n, bufs, lens, code, ptrs,
              pitches, init, stream)
    state[1] = (n, code)
    last_backend = "hardware" if backend == _HARDWARE else "gpu_hybrid"
    decode_batch.launches += 1
    return outs


decode_batch.launches = 0


def _encoder(dev):
    encs = getattr(_local, "encoders", None)
    if encs is None:
        encs = _local.encoders = {}
    if dev not in encs:
        e = ctypes.c_void_p()
        with torch.cuda.device(dev):
            _call("mx_jpeg_encoder_create", "nvjpegEncoderStateCreate",
                  _handle(dev, _DEFAULT),
                  torch.cuda.current_stream(dev).cuda_stream,
                  ctypes.byref(e))
        encs[dev] = e.value
    return encs[dev]


def encode(img: torch.Tensor, quality: int = 95) -> bytes:
    """Encode an ``(H, W, 3)`` RGB or ``(H, W)``/``(H, W, 1)`` grayscale
    uint8 tensor on the card as a baseline JPEG at ``quality`` (4:2:0
    chroma for RGB). Waits for the card: the file comes back to the
    host."""
    if img.device.type != "cuda" or img.dtype != torch.uint8:
        raise MXNetError(f"encode takes a uint8 CUDA tensor, not "
                         f"{img.dtype} on {img.device}")
    if img.dim() == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if not (img.dim() == 2 or (img.dim() == 3 and img.shape[2] == 3)):
        raise MXNetError(f"encode takes (H, W, 3) or (H, W) images, not "
                         f"{tuple(img.shape)}")
    if not 1 <= int(quality) <= 100:
        raise MXNetError(f"JPEG quality {quality} is not in 1..100")
    img = img.contiguous()
    dev = _index(img.device)
    h, w = img.shape[:2]
    channels = 1 if img.dim() == 2 else 3
    capacity = 2 * h * w * channels + (1 << 16)
    buf = ctypes.create_string_buffer(capacity)
    n = ctypes.c_size_t()
    with torch.cuda.device(dev):
        _call("mx_jpeg_encode", "nvjpegEncodeImage", _handle(dev, _DEFAULT),
              _encoder(dev), img.data_ptr(), img.stride(0), w, h, channels,
              int(quality), _CSS_420,
              torch.cuda.current_stream(dev).cuda_stream, buf, capacity,
              ctypes.byref(n))
    encode.launches += 1
    return buf.raw[:n.value]


encode.launches = 0
