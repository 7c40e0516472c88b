"""``mx.runtime`` — feature detection (counterpart of
``mxnet_tpu/runtime.py``; reference ``python/mxnet/runtime.py`` over
``src/libinfo.cc``).

MXNet's feature names, each probed on this build and machine rather than
read from compile-time flags: ``CUDA``, ``CUDNN``, ``NCCL``,
``CUDA_RTC`` (NVRTC loads), ``NVJPEG`` (the card's JPEG codec: the CUDA
toolkit's libnvjpeg loads), ``OPENCV`` (none: the CPU codec is Pillow,
``IMAGE_CODECS``, found without importing it), ``MKLDNN``, ``OPENMP``, ``DIST_KVSTORE``,
``PROFILER``, ``NATIVE_RECORDIO`` and the constant ones. The reference's
TPU probes (``TPU``, ``PALLAS``, ``FLASH_ATTENTION``, ``X64``) are not
carried over.
"""
from __future__ import annotations

import collections
import ctypes
import importlib.util
import os

__all__ = ["Feature", "feature_list", "Features"]

Feature = collections.namedtuple("Feature", ["name", "enabled"])


def _loads(names) -> bool:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for name in names:
        for path in (os.path.join(cuda_home, "lib64", name), name):
            try:
                ctypes.CDLL(path)
            except OSError:
                continue
            return True
    return False


def _probe():
    import torch

    feats = {}

    def add(name, fn):
        try:
            feats[name] = bool(fn())
        except Exception:  # noqa: BLE001 - a probe that fails is off
            feats[name] = False

    cuda = torch.cuda.is_available()
    add("CUDA", lambda: cuda)
    add("CUDNN", lambda: cuda and torch.backends.cudnn.is_available())
    add("NCCL", lambda: cuda and torch.distributed.is_available()
        and torch.distributed.is_nccl_available())
    add("CUDA_RTC", lambda: cuda and _loads(["libnvrtc.so.12",
                                             "libnvrtc.so"]))
    add("NVJPEG", lambda: cuda and _loads(["libnvjpeg.so.12",
                                           "libnvjpeg.so"]))
    add("CPU", lambda: True)
    add("BF16", lambda: True)
    add("INT64_TENSOR_SIZE", lambda: True)
    add("PROFILER", lambda: True)
    add("MKLDNN", lambda: torch.backends.mkldnn.is_available())
    add("OPENMP", lambda: torch.backends.openmp.is_available())
    add("DIST_KVSTORE", lambda: torch.distributed.is_available())
    add("NATIVE_RECORDIO", lambda: __import__(
        "mxnet_tpu_torch._native", fromlist=["recordio_lib"]
    ).recordio_lib() is not None)

    # the CPU codec is found, not imported: only imdecode imports Pillow
    add("IMAGE_CODECS", lambda: importlib.util.find_spec("PIL") is not None)
    for off in ("TENSORRT", "OPENCV"):
        feats[off] = False
    return feats


class Features(dict):
    """Mapping name -> Feature (reference: runtime.Features)."""

    instance = None

    def __init__(self):
        super().__init__(
            {n: Feature(n, on) for n, on in _probe().items()})

    def __repr__(self):
        on = [n for n, f in sorted(self.items()) if f.enabled]
        off = [n for n, f in sorted(self.items()) if not f.enabled]
        return f"[✔ {', '.join(on)}] [✖ {', '.join(off)}]"

    def is_enabled(self, feature_name: str) -> bool:
        name = feature_name.upper()
        if name not in self:
            raise RuntimeError(f"unknown feature {feature_name!r}")
        return self[name].enabled


def feature_list():
    """List of Feature namedtuples (reference: runtime.feature_list)."""
    return list(Features().values())
