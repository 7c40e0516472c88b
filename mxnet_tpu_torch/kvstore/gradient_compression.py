"""2-bit gradient compression with error feedback (counterpart of
``mxnet_tpu/kvstore/gradient_compression.py:49-153``; reference
``kvstore.set_gradient_compression`` /
``Trainer(compression_params={'type': '2bit', 'threshold': t})``).

Each gradient element is quantized to ``{-t, 0, +t}`` before the
exchange, the quantization error kept in a per-key f32 residual added to
the next gradient, so the sum of what is sent follows the true gradient
sum. The values go on the wire at full width, as the reference sends
them. The quantizer is :func:`~mxnet_tpu_torch.kernels.twobit_quantize`:
the hand-written kernel on a CUDA tensor, its plain version on a CPU
one.

Two granularities share it: per key (:meth:`GradientCompression.compress`,
the scalar ``push()`` path, one residual per ``(key, slot)``) and per
bucket (:meth:`GradientCompression.compress_flat`, the fused
``pushpull`` path, one quantizer launch over a packed bucket with one
residual per ``(member keys, slot)``). The two residual namespaces are
independent. Only floating-point gradients are quantized: an integer
gradient raises :class:`MXNetError`. :meth:`get_state` /
:meth:`set_state` carry the residuals (as numpy arrays, the reference's
format, so each package loads the other's) in ``Trainer.save_states``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError
from ..kernels import twobit_quantize
from ..ndarray import NDArray
from ..telemetry import _state as _telemetry_state

__all__ = ["GradientCompression", "create_compression"]

_SUPPORTED = {torch.float32: "float32", torch.float16: "float16",
              torch.bfloat16: "bfloat16"}


class GradientCompression:
    """Threshold 2-bit quantizer with residual error feedback."""

    def __init__(self, threshold=0.5):
        threshold = float(threshold)
        if threshold <= 0:
            raise MXNetError("gradient compression threshold must be > 0")
        self.threshold = threshold
        self._residual: Dict = {}

    def _check_dtype(self, dtype, what):
        if dtype not in _SUPPORTED:
            raise MXNetError(
                f"2-bit gradient compression supports float gradients "
                f"only ({', '.join(_SUPPORTED.values())}); {what} has "
                f"dtype {str(dtype).split('.')[-1]} — refusing to silently "
                "cast")

    def _quantize(self, rkey, data: torch.Tensor) -> torch.Tensor:
        res = self._residual.get(rkey)
        if res is None or res.shape != data.shape:
            res = torch.zeros(data.shape, dtype=torch.float32,
                              device=data.device)
            self._residual[rkey] = res
        elif res.device != data.device:         # restored on the CPU
            res = self._residual[rkey] = res.to(data.device)
        with torch.no_grad():
            out = twobit_quantize(data.contiguous(), res, self.threshold)
        if _telemetry_state.enabled:
            telemetry.record_kv_compression(data.element_size() * 8 / 2.0,
                                            int(data.numel()))
        return out

    def compress(self, key, slot, grad: NDArray) -> NDArray:
        """Quantize ``grad + residual`` to {-t, 0, +t}; update the
        residual."""
        self._check_dtype(grad._data.dtype, f"gradient for key {key!r}")
        return NDArray(self._quantize((key, slot), grad._data.detach()),
                       ctx=grad.context)

    def compress_flat(self, bucket_key, slot, flat: torch.Tensor
                      ) -> torch.Tensor:
        """Quantize a packed gradient bucket (a flat tensor) in one
        quantizer launch; the residual is keyed by the bucket's member
        keys and slot (a model's buckets are the same every step, so the
        residual stream is continuous)."""
        self._check_dtype(flat.dtype, f"gradient bucket {tuple(bucket_key)!r}")
        return self._quantize((tuple(bucket_key), slot), flat)

    # -- checkpointing -------------------------------------------------
    def get_state(self) -> Dict:
        """The residuals as numpy arrays (what ``Trainer.save_states``
        embeds, so a resumed run's error feedback continues bit for
        bit)."""
        return {"threshold": self.threshold,
                "residual": {k: v.detach().cpu().numpy().copy()
                             for k, v in self._residual.items()}}

    def set_state(self, state: Dict) -> None:
        """Inverse of :meth:`get_state` (the residuals land on the CPU and
        move to their gradient's device at its next use). A threshold
        mismatch raises: residuals made under another quantization grid
        would corrupt the error feedback."""
        thr = state.get("threshold")
        if thr is not None and float(thr) != self.threshold:
            raise MXNetError(
                f"gradient-compression state was saved with threshold "
                f"{thr} but this store is configured with "
                f"{self.threshold}")
        self._residual = {
            k: torch.from_numpy(np.asarray(v, np.float32).copy())
            for k, v in state.get("residual", {}).items()}


def create_compression(params) -> GradientCompression:
    """Build from a ``compression_params`` dict (reference:
    ``kvstore.py::set_gradient_compression``'s argument contract)."""
    params = dict(params or {})
    ctype = params.pop("type", None)
    if ctype != "2bit":
        raise MXNetError(
            f"unsupported gradient compression type {ctype!r} "
            "(supported: '2bit')")
    comp = GradientCompression(threshold=params.pop("threshold", 0.5))
    if params:
        raise MXNetError(
            f"unknown compression_params keys: {sorted(params)}")
    return comp
