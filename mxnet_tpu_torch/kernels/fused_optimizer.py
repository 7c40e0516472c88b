"""Fused multi-tensor SGD, Adam and AdamW sweeps: the hand-written CUDA
kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/pallas_kernels/fused_optimizer.py``
(``sweep_pallas``, the ``pallas_call`` at ``:128``) running the SGD
formula ``_sgd_elem`` of ``mxnet_tpu/optimizer/multi_tensor.py``
(``:326-339``), the Adam formula ``_adam_elem`` (``:342-353``), or
AdamW's ``_adamw_elem`` (``:356-372``) after its per-member overflow
scan (``:474-491``), with the multi-precision downcast (``w_low``,
``:545``) in the same pass. The kernels are
``csrc/fused_optimizer.cu``; its header comment says what bounds them on
an H100 and why they walk the members through a small device table of
their addresses instead of packing them into flat buffers.

Both versions update their arguments in place (the JAX sweep returns new
arrays): the update target ``w`` (the f32 master of a multi-precision
bucket), the state (Adam's moments ``m`` and ``v``, SGD's momentum
``mom``) and, when given, the low-precision weights. They agree bit for
bit on the card: the kernel rounds each step of the formula explicitly,
the plain version runs one torch op per step.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError
from . import _build

__all__ = ["fused_sgd_sweep", "sgd_sweep_reference", "fused_adam_sweep",
           "adam_sweep_reference", "fused_adamw_sweep",
           "adamw_sweep_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 4096              # elements per CTA (csrc kChunk)
_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float] * 7 \
    + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_SCAN_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
    + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
_SGD_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
    + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_ADAMW_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
    + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# (weight, grad) dtypes a bucket may have
_COMBOS = {(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
           (torch.bfloat16, torch.bfloat16)}


def adam_sweep_reference(ws, gs, means, vars_, lows, lrs, wds, *,
                         beta1, beta2, epsilon, rescale_grad,
                         clip_gradient=None) -> None:
    """Plain PyTorch Adam over members ``j``: ``ws[j]``, ``means[j]``,
    ``vars_[j]`` (and ``lows[j]`` when ``lows`` is given) are updated in
    place from ``gs[j]``, the per-member ``lrs[j]`` (bias correction
    folded in) and ``wds[j]``. One op per step of ``_adam_elem``, in its
    order, everything in f32."""
    for j, (w, g, m, v) in enumerate(zip(ws, gs, means, vars_)):
        g32 = g.float() * rescale_grad
        if clip_gradient is not None and clip_gradient >= 0:
            g32 = torch.clamp(g32, -clip_gradient, clip_gradient)
        w32 = w.float()
        g32 = g32 + float(wds[j]) * w32
        m32 = beta1 * m.float() + (1 - beta1) * g32
        v32 = beta2 * v.float() + (1 - beta2) * (g32 * g32)
        w32 = w32 - float(lrs[j]) * m32 / (torch.sqrt(v32) + epsilon)
        w.copy_(w32)
        m.copy_(m32)
        v.copy_(v32)
        if lows is not None:
            lows[j].copy_(w32)


def _layout(t):
    """The memory order of a dense tensor: "c" (row-major; any tensor
    whose size-1 axes alone break another order), "cl" (channels-last,
    the conv weights of an NHWC model), or None (not dense)."""
    if t.is_contiguous():
        return "c"
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return "cl"
    return None


def _check(what, ws, gs, states, lows, state_dtype=None):
    """Raise unless the members form one bucket the kernels take: one
    device, matching shapes, each member's tensors dense in one memory
    order (the kernels walk them as flat arrays), one weight and one grad
    dtype, every state (``states``: one list of per-member tensors per
    state role) in ``state_dtype`` (None: the weight's dtype)."""
    dev = ws[0].device
    groups = [ws, gs, *states] + ([lows] if lows is not None else [])
    if any(len(grp) != len(ws) for grp in groups):
        raise MXNetError(f"{what}: the member lists differ in length")
    wdt, gdt = ws[0].dtype, gs[0].dtype
    sdt = state_dtype or wdt
    for j in range(len(ws)):
        members = [grp[j] for grp in groups]
        if any(t.device != dev for t in members):
            raise MXNetError(f"{what}: every tensor must be on one CUDA "
                             f"device ({dev})")
        if any(t.shape != ws[j].shape for t in members):
            raise MXNetError(f"{what}: member {j} has shapes "
                             f"{[tuple(t.shape) for t in members]}")
        orders = {_layout(t) for t in members}
        if None in orders or len(orders) != 1:
            raise MXNetError(f"{what}: member {j} is not dense in one "
                             "memory order")
        if ws[j].dtype != wdt or gs[j].dtype != gdt \
                or any(st[j].dtype != sdt for st in states):
            raise MXNetError(f"{what}: one bucket has one weight dtype, one "
                             f"grad dtype and states in {sdt}")
    if (wdt, gdt) not in _COMBOS:
        raise MXNetError(f"{what}: weight/grad dtypes {wdt}/{gdt} not "
                         f"supported ({sorted(map(str, _COMBOS))})")
    if lows is not None and (wdt != torch.float32 or any(
            t.dtype != torch.bfloat16 for t in lows)):
        raise MXNetError(f"{what}: low-precision weights are bfloat16 "
                         "beside an f32 master")


def _table(ws, gs, means, vars_, lows):
    """The (n_members, 7) int64 member table the kernel reads (five
    addresses, 0 for a role the sweep has not, the size, the first
    chunk), and the total chunk count."""
    sizes = np.asarray([w.numel() for w in ws], np.int64)
    chunks = -(-sizes // _CHUNK)
    first = np.cumsum(chunks) - chunks
    none = [None] * len(ws)
    rows = [[_ptr(w), _ptr(g), _ptr(m), _ptr(v), _ptr(lo), int(n), int(f)]
            for w, g, m, v, lo, n, f in zip(
                ws, gs, means or none, vars_ or none, lows or none, sizes,
                first)]
    return torch.tensor(rows, dtype=torch.int64), int(chunks.sum())


def _ptr(t) -> int:
    return t.data_ptr() if t is not None else 0


def _device_tables(ws, gs, means, vars_, lows, lrs, wds):
    """The member table and the (n_members, 2) f32 lr/wd table on the
    members' device, and the total chunk count. They go up from pinned
    memory, so the copies queue behind the stream's work without
    stalling the host."""
    members, n_blocks = _table(ws, gs, means, vars_, lows)
    lr_wd = torch.from_numpy(np.stack(
        [np.asarray(lrs, np.float32), np.asarray(wds, np.float32)], 1))
    dev = ws[0].device
    return (members.pin_memory().to(dev, non_blocking=True),
            lr_wd.pin_memory().to(dev, non_blocking=True), n_blocks)


def _clip_arg(clip_gradient) -> float:
    return -1.0 if clip_gradient is None or clip_gradient < 0 \
        else float(clip_gradient)


def fused_adam_sweep(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                     means: Sequence[torch.Tensor],
                     vars_: Sequence[torch.Tensor],
                     lows: Optional[Sequence[torch.Tensor]], lrs, wds, *,
                     beta1: float, beta2: float, epsilon: float,
                     rescale_grad: float, clip_gradient=None) -> None:
    """One Adam sweep over a dtype bucket, in place: see
    :func:`adam_sweep_reference` for the arguments and the formula.

    Bucket dtypes: f32 weights and moments with f32 or bf16 grads (a
    multi-precision bucket passes its f32 masters as ``ws`` and its bf16
    weights as ``lows``), or bf16 weights, moments and grads. On the
    card: one launch per call, the members read where they lie through a
    small device table of their addresses, made anew each call."""
    if not ws:
        return
    if ws[0].device.type == "cpu":
        return adam_sweep_reference(ws, gs, means, vars_, lows, lrs, wds,
                                    beta1=beta1, beta2=beta2,
                                    epsilon=epsilon,
                                    rescale_grad=rescale_grad,
                                    clip_gradient=clip_gradient)
    if ws[0].device.type != "cuda":
        raise MXNetError(f"fused_adam_sweep: unsupported device "
                         f"{ws[0].device}")
    _check("fused_adam_sweep", ws, gs, [means, vars_], lows)
    dev = ws[0].device
    members, lr_wd, n_blocks = _device_tables(ws, gs, means, vars_, lows,
                                              lrs, wds)
    clip = _clip_arg(clip_gradient)
    with torch.cuda.device(dev):
        _build.call(
            "fused_optimizer.cu", "mx_adam_sweep", _ARGS, "fused_adam_sweep",
            members.data_ptr(), lr_wd.data_ptr(), len(ws), n_blocks,
            float(beta1), float(1 - beta1), float(beta2),
            float(1 - beta2), float(epsilon), float(rescale_grad), clip,
            _DTYPE_CODE[ws[0].dtype], _DTYPE_CODE[gs[0].dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    fused_adam_sweep.launches += 1


fused_adam_sweep.launches = 0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_sweep_reference(ws, gs, means, vars_, lows, lrs, wds, *,
                          beta1, beta2, epsilon, rescale_grad,
                          clip_gradient=None) -> None:
    """Plain PyTorch AdamW over members ``j``, in place, with MXNet's
    semantics (``_adamw_elem``, ``multi_tensor.py:356-372``): the grad
    rescaled and clipped, no wd term in it; the moments (f32) updated;
    ``w - 1.0 * (lr * m / (sqrt(v) + eps) + wd * lr * w)`` with the
    bias-corrected ``lrs[j]``; a member whose rescaled, clipped grad
    holds a value that is not finite (``torch.isfinite(...).all()``,
    kept on the device) keeps its weight and moments. ``lows[j]``, when
    given, gets the resulting weight. One op per step, in order, in
    f32."""
    for j, (w, g, m, v) in enumerate(zip(ws, gs, means, vars_)):
        g32 = g.float() * rescale_grad
        if clip_gradient is not None and clip_gradient >= 0:
            g32 = torch.clamp(g32, -clip_gradient, clip_gradient)
        ok = torch.isfinite(g32).all()
        m32 = beta1 * m + (1 - beta1) * g32
        v32 = beta2 * v + (1 - beta2) * (g32 * g32)
        w32 = w.float()
        wd_lr = float(np.float32(wds[j]) * np.float32(lrs[j]))
        w_new = w32 - (float(lrs[j]) * m32 / (torch.sqrt(v32) + epsilon)
                       + wd_lr * w32)
        w_new = torch.where(ok, w_new, w32)
        w.copy_(w_new)
        m.copy_(torch.where(ok, m32, m))
        v.copy_(torch.where(ok, v32, v))
        if lows is not None:
            lows[j].copy_(w_new)


def fused_adamw_sweep(ws: Sequence[torch.Tensor],
                      gs: Sequence[torch.Tensor],
                      means: Sequence[torch.Tensor],
                      vars_: Sequence[torch.Tensor],
                      lows: Optional[Sequence[torch.Tensor]], lrs, wds, *,
                      beta1: float, beta2: float, epsilon: float,
                      rescale_grad: float, clip_gradient=None) -> None:
    """One AdamW sweep over a dtype bucket, in place: see
    :func:`adamw_sweep_reference` for the arguments and the formula.

    Bucket dtypes: f32 moments always; f32 weights with f32 or bf16
    grads (a multi-precision bucket passes its f32 masters as ``ws`` and
    its bf16 weights as ``lows``), or bf16 weights and grads. On the
    card: two launches per call over one device table of the members,
    the overflow scan into per-member int32 flags on the device, then
    the sweep, which reads them (``launches`` counts the sweeps,
    ``scan_launches`` the scans)."""
    if not ws:
        return
    if ws[0].device.type == "cpu":
        return adamw_sweep_reference(ws, gs, means, vars_, lows, lrs, wds,
                                     beta1=beta1, beta2=beta2,
                                     epsilon=epsilon,
                                     rescale_grad=rescale_grad,
                                     clip_gradient=clip_gradient)
    if ws[0].device.type != "cuda":
        raise MXNetError(f"fused_adamw_sweep: unsupported device "
                         f"{ws[0].device}")
    _check("fused_adamw_sweep", ws, gs, [means, vars_], lows,
           torch.float32)
    dev = ws[0].device
    members, lr_wd, n_blocks = _device_tables(ws, gs, means, vars_, lows,
                                              lrs, wds)
    ok = torch.ones(len(ws), dtype=torch.int32, device=dev)
    clip = _clip_arg(clip_gradient)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _build.call(
            "fused_optimizer.cu", "mx_adamw_scan", _SCAN_ARGS,
            "fused_adamw_sweep (scan)", members.data_ptr(), ok.data_ptr(),
            len(ws), n_blocks, float(rescale_grad), clip,
            _DTYPE_CODE[gs[0].dtype], stream)
        fused_adamw_sweep.scan_launches += 1
        _build.call(
            "fused_optimizer.cu", "mx_adamw_sweep", _ADAMW_ARGS,
            "fused_adamw_sweep", members.data_ptr(), lr_wd.data_ptr(),
            ok.data_ptr(), len(ws), n_blocks, float(beta1),
            float(1 - beta1), float(beta2), float(1 - beta2),
            float(epsilon), float(rescale_grad), clip,
            _DTYPE_CODE[ws[0].dtype], _DTYPE_CODE[gs[0].dtype], stream)
    fused_adamw_sweep.launches += 1


fused_adamw_sweep.launches = 0
fused_adamw_sweep.scan_launches = 0


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

def sgd_sweep_reference(ws, gs, moms, lows, lrs, wds, *, momentum,
                        rescale_grad, clip_gradient=None) -> None:
    """Plain PyTorch SGD over members ``j``, in place (``_sgd_elem``,
    ``multi_tensor.py:326-339``, and ``mp_sgd_mom_update``,
    ``ops/optimizer_op.py:55-61``): the grad rescaled, clipped and given
    ``wds[j] * w``; with ``moms``, ``mom = momentum * mom - lrs[j] * g``
    and ``w += mom`` (at momentum 0 the buffer is still rewritten, the
    op's contract); without, ``w -= lrs[j] * g``. ``lows[j]``, when
    given, gets the new weight rounded to bf16. One op per step, in
    order, in f32; a non-finite grad propagates, as in the reference."""
    for j, (w, g) in enumerate(zip(ws, gs)):
        g32 = g.float() * rescale_grad
        if clip_gradient is not None and clip_gradient >= 0:
            g32 = torch.clamp(g32, -clip_gradient, clip_gradient)
        w32 = w.float()
        g32 = g32 + float(wds[j]) * w32
        if moms is None:
            w32 = w32 - float(lrs[j]) * g32
        else:
            m32 = momentum * moms[j].float() - float(lrs[j]) * g32
            w32 = w32 + m32
            moms[j].copy_(m32)
        w.copy_(w32)
        if lows is not None:
            lows[j].copy_(w32)


def fused_sgd_sweep(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                    moms: Optional[Sequence[torch.Tensor]],
                    lows: Optional[Sequence[torch.Tensor]], lrs, wds, *,
                    momentum: float, rescale_grad: float,
                    clip_gradient=None) -> None:
    """One SGD sweep over a dtype bucket, in place: see
    :func:`sgd_sweep_reference` for the arguments and the formula;
    ``moms=None`` is the momentum-free form.

    Bucket dtypes: f32 weights with f32 or bf16 grads (a
    multi-precision bucket passes its f32 masters as ``ws``, their f32
    momenta as ``moms`` and its bf16 weights as ``lows``), or bf16
    weights and grads; the momentum in the weight's dtype. On the card:
    one launch per call over the members where they lie, through the
    device table the Adam sweeps read."""
    if not ws:
        return
    if ws[0].device.type == "cpu":
        return sgd_sweep_reference(ws, gs, moms, lows, lrs, wds,
                                   momentum=momentum,
                                   rescale_grad=rescale_grad,
                                   clip_gradient=clip_gradient)
    if ws[0].device.type != "cuda":
        raise MXNetError(f"fused_sgd_sweep: unsupported device "
                         f"{ws[0].device}")
    _check("fused_sgd_sweep", ws, gs, [moms] if moms is not None else [],
           lows)
    dev = ws[0].device
    members, lr_wd, n_blocks = _device_tables(ws, gs, moms, None, lows,
                                              lrs, wds)
    with torch.cuda.device(dev):
        _build.call(
            "fused_optimizer.cu", "mx_sgd_sweep", _SGD_ARGS,
            "fused_sgd_sweep", members.data_ptr(), lr_wd.data_ptr(),
            len(ws), n_blocks, float(momentum), float(rescale_grad),
            _clip_arg(clip_gradient), _DTYPE_CODE[ws[0].dtype],
            _DTYPE_CODE[gs[0].dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    fused_sgd_sweep.launches += 1


fused_sgd_sweep.launches = 0
