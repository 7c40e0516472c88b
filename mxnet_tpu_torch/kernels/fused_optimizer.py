"""Fused multi-tensor SGD, Adam, AdamW and LAMB sweeps: the hand-written
CUDA kernels and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/pallas_kernels/fused_optimizer.py``
(``sweep_pallas``, the ``pallas_call`` at ``:128``) running the SGD
formula ``_sgd_elem`` of ``mxnet_tpu/optimizer/multi_tensor.py``
(``:326-339``), the Adam formula ``_adam_elem`` (``:342-353``), or
AdamW's ``_adamw_elem`` (``:356-372``) after its per-member overflow
scan (``:474-491``), or LAMB's two stages with the per-member
trust-ratio norms between them (``_lamb_phase1_elem`` ``:375-392``,
``segment_sumsq`` ``:259-277``, ``_lamb_phase2_elem`` ``:395-398``), with
the multi-precision downcast (``w_low``, ``:545``) in the same pass. The kernels are
``csrc/fused_optimizer.cu``; its header comment says what bounds them on
an H100 and why they walk the members through a small device table of
their addresses instead of packing them into flat buffers.

Both versions update their arguments in place (the JAX sweep returns new
arrays): the update target ``w`` (the f32 master of a multi-precision
bucket), the state (Adam's moments ``m`` and ``v``, SGD's momentum
``mom``) and, when given, the low-precision weights. They agree bit for
bit on the card: the kernel rounds each step of the formula explicitly,
the plain version runs one torch op per step (LAMB's norms are sums in
another order: its phases agree bit for bit given the same norms).

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
           "adamw_sweep_reference", "fused_lamb_sweep",
           "lamb_sweep_reference"]

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
_LAMB1_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
    + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_LAMB_NORM_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_LAMB2_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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


def _device_tables(ws, gs, means, vars_, lows, *cols):
    """The member table and the (n_members, len(cols)) f32 table of the
    per-member scalars ``cols`` (lr and wd, and LAMB's bias corrections)
    on the members' device, and the total chunk count. They go up from
    pinned memory, so the copies queue behind the stream's work without
    stalling the host."""
    members, n_blocks = _table(ws, gs, means, vars_, lows)
    scal = torch.from_numpy(np.stack(
        [np.asarray(c, np.float32) for c in cols], 1))
    dev = ws[0].device
    return (members.pin_memory().to(dev, non_blocking=True),
            scal.pin_memory().to(dev, non_blocking=True), n_blocks)


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


# ---------------------------------------------------------------------------
# LAMB
# ---------------------------------------------------------------------------

def _bc_mode(bias_correction, bc_recip) -> int:
    """The kernel's bias-correction mode: 0 none, 1 multiply by the f32
    reciprocals, 2 divide."""
    if not bias_correction:
        return 0
    return 1 if bc_recip else 2


def lamb_sweep_reference(ws, gs, means, vars_, lows, lrs, wds, bc1s, bc2s, *,
                         beta1, beta2, epsilon, rescale_grad,
                         clip_gradient=None, bias_correction=True,
                         bc_recip=True, lower_bound=None, upper_bound=None,
                         norms=None):
    """Plain PyTorch LAMB over members ``j``, in place (``_lamb_phase1_elem``,
    the per-member norms and ``_lamb_phase2_elem``,
    ``multi_tensor.py:375-398``, ``:492-539``). Phase 1: the grad
    rescaled and clipped; the f32 moments ``means[j]``/``vars_[j]``
    updated; with ``bias_correction`` the moments multiplied by the f32
    reciprocals ``bc1s[j]``/``bc2s[j]`` (``bc_recip``) or divided by
    ``bc1s[j]``/``bc2s[j]``; ``upd = m / (sqrt(v) + eps) + wds[j] * w``.
    Norms: ``r1 = ||w||`` and ``r2 = ||upd||`` (``norms[j]`` in their
    place when given: the kernel's, so that phase 2 is compared on the
    same norms); ``r1`` clamped to the bounds that are given and >= 0;
    ``ratio = r1 / r2`` if both are > 0, else 1. Phase 2:
    ``w -= (f32(lrs[j]) * ratio) * upd``, and ``lows[j]``, when given,
    gets the new ``w`` rounded to bf16. ``ws`` are f32 (the masters of a
    multi-precision bucket). One op per step, in order, in f32. Returns
    ``(upds, norms)``: each member's f32 ``upd`` and the (n_members, 2)
    f32 ``(r1, r2)`` before the bounds."""
    upds, rs = [], []
    for j, (w, g, m, v) in enumerate(zip(ws, gs, means, vars_)):
        dev = w.device
        g32 = g.float() * rescale_grad
        if clip_gradient is not None and clip_gradient >= 0:
            g32 = torch.clamp(g32, -clip_gradient, clip_gradient)
        w32 = w.float()
        m32 = beta1 * m + (1 - beta1) * g32
        v32 = beta2 * v + (1 - beta2) * (g32 * g32)
        mh, vh = m32, v32
        if bias_correction and bc_recip:
            mh = m32 * float(bc1s[j])
            vh = v32 * float(bc2s[j])
        elif bias_correction:
            # a 0-d tensor on the members' device: torch divides a CUDA
            # tensor by a Python scalar as a multiply by its reciprocal
            mh = m32 / torch.full((), float(bc1s[j]), device=dev)
            vh = v32 / torch.full((), float(bc2s[j]), device=dev)
        upd = mh / (torch.sqrt(vh) + epsilon) + float(wds[j]) * w32
        m.copy_(m32)
        v.copy_(v32)
        if norms is None:
            r = torch.stack([torch.sqrt(torch.sum(w32 * w32)),
                             torch.sqrt(torch.sum(upd * upd))])
        else:
            r = norms[j].to(dev, torch.float32)
        r1, r2 = r[0], r[1]
        if lower_bound is not None and lower_bound >= 0:
            r1 = torch.maximum(r1, torch.full((), float(lower_bound),
                                              device=dev))
        if upper_bound is not None and upper_bound >= 0:
            r1 = torch.minimum(r1, torch.full((), float(upper_bound),
                                              device=dev))
        ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                            torch.ones((), device=dev))
        w_new = w32 - (float(lrs[j]) * ratio) * upd
        w.copy_(w_new)
        if lows is not None:
            lows[j].copy_(w_new)
        upds.append(upd)
        rs.append(r)
    return upds, (torch.stack(rs) if rs else torch.zeros(0, 2))


def fused_lamb_sweep(ws: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
                     means: Sequence[torch.Tensor],
                     vars_: Sequence[torch.Tensor],
                     lows: Optional[Sequence[torch.Tensor]], lrs, wds,
                     bc1s, bc2s, *, beta1: float, beta2: float,
                     epsilon: float, rescale_grad: float,
                     clip_gradient=None, bias_correction=True,
                     bc_recip=True, lower_bound=None, upper_bound=None):
    """One LAMB sweep over a dtype bucket, in place: see
    :func:`lamb_sweep_reference` for the arguments, the formula and the
    return value (``bc1s``/``bc2s`` may be None without
    ``bias_correction``).

    Bucket dtypes: f32 weights (a multi-precision bucket passes its f32
    masters as ``ws`` and its bf16 weights as ``lows``) and f32 moments,
    with f32 or bf16 grads. On the card: three launches per call over one
    device table of the members (phase 1 with each chunk's partial sums
    of squares, the per-member norms, phase 2), counted by
    ``phase1_launches``, ``norms_launches`` and ``launches`` (phase 2).
    ``upd`` and the partial sums live in scratch from torch's caching
    allocator, which hands the same block back every step; the returned
    ``upds`` are views of it."""
    if not ws:
        return [], torch.zeros(0, 2)
    if ws[0].device.type == "cpu":
        return lamb_sweep_reference(
            ws, gs, means, vars_, lows, lrs, wds, bc1s, bc2s, beta1=beta1,
            beta2=beta2, epsilon=epsilon, rescale_grad=rescale_grad,
            clip_gradient=clip_gradient, bias_correction=bias_correction,
            bc_recip=bc_recip, lower_bound=lower_bound,
            upper_bound=upper_bound)
    if ws[0].device.type != "cuda":
        raise MXNetError(f"fused_lamb_sweep: unsupported device "
                         f"{ws[0].device}")
    if ws[0].dtype != torch.float32:
        raise MXNetError("fused_lamb_sweep: the update target is f32 (the "
                         "master of a multi-precision bucket); a "
                         "half-precision weight without multi_precision "
                         "takes LAMB's per-parameter update "
                         "(optimizer.multi_tensor.sweepable)")
    _check("fused_lamb_sweep", ws, gs, [means, vars_], lows, torch.float32)
    dev = ws[0].device
    n = len(ws)
    ones = [1.0] * n
    members, scal, n_blocks = _device_tables(
        ws, gs, means, vars_, lows, lrs, wds,
        bc1s if bias_correction else ones, bc2s if bias_correction else ones)
    upd = torch.empty(max(n_blocks, 1) * _CHUNK, dtype=torch.float32,
                      device=dev)
    partials = torch.empty(max(n_blocks, 1), 2, dtype=torch.float32,
                           device=dev)
    norms = torch.empty(n, 3, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bound = [-1.0 if b is None or b < 0 else float(b)
             for b in (lower_bound, upper_bound)]
    with torch.cuda.device(dev):
        _build.call(
            "fused_optimizer.cu", "mx_lamb_phase1", _LAMB1_ARGS,
            "fused_lamb_sweep (phase 1)", members.data_ptr(),
            scal.data_ptr(), upd.data_ptr(), partials.data_ptr(), n,
            n_blocks, float(beta1), float(1 - beta1), float(beta2),
            float(1 - beta2), float(epsilon), float(rescale_grad),
            _clip_arg(clip_gradient), _bc_mode(bias_correction, bc_recip),
            _DTYPE_CODE[gs[0].dtype], stream)
        fused_lamb_sweep.phase1_launches += 1
        _build.call(
            "fused_optimizer.cu", "mx_lamb_norms", _LAMB_NORM_ARGS,
            "fused_lamb_sweep (norms)", members.data_ptr(), scal.data_ptr(),
            partials.data_ptr(), norms.data_ptr(), n, *bound, stream)
        fused_lamb_sweep.norms_launches += 1
        _build.call(
            "fused_optimizer.cu", "mx_lamb_phase2", _LAMB2_ARGS,
            "fused_lamb_sweep (phase 2)", members.data_ptr(),
            upd.data_ptr(), norms.data_ptr(), n, n_blocks, stream)
    fused_lamb_sweep.launches += 1
    offsets = np.cumsum([0] + [-(-w.numel() // _CHUNK) for w in ws])
    upds = [upd.as_strided(w.shape, w.stride(), int(off) * _CHUNK)
            for w, off in zip(ws, offsets[:-1])]
    return upds, norms[:, :2]


fused_lamb_sweep.launches = 0
fused_lamb_sweep.phase1_launches = 0
fused_lamb_sweep.norms_launches = 0
