"""The stateless position-hash dropout: the ``Dropout`` op's kernel and
the torch versions of the hash that every plain reference of the port
uses.

Counterpart of the hash of ``mxnet_tpu/pallas_kernels/flash_attention.py``
(``_hash_u32`` ``:85``, ``_hash_u16`` ``:96``, ``dropout_thresh``
``:101``, ``_drop_mask`` ``:117``), of ``fused_layers.py``'s
``_row_keep_mask`` (``:113``) and of the hash branch of ``dropout_op``
(``mxnet_tpu/ops/nn.py:1079-1131``), which the port always takes. The
TPU kernels draw no random numbers: they hash each element's absolute
position under a u32 seed, and a backward regenerates the forward's bits
from the same seed. The CUDA side of the hash is one header,
``csrc/hash_dropout.cuh``, shared by the Dropout kernel
(``csrc/dropout.cu``), the LayerNorm kernels and the flash attention
kernels; the functions here are its bit-exact torch twin.

torch has no full uint32 arithmetic, so the hash runs in int64 and
masks to 32 bits after every product and sum, before any right shift:
the low 32 bits of an int64 product survive its wrap past 2**63, and a
masked value is never negative. The same functions take Python ints.

:func:`hash_dropout` is differentiable: its backward is the same
function of the output gradient (the kernel again on the card), so the
autograd node saves the seed and nothing else. A CPU tensor takes the
plain version, :func:`hash_dropout_reference`; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["hash_u32", "hash_u16", "dropout_thresh", "drop_mask",
           "attn_keep_mask", "row_keep_mask", "hash_dropout",
           "hash_dropout_bwd", "hash_dropout_reference", "check_dropout",
           "kernel_args", "f32"]

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
MUR1 = 0x85EBCA6B
MUR2 = 0xC2B2AE35
_MAX_DIMS = 8                 # csrc kMaxDims
_THREADS = 256                # csrc kThreads
_CTAS_PER_SM = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
         ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]


def hash_u32(idx, seed):
    """The murmur3 finalizer of ``idx * GOLD + seed`` in uint32
    arithmetic (``_hash_u32``): ``idx`` an int64 tensor or an int of
    values in [0, 2**32), ``seed`` an int or an int64 tensor."""
    z = (idx * GOLD + seed) & M32
    z = z ^ (z >> 16)
    z = (z * MUR1) & M32
    z = z ^ (z >> 13)
    z = (z * MUR2) & M32
    return z ^ (z >> 16)


def hash_u16(idx, seed):
    """The low 16 bits of :func:`hash_u32` (``_hash_u16``)."""
    return hash_u32(idx, seed) & 0xFFFF


def dropout_thresh(p: float) -> int:
    """The u16 keep threshold of drop rate ``p``: ``min(0xFFFF,
    round((1 - p) * 65536))`` with Python's round (half to even), as
    ``dropout_thresh`` computes it; compared against as a u32."""
    return min(0xFFFF, int(round((1.0 - p) * 65536.0)))


def drop_mask(head, q, k, lk: int, seed: int, thresh: int):
    """Keep-mask of attention elements at absolute ``(head, q, k)``
    (broadcastable int64 tensors; ``head`` is ``b * H + h`` in every
    layout, ``q`` has no causal offset, ``lk`` the true key length), the
    two-level hash of ``_drop_mask``: the head folds into a per-head seed,
    then ``q * lk + k`` is hashed under it."""
    head_seed = hash_u32(head, seed)
    idx = (q * lk + k) & M32
    return hash_u16(idx, head_seed) < thresh


def attn_keep_mask(b: int, h: int, lq: int, lk: int, seed: int,
                   thresh: int, device=None):
    """(b, h, lq, lk) keep-mask of attention probabilities: the
    :func:`drop_mask` of every (b * h + head, q, k)."""
    ar = lambda n: torch.arange(n, device=device,  # noqa: E731
                                dtype=torch.int64)
    return drop_mask(ar(b * h).reshape(b, h, 1, 1), ar(lq)[:, None], ar(lk),
                     lk, seed, thresh)


def row_keep_mask(rows: int, d: int, seed: int, thresh: int, device=None,
                  row0: int = 0):
    """(rows, d) keep-mask of a row kernel: the element's flat id
    ``row * d + col`` (uint32), rows counted from ``row0``
    (``_row_keep_mask``, ``_ref_keep_mask``)."""
    row = torch.arange(row0, row0 + rows, device=device,
                       dtype=torch.int64)[:, None]
    col = torch.arange(d, device=device, dtype=torch.int64)[None, :]
    return hash_u16((row * d + col) & M32, seed) < thresh


def check_dropout(p: float, seed, what: str):
    """``(p, seed)`` checked: a rate in [0, 1), and the seed as a Python
    int in [0, 2**32), or None when ``p`` is 0; a rate above 0 without a
    seed raises, as the reference does."""
    p = float(p)
    if not 0.0 <= p < 1.0:
        raise MXNetError(f"{what}: dropout rate {p} must be in [0, 1)")
    if p == 0.0:
        return p, None
    if seed is None:
        raise MXNetError(f"{what}: dropout > 0 requires a seed (a u32, "
                         "from mxnet_tpu_torch.random_state.next_seed)")
    seed = int(seed)
    if not 0 <= seed <= M32:
        raise MXNetError(f"{what}: seed {seed} is not a u32")
    return p, seed


def f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def kernel_args(p: float, seed, scale: float) -> tuple:
    """The row and flash kernels' dropout arguments ``(drop, seed,
    thresh, scale)``, with the site's f32 ``scale``; all off at p = 0."""
    if p == 0.0:
        return 0, 0, 0, 1.0
    return 1, seed, dropout_thresh(p), scale


def _mask_shape(shape, axes):
    """x's shape with the ``axes`` dims set to 1, and the axes
    normalised."""
    nd = len(shape)
    norm = []
    for a in axes:
        a = int(a)
        if not -nd <= a < nd:
            raise MXNetError(f"hash_dropout: axis {a} out of range for "
                             f"{nd} dims")
        norm.append(a % nd)
    return tuple(1 if i in norm else s for i, s in enumerate(shape)), norm


def hash_dropout_reference(x, p: float, seed: int, axes=()):
    """Plain PyTorch version of :func:`hash_dropout`, ``dropout_op``'s
    hash branch: the flat index of every element of the mask shape (x's
    shape with ``axes`` set to 1) in uint32, hashed under ``seed``,
    broadcast over ``axes``; ``x * inv_keep`` in x's dtype where kept,
    0 elsewhere, with ``inv_keep = dtype(1 / (1 - p))``."""
    p, seed = check_dropout(p, seed, "hash_dropout")
    if p == 0.0:
        return x
    mshape, _ = _mask_shape(tuple(x.shape), axes)
    n = 1
    for s in mshape:
        n *= s
    ids = (torch.arange(n, device=x.device, dtype=torch.int64)
           & M32).reshape(mshape)
    keep = (hash_u16(ids, seed) < dropout_thresh(p)).expand(x.shape)
    inv_keep = torch.tensor(1.0 / (1.0 - p), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * inv_keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _launch(x, p, seed, axes, what):
    """Run the kernel over the CUDA tensor ``x``; returns the output."""
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError(f"{what}: dtype {x.dtype} not supported (float32 "
                         "or bfloat16)")
    if not x.is_contiguous():
        raise MXNetError(f"{what}: x must be contiguous")
    mshape, norm = _mask_shape(tuple(x.shape), axes)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    ndim = x.dim() if norm else 0
    if ndim > _MAX_DIMS:
        raise MXNetError(f"{what}: axes over {x.dim()} dims (at most "
                         f"{_MAX_DIMS})")
    strides, acc = [0] * ndim, 1
    for i in reversed(range(ndim)):
        strides[i] = 0 if i in norm else acc & M32
        acc *= mshape[i]
    c_shape = (ctypes.c_longlong * max(ndim, 1))(*x.shape[:ndim])
    c_strides = (ctypes.c_uint * max(ndim, 1))(*strides)
    per = 16 // x.element_size()
    vec = n % per == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    chunks = n // per if vec else n
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_ctas = max(1, min(-(-chunks // _THREADS), sms * _CTAS_PER_SM))
    scale = float(torch.tensor(1.0 / (1.0 - p), dtype=x.dtype))
    with torch.cuda.device(x.device):
        _build.call(
            "dropout.cu", "mx_hash_dropout", _ARGS, what, x.data_ptr(),
            out.data_ptr(), n, ndim, ctypes.addressof(c_shape),
            ctypes.addressof(c_strides), seed, dropout_thresh(p), scale,
            _DTYPE_CODE[x.dtype], int(vec), n_ctas,
            torch.cuda.current_stream(x.device).cuda_stream)
    return out


def _apply(x, p, seed, axes, what):
    p, seed = check_dropout(p, seed, what)
    if p == 0.0:
        return x, False
    if x.device.type in ("cpu", "meta"):
        return hash_dropout_reference(x, p, seed, axes), False
    if x.device.type != "cuda":
        raise MXNetError(f"{what}: unsupported device {x.device}")
    return _launch(x, p, seed, axes, what), True


def hash_dropout_bwd(dy, p: float, seed: int, axes=()):
    """The gradient of :func:`hash_dropout`: the same function of ``dy``
    (the kernel again, on a contiguous copy if ``dy`` is not)."""
    out, launched = _apply(dy.contiguous(), p, seed, axes,
                           "hash_dropout_bwd")
    hash_dropout_bwd.launches += int(launched)
    return out


hash_dropout_bwd.launches = 0


def _hash_dropout_fwd(x, p, seed, axes):
    out, launched = _apply(x, p, seed, axes, "hash_dropout")
    hash_dropout.launches += int(launched)
    return out


class _HashDropout(torch.autograd.Function):
    """``hash_dropout`` with its backward; saves the seed, no tensor."""

    @staticmethod
    def forward(ctx, x, p, seed, axes):
        ctx.cfg = (p, seed, axes)
        return _hash_dropout_fwd(x, p, seed, axes)

    @staticmethod
    def backward(ctx, dy):
        return hash_dropout_bwd(dy, *ctx.cfg), None, None, None


def hash_dropout(x, p: float, seed: int, axes=()):
    """Dropout of ``x`` at rate ``p`` under the u32 ``seed``: each element
    of the mask shape (x's shape with ``axes`` set to 1) is kept iff the
    low 16 bits of the hash of its flat index are below
    ``dropout_thresh(p)``; kept elements are multiplied by
    ``dtype(1 / (1 - p))`` in x's dtype, dropped ones are 0. ``x``:
    contiguous float32 or bfloat16 on the card (any float dtype on the
    CPU). ``p`` = 0 returns ``x``. With autograd recording and ``x``
    requiring grad, the backward is :func:`hash_dropout_bwd`."""
    if check_dropout(p, seed, "hash_dropout")[0] == 0.0:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _HashDropout.apply(x, p, seed, tuple(axes))
    return _hash_dropout_fwd(x, p, seed, tuple(axes))


hash_dropout.launches = 0
