"""Shape, indexing, ordering, reduction, product and creation operators
(counterpart of the parts of ``mxnet_tpu/ops/tensor.py`` that NDArray's
operators and methods reach).

An op's output is a fresh array even where PyTorch would hand back a
view (``Reshape``, ``transpose``, ``broadcast_to``...):
``ndarray.imperative_invoke`` copies an output that aliases an input, as
the reference's outputs are new arrays. Only ``NDArray.reshape`` and
basic indexing give views. The creation ops take the device to create
on as their ``device`` attribute. The ``_linalg_*`` ops,
``gather_nd``/``scatter_nd``, ``boolean_mask`` and the contrib ops
other than SSD's (``ops/multibox.py``, ``ops/spatial.py``) wait
(ROADMAP.md, port queue 1, item 4).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .elemwise import (_abs, max_zero_sign, min_zero_sign,
                       signed_zeros)
from .registry import register

__all__ = ["reshape_with_magic"]

# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


def reshape_with_magic(shape_in, target):
    """MXNet's Reshape target with its magic values resolved: 0 copies a
    dim, -1 infers one, -2 copies the rest, -3 merges two, -4 splits one
    (reference: ``src/operator/tensor/matrix_op.cc :: ReshapeShape``)."""
    target = list(target)
    out, src = [], list(shape_in)
    i = j = 0
    while j < len(target):
        t = target[j]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = target[j + 1], target[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(t)
            i += 1
        j += 1
    if out.count(-1) == 1:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in shape_in:
            total *= d
        out[out.index(-1)] = total // max(known, 1)
    return tuple(out)


@register("Reshape", aliases=["reshape"])
def reshape_op(data, *, shape=(), reverse=False):
    shape = tuple(shape)
    if reverse:
        tgt = reshape_with_magic(data.shape[::-1], shape[::-1])[::-1]
    else:
        tgt = reshape_with_magic(data.shape, shape)
    return data.reshape(tgt)


@register("reshape_like")
def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


@register("Flatten", aliases=["flatten"])
def flatten_op(data):
    return data.reshape(data.shape[0], -1)


@register("transpose")
def transpose(data, *, axes=()):
    axes = tuple(axes) if axes else tuple(reversed(range(data.dim())))
    return data.permute(axes)


@register("expand_dims")
def expand_dims(data, *, axis=0):
    return data.unsqueeze(axis)


@register("squeeze")
def squeeze(data, *, axis=None):
    if axis is None:
        return data.squeeze()
    return data.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register("broadcast_to")
def broadcast_to(data, *, shape=()):
    tgt = tuple(s if t == 0 else t for s, t in zip(data.shape, shape))
    return data.expand(tgt + tuple(shape)[len(tgt):])


@register("broadcast_like")
def broadcast_like(lhs, rhs, *, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape)
    tgt = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        tgt[la] = rhs.shape[ra]
    return lhs.expand(tgt)


@register("broadcast_axis", aliases=["broadcast_axes"])
def broadcast_axis(data, *, axis=(), size=()):
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return data.expand(tgt)


def _check_step(step):
    if step is not None and step < 0:
        raise MXNetError("slice: a negative step is not ported yet "
                         "(ROADMAP.md, port queue 1, item 4)")
    return step


@register("slice")
def slice_op(data, *, begin=(), end=(), step=()):
    step = step or (None,) * len(begin)
    idx = tuple(slice(b, e, _check_step(step[i] if i < len(step) else None))
                for i, (b, e) in enumerate(zip(begin, end)))
    return data[idx]


@register("slice_axis")
def slice_axis(data, *, axis=0, begin=0, end=None):
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("slice_like")
def slice_like(data, shape_like, *, axes=()):
    axes = tuple(axes) if axes else tuple(range(shape_like.dim()))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("Concat", aliases=["concat"])
def concat(*data, dim=1, num_args=None):
    return torch.cat(data, dim=dim)


@register("stack")
def stack(*data, axis=0, num_args=None):
    return torch.stack(data, dim=axis)


def _split(data, sections, axis, squeeze_axis):
    n = data.shape[axis]
    if isinstance(sections, int):
        if n % sections:
            raise ValueError(f"split: axis {axis} of size {n} does not "
                             f"divide into {sections} equal sections")
        parts = torch.split(data, n // sections, dim=axis)
    else:
        bounds = [0, *sections, n]
        parts = [data.narrow(axis, a, max(b - a, 0))
                 for a, b in zip(bounds[:-1], bounds[1:])]
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("split", aliases=["SliceChannel"])
def split(data, *, num_outputs=1, axis=1, squeeze_axis=False):
    return _split(data, num_outputs, axis, squeeze_axis)


@register("_split_views", views=True)
def split_views(data, *, num_outputs=1, axis=-1):
    """``data`` cut into ``num_outputs`` equal parts along ``axis``, as
    views of it: one split, whose backward is one concatenation. The
    port's own op (``split`` hands out copies, as the reference's does);
    its NDArray outputs share ``data``'s storage."""
    return data.split(data.shape[axis] // num_outputs, dim=axis)


@register("split_v2")
def split_v2(data, *, indices=(), axis=0, squeeze_axis=False, sections=0):
    return _split(data, sections if sections > 0 else list(indices), axis,
                  squeeze_axis)


@register("tile")
def tile(data, *, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat")
def repeat(data, *, repeats=1, axis=None):
    return torch.repeat_interleave(data, repeats, dim=axis)


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register("Pad", aliases=["pad"])
def pad_op(data, *, mode="constant", pad_width=(), constant_value=0.0):
    # MXNet lists (before, after) from the first axis; F.pad from the last
    pw = []
    for i in reversed(range(len(pad_width) // 2)):
        pw += [pad_width[2 * i], pad_width[2 * i + 1]]
    if mode == "constant":
        return F.pad(data, pw, mode="constant", value=constant_value)
    # F.pad pads only the trailing axes in these modes: drop the leading
    # zero pairs (MXNet pads no batch or channel axis here either)
    while len(pw) > 2 and pw[-2:] == [0, 0]:
        pw = pw[:-2]
    return F.pad(data, pw, mode=_PAD_MODES[mode])


@register("flip", aliases=["reverse"])
def flip(data, *, axis=()):
    return torch.flip(data, (axis,) if isinstance(axis, int) else tuple(axis))


@register("swapaxes", aliases=["SwapAxis"])
def swapaxes(data, *, dim1=0, dim2=0):
    return data.transpose(dim1, dim2)


@register("depth_to_space")
def depth_to_space(data, *, block_size=1):
    """(n, c, h, w) -> (n, c / b^2, h b, w b): the channel blocks moved
    into the spatial axes in DCR order (reference ``ops/tensor.py:212``)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, *, block_size=1):
    """The inverse of :func:`depth_to_space` (reference ``:221``)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# the Sequence ops (reference ops/tensor.py:294-335): masks and gathers,
# on the device of the data, with no host sync
# ---------------------------------------------------------------------------


def _lengths(sequence_length, axis, ndim):
    """The lengths as int64 (floats truncated, as ``astype(int32)``),
    shaped to broadcast against the (time, batch) or (batch, time) axes
    of an ``ndim``-dimensional input."""
    lens = sequence_length.to(torch.int32).to(torch.int64)
    shape = (1, -1) if axis == 0 else (-1, 1)
    return lens.reshape(shape + (1,) * (ndim - 2))


def _check_seq_axis(op, axis):
    if axis not in (0, 1):
        raise MXNetError(f"{op}: axis {axis} must be 0 (TNC) or 1 (NTC)")


@register("SequenceMask", aliases=["sequence_mask"])
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                  value=0.0, axis=0):
    """The steps of each sequence at or past its length set to ``value``
    (``axis`` 0: data is (time, batch, ...); 1: (batch, time, ...))."""
    _check_seq_axis("SequenceMask", axis)
    if not use_sequence_length or sequence_length is None:
        return data
    pos = torch.arange(data.shape[axis], device=data.device)
    pos = pos.reshape((-1, 1) if axis == 0 else (1, -1))
    mask = pos.reshape(pos.shape + (1,) * (data.dim() - 2)) \
        < _lengths(sequence_length, axis, data.dim())
    return torch.where(mask, data, data.new_full((), value))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step (the last step without lengths);
    a length of 0 reads the step before step 0, i.e. the last one, as
    the reference's ``take_along_axis`` of index -1 does."""
    _check_seq_axis("SequenceLast", axis)
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    last = (_lengths(sequence_length, axis, data.dim()) - 1) \
        % data.shape[axis]
    shape = list(data.shape)
    shape[axis] = 1
    return torch.gather(data, axis, last.expand(shape)).squeeze(axis)


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, *, use_sequence_length=False,
                     axis=0):
    """The first ``length`` steps of each sequence reversed, the padding
    left in place. Without lengths the reference flips axis 0 whatever
    ``axis`` says, and so does the port; with lengths ``axis`` 1 reverses
    along axis 1 (the reference gathers along axis 0 there too, which
    holds only for a square (batch, time) input)."""
    _check_seq_axis("SequenceReverse", axis)
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    pos = torch.arange(data.shape[axis], device=data.device)
    pos = pos.reshape(((-1, 1) if axis == 0 else (1, -1))
                      + (1,) * (data.dim() - 2))
    sl = _lengths(sequence_length, axis, data.dim())
    src = torch.where(pos < sl, sl - 1 - pos, pos)
    return torch.gather(data, axis, src.expand(data.shape))


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------


def _index(indices, n, mode):
    idx = indices.to(torch.int64)
    if mode == "wrap":
        return torch.remainder(idx, n)
    return idx.clamp(0, n - 1)          # "clip", and "raise" as the reference


@register("take")
def take(a, indices, *, axis=0, mode="clip"):
    axis = axis % a.dim()
    idx = _index(indices, a.shape[axis], mode)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick")
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    idx = _index(index, data.shape[axis], mode)
    picked = torch.take_along_dim(data, idx.unsqueeze(axis), dim=axis)
    return picked if keepdims else picked.squeeze(axis)


@register("one_hot")
def one_hot(indices, *, depth=1, on_value=1.0, off_value=0.0,
            dtype="float32"):
    pos = torch.arange(depth, device=indices.device)
    oh = (indices.to(torch.int64).unsqueeze(-1) == pos).to(torch_dtype(dtype))
    return oh * on_value + (1.0 - oh) * off_value


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _axes(data, axis, exclude):
    if axis is None or axis == ():
        return tuple(range(data.dim()))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(a % max(data.dim(), 1) for a in ax)
    if exclude:
        ax = tuple(i for i in range(data.dim()) if i not in ax)
    return ax


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _mean(x, dim, keepdim):
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _reduce(name, fn, aliases=()):
    def impl(data, *, axis=None, keepdims=False, exclude=False):
        ax = _axes(data, axis, exclude)
        if not ax:
            return data
        return fn(data, ax, keepdims)

    impl.__name__ = name
    register(name, aliases=list(aliases))(impl)


_reduce("sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k, dtype=x.dtype),
        aliases=["sum_axis"])
_reduce("mean", _mean)
_reduce("prod", _prod)
def amax(x, dim, keepdim):
    """``jnp.max``: torch's ``amax`` (the gradient split over the ties,
    as the reference's), with XLA's +0 where a +0 meets a -0."""
    out = torch.amax(x, dim=dim, keepdim=keepdim)
    if not x.dtype.is_floating_point:
        return out
    return max_zero_sign(out, signed_zeros(x, False).any(dim=dim,
                                                          keepdim=keepdim))


def amin(x, dim, keepdim):
    """``jnp.min``; see :func:`amax`."""
    out = torch.amin(x, dim=dim, keepdim=keepdim)
    if not x.dtype.is_floating_point:
        return out
    return min_zero_sign(out, signed_zeros(x, True).any(dim=dim,
                                                         keepdim=keepdim))


_reduce("max", amax, aliases=["max_axis"])
_reduce("min", amin, aliases=["min_axis"])


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    ax = _axes(data, axis, False)
    if ord == 1:
        # the registered abs: its gradient is 1 at +-0, as jnp.abs's
        return torch.sum(_abs(data), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                keepdim=keepdims))


def _arg(fn, data, axis, keepdims):
    if axis is None:
        return fn(data).to(torch.float32)
    return fn(data, dim=axis, keepdim=keepdims).to(torch.float32)


@register("L2Normalization")
def l2_normalization(data, *, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` over every axis but the first
    (``instance``), the channel axis (``channel``) or the spatial axes
    (``spatial``) (reference ``ops/tensor.py:377``)."""
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, data.dim()))
    else:
        raise MXNetError(f"L2Normalization: mode {mode!r} is not instance, "
                         "channel or spatial")
    return data / torch.sqrt(data.square().sum(dim=ax, keepdim=True) + eps)


@register("argmax")
def argmax(data, *, axis=None, keepdims=False):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, *, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------


@register("topk")
def topk(data, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    # a stable sort, then the first k: equal values come in index order,
    # as jax.lax.top_k gives them (torch.topk's order among ties is not
    # the reference's); top_k orders -0 below +0, so a float input is
    # sorted by its zeros' signs first
    if data.dtype.is_floating_point:
        first = torch.sort(torch.signbit(data).to(torch.uint8), dim=axis,
                           descending=is_ascend, stable=True)[1]
        vals, raw = torch.sort(data.gather(axis, first), dim=axis,
                               descending=not is_ascend, stable=True)
        raw = first.gather(axis, raw)
    else:
        vals, raw = torch.sort(data, dim=axis, descending=not is_ascend,
                               stable=True)
    vals, raw = vals.narrow(axis, 0, k), raw.narrow(axis, 0, k)
    if ret_typ == "indices":
        return raw.to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, raw.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(axis, raw, 1)
    raise ValueError(ret_typ)


@register("sort")
def sort(data, *, axis=-1, is_ascend=True):
    s = torch.sort(data, dim=axis, stable=True).values
    return s if is_ascend else torch.flip(s, (axis,))


@register("argsort")
def argsort(data, *, axis=-1, is_ascend=True, dtype="float32"):
    s = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        s = torch.flip(s, (axis,))
    return s.to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def _t(x):
    return x.permute(tuple(reversed(range(x.dim()))))


@register("dot")
def dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    a = _t(lhs) if transpose_a else lhs
    b = _t(rhs) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    # MXNet's dot contracts a's last axis with b's first
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, *, transpose_a=False, transpose_b=False):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)


@register("_zeros", aliases=["zeros"])
def _zeros(*, shape=(), dtype="float32", device=None):
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("_ones", aliases=["ones"])
def _ones(*, shape=(), dtype="float32", device=None):
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype), device=device)


@register("_full", aliases=["full"])
def _full(*, shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                      device=device)


@register("_arange", aliases=["arange"])
def _arange(*, start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None):
    """``jnp.arange`` with a step, which is ``np.arange``: the first two
    values rounded to the dtype, then ``first + i * (second - first)``
    computed in the dtype (in f32 for f16 and bf16, rounded once), not
    each value in f64 as ``torch.arange`` does."""
    if stop is None:
        start, stop = 0, start
    dt = torch_dtype(dtype)
    n = max(0, math.ceil((stop - start) / step))
    work = torch.float32 if dt in (torch.float16, torch.bfloat16) else dt
    ends = torch.tensor([start, start + step], dtype=dt,
                        device=device).to(work)
    out = ends[0] + torch.arange(n, dtype=work, device=device) * (
        ends[1] - ends[0])
    if n > 1:
        out[1] = ends[1]
    out = out.to(dt)
    return torch.repeat_interleave(out, repeat) if repeat > 1 else out


@register("_contrib_arange_like", aliases=["arange_like"])
def arange_like(data, *, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * i`` in f32 over ``data``'s shape, or over its
    ``axis`` alone, on ``data``'s device (no host copy: a CUDA graph
    captures it). ``repeat`` is taken and ignored, as in the
    reference."""
    if axis is None:
        out = start + step * torch.arange(data.numel(), dtype=torch.float32,
                                          device=data.device)
        return out.reshape(data.shape)
    return start + step * torch.arange(data.shape[axis], dtype=torch.float32,
                                       device=data.device)


@register("diag")
def diag(data, *, k=0, axis1=0, axis2=1):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)


@register("shape_array")
def shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int64, device=data.device)


@register("size_array")
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)
