"""NDArray of the port: MXNet's imperative array over one
``torch.Tensor`` (counterpart of ``mxnet_tpu/ndarray/ndarray.py``:
``NDArray`` ``:53-650``, ``imperative_invoke`` ``:706``, ``array``
``:893``, ``empty`` ``:910``, ``waitall`` ``:919``, the fluent methods
``:930+``).

An NDArray holds one tensor and its :class:`Context`. Ops go through the
registry (``ops/registry.py``) on the tensors and return new NDArrays;
PyTorch queues each on the card's current stream and returns, as the
reference engine does, and ``wait_to_read``, ``asnumpy`` and
``waitall`` are the sync points where an asynchronous CUDA error comes
up as :class:`MXNetError`. Where the reference's semantics and
PyTorch's differ, the reference holds:

* an op's output is a new array: an output that aliases an input (a
  PyTorch view) or is not contiguous is copied;
* basic indexing (``x[1:3]``, ``x[0, :2]``) and :meth:`NDArray.reshape`
  give views that write through to their base, as the reference's
  lenses do; ``reshape`` uses ``Tensor.view`` and raises where no view
  exists; an NDArray index copies (``take``);
* outside ``autograd.record()`` no op is recorded (ops and writes run
  under ``torch.no_grad()``, so ``w[:] = w - lr * w.grad`` writes a leaf
  that requires a gradient); inside it every op is, and an in-place
  write to an array on the tape raises at the write
  (``ndarray.py:606-615``);
* a write outside ``record()`` to an array whose storage a live graph
  saved copies on write: a base array swaps in a fresh tensor (the
  reference's functional swap, so the graph keeps what it saved and its
  views follow the base), and the same write through a view raises
  (ROADMAP.md, port queue 3);
* the default context is :func:`current_context`, ``gpu(0)`` (the
  reference's is ``cpu(0)``); ``asnumpy()`` of a bf16 array gives
  float32, and ``dtype`` of one is the string ``"bfloat16"`` (no
  ``ml_dtypes`` on the card's machine).
"""
from __future__ import annotations

from typing import Optional

import numpy as _np
import torch

from .. import autograd, engine
from ..base import MXNetError, numeric_types, torch_dtype
from ..context import Context, current_context
from ..ops import registry
from ..ops.registry import get_op
from ..ops.tensor import reshape_with_magic

__all__ = ["NDArray", "array", "empty", "imperative_invoke", "waitall"]

_NP_DTYPES = {torch.float32: _np.float32, torch.float64: _np.float64,
              torch.float16: _np.float16, torch.uint8: _np.uint8,
              torch.int8: _np.int8, torch.int16: _np.int16,
              torch.int32: _np.int32, torch.int64: _np.int64,
              torch.bool: _np.bool_}


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class NDArray:
    """Multi-dimensional array on a device context, over one tensor.

    ``NDArray(tensor)`` wraps the tensor without a copy (the reference's
    ``NDArray(data=...)``); its context is the tensor's device, and a
    ``ctx`` given beside it must agree (any ``cpu(i)`` names the host:
    several CPU contexts, each array keeping its own, as in the
    reference; ops and views keep their input's)."""

    __array_priority__ = 100.0

    def __init__(self, data: torch.Tensor, ctx: Optional[Context] = None,
                 _base: Optional["NDArray"] = None, _view=None):
        if not isinstance(data, torch.Tensor):
            raise TypeError(f"NDArray wraps a torch.Tensor, not "
                            f"{type(data).__name__}; use mx.nd.array")
        if ctx is None:
            self._ctx = Context.from_device(data.device)
        else:
            if not isinstance(ctx, Context):
                ctx = Context(ctx)
            # the CPU contexts cpu(0), cpu(1)... all name the host, as the
            # reference's several CPU contexts do
            dev = data.device
            # cpu_pinned labels a pinned host tensor or the card's copy of
            # one (a staged input batch, as the reference labels it)
            if ctx.device_typeid == 3:
                pass
            elif dev.type != ("cuda" if ctx.device_typeid == 2 else "cpu") \
                    or (dev.type == "cuda"
                        and (dev.index or 0) != ctx.device_id):
                raise MXNetError(f"NDArray: the tensor is on "
                                 f"{Context.from_device(dev)}, not {ctx}")
            self._ctx = ctx
        self._tensor = data
        # a view: its root base and how to derive it from the base's tensor
        self._base = _base
        self._view = _view
        self._base_tensor = None if _base is None else _base._tensor
        self._version = 0
        self._grad_nd = None

    # ------------------------------------------------------------------
    # payload
    # ------------------------------------------------------------------
    @property
    def _data(self) -> torch.Tensor:
        """The tensor; a view whose base swapped its tensor (copy on
        write) derives itself again from the new one."""
        b = self._base
        if b is not None and b._tensor is not self._base_tensor:
            self._tensor = self._view(b._tensor)
            self._base_tensor = b._tensor
        return self._tensor

    data = _data

    def _prepare_write(self) -> torch.Tensor:
        """The checks before an in-place write; returns the tensor to
        write into."""
        if autograd.is_recording() and autograd.is_on_tape(self):
            raise MXNetError(
                "in-place operation on an array held by the autograd tape "
                "inside autograd.record() is not allowed; use out-of-place "
                "ops or move the mutation outside the record scope")
        t = self._data
        if autograd.holds_live_save(t):
            if self._base is not None:
                raise MXNetError(
                    "write through a view of an array that a live autograd "
                    "graph saved; run backward first, or write to the base "
                    "array (which copies on write)")
            new = t.detach().clone()
            if t.requires_grad:
                new.requires_grad_(True)
                new.grad = t.grad           # backward writes the same buffer
                if hasattr(t, "_mx_grad_req"):
                    new._mx_grad_req = t._mx_grad_req
            self._tensor = t = new
        return t

    def _wrote(self) -> None:
        self._version += 1
        if self._base is not None:
            self._base._version += 1

    def _assign(self, value) -> None:
        """Write ``value`` (a tensor, broadcast and cast) into the whole
        array."""
        t = self._prepare_write()
        with torch.no_grad():
            t.copy_(value)
        self._wrote()

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        dt = self._data.dtype
        return "bfloat16" if dt == torch.bfloat16 else _np.dtype(
            _NP_DTYPES[dt])

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return imperative_invoke(get_op("transpose"), [self], {})

    @property
    def grad(self) -> Optional["NDArray"]:
        t = self._data
        g = t.grad if t.is_leaf else None
        if g is None:
            return None
        if self._grad_nd is None or self._grad_nd._tensor is not g:
            self._grad_nd = NDArray(g, ctx=self._ctx)
        return self._grad_nd

    @property
    def _grad_req(self) -> str:
        t = self._data
        return getattr(t, "_mx_grad_req", "write") if t.requires_grad \
            else "null"

    @property
    def handle(self):
        return id(self)

    # ------------------------------------------------------------------
    # sync and host transfer
    # ------------------------------------------------------------------
    def wait_to_read(self) -> None:
        engine.wait_to_read(self._data)

    def asnumpy(self) -> _np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        try:
            return t.to("cpu", copy=True).numpy()
        except RuntimeError as e:
            raise MXNetError(f"asnumpy: an asynchronous CUDA error: {e}") \
                from e

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    item = asscalar

    def tolist(self):
        return self.asnumpy().tolist()

    # ------------------------------------------------------------------
    # context and dtype
    # ------------------------------------------------------------------
    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self._ctx:
            return self
        if self._ctx.device_typeid == 3 and ctx.device_typeid == 2:
            # a staged input batch going to the card: the card's copy
            # changes label without another copy, and a pinned host
            # tensor crosses asynchronously (the copy is ordered on the
            # current stream, which reads it). Any other move, to the
            # host above all, is copyto's synchronous copy.
            return NDArray(self._data.detach().to(ctx.torch_device(),
                                                  non_blocking=True),
                           ctx=ctx)
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def copyto(self, other) -> "NDArray":
        if isinstance(other, NDArray):
            other._assign(self._data.detach().to(other._data.device))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), ctx=other)
        raise TypeError(f"copyto does not support type {type(other)}")

    def copy(self) -> "NDArray":
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return imperative_invoke(get_op("Cast"), [self],
                                 {"dtype": str(dt).split(".")[-1]})

    # ------------------------------------------------------------------
    # autograd
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Make this array a leaf of the tape with a zero gradient buffer
        (``grad_req`` "write" or "add"; "null" detaches it)."""
        t = self._data
        if not t.is_leaf:
            t = self._tensor = t.detach()
        if not (t.dtype.is_floating_point or t.dtype.is_complex):
            raise MXNetError(f"attach_grad: a {t.dtype} array cannot have "
                             "a gradient")
        t.requires_grad_(grad_req != "null")
        t._mx_grad_req = grad_req
        t.grad = None if grad_req == "null" else torch.zeros_like(t)

    def drop_grad(self) -> None:
        self.attach_grad("null")

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach(), ctx=self._ctx)

    def backward(self, out_grad=None, retain_graph=False,
                 train_mode=True) -> None:
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph)

    # ------------------------------------------------------------------
    # shape (views)
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """A view of ``shape`` (MXNet's magic values allowed) that writes
        through to this array; raises where no view exists."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        new = reshape_with_magic(self.shape, tuple(shape))
        try:
            return self._make_view(lambda t: t.view(new))
        except RuntimeError as e:
            raise MXNetError(f"reshape to {new} is not a view of this "
                             f"array: {e}") from e

    def _make_view(self, fn, out=None) -> "NDArray":
        """The view ``fn`` of this array (``out``: ``fn`` of its tensor,
        where already taken), kept derivable from the root base."""
        if out is None:
            with torch.set_grad_enabled(autograd.is_recording()):
                out = fn(self._data)
        if self._base is None:
            return NDArray(out, ctx=self._ctx, _base=self, _view=fn)
        outer = self._view
        return NDArray(out, ctx=self._ctx, _base=self._base,
                       _view=lambda t: fn(outer(t)))

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        return imperative_invoke(get_op("expand_dims"), [self], {"axis": axis})

    def squeeze(self, axis=None):
        return imperative_invoke(get_op("squeeze"), [self], {"axis": axis})

    def flatten(self):
        return imperative_invoke(get_op("Flatten"), [self], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return imperative_invoke(get_op("transpose"), [self], {"axes": axes})

    def swapaxes(self, dim1, dim2):
        return imperative_invoke(get_op("swapaxes"), [self],
                                 {"dim1": dim1, "dim2": dim2})

    def flip(self, axis):
        return imperative_invoke(get_op("flip"), [self], {"axis": axis})

    def tile(self, reps):
        return imperative_invoke(get_op("tile"), [self], {"reps": reps})

    def slice(self, begin, end, step=None):
        return imperative_invoke(get_op("slice"), [self],
                                 {"begin": begin, "end": end,
                                  "step": step or ()})

    def slice_axis(self, axis, begin, end):
        return imperative_invoke(get_op("slice_axis"), [self],
                                 {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return imperative_invoke(get_op("take"), [self, indices],
                                 {"axis": axis, "mode": mode})

    def pick(self, index, axis=-1, mode="clip", keepdims=False):
        return imperative_invoke(get_op("pick"), [self, index],
                                 {"axis": axis, "keepdims": keepdims,
                                  "mode": mode})

    def one_hot(self, depth, **kw):
        return imperative_invoke(get_op("one_hot"), [self],
                                 {"depth": depth, **kw})

    def broadcast_like(self, rhs, **kw):
        return imperative_invoke(get_op("broadcast_like"), [self, rhs], kw)

    def slice_like(self, shape_like, axes=()):
        return imperative_invoke(get_op("slice_like"), [self, shape_like],
                                 {"axes": axes})

    def clip(self, a_min, a_max):
        return imperative_invoke(get_op("clip"), [self],
                                 {"a_min": a_min, "a_max": a_max})

    def _reduce(self, op, axis, keepdims, **kw):
        return imperative_invoke(get_op(op), [self],
                                 {"axis": axis, "keepdims": keepdims, **kw})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._reduce("norm", axis, keepdims, ord=ord)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return imperative_invoke(get_op("argsort"), [self],
                                 {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return imperative_invoke(get_op("topk"), [self],
                                 {"axis": axis, "k": k, "ret_typ": ret_typ,
                                  "is_ascend": is_ascend})

    def softmax(self, axis=-1):
        return imperative_invoke(get_op("softmax"), [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return imperative_invoke(get_op("log_softmax"), [self],
                                 {"axis": axis})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return imperative_invoke(get_op("dot"), [self, other],
                                 {"transpose_a": transpose_a,
                                  "transpose_b": transpose_b})

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError(f"tostype({stype!r}): sparse storage is not "
                             "ported (ROADMAP.md, port queue 1, item 4)")
        return self

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def __getitem__(self, key):
        """Basic indexing gives a view; an NDArray index, advanced
        indexing and a slice with a negative step give a copy (the
        elements of the positive-step slice over the same elements,
        flipped: torch has no negative strides)."""
        if isinstance(key, NDArray):
            return imperative_invoke(get_op("take"), [self, key], {"axis": 0})
        key = _clean_index(key)
        key, flips = _positive_steps(key, self.shape)
        with torch.set_grad_enabled(autograd.is_recording()):
            out = self._data[key]
            if flips:
                return NDArray(torch.flip(out, flips), ctx=self._ctx)
        if out._base is None:              # advanced indexing copied
            return NDArray(out, ctx=self._ctx)
        return self._make_view(lambda t: t[key], out)

    def __setitem__(self, key, value):
        t = self._prepare_write()
        key = _clean_index(key)
        key, flips = _positive_steps(key, self.shape)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, numeric_types):
            value = torch.as_tensor(_np.asarray(value), device=t.device)
        with torch.no_grad():
            if isinstance(key, torch.Tensor):
                t[key.to(torch.int64)] = value
            else:
                if flips and isinstance(value, torch.Tensor):
                    value = torch.flip(
                        torch.broadcast_to(value, t[key].shape), flips)
                t[key] = value
        self._wrote()

    # ------------------------------------------------------------------
    # Python protocol
    # ------------------------------------------------------------------
    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self._ctx}>")

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, stream=None):
        return self._data.detach().__dlpack__(stream=stream)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------------
    # arithmetic
    # ------------------------------------------------------------------
    def _binop(self, other, opname, scalar_opname, reverse=False):
        if isinstance(other, NDArray):
            args = [other, self] if reverse else [self, other]
            return imperative_invoke(get_op(opname), args, {})
        if isinstance(other, numeric_types):
            return imperative_invoke(get_op(scalar_opname), [self],
                                     {"scalar": float(other)})
        if isinstance(other, _np.ndarray):
            return self._binop(array(other, ctx=self._ctx), opname,
                               scalar_opname, reverse)
        return NotImplemented

    def _rbinop(self, other, opname, scalar_opname):
        if isinstance(other, numeric_types):
            return imperative_invoke(get_op(scalar_opname), [self],
                                     {"scalar": float(other)})
        return self._binop(other, opname, scalar_opname, reverse=True)

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._rbinop(o, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._rbinop(o, "broadcast_div", "_rdiv_scalar")

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._rbinop(o, "broadcast_mod", "_rmod_scalar")

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._rbinop(o, "broadcast_power", "_rpower_scalar")

    def __neg__(self):
        return imperative_invoke(get_op("negative"), [self], {})

    def __abs__(self):
        return imperative_invoke(get_op("abs"), [self], {})

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def _ibinop(self, other, opname, scalar_opname):
        # in place, as MXNet's +=: the result is cast to this array's dtype
        self._prepare_write()
        with autograd.pause():
            out = self._binop(other, opname, scalar_opname)
        if out is NotImplemented:
            return out
        self._assign(out._data)
        return self

    def __iadd__(self, o):
        return self._ibinop(o, "broadcast_add", "_plus_scalar")

    def __isub__(self, o):
        return self._ibinop(o, "broadcast_sub", "_minus_scalar")

    def __imul__(self, o):
        return self._ibinop(o, "broadcast_mul", "_mul_scalar")

    def __itruediv__(self, o):
        return self._ibinop(o, "broadcast_div", "_div_scalar")

    def save(self, fname):
        from .serialization import save

        save(fname, self)


def _positive_steps(key, shape):
    """``(key, flips)``: a basic index with each negative-step slice
    replaced by the positive-step slice over the same elements, and the
    result's dims those slices make, to flip back. An index with tensors
    in it is returned as it is."""
    parts = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in parts) \
            or any(isinstance(k, torch.Tensor) for k in parts):
        return key, []
    used = sum(1 for k in parts if k is not None and k is not Ellipsis)
    out, flips, dim, odim = [], [], 0, 0
    for k in parts:
        if k is Ellipsis:
            skip = len(shape) - used
            dim, odim = dim + skip, odim + skip
        elif k is None:
            odim += 1
        elif isinstance(k, slice):
            if k.step is not None and k.step < 0:
                n = len(range(*k.indices(shape[dim])))
                start, _, step = k.indices(shape[dim])
                low = start + (n - 1) * step
                k = slice(low, start + 1, -step) if n else slice(0, 0)
                flips.append(odim)
            dim, odim = dim + 1, odim + 1
        else:                               # an integer drops its dim
            dim += 1
        out.append(k)
    return tuple(out), flips


def _clean_index(key):
    if isinstance(key, NDArray):
        return key._data.to(torch.int64)
    if isinstance(key, tuple):
        return tuple(k._data.to(torch.int64) if isinstance(k, NDArray) else k
                     for k in key)
    return key


# ---------------------------------------------------------------------------
# the imperative invoke path
# ---------------------------------------------------------------------------


def _fresh(out: torch.Tensor, inputs) -> torch.Tensor:
    """``out`` as a new contiguous tensor of its own (a PyTorch op may
    hand back a view of its input, the reference's never does)."""
    if not out.is_contiguous() or any(
            _storage(out) == _storage(t) for t in inputs):
        return out.clone(memory_format=torch.contiguous_format)
    return out


def _canon_attr(v):
    if isinstance(v, list):
        return tuple(v)
    if isinstance(v, _np.integer):
        return int(v)
    if isinstance(v, _np.floating):
        return float(v)
    return v


def imperative_invoke(opdef, tensor_args, attrs, out=None, ctx=None):
    """Run a registered op on NDArrays (reference: ``ndarray.py:706``):
    under ``record()`` with PyTorch's autograd recording (and the saved
    tensors registered, ``autograd.saved_tensor_hooks``), outside it
    under ``torch.no_grad()``; outputs are new NDArrays, or are written
    into ``out``. A creation op (no tensor inputs) creates on ``ctx``,
    else on :func:`current_context`."""
    if ctx is None:
        ctx = next((a.context for a in tensor_args if isinstance(a, NDArray)),
                   None)
    if ctx is None:
        ctx = current_context()
    elif isinstance(ctx, str):
        ctx = Context(ctx)
    vals = []
    for a in tensor_args:
        if isinstance(a, NDArray):
            vals.append(a._data)
        elif a is None or isinstance(a, numeric_types):
            vals.append(a)
        else:
            vals.append(array(a, ctx=ctx)._data)
    attrs = {k: _canon_attr(v) for k, v in attrs.items()
             if v is not None or k == "axis"}
    if not opdef.tensor_params:
        attrs["device"] = ctx.torch_device()
    if autograd.is_recording():
        with torch.enable_grad(), autograd.saved_tensor_hooks():
            result = registry.invoke(opdef, vals, attrs)
    else:
        with torch.no_grad():
            result = registry.invoke(opdef, vals, attrs)
    multi = isinstance(result, (tuple, list))
    inputs = [v for v in vals if isinstance(v, torch.Tensor)]
    if opdef.views:
        # views of the one input, derived from it again as reshape's are
        src = tensor_args[0]
        outputs = [src._make_view(
            lambda t, i=i: registry.invoke(opdef, [t], attrs)[i]
            if multi else registry.invoke(opdef, [t], attrs), out=r)
            for i, r in enumerate(result if multi else [result])]
    else:
        outputs = [_wrap(_fresh(r, inputs), ctx)
                   for r in (result if multi else [result])]
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs, outputs):
            dst._assign(src._data)
        return out
    return outputs if multi else outputs[0]


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------


def _wrap(t: torch.Tensor, ctx: Context) -> NDArray:
    """An op's output on ``ctx`` when that names its device (a
    ``cpu(i)`` input gives ``cpu(i)`` outputs), else on its device."""
    if ctx.device_type == "cpu" and t.device.type == "cpu":
        return NDArray(t, ctx=ctx)
    return NDArray(t)


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """A new NDArray holding a copy of ``source_array`` (an NDArray, a
    tensor or anything numpy takes) on ``ctx`` (default:
    :func:`current_context`). float64 data becomes float32 unless
    ``dtype`` says otherwise (reference: ``mx.nd.array``)."""
    ctx = (ctx if isinstance(ctx, Context) else
           Context(ctx) if ctx is not None else current_context())
    dev = ctx.torch_device()
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        src = source_array.detach()
        dt = src.dtype if dtype is None else torch_dtype(dtype)
        return NDArray(src.to(device=dev, dtype=dt, copy=True), ctx=ctx)
    src = _np.asarray(source_array)
    if dtype is None and src.dtype == _np.float64:
        dtype = "float32"
    # a private copy: the array never aliases the caller's numpy buffer
    t = torch.from_numpy(_np.array(src, order="C"))
    dt = t.dtype if dtype is None else torch_dtype(dtype)
    return NDArray(t.to(device=dev, dtype=dt), ctx=ctx)


def empty(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.empty(tuple(shape),
                               dtype=torch_dtype(dtype or "float32"),
                               device=ctx.torch_device()), ctx=ctx)


def waitall() -> None:
    engine.wait_for_all()
