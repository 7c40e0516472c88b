"""``Block`` and ``HybridBlock`` of the port.

Counterpart of ``mxnet_tpu/gluon/block.py:110-860``. A :class:`Block`
is a ``torch.nn.Module`` that carries MXNet's Gluon surface: a name
``prefix`` handed out by the enclosing :meth:`Block.name_scope` (per
thread, ``dense0_``, ``bertmodel0_``...), its :class:`ParameterDict`
``params``, :meth:`collect_params` keyed by the prefixed names,
``register_child``, forward hooks with a ``detach``-able handle,
``initialize``, ``cast``, ``summary`` and
``save_parameters``/``load_parameters`` keyed by the structural names
(``encoder.cells.0.ffn.ffn1.weight``: attribute path, the ``.params``
key of both packages).

A :class:`~mxnet_tpu_torch.gluon.Parameter` set as an attribute is held
by the block, and its tensor is registered under that name in the
module's ``_parameters`` (``_buffers`` when it is not differentiable),
so torch's own machinery (``named_parameters``, ``state_dict``,
``load_state_dict``, ``.to``) sees the same storage as Gluon does.

A :class:`HybridBlock` defines ``hybrid_forward(F, x, *args,
**params)``. One body serves two kinds of caller:

* called with NDArrays, ``F`` is ``mx.nd`` and the parameters come as
  NDArrays over their storage (a user's subclass runs unchanged); the
  result is NDArrays, recorded under ``autograd.record()``;
* called with torch tensors, as ``parallel.TrainStep`` and
  ``serving.Server`` call it, ``F`` runs the same registered ops on the
  tensors (:data:`tensor_ops`) and the parameters come as their
  ``nn.Parameter``\\ s.

``hybridize()`` turns on :class:`_CachedGraph`: a hybridized block called
outside ``record()`` (and outside training mode) on CUDA NDArrays runs one
``torch.cuda.CUDAGraph`` per signature (input, parameter shapes and
dtypes), kept in the compilation service's ``cached_op`` site cache and
warmed from a manifest by ``compiler.warm_start``
(:func:`warm_cached_op_spec`). Under ``record()``, in training mode or on the CPU it runs its
forward eagerly (ROADMAP.md, port queue 3: the dropout kernels take their
seed as a host argument, so a graph would replay one mask). ``export``,
``optimize_for`` and ``SymbolBlock`` need the symbol API (ROADMAP.md,
port queue 1, item 12).

:func:`remat_call` rematerialises a block (reference ``:41-104``):
its activations are recomputed in the backward instead of kept, under
``torch.utils.checkpoint`` (non-reentrant). It does so only while
autograd records (grad enabled and an input or a parameter of the block
requiring grad), as the reference does only inside a trace; a call on
NDArrays, in serving or under ``hybridize`` is a plain call. The
recompute draws the forward's dropout seeds again
(``random_state.seed_tape``/``replay_seeds``), runs in the forward's
training mode, and leaves BatchNorm's running statistics alone
(:func:`is_recomputing`), so they are updated once a step.
"""
from __future__ import annotations

import copy
import functools
import re
import threading
import weakref
from collections import OrderedDict

import torch
from torch import nn

from .. import autograd
from ..base import MXNetError, name_manager, torch_dtype
from ..context import Context, cpu, current_context
from ..ndarray import NDArray
from ..ops.registry import get_op
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _contexts, current_replica,
                        multi_context_live, replica_scope)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "tensor_ops",
           "param_like", "remat_call", "resolve_remat_policy",
           "is_recomputing"]


class _TensorOps:
    """``F`` for torch tensors: ``F.<op>`` is the registered op of that
    name called on tensors, with the positional-to-attribute mapping of
    the ``mx.nd`` wrappers (``F.cast(x, "float32")``); ``F.contrib.<op>``
    is the op ``_contrib_<op>``, as ``mx.nd.contrib`` holds it."""

    def __init__(self, prefix=""):
        self._prefix = prefix

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name == "contrib" and not self._prefix:
            self.contrib = _TensorOps("_contrib_")
            return self.contrib
        opdef = get_op(self._prefix + name)
        n = len(opdef.tensor_params)
        names = opdef.attr_params

        def call(*args, **attrs):
            if opdef.variadic or len(args) <= n:
                return opdef.fn(*args, **attrs)
            for k, v in zip(names, args[n:]):
                attrs[k] = v
            return opdef.fn(*args[:n], **attrs)

        call.__name__ = name
        setattr(self, name, call)
        return call


tensor_ops = _TensorOps()


def _is_nd(args) -> bool:
    return any(isinstance(a, NDArray) for a in args)


def param_like(param: Parameter, x):
    """``param``'s value in the form of ``x``: an NDArray over its
    storage when ``x`` is an NDArray, else its tensor (for a forward body
    that reads another block's parameter)."""
    return param.data() if isinstance(x, NDArray) else param.tensor


def _input_context(args):
    """The context of the first NDArray (or tensor) among ``args``, and
    whether it was read off a tensor's device; (None, False) if none."""
    for a in args:
        if isinstance(a, NDArray):
            return a.context, False
        if isinstance(a, torch.Tensor):
            return Context.from_device(a.device), True
    return None, False


def _raw(x):
    return x._data if isinstance(x, NDArray) else x


# ---------------------------------------------------------------------------
# name scopes
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------

def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``'s counterpart: keep the
    outputs of the matrix products with no batch dimension (``mm``,
    ``addmm``), recompute everything else (every allocation included, so
    a kernel's output buffer is never a saved tensor written again)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(policy):
    """Normalise a remat policy (the one validator of ``remat_call``, the
    model zoo's ``remat=`` and ``TrainStep(remat=...)``, so a typo raises
    the same ``ValueError`` everywhere, at construction): None or
    ``"full"`` save nothing (returns None); ``"dots"`` keeps the outputs
    of the matrix products with no batch dimension and recomputes the
    rest; a callable is a selective-checkpoint policy ``(ctx, op, *args,
    **kwargs) -> CheckpointPolicy`` and passes through."""
    if policy in (None, "full"):
        return None
    if policy == "dots":
        return _dots_policy
    if callable(policy):
        return policy
    raise ValueError(f"unknown remat policy {policy!r}")


class _RematState(threading.local):
    def __init__(self):
        self.recomputing = 0


_remat_state = _RematState()


def is_recomputing() -> bool:
    """True inside the backward's recompute of a rematerialised span."""
    return _remat_state.recomputing > 0


def _records(block, args) -> bool:
    if not torch.is_grad_enabled() or not args \
            or not all(isinstance(a, torch.Tensor) for a in args):
        return False
    if any(a.requires_grad for a in args):
        return True
    return isinstance(block, nn.Module) and any(
        p.requires_grad for p in block.parameters())


def remat_call(block, *args, policy=None):
    """``block(*args)`` rematerialised while autograd records (see the
    module docstring), else a plain call. ``policy``: None or ``"full"``
    (save nothing: the block's forward runs again in the backward) or
    ``"dots"`` (the matrix products' outputs kept, the rest recomputed);
    checked on every call."""
    pol = resolve_remat_policy(policy)
    if not _records(block, args):
        return block(*args)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    from .. import random_state

    training = autograd.is_training()
    runs = [0]
    tape_box = []

    def run(*a):
        first = runs[0] == 0
        runs[0] += 1
        if first:
            with random_state.seed_tape() as tape:
                out = block(*a)
            tape_box.append(tape)
            return out
        prev = autograd.set_training(training)
        _remat_state.recomputing += 1
        try:
            with random_state.replay_seeds(tape_box[0]):
                return block(*a)
        finally:
            _remat_state.recomputing -= 1
            autograd.set_training(prev)

    kw = {"use_reentrant": False}
    if pol is not None:
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(pol)
    return checkpoint(run, *args, **kw)


class _BlockScope(threading.local):
    """The block whose :meth:`Block.name_scope` is open, per thread
    (reference ``block.py:110-160``)."""

    def __init__(self):
        super().__init__()
        self.current = None

    @staticmethod
    def create(prefix, params, hint):
        current = _scope.current
        if current is None:
            if prefix is None:
                prefix = name_manager.get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, shared=params)
            return prefix, params
        block = current._block()
        if prefix is None:
            prefix = name_manager.get(None, hint) + "_"
        if params is None:
            params = ParameterDict(block._params.prefix + prefix)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return block.prefix + prefix, params


_scope = _BlockScope()


class _NameScopeCtx:
    """A block's name scope; re-entrant, the outer scopes kept on a
    stack. It refers to its block weakly (no reference cycle)."""

    def __init__(self, block):
        self._block = weakref.ref(block)
        self._olds = []

    def __deepcopy__(self, memo):
        return _NameScopeCtx(copy.deepcopy(self._block(), memo))

    def __enter__(self):
        self._olds.append(_scope.current)
        _scope.current = self
        return self

    def __exit__(self, *exc):
        _scope.current = self._olds.pop()


class _HookHandle:
    """The handle of a forward hook: ``detach()`` (MXNet) or ``remove()``
    (torch) unregisters it."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self) -> None:
        self._handle.remove()

    remove = detach


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """Base of the port's layers and models (see the module docstring).
    ``prefix``: the name prefix of this block's parameters (default: one
    from the enclosing name scope); ``params``: a :class:`ParameterDict`
    whose parameters this block shares."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _NameScopeCtx(self)
        self._reg_params = OrderedDict()

    def _alias(self) -> str:
        return self.__class__.__name__.lower()

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    @property
    def params(self) -> ParameterDict:
        return self._params

    @property
    def _children(self):
        return self._modules

    def name_scope(self):
        return self._scope

    # -- parameters as attributes --------------------------------------
    def __setattr__(self, name, value):
        reg = self.__dict__.get("_reg_params")
        old = reg.get(name) if reg is not None else None
        if old is not None and old is not value:
            old._detach(self, name)
            del reg[name]
            self._parameters.pop(name, None)
            self._buffers.pop(name, None)
        if isinstance(value, Parameter):
            if reg is None:
                raise AttributeError("cannot assign a Parameter before "
                                     "Block.__init__() call")
            reg[name] = value
            object.__setattr__(self, name, value)
            if old is not value:
                value._attach(self, name)
            return
        super().__setattr__(name, value)

    def _register_var(self, name: str, var) -> None:
        """Hold ``var`` (None before initialization) under ``name``: in
        ``_parameters`` when the parameter is differentiable, else in
        ``_buffers``."""
        if self._reg_params[name]._differentiable:
            self._buffers.pop(name, None)
            self._parameters[name] = var
        else:
            self._parameters.pop(name, None)
            self._buffers[name] = var

    def _apply(self, fn, recurse=True):
        # torch's _apply swaps a buffer (and, with its conversion flag, a
        # parameter) for a new tensor: the Gluon parameter follows it
        out = super()._apply(fn, recurse)
        for name, p in self._reg_params.items():
            cur = self._parameters.get(name, self._buffers.get(name))
            if cur is not None and cur is not p._var:
                p._adopt(cur)
                p._init_grad()
        return out

    def _clear_cached_op(self) -> None:
        """Drop the hybridized graphs (a ``HybridBlock`` has some)."""

    def collect_params(self, select=None) -> ParameterDict:
        """This block's parameters and its children's, keyed by their
        prefixed names; with ``select``, those whose name matches it
        (``re.match``)."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pat = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pat.match(k)})
        for child in self._modules.values():
            if isinstance(child, Block):
                ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix="") -> dict:
        """Every parameter under its structural name, the key of a
        ``.params`` file: the attribute path (``encoder.cells.0.ln1.
        gamma``)."""
        if prefix:
            prefix += "."
        ret = {prefix + name: p for name, p in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def register_child(self, block, name=None):
        """Add ``block`` as a child named ``name`` (default: its index)."""
        self.add_module(name or str(len(self._modules)), block)
        return block

    def __call__(self, *args, **kwargs):
        # while some parameter lives on several contexts, the outermost
        # call picks its copy: the one on its first input's context
        if multi_context_live() and current_replica() is None:
            ctx, from_tensor = _input_context(args)
            if ctx is not None:
                with replica_scope(ctx, from_tensor):
                    return super().__call__(*args, **kwargs)
        return super().__call__(*args, **kwargs)

    def register_forward_pre_hook(self, hook, **kwargs) -> _HookHandle:
        """``hook(block, args)`` before each forward."""
        return _HookHandle(super().register_forward_pre_hook(hook,
                                                             **kwargs))

    def register_forward_hook(self, hook, **kwargs) -> _HookHandle:
        """``hook(block, args, output)`` after each forward."""
        return _HookHandle(super().register_forward_hook(hook, **kwargs))

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (``collect_params().initialize``)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        """Cast every parameter to ``dtype``."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.cast(dtype)
        for p in self._params.values():
            p.cast(dtype)
        return self

    def hybridize(self, active=True, **kwargs):
        """Hybridize every :class:`HybridBlock` below this block."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def summary(self, *inputs) -> str:
        """The output shape of every block of one forward of
        ``inputs``, as a table."""
        rows = []
        handles = []

        def add_hooks(blk, path):
            for name, child in blk._modules.items():
                if isinstance(child, Block):
                    add_hooks(child, f"{path}.{name}")
            handles.append(blk.register_forward_hook(
                lambda b, i, o, path=path: rows.append(
                    (path, type(b).__name__, getattr(
                        o[0] if isinstance(o, (list, tuple)) else o,
                        "shape", None)))))

        add_hooks(self, self._name)
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.detach()
        lines = [f"{'Layer':<40}{'Type':<25}{'Output shape'}"]
        lines += [f"{p:<40}{t:<25}{s}" for p, t, s in rows]
        return "\n".join(lines)

    # -- .params files ---------------------------------------------------
    def save_parameters(self, filename, deduplicate=False) -> None:
        """Write every parameter to a ``.params`` file under its
        structural name; with ``deduplicate``, a shared parameter once,
        under its first name."""
        from ..ndarray import serialization

        out, seen = {}, set()
        for name, p in self._collect_params_with_prefix().items():
            if deduplicate and id(p) in seen:
                continue
            seen.add(id(p))
            out[name] = p.data().as_in_context(cpu())
        serialization.save(filename, out)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current") -> None:
        """Set the parameters from a ``.params`` file written by either
        package's ``save_parameters``: in place, cast to each parameter's
        dtype; a parameter not yet initialized is allocated from the
        file's value on ``ctx`` (default: the context it was initialized
        for, else :func:`current_context`), and with ``cast_dtype`` and
        ``dtype_source="saved"`` a parameter takes the file's dtype.
        A missing name, an extra name or a shape that differs raises
        :class:`MXNetError` naming it."""
        from ..ndarray import serialization

        loaded = serialization.load(filename, ctx=cpu())
        if isinstance(loaded, list):
            raise MXNetError(f"{filename} holds a list, not a parameter dict")
        loaded = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                  for k, v in loaded.items()}
        params = self._collect_params_with_prefix()
        missing = [n for n in params if n not in loaded]
        if missing and not allow_missing:
            avail = sorted(loaded)
            shown = ", ".join(avail[:12]) + (
                f", ... ({len(avail) - 12} more)" if len(avail) > 12 else "")
            raise MXNetError(
                f"Parameter {missing[0]} missing in {filename} "
                f"(allow_missing=False). The file contains {len(avail)} "
                f"parameter(s): [{shown}]")
        for name, v in loaded.items():
            p = params.get(name)
            if p is None:
                if not ignore_extra:
                    raise MXNetError(f"{filename} contains extra parameter "
                                     f"{name} (ignore_extra=False)")
                continue
            if cast_dtype and dtype_source == "saved" \
                    and p.dtype != str(v._data.dtype).split(".")[-1]:
                p.cast(v._data.dtype)
            if p._var is None:
                # allocated from the file's value: nothing to draw first
                p.shape = tuple(v.shape)
                ctxs = (p._deferred_init[1] if ctx is None
                        and p._deferred_init is not None
                        else _contexts(ctx))
                p._deferred_init = None
                p._set_var(v._data.to(ctxs[0].torch_device(),
                                      torch_dtype(p.dtype)), ctxs)
                continue
            if tuple(v.shape) != tuple(p._var.shape):
                raise MXNetError(f"{filename}: {name} has shape "
                                 f"{tuple(v.shape)}, the parameter "
                                 f"{tuple(p._var.shape)}")
            p.set_data(v)

    def export(self, path, epoch=0):
        raise MXNetError("export needs the symbol API, not ported yet "
                         "(ROADMAP.md, port queue 1, item 12)")


# ---------------------------------------------------------------------------
# the CachedOp counterpart
# ---------------------------------------------------------------------------


def _flatten(out, flat):
    if isinstance(out, NDArray):
        flat.append(out)
        return ("leaf", len(flat) - 1)
    if isinstance(out, (list, tuple)):
        return ("seq", type(out) is tuple, [_flatten(o, flat) for o in out])
    raise MXNetError(f"a hybridized forward returned a {type(out)}, not "
                     "NDArrays")


def _unflatten(tree, flat):
    if tree[0] == "leaf":
        return flat[tree[1]]
    seq = [_unflatten(t, flat) for t in tree[2]]
    return tuple(seq) if tree[1] else seq


class _GraphState(threading.local):
    """How deep this thread is inside a graph's body: a hybridized child
    called there runs eagerly, into its parent's graph."""

    def __init__(self):
        super().__init__()
        self.depth = 0


_graph_state = _GraphState()


class _Captured:
    """One signature's graph: the static inputs it reads, its outputs and
    how far each launch counter moved while it was captured."""

    __slots__ = ("graph", "inputs", "outputs", "tree", "launches")


def _replay(captured: _Captured, owner, args):
    """Copy ``args`` into the graph's static inputs, replay it, move the
    launch counters by one replay, and hand out fresh NDArrays (copies
    of the static outputs)."""
    from ..kernels._build import replay_counts

    with torch.no_grad():
        for buf, a in zip(captured.inputs, args):
            if buf is not None:
                buf.copy_(a._data)
    captured.graph.replay()
    replay_counts(captured.launches)
    graph = owner()
    if graph is not None:
        graph.replays += 1
    return _unflatten(captured.tree, [NDArray(o.clone())
                                      for o in captured.outputs])


def _evicted(owner, key, entry) -> None:
    """A graph left its block's cache: drop it and its static tensors now
    (its share of the pool goes back to the pool), and the pool itself
    once no graph of the block is left."""
    entry.graph = entry.inputs = entry.outputs = None
    graph = owner()
    if graph is not None and not len(graph._cache):
        graph._pool = None


def _arg_avals(args) -> tuple:
    from ..compiler import keys

    return tuple(None if a is None else keys.aval(a._data) for a in args)


class _CachedGraph:
    """One ``torch.cuda.CUDAGraph`` per call signature of a hybridized
    block (the counterpart of the reference's ``_CachedGraph``,
    ``block.py:440-690``, and of MXNet's ``CachedOp``).

    The graphs live in the block's compilation-service site cache,
    ``SiteCache("cached_op")``, keyed by ``compiler.signature``: the
    inputs' shape, dtype, device and memory order (None where an
    optional input is left out), the parameters' shapes and dtypes, the
    platform and the routing knobs. Graphs serve predict mode only (a
    training-mode call runs eagerly), so the training flag is always off
    here. A signature's graph is captured at its first call (or by
    :meth:`HybridBlock.warmup`, or by ``compiler.warm_start`` from a
    manifest) over static input buffers, into the block's private memory
    pool, by ``kernels._build.capture_graph`` as the decode graphs are
    (a warm-up forward on a side stream, the cyclic GC off, the launch
    counters put back and moved per replay), and journaled to the
    signature manifest when one records. A failed capture raises
    :class:`MXNetError`; nothing runs eagerly in its place.

    Each entry is the signature's :class:`_Captured`; its key is the
    exact signature, and :meth:`HybridBlock.forward` sends every other
    call (under ``record()``, in training mode, on the CPU) to the eager
    forward before the lookup. A replay copies the inputs into the
    static buffers and hands out fresh NDArrays (copies of the static
    outputs). An evicted entry drops its graph and buffers at once. The parameters are read where they lie: an in-place
    update (``Trainer.step``) needs no recapture, while a parameter whose
    storage was replaced (``cast``, ``reset_ctx``, a deferred or
    reallocating load) clears every graph, and the pool with them.
    Holds its block, and its entries hold it, through weak references:
    no cycle, so no graph is ever freed by a cycle collection."""

    def __init__(self, block):
        from ..compiler.service import SiteCache

        self._block = weakref.ref(block)
        self._cache = SiteCache("cached_op", on_evict=functools.partial(
            _evicted, weakref.ref(self)))
        self._pool = None
        self._params = None
        self._vars = None
        self.captures = 0
        self.replays = 0

    def __deepcopy__(self, memo):
        return None                 # a copy of the block captures anew

    def clear(self) -> None:
        self._cache.clear()
        self._pool = None           # a pool whose graphs are gone is spent
        self._params = self._vars = None

    @property
    def _graphs(self) -> dict:
        """The captured graphs (:class:`_Captured`) by signature key, the
        least recently used first."""
        return dict(self._cache.items())

    def _param_state(self, block):
        if self._params is None:
            self._params = list(block.collect_params().values())
        return tuple(p._var for p in self._params)

    def _settled_vars(self, block, args) -> tuple:
        """The parameters' tensors, their shapes settled from ``args``;
        every graph is cleared when one was replaced since the last call."""
        vars_ = self._param_state(block)
        if any(v is None for v in vars_):
            block._infer_and_init(args)
            vars_ = self._param_state(block)
        if self._vars is None or any(
                a is not b for a, b in zip(vars_, self._vars)):
            if self._vars is not None:
                self.clear()
                vars_ = self._param_state(block)
            self._vars = vars_
        return vars_

    def _key(self, avals, vars_, device):
        from ..compiler import keys

        return keys.signature(
            "cached_op", id(self), avals=avals,
            extra=(tuple((tuple(v.shape), str(v.dtype)) for v in vars_),),
            platform=keys.platform(device))

    def __call__(self, args):
        block = self._block()
        vars_ = self._settled_vars(block, args)
        avals = _arg_avals(args)
        dev = next(a._data.device for a in args if a is not None)
        key = self._key(avals, vars_, dev)
        entry = self._cache.lookup(key)
        if entry is self._cache.MISS:
            entry = self._seat(block, args, key)
        return _replay(entry, weakref.ref(self), args)

    def _seat(self, block, args, key):
        """Capture ``args``' signature and keep it under ``key``."""
        from ..compiler import keys, manifest

        entry = self._capture(block, args)
        sig = key.avals
        self._cache.insert(key, entry)
        if manifest.recorder() is not None:
            manifest.record_signature("cached_op", {
                "graph": keys.graph_ident(block),
                "args": tuple(None if a is None else (a[0], a[1], a[3])
                              for a in sig),
                "training": False, "routing": key.routing}, key.platform)
        return entry

    def _capture(self, block, args) -> _Captured:
        from ..kernels._build import capture_graph

        dev = next(a._data.device for a in args if a is not None)
        inputs = [None if a is None else a._data.detach().clone()
                  for a in args]

        def body():
            nd_in = [None if t is None else NDArray(t) for t in inputs]
            _graph_state.depth += 1
            try:
                with autograd.pause():
                    return block._eager_forward(nd_in)
            finally:
                _graph_state.depth -= 1

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        entry = _Captured()
        try:
            entry.graph, out, entry.launches = capture_graph(
                body, dev, self._pool,
                f"{block.name}: capturing the hybridized graph of input "
                f"shapes {[None if a is None else a.shape for a in args]}")
        except MXNetError:
            if not len(self._cache):
                self._pool = None
            raise
        flat = []
        entry.tree = _flatten(out, flat)
        entry.outputs = [o._data for o in flat]
        entry.inputs = inputs
        self.captures += 1
        return entry


def warm_cached_op_spec(block, spec) -> str:
    """``compiler.warm_start``'s ``cached_op`` replay: capture one recorded
    input signature into ``block``'s graph cache over zero inputs on the
    card its parameters live on (hybridizing it first if it is not). A
    block on the CPU has no graphs: skipped."""
    from ..context import Context
    from ..ndarray import zeros

    if not isinstance(block, HybridBlock) or spec.get("training"):
        return "skipped"
    params = list(block.collect_params().values())
    dev = next((p._var.device for p in params if p._var is not None), None)
    if dev is None:
        ctxs = next((p._deferred_init[1] for p in params
                     if p._deferred_init is not None), None)
        dev = ctxs[0].torch_device() if ctxs else None
    if dev is None or dev.type != "cuda":
        return "skipped"
    if not block._active:
        block.hybridize()
    args = []
    for a in spec.get("args") or ():
        if a is None:
            args.append(None)
            continue
        shape, dtype, last = a
        x = zeros(tuple(shape), ctx=Context.from_device(dev), dtype=dtype)
        if last:
            x = NDArray(x._data.contiguous(
                memory_format=torch.channels_last))
        args.append(x)
    if not any(a is not None for a in args):
        return "skipped"
    graph = block._graph()
    with autograd.pause(), autograd.predict_mode():
        vars_ = graph._settled_vars(block, args)
        key = graph._key(_arg_avals(args), vars_, dev)
        if key in graph._cache:
            return "deduped"
        graph._seat(block, args, key)
    return "replayed"


# ---------------------------------------------------------------------------
# HybridBlock
# ---------------------------------------------------------------------------


class HybridBlock(Block):
    """A block whose computation is ``hybrid_forward(F, x, *args,
    **params)`` (see the module docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._cached_graph = None

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, forward_bulk_size=None,
                  backward_bulk_size=None, **kwargs):
        """Serve later NDArray calls on the card from CUDA graphs (see
        :class:`_CachedGraph`); every call clears the graphs. The
        CachedOp flags are kept for the API: a CUDA graph's memory is
        static by construction."""
        self._active = bool(active)
        self._flags = {"static_alloc": static_alloc,
                       "static_shape": static_shape}
        self._clear_cached_op()
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _clear_cached_op(self) -> None:
        if self._cached_graph is not None:
            self._cached_graph.clear()
        self._cached_graph = None

    @property
    def cached_graph(self):
        """The block's :class:`_CachedGraph` (its ``captures`` and
        ``replays`` counts), or None before the first graph call."""
        return self._cached_graph

    def warmup(self, input_shapes, dtype="float32", ctx=None) -> int:
        """Capture the graph of every signature in ``input_shapes`` (one
        shape tuple per input, or one tuple for a one-input block; a
        ``(shape, dtype)`` pair sets an input's dtype) over zero inputs
        on ``ctx``, ahead of the first request. Returns the number of
        graphs captured."""
        from ..ndarray import zeros

        if not self._active:
            raise MXNetError(f"{self.name}: warmup() requires hybridize()")
        before = self._graph().captures
        for spec in input_shapes:
            spec = [tuple(spec)] if spec and isinstance(spec[0], int) \
                else list(spec)
            args = []
            for item in spec:
                if len(item) == 2 and isinstance(item[0], (tuple, list)) \
                        and isinstance(item[1], str):
                    shape, dt = tuple(item[0]), item[1]
                else:
                    shape, dt = tuple(item), dtype
                args.append(zeros(shape, ctx=ctx, dtype=dt))
            with autograd.pause():
                self(*args)
        return self._graph().captures - before

    def _graph(self) -> _CachedGraph:
        if self._cached_graph is None:
            self._cached_graph = _CachedGraph(self)
        return self._cached_graph

    def cast(self, dtype):
        self._clear_cached_op()
        return super().cast(dtype)

    def infer_shape(self, *args) -> None:
        """Settle the deferred parameter shapes from sample inputs."""
        self._infer_and_init(args)

    def _infer_and_init(self, args) -> None:
        with autograd.pause():
            self._eager_forward(list(args))

    def forward(self, *args):
        if _is_nd(args):
            if self._active and not autograd.is_recording() \
                    and not autograd.is_training() \
                    and not _graph_state.depth \
                    and next(a for a in args if a is not None
                             ).context.device_type == "gpu":
                return self._graph()(list(args))
            return self._eager_forward(list(args))
        return self._eager_forward(list(args), nd=False)

    def _param_values(self, nd: bool) -> dict:
        if nd:
            return {name: p.data() for name, p in self._reg_params.items()}
        return {name: p.tensor for name, p in self._reg_params.items()}

    def _eager_forward(self, args, nd=True):
        """``hybrid_forward`` on NDArrays (``F`` = ``mx.nd``) or tensors
        (``F`` = :data:`tensor_ops`), settling deferred shapes first."""
        from .. import ndarray as F_nd

        while args and args[-1] is None:
            args = args[:-1]
        try:
            params = self._param_values(nd)
        except DeferredInitializationError:
            self._infer_param_shapes(*args)
            params = self._param_values(nd)
        return self.hybrid_forward(F_nd if nd else tensor_ops, *args,
                                   **params)

    def _infer_param_shapes(self, *args) -> None:
        """Finish the deferred parameters from the inputs' shapes (layers
        with deferred parameters override it)."""
        raise DeferredInitializationError(
            f"{self.name}: parameter shapes are unknown and "
            f"{type(self).__name__} does not implement shape inference; "
            "initialize with explicit shapes")

    def hybrid_forward(self, F, x, *args, **params):
        raise NotImplementedError

    def optimize_for(self, x, backend=None, **kwargs):
        raise MXNetError("optimize_for needs the symbol API, not ported yet "
                         "(ROADMAP.md, port queue 1, item 12)")


class SymbolBlock(HybridBlock):
    """A symbolic graph as a block: needs the symbol API (ROADMAP.md, port
    queue 1, item 12)."""

    def __init__(self, outputs=None, inputs=None, params=None):
        raise MXNetError("SymbolBlock needs the symbol API, not ported yet "
                         "(ROADMAP.md, port queue 1, item 12)")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        raise MXNetError("SymbolBlock.imports needs the symbol API, not "
                         "ported yet (ROADMAP.md, port queue 1, item 12)")
