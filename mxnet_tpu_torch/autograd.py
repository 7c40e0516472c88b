"""``mx.autograd`` of the port: the recording and training flags and
``backward`` (counterpart of ``mxnet_tpu/autograd.py:48-116`` and
``:260-273``).

``is_training``, ``set_training``, ``train_mode`` and ``predict_mode``
decide whether the dropout sites drop: ``parallel.TrainStep`` runs its
forward and backward under :func:`train_mode`, ``serving.Server`` runs
every forward under :func:`predict_mode`. ``record()`` and ``pause()``
set the recording flag beside it and turn torch's grad mode on and off;
torch's autograd is the tape. Both flags are per thread and start off, as
the reference's do.

Recording differs from the reference's in one way, by design: torch
records whenever its grad mode is on and an input requires a gradient,
so a forward outside ``record()`` under torch's default grad mode is
recorded too (it keeps its saved activations while its output lives),
and :func:`backward` differentiates it. A head computed under
``pause()`` or ``torch.no_grad()`` is not on the tape, and ``backward``
raises for it as the reference does (``autograd.py:466-472``).

Heads and leaves may be ``mx.nd`` NDArrays (``NDArray.attach_grad``
makes a leaf, ``NDArray.backward`` calls :func:`backward`). An NDArray
op under ``record()`` runs inside :func:`saved_tensor_hooks`, which
registers every tensor its graph saves, so that a write to that storage
while the graph lives can be caught at the write (:func:`holds_live_save`,
the reference's write-after-record rule, ``autograd.py:8-13``) instead of
at ``backward``.

:func:`mark_variables` attaches given gradient buffers to NDArrays,
:func:`grad` returns the gradients of heads as new NDArrays (to any
order with ``create_graph``: the gradient is itself on the tape), and
:class:`Function` runs a user's ``forward``/``backward`` on NDArrays as a
``torch.autograd.Function``. :func:`watch_grad_ready` registers a
callback fired inside :func:`backward` the moment a watched array's
gradient buffer is written, with the rest of the reverse sweep still to
run (reference ``autograd.py:191-227``): the overlapped-comms ``Trainer``
exchanges a gradient bucket from it.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["is_training", "set_training", "train_mode", "predict_mode",
           "is_recording", "set_recording", "record", "pause", "backward",
           "is_on_tape", "saved_tensor_hooks", "holds_live_save",
           "mark_variables", "grad", "Function", "watch_grad_ready",
           "unwatch_grad_ready", "backward_sweep_seq"]

_state = threading.local()


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_training(train: bool) -> bool:
    """Set the flag; returns its previous value."""
    prev = is_training()
    _state.training = bool(train)
    return prev


def is_recording() -> bool:
    return getattr(_state, "recording", False)


def set_recording(is_record: bool) -> bool:
    """Set the recording flag; returns its previous value."""
    prev = is_recording()
    _state.recording = bool(is_record)
    return prev


@contextlib.contextmanager
def _scope(record, train):
    """Set the recording flag (with torch's grad mode) and the training
    flag where they are not None; restore both on exit."""
    prev_rec = set_recording(record) if record is not None else None
    prev_train = set_training(train) if train is not None else None
    try:
        if record is None:
            yield
        else:
            with torch.set_grad_enabled(record):
                yield
    finally:
        if record is not None:
            set_recording(prev_rec)
        if train is not None:
            set_training(prev_train)


def record(train_mode: bool = True):
    """A scope that records the operations for :func:`backward` (torch's
    grad mode on), in training mode unless ``train_mode`` is False."""
    return _scope(True, train_mode)


def pause(train_mode: bool = False):
    """A scope that records nothing (torch's grad mode off), in predict
    mode unless ``train_mode`` is True."""
    return _scope(False, train_mode)


def train_mode():
    """A scope in which the dropout sites drop."""
    return _scope(None, True)


def predict_mode():
    """A scope in which every dropout site is the identity."""
    return _scope(None, False)


def _leaves(heads) -> list:
    """The leaf tensors that require a gradient and that the heads'
    graph reaches, each once, found by one walk of the graph."""
    # ``seen`` holds every visited node's Python object: torch makes one
    # for a graph node on demand and may free it once unreferenced, and
    # a freed object's id can then come back for another node
    seen, leaves, stack = {}, [], []
    for h in heads:
        if h.grad_fn is not None:
            stack.append(h.grad_fn)
        elif h.requires_grad:
            leaves.append(h)
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen[id(fn)] = fn
        var = getattr(fn, "variable", None)     # an AccumulateGrad node
        if var is not None:
            leaves.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    return list({id(v): v for v in leaves}.values())


def is_on_tape(arr) -> bool:
    """Whether ``arr`` (an NDArray or a tensor) takes part in a recorded
    graph: a leaf with a gradient attached, or the output of a recorded
    op (reference: ``autograd.py:150``)."""
    t = getattr(arr, "_data", arr)
    return bool(getattr(t, "requires_grad", False))


# storage address -> how many tensors on it live graphs hold saved
_saves = {}
_saves_lock = threading.RLock()     # __del__ may run inside a locked scope


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Saved:
    """What a graph keeps of a saved tensor: the tensor (detached: it
    shares storage and version counter) and its version when saved. The
    handle lives exactly as long as the graph does, and counts itself in
    ``_saves`` meanwhile."""

    __slots__ = ("t", "version", "key")

    def __init__(self, t: torch.Tensor):
        self.t = t.detach()
        self.version = t._version
        self.key = _key(t)
        with _saves_lock:
            _saves[self.key] = _saves.get(self.key, 0) + 1

    def __del__(self):
        with _saves_lock:
            n = _saves.pop(self.key, 0) - 1
            if n > 0:
                _saves[self.key] = n


def _unpack(h: _Saved) -> torch.Tensor:
    # the version check torch itself skips for a tensor saved through hooks
    if h.t._version != h.version:
        raise MXNetError(
            "a tensor saved for backward was modified in place after it "
            "was recorded; write through an NDArray outside record() (which "
            "copies on write) or record the computation again")
    return h.t


def saved_tensor_hooks():
    """The scope in which the tensors a graph saves are registered for
    :func:`holds_live_save`."""
    return torch.autograd.graph.saved_tensors_hooks(_Saved, _unpack)


def holds_live_save(t: torch.Tensor) -> bool:
    """Whether a live graph recorded under :func:`saved_tensor_hooks`
    saved a tensor on ``t``'s storage."""
    return _key(t) in _saves


# id(tensor) -> (weakref to the tensor, weakref to the watched array,
# callback reference). A bound-method callback is held weakly (its owner
# may go away), a plain function strongly (it is the registration); dead
# entries are pruned at the start of every watched sweep, and the tensor
# identity is checked on fire (an id can be reused).
_GRAD_READY_WATCH = {}
# id of the running (or last) watched backward sweep: a consumer with
# per-sweep state tells a new sweep from the one that raised midway
_BACKWARD_SEQ = 0


def backward_sweep_seq() -> int:
    """The current watched-backward sweep id."""
    return _BACKWARD_SEQ


def watch_grad_ready(arrays, callback) -> None:
    """Call ``callback(array)`` when the gradient buffer of ``array`` (an
    NDArray over a leaf, such as a parameter's ``list_data()``) is
    written during :func:`backward`, while the reverse sweep still runs:
    the buffer is written from a hook on the leaf as soon as autograd
    has summed its gradient, instead of after the sweep. A bound-method
    callback keeps only a weak reference to its owner. Nothing fires for
    :func:`grad` (its gradients are new arrays, not buffer writes)."""
    try:
        cb_ref = weakref.WeakMethod(callback)
    except TypeError:
        cb_ref = lambda _cb=callback: _cb   # noqa: E731
    for a in arrays:
        t = a._data
        _GRAD_READY_WATCH[id(t)] = (weakref.ref(t), weakref.ref(a), cb_ref)


def unwatch_grad_ready(arrays) -> None:
    for a in arrays:
        _GRAD_READY_WATCH.pop(id(a._data), None)


def _write_grad(var, g) -> None:
    """``var``'s gradient ``g`` into its buffer by its ``grad_req`` (the
    caller turns the tape off)."""
    if var.grad is None:
        var.grad = torch.zeros_like(var)
    if getattr(var, "_mx_grad_req", "write") == "add":
        var.grad.add_(g)
    else:
        var.grad.copy_(g)


def _watch_hooks(leaves, written) -> list:
    """Hooks on the watched ``leaves``: each writes its leaf's buffer and
    fires the callback; ``written`` collects the leaves done so. Returns
    the hook handles."""
    global _BACKWARD_SEQ
    for k, (tref, aref, cref) in list(_GRAD_READY_WATCH.items()):
        if tref() is None or aref() is None or cref() is None:
            _GRAD_READY_WATCH.pop(k, None)
    hooked = [v for v in leaves if id(v) in _GRAD_READY_WATCH
              and _GRAD_READY_WATCH[id(v)][0]() is v]
    if not hooked:
        return []
    _BACKWARD_SEQ += 1
    return [v.register_hook(_make_hook(v, written)) for v in hooked]


def _make_hook(var, written):
    _, aref, cref = _GRAD_READY_WATCH[id(var)]

    def hook(g):
        with torch.no_grad():
            _write_grad(var, g)
        written.add(id(var))
        arr, cb = aref(), cref()
        if arr is not None and cb is not None:
            cb(arr)

    return hook


def _tensors(xs) -> list:
    return [getattr(x, "_data", x) for x in xs]


def backward(heads, head_grads=None, retain_graph: bool = False) -> None:
    """Differentiate ``heads`` (a tensor or an NDArray, or a list of
    them) and write each reached parameter's gradient into its ``.grad``
    by its ``grad_req`` (reference: ``autograd.backward``): ``"write"``
    (the default for a tensor that requires a gradient) overwrites,
    ``"add"`` accumulates; a parameter with ``grad_req="null"`` requires
    no gradient and never gets one, and one the heads do not reach keeps
    what it holds.
    ``head_grads`` default to ones, MXNet's head gradient, so a vector
    head is differentiated as its sum. Raises :class:`MXNetError` for a
    head that is not on the tape (computed under :func:`pause` or
    ``torch.no_grad()``)."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    heads = _tensors(heads)
    head_grads = [None] * len(heads) if head_grads is None \
        else _tensors(head_grads)
    for h in heads:
        if not h.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that is not on the tape; "
                "compute it inside autograd.record() from parameters that "
                "require a gradient")
    leaves = _leaves(heads)
    hgs = [torch.ones_like(h) if hg is None else hg
           for h, hg in zip(heads, head_grads)]
    written = set()
    handles = _watch_hooks(leaves, written) if _GRAD_READY_WATCH else []
    try:
        grads = torch.autograd.grad(heads, leaves, hgs,
                                    retain_graph=retain_graph,
                                    allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    with torch.no_grad():
        for var, g in zip(leaves, grads):
            if g is not None and id(var) not in written:
                _write_grad(var, g)


def _nd(t):
    from .ndarray import NDArray

    return NDArray(t)


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make each NDArray of ``variables`` a leaf of the tape whose
    gradient goes into the NDArray of ``gradients`` beside it (the same
    storage), by ``grad_reqs`` (one for all, or one each)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        t = v._data
        if not t.is_leaf:
            t = v._tensor = t.detach()
        t.requires_grad_(req != "null")
        t._mx_grad_req = req
        t.grad = None if req == "null" else g._data


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """The gradients of ``heads`` with respect to ``variables`` (an
    NDArray or a list), as new NDArrays; the variables' own gradient
    buffers are left alone. With ``create_graph`` the gradients are on
    the tape, so they can be differentiated again; ``retain_graph``
    defaults to ``create_graph``. A variable the heads do not reach
    raises :class:`MXNetError`."""
    single = not isinstance(variables, (list, tuple))
    if single:
        variables = [variables]
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    hs = _tensors(heads)
    for h in hs:
        if not h.requires_grad:
            raise MXNetError(
                "cannot differentiate a head that is not on the tape; "
                "compute it inside autograd.record() from arrays with "
                "attach_grad()")
    hgs = [torch.ones_like(h) if hg is None else hg for h, hg in
           zip(hs, [None] * len(hs) if head_grads is None
               else _tensors(head_grads))]
    if retain_graph is None:
        retain_graph = create_graph
    with torch.set_grad_enabled(create_graph):
        gs = torch.autograd.grad(hs, _tensors(variables), hgs,
                                 retain_graph=retain_graph,
                                 create_graph=create_graph,
                                 allow_unused=True)
    if any(g is None for g in gs):
        raise MXNetError("cannot differentiate: one of the requested "
                         "variables is not part of the recorded graph")
    out = [_nd(g) for g in gs]
    return out[0] if single else out


class Function:
    """A user-defined differentiable function: subclass it with
    ``forward(*inputs)`` and ``backward(*output_grads)`` on NDArrays (both
    run outside the tape; ``save_for_backward`` keeps what backward
    needs) and call an instance on NDArrays. Under ``record()`` the call
    is one node of the tape, a ``torch.autograd.Function`` whose backward
    is the user's, itself recorded when the gradient is asked for with
    ``create_graph``."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args) -> None:
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        if not is_recording():
            with pause(train_mode=is_training()):
                return self.forward(*inputs)
        user = self
        single = []

        class _Node(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                with pause(train_mode=is_training()):
                    outs = user.forward(*[_nd(t) for t in tensors])
                single.append(not isinstance(outs, (list, tuple)))
                outs = [outs] if single[0] else list(outs)
                return tuple(o._data.clone() for o in outs)

            @staticmethod
            def backward(ctx, *cts):
                # recorded under create_graph, so the gradient stays on
                # the tape
                with _scope(torch.is_grad_enabled(), None):
                    gs = user.backward(*[_nd(c) for c in cts])
                if not isinstance(gs, (list, tuple)):
                    gs = [gs]
                return tuple(None if g is None else g._data for g in gs)

        outs = _Node.apply(*_tensors(inputs))
        outs = [_nd(o) for o in outs]
        return outs[0] if single[0] else outs
