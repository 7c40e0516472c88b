"""The port's random state: per-device streams of u32 dropout seeds.

Counterpart of ``mxnet_tpu/random_state.py``. The reference keeps one
splittable JAX key per device and splits a subkey off it for every
random op; inside a traced step, ``scoped_key`` installs the step's key
and every op splits its own off that one, in call order. The port's
only random consumers are the position-hash dropout sites, which take
one u32 seed each, so a stream here hands out seeds:

* eager mode: :func:`next_seed` draws from the device's stream, a CPU
  ``torch.Generator`` seeded from the base seed folded with the device
  (crc32 of its name, as the reference folds its device signature);
* inside :func:`scoped_seed` (what ``parallel.TrainStep`` installs
  around one step), the k-th draw is ``hash_u32(k, step_seed)``: a
  fixed function of the draw's position and the step's seed, in call
  order, as ``scoped_key``'s splits are.

Seeds are Python ints handed to the kernels by value: no device tensor
and no host synchronisation. The state is per thread, as the
reference's is.

A rematerialised span (``gluon.block.remat_call``) runs its forward
twice, once in the forward and once in the backward's recompute; both
runs must draw the same seeds, or the recompute's dropout masks differ
from the forward's. :func:`seed_tape` records the seeds a span draws and
:func:`replay_seeds` hands them out again, in order. The reference needs
nothing of the kind: its keys are values in the traced program.
"""
from __future__ import annotations

import contextlib
import threading
import zlib

import torch

from .context import Context
from .kernels.dropout import hash_u32

__all__ = ["seed", "next_seed", "next_init_seed", "scoped_seed",
           "preserved_stream", "checkpoint_state",
           "restore_checkpoint_state", "seed_tape", "replay_seeds"]

_state = threading.local()
_DEFAULT_SEED = 0


def _global():
    if not hasattr(_state, "streams"):
        _state.streams = {}          # device name -> torch.Generator (CPU)
        _state.base_seed = _DEFAULT_SEED
        _state.scoped = []           # [step_seed, draws so far] frames
        _state.tapes = []            # seed lists being recorded
        _state.replays = []          # [seeds, next position] frames
    return _state


def _sig(device) -> str:
    if isinstance(device, Context):
        device = device.torch_device()
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return str(dev)


def _stream(st, sig: str) -> torch.Generator:
    gen = st.streams.get(sig)
    if gen is None:
        fold = zlib.crc32(sig.encode()) & 0x7FFFFFFF
        gen = torch.Generator().manual_seed(
            (int(st.base_seed) * 0x9E3779B1 + fold) & 0xFFFFFFFFFFFF)
        st.streams[sig] = gen
    return gen


def seed(seed_state: int, ctx="all") -> None:
    """Seed the streams (``mx.random.seed(seed, ctx)``): ``ctx="all"``
    reseeds every device's stream from ``seed_state``; a device reseeds
    that device's stream alone."""
    st = _global()
    if isinstance(ctx, str) and ctx == "all":
        st.base_seed = int(seed_state)
        st.streams = {}
    else:
        st.streams[_sig(ctx)] = torch.Generator().manual_seed(
            int(seed_state))


def next_seed(device=None) -> int:
    """A fresh u32 seed: inside :func:`scoped_seed`, the next of the
    scope's draws; otherwise a draw from ``device``'s stream (the CPU's
    when None)."""
    st = _global()
    if st.replays:
        frame = st.replays[-1]
        s = frame[0][frame[1]]
        frame[1] += 1
    elif st.scoped:
        frame = st.scoped[-1]
        k = frame[1]
        frame[1] = k + 1
        s = hash_u32(k, frame[0])
    else:
        gen = _stream(st, _sig(device))
        s = int(torch.randint(0, 2 ** 32, (1,), generator=gen,
                              dtype=torch.int64))
    for tape in st.tapes:
        tape.append(s)
    return s


def next_init_seed() -> int:
    """A fresh seed for an initializer's draws, from a stream of its own
    (the reference draws initial weights from its host generator, apart
    from the random ops' keys), so initializing a model does not move any
    device's sequence of dropout seeds; ``seed(n)`` resets it too."""
    gen = _stream(_global(), "init")
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=gen,
                             dtype=torch.int64))


@contextlib.contextmanager
def scoped_seed(step_seed: int):
    """Within the scope, the k-th :func:`next_seed` (counted from 0) is
    ``hash_u32(k, step_seed)``; scopes nest, the innermost serving."""
    st = _global()
    st.scoped.append([int(step_seed) & 0xFFFFFFFF, 0])
    try:
        yield
    finally:
        st.scoped.pop()


@contextlib.contextmanager
def seed_tape():
    """Record every :func:`next_seed` drawn inside the scope into the
    list it yields (tapes nest: each records the draws of its scope)."""
    st = _global()
    tape = []
    st.tapes.append(tape)
    try:
        yield tape
    finally:
        st.tapes.remove(tape)


@contextlib.contextmanager
def replay_seeds(tape):
    """Inside the scope, :func:`next_seed` hands out ``tape``'s seeds
    again, in order, whatever stream or scope is active."""
    st = _global()
    st.replays.append([list(tape), 0])
    try:
        yield
    finally:
        st.replays.pop()


@contextlib.contextmanager
def preserved_stream():
    """Snapshot every device stream and restore it on exit, so that a
    probe does not advance the program's sequence of seeds."""
    st = _global()
    saved = {sig: gen.get_state() for sig, gen in st.streams.items()}
    try:
        yield
    finally:
        streams = {}
        for sig, state in saved.items():
            gen = torch.Generator()
            gen.set_state(state)
            streams[sig] = gen
        st.streams = streams


def checkpoint_state() -> dict:
    """A picklable snapshot of the calling thread's streams, for a
    checkpoint bundle's ``rng.pkl``: the reference's layout (``version``,
    ``base_seed``, ``keys``, ``host_rng``) with the port's streams under
    ``torch_streams`` (each a CPU generator's state as uint8 numpy).
    ``keys`` stays empty: the port holds no JAX keys, so the reference
    restoring this snapshot keeps the base seed and derives its keys
    afresh."""
    import numpy as np

    st = _global()
    return {"version": 1, "base_seed": st.base_seed, "keys": {},
            "host_rng": None,
            "torch_streams": {sig: np.asarray(gen.get_state().numpy())
                              for sig, gen in st.streams.items()}}


def restore_checkpoint_state(state: dict) -> None:
    """Restore :func:`checkpoint_state`'s snapshot into the calling
    thread's streams. A snapshot the reference wrote (JAX keys, no
    ``torch_streams``) restores its base seed alone: its keys have no
    meaning here, and the streams restart from that seed."""
    st = _global()
    st.base_seed = int(state["base_seed"])
    streams = {}
    for sig, raw in (state.get("torch_streams") or {}).items():
        gen = torch.Generator()
        gen.set_state(torch.from_numpy(raw.copy()))
        streams[sig] = gen
    st.streams = streams
