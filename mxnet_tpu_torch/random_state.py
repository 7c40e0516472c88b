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
"""
from __future__ import annotations

import contextlib
import threading
import zlib

import torch

from .kernels.dropout import hash_u32

__all__ = ["seed", "next_seed", "scoped_seed", "preserved_stream"]

_state = threading.local()
_DEFAULT_SEED = 0


def _global():
    if not hasattr(_state, "streams"):
        _state.streams = {}          # device name -> torch.Generator (CPU)
        _state.base_seed = _DEFAULT_SEED
        _state.scoped = []           # [step_seed, draws so far] frames
    return _state


def _sig(device) -> str:
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
    if st.scoped:
        frame = st.scoped[-1]
        k = frame[1]
        frame[1] = k + 1
        return hash_u32(k, frame[0])
    gen = _stream(st, _sig(device))
    return int(torch.randint(0, 2 ** 32, (1,), generator=gen,
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
