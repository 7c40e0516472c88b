"""The training flag of ``mx.autograd`` (counterpart of the state part of
``mxnet_tpu/autograd.py:59-116``).

``is_training``, ``set_training``, ``train_mode`` and ``predict_mode``
decide whether the dropout sites drop: ``parallel.TrainStep`` runs its
forward and backward under :func:`train_mode`, ``serving.Server`` runs
every forward under :func:`predict_mode`. The flag is per thread and
starts off, as the reference's does. The tape (``record``, ``pause``,
``backward``, ``grad``, ``mark_variables``, ``Function``) waits for the
autograd slice (ROADMAP.md, port queue 1, item 5); until then torch's
own autograd records the gradients.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["is_training", "set_training", "train_mode", "predict_mode"]

_state = threading.local()


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_training(train: bool) -> bool:
    """Set the flag; returns its previous value."""
    prev = is_training()
    _state.training = bool(train)
    return prev


@contextlib.contextmanager
def _training_scope(train: bool):
    prev = set_training(train)
    try:
        yield
    finally:
        set_training(prev)


def train_mode():
    """A scope in which the dropout sites drop."""
    return _training_scope(True)


def predict_mode():
    """A scope in which every dropout site is the identity."""
    return _training_scope(False)
