"""``mx.random`` of the port (counterpart of ``mxnet_tpu/random.py``):
``seed`` for now; the sampling functions come with the NDArray slice
(ROADMAP.md, port queue 1, item 4)."""
from .random_state import seed

__all__ = ["seed"]
