"""``mx.init``: the initializer namespace under its short name
(counterpart of ``mxnet_tpu/init.py``)."""
from .initializer import *  # noqa: F401,F403
from .initializer import Initializer, create, register  # noqa: F401
