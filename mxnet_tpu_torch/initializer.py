"""Weight initializers of the port (``mx.init``, ``mx.initializer``).

Counterpart of ``mxnet_tpu/initializer.py:27-308``: the registry
(``register``/``create``), :class:`InitDesc`, and :class:`Initializer`
with its name-pattern dispatch (``weight``, ``bias``, ``gamma``,
``beta`` and the running statistics), then ``Uniform``, ``Normal``,
``Zero``, ``One``, ``Constant``, ``Xavier`` (``rnd_type`` uniform or
gaussian, ``factor_type`` avg, in or out), ``MSRAPrelu``,
``Orthogonal``, ``Bilinear``, ``LSTMBias``, ``Mixed`` and ``Load``.

An initializer fills an NDArray in place (``arr[:] = ...``). Random
draws come from a ``torch.Generator`` on the array's device, seeded from
:func:`mxnet_tpu_torch.random_state.next_init_seed` (so ``mx.random.seed``
fixes them, and the dropout seeds do not move), or, inside
:func:`generator_scope`, from the generator it names (how the model zoo's ``generator=`` argument reaches the draws).
They are drawn in float32 and cast on assignment, as the reference
draws on the host in float32. They are not the reference's draws: the
streams differ, the distributions and the fan arithmetic are the same.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import threading

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "Mixed", "Load", "register", "create", "InitDesc",
           "generator_scope"]

_REGISTRY = {}
_local = threading.local()


def register(klass):
    """Register an initializer class under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from an instance (returned as is), None
    (``Uniform()``) or a registered name (``"zeros"``, ``"xavier"``...)."""
    if isinstance(name, (Initializer, Load)):
        return name
    if name is None:
        return Uniform()
    key = str(name).lower()
    key = {"zeros": "zero", "ones": "one"}.get(key, key)
    if key not in _REGISTRY:
        raise MXNetError(f"unknown initializer {name!r}")
    return _REGISTRY[key](**kwargs)


@contextlib.contextmanager
def generator_scope(generator):
    """Inside the scope every random draw of an initializer comes from
    ``generator`` (a ``torch.Generator`` on the arrays' device), in the
    order the parameters are initialized; None leaves the default."""
    prev = getattr(_local, "generator", None)
    _local.generator = generator
    try:
        yield
    finally:
        _local.generator = prev


def _generator(device) -> torch.Generator:
    gen = getattr(_local, "generator", None)
    if gen is not None:
        return gen
    from .random_state import next_init_seed

    return torch.Generator(device=device).manual_seed(next_init_seed())


def _nd(t: torch.Tensor):
    from .ndarray import NDArray

    return NDArray(t)


class InitDesc(str):
    """A parameter's name, with ``attrs`` and the ``global_init``
    (reference: ``InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base of the initializers: ``init(desc, arr)`` fills the NDArray
    ``arr`` by the pattern of the name ``desc``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr) -> None:
        if not isinstance(desc, str):
            raise TypeError("desc must be a string/InitDesc")
        init_name = getattr(desc, "attrs", {}).get("__init__", "")
        if init_name:
            klass, kwargs = json.loads(init_name)
            create(klass, **kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith(("running_mean", "moving_mean")):
            self._init_zero(desc, arr)
        elif name.endswith(("running_var", "moving_var")):
            self._init_one(desc, arr)
        elif name.endswith(("moving_inv_var", "moving_avg")):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_bias(self, name, arr):
        arr[:] = 0.0

    def _init_gamma(self, name, arr):
        arr[:] = 1.0

    def _init_beta(self, name, arr):
        arr[:] = 0.0

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def __repr__(self):
        return f"{self.__class__.__name__}({self._kwargs})"

    @staticmethod
    def _draw(arr, shape=None) -> torch.Tensor:
        """An empty float32 tensor of ``shape`` (default: arr's) on arr's
        device, and the generator to fill it from."""
        dev = arr.context.torch_device()
        t = torch.empty(tuple(arr.shape if shape is None else shape),
                        dtype=torch.float32, device=dev)
        return t, _generator(dev)

    def _uniform(self, arr, low, high, shape=None):
        t, gen = self._draw(arr, shape)
        return _nd(t.uniform_(low, high, generator=gen))

    def _normal(self, arr, sigma, shape=None):
        t, gen = self._draw(arr, shape)
        return _nd(t.normal_(0.0, sigma, generator=gen))


@register
class Uniform(Initializer):
    """Weights uniform in [-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr[:] = self._uniform(arr, -self.scale, self.scale)


@register
class Normal(Initializer):
    """Weights from N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr[:] = self._normal(arr, self.sigma)


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    """Weights set to ``value`` (a number, an array or an NDArray,
    broadcast)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        v = self.value
        arr[:] = v.asnumpy() if hasattr(v, "asnumpy") else v


@register
class Xavier(Initializer):
    """Fan-scaled weights: ``scale = sqrt(magnitude / factor)`` with the
    factor the mean of the fans (``avg``), fan in or fan out, the fans
    counting the trailing (kernel) axes; uniform in [-scale, scale) or
    N(0, scale^2) by ``rnd_type``."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim>=2, got shape {shape} "
                             f"for {name}")
        hw_scale = float(_np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factors = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                   "out": fan_out}
        if self.factor_type not in factors:
            raise MXNetError(f"unknown factor_type {self.factor_type}")
        scale = math.sqrt(self.magnitude / factors[self.factor_type])
        if self.rnd_type == "uniform":
            arr[:] = self._uniform(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            arr[:] = self._normal(arr, scale)
        else:
            raise MXNetError(f"unknown rnd_type {self.rnd_type}")


@register
class MSRAPrelu(Xavier):
    """He initialization for PReLU nets: gaussian Xavier with magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of an SVD of a uniform
    (-1, 1) or standard normal (``rand_type``) draw, shaped (out, rest)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self._uniform(arr, -1.0, 1.0, (nout, nin))
        else:
            tmp = self._normal(arr, 1.0, (nout, nin))
        tmp = tmp.asnumpy().astype("float64")
        u, _, v = _np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape).astype("float32")


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel (for a deconvolution)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        weight = _np.zeros(shape, dtype="float32")
        f = _np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(_np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter set to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = _np.zeros(arr.shape, dtype="float32")
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = b

    _init_default = _init_weight
    _init_bias = _init_weight


@register
class Mixed(Initializer):
    """The first initializer whose pattern (``re.match``) matches the
    name; a name no pattern matches raises."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed: one initializer per pattern")
        self.map = [(re.compile(p), i) for p, i in zip(patterns,
                                                       initializers)]

    def __call__(self, name, arr):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr)
                return
        raise MXNetError(f"parameter {name} did not match any Mixed pattern")


class Load:
    """Values from a saved dict (or a ``.params`` file): a name found
    there takes its value, any other goes to ``default_init`` (or
    raises when there is none)."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .context import cpu
            from .ndarray import serialization

            param = serialization.load(param, ctx=cpu())
        if not isinstance(param, dict):
            raise TypeError(
                "Load: expected a dict of name -> NDArray (a .params file "
                "saved with names), got " + type(param).__name__)
        self.param = {(k[4:] if k.startswith(("arg:", "aux:")) else k): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, desc, arr):
        name = str(desc)
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise ValueError(
                    f"Load: parameter {name!r} has shape {src.shape} in the "
                    f"file but {arr.shape} is requested")
            arr[:] = src.asnumpy() if hasattr(src, "asnumpy") else src
            if self.verbose:
                print(f"Initialized {name} by loading")
        else:
            if self.default_init is None:
                raise ValueError(
                    f"Load: cannot initialize {name!r}: not found in the "
                    "loaded file and no default_init is given")
            self.default_init(desc, arr)
