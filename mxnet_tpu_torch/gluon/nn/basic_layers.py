"""Basic layers of the port.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py:19-404``:
``Sequential``, ``HybridSequential``, ``Dense``, ``Dropout``,
``BatchNorm``, ``LayerNorm``, ``InstanceNorm``, ``GroupNorm``,
``Embedding``, ``Flatten``, ``Identity``, ``Lambda`` and
``HybridLambda``, with the reference's constructor arguments: an
``in_units``/``in_channels`` of 0 is settled by the first forward
(deferred initialization), the initializers, ``dtype``, ``prefix`` and
``params``. ``LayerNorm`` takes a ``dtype`` as well (the port's model zoo
builds its models in one dtype).

The ops are the registered ones (``F.FullyConnected``, ``F.LayerNorm``,
...), so a CUDA input reaches the port's kernels whether it comes as an
NDArray or as a tensor: ``Dense(activation="gelu")`` with a bias runs the
product without its bias and then the fused bias+GELU kernel (reference
``:110-122``), ``LayerNorm`` the fused LayerNorm kernel, ``Dropout`` the
position-hash dropout kernel (in training mode only).
"""
from __future__ import annotations

import torch

from ... import autograd
from ..block import Block, HybridBlock, _raw, is_recomputing

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "Identity"]


class _Stack:
    """``add``, ``len``, iteration and indexing (a slice gives a new
    container of the same blocks) of the sequential containers."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())
        if isinstance(key, slice):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers[key])
            return net
        return layers[key]

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """Blocks applied in the order :meth:`add` received them."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """Hybrid blocks applied in the order :meth:`add` received them."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        for block in self._modules.values():
            x = block(x)
        return x


def _make_activation(activation, parent):
    if activation is None:
        return None
    from .activations import Activation

    with parent.name_scope():
        act = Activation(activation)
    parent.register_child(act, "act")
    return act


class Dense(HybridBlock):
    """``act(x @ weight.T + bias)``, weight (units, in_units); ``flatten``
    folds every input axis after the first (else the product is over the
    last axis)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._in_units = in_units
        self._flatten = flatten
        self._activation = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype)
            else:
                self.bias = None
            self.act = _make_activation(activation, self)

    def _infer_param_shapes(self, x, *rest):
        in_units = 1
        if self._flatten:
            for d in x.shape[1:]:
                in_units *= d
        else:
            in_units = x.shape[-1]
        self.weight._finish_deferred_init((self._units, in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is not None and self._activation == "gelu":
            out = F.FullyConnected(x, weight, None, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
            return F._contrib_fused_bias_gelu(out, bias)
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out

    def extra_repr(self):
        return (f"{self._units}, in_units={self.weight.shape[1]}, "
                f"activation={self._activation}")


class Dropout(HybridBlock):
    """Dropout at ``rate``, broadcast along ``axes``, in training mode
    (``autograd.record()`` or ``train_mode()``); the identity otherwise."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        # outside training the op is the identity: hand x back rather
        # than the copy an NDArray op's output would be
        if self._rate == 0 or not autograd.is_training():
            return x
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def extra_repr(self):
        return f"p={self._rate}, axes={self._axes}"


class BatchNorm(HybridBlock):
    """Batch normalization over the channel ``axis`` (1; -1 for a
    channels-last model). ``gamma``/``beta`` train unless ``scale``/
    ``center`` is off (then they are constants, held as buffers);
    ``running_mean``/``running_var`` are constants (buffers), so
    ``parallel.TrainStep``'s sweeps never touch them. In training mode
    (``autograd.record()``, ``TrainStep``) the forward normalises by the
    batch statistics and folds them into the running ones in place, ``run
    * m + stat * (1 - m)`` (the reference's expression); otherwise it
    normalises by the running ones. The parameters stay float32 when the
    block is cast to a half type, as the reference's ``BatchNorm.cast``
    keeps them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = int(axis)
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self._in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _infer_param_shapes(self, x, *rest):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p._finish_deferred_init((c,))

    def cast(self, dtype):
        if str(dtype).split(".")[-1] in ("float16", "bfloat16"):
            dtype = "float32"
        return super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        ret = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis)
        if not isinstance(ret, (list, tuple)):
            return ret
        out, mean, var = ret
        if is_recomputing():
            # the backward's recompute of a rematerialised span: the
            # forward already folded this batch into the statistics
            return out
        m = self._momentum
        with torch.no_grad():
            for run, stat in ((running_mean, mean), (running_var, var)):
                run = _raw(run)
                run.copy_(run * m + _raw(stat).to(run.dtype) * (1 - m))
        return out

    def extra_repr(self):
        return (f"axis={self._axis}, momentum={self._momentum}, "
                f"eps={self._epsilon}")


class LayerNorm(HybridBlock):
    """LayerNorm over the last axis, f32 statistics (the fused kernel on
    a CUDA input)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, dtype="float32"):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, dtype=dtype)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, dtype=dtype)

    def _infer_param_shapes(self, x, *rest):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta):
            p._finish_deferred_init((c,))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._epsilon)


class InstanceNorm(HybridBlock):
    """Each sample's channels normalised over their spatial axes."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def _infer_param_shapes(self, x, *rest):
        for p in (self.gamma, self.beta):
            p._finish_deferred_init((x.shape[1],))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class GroupNorm(HybridBlock):
    """The channels in ``num_groups`` groups, each normalised over its
    channels and the spatial axes."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_groups = num_groups
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def _infer_param_shapes(self, x, *rest):
        for p in (self.gamma, self.beta):
            p._finish_deferred_init((x.shape[1],))

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    """Rows of the (input_dim, output_dim) table at the indices (floats
    are truncated). ``sparse_grad`` takes a dense gradient in the port."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


class Flatten(HybridBlock):
    """Every axis after the first folded into one."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class Lambda(Block):
    """A function (or the name of an ``mx.nd`` op) as a block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod

            self._func = getattr(nd_mod, function)
            self._func_name = function
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")

    def forward(self, *args):
        return self._func(*args)

    def extra_repr(self):
        return self._func_name


class HybridLambda(HybridBlock):
    """``function(F, *args)`` (or the op named ``function``) as a hybrid
    block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name = function

            def _f(F, *args):
                return getattr(F, function)(*args)

            self._func = _f
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)

    def extra_repr(self):
        return self._func_name
