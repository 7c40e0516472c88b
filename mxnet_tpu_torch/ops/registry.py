"""Operator registry of the port (counterpart of
``mxnet_tpu/ops/registry.py:42-295`` and its eager call, ``:407-516``).

An operator is a pure PyTorch function ``fn(*tensors, **attrs) ->
tensor | tuple`` registered under its MXNet name. Tensor inputs are its
positional parameters, attributes its keyword parameters with defaults
(a positional parameter whose default is None is an optional tensor, as
``bias=None``); :func:`register` splits the two with ``inspect``, and the
``mx.nd.*`` wrappers are generated from that split. Typed attribute
declarations (:class:`AttrSpec`, the ``dmlc::Parameter`` equivalent) are
validated on every call with the reference's messages and rendered into
the wrappers' docstrings.

The reference's jit caches, bulk recording, fused segments and warm
specs (``registry.py:298-358``, ``:529-925``) are XLA devices; PyTorch
runs each op eagerly, so :func:`invoke` validates and calls.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as _np

from ..base import MXNetError

__all__ = ["OpDef", "AttrSpec", "attr", "register", "get_op", "has_op",
           "list_ops", "alias", "validate_attrs", "render_attr_docs",
           "invoke"]


class AttrSpec(NamedTuple):
    """A typed operator attribute: its type (a type or a tuple of them),
    an inclusive numeric range, or a set of choices."""

    name: str
    type: object = None
    doc: str = ""
    low: Optional[float] = None
    high: Optional[float] = None
    choices: Optional[tuple] = None

    def describe(self) -> str:
        parts = []
        if self.type is not None:
            ts = self.type if isinstance(self.type, tuple) else (self.type,)
            parts.append("/".join(t.__name__ for t in ts))
        if self.choices is not None:
            parts.append("one of " + ", ".join(map(repr, self.choices)))
        if self.low is not None or self.high is not None:
            lo = "-inf" if self.low is None else self.low
            hi = "inf" if self.high is None else self.high
            parts.append(f"range [{lo}, {hi}]")
        return ", ".join(parts)


def attr(name, type=None, doc="", low=None, high=None, choices=None):
    return AttrSpec(name, type, doc, low, high,
                    tuple(choices) if choices is not None else None)


# what each declared type accepts (a float attribute takes an int, a
# tuple attribute a list or one int)
_COERCIBLE = {
    int: (int,),
    float: (int, float),
    bool: (bool, int),
    str: (str,),
    tuple: (tuple, list, int),
}


def validate_attrs(opdef: "OpDef", attrs: Dict) -> None:
    """Raise :class:`MXNetError` naming the op, the attribute and the
    constraint for a value out of its spec. Undeclared attributes pass."""
    specs = opdef.attr_specs
    if not specs:
        return
    for k, v in attrs.items():
        spec = specs.get(k)
        if spec is None or v is None:
            continue
        if isinstance(v, _np.generic):
            v = v.item()
        if spec.type is not None:
            want = spec.type if isinstance(spec.type, tuple) else (spec.type,)
            ok = any(isinstance(v, _COERCIBLE.get(t, (t,))) for t in want)
            # a bool is an int in Python: refuse it where an int is wanted
            if ok and bool not in want and isinstance(v, bool):
                ok = False
            if not ok:
                raise MXNetError(
                    f"{opdef.name}: attribute {k}={v!r} has type "
                    f"{type(v).__name__}; expected {spec.describe()}")
        if spec.choices is not None and v not in spec.choices:
            raise MXNetError(
                f"{opdef.name}: attribute {k}={v!r} must be "
                f"{spec.describe()}")
        for item in (v if isinstance(v, (tuple, list)) else (v,)):
            if not isinstance(item, (int, float)) or isinstance(item, bool):
                continue
            if spec.low is not None and item < spec.low:
                raise MXNetError(f"{opdef.name}: attribute {k}={v!r} below "
                                 f"{spec.describe()}")
            if spec.high is not None and item > spec.high:
                raise MXNetError(f"{opdef.name}: attribute {k}={v!r} above "
                                 f"{spec.describe()}")


def render_attr_docs(opdef: "OpDef") -> str:
    """The numpy-style attribute section of a wrapper's docstring."""
    if not opdef.attr_specs:
        return ""
    lines = ["", "", "Attributes", "----------"]
    for spec in opdef.attr_specs.values():
        desc = spec.describe()
        lines.append(spec.name + (f" : {desc}" if desc else ""))
        if spec.doc:
            lines.append(f"    {spec.doc}")
    return "\n".join(lines)


class OpDef(NamedTuple):
    name: str
    fn: Callable
    tensor_params: tuple              # tensor parameters, in order
    optional_tensor_params: frozenset  # those that may be None (bias)
    attr_params: tuple                # attribute names, in order
    variadic: bool                    # takes *tensors (Concat, add_n)
    attr_specs: Optional[Dict] = None  # AttrSpec by name
    views: bool = False               # its outputs are views of its input


_REGISTRY: Dict[str, OpDef] = {}


def register(name: Optional[str] = None, aliases: Sequence[str] = (),
             attrs: Sequence[AttrSpec] = (), views: bool = False):
    """Decorator registering a PyTorch op under ``name`` (default: the
    function's name) and ``aliases``; ``attrs`` declares typed
    attributes. ``views``: the op's outputs are views of its input, and
    the NDArray layer hands them out as such (no other op's NDArray
    output shares its input's storage)."""

    def deco(fn):
        opname = name or fn.__name__
        tensor_params: List[str] = []
        optional: List[str] = []
        attr_params: List[str] = []
        params = inspect.signature(fn).parameters.values()
        for p in params:
            if p.kind == p.POSITIONAL_OR_KEYWORD and p.default is not None \
                    and p.default is not p.empty:
                attr_params.append(p.name)
            elif p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                            p.VAR_POSITIONAL):
                tensor_params.append(p.name)
                if p.default is None:
                    optional.append(p.name)
            elif p.kind == p.KEYWORD_ONLY:
                attr_params.append(p.name)
        opdef = OpDef(
            name=opname, fn=fn, tensor_params=tuple(tensor_params),
            optional_tensor_params=frozenset(optional),
            attr_params=tuple(attr_params),
            variadic=any(p.kind == p.VAR_POSITIONAL for p in params),
            attr_specs={s.name: s for s in attrs} if attrs else None,
            views=views)
        _REGISTRY[opname] = opdef
        for a in aliases:
            _REGISTRY[a] = opdef
        return fn

    return deco


def alias(new_name: str, existing: str) -> None:
    _REGISTRY[new_name] = _REGISTRY[existing]


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"operator {name!r} is not ported to mxnet_tpu_torch yet "
            "(ROADMAP.md, port queue 1, item 4 (d)-(h))") from None


def has_op(name: str) -> bool:
    return name in _REGISTRY


def list_ops() -> List[str]:
    return sorted(_REGISTRY)


def invoke(opdef: OpDef, tensors, attrs: Dict):
    """Run one op eagerly: validate its attributes, call it."""
    if opdef.attr_specs:
        validate_attrs(opdef, attrs)
    return opdef.fn(*tensors, **attrs)
