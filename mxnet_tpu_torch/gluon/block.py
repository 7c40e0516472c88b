"""``Block`` and ``HybridBlock`` of the port.

Counterpart of ``mxnet_tpu/gluon/block.py`` as far as the eager
``Trainer`` needs it: a ``Block`` is a ``torch.nn.Module`` with
:meth:`Block.collect_params` (reference ``:195-204``). Parameters are
named by their module path, as ``named_parameters`` names them (a tied
weight once, under its first name), and ``select`` is a regular
expression matched against that name from its start (``re.match``), as
in the reference. ``HybridBlock`` is ``Block``: the port runs eagerly.
``load_parameters`` reads the reference's ``.params`` files under its
structural names (reference ``:294-346``); ``save_parameters``,
``initialize``, ``hybridize`` and hooks wait (ROADMAP.md, port queue 1,
item 6).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch
from torch import nn

from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class Block(nn.Module):
    """Base class of the port's layers and models."""

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """This block's parameters and its children's, as a
        :class:`ParameterDict` keyed by name, those whose name matches
        ``select`` when it is given. Each ``nn.Parameter`` is stood for by
        one :class:`Parameter`, made on the first call and handed back by
        every later one (from any block that holds it)."""
        pat = re.compile(select) if select is not None else None
        out = []
        for name, var in self.named_parameters():
            if pat is not None and not pat.match(name):
                continue
            param = var.__dict__.get("_mx_param")
            if param is None or param._var is not var:
                param = Parameter(name, var)
                var._mx_param = param
            out.append((name, param))
        return ParameterDict(out)

    def _collect_params_with_prefix(self) -> Dict[str, nn.Parameter]:
        """Every parameter under its structural name, the key of a
        ``.params`` file: its module path, as ``named_parameters`` gives
        it. A model whose children are laid out unlike the reference's
        renames them here, so each package loads the other's files."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def load_parameters(self, filename: str, allow_missing: bool = False,
                        ignore_extra: bool = False) -> None:
        """Copy a ``.params`` file's arrays into the parameters of the
        same names, in place, cast to each parameter's dtype and device
        (the reference's ``set_data``). A missing name, an extra name or
        a shape that differs raises :class:`MXNetError` naming it."""
        from ..context import cpu
        from ..ndarray import serialization

        loaded = serialization.load(filename, ctx=cpu())
        if isinstance(loaded, list):
            raise MXNetError(f"{filename} holds a list, not a parameter dict")
        loaded = {k[4:] if k.startswith(("arg:", "aux:")) else k: v
                  for k, v in loaded.items()}
        params = self._collect_params_with_prefix()
        missing = sorted(set(params) - set(loaded))
        if missing and not allow_missing:
            raise MXNetError(
                f"Parameter {missing[0]} missing in {filename} "
                f"(allow_missing=False). The file contains {len(loaded)} "
                f"parameter(s): {sorted(loaded)[:12]}")
        for name, v in loaded.items():
            p = params.get(name)
            if p is None:
                if not ignore_extra:
                    raise MXNetError(f"{filename} contains extra parameter "
                                     f"{name} (ignore_extra=False)")
                continue
            if tuple(v.shape) != tuple(p.shape):
                raise MXNetError(f"{filename}: {name} has shape "
                                 f"{tuple(v.shape)}, the parameter "
                                 f"{tuple(p.shape)}")
            p.copy_(v._data)


HybridBlock = Block
