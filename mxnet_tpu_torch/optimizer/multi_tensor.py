"""Horizontally-fused multi-tensor optimizer sweeps (the SGD, Adam and
AdamW families).

Counterpart of ``mxnet_tpu/optimizer/multi_tensor.py``: the family
routing (``family_of``, ``family_static``, ``state_roles``), the
per-member scalar prep with the bias correction folded into the learning
rate (``collect_scalars``, ``:137-185``), the dtype-bucket planner with
its "one sweep per dtype bucket" contract (``plan_buckets``, ``:213``),
and ``packed_apply`` (``:431``), which runs one bucket's sweep:
:func:`~mxnet_tpu_torch.kernels.fused_sgd_sweep`,
:func:`~mxnet_tpu_torch.kernels.fused_adam_sweep` or
:func:`~mxnet_tpu_torch.kernels.fused_adamw_sweep` (its per-member
overflow scan, then the sweep), the hand-written kernels on a CUDA
tensor and their plain versions on a CPU one.

Unlike the JAX sweep, which packs each bucket into flat buffers and
returns new arrays, the port's sweep updates the members in place where
they lie (the kernel's header comment says why). LAMB, and the eager
Trainer's consumer of this module, come with the Trainer slice
(ROADMAP.md, port queue 1, item 7).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..base import MXNetError
from ..kernels import fused_adam_sweep, fused_adamw_sweep, fused_sgd_sweep

__all__ = ["family_of", "family_static", "state_roles", "collect_scalars",
           "plan_buckets", "packed_apply", "Bucket"]

_NOT_PORTED = ("the lamb sweep comes with the Trainer slice (ROADMAP.md, "
               "port queue 1, item 7)")
_FAMILIES = ("sgd", "adam", "adamw")


def _known(family: str) -> None:
    if family not in _FAMILIES:
        raise MXNetError(f"unknown sweep family {family!r}: {_NOT_PORTED}")


def family_of(optimizer) -> Optional[str]:
    """The sweep family of ``optimizer``: ``"sgd"``, ``"adam"`` or
    ``"adamw"`` for exactly :class:`~.optimizer.SGD`,
    :class:`~.optimizer.Adam` or :class:`~.optimizer.AdamW` (a subclass
    may override the update), else None."""
    from .optimizer import SGD, Adam, AdamW

    return {SGD: "sgd", Adam: "adam", AdamW: "adamw"}.get(type(optimizer))


def family_static(optimizer, family: str) -> tuple:
    """The family's hyperparameters fixed for the run, as sorted items:
    SGD's momentum, Adam's and AdamW's betas and epsilon, and the clip."""
    _known(family)
    if family == "sgd":
        items = {"momentum": float(optimizer.momentum)}
    else:
        items = {"beta1": float(optimizer.beta1),
                 "beta2": float(optimizer.beta2),
                 "epsilon": float(optimizer.epsilon)}
    items["clip_gradient"] = optimizer.clip_gradient
    return tuple(sorted(items.items()))


def state_roles(family: str, static: dict) -> Tuple[str, ...]:
    """Names of the family's state leaves in ``create_state`` order (the
    f32 master of a multi-precision member is the separate ``w`` role):
    SGD's ``mom`` (none at momentum 0), Adam's ``mean`` and ``var``."""
    _known(family)
    if family == "sgd":
        return ("mom",) if static["momentum"] != 0.0 else ()
    return ("mean", "var")


def collect_scalars(optimizer, family: str,
                    ks: Sequence[int]) -> Dict[str, list]:
    """Per-member ``lr`` and ``wd``: SGD's as they are; Adam's with the
    bias correction folded into ``lr`` (always for Adam, with
    ``correct_bias`` for AdamW), with the expressions of ``Adam.update``
    and ``AdamW.update`` (the JAX ``collect_scalars``, ``:154-158``). The bias correction is computed
    in double precision, as the JAX step computes it from its traced
    int32 t with ``jax_enable_x64`` on (``step.py:913-920``); the sweep
    reads each value as f32, as the JAX sweep's ``_as_vec`` does."""
    _known(family)
    lrs, wds = [], []
    for k in ks:
        lr = float(optimizer._get_lr(k))
        if family == "adam" or (family == "adamw"
                                and optimizer.correct_bias):
            t = int(optimizer._t(k))
            lr *= ((1.0 - optimizer.beta2 ** t) ** 0.5
                   / (1.0 - optimizer.beta1 ** t))
        lrs.append(lr)
        wds.append(float(optimizer._get_wd(k)))
    return {"lr": lrs, "wd": wds}


class Bucket(NamedTuple):
    """One dtype bucket: ``members`` index the caller's entries;
    ``wdtype``/``gdtype`` the weight and grad dtypes; ``mp`` when the
    sweep runs on f32 masters and writes the low-precision weights in the
    same pass."""

    members: Tuple[int, ...]
    wdtype: torch.dtype
    gdtype: torch.dtype
    mp: bool


def plan_buckets(entries, multi_precision: bool) -> List[Bucket]:
    """Group ``entries`` (``(wdtype, gdtype)`` each) into one bucket per
    dtype pair, in first-seen order: one sweep per dtype bucket."""
    groups: Dict[tuple, list] = {}
    for pos, key in enumerate(entries):
        groups.setdefault(tuple(key), []).append(pos)
    return [Bucket(tuple(mem), wdtype, gdtype,
                   multi_precision and wdtype in (torch.float16,
                                                  torch.bfloat16))
            for (wdtype, gdtype), mem in groups.items()]


def packed_apply(family, static, ins, vecs, rescale, low=None):
    """One fused sweep over one bucket, in place.

    ``ins``: role -> list of per-member tensors: ``w`` (the update
    target: the f32 master in a multi-precision bucket, the weight
    itself otherwise), ``g`` and the family's state roles
    (:func:`state_roles`). ``vecs``:
    ``lr`` and ``wd`` per member (:func:`collect_scalars`). ``rescale``:
    the grad rescale factor. ``low``: a multi-precision bucket's
    low-precision weights, written in the same pass. Returns ``ins``
    (with ``w_low`` = ``low`` when given), updated in place. AdamW's
    overflow flags stay on the device."""
    _known(family)
    static = dict(static)
    if family == "sgd":
        fused_sgd_sweep(ins["w"], ins["g"], ins.get("mom"), low, vecs["lr"],
                        vecs["wd"], momentum=static["momentum"],
                        rescale_grad=rescale,
                        clip_gradient=static["clip_gradient"])
    else:
        sweep = fused_adam_sweep if family == "adam" else fused_adamw_sweep
        sweep(ins["w"], ins["g"], ins["mean"], ins["var"], low, vecs["lr"],
              vecs["wd"], beta1=static["beta1"], beta2=static["beta2"],
              epsilon=static["epsilon"], rescale_grad=rescale,
              clip_gradient=static["clip_gradient"])
    out = dict(ins)
    if low is not None:
        out["w_low"] = low
    return out
