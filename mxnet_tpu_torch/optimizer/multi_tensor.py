"""Horizontally-fused multi-tensor optimizer sweeps (the SGD, Adam, AdamW
and LAMB families) and their two consumers.

Counterpart of ``mxnet_tpu/optimizer/multi_tensor.py``: the family
routing (``family_of``, ``family_static``, ``state_roles``), the
per-member scalar prep with the bias correction folded into the learning
rate, or LAMB's bias corrections as separate per-member values
(``collect_scalars``, ``:137-185``), the dtype-bucket planner with its
"one sweep per dtype bucket" contract (``plan_buckets``, ``:213``),
``packed_apply`` (``:431``), which runs one bucket's sweep:
:func:`~mxnet_tpu_torch.kernels.fused_sgd_sweep`,
:func:`~mxnet_tpu_torch.kernels.fused_adam_sweep`,
:func:`~mxnet_tpu_torch.kernels.fused_adamw_sweep` (its per-member
overflow scan, then the sweep) or
:func:`~mxnet_tpu_torch.kernels.fused_lamb_sweep` (phase 1, the
per-member norms, phase 2), the hand-written kernels on a CUDA tensor
and their plain versions on a CPU one; and the eager consumer that
``gluon.Trainer`` runs (``plan_eager``/``apply_eager_plan``,
``:878-1003``). ``parallel.TrainStep`` and the Trainer share
:func:`sweep_bucket`; a parameter the sweep cannot take (:func:`sweepable`)
and every parameter of another optimizer, or of a subclass of these four,
take the optimizer's per-parameter ``update`` instead.

Unlike the JAX sweep, which packs each bucket into flat buffers and
returns new arrays, the port's sweep updates the members in place where
they lie (the kernel's header comment says why), so the eager consumer
has no compile cache and no jitted program per bucket: one sweep call
per dtype bucket.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..base import MXNetError
from ..kernels import (fused_adam_sweep, fused_adamw_sweep, fused_lamb_sweep,
                       fused_sgd_sweep)
from ..kernels.fused_optimizer import _COMBOS, _layout
from ..ndarray import NDArray

__all__ = ["family_of", "family_static", "state_roles", "collect_scalars",
           "sweepable",
           "plan_buckets", "packed_apply", "sweep_bucket", "plan_eager",
           "apply_eager_plan", "Bucket", "EagerPlan"]

_FAMILIES = ("sgd", "adam", "adamw", "lamb")


def _known(family: str) -> None:
    if family not in _FAMILIES:
        raise MXNetError(f"unknown sweep family {family!r} (known: "
                         f"{_FAMILIES})")


def family_of(optimizer) -> Optional[str]:
    """The sweep family of ``optimizer``: ``"sgd"``, ``"adam"``,
    ``"adamw"`` or ``"lamb"`` for exactly :class:`~.optimizer.SGD`,
    :class:`~.optimizer.Adam`, :class:`~.optimizer.AdamW` or
    :class:`~.optimizer.LAMB` (a subclass may override the update), else
    None."""
    from .optimizer import LAMB, SGD, Adam, AdamW

    return {SGD: "sgd", Adam: "adam", AdamW: "adamw",
            LAMB: "lamb"}.get(type(optimizer))


def sweepable(family: str, weight: torch.Tensor, grad: torch.Tensor,
              multi_precision: bool) -> bool:
    """Whether the sweep kernels take this parameter (on either device,
    so that the CPU routes as the card does): an f32 update target (a
    bf16 weight's master under ``multi_precision``) or a bf16 one, an f32
    or bf16 grad, the weight and grad dense in one memory order, and
    LAMB's target f32."""
    low = weight.dtype in (torch.float16, torch.bfloat16)
    mp = multi_precision and low
    if mp and weight.dtype != torch.bfloat16:
        return False
    target = torch.float32 if mp else weight.dtype
    if (target, grad.dtype) not in _COMBOS:
        return False
    if family == "lamb" and target != torch.float32:
        return False
    order = _layout(weight)
    return order is not None and order == _layout(grad)


def family_static(optimizer, family: str) -> tuple:
    """The family's hyperparameters fixed for the run, as sorted items:
    SGD's momentum, the betas and epsilon, LAMB's bias correction, its
    bounds and ``bc_recip`` (whether the bias corrections arrive as f32
    reciprocals, on the eager path, or as divisors, under the fused
    step's dynamic mode; reference ``:101-111``), and the clip."""
    _known(family)
    if family == "sgd":
        items = {"momentum": float(optimizer.momentum)}
    else:
        items = {"beta1": float(optimizer.beta1),
                 "beta2": float(optimizer.beta2),
                 "epsilon": float(optimizer.epsilon)}
    if family == "lamb":
        items.update(bias_correction=bool(optimizer.bias_correction),
                     lower_bound=optimizer.lower_bound,
                     upper_bound=optimizer.upper_bound,
                     bc_recip=optimizer._dyn is None)
    items["clip_gradient"] = optimizer.clip_gradient
    return tuple(sorted(items.items()))


def state_roles(family: str, static: dict) -> Tuple[str, ...]:
    """Names of the family's state leaves in ``create_state`` order (the
    f32 master of a multi-precision member is the separate ``w`` role):
    SGD's ``mom`` (none at momentum 0), the others' ``mean`` and
    ``var``."""
    _known(family)
    if family == "sgd":
        return ("mom",) if static["momentum"] != 0.0 else ()
    return ("mean", "var")


def collect_scalars(optimizer, family: str,
                    ks: Sequence[int]) -> Dict[str, list]:
    """Per-member ``lr`` and ``wd``, each with its parameter's
    multiplier: SGD's and LAMB's as they are; Adam's with the bias
    correction folded into ``lr`` (always for Adam, with
    ``correct_bias`` for AdamW), with the expressions of ``Adam.update``
    and ``AdamW.update`` (the JAX ``collect_scalars``, ``:154-158``). The
    bias correction is computed in double precision, as the JAX step
    computes it from its traced int32 t with ``jax_enable_x64`` on
    (``step.py:913-920``); the sweep reads each value as f32, as the JAX
    sweep's ``_as_vec`` does.

    LAMB with ``bias_correction`` also gets ``bc1`` and ``bc2``
    (``:159-185``): on the eager path the f32 reciprocal of the
    f32-rounded ``1 - beta**t``, computed with numpy float32 (the
    reference's per-t op is constant-folded into that multiply); under
    the fused step's dynamic mode ``1 - beta**t`` itself, for a true
    division."""
    _known(family)
    lrs, wds, bc1s, bc2s = [], [], [], []
    for k in ks:
        lr = float(optimizer._get_lr(k))
        if family == "adam" or (family == "adamw"
                                and optimizer.correct_bias):
            t = int(optimizer._t(k))
            lr *= ((1.0 - optimizer.beta2 ** t) ** 0.5
                   / (1.0 - optimizer.beta1 ** t))
        elif family == "lamb" and optimizer.bias_correction:
            t = int(optimizer._t(k))
            bc1 = 1.0 - optimizer.beta1 ** t
            bc2 = 1.0 - optimizer.beta2 ** t
            if optimizer._dyn is None:
                bc1 = float(np.float32(1.0) / np.float32(bc1))
                bc2 = float(np.float32(1.0) / np.float32(bc2))
            bc1s.append(bc1)
            bc2s.append(bc2)
        lrs.append(lr)
        wds.append(float(optimizer._get_wd(k)))
    out = {"lr": lrs, "wd": wds}
    if family == "lamb" and optimizer.bias_correction:
        out["bc1"], out["bc2"] = bc1s, bc2s
    return out


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
    overflow flags and LAMB's norms stay on the device; ``vecs`` also
    carries LAMB's ``bc1``/``bc2`` under ``bias_correction``."""
    _known(family)
    static = dict(static)
    if family == "sgd":
        fused_sgd_sweep(ins["w"], ins["g"], ins.get("mom"), low, vecs["lr"],
                        vecs["wd"], momentum=static["momentum"],
                        rescale_grad=rescale,
                        clip_gradient=static["clip_gradient"])
    elif family == "lamb":
        fused_lamb_sweep(
            ins["w"], ins["g"], ins["mean"], ins["var"], low, vecs["lr"],
            vecs["wd"], vecs.get("bc1"), vecs.get("bc2"),
            beta1=static["beta1"], beta2=static["beta2"],
            epsilon=static["epsilon"], rescale_grad=rescale,
            clip_gradient=static["clip_gradient"],
            bias_correction=static["bias_correction"],
            bc_recip=static["bc_recip"], lower_bound=static["lower_bound"],
            upper_bound=static["upper_bound"])
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


def _as_tuple(state) -> tuple:
    if state is None:
        return ()
    return state if isinstance(state, tuple) else (state,)


def _t(x):
    """The tensor of a state leaf (an NDArray after ``set_states``)."""
    return x._data if isinstance(x, NDArray) else x


def sweep_bucket(optimizer, family: str, static: tuple, bucket: Bucket,
                 ks: Sequence[int], params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], states: Sequence) -> None:
    """One fused sweep over ``bucket``'s members, in place: ``ks`` are
    their optimizer indices, ``params`` the weights, ``grads`` their
    gradients and ``states`` their states as
    ``create_state_multi_precision`` made them (``(f32 master, state)``
    in a multi-precision bucket, whose bf16 weights the sweep writes from
    the new masters)."""
    params = [p.detach() for p in params]
    if bucket.mp:
        ins = {"w": [_t(s[0]) for s in states], "g": list(grads)}
        base, low = [s[1] for s in states], params
    else:
        ins = {"w": params, "g": list(grads)}
        base, low = states, None
    for ri, role in enumerate(state_roles(family, dict(static))):
        ins[role] = [_t(_as_tuple(s)[ri]) for s in base]
    packed_apply(family, static, ins, collect_scalars(optimizer, family, ks),
                 optimizer.rescale_grad, low=low)


class EagerPlan(NamedTuple):
    """One eager Trainer step's sweep plan: the family, its static items
    and the dtype buckets of the step's items."""

    family: str
    static: tuple
    buckets: Tuple[Bucket, ...]


def plan_eager(optimizer, updater, items) -> EagerPlan:
    """Plan one eager step over ``items`` (``(index, weight, grad)`` for
    each parameter the sweep takes, :func:`sweepable`) of an optimizer
    with a sweep family (:func:`family_of`): each
    missing state is created in ``updater.states`` (the lazy ``Updater``
    contract) and the items are bucketed by dtype; no count advances and
    no weight moves."""
    family = family_of(optimizer)
    for i, w, _ in items:
        if i not in updater.states:
            updater.states[i] = optimizer.create_state_multi_precision(
                i, w.detach())
    buckets = plan_buckets([(w.dtype, g.dtype) for _, w, g in items],
                           optimizer.multi_precision)
    return EagerPlan(family, family_static(optimizer, family),
                     tuple(buckets))


def apply_eager_plan(optimizer, updater, plan: EagerPlan, items) -> None:
    """Apply a :func:`plan_eager` plan: advance the update counts of every
    index first, then one fused sweep per dtype bucket, in place."""
    for i, _, _ in items:
        optimizer._update_count(i)
    for b in plan.buckets:
        telemetry.record_optimizer_dispatch("fused_sweep")
        ks = [items[pos][0] for pos in b.members]
        sweep_bucket(optimizer, plan.family, plan.static, b, ks,
                     [items[pos][1] for pos in b.members],
                     [items[pos][2] for pos in b.members],
                     [updater.states[k] for k in ks])
