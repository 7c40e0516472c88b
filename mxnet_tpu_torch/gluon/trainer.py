"""Gluon ``Trainer`` of the port: the optimizer step of the eager path and
its data-parallel comms.

Counterpart of ``mxnet_tpu/gluon/trainer.py``, as MXNet's users wrote
it::

    ctxs = [mx.gpu(0), mx.gpu(1)]            # or cpu(0), cpu(1)
    net.initialize(ctx=ctxs)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 1e-3}, kvstore="nccl")
    with mx.autograd.record():
        losses = [loss_fn(net(x), y) for x, y in zip(
            split_and_load(data, ctxs), split_and_load(label, ctxs))]
    mx.autograd.backward(losses)
    trainer.step(batch_size)

``step`` sets ``rescale_grad = 1 / batch_size``, exchanges the
gradients of the parameters' contexts (and processes) through the
kvstore (``_allreduce_grads``: one batched ``pushpull`` whose keys the
store coalesces into ``MXNET_KV_BUCKET_MB`` buckets, priority ``-i``),
then updates each context's copy: SGD, Adam, AdamW and LAMB (exactly
those classes) through the fused sweep, one per dtype bucket and
context, every other optimizer and every parameter the sweep cannot
take through the per-parameter ``Updater``. Each context advances its
own update count (``_set_current_context``), so the copies stay
identical under Adam's bias correction.

The kvstore (reference ``:117-166``): None, or ``"device"``/``"local"``
on one context, exchanges nothing; several contexts, or ``"nccl"``,
``"tpu_sync"``, ``"dist_sync"``, ``"dist_device_sync"``, make a store
(:func:`mxnet_tpu_torch.kvstore.create`). ``update_on_kvstore=True``
runs the optimizer on the store (push the gradients, pull the weights);
its default is the reference's. ``compression_params={'type': '2bit',
'threshold': t}`` quantizes each bucket (``twobit_quantize``) with error
feedback. ``overlap_comms=True`` (or ``MXNET_KV_OVERLAP=1``) exchanges
each bucket from inside the backward the moment its members' gradients
are written (``autograd.watch_grad_ready``; ``last_overlap_stats``).
``partition="zero1"|"zero2"`` (or ``MXNET_ZERO_PARTITION``) shards the
optimizer state of the sgd/adam/adamw families (:mod:`..optimizer.zero`).

``check_nonfinite`` (or ``MXNET_CHECK_NONFINITE=1``) skips a step whose
gradients hold NaN or Inf before any exchange, counting it in
``steps_skipped`` and telemetry. ``save_states``/``load_states`` write
and read the ``Updater``'s v2 states, with the compression residuals
and the ZeRO shards in the reference's envelope (each package loads the
other's), committed atomically.
"""
from __future__ import annotations

import contextlib
import logging
import os
import warnings
from typing import List, Optional

import torch

from .. import autograd as ag
from .. import optimizer as opt
from .. import telemetry
from ..base import MXNetError
from ..ndarray import NDArray
from ..optimizer import multi_tensor as mt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_COLLECTIVE = ("tpu_sync", "dist_sync", "dist_device_sync", "nccl")


class Trainer:
    """Applies an optimizer to a set of :class:`Parameter`\\ s.

    Parameters
    ----------
    params : a :class:`ParameterDict` (or dict) or a list of
        :class:`Parameter`, all on one set of contexts.
    optimizer : a registered name (``"sgd"``, ``"nag"``, ``"adam"``...)
        built with ``optimizer_params``, or an
        :class:`~mxnet_tpu_torch.optimizer.Optimizer` (then
        ``optimizer_params`` must be empty).
    kvstore : a type name, a :class:`~mxnet_tpu_torch.kvstore.KVStore`
        or None (see the module docstring).
    compression_params, update_on_kvstore, overlap_comms, partition,
    partition_rank, partition_world : see the module docstring.
    check_nonfinite : skip and count a step with NaN/Inf gradients.
    """

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, check_nonfinite=None,
                 overlap_comms=None, partition=None, partition_rank=None,
                 partition_world=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("First argument must be a list or dict of "
                             f"Parameters, got {type(params)}")
        self._params: List[Parameter] = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"invalid parameter {p!r}")
            self._params.append(p)
        if check_nonfinite is None:
            check_nonfinite = os.environ.get("MXNET_CHECK_NONFINITE",
                                             "0") == "1"
        self._check_nonfinite = bool(check_nonfinite)
        self.steps_skipped = 0
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an instance")
            optimizer.param_dict = param_dict
        else:
            optimizer = opt.create(optimizer, param_dict=param_dict,
                                   **(optimizer_params or {}))
        self._optimizer = optimizer
        # one Updater per context, the first made now
        self._updaters = [opt.Updater(optimizer)]
        self._scale = 1.0
        self._compression_params = compression_params
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        self._contexts = None
        if overlap_comms is None:
            overlap_comms = os.environ.get("MXNET_KV_OVERLAP", "0") == "1"
        self._overlap_comms = bool(overlap_comms)
        self._overlap = None
        self.last_overlap_stats = None
        if partition is None:
            partition = os.environ.get("MXNET_ZERO_PARTITION") or None
        if partition is not None and partition not in ("zero1", "zero2"):
            raise MXNetError(f"unknown partition mode {partition!r}; "
                             "expected one of ('zero1', 'zero2')")
        self._partition = partition
        self._partition_rank = partition_rank
        self._partition_world = partition_world
        self._zero = None

    @property
    def _updater(self):
        """The first context's Updater."""
        return self._updaters[0]

    # ------------------------------------------------------------------
    def _check_contexts(self):
        contexts = None
        for p in self._params:
            ctx = p.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError(
                    f"All Parameters must be initialized on the same set of "
                    f"contexts, but {p.name} is on {ctx} while others are on "
                    f"{contexts}")
            contexts = ctx
        return contexts or []

    def _init_kvstore(self):
        self._contexts = self._check_contexts()
        kv_type = self._kvstore_type
        if isinstance(kv_type, str):
            if len(self._contexts) > 1 or kv_type.lower() in _COLLECTIVE:
                from .. import kvstore as kv

                self._kvstore = kv.create(kv_type)
            else:
                self._kvstore = None
        else:
            self._kvstore = kv_type
        if self._kvstore is None and self._update_on_kvstore:
            raise MXNetError(
                "update_on_kvstore=True requires a kvstore, but none is "
                "active (single context with kvstore='local'/'device' has "
                "nothing to aggregate); pass kvstore='nccl' or drop "
                "update_on_kvstore")
        if self._kvstore is not None:
            if self._compression_params is not None:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            if self._update_on_kvstore is None:
                self._update_on_kvstore = self._kvstore.type not in (
                    "tpu_sync", "local", "device") \
                    and len(self._contexts) > 1
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.init(i, p.data(self._contexts[0]))
        self._updaters = self._updaters[:1] + [
            opt.Updater(self._optimizer) for _ in self._contexts[1:]]
        self._kv_initialized = True
        if self._partition is not None:
            self._init_partition()
        if self._overlap_comms:
            if self._zero is not None:
                # the ZeRO engine owns the exchange of its members
                warnings.warn(
                    "overlap_comms is disabled under partition="
                    f"{self._partition!r}: the ZeRO engine owns the "
                    "gradient collective for sharded params", stacklevel=2)
            else:
                self._setup_overlap()

    def _init_partition(self):
        from ..optimizer import zero as _zero

        if self._update_on_kvstore:
            raise MXNetError(
                f"partition={self._partition!r} requires a worker-side "
                "optimizer (update_on_kvstore=False): the sharded sweep "
                "runs on the workers")
        if _zero.supported_family(self._optimizer) is None:
            n = sum(1 for p in self._params if p.grad_req != "null")
            telemetry.record_kv_bucket_fallback(_zero.FALLBACK_FAMILY, n)
            warnings.warn(
                f"partition={self._partition!r} ignored: optimizer "
                f"{type(self._optimizer).__name__} is outside the sharded "
                "sweep families (sgd/adam/adamw) — training continues "
                "replicated", stacklevel=3)
            return
        self._zero = _zero.ZeroEngine(self, self._partition,
                                      rank=self._partition_rank,
                                      world=self._partition_world)
        self._zero.ensure_ready()

    @property
    def partition(self) -> Optional[str]:
        """The active ZeRO partition mode ('zero1'/'zero2'), or None."""
        return self._zero.mode if self._zero is not None else None

    def partition_manifest(self) -> Optional[dict]:
        """The partition plan (mode, world, rank, bucket layout; no
        tensors) for checkpoint manifests; None when unpartitioned."""
        if not self._kv_initialized:
            self._init_kvstore()
        return None if self._zero is None else \
            self._zero.partition_manifest()

    def zero_reconfigure(self, rank, world):
        """Adopt a new (rank, world) partition identity (virtual mode;
        :meth:`ZeroEngine.reconfigure`)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._zero is None:
            raise MXNetError(
                "zero_reconfigure requires an active partition= mode")
        self._zero.reconfigure(rank, world)

    # -- backward-overlapped comms -------------------------------------
    def _setup_overlap(self):
        """Watch every trainable copy's gradient (``watch_grad_ready``)
        so that ``backward()`` exchanges each bucket of the store's plan
        as soon as all its members' gradients are written. Engages only
        where the fused bucketed exchange runs (a worker-side optimizer,
        bucketing on) and every trainable parameter writes its gradient
        (``'add'`` would exchange a partial sum); the nonfinite guard
        must see gradients before any exchange, so it keeps the at-step
        exchange. One backward per step. Buckets go in one order on every
        rank: from the plan's last group to its first (the order the
        backward finishes them, the last layers first); a group that
        finishes early waits for the groups after it, and ``step``
        exchanges whatever did not finish."""
        store = self._kvstore
        if (store is None or self._update_on_kvstore
                or not hasattr(store, "plan_pushpull")
                or getattr(store, "_bucket_bytes", 0) <= 0
                or self._check_nonfinite):
            return
        if any(p.grad_req == "add" for p in self._params):
            return
        idxs = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not idxs:
            return
        watch, arrays = {}, []
        for i in idxs:
            for a in self._params[i].list_data():
                watch[id(a)] = i
                arrays.append(a)
        if self._overlap is not None:
            ag.unwatch_grad_ready(self._overlap["arrays"])
        self._overlap = {
            "idxs": idxs, "watch": watch, "arrays": arrays,
            "pending": {i: len(self._params[i].list_ctx()) for i in idxs},
            "exchange": None, "groups": None, "group_of": {}, "left": [],
            "ready": set(), "next": None, "in_backward": 0, "seq": -1,
        }
        ag.watch_grad_ready(arrays, self._on_grad_ready)

    def _grad_exchange_args(self):
        # the ZeRO engine reduces its members itself
        zero_keys = set(self._zero.eligible_indices()) \
            if self._zero is not None else ()
        keys, grads, priorities = [], [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null" or i in zero_keys:
                continue
            keys.append(i)
            grads.append(p.list_grad())
            priorities.append(-i)
        return keys, grads, priorities

    def _ensure_overlap_plan(self):
        st = self._overlap
        if st["groups"] is not None:
            return
        keys, grads, priorities = self._grad_exchange_args()
        st["exchange"] = (keys, grads, priorities)
        st["groups"] = self._kvstore.plan_pushpull(keys, grads, priorities)
        for gi, grp in enumerate(st["groups"]):
            for pos in grp:
                st["group_of"][keys[pos]] = gi
        # members of each group whose gradients are not written yet
        st["left"] = [len(grp) for grp in st["groups"]]
        st["next"] = len(st["groups"]) - 1

    def _on_grad_ready(self, arr):
        """Fires inside ``backward()`` when a watched copy's gradient
        buffer is written."""
        st = self._overlap
        if st is None:
            return
        seq = ag.backward_sweep_seq()
        if seq != st["seq"]:
            # a new sweep: if the last one raised midway (so step()'s
            # flush never ran), start this step's tracking afresh
            if st["seq"] != -1 and (st["ready"] or st["in_backward"]):
                self._reset_overlap_step()
            st["seq"] = seq
        i = st["watch"].get(id(arr))
        if i is None:
            return
        st["pending"][i] = st["pending"].get(i, 0) - 1
        if st["pending"][i] > 0:
            return
        self._ensure_overlap_plan()
        gi = st["group_of"].get(i)
        if gi is None:
            return
        st["left"][gi] -= 1
        if st["left"][gi] > 0:
            return
        st["ready"].add(gi)
        while st["next"] >= 0 and st["next"] in st["ready"]:
            self._dispatch_overlap_group(st["next"], during_backward=True)
            st["next"] -= 1

    def _dispatch_overlap_group(self, gi, during_backward):
        st = self._overlap
        keys, grads, priorities = st["exchange"]
        grp = st["groups"][gi]
        self._kvstore.pushpull([keys[pos] for pos in grp],
                               [grads[pos] for pos in grp],
                               out=[grads[pos] for pos in grp],
                               priority=[priorities[pos] for pos in grp])
        if during_backward:
            st["in_backward"] += 1
        telemetry.record_kv_overlap("backward" if during_backward
                                    else "step")

    def _overlap_flush(self):
        """Exchange every group the backward did not, in the same order;
        record the stats and reset the step's tracking."""
        st = self._overlap
        self._ensure_overlap_plan()
        while st["next"] >= 0:
            self._dispatch_overlap_group(st["next"], during_backward=False)
            st["next"] -= 1
        self.last_overlap_stats = {
            "groups": len(st["groups"]),
            "dispatched_in_backward": st["in_backward"],
        }
        self._reset_overlap_step()

    def _reset_overlap_step(self):
        st = self._overlap
        st["ready"].clear()
        st["in_backward"] = 0
        if st["groups"] is not None:
            st["next"] = len(st["groups"]) - 1
            st["left"] = [len(grp) for grp in st["groups"]]
        for i in st["idxs"]:
            st["pending"][i] = len(self._params[i].list_ctx())

    # ------------------------------------------------------------------
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr) -> None:
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False) -> None:
        """Exchange the gradients, then one optimizer step scaled by
        ``1 / batch_size``; with ``check_nonfinite``, a step with NaN/Inf
        gradients is skipped and counted before any exchange."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._check_nonfinite and self._grads_nonfinite():
            self.steps_skipped += 1
            telemetry.record_step_skipped("nonfinite_grad")
            logging.warning(
                "Trainer.step: non-finite gradient detected, skipping "
                "update (%d skipped so far)", self.steps_skipped)
            return
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def _grads_nonfinite(self) -> bool:
        """True if any live gradient of any context holds NaN/Inf: every
        gradient's ``isfinite().all()`` folded per device, one read to the
        host each."""
        by_dev = {}
        for p in self._params:
            if p.grad_req == "null":
                continue
            for ci in range(len(p.list_ctx())):
                g = p._grad_tensor(ci)
                by_dev.setdefault(g.device, []).append(
                    torch.isfinite(g).all())
        return not all(bool(torch.stack(f).all()) for f in by_dev.values())

    def allreduce_grads(self) -> None:
        """Exchange the gradients only (reference
        ``Trainer.allreduce_grads``), e.g. to clip between the exchange
        and :meth:`update`."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self) -> None:
        if self._kvstore is None:
            return
        if self._update_on_kvstore:
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.push(i, p.list_grad(), priority=-i)
            return
        if self._overlap is not None:
            self._overlap_flush()
            return
        keys, grads, priorities = self._grad_exchange_args()
        if keys:
            self._kvstore.pushpull(keys, grads, out=grads,
                                   priority=priorities)

    def update(self, batch_size, ignore_stale_grad=False) -> None:
        """The optimizer step alone (after :meth:`allreduce_grads`)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False) -> None:
        if self._update_on_kvstore:
            for i, p in enumerate(self._params):
                if p.grad_req != "null":
                    self._kvstore.pull(i, p.list_data(), priority=-i)
            return
        idxs = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if self._zero is not None:
            self._zero.step()
            zero_keys = set(self._zero.eligible_indices())
            idxs = [i for i in idxs if i not in zero_keys]
        self._update_indices(idxs)

    def _n_contexts(self) -> int:
        return max(1, len(self._contexts or ()))

    def _update_indices(self, idxs) -> None:
        """Update the parameters ``idxs`` on every context: the fused
        families' sweepable parameters through one sweep per dtype bucket
        and context (every context planned before any sweeps), the rest
        per parameter. Under an ``lr_scheduler`` with several contexts
        everything goes per parameter, index by index and context by
        context, as the reference's order of the scheduler's clock
        wants."""
        o = self._optimizer
        nctx = self._n_contexts()
        family = mt.family_of(o)
        fused, rest = [], idxs
        if family is not None and not (nctx > 1
                                       and o.lr_scheduler is not None):
            mp = o.multi_precision
            rest = []
            for i in idxs:
                p = self._params[i]
                g = p._grad_tensor()
                if mt.sweepable(family, p._var, g, mp):
                    fused.append((i, p, g))
                else:
                    rest.append(i)
        if fused:
            per_ctx = [[(i, p._copies[ci], g if ci == 0
                         else p._grad_tensor(ci))
                        for i, p, g in fused] for ci in range(nctx)]
            plans = []
            for ci, items in enumerate(per_ctx):
                with self._ctx_scope(ci):
                    plans.append(mt.plan_eager(o, self._updaters[ci],
                                               items))
            for ci, (plan, items) in enumerate(zip(plans, per_ctx)):
                o._set_current_context(ci)
                mt.apply_eager_plan(o, self._updaters[ci], plan, items)
        for i in rest:
            p = self._params[i]
            for ci in range(nctx):
                o._set_current_context(ci)
                telemetry.record_optimizer_dispatch("per_param")
                ctx = p._ctxs[ci]
                self._updaters[ci](
                    i, NDArray(p._grad_tensor(ci), ctx=ctx),
                    NDArray(p._copies[ci].detach(), ctx=ctx))
        o._set_current_context(0)

    def _ctx_scope(self, ci):
        ctxs = self._contexts or (self._params[0].list_ctx()
                                  if self._params else [])
        return ctxs[ci] if ci < len(ctxs) \
            else contextlib.nullcontext()

    # ------------------------------------------------------------------
    # the envelope of trainer states that carry compression residuals or
    # ZeRO shards beside the updater's bytes (the reference's marker)
    _STATES_ENVELOPE = "__mxnet_tpu_trainer_states__"

    def _compression(self):
        return getattr(self._kvstore, "_compression", None) \
            if self._kvstore is not None else None

    def save_states(self, fname) -> None:
        """The updater's states (``Updater.get_states``) into ``fname``,
        committed atomically; with gradient compression the residuals,
        and under ZeRO this rank's shards, ride along in the reference's
        envelope."""
        if not self._kv_initialized:
            self._init_kvstore()
        from ..checkpoint import atomic_write

        blob = self._updaters[0].get_states(dump_optimizer=False)
        comp = self._compression()
        if comp is not None or self._zero is not None:
            import pickle

            env = {self._STATES_ENVELOPE: 1, "updater": blob}
            if comp is not None:
                env["compression"] = comp.get_state()
            if self._zero is not None:
                env["zero"] = self._zero.export_state()
            blob = pickle.dumps(env)
        atomic_write(fname, blob)

    def _set_updater_states(self, blob) -> None:
        for ci, upd in enumerate(self._updaters):
            with self._ctx_scope(ci):
                upd.set_states(blob)
            if upd.optimizer is not self._optimizer:
                # a dump_optimizer=True payload installed its own
                # optimizer: carry its counters onto the live one
                self._optimizer.num_update = upd.optimizer.num_update
                self._optimizer._restore_update_counts(
                    upd.optimizer._index_update_count)
                upd.optimizer = self._optimizer
            self._conform_states(ci)

    def load_states(self, fname) -> None:
        """Inverse of :meth:`save_states` (and of the reference's): the
        states land on each context's device, each in the dtype the
        optimizer creates for its parameter, the update counters on this
        trainer's optimizer, the compression residuals on the store, the
        ZeRO shards on the engine (a plan that differs raises
        :class:`~mxnet_tpu_torch.optimizer.zero.PartitionMismatchError`).
        A missing or corrupt file raises :class:`MXNetError` naming
        it."""
        if not self._kv_initialized:
            self._init_kvstore()
        from ..checkpoint import apply_state_bytes, read_state_bytes

        states = read_state_bytes(fname, "Trainer.load_states")

        def _apply(blob):
            import pickle

            from ..optimizer.zero import PartitionMismatchError, _plan_digest

            comp_state = zero_blob = None
            try:
                obj = pickle.loads(blob)
            except Exception:  # noqa: BLE001 - not an envelope
                obj = None
            if isinstance(obj, dict) and obj.get(self._STATES_ENVELOPE):
                comp_state = obj.get("compression")
                zero_blob = obj.get("zero")
                blob = obj["updater"]
            if self._zero is not None:
                if zero_blob is None:
                    raise PartitionMismatchError(
                        f"{fname!r} holds replicated (unpartitioned) "
                        f"trainer state but this trainer runs partition "
                        f"plan [{self._zero.describe()}] — save under the "
                        "same partition mode or load into an unpartitioned "
                        "trainer")
                self._zero.check_compatible(zero_blob)
            elif zero_blob is not None:
                src = _plan_digest(zero_blob.get("plan", []),
                                   zero_blob.get("mode"),
                                   zero_blob.get("world"))
                raise PartitionMismatchError(
                    f"{fname!r} holds sharded optimizer state (plan "
                    f"[{src}]) but this trainer is unpartitioned — "
                    "construct the Trainer with the matching partition= "
                    "mode to restore it")
            comp = self._compression()
            if comp_state is not None:
                if comp is None:
                    raise MXNetError(
                        f"{fname!r} carries gradient-compression residual "
                        "state but this Trainer has no compression_params "
                        "configured")
                comp.set_state(comp_state)
            elif comp is not None:
                # a payload without residuals: clear the live ones, as a
                # fresh process loading the same file has none
                comp.set_state({})
            self._set_updater_states(blob)
            if self._zero is not None:
                self._zero.import_state([zero_blob])

        apply_state_bytes(states, _apply, fname, "Trainer.load_states")

    def load_states_resharded(self, fnames) -> None:
        """Gather per-rank sharded state files, possibly saved at another
        world size, and re-shard them into this trainer's partition plan
        (reference ``:679``). ``fnames`` must cover every rank of the
        source world; the updater's (leftover parameters') and the
        compression states come from the first file."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._zero is None:
            raise MXNetError(
                "load_states_resharded requires an active partition= mode; "
                "use load_states for replicated trainer state")
        import pickle

        from ..checkpoint import apply_state_bytes, read_state_bytes
        from ..optimizer.zero import PartitionMismatchError

        fnames = list(fnames)
        if not fnames:
            raise MXNetError("load_states_resharded: no state files")
        payloads, head = [], None
        for fname in fnames:
            states = read_state_bytes(fname, "Trainer.load_states_resharded")

            def _parse(blob, _fname=fname):
                obj = pickle.loads(blob)
                if not (isinstance(obj, dict)
                        and obj.get(self._STATES_ENVELOPE)
                        and obj.get("zero") is not None):
                    raise PartitionMismatchError(
                        f"{_fname!r} does not hold sharded trainer state "
                        "(no partition envelope) — it cannot join a "
                        "re-shard")
                return obj

            box = []
            apply_state_bytes(states, lambda b: box.append(_parse(b)),
                              fname, "Trainer.load_states_resharded")
            payloads.append(box[0]["zero"])
            if head is None:
                head = box[0]
        comp = self._compression()
        if comp is not None:
            comp.set_state(head.get("compression") or {})
        self._set_updater_states(head["updater"])
        self._zero.import_state(payloads)

    def _conform_states(self, ci: int = 0) -> None:
        """Cast each loaded state of context ``ci`` to the dtype, device
        and memory order the optimizer creates for its parameter (a bf16
        state travels as an f32 array)."""
        upd = self._updaters[ci]
        for i, st in list(upd.states.items()):
            if i >= len(self._params) or st is None:
                continue
            p = self._params[i]
            if p._var is None or ci >= len(p._copies):
                continue
            like = self._optimizer.create_state_multi_precision(
                i, NDArray(p._copies[ci].detach()))
            upd.states[i] = _conform(st, like)


def _conform(state, like):
    if isinstance(state, tuple) and isinstance(like, tuple):
        return tuple(_conform(s, t) for s, t in zip(state, like))
    if isinstance(state, NDArray) and isinstance(like, NDArray):
        ref = like._data
        if tuple(state.shape) != tuple(ref.shape):
            raise MXNetError(f"Trainer.load_states: a state of shape "
                             f"{tuple(state.shape)} for a parameter whose "
                             f"state has shape {tuple(ref.shape)}")
        out = torch.empty_like(ref)
        out.copy_(state._data)
        return NDArray(out)
    return state
