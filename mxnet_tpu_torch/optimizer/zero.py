"""ZeRO-sharded optimizer state over the bucketed exchange (counterpart
of ``mxnet_tpu/optimizer/zero.py:82-900``; Rajbhandari et al., "ZeRO:
Memory Optimizations Toward Training Trillion Parameter Models", SC'20).

The replicated data-parallel step keeps every optimizer state tensor on
every rank. :class:`ZeroEngine` carves each planned bucket's flat layout
(``kvstore.bucketing.plan_buckets(partition=...)``) into ``world`` equal
contiguous shards, one per rank, and holds only the owned shards' state:

* **zero1**: the gradient bucket is reduce-scattered (each rank sums
  only its shard, :func:`~mxnet_tpu_torch.kvstore.comm.reduce_scatter`),
  the family's fused sweep (row 12's kernel on the card) updates the
  rank's shard, and the updated weights are all-gathered; the reduced
  gradient is all-gathered too and written back into the gradient
  buffers, so post-step inspection matches the replicated path;
* **zero2**: the same without the gradient write-back.

The sweep takes the shard as 1-D views of the members' slices that fall
in it (weights where they lie, the gradient shard, the state shard), so
``fused_optimizer.cu`` walks them in place, and the elementwise formula
on a slice is bit-equal to the same slice of the whole-member sweep.
Every element is summed in the one order of :mod:`..kvstore.comm`, so
zero1 and zero2 are bit-identical to the replicated, per-key and
bucketed exchanges at any world.

Modes: **mesh** over several contexts of one process (world = the
copies; each shard's state on its context's device) or over the
processes of a ``torch.distributed`` job (one context per process; world
= the processes); **virtual** on one context with an explicit (rank,
world) identity (``reconfigure``, ``MXNET_ZERO_RANK``/``MXNET_ZERO_WORLD``):
the update runs over the full state locally, and only serialization is
sharded: :meth:`ZeroEngine.export_state` emits the owned shard, and
:meth:`ZeroEngine.import_state` re-shards payloads saved at world N
into world M. The payloads and the partition manifest are the
reference's (numpy shards), so each package loads the other's.

The sgd, adam and adamw families shard; LAMB is refused (its trust-ratio
norms are sums over whole members). A multi-precision member (a bf16
weight with an f32 master), a sparse one and one whose weight is not
row-major stay replicated, as in the reference, counted in
``mxnet_kvstore_bucket_fallback_total``.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from .. import telemetry
from ..base import MXNetError
from ..kvstore import comm
from ..kvstore.bucketing import (PARTITION_MODES, ShardPlan,
                                 bucket_cap_bytes, pack, plan_buckets,
                                 shard_layout)
from . import multi_tensor as mt

__all__ = ["PartitionMismatchError", "ZeroEngine", "supported_family",
           "FALLBACK_FAMILY", "FALLBACK_MULTI_PRECISION", "FALLBACK_SPARSE",
           "FALLBACK_LAYOUT"]

STATE_VERSION = 1

FALLBACK_FAMILY = "zero_family"
FALLBACK_MULTI_PRECISION = "zero_multi_precision"
FALLBACK_SPARSE = "zero_sparse"
FALLBACK_LAYOUT = "zero_layout"

_NP_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16",
            torch.float16: "float16"}


class PartitionMismatchError(MXNetError):
    """Sharded optimizer state loaded at an incompatible partition plan
    (wrong mode, world or bucket layout, or sharded against
    replicated). The message names both plans; re-shard across world
    sizes on purpose with ``Trainer.load_states_resharded``."""


def supported_family(optimizer) -> Optional[str]:
    """The fused-sweep family name if this optimizer's update can run
    sharded, else None (LAMB's norms are sums over whole members)."""
    family = mt.family_of(optimizer)
    return family if family in ("sgd", "adam", "adamw") else None


def _plan_digest(plan_table, mode, world) -> str:
    nparams = sum(len(b["members"]) for b in plan_table)
    return f"{mode}@world={world}:{len(plan_table)}buckets/{nparams}params"


def _sizes_offsets(shapes):
    sizes = []
    for s in shapes:
        n = 1
        for d in s:
            n *= int(d)
        sizes.append(n)
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + n)
    return sizes, offsets


def _np_of(t: torch.Tensor) -> _np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


class _BucketState:
    """One planned ZeRO bucket: its layout and its state (``shards``:
    role -> {rank: 1-D shard tensor} in mesh mode; ``full``: role -> the
    whole padded buffer in virtual mode)."""

    __slots__ = ("indices", "shapes", "sizes", "offsets", "wdtype",
                 "gdtype", "sdtype", "plan", "nbytes", "shards", "full")

    def __init__(self, indices, shapes, wdtype, gdtype, sdtype, plan,
                 nbytes):
        self.indices: List[int] = list(indices)
        self.shapes: List[Tuple[int, ...]] = [tuple(s) for s in shapes]
        self.sizes, self.offsets = _sizes_offsets(self.shapes)
        self.wdtype = wdtype
        self.gdtype = gdtype
        self.sdtype = sdtype
        self.plan: ShardPlan = plan
        self.nbytes = int(nbytes)
        self.shards: Dict[str, Dict[int, torch.Tensor]] = {}
        self.full: Dict[str, torch.Tensor] = {}

    @property
    def total(self):
        return self.offsets[-1]

    def span(self, r: int) -> Tuple[int, int]:
        """[lo, hi) of rank ``r``'s shard within the unpadded layout."""
        lo, hi = self.plan.shard_range(r)
        return min(lo, self.total), min(hi, self.total)


class ZeroEngine:
    """Shard-partitioned optimizer sweep bound to one Trainer."""

    def __init__(self, trainer, mode: str, rank: Optional[int] = None,
                 world: Optional[int] = None):
        if mode not in PARTITION_MODES:
            raise MXNetError(
                f"unknown partition mode {mode!r}; expected one of "
                f"{PARTITION_MODES}")
        self._trainer = trainer
        self._mode = mode
        self._family = supported_family(trainer._optimizer)
        if self._family is None:
            raise MXNetError(
                f"partition={mode!r} requires a fused-sweep optimizer "
                f"family (sgd/adam/adamw); got "
                f"{type(trainer._optimizer).__name__}")
        self._explicit_rank = rank
        self._explicit_world = world
        self._ready = False
        self._mesh_mode = False
        self._process_mode = False
        self._rank = 0
        self._world = 1
        self._buckets: List[_BucketState] = []
        self._fallback: Dict[int, str] = {}
        self._devs: List[torch.device] = []
        # the flat gradient buffers of the buckets (pack), freed with
        # the engine
        self._flats: Dict = {}

    # -- identity ----------------------------------------------------------
    @property
    def mode(self) -> str:
        return self._mode

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world(self) -> int:
        return self._world

    @property
    def fallback_reasons(self) -> Dict[int, str]:
        """param index -> reason for params outside the sharded sweep."""
        self.ensure_ready()
        return dict(self._fallback)

    def eligible_indices(self) -> List[int]:
        self.ensure_ready()
        return sorted(i for b in self._buckets for i in b.indices)

    def _resolve_identity(self):
        from ..kvstore.kvstore import KVStoreTPUSync

        trainer = self._trainer
        ncopies = len(trainer._contexts)
        store = trainer._kvstore
        if comm._dist() is not None and isinstance(store, KVStoreTPUSync):
            if ncopies > 1:
                raise MXNetError(
                    f"partition={self._mode!r} across processes takes one "
                    f"context per process, not {ncopies}")
            w = comm.world()
            if self._explicit_world not in (None, w):
                raise MXNetError(
                    f"explicit partition world {self._explicit_world} "
                    f"conflicts with the {w} processes of the group")
            self._mesh_mode = self._process_mode = True
            self._world, self._rank = w, comm.rank()
            return
        if ncopies > 1:
            if not isinstance(store, KVStoreTPUSync):
                raise MXNetError(
                    f"partition={self._mode!r} with {ncopies} contexts "
                    "requires a collective kvstore (tpu_sync/nccl); got "
                    f"{type(store).__name__ if store else None}")
            if self._explicit_world not in (None, ncopies):
                raise MXNetError(
                    f"explicit partition world {self._explicit_world} "
                    f"conflicts with {ncopies} gradient copies (mesh mode "
                    "shards across the copies)")
            self._mesh_mode = True
            self._world, self._rank = ncopies, 0
            return
        world = self._explicit_world
        rank = self._explicit_rank
        if world is None:
            world = int(os.environ.get("MXNET_ZERO_WORLD", "1") or 1)
        if rank is None:
            rank = int(os.environ.get("MXNET_ZERO_RANK", "0") or 0)
        world, rank = int(world), int(rank)
        if world < 1 or not (0 <= rank < world):
            raise MXNetError(
                f"invalid partition identity rank={rank} world={world}")
        self._world, self._rank = world, rank

    def _classify(self):
        trainer = self._trainer
        o = trainer._optimizer
        eligible: List[int] = []
        fallback: Dict[int, str] = {}
        for i, p in enumerate(trainer._params):
            if p.grad_req == "null":
                continue
            if getattr(p, "_stype", "default") != "default" or \
                    getattr(p, "grad_stype", "default") != "default":
                fallback[i] = FALLBACK_SPARSE
            elif getattr(o, "multi_precision", False) and \
                    p.dtype in ("float16", "bfloat16"):
                fallback[i] = FALLBACK_MULTI_PRECISION
            elif not (p._var.is_contiguous() and mt.sweepable(
                    self._family, p._var, p._grad_tensor(), False)):
                fallback[i] = FALLBACK_LAYOUT
            else:
                eligible.append(i)
        return eligible, fallback

    def ensure_ready(self) -> None:
        """Plan the buckets and allocate the sharded state (once)."""
        if self._ready:
            return
        self._resolve_identity()
        trainer = self._trainer
        eligible, self._fallback = self._classify()
        if self._fallback:
            by_reason: Dict[str, int] = {}
            for reason in self._fallback.values():
                by_reason[reason] = by_reason.get(reason, 0) + 1
            for reason, n in sorted(by_reason.items()):
                telemetry.record_kv_bucket_fallback(reason, n)
            warnings.warn(
                f"{len(self._fallback)} parameter(s) fell outside the ZeRO "
                f"sharded sweep ("
                f"{', '.join(f'{r}:{n}' for r, n in sorted(by_reason.items()))}"
                ") — they update replicated through the per-param path",
                stacklevel=3)
        params = trainer._params
        if eligible:
            self._devs = [t.device for t in params[eligible[0]]._copies]
        store = trainer._kvstore
        cap = getattr(store, "_bucket_bytes", None) if store else None
        if not cap:
            cap = bucket_cap_bytes()
        entries = []
        for i in eligible:
            p = params[i]
            shape = tuple(int(d) for d in p.shape)
            w, g = p._var, p._grad_tensor()
            entries.append((i, shape, w.dtype, (w.dtype, g.dtype),
                            w.numel() * g.element_size()))
        sdt = {"adamw": lambda w: torch.float32}.get(self._family,
                                                     lambda w: w)
        self._flats = {}
        self._buckets = [
            _BucketState(b.indices, b.shapes, b.group[0], b.group[1],
                         sdt(b.group[0]), b.shard_plan, b.nbytes)
            for b in plan_buckets(entries, cap, partition=self._mode,
                                  world=self._world)]
        for bs in self._buckets:
            self._init_states(bs)
        self._record_state_bytes()
        self._ready = True

    def _owned_ranks(self) -> List[int]:
        """The ranks whose shard state this process holds."""
        if self._process_mode:
            return [self._rank]
        if self._mesh_mode or self._world == 1:
            return list(range(self._world))
        return [self._rank]

    def _shard_device(self, r: int) -> torch.device:
        if self._mesh_mode and not self._process_mode:
            return self._devs[r]
        return self._devs[0] if self._devs else torch.device("cpu")

    def _init_states(self, bs: _BucketState) -> None:
        for role in self._roles():
            if self._mesh_mode:
                bs.shards[role] = {
                    r: torch.zeros(bs.plan.shard_len, dtype=bs.sdtype,
                                   device=self._shard_device(r))
                    for r in self._owned_ranks()}
            else:
                bs.full[role] = torch.zeros(bs.plan.padded,
                                            dtype=bs.sdtype,
                                            device=self._shard_device(0))

    def _record_state_bytes(self) -> None:
        roles = self._roles()
        per_rank = replicated = 0
        for bs in self._buckets:
            isz = torch.empty((), dtype=bs.sdtype).element_size()
            per_rank += len(roles) * bs.plan.shard_len * isz
            replicated += len(roles) * bs.total * isz
        telemetry.record_optimizer_state_bytes(self._mode, per_rank)
        telemetry.record_optimizer_state_bytes("replicated", replicated)
        self._state_bytes = (per_rank, replicated)

    def _roles(self) -> Tuple[str, ...]:
        return mt.state_roles(self._family, dict(self._static_items()))

    def _static_items(self) -> tuple:
        return mt.family_static(self._trainer._optimizer, self._family)

    # -- the step ----------------------------------------------------------
    def step(self) -> None:
        """The sharded sweep over every partitioned bucket. Advances the
        optimizer's per-index update count once per step on every
        context's stream (the engine replaces both the exchange and the
        per-context update of its members)."""
        self.ensure_ready()
        o = self._trainer._optimizer
        for ci in range(max(1, len(self._trainer._updaters))):
            o._set_current_context(ci)
            for bs in self._buckets:
                for i in bs.indices:
                    o._update_count(i)
        o._set_current_context(0)
        for bs in self._buckets:
            vecs = mt.collect_scalars(o, self._family, bs.indices)
            if self._process_mode:
                self._step_process(bs, vecs)
            elif self._mesh_mode:
                self._step_mesh(bs, vecs)
            else:
                self._step_virtual(bs, vecs)
            telemetry.record_optimizer_dispatch("zero_sweep", 1)
            telemetry.record_optimizer_bucket(bs.nbytes, len(bs.indices))

    def _grads(self, bs, ci) -> List[torch.Tensor]:
        return [self._trainer._params[i]._grad_tensor(ci)
                for i in bs.indices]

    def _weights(self, bs, ci) -> List[torch.Tensor]:
        return [self._trainer._params[i]._copies[ci].detach()
                for i in bs.indices]

    def _bad_members(self, bs, g_full: torch.Tensor) -> set:
        """AdamW's members whose rescaled, clipped reduced gradient holds
        a value that is not finite (they keep weight and moments, as the
        sweep's per-member scan decides over the whole member)."""
        if self._family != "adamw":
            return set()
        o = self._trainer._optimizer
        clip = dict(self._static_items())["clip_gradient"]
        oks = []
        for j in range(len(bs.indices)):
            g32 = g_full[bs.offsets[j]:bs.offsets[j + 1]].float() \
                * o.rescale_grad
            if clip is not None and clip >= 0:
                g32 = torch.clamp(g32, -clip, clip)
            oks.append(torch.isfinite(g32).all())
        flags = torch.stack(oks).cpu().tolist()
        return {j for j, ok in enumerate(flags) if not ok}

    def _sweep(self, bs, lo, hi, weights, grad_of, states, vecs,
               bad=()) -> None:
        """One fused sweep over flat positions [lo, hi) of ``bs``: each
        member's slice there as a 1-D view of its weight, ``grad_of(j, a,
        b)`` its gradient over [a, b), and ``states`` (role -> 1-D tensor
        over [lo, hi))."""
        ins = {"w": [], "g": []}
        roles = self._roles()
        for role in roles:
            ins[role] = []
        lrs, wds = [], []
        for j in range(len(bs.indices)):
            o, o2 = bs.offsets[j], bs.offsets[j + 1]
            a, b = max(lo, o), min(hi, o2)
            if a >= b or j in bad:
                continue
            ins["w"].append(weights[j].view(-1)[a - o:b - o])
            ins["g"].append(grad_of(j, a, b))
            for role in roles:
                ins[role].append(states[role][a - lo:b - lo])
            lrs.append(vecs["lr"][j])
            wds.append(vecs["wd"][j])
        if ins["w"]:
            mt.packed_apply(self._family, self._static_items(), ins,
                            {"lr": lrs, "wd": wds},
                            self._trainer._optimizer.rescale_grad)

    def _step_virtual(self, bs, vecs) -> None:
        grads = self._grads(bs, 0)
        bad = set()
        if self._family == "adamw":
            bad = self._bad_members(bs, torch.cat(
                [g.reshape(-1) for g in grads]))

        def grad_of(j, a, b):
            o = bs.offsets[j]
            return grads[j].reshape(-1)[a - o:b - o]

        self._sweep(bs, 0, bs.total, self._weights(bs, 0), grad_of,
                    {r: t[:bs.total] for r, t in bs.full.items()}, vecs,
                    bad)

    def _step_mesh(self, bs, vecs) -> None:
        """Several contexts of one process: the copies' gradient buckets
        summed in context order, each context updating its shard, the
        updated slices copied to the other contexts."""
        n = self._world
        flats = [pack(self._grads(bs, c), self._flats,
                      slot=(tuple(bs.indices), c))
                 for c in range(n)]
        reduced = comm.local_sum(flats)
        if reduced is flats[0]:
            reduced = reduced.clone()
        telemetry.record_kv_collective("zero")
        bad = self._bad_members(bs, reduced)
        weights = [self._weights(bs, c) for c in range(n)]
        for r in range(n):
            lo, hi = bs.span(r)
            g_shard = reduced[lo:hi].to(self._devs[r])
            self._sweep(bs, lo, hi, weights[r],
                        lambda j, a, b: g_shard[a - lo:b - lo],
                        {role: s[r][:hi - lo]
                         for role, s in bs.shards.items()}, vecs, bad)
        with torch.no_grad():
            for r in range(n):
                lo, hi = bs.span(r)
                for j in range(len(bs.indices)):
                    o, o2 = bs.offsets[j], bs.offsets[j + 1]
                    a, b = max(lo, o), min(hi, o2)
                    if a >= b:
                        continue
                    src = weights[r][j].view(-1)[a - o:b - o]
                    for c in range(n):
                        if c != r:
                            weights[c][j].view(-1)[a - o:b - o].copy_(src)
            if self._mode == "zero1":
                for c in range(n):
                    full = reduced if reduced.device == self._devs[c] \
                        else reduced.to(self._devs[c])
                    for j, g in enumerate(self._grads(bs, c)):
                        g.view(-1).copy_(
                            full[bs.offsets[j]:bs.offsets[j + 1]])

    def _step_process(self, bs, vecs) -> None:
        """One context per process: reduce-scatter the gradient bucket,
        update this rank's shard, all-gather the weights (and, for zero1
        or AdamW's scan, the reduced gradient)."""
        r = self._rank
        flat = pack(self._grads(bs, 0), self._flats,
                    slot=(tuple(bs.indices), 0))
        g_shard = comm.reduce_scatter(flat)
        telemetry.record_kv_collective("zero")
        g_full = None
        if self._mode == "zero1" or self._family == "adamw":
            g_full = comm.all_gather(g_shard, bs.total)
        bad = self._bad_members(bs, g_full) if g_full is not None else set()
        lo, hi = bs.span(r)
        weights = self._weights(bs, 0)
        self._sweep(bs, lo, hi, weights,
                    lambda j, a, b: g_shard[a - lo:b - lo],
                    {role: s[r][:hi - lo] for role, s in bs.shards.items()},
                    vecs, bad)
        with torch.no_grad():
            wbuf = torch.zeros(bs.plan.shard_len, dtype=bs.wdtype,
                               device=weights[0].device)
            for j in range(len(bs.indices)):
                o, o2 = bs.offsets[j], bs.offsets[j + 1]
                a, b = max(lo, o), min(hi, o2)
                if a < b:
                    wbuf[a - lo:b - lo].copy_(weights[j].view(-1)[a - o:b - o])
            w_full = comm.all_gather(wbuf, bs.total)
            for j, w in enumerate(weights):
                w.view(-1).copy_(w_full[bs.offsets[j]:bs.offsets[j + 1]])
            if self._mode == "zero1":
                for j, g in enumerate(self._grads(bs, 0)):
                    g.view(-1).copy_(g_full[bs.offsets[j]:bs.offsets[j + 1]])

    # -- elastic re-identity ----------------------------------------------
    def reconfigure(self, rank: int, world: int) -> None:
        """Adopt a new (rank, world) identity: virtual mode only (the
        state is whole locally; only the serialization carve changes)."""
        self.ensure_ready()
        rank, world = int(rank), int(world)
        if self._mesh_mode:
            if world != self._world:
                raise MXNetError(
                    f"cannot reconfigure a mesh-mode partition (world "
                    f"{self._world}) to world {world}")
            return
        if world < 1 or not (0 <= rank < world):
            raise MXNetError(
                f"invalid partition identity rank={rank} world={world}")
        if world == self._world and rank == self._rank:
            return
        self._rank, self._world = rank, world
        for bs in self._buckets:
            old = bs.plan
            bs.plan = shard_layout(self._mode, bs.total, world)
            if bs.plan.padded != old.padded:
                for role, buf in list(bs.full.items()):
                    new = torch.zeros(bs.plan.padded, dtype=buf.dtype,
                                      device=buf.device)
                    new[:bs.total].copy_(buf[:bs.total])
                    bs.full[role] = new
        self._record_state_bytes()

    # -- serialization -----------------------------------------------------
    def describe(self) -> str:
        self.ensure_ready()
        return _plan_digest(self._plan_table(), self._mode, self._world)

    def _plan_table(self):
        return [{"members": list(bs.indices),
                 "shapes": [list(s) for s in bs.shapes],
                 "wdtype": _NP_NAME[bs.wdtype],
                 "total": bs.total,
                 "padded": bs.plan.padded,
                 "shard_len": bs.plan.shard_len} for bs in self._buckets]

    def partition_manifest(self) -> dict:
        """Plan metadata (no tensors) for checkpoint manifests."""
        self.ensure_ready()
        return {"version": STATE_VERSION, "mode": self._mode,
                "world": self._world, "rank": self._rank,
                "family": self._family, "digest": self.describe(),
                "plan": self._plan_table()}

    def export_state(self, all_ranks: bool = False) -> dict:
        """The sharded state payload (numpy): the shards this process
        owns (every rank's in-process, this rank's across processes and
        in virtual mode, unless ``all_ranks`` in virtual mode)."""
        self.ensure_ready()
        roles = self._roles()
        owned = list(range(self._world)) if (
            all_ranks and not self._mesh_mode) else self._owned_ranks()
        shards: Dict[int, Dict[int, Dict[str, object]]] = {}
        for bid, bs in enumerate(self._buckets):
            per_rank = {r: {} for r in owned}
            for role in roles:
                if self._mesh_mode:
                    for r in owned:
                        per_rank[r][role] = _np_of(bs.shards[role][r])
                else:
                    full = _np_of(bs.full[role])
                    for r in owned:
                        lo, hi = bs.plan.shard_range(r)
                        per_rank[r][role] = full[lo:hi].copy()
            shards[bid] = per_rank
        o = self._trainer._optimizer
        clock = {"num_update": int(o.num_update),
                 "index_update_count": {
                     int(i): int(o._index_update_count[i])
                     for bs in self._buckets for i in bs.indices
                     if i in o._index_update_count}}
        return {"version": STATE_VERSION, "mode": self._mode,
                "world": self._world, "family": self._family,
                "roles": list(roles), "plan": self._plan_table(),
                "owned": owned, "clock": clock, "shards": shards}

    def check_compatible(self, payload: dict) -> None:
        """Raise :class:`PartitionMismatchError` unless ``payload`` was
        exported at exactly this engine's partition plan."""
        self.ensure_ready()
        src = _plan_digest(payload.get("plan", []), payload.get("mode"),
                           payload.get("world"))
        if payload.get("mode") != self._mode or \
                int(payload.get("world", -1)) != self._world or \
                payload.get("plan") != self._plan_table():
            raise PartitionMismatchError(
                f"sharded optimizer state was saved under partition plan "
                f"[{src}] but this trainer runs plan [{self.describe()}]; "
                "use Trainer.load_states_resharded to re-shard across "
                "plans")

    def import_state(self, payloads: Sequence[dict]) -> None:
        """Merge per-rank payloads, possibly saved at another world size
        or bucket layout, and re-shard them into the current plan. Every
        rank of the source world must appear in some payload; the remap
        runs member by member, so any change of world or layout re-shards
        losslessly."""
        self.ensure_ready()
        if not payloads:
            raise MXNetError("import_state: no payloads given")
        head = payloads[0]
        roles = self._roles()
        if head.get("family") != self._family:
            raise PartitionMismatchError(
                f"sharded state family {head.get('family')!r} does not "
                f"match this trainer's optimizer family {self._family!r}")
        src_plan = head.get("plan")
        src_world = int(head.get("world", 0))
        for p in payloads[1:]:
            if p.get("plan") != src_plan or \
                    int(p.get("world", 0)) != src_world:
                raise PartitionMismatchError(
                    "import_state payloads disagree on the source partition "
                    "plan — they must all come from the same checkpoint "
                    "step")
        src_members = {int(i): (tuple(int(d) for d in s), b["wdtype"])
                       for b in src_plan
                       for i, s in zip(b["members"], b["shapes"])}
        cur_members = {int(i): (tuple(s), _NP_NAME[bs.wdtype])
                       for bs in self._buckets
                       for i, s in zip(bs.indices, bs.shapes)}
        if src_members != cur_members:
            raise PartitionMismatchError(
                f"sharded state members do not match this trainer: saved "
                f"{len(src_members)} member(s), trainer has "
                f"{len(cur_members)} — shapes/dtypes/indices must agree "
                "(same model) to re-shard")
        merged: Dict[int, Dict[int, Dict[str, object]]] = {}
        for p in payloads:
            for bid, per_rank in p.get("shards", {}).items():
                dst = merged.setdefault(int(bid), {})
                for r, role_map in per_rank.items():
                    dst.setdefault(int(r), role_map)
        member_state: Dict[int, Dict[str, _np.ndarray]] = {}
        for bid, b in enumerate(src_plan):
            per_rank = merged.get(bid, {})
            missing = [r for r in range(src_world) if r not in per_rank]
            if missing:
                raise PartitionMismatchError(
                    f"cannot re-shard optimizer state: source world "
                    f"{src_world} but shard(s) for rank(s) {missing} of "
                    f"bucket {bid} are missing — gather every rank's "
                    "bundle first")
            _, offsets = _sizes_offsets([tuple(s) for s in b["shapes"]])
            for role in roles:
                full = _np.concatenate(
                    [_np.asarray(per_rank[r][role], _np.float32)
                     for r in range(src_world)])[:b["total"]]
                for i, o, o2 in zip(b["members"], offsets[:-1],
                                    offsets[1:]):
                    member_state.setdefault(int(i), {})[role] = full[o:o2]
        for bs in self._buckets:
            for role in roles:
                full = _np.zeros(bs.plan.padded, _np.float32)
                off = 0
                for i, n in zip(bs.indices, bs.sizes):
                    full[off:off + n] = member_state[i][role]
                    off += n
                t = torch.from_numpy(full).to(bs.sdtype)
                if self._mesh_mode:
                    sl = bs.plan.shard_len
                    bs.shards[role] = {
                        r: t[r * sl:(r + 1) * sl].to(
                            self._shard_device(r), copy=True)
                        for r in self._owned_ranks()}
                else:
                    bs.full[role] = t.to(self._shard_device(0), copy=True)
        clock = head.get("clock") or {}
        o = self._trainer._optimizer
        if clock:
            o.num_update = max(int(o.num_update),
                               int(clock.get("num_update", 0)))
            for i, c in (clock.get("index_update_count") or {}).items():
                o._index_update_count[int(i)] = int(c)
                o._count_baseline[int(i)] = int(c)
