"""``mx.checkpoint`` — crash-safe checkpointing.

Counterpart of ``mxnet_tpu/checkpoint.py``: :func:`atomic_write` and
:class:`CheckpointManager` write and read the same bundles, file for
file. A bundle is a directory ``{prefix}-{step:08d}/`` holding
``params.params`` (the ``.params`` format, byte for byte the
reference's, under the reference's structural names), ``trainer.states``
(``Trainer.save_states``: the ``Updater``'s v2 states), ``rng.pkl``
(:func:`~mxnet_tpu_torch.random_state.checkpoint_state`), ``meta.json``
and ``MANIFEST.json``, written last with the sha256 of every payload
file; the bundle is staged in a temporary directory and committed with
one ``os.replace``. Each package loads the other's bundles.
:func:`read_state_bytes` and :func:`apply_state_bytes` are the error
contract of ``Trainer.load_states``.

A ZeRO-partitioned trainer's bundle also holds ``zero.json``, its
partition plan (mode, world, rank, bucket layout; reference
``checkpoint.py:488``), so that rejoin tooling can choose which rank
bundles to gather before unpickling any tensor; its ``trainer.states``
is that rank's shard file (``states_path``), the unit
``Trainer.load_states_resharded`` gathers.

Telemetry: ``mxnet_checkpoint_write_seconds``. Fault sites:
``checkpoint.write`` (every atomic commit), ``checkpoint.read`` (every
manifest read) — see :mod:`mxnet_tpu_torch.fault`.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import shutil
import tempfile
import time
from typing import Dict, List, Optional

from . import fault, telemetry
from .base import MXNetError
from .fault import _state as _fault_state

__all__ = ["atomic_write", "read_state_bytes", "apply_state_bytes",
           "CheckpointManager", "MANIFEST_NAME", "FORMAT_VERSION"]

MANIFEST_NAME = "MANIFEST.json"
FORMAT_VERSION = 1

_PARAMS_FILE = "params.params"
_STATES_FILE = "trainer.states"
_RNG_FILE = "rng.pkl"
# the partition plan of a ZeRO-sharded trainer.states
_ZERO_FILE = "zero.json"
_META_FILE = "meta.json"


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename into it survives power loss.
    Best-effort: not all filesystems allow opening directories."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data: bytes) -> None:
    """Commit ``data`` to ``path`` atomically: temp file in the same
    directory + flush + fsync + ``os.replace`` + directory fsync.
    Readers see the old content or the new content, never a torn file.
    Fault site ``checkpoint.write`` fires before any byte is written, so
    an injected crash leaves the previous content untouched."""
    if _fault_state.enabled:
        fault.check("checkpoint.write", path)
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def read_state_bytes(fname: str, context: str) -> bytes:
    """Read an optimizer-state file, a failure raised as
    :class:`MXNetError` naming the file."""
    try:
        with open(fname, "rb") as f:
            return f.read()
    except OSError as e:
        raise MXNetError(
            f"{context}: cannot read optimizer state file {fname!r}: "
            f"{e}") from e


def apply_state_bytes(states: bytes, apply, fname: str,
                      context: str) -> None:
    """Run ``apply(states)`` (an ``Updater.set_states``-like consumer),
    a corrupt payload raised as :class:`MXNetError` naming the file; an
    ``MXNetError`` of the consumer passes through as it is."""
    try:
        apply(states)
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError(
            f"{context}: {fname!r} is not a valid optimizer state file "
            f"(corrupt or wrong format): {e}") from e


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    """Crash-safe, manifest-tracked, last-K checkpoint bundles.

    ::

        mgr = mx.checkpoint.CheckpointManager("ckpts", keep_last=3)
        for step, batch in enumerate(loader):
            ...
            if step % 100 == 0:
                mgr.save(step, params=net, epoch=epoch)

        # after a crash, in a fresh process:
        meta = mgr.restore(block=net)   # newest valid: params + RNG
        start = meta["step"] + 1

    ``save`` stages the bundle in a temp directory and commits it with
    one ``os.replace``; a SIGKILL at ANY point leaves the previous
    checkpoint the newest valid one. Re-saving an existing step replaces
    it. Retention removes all but the newest ``keep_last`` valid bundles
    (and invalid debris older than the newest valid).
    """

    def __init__(self, directory: str, prefix: str = "ckpt",
                 keep_last: int = 3):
        if keep_last < 1:
            raise MXNetError(
                f"keep_last must be >= 1, got {keep_last}")
        if not re.fullmatch(r"[A-Za-z0-9._-]+", prefix):
            raise MXNetError(
                f"checkpoint prefix {prefix!r} must be filename-safe "
                "([A-Za-z0-9._-])")
        self.directory = os.fspath(directory)
        self.prefix = prefix
        self.keep_last = int(keep_last)
        self._pat = re.compile(re.escape(prefix) + r"-(\d{8})$")
        # poll_newest change-detection state, keyed by caller tag
        self._poll_state: Dict[str, Dict] = {}
        os.makedirs(self.directory, exist_ok=True)

    # -- naming --------------------------------------------------------
    def _name(self, step: int) -> str:
        return f"{self.prefix}-{int(step):08d}"

    def path(self, step: int) -> str:
        """Bundle directory for ``step`` (whether or not it exists)."""
        return os.path.join(self.directory, self._name(step))

    def _scan(self) -> List[int]:
        """All steps with a bundle directory present (validity unchecked),
        newest first."""
        steps = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        for e in entries:
            m = self._pat.fullmatch(e)
            if m and os.path.isdir(os.path.join(self.directory, e)):
                steps.append(int(m.group(1)))
        return sorted(steps, reverse=True)

    # -- validation ----------------------------------------------------
    def _read_manifest(self, step: int) -> Optional[Dict]:
        p = os.path.join(self.path(step), MANIFEST_NAME)
        if _fault_state.enabled:
            fault.check("checkpoint.read", p)
        try:
            with open(p, "rb") as f:
                return json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError, UnicodeDecodeError):
            return None

    def is_valid(self, step: int) -> bool:
        """True iff the bundle's manifest exists and every payload file
        matches its recorded sha256 and size."""
        man = self._read_manifest(step)
        if not isinstance(man, dict) or "files" not in man:
            return False
        root = self.path(step)
        for fname, rec in man["files"].items():
            fp = os.path.join(root, fname)
            try:
                if os.path.getsize(fp) != rec["bytes"]:
                    return False
                if _sha256_file(fp) != rec["sha256"]:
                    return False
            except (OSError, KeyError, TypeError):
                return False
        return True

    def steps(self) -> List[int]:
        """Checksum-valid checkpoint steps, newest first."""
        return [s for s in self._scan() if self.is_valid(s)]

    def latest_step(self) -> Optional[int]:
        """Newest checksum-valid step, or None. Corrupt/partial bundles
        are skipped, not fatal — that is the whole point."""
        for s in self._scan():
            if self.is_valid(s):
                return s
        return None

    def _manifest_sig(self, step: int) -> Optional[tuple]:
        """Cheap identity of a bundle's commit record: one stat() of its
        manifest. The manifest is always written last and atomically, so
        (step, mtime_ns, size) changing is necessary AND sufficient for
        the bundle's content having changed."""
        try:
            st = os.stat(os.path.join(self.path(step), MANIFEST_NAME))
        except OSError:
            return None
        return (step, st.st_mtime_ns, st.st_size)

    def poll_newest(self, tag: str = "default") -> Optional[int]:
        """Return the newest valid step IFF it changed since the last
        poll with this ``tag``; None when nothing new (including "still
        no checkpoint"). The hot-reload watcher's tick primitive: the
        no-change path is one ``listdir`` + one ``stat`` — full manifest
        re-hashing (:meth:`is_valid` over every payload file) only runs
        when a bundle's commit record actually moved. Each ``tag`` keeps
        independent state, so several watchers can share one manager.
        The first poll with a tag reports an existing checkpoint as a
        change; prime the tag with one discarded poll to watch for
        *subsequent* checkpoints only."""
        committed = [s for s in self._scan() if self._has_manifest(s)]
        commit_sig = self._manifest_sig(committed[0]) if committed else None
        prev = self._poll_state.get(tag)
        if prev is not None and prev["commit_sig"] == commit_sig:
            return None
        # the newest committed bundle moved (or first poll): pay one full
        # validation pass to find the newest VALID step
        step = self.latest_step()
        valid_sig = self._manifest_sig(step) if step is not None else None
        changed = (prev is None or step != prev["valid_step"]
                   or valid_sig != prev["valid_sig"])
        self._poll_state[tag] = {"commit_sig": commit_sig,
                                 "valid_step": step,
                                 "valid_sig": valid_sig}
        return step if (changed and step is not None) else None

    def poll_reset(self, tag: str = "default") -> None:
        """Forget ``tag``'s poll state: the next :meth:`poll_newest`
        reports the newest valid bundle again. A consumer that FAILED to
        act on a reported change calls this so the change is re-offered
        next tick instead of being lost until a newer bundle lands."""
        self._poll_state.pop(tag, None)

    # -- write ---------------------------------------------------------
    def _param_payload(self, params) -> Dict:
        """Normalize ``params`` (a Block, or a dict of tensors, NDArrays
        or Parameters) into a name -> NDArray dict on the CPU for
        serialization; a Block's names are its structural names
        (``Block._collect_params_with_prefix``)."""
        import torch

        from .gluon.parameter import Parameter
        from .ndarray.ndarray import NDArray

        if hasattr(params, "_collect_params_with_prefix"):
            params = params._collect_params_with_prefix()
        if not isinstance(params, dict):
            raise MXNetError(
                "CheckpointManager.save params must be a Block or a dict "
                f"of tensors/NDArrays/Parameters, got {type(params)}")
        out = {}
        for name, v in params.items():
            if isinstance(v, Parameter):
                v = v.data()
            if isinstance(v, NDArray):
                v = v._data
            if not isinstance(v, torch.Tensor):
                raise MXNetError(f"CheckpointManager.save: {name!r} is a "
                                 f"{type(v).__name__}, not an array")
            out[name] = NDArray(v.detach().cpu())
        return out

    # staging dirs younger than this are presumed to belong to a LIVE
    # writer sharing the directory and are left alone (the same guard
    # _gc applies to committed debris); older ones are crash leftovers
    _STAGING_SWEEP_AGE_S = 3600.0

    def _clean_tmp(self) -> None:
        """Remove staging leftovers from crashed writers (best-effort).
        Age-gated: a fresh staging dir may be another writer's in-flight
        bundle — sweeping it would make that writer's save fail
        spuriously mid-write."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        now = time.time()
        for e in entries:
            if e.startswith("." + self.prefix + "-") and ".staging-" in e:
                p = os.path.join(self.directory, e)
                try:
                    age = now - os.path.getmtime(p)
                except OSError:
                    continue
                if age > self._STAGING_SWEEP_AGE_S:
                    shutil.rmtree(p, ignore_errors=True)

    def save(self, step: int, params=None, trainer=None, epoch=None,
             extra=None) -> str:
        """Write + commit one bundle; returns the committed path.

        ``params``: Block or name -> tensor/NDArray/Parameter dict.
        ``trainer``: a Gluon Trainer whose updater states go into
        ``trainer.states`` (``Trainer.save_states``). The RNG streams
        (``random_state.checkpoint_state()``) are always captured.
        ``extra`` must be JSON-serializable.
        """
        t0 = time.perf_counter()
        step = int(step)
        if step < 0:
            raise MXNetError(f"checkpoint step must be >= 0, got {step}")
        self._clean_tmp()
        final = self.path(step)
        tmp = tempfile.mkdtemp(
            dir=self.directory,
            prefix=f".{self._name(step)}.staging-")
        try:
            written: List[str] = []
            if params is not None:
                from .ndarray import serialization

                serialization.save(os.path.join(tmp, _PARAMS_FILE),
                                   self._param_payload(params))
                written.append(_PARAMS_FILE)
            if trainer is not None:
                trainer.save_states(os.path.join(tmp, _STATES_FILE))
                written.append(_STATES_FILE)
                zman = trainer.partition_manifest() \
                    if hasattr(trainer, "partition_manifest") else None
                if zman is not None:
                    atomic_write(
                        os.path.join(tmp, _ZERO_FILE),
                        json.dumps(zman, indent=1).encode("utf-8"))
                    written.append(_ZERO_FILE)
            from . import random_state

            atomic_write(os.path.join(tmp, _RNG_FILE),
                         pickle.dumps(random_state.checkpoint_state()))
            written.append(_RNG_FILE)
            meta = {"format": FORMAT_VERSION, "step": step,
                    "epoch": epoch, "extra": extra,
                    "created_unix": time.time()}
            atomic_write(os.path.join(tmp, _META_FILE),
                         json.dumps(meta, indent=1).encode("utf-8"))
            written.append(_META_FILE)
            manifest = {
                "format": FORMAT_VERSION, "step": step,
                "files": {
                    f: {"sha256": _sha256_file(os.path.join(tmp, f)),
                        "bytes": os.path.getsize(os.path.join(tmp, f))}
                    for f in written}}
            # the commit record — written LAST: a bundle without it (or
            # with stale checksums) is invisible to discovery
            atomic_write(os.path.join(tmp, MANIFEST_NAME),
                         json.dumps(manifest, indent=1).encode("utf-8"))
            _fsync_dir(tmp)
            if os.path.isdir(final):
                # re-save of an existing step: replace the old bundle.
                # (os.replace cannot overwrite a non-empty dir; the gap
                # between rmtree and rename is the one non-atomic window,
                # and only for same-step re-saves.)
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(self.directory)
        telemetry.record_checkpoint_write(time.perf_counter() - t0)
        self._gc()
        return final

    def _has_manifest(self, step: int) -> bool:
        return os.path.isfile(os.path.join(self.path(step), MANIFEST_NAME))

    def _gc(self) -> None:
        """Retention: keep the newest ``keep_last`` committed bundles
        (manifest present — the cheap commit marker; full checksum
        validation is the RESUME path's job, re-hashing every retained
        gigabyte-scale bundle on every save would make checkpointing an
        I/O hotspot); drop older committed ones and any manifest-less
        debris older than the newest committed bundle (never newer — it
        may be another writer's in-flight work)."""
        committed = [s for s in self._scan() if self._has_manifest(s)]
        keep = set(committed[:self.keep_last])
        newest = committed[0] if committed else None
        for s in self._scan():
            if s in keep:
                continue
            if s in committed or (newest is not None and s < newest):
                shutil.rmtree(self.path(s), ignore_errors=True)

    # -- read ----------------------------------------------------------
    def _resolve_valid(self, step: Optional[int]):
        """Pick the target step (newest valid when None), checksum-check
        it once, and return ``(step, manifest)``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise MXNetError(
                    f"no checksum-valid checkpoint found under "
                    f"{self.directory!r} (prefix {self.prefix!r})")
        elif not self.is_valid(step):
            raise MXNetError(
                f"checkpoint step {step} under {self.directory!r} is "
                f"missing or fails checksum validation")
        return step, self._read_manifest(step)

    def load(self, step: Optional[int] = None) -> Dict:
        """Load a bundle's payloads (newest valid when ``step`` is None).

        Returns ``{"step", "epoch", "extra", "path", "params" (dict of
        CPU NDArrays or None), "trainer_states" (bytes or None), "rng"
        (random_state snapshot or None)}``. Raises :class:`MXNetError`
        when no valid checkpoint exists or ``step`` is invalid/corrupt.
        """
        step, man = self._resolve_valid(step)
        root = self.path(step)
        out: Dict = {"step": step, "path": root, "params": None,
                     "trainer_states": None, "rng": None,
                     "epoch": None, "extra": None}
        files = man["files"]
        if _META_FILE in files:
            with open(os.path.join(root, _META_FILE), "rb") as f:
                meta = json.loads(f.read().decode("utf-8"))
            out["epoch"] = meta.get("epoch")
            out["extra"] = meta.get("extra")
        if _PARAMS_FILE in files:
            from .ndarray import serialization

            from .context import cpu

            out["params"] = serialization.load(
                os.path.join(root, _PARAMS_FILE), ctx=cpu())
        if _STATES_FILE in files:
            with open(os.path.join(root, _STATES_FILE), "rb") as f:
                out["trainer_states"] = f.read()
        if _RNG_FILE in files:
            if _fault_state.enabled:
                fault.check("checkpoint.read",
                            os.path.join(root, _RNG_FILE))
            with open(os.path.join(root, _RNG_FILE), "rb") as f:
                out["rng"] = pickle.loads(f.read())
        out["zero"] = self.partition_manifest(step)
        return out

    def partition_manifest(self, step: int) -> Optional[Dict]:
        """The bundle's ZeRO partition plan (``zero.json``), or None for
        a replicated bundle. ``step`` names an existing bundle; no
        checksum pass runs here."""
        p = os.path.join(self.path(step), _ZERO_FILE)
        try:
            with open(p, "rb") as f:
                return json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError, UnicodeDecodeError):
            return None

    def states_path(self, step: int) -> str:
        """Path of the bundle's ``trainer.states`` (this rank's shard
        file under ZeRO)."""
        return os.path.join(self.path(step), _STATES_FILE)

    def restore(self, block=None, trainer=None, restore_rng: bool = True,
                step: Optional[int] = None) -> Dict:
        """One-call resume: pick the newest valid bundle (or ``step``)
        and apply it — params into ``block`` (``Block.load_parameters``:
        copied in place onto the block's own device, the card unless
        the block was built on the CPU), optimizer states into
        ``trainer`` (``Trainer.load_states``) and the RNG streams back
        into ``mx.random``. Returns the bundle's meta dict (``step``,
        ``epoch``, ``extra``, ``path``)."""
        step, man = self._resolve_valid(step)
        root = self.path(step)
        files = man["files"]
        if block is not None:
            if _PARAMS_FILE not in files:
                raise MXNetError(
                    f"checkpoint {root!r} holds no params.params to "
                    "restore the block from")
            block.load_parameters(os.path.join(root, _PARAMS_FILE))
        if trainer is not None:
            if _STATES_FILE not in files:
                raise MXNetError(
                    f"checkpoint {root!r} holds no trainer.states to "
                    "restore the trainer from")
            trainer.load_states(os.path.join(root, _STATES_FILE))
        if restore_rng and _RNG_FILE in files:
            if _fault_state.enabled:
                fault.check("checkpoint.read",
                            os.path.join(root, _RNG_FILE))
            from . import random_state

            with open(os.path.join(root, _RNG_FILE), "rb") as f:
                random_state.restore_checkpoint_state(pickle.loads(f.read()))
        out = {"step": step, "epoch": None, "extra": None, "path": root}
        if _META_FILE in files:
            with open(os.path.join(root, _META_FILE), "rb") as f:
                meta = json.loads(f.read().decode("utf-8"))
            out["epoch"] = meta.get("epoch")
            out["extra"] = meta.get("extra")
        return out
