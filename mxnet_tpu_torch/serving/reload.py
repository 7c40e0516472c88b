"""Zero-downtime model hot-reload for the serving stack.

Counterpart of ``mxnet_tpu/serving/reload.py``, copied whole. On the
port a reload swaps the tenant's block at once and its decode engine
takes the new weights at the scheduler's next completion boundary,
recapturing its decode graphs (``Server._decode_tick``).

Protocol (the "old graph serves until the new one is warmed" contract):

1. the watcher thread ticks ``CheckpointManager.poll_newest(tag)`` — a
   one-``stat`` no-change fast path, full manifest re-validation only
   when a bundle's commit record actually moved;
2. on a new valid bundle it calls ``Server.reload``: the user's
   ``model_factory(bundle_path)`` builds a fresh block (on the server's
   device, weights loaded from the bundle), and only then is it swapped
   in — requests dispatched while it builds keep running on the OLD
   block;
3. a failed reload (corrupt bundle, factory bug) is contained: the
   error is recorded (``mxnet_serving_reloads_total{outcome="error"}``),
   the old model keeps serving, and the watcher keeps polling —
   transient failures additionally retry inside ``fault.retry_call``
   at site ``serving.reload``.

``model_factory`` receives the BUNDLE DIRECTORY (not a file): load
whatever the deployment needs from it, typically::

    def factory(path):
        net = llama_3_8b(dtype=torch.bfloat16)
        net.load_parameters(os.path.join(path, "params.params"))
        return net
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

from ..base import MXNetError

__all__ = ["ReloadWatcher"]

_log = logging.getLogger(__name__)


class ReloadWatcher:
    """Poll a CheckpointManager; hot-reload the server on new bundles.

    The first poll is PRIMED away at :meth:`start`: the bundle the
    server was launched from must not trigger an immediate no-op
    reload — only bundles committed after the watcher starts do.
    """

    def __init__(self, server, manager, model_factory,
                 interval_s: float = 0.5, tag: str = "serve"):
        if interval_s <= 0:
            raise MXNetError(
                f"reload poll interval must be > 0, got {interval_s}")
        self.server = server
        self.manager = manager
        self.model_factory = model_factory
        self.interval_s = float(interval_s)
        self.tag = tag
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ReloadWatcher":
        if self._thread is not None:
            return self
        # prime: the currently-newest bundle is the one already serving
        self.manager.poll_newest(self.tag)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.server.name}-reload",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise MXNetError(
                    f"{self.server.name}: reload watcher did not exit "
                    f"within {timeout}s (model build/warmup in flight?)")
            self._thread = None

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                step = self.manager.poll_newest(self.tag)
            except Exception:  # noqa: BLE001 - keep serving, keep polling
                _log.exception("%s: checkpoint poll failed", self.server.name)
                continue
            if step is None:
                continue
            try:
                self.server.reload(self.manager, self.model_factory,
                                   step=step)
                _log.info("%s: hot-reloaded model from step %d",
                          self.server.name, step)
            except Exception:  # noqa: BLE001 - old model keeps serving
                _log.exception("%s: hot reload of step %d failed; "
                               "previous model keeps serving",
                               self.server.name, step)
                # the poll already consumed this bundle's change event —
                # forget it so the next tick retries instead of serving
                # stale weights until a NEWER bundle happens to land
                self.manager.poll_reset(self.tag)
