"""``mx.monitor.Monitor`` — debugging statistics of a model's arrays
(counterpart of ``mxnet_tpu/monitor.py``; reference
``python/mxnet/monitor.py``).

Every ``interval`` batches, ``toc()`` returns ``(step, name, stat)``
triples of ``stat_func`` (default: the mean absolute value, computed on
the host in numpy as the reference's) over what ``install``-ed models
hold at the step boundary, in the order of the reference's executor
monitor: the arguments (the forward's inputs, ``data`` or ``data0``,
``data1``..., then the parameters), the auxiliary states (the parameters
with ``grad_req="null"``: running statistics), the gradients
(``<name>_grad``) and the outputs (``output0``...). ``install`` takes a
Gluon ``Block``, whose inputs and outputs a forward hook records while a
batch is being collected (the port has no executors). ``pattern``
filters names; ``sort`` orders the triples by name.
"""
from __future__ import annotations

import logging
import re

import numpy as np

__all__ = ["Monitor"]


def _asnumpy(arr):
    if hasattr(arr, "asnumpy"):
        return arr.asnumpy()
    if hasattr(arr, "detach"):
        return arr.detach().float().cpu().numpy() \
            if str(arr.dtype) == "torch.bfloat16" \
            else arr.detach().cpu().numpy()
    return np.asarray(arr)


class _BlockTap:
    """A Block's arrays for the monitor: its parameters, and the inputs
    and outputs of its last forward while the monitor collects."""

    def __init__(self, block, monitor):
        self.block = block
        self.inputs = []
        self.outputs = []
        self._handle = block.register_forward_hook(self._hook)
        self._monitor = monitor

    def _hook(self, block, args, output):
        if not self._monitor.activated:
            return
        self.inputs = [a for a in args if hasattr(a, "shape")]
        outs = output if isinstance(output, (list, tuple)) else [output]
        self.outputs = [o for o in outs if hasattr(o, "shape")]

    def arrays(self):
        params = list(self.block.collect_params().items())
        args = [("data" if len(self.inputs) == 1 else f"data{i}", x)
                for i, x in enumerate(self.inputs)]
        args += [(n, p.data()) for n, p in params if p.grad_req != "null"]
        aux = [(n, p.data()) for n, p in params if p.grad_req == "null"]
        grads = [(n + "_grad", x.grad) for n, x in args[:len(self.inputs)]
                 if getattr(x, "grad", None) is not None]
        for n, p in params:
            if p.grad_req == "null":
                continue
            try:
                grads.append((n + "_grad", p.grad()))
            except Exception:  # noqa: BLE001 - no gradient buffer yet
                continue
        outs = [(f"output{i}", o) for i, o in enumerate(self.outputs)]
        return args + aux + grads + outs


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def stat_func(x):
                # the reference's default: mean(abs(x))
                return np.abs(x).mean()
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_pattern = re.compile(pattern)
        self.sort = sort

    def install(self, block):
        """Register a Block, snapshotted at toc(): a forward hook records
        its inputs and outputs."""
        if all(tap.block is not block for tap in self.exes):
            self.exes.append(_BlockTap(block, self))
        return block

    def tic(self):
        """Start collecting for this batch if the interval hits."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def _collect(self, name, arr):
        if arr is None or not self.re_pattern.match(name):
            return
        try:
            val = self.stat_func(_asnumpy(arr))
        except Exception as e:  # noqa: BLE001 - keep collecting
            val = f"<stat failed: {e}>"
        self.queue.append((self.step, name, val))

    def toc(self):
        """Collect the statistics of this batch; returns the triples."""
        if not self.activated:
            return []
        for tap in self.exes:
            for name, arr in tap.arrays():
                self._collect(name, arr)
        self.activated = False
        res = list(self.queue)
        if self.sort:
            res.sort(key=lambda t: t[1])
        self.queue = []
        return res

    def toc_print(self):
        """Collect and log (reference: Monitor.toc_print)."""
        for step, name, value in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, value)
