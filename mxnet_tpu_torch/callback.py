"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``;
reference ``python/mxnet/callback.py``).

``Speedometer`` (throughput every N batches, with an optional MFU line
against the card's dense bf16 peak), ``log_train_metric`` and
``ProgressBar`` follow the reference's ``BatchEndParam`` callback
contract, so user loops drive them unchanged. ``do_checkpoint`` saves
through the Module API, which is not ported yet: it raises.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar",
           "device_peak_flops"]

def device_peak_flops(device=None):
    """The dense bf16 peak FLOP/s of one card (``telemetry``'s: an H100
    SXM's 989e12), or None where it is not known (no card, another
    card); callers skip MFU then. ``device`` is accepted for the
    reference's signature; every card of a host is one model."""
    from .telemetry import _device_peak_flops

    return _device_peak_flops()


class Speedometer:
    """Log training speed (and optionally MFU) every ``frequent`` batches.

    Reference: ``callback.py::Speedometer``. With ``flops_per_sample``
    and a known card peak, an MFU percentage is appended.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True,
                 flops_per_sample=None, num_devices=None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.flops_per_sample = flops_per_sample
        # batch_size counts samples across ALL cards (global batch), so the
        # MFU denominator is the aggregate peak of the cards doing the
        # work; default: every card of the host
        self.num_devices = num_devices
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self._peak = None

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        mfu = ""
        if self.flops_per_sample:
            if self._peak is None:
                per_card = device_peak_flops() or 0.0
                if per_card:
                    import torch

                    n = self.num_devices or torch.cuda.device_count()
                    self._peak = per_card * n
                else:
                    self._peak = 0.0
            if self._peak:
                mfu = "\tMFU=%.1f%%" % (
                    100.0 * speed * self.flops_per_sample / self._peak)
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s"
            msg += "\t%s=%f" * len(name_value)
            logging.info(msg, param.epoch, count, speed, mfu,
                         *sum(name_value, ()))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, count, speed, mfu)
        self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback of the Module API (reference:
    ``callback.py::do_checkpoint`` → ``model.save_checkpoint``), which is
    not ported yet."""
    from .base import MXNetError

    raise MXNetError("callback.do_checkpoint saves through the Module API, "
                     "which is not ported yet (ROADMAP.md, port queue 1, "
                     "item 12); save with net.save_parameters or "
                     "mx.checkpoint.CheckpointManager")


def log_train_metric(period, auto_reset=False):
    """Batch-end callback: log the evaluation metric every ``period``."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class ProgressBar:
    """Text progress bar over total batch count (reference: ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
