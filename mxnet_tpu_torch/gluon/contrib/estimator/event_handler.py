"""Estimator event handlers (a copy of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py:22-241``, which
imports nothing of JAX): the TrainBegin/TrainEnd/EpochBegin/EpochEnd/
BatchBegin/BatchEnd mixin protocol and the StoppingHandler,
MetricHandler, ValidationHandler, LoggingHandler, CheckpointHandler and
EarlyStoppingHandler, over the port's ``metric``."""
from __future__ import annotations

import logging
import os
import time

import numpy as _np

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.max_epoch = estimator.max_epoch if self.max_epoch is None else self.max_epoch
        self.max_batch = estimator.max_batch if self.max_batch is None else self.max_batch

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch is not None and self.current_batch == self.max_batch:
            self.stop_training = True
        return self.stop_training

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch is not None and self.current_epoch == self.max_epoch:
            self.stop_training = True
        return self.stop_training


class MetricHandler(EpochBegin, BatchEnd):
    def __init__(self, train_metrics):
        self.train_metrics = train_metrics or []

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.train_metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs["pred"]
        label = kwargs["label"]
        loss = kwargs["loss"]
        from ....metric import Loss as LossMetric

        for metric in self.train_metrics:
            if isinstance(metric, LossMetric):
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    def __init__(self, val_data, eval_fn, val_metrics=None, epoch_period=1,
                 batch_period=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.val_metrics = val_metrics or []
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data, val_metrics=self.val_metrics)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data, val_metrics=self.val_metrics)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    def __init__(self, log_interval="epoch", train_metrics=None,
                 val_metrics=None):
        self.log_interval = log_interval
        self.train_metrics = train_metrics or []
        self.val_metrics = val_metrics or []
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        t = time.time() - self.train_start
        self.logger.info("Train finished using %.3fs", t)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()

    def epoch_end(self, estimator, *args, **kwargs):
        t = time.time() - self.epoch_start
        msgs = [f"{m.get()[0]}: {m.get()[1]:.4f}"
                for m in self.train_metrics + self.val_metrics]
        self.logger.info("Epoch %d finished in %.3fs: %s",
                         self.current_epoch, t, ", ".join(msgs))
        self.current_epoch += 1
        self.batch_index = 0

    def batch_end(self, estimator, *args, **kwargs):
        if isinstance(self.log_interval, int) \
                and self.batch_index % self.log_interval == 0:
            msgs = [f"{m.get()[0]}: {m.get()[1]:.4f}" for m in self.train_metrics]
            self.logger.info("Epoch %d batch %d: %s", self.current_epoch,
                             self.batch_index, ", ".join(msgs))
        self.batch_index += 1


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5, resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_epoch = 0
        self.current_batch = 0
        self.best = None
        self.mode = mode
        os.makedirs(model_dir, exist_ok=True)

    def _save(self, estimator, tag):
        path = os.path.join(self.model_dir, f"{self.model_prefix}-{tag}.params")
        estimator.net.save_parameters(path)
        if estimator.trainer is not None:
            estimator.trainer.save_states(path.replace(".params", ".states"))

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(estimator, f"batch{self.current_batch}")

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch}")
        if self.save_best and self.monitor is not None:
            name, value = self.monitor.get()
            better = (self.best is None
                      or (self.mode != "min" and value > self.best)
                      or (self.mode == "min" and value < self.best))
            if better:
                self.best = value
                self._save(estimator, "best")


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.baseline = baseline
        self.wait = 0
        self.best = None
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False

    def epoch_end(self, estimator, *args, **kwargs):
        name, value = self.monitor.get()
        if _np.isnan(value):
            self.current_epoch += 1
            return self.stop_training
        greater_is_better = self.mode != "min" and ("acc" in name or self.mode == "max")
        if self.best is None:
            self.best = value
        else:
            improved = (value > self.best + self.min_delta if greater_is_better
                        else value < self.best - self.min_delta)
            if improved:
                self.best = value
                self.wait = 0
            else:
                self.wait += 1
                if self.wait >= self.patience:
                    self.stopped_epoch = self.current_epoch
                    self.stop_training = True
        self.current_epoch += 1
        return self.stop_training

    def train_end(self, estimator, *args, **kwargs):
        if self.stop_training:
            logging.getLogger("mxnet_tpu_torch.estimator").info(
                "Early stopping at epoch %d", self.stopped_epoch)
