"""``Estimator``: the fit loop of ``gluon.contrib`` (counterpart of
``mxnet_tpu/gluon/contrib/estimator/estimator.py:22``).

``Estimator(net, loss, train_metrics, trainer, context)``; ``fit`` runs
epochs (or batches) of ``autograd.record()``, ``loss.backward()`` and
``trainer.step(batch_size)`` over the port's ``Trainer``, calling the
event handlers (``event_handler.py``) at each event, in the order the
reference calls them; ``evaluate`` updates the validation metrics.
"""
from __future__ import annotations

from .... import autograd, metric as metric_mod
from ....base import MXNetError
from ....context import Context, current_context
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, ValidationHandler)

__all__ = ["Estimator"]


class Estimator:
    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None, val_metrics=None):
        self.net = net
        self.loss = loss
        self.train_metrics = [metric_mod.create(m)
                              for m in (train_metrics or ["accuracy"])]
        self.val_metrics = [metric_mod.create(m)
                            for m in (val_metrics or ["accuracy"])]
        self.context = self._check_context(context)
        self.trainer = trainer or Trainer(
            net.collect_params(), "sgd", {"learning_rate": 0.001})
        self.max_epoch = None
        self.max_batch = None

    def _check_context(self, context):
        if context is None:
            return [current_context()]
        if isinstance(context, Context):
            return [context]
        return list(context)

    def evaluate(self, val_data, val_metrics=None, batch_axis=0):
        val_metrics = val_metrics or self.val_metrics
        for m in val_metrics:
            m.reset()
        for batch in val_data:
            data = batch[0].as_in_context(self.context[0])
            label = batch[1].as_in_context(self.context[0])
            pred = self.net(data)
            for m in val_metrics:
                m.update([label], [pred])
        return val_metrics

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        self.max_epoch = epochs
        self.max_batch = batches
        if epochs is None and batches is None:
            raise MXNetError("must specify epochs or batches")
        handlers = self._prepare_handlers(val_data, event_handlers)

        def those(kind):
            return [h for h in handlers if isinstance(h, kind)]

        batch_begin, batch_end = those(BatchBegin), those(BatchEnd)
        epoch_begin, epoch_end = those(EpochBegin), those(EpochEnd)
        for h in those(TrainBegin):
            h.train_begin(self)
        stop = False
        while not stop:
            for h in epoch_begin:
                h.epoch_begin(self)
            for batch in train_data:
                data = batch[0].as_in_context(self.context[0])
                label = batch[1].as_in_context(self.context[0])
                for h in batch_begin:
                    h.batch_begin(self, batch=batch)
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                loss.backward()
                self.trainer.step(data.shape[0])
                for h in batch_end:
                    if h.batch_end(self, batch=batch, pred=[pred],
                                   label=[label], loss=[loss]):
                        stop = True
                if stop:
                    break
            for h in epoch_end:
                if h.epoch_end(self):
                    stop = True
        for h in those(TrainEnd):
            h.train_end(self)

    def _prepare_handlers(self, val_data, event_handlers):
        handlers = list(event_handlers or [])
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(self.max_epoch, self.max_batch))
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(self.train_metrics))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate,
                                              self.val_metrics))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(train_metrics=self.train_metrics,
                                           val_metrics=self.val_metrics))
        return handlers
