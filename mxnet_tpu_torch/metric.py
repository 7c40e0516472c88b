"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``).

Reference: ``python/mxnet/metric.py`` — `EvalMetric` base (host-side numpy
on synced outputs), Accuracy, TopKAccuracy, F1, MCC, MAE, MSE, RMSE,
CrossEntropy, NegativeLogLikelihood, Perplexity, PearsonCorrelation,
Loss, CompositeEvalMetric, CustomMetric, and `create`.

Every metric computes on host numpy, as the reference's (``_as_numpy``);
it takes NDArrays, torch tensors on any device and numpy arrays. A
bfloat16 input reaches numpy as float32 (the port's ``asnumpy``
convention), where the reference does the arithmetic in ml_dtypes
bfloat16: a difference by design.
"""
from __future__ import annotations

import math
import numpy as _np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MCC", "MAE",
           "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "Loss", "CompositeEvalMetric",
           "CustomMetric", "Torch", "Caffe", "PCC", "create", "np"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    key = str(metric).lower()
    if key == "acc":
        key = "accuracy"
    if key == "ce":
        key = "crossentropy"
    if key == "nll_loss":
        key = "negativeloglikelihood"
    if key not in _REGISTRY:
        raise MXNetError(f"unknown metric {metric!r}")
    return _REGISTRY[key](*args, **kwargs)


def _as_numpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if isinstance(labels, (list, tuple)) != isinstance(preds, (list, tuple)):
        pass
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    if isinstance(labels, (list, tuple)) and isinstance(preds, (list, tuple)) \
            and len(labels) != len(preds):
        raise MXNetError(
            f"label and prediction counts differ: {len(labels)} vs {len(preds)}")
    return labels, preds


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def _accumulate(self, metric, count):
        self.sum_metric += metric
        self.num_inst += count
        self.global_sum_metric += metric
        self.global_num_inst += count

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.global_sum_metric / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def __str__(self):
        return f"EvalMetric: {dict([self.get_name_value()[0]])}"


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if pred.ndim > label.ndim:
                pred = _np.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").ravel()
            label = label.astype("int32").ravel()
            if len(pred) != len(label):
                raise MXNetError(
                    f"Accuracy: prediction count {len(pred)} != label count "
                    f"{len(label)}")
            correct = int((pred == label).sum())
            self._accumulate(correct, len(pred))


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k
        assert top_k > 1, "use Accuracy for top_k=1"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).astype("int32")
            pred = _as_numpy(pred)
            topk = _np.argsort(pred, axis=-1)[..., -self.top_k:]
            hits = (topk == label.reshape(-1, 1)).any(axis=-1)
            self._accumulate(int(hits.sum()), hits.size)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self._tp = self._fp = self._fn = 0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype("int32")
            pred = _as_numpy(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = _np.argmax(pred, axis=-1)
            pred = (pred.ravel() > 0.5).astype("int32") if pred.dtype.kind == "f" and pred.max(initial=0) <= 1 else pred.ravel().astype("int32")
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            prec = self._tp / max(self._tp + self._fp, 1)
            rec = self._tp / max(self._tp + self._fn, 1)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1
            self.global_sum_metric = f1
            self.global_num_inst = 1


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._tp = self._fp = self._fn = self._tn = 0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype("int32")
            pred = _as_numpy(pred)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = _np.argmax(pred, axis=-1)
            pred = pred.ravel().astype("int32")
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            self._tn += int(((pred == 0) & (label == 0)).sum())
            denom = math.sqrt(
                (self._tp + self._fp) * (self._tp + self._fn)
                * (self._tn + self._fp) * (self._tn + self._fn))
            mcc = ((self._tp * self._tn - self._fp * self._fn) / denom
                   if denom else 0.0)
            self.sum_metric = mcc
            self.num_inst = 1
            self.global_sum_metric = mcc
            self.global_num_inst = 1


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            self._accumulate(float(_np.abs(label.reshape(pred.shape) - pred).mean())
                             * label.shape[0], label.shape[0])


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            self._accumulate(float(((label.reshape(pred.shape) - pred) ** 2).mean())
                             * label.shape[0], label.shape[0])


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype("int32")
            pred = _as_numpy(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self._accumulate(float((-_np.log(prob + self.eps)).sum()), label.shape[0])


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel().astype("int32")
            pred = _as_numpy(pred).reshape(-1, _as_numpy(pred).shape[-1])
            prob = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                prob = _np.where(ignore, 1.0, prob)
                num -= int(ignore.sum())
            loss += float(-_np.log(_np.maximum(prob, 1e-10)).sum())
            num += label.shape[0]
        self._accumulate(loss, num)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            r = _np.corrcoef(label, pred)[0, 1]
            self._accumulate(float(r), 1)


@register
class Loss(EvalMetric):
    """Mean of a loss output (reference: metric.py::Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for pred in preds:
            loss = float(_as_numpy(pred).sum())
            self._accumulate(loss, _as_numpy(pred).size)


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            name, value = m.get()
            names.append(name)
            values.append(value)
        return (names, values)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 output_names=None, label_names=None):
        super().__init__(f"custom({getattr(feval, '__name__', name)})",
                         output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_numpy(label), _as_numpy(pred))
            if isinstance(reval, tuple):
                m, n = reval
                self._accumulate(m, n)
            else:
                self._accumulate(reval, 1)


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """Wrap a numpy feval as a metric (reference: metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name, allow_extra_outputs)


@register
class Torch(Loss):
    """Deprecated alias kept for API parity (reference: metric.py::Torch —
    mean of a torch-criterion output; identical to Loss here)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """Deprecated alias kept for API parity (reference: metric.py::Caffe)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation of the confusion matrix (reference:
    metric.py::PCC — the k-category generalization of MCC)."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._conf = None
        self._gconf = None

    def reset(self):
        super().reset()
        self._conf = None
        self._gconf = None

    def reset_local(self):
        super().reset_local()
        self._conf = None

    @staticmethod
    def _pcc_of(c):
        n = c.sum()
        x = c.sum(axis=1)
        y = c.sum(axis=0)
        cov_xy = c.trace() * n - (x * y).sum()
        denom = ((n * n - (x * x).sum()) * (n * n - (y * y).sum())) ** 0.5
        return float(cov_xy / denom) if denom > 0 else 0.0

    def update(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels, preds = [labels], [preds]

        def grow(conf, k):
            if conf is None or conf.shape[0] < k:
                new = _np.zeros((k, k), _np.float64)
                if conf is not None:
                    new[:conf.shape[0], :conf.shape[1]] = conf
                return new
            return conf

        for label, pred in zip(labels, preds):
            lab = _as_numpy(label).astype(int).reshape(-1)
            p = _as_numpy(pred)
            cls = p.argmax(-1).reshape(-1) if p.ndim > 1 else \
                (p.reshape(-1) > 0.5).astype(int)
            k = int(max(lab.max(initial=0), cls.max(initial=0))) + 1
            self._conf = grow(self._conf, k)
            self._gconf = grow(self._gconf, k)
            _np.add.at(self._conf, (cls, lab), 1)
            _np.add.at(self._gconf, (cls, lab), 1)
            self.num_inst = 1
            self.global_num_inst = 1
        self.sum_metric = self._pcc_of(self._conf)
        self.global_sum_metric = self._pcc_of(self._gconf)
