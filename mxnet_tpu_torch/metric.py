"""Evaluation metrics (the counterpart of `mxnet_tpu/metric.py`; reference
`python/mxnet/metric.py`).

The registry and the whole class surface: Accuracy, TopKAccuracy, F1,
MCC, Perplexity (with ``ignore_label``), MAE/MSE/RMSE, CrossEntropy,
NegativeLogLikelihood, PearsonCorrelation, Loss, CustomMetric and
CompositeEvalMetric, with `np_metric` and `create`.  Accuracy, MAE, MSE,
RMSE and Loss accumulate NDArray inputs on their device: the running sum
stays a device tensor until `get()`, which pays the one host read.  A
label on another device than its prediction moves to the prediction's.
The others compute on host copies, as the reference's do.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np_metric", "np", "create"]

_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(*names):
    def deco(klass):
        for n in names:
            _METRIC_REGISTRY[n.lower()] = klass
        return klass
    return deco


def create(metric, *args, **kwargs):
    """Create metric from name/callable/list (reference `metric.py:create`)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        try:
            return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
        except KeyError:
            raise MXNetError(f"metric {metric!r} is not registered") from None
    raise TypeError(f"cannot create metric from {type(metric)}")


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _np.asarray(x)


def _align_device(l, p):
    """The label on the prediction's device (a host-fed label against a
    prediction on the card)."""
    return l if l.device == p.device else l.to(p.device, non_blocking=True)


def _accumulate(cur, inc):
    """Add a device-scalar increment into the running accumulator with no
    host read; the increment follows the accumulator's device."""
    if isinstance(cur, torch.Tensor) and cur.device != inc.device:
        inc = inc.to(cur.device)
    return cur + inc


def _host_scalar(v):
    """The accumulator as a Python number: the one place accumulation
    reads the device."""
    if isinstance(v, (int, float)):
        return v
    try:
        return float(v)
    except TypeError:
        return v


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            f"Shape of labels {label_shape} does not match shape of "
            f"predictions {pred_shape}")
    if wrap:
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
    return labels, preds


class EvalMetric:
    """Base metric (reference `metric.py:EvalMetric`)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name,
                _host_scalar(self.sum_metric) / _host_scalar(self.num_inst))

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if not isinstance(value, list):
                value = [value]
            names.extend(name)
            values.extend(value)
        return names, values


@register
@_alias("acc")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                # device-resident accumulation: the correct count stays a
                # device scalar until get()
                p, l = pred.data, label.data
                if p.shape != l.shape:
                    p = p.argmax(dim=self.axis)
                p = p.to(torch.int32).reshape(-1)
                l = _align_device(l.to(torch.int32).reshape(-1), p)
                check_label_shapes(l, p)
                self.sum_metric = _accumulate(self.sum_metric, (p == l).sum())
                self.num_inst += int(p.shape[0])
                continue
            pred = _as_numpy(pred)
            label = _as_numpy(label)
            # reference Accuracy.update: argmax on any shape mismatch
            # (2-D labels from custom iterators flatten against pred rows)
            if pred.shape != label.shape:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(_np.int32).reshape(-1)
            label = label.astype(_np.int32).reshape(-1)
            label, pred = check_label_shapes(label, pred)
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(pred)


@register
@_alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += f"_{top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred).astype("float32")
            label = _as_numpy(label).astype("int32").reshape(-1)
            pred = _np.argpartition(pred, -self.top_k, axis=-1)
            num_samples = pred.shape[0]
            for j in range(self.top_k):
                self.sum_metric += (
                    pred[:, -1 - j].reshape(-1) == label).sum()
            self.num_inst += num_samples


class _BinaryClassificationStats:
    """Running TP/FP/TN/FN (reference
    `metric.py:_BinClassificationMetrics`)."""

    def __init__(self):
        self.reset_stats()

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0

    def update_binary_stats(self, label, pred):
        pred = _as_numpy(pred)
        label = _as_numpy(label).astype(_np.int32)
        pred_label = _np.argmax(pred, axis=1)
        check_label_shapes(label, pred)
        if len(_np.unique(label)) > 2:
            raise ValueError("%s currently only supports binary "
                             "classification." % type(self).__name__)
        pred_true = pred_label == 1
        pred_false = ~pred_true
        label_true = label.reshape(-1) == 1
        label_false = ~label_true
        self.true_positives += (pred_true & label_true).sum()
        self.false_positives += (pred_true & label_false).sum()
        self.false_negatives += (pred_false & label_true).sum()
        self.true_negatives += (pred_false & label_false).sum()

    @property
    def precision(self):
        tp_fp = self.true_positives + self.false_positives
        return self.true_positives / tp_fp if tp_fp > 0 else 0.0

    @property
    def recall(self):
        tp_fn = self.true_positives + self.false_negatives
        return self.true_positives / tp_fn if tp_fn > 0 else 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return (2 * self.precision * self.recall
                    / (self.precision + self.recall))
        return 0.0

    @property
    def matthewscc(self):
        terms = [(self.true_positives + self.false_positives),
                 (self.true_positives + self.false_negatives),
                 (self.true_negatives + self.false_positives),
                 (self.true_negatives + self.false_negatives)]
        denom = 1.0
        for t in filter(lambda t: t != 0.0, terms):
            denom *= t
        return ((self.true_positives * self.true_negatives
                 - self.false_positives * self.false_negatives)
                / math.sqrt(denom))

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives
                + self.true_negatives + self.true_positives)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationStats()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (reference `metric.py:MCC`)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationStats()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(label, pred)
        if self._average == "macro":
            self.sum_metric += self._metrics.matthewscc
            self.num_inst += 1
            self._metrics.reset_stats()
        else:
            self.sum_metric = (self._metrics.matthewscc
                               * self._metrics.total_examples)
            self.num_inst = self._metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "_metrics"):
            self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).reshape(-1).astype(_np.int64)
            pred = _as_numpy(pred)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[_np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                probs = probs * (1 - ignore) + ignore
                num -= int(ignore.sum())
            loss -= _np.sum(_np.log(_np.maximum(1e-10, probs)))
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                l, p = label.data, pred.data
                if l.dim() == 1:
                    l = l.reshape(l.shape[0], 1)
                if p.dim() == 1:
                    p = p.reshape(p.shape[0], 1)
                l = _align_device(l, p)
                self.sum_metric = _accumulate(self.sum_metric,
                                              (l - p).abs().mean())
                self.num_inst += 1
                continue
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += _np.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                l, p = label.data, pred.data
                if l.dim() == 1:
                    l = l.reshape(l.shape[0], 1)
                if p.dim() == 1:
                    p = p.reshape(p.shape[0], 1)
                l = _align_device(l, p)
                self.sum_metric = _accumulate(self.sum_metric,
                                              ((l - p) ** 2.0).mean())
                self.num_inst += 1
                continue
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred, NDArray):
                l, p = label.data, pred.data
                if l.dim() == 1:
                    l = l.reshape(l.shape[0], 1)
                if p.dim() == 1:
                    p = p.reshape(p.shape[0], 1)
                l = _align_device(l, p)
                self.sum_metric = _accumulate(self.sum_metric, torch.sqrt(
                    ((l - p) ** 2.0).mean()))
                self.num_inst += 1
                continue
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += _np.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@register
@_alias("ce")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), _np.int64(label)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
@_alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples
            prob = pred[_np.arange(num_examples, dtype=_np.int64),
                        _np.int64(label)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += num_examples


@register
@_alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, False, True)
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            self.sum_metric += _np.corrcoef(pred.ravel(), label.ravel())[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of the loss heads (reference `metric.py:Loss`)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            if isinstance(pred, NDArray):
                # a device sum: no per-batch host read
                self.sum_metric = _accumulate(self.sum_metric,
                                              pred.data.sum())
                self.num_inst += pred.data.numel()
            else:
                pred = _as_numpy(pred)
                self.sum_metric += pred.sum()
                self.num_inst += pred.size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np_metric(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a metric (reference `metric.py:np`)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


# the reference exposes this factory as `mx.metric.np` (metric.py:np);
# the module's numpy import is aliased to _np to free the name
np = np_metric
