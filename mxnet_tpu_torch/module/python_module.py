"""PythonModule / PythonLossModule: plug arbitrary Python computation into
a Module pipeline (the counterpart of `mxnet_tpu/module/python_module.py`;
reference `python/mxnet/module/python_module.py`) -- typically the tail of
a SequentialModule where a hand-written loss/gradient replaces a symbolic
head.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..io import DataDesc
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Parameter-less module whose compute is plain Python (reference
    `python_module.py:28`).  Subclasses implement `forward` (and
    `backward` if used in training) plus `_compute_output_shapes`."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- symbol information ---------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    # -- shapes ----------------------------------------------------------
    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- params: none ----------------------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, *a, **k):
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.params_initialized = True

    def update(self):
        """No parameters to update; hook for stateful subclasses."""

    def update_metric(self, eval_metric, labels):
        if self._label_names:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [d if isinstance(d, DataDesc)
                             else DataDesc(*d) for d in data_shapes]
        # unconditional: a rebind without labels must not keep stale shapes
        self._label_shapes = ([d if isinstance(d, DataDesc)
                               else DataDesc(*d) for d in label_shapes]
                              if label_shapes is not None else None)
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError

    def init_optimizer(self, *a, **k):
        """Nothing to optimize."""


class PythonLossModule(PythonModule):
    """Loss head in Python: forward stores scores/labels, backward calls
    `grad_func(scores, labels) -> dscores` (reference
    `python_module.py:243`)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names,
                         [name + "_output"], logger=logger)
        self._name = name
        if len(self._data_names) != 1 or len(self._label_names) != 1:
            raise MXNetError("PythonLossModule takes one data, one label")
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [DataDesc(self._name + "_output",
                         self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError("loss module expects no out_grads")
        if not self.for_training:
            raise MXNetError("module not bound for training")
        if self._grad_func is None:
            raise NotImplementedError("pass grad_func or override backward")
        from ..ndarray import ndarray as _nd
        from ..ndarray.ndarray import NDArray
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, NDArray):
            grad = _nd.array(np.asarray(grad), ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
