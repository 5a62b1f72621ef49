"""Contrib optimizers (the counterpart of `mxnet_tpu/optimizer/contrib.py`;
reference `python/mxnet/optimizer/contrib.py`)."""
from __future__ import annotations

import torch

from ..ndarray.ndarray import NDArray
from .optimizer import Optimizer, _run, register

__all__ = ["GroupAdaGrad"]


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one accumulator per row (reference
    `contrib.py:GroupAdaGrad`): history += mean(g², rows); w -= lr·g /
    sqrt(history + eps).  Weight decay is refused, as in the reference."""

    def __init__(self, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        assert len(weight.shape) >= 1
        shape = (weight.shape[0],) + (1,) * (len(weight.shape) - 1)
        return NDArray(torch.zeros(shape, dtype=weight.data.dtype,
                                   device=weight.data.device))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._base_kwargs(index)
        assert kw.pop("wd", 0.0) == 0.0, \
            "weight decay is not supported by GroupAdaGrad"
        _run("_contrib_group_adagrad_update", (weight, grad, state),
             epsilon=self.float_stable_eps, **kw)
