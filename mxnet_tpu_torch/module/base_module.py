"""BaseModule: the symbolic training workflow (the counterpart of
`mxnet_tpu/module/base_module.py`; reference
`python/mxnet/module/base_module.py`).  ``fit``, ``score`` and
``predict`` come with the data iterators and metrics."""
from __future__ import annotations

import logging

__all__ = ["BaseModule"]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.symbol = None

    # -- provided by subclasses ------------------------------------------
    def bind(self, *a, **k):
        raise NotImplementedError

    def init_params(self, *a, **k):
        raise NotImplementedError

    def init_optimizer(self, *a, **k):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    # -- shared workflow ---------------------------------------------------
    def forward_backward(self, data_batch):
        """One training forward and its backward (reference
        `base_module.py:forward_backward`)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def fused_step(self, data_batch, eval_metric=None):
        """The whole step as one fused program where a subclass has one;
        False tells the caller to run ``forward_backward()`` + ``update()``
        (the same numbers).  No fused step is ported yet."""
        return False
