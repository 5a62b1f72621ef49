"""Legacy learning-rate scheduler API (the counterpart of
`mxnet_tpu/misc.py`; reference ``python/mxnet/misc.py``).

Predates ``lr_scheduler``; kept because old training scripts import
``FactorScheduler`` from here.  Schedulers are called with the iteration
count and return the lr (vs ``lr_scheduler``'s mutate-in-place design).
"""
import logging
import math


class LearningRateScheduler(object):
    """Base class of the legacy scheduler: call with iteration, get lr."""

    def __init__(self):
        self.base_lr = 0.01

    def __call__(self, iteration):
        raise NotImplementedError("must override this")


class FactorScheduler(LearningRateScheduler):
    """lr = base_lr * factor^(iteration // step), logging on change."""

    def __init__(self, step, factor=0.1):
        super().__init__()
        if step < 1:
            raise ValueError(
                "Schedule step must be greater or equal than 1 round")
        if factor >= 1.0:
            raise ValueError("Factor must be less than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.old_lr = self.base_lr
        self.init = False

    def __call__(self, iteration):
        if not self.init:
            self.init = True
            self.old_lr = self.base_lr
        lr = self.base_lr * math.pow(self.factor, int(iteration / self.step))
        if lr != self.old_lr:
            self.old_lr = lr
            logging.info("At Iteration [%d]: Swith to new learning rate %.5f",
                         iteration, lr)
        return lr
