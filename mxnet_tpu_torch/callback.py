"""Training callbacks (the counterpart of `mxnet_tpu/callback.py`;
reference `python/mxnet/callback.py`): `Speedometer`, `do_checkpoint`,
`module_checkpoint`, `LogValidationMetricsCallback`, `log_train_metric`
and `ProgressBar`.  `module_checkpoint` takes a file prefix; the JAX
package's `checkpoint.CheckpointManager` form waits for that module."""
from __future__ import annotations

import logging
import sys
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "ProgressBar", "module_checkpoint",
           "LogValidationMetricsCallback"]


class Speedometer:
    """Log throughput every `frequent` batches (reference
    `callback.py:Speedometer`)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / (
                    time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving ``prefix-symbol.json`` and
    ``prefix-NNNN.params`` every ``period`` epochs (reference
    `callback.py:do_checkpoint`)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg or {}, aux or {})
    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback running ``mod.save_checkpoint(prefix, ...)``
    every ``period`` epochs (reference `callback.py:module_checkpoint`).
    ``prefix`` may be a `checkpoint.CheckpointManager`: each firing then
    commits a crash-consistent step directory (parameters, optimizer
    states, generators, epoch)."""
    period = int(max(1, period))
    if hasattr(prefix, "save_module"):
        manager = prefix

        def _manager_callback(iter_no, sym=None, arg=None, aux=None):
            if (iter_no + 1) % period == 0:
                manager.save_module(mod, step=iter_no, epoch=iter_no)
        return _manager_callback

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


class LogValidationMetricsCallback:
    """Log eval metrics at the end of an epoch (reference
    `callback.py:LogValidationMetricsCallback`)."""

    def __call__(self, param):
        if not param.eval_metric:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info('Epoch[%d] Validation-%s=%f', param.epoch, name,
                         value)


def log_train_metric(period, auto_reset=False):
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
    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        count = param.nbatch
        filled = int(round(self.length * count / float(self.total)))
        pct = round(100.0 * count / float(self.total), 1)
        bar = "=" * filled + "-" * (self.length - filled)
        sys.stdout.write(f"[{bar}] {pct}%\r")
