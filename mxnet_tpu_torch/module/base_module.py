"""BaseModule: the symbolic training workflow (the counterpart of
`mxnet_tpu/module/base_module.py`; reference
`python/mxnet/module/base_module.py`).

``fit`` is the reference's epoch/batch loop: bind, init_params,
init_optimizer, then per batch one `fused_step` (the whole step as one
program, captured as a CUDA graph on the card) where the module has one,
else ``forward_backward()`` + ``update()``; the metric is updated on the
host unless the step accumulated it itself (``last_step_metric_done``).
Each step runs under a `telemetry.trace` id, stamps the steps/s gauge and
feeds a `telemetry.SlowStepWatchdog` (input wait vs compute vs comm, on
host clocks), as in the JAX package.  ``score`` and ``predict`` run
inference forwards.

With ``MXTPU_CKPT_DIR`` set, ``fit`` commits a checkpoint after every
epoch (`checkpoint.CheckpointManager.save_module`) and, on a restart,
resumes after the newest valid one: parameters, optimizer states (with
their update counts) and the generators restored, so that the resumed
run ends where an uninterrupted one does.  A mid-epoch ``preempted``
snapshot of the preemption supervisor (`train_driver`) resumes inside
its epoch: the batches the preempted run consumed are read from the
(deterministic) iterator and skipped, so the continuation equals an
uninterrupted run bit for bit.  Under an activated `train_driver.
TrainingSupervisor` each step boundary honors a pending stop (the
bounded final checkpoint, then `TrainingPreempted`), and with
``MXTPU_ANOMALY_GUARD`` an `AnomalyGuard` counts the steps the device
skipped.
"""
from __future__ import annotations

import logging
import time
from typing import List

import torch

from .. import metric as metric_mod
from .. import profiler as _prof
from .. import telemetry as _tele
from ..ndarray.ndarray import NDArray

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

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    # -- shared workflow ---------------------------------------------------
    def forward_backward(self, data_batch):
        """One training forward and its backward (reference
        `base_module.py:forward_backward`)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def fused_step(self, data_batch, eval_metric=None):
        """The whole step (forward, backward, update) as one program where
        the subclass has one; False tells the caller to run
        ``forward_backward()`` + ``update()`` (the same numbers).  A
        subclass that accumulated ``eval_metric`` inside the step sets
        `last_step_metric_done`."""
        return False

    #: whether the last `fused_step` accumulated fit's metric itself
    last_step_metric_done = False

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """``eval_metric`` over ``eval_data``'s batches, by inference
        forwards (reference `base_module.py:score`)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data``'s batches, concatenated along
        the batch axis with ``merge_batches`` (reference
        `base_module.py:predict`)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        outputs_all: List[List[NDArray]] = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            outputs_all.append([NDArray(o.data.clone())
                                for o in self.get_outputs()])
        if not outputs_all:
            return []
        if merge_batches:
            num_out = len(outputs_all[0])
            merged = [NDArray(torch.cat([b[i].data for b in outputs_all]))
                      for i in range(num_out)]
            if num_out == 1 and not always_output_list:
                return merged[0]
            return merged
        return outputs_all

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd", optimizer_params=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The epoch/batch training loop (reference
        `base_module.py:409`), with ``MXTPU_CKPT_DIR``'s checkpoint after
        each epoch and resume on restart (the module's docstring), and
        ``monitor``'s ``tic``/``toc_print`` around each batch."""
        assert num_epoch is not None, "please specify num_epoch"
        from .. import initializer as init_mod
        from ..checkpoint import auto_manager, split_arg_aux
        optimizer_params = dict(optimizer_params or {"learning_rate": 0.01})
        initializer = initializer or init_mod.Uniform(0.01)
        ckpt_mgr = auto_manager(logger=self.logger)
        resume = None
        skip_batches = 0
        if ckpt_mgr is not None:
            ck = ckpt_mgr.latest_valid()
            if ck is not None:
                resume = ckpt_mgr.load(ck)
                arg_r, aux_r = split_arg_aux(resume.get("params") or {})
                arg_params = dict(arg_params or {}, **arg_r)
                aux_params = dict(aux_params or {}, **aux_r)
                done = ck.epoch if ck.epoch is not None else ck.step
                if (resume.get("extra") or {}).get("preempted") and \
                        resume.get("batch") is not None:
                    # a mid-epoch preemption snapshot: redo that epoch
                    # from the recorded batch cursor
                    begin_epoch = max(begin_epoch, int(done))
                    skip_batches = int(resume["batch"])
                    self.logger.info(
                        "MXTPU_CKPT_DIR auto-resume (preempted): restored "
                        "%s; redoing epoch %d from batch %d", ck,
                        begin_epoch, skip_batches)
                else:
                    begin_epoch = max(begin_epoch, int(done) + 1)
                    self.logger.info(
                        "MXTPU_CKPT_DIR auto-resume: restored %s; "
                        "continuing at epoch %d", ck, begin_epoch)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init or (resume is not None
                                                   and bool(arg_params)))
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if resume is not None:
            if resume.get("optimizer_states"):
                self.load_optimizer_states_bytes(resume["optimizer_states"])
            if resume.get("rng"):
                # after the parameters' and the optimizer's set-up, so the
                # stream continues where the saved run's stood
                from .. import random as rnd_mod
                rnd_mod.set_state(resume["rng"])
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        from .. import train_driver as _drv
        # the ambient preemption supervisor (None unless one was activated
        # with MXTPU_DRIVER on) and the host half of MXTPU_ANOMALY_GUARD
        sup = _drv.current()
        anomaly_guard = _drv.AnomalyGuard.maybe(logger=self.logger)
        # trailing-window anomaly detector: attributes a slow step to
        # input wait vs compute vs comm through a structured event (host
        # clocks only: nothing here waits for the card)
        watchdog = _tele.SlowStepWatchdog()
        from ..parallel.elastic_mesh import MeshDegradedError as _MeshDeg
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            data_iter = iter(train_data)
            while True:
                t_in = time.perf_counter()
                try:
                    data_batch = next(data_iter)
                except StopIteration:
                    break
                if nbatch < skip_batches:
                    # preempt-resume fast-forward: the preempted run
                    # consumed these before its final checkpoint
                    nbatch += 1
                    continue
                input_s = time.perf_counter() - t_in
                comm0 = float(_prof.comm_counters().get("blocked_s", 0.0))
                t_step = time.perf_counter()
                # one trace id per training step
                while True:
                    try:
                        with _tele.trace():
                            if monitor is not None:
                                monitor.tic()
                            if not self.fused_step(data_batch,
                                                   eval_metric=eval_metric):
                                self.forward_backward(data_batch)
                                self.update()
                            if not self.last_step_metric_done:
                                self.update_metric(eval_metric,
                                                   data_batch.label)
                        break
                    except _MeshDeg as mexc:
                        if sup is None:
                            raise
                        # a mesh member is lost: the probe fired before
                        # anything mutated, so after the supervisor shrinks
                        # (or preempts, which raises) the same batch retries
                        sup.on_mesh_degraded(mexc, module=self,
                                             ckpt_mgr=ckpt_mgr, epoch=epoch,
                                             nbatch=nbatch,
                                             train_data=train_data)
                step_s = time.perf_counter() - t_step
                comm_s = max(0.0, float(_prof.comm_counters()
                                        .get("blocked_s", 0.0)) - comm0)
                _tele.mark_step()
                watchdog.observe(nbatch, input_s,
                                 max(0.0, step_s - comm_s), comm_s)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(_BatchEndParam(epoch, nbatch, eval_metric,
                                          locals()))
                nbatch += 1
                if anomaly_guard is not None:
                    anomaly_guard.after_step(self, epoch=epoch,
                                             nbatch=nbatch)
                if sup is not None:
                    # step boundary: fault-plan driver events, and a
                    # pending stop's final checkpoint at this cursor
                    sup.on_step_end(module=self, ckpt_mgr=ckpt_mgr,
                                    epoch=epoch, nbatch=nbatch)
            skip_batches = 0
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if ckpt_mgr is not None:
                ckpt_mgr.save_module(self, step=epoch, epoch=epoch,
                                     batch=nbatch)
            if sup is not None:
                # a stop after the epoch's last step: the per-epoch save
                # above, when there is one, is the final checkpoint
                sup.on_epoch_end(module=self, ckpt_mgr=ckpt_mgr,
                                 epoch=epoch, saved=ckpt_mgr is not None)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)

    def install_monitor(self, mon):
        raise NotImplementedError

    def load_optimizer_states_bytes(self, blob: bytes) -> None:
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)


class _BatchEndParam:
    """What a batch-end callback receives (reference
    `base_module.py:_BatchEndParam`)."""

    def __init__(self, epoch, nbatch, eval_metric, local_vars):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = local_vars


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
