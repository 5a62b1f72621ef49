"""Data-parallel executor management (the counterpart of
`mxnet_tpu/executor_manager.py`; reference
`python/mxnet/executor_manager.py`).

The classic multi-device training path: each mini-batch is split across a
list of contexts by ``work_load_list``, one executor per context runs its
slice, and the per-parameter lists of arrays across contexts are handed
to the caller (its updater or kvstore) to aggregate.  Each context gets
its executor and its buffers of its own, also where two contexts share a
device (``[gpu(0), gpu(0)]``, every CPU list).  The executors run through
their `GraphProgram`s (`Executor.compiled_forward`), so on the card an
inference forward replays the CUDA graph of its executor's bound shapes.
"""
import logging

import numpy as np

from .io import DataDesc

__all__ = ["DataParallelExecutorGroup", "DataParallelExecutorManager",
           "_split_input_slice", "_check_arguments", "_load_data",
           "_load_label", "_load_general"]

mx_real_t = np.float32


def _split_input_slice(batch_size, work_load_list):
    """``batch_size`` split into per-context slices proportional to
    ``work_load_list`` (reference `executor_manager.py:31-66`).  Raises
    ValueError when a split comes out empty."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(work_load * batch_size / total_work_load)
                      for work_load in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError('Too many slices. Some splits are empty.')
        slices.append(slice(begin, end))
    return slices


def _check_arguments(symbol):
    """Reject duplicate argument or auxiliary names (reference
    `executor_manager.py:68-96`)."""
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        raise ValueError('Find duplicated argument name="%s"' % ','.join(
            n for n in set(arg_names) if arg_names.count(n) > 1))
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise ValueError('Find duplicated auxiliary name="%s"' % ','.join(
            n for n in set(aux_names) if aux_names.count(n) > 1))


def _load_general(data, targets):
    """Write each batch-major array's slices into its per-context
    ``(slice, NDArray)`` targets."""
    for d_src, d_targets in zip(data, targets):
        for slice_idx, d_dst in d_targets:
            d_dst[:] = d_src[slice_idx]


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


class DataParallelExecutorGroup(object):
    """One executor per context, each bound at its slice's batch shape;
    parameters and gradients exposed as per-parameter lists across the
    contexts (reference `executor_manager.py:204-296`).  With
    ``shared_group`` (another bucket's group) each executor binds the
    parameter arrays of that group's executor on its context."""

    def __init__(self, sym, arg_names, param_names, ctx, slices, train_data,
                 shared_group=None):
        _check_arguments(sym)

        self.data_names = [x[0] for x in train_data.provide_data]
        self.label_names = [x[0] for x in (train_data.provide_label or [])]
        self.aux_names = sym.list_auxiliary_states()
        self.param_idx = [i for i in range(len(arg_names))
                          if arg_names[i] in param_names]
        self.param_names = [arg_names[i] for i in self.param_idx]

        self.train_execs = []
        for i, ctxi in enumerate(ctx):
            shapes = {}
            types = {}
            for x in (list(train_data.provide_data)
                      + list(train_data.provide_label or [])):
                shapes[x[0]] = tuple(
                    [slices[i].stop - slices[i].start] + list(x[1][1:]))
                types[x[0]] = (x.dtype if isinstance(x, DataDesc)
                               else mx_real_t)
            # gradients of the parameters only
            grad_req = {n: ('write' if n in self.param_names else 'null')
                        for n in arg_names}
            shared = shared_group.train_execs[i] if shared_group else None
            self.train_execs.append(sym.simple_bind(
                ctx=ctxi, grad_req=grad_req, type_dict=types,
                shared_exec=shared, **shapes))

        self.data_arrays = [[(slices[i], e.arg_dict[name])
                             for i, e in enumerate(self.train_execs)]
                            for name in self.data_names]
        self.label_arrays = [[(slices[i], e.arg_dict[name])
                              for i, e in enumerate(self.train_execs)]
                             for name in self.label_names]
        self.param_arrays = [[e.arg_dict[arg_names[i]]
                              for e in self.train_execs]
                             for i in self.param_idx]
        self.aux_arrays = [[e.aux_dict[name] for e in self.train_execs]
                           for name in self.aux_names]
        self.slices = slices

    @property
    def grad_arrays(self):
        """Per-parameter gradient lists across the contexts."""
        return [[e.grad_dict.get(name) for e in self.train_execs]
                for name in self.param_names]

    def load_data_batch(self, data_batch):
        """Write one batch's slices into each context's input arrays."""
        _load_data(data_batch, self.data_arrays)
        if self.label_arrays and getattr(data_batch, 'label', None):
            _load_label(data_batch, self.label_arrays)

    def forward(self, is_train=False):
        """Forward on every executor."""
        for texec in self.train_execs:
            texec.compiled_forward(is_train=is_train)

    def backward(self):
        """Backward on every executor."""
        for texec in self.train_execs:
            texec.compiled_backward()

    def update_metric(self, metric, labels, pre_sliced=False):
        """Update ``metric`` context by context with that context's label
        slice and outputs."""
        for current_exec, (texec, islice) in enumerate(
                zip(self.train_execs, self.slices)):
            if not pre_sliced:
                labels_slice = [label[islice] for label in labels]
            else:
                labels_slice = labels[current_exec]
            metric.update(labels_slice, texec.outputs)


class DataParallelExecutorManager(object):
    """Data-parallel executors over ``ctx`` for ``train_data`` (reference
    `executor_manager.py:298-446`): the batch is sliced by
    ``work_load_list``; the manager aggregates nothing itself, and
    ``param_arrays``/``grad_arrays`` feed the caller's updater or
    kvstore."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        num_device = len(ctx)
        logger.info('Start training with %s', str(ctx))

        if work_load_list is None:
            work_load_list = [1] * num_device
        if not (isinstance(work_load_list, list)
                and len(work_load_list) == num_device):
            raise AssertionError("Invalid settings for work load.")

        batch_size = next(x[1][0] for x in train_data.provide_data)
        self.slices = _split_input_slice(batch_size, work_load_list)

        self.arg_names = arg_names or symbol.list_arguments()
        data_label = {x[0] for x in (list(train_data.provide_data)
                                     + list(train_data.provide_label or []))}
        self.param_names = param_names or [
            n for n in self.arg_names if n not in data_label]
        self.aux_names = aux_names or symbol.list_auxiliary_states()
        self.ctx = ctx
        self.sym_gen = sym_gen
        self.symbol = symbol

        self.execgrp = DataParallelExecutorGroup(
            symbol, self.arg_names, self.param_names, ctx, self.slices,
            train_data)
        self.execgrp_bucket = {}
        if sym_gen is not None:
            default_key = getattr(train_data, 'default_bucket_key', None)
            if default_key is not None:
                self.execgrp_bucket[default_key] = self.execgrp
        self.curr_execgrp = self.execgrp

    def install_monitor(self, monitor):
        """Install ``monitor`` on every executor."""
        for texec in self.curr_execgrp.train_execs:
            monitor.install(texec)

    def set_params(self, arg_params, aux_params):
        """Copy the parameter values into every executor."""
        for texec in self.curr_execgrp.train_execs:
            texec.copy_params_from(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """Copies of the parameters of the first context's executor (every
        context holds the same values between updates)."""
        exec0 = self.curr_execgrp.train_execs[0]
        for name in self.param_names:
            arg_params[name] = exec0.arg_dict[name].copy()
        for name in self.aux_names:
            aux_params[name] = exec0.aux_dict[name].copy()

    @property
    def param_arrays(self):
        """Per-parameter lists of the contexts' arrays."""
        return [self.curr_execgrp.param_arrays[i]
                for i in range(len(self.param_names))]

    @property
    def grad_arrays(self):
        """Per-parameter lists of the contexts' gradient arrays."""
        return self.curr_execgrp.grad_arrays

    @property
    def aux_arrays(self):
        """Per-auxiliary-state lists of the contexts' arrays."""
        return self.curr_execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        """Scatter a batch; with ``sym_gen``, bind the bucket's executor
        group first (reference `executor_manager.py:415-432`)."""
        if self.sym_gen is not None:
            key = getattr(data_batch, 'bucket_key', None)
            if key is not None and key not in self.execgrp_bucket:
                symbol = self.sym_gen(key)
                self.execgrp_bucket[key] = DataParallelExecutorGroup(
                    symbol, self.arg_names, self.param_names, self.ctx,
                    self.slices, data_batch, shared_group=self.execgrp)
            if key is not None:
                self.curr_execgrp = self.execgrp_bucket[key]
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        """Forward on the current executor group."""
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        """Backward on the current executor group."""
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels, pre_sliced=False):
        """Update ``metric`` from every context's outputs."""
        self.curr_execgrp.update_metric(metric, labels, pre_sliced)
