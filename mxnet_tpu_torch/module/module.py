"""Module: symbolic training on one device (the counterpart of
`mxnet_tpu/module/module.py`; reference `python/mxnet/module/module.py`).

A ``context`` list folds onto its first context, as the JAX package folds
a list whose devices repeat: the module's results are those of one
context.  Every CPU list folds so (all CPU contexts are the host), and so
does ``[gpu(0), gpu(0)]``; a list of distinct cards folds too, with a
warning, until a run with two cards holds the split of a batch across
them.  `executor_manager` runs one executor per context.  ``group2ctxs``
places the ``ctx_group`` groups of the symbol (model parallelism,
`Symbol.simple_bind`'s ``group2ctx``); such a module never takes the
fused step.

``bind`` → ``init_params`` → ``init_optimizer``, then per batch
``forward`` / ``backward`` / ``update``, or ``fit`` over a data iterator.
The module trains through its executor's training `GraphProgram` and
updates its parameters in place with the local `Updater` (one
multi-tensor update under ``MXTPU_FUSED_STEP``, the default).
`fused_step` runs the whole step as one program (`fused_step`), captured
as a CUDA graph on the card.  Without a ``context`` it runs on the card.
``state_names`` are inputs the module holds across batches (a recurrent
net's carried states): zeros at bind, never trained, read and written by
`get_states` / `set_states`.  ``save_checkpoint`` / `Module.load` write
and read the JAX package's ``prefix-symbol.json`` + ``prefix-NNNN.params``
(and ``.states`` for the optimizer).  With a `kvstore.KVStore` object
(or a ``dist`` type name) ``init_optimizer`` updates on the store: the
store runs the optimizer, and each update pushes the gradients and pulls
the weights back.  A store, a `monitor.Monitor` (`install_monitor`) or
a sparse input batch takes the step off the fused path onto
``forward_backward`` + ``update``, as in the JAX package.  So does a graph
that holds an op no CUDA graph can hold (`graph_compile.one_graph`: a
``Custom`` op, a ``_cond``), decided from the graph before any capture;
a graph with fallback islands (a ``Custom`` op) also runs its forward on
the executor's classic path, as the JAX package's module does.  A batch
of other input shapes reshapes the executor (`reshape`); the module keeps
each executor it reshaped to, by input shapes, with its fused step, so a
ragged tail batch and the change back reuse their captures.
"""
from __future__ import annotations

import logging
import warnings
from typing import Dict

import torch

from .. import initializer as init_mod
from .. import optimizer as opt_mod
from .. import profiler as _prof
from ..base import MXNetError
from ..fused_step import fused_enabled
from ..context import default_context
from ..graph_compile import one_graph
from ..executor import _tensor
from ..io import DataDesc
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule

__all__ = ["Module"]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        self.symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        if isinstance(context, (list, tuple)):
            context = _fold_contexts(list(context), work_load_list, logger)
        self._context = context if context is not None else \
            default_context("Module")
        self._group2ctxs = _one_group2ctx(group2ctxs, logger)
        self._fixed_param_names = set(fixed_param_names or [])
        self._state_names = list(state_names or [])
        self._exec = None
        self._optimizer = None
        self._updater = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused_train_step = None
        # input shapes -> (the executor bound or reshaped to them, its
        # fused step or None)
        self._execs: Dict[tuple, list] = {}
        self._kvstore = None
        self._kv_inited = set()
        # `Module.load`'s checkpoint, taken by bind/init_params and
        # init_optimizer
        self._preloaded = None
        self._preload_states = None
        self._one_graph_of = (None, False)

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self.symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        """``[(output name, shape)]`` for the bound input shapes."""
        _, out_shapes, _ = self.symbol.infer_shape(
            **{d.name: d.shape for d in (self._data_shapes or [])},
            **{d.name: d.shape for d in (self._label_shapes or [])})
        return list(zip(self.output_names, out_shapes))

    def _input_names(self):
        """Data, label and state names: the arguments that are not
        parameters."""
        return {d.name for d in self._data_shapes + self._label_shapes} | \
            set(self._state_names)

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate the executor for these input shapes (reference
        `module.py:364` → simple_bind).  Labels and fixed parameters
        never take gradients, nor do states; data only with
        ``inputs_need_grad``.  With ``shared_module`` (bound) the
        parameters, their gradients and the auxiliary states are that
        module's arrays (`Symbol.simple_bind`'s ``shared_exec``: the
        train/validation pair), and a shape that differs raises
        ValueError."""
        if self.binded and not force_rebind:
            return self
        if shared_module is not None and not shared_module.binded:
            raise MXNetError("shared_module must be binded before sharing")
        self._data_shapes, self._label_shapes, shapes = _parse_shapes(
            data_shapes, label_shapes)
        type_dict = {d.name: d.dtype
                     for d in self._data_shapes + self._label_shapes}
        self._exec = self.symbol.simple_bind(
            ctx=self._context, grad_req=grad_req if for_training else "null",
            type_dict=type_dict, group2ctx=self._group2ctxs,
            shared_exec=shared_module._exec if shared_module else None,
            **shapes)
        self._execs = {}
        self._fused_train_step = None
        keep = set(self._data_names) if inputs_need_grad else set()
        for name in list(self._exec._grad_req):
            if name in keep:
                continue
            if name in shapes or name in self._fixed_param_names or \
                    name in self._state_names:
                self._exec._grad_req[name] = "null"
                self._exec.grad_dict.pop(name, None)
        if shared_module is not None:
            self.params_initialized = shared_module.params_initialized
        self.binded = True
        self.for_training = for_training
        if not self.params_initialized and self._preloaded is not None:
            # `Module.load` leaves the parameters ready, as the
            # reference's does: load -> bind -> forward
            self.init_params()
        return self

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill every parameter (each argument that is not an input), in
        place: from ``arg_params`` where it names one, else by
        ``initializer`` (`Uniform(0.01)` when neither is given).  After
        `Module.load` the checkpoint's parameters are the default."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        if arg_params is None and self._preloaded is not None:
            arg_params, aux_params = self._preloaded
        if initializer is None and not (arg_params or aux_params):
            initializer = init_mod.Uniform(0.01)
        inputs = self._input_names()
        attr_dict = self.symbol.attr_dict()
        with torch.no_grad():
            for name, arr in self._exec.arg_dict.items():
                if name in inputs:
                    continue
                if arg_params and name in arg_params:
                    arr.data.copy_(_tensor(arg_params[name]))
                elif initializer is not None:
                    desc = init_mod.InitDesc(name,
                                             attrs=attr_dict.get(name, {}))
                    init_mod.create(initializer)(desc, arr)
                elif not allow_missing:
                    raise MXNetError(f"parameter {name} missing and no "
                                     "initializer")
            for name, arr in self._exec.aux_dict.items():
                if aux_params and name in aux_params:
                    arr.data.copy_(_tensor(aux_params[name]))
                else:
                    arr.data.fill_(1.0 if name.endswith("var") else 0.0)
        if arg_params and not allow_extra:
            extra = set(arg_params) - set(self._exec.arg_dict)
            if extra:
                raise MXNetError(f"arg_params names unknown parameters "
                                 f"{sorted(extra)}")
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """Create the optimizer and its updater.  A named optimizer gets
        ``rescale_grad = 1/batch``, because the loss head's gradients are
        summed over the batch (reference `module.py:332-333`; times the
        workers of a ``dist_*_sync`` store).  A `KVStore` object, or a
        type name with ``dist``, updates on the store (reference
        `_update_params_on_kvstore`); another name updates locally."""
        if self.optimizer_initialized and not force_init:
            return
        self._kvstore = None
        self._kv_inited = set()
        if isinstance(kvstore, str) and "dist" in kvstore:
            from .. import kvstore as kv_mod
            kvstore = kv_mod.create(kvstore)
        batch_size = self._data_shapes[0].shape[0] if self._data_shapes \
            else None
        if batch_size and kvstore and not isinstance(kvstore, str) and \
                "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        idx2name = dict(enumerate(self._exec.arg_names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params or {})
            if batch_size and "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / batch_size
            optimizer_params.setdefault("param_idx2name", idx2name)
            optimizer_params.setdefault("sym", self.symbol)
            optimizer = opt_mod.create(optimizer, **optimizer_params)
        elif batch_size and \
                abs(optimizer.rescale_grad - 1.0 / batch_size) > 1e-12:
            warnings.warn(
                "Optimizer created manually outside Module but rescale_grad "
                f"is not normalized to 1.0/batch_size "
                f"({optimizer.rescale_grad} vs {1.0 / batch_size}). Is this "
                "intended?", stacklevel=2)
        optimizer.idx2name = idx2name
        if not optimizer.sym_info:
            optimizer.sym_info = (self.symbol.attr_dict(),
                                  self.symbol.list_arguments())
            optimizer.set_lr_mult(optimizer._args_lr_mult)
            optimizer.set_wd_mult(optimizer._args_wd_mult)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        if kvstore and not isinstance(kvstore, str):
            self._kvstore = kvstore
            kvstore.set_optimizer(self._optimizer)
        if self._preload_states:
            self.load_optimizer_states(self._preload_states)
            self._preload_states = None
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def _batch_feeds(self, data_batch):
        """The batch's arrays by input name; a batch of other shapes
        first reshapes the executor (reference `module.py:_reshape_exec`:
        up-sizing allowed, a parameter's shape change still raises)."""
        feeds = dict(zip((d.name for d in self._data_shapes),
                         data_batch.data))
        if self._label_shapes and data_batch.label is not None:
            feeds.update(zip((d.name for d in self._label_shapes),
                             data_batch.label))
        if any(tuple(a.shape) != tuple(self._exec.arg_dict[n].shape)
               for n, a in feeds.items()):
            self._reshape_exec({n: tuple(a.shape) for n, a in feeds.items()})
        return feeds

    def _reshape_exec(self, shapes):
        """Switch to the executor at ``shapes``: one this module reshaped
        to before, while it still holds the current executor's parameter
        arrays, else a new `Executor.reshape`."""
        cur = self._exec
        self._execs[_shape_key(cur)] = [cur, self._fused_train_step]
        entry = self._execs.get(_shape_key(cur, shapes))
        if entry is None or not _same_params(entry[0], cur, shapes):
            entry = [cur.reshape(allow_up_sizing=True, **shapes), None]
        self._exec, self._fused_train_step = entry

    def reshape(self, data_shapes, label_shapes=None):
        """Bind to new input shapes over the same parameters (reference
        `module.py:reshape` -> `Executor.reshape`)."""
        if not self.binded:
            raise MXNetError("call bind before reshape")
        self._data_shapes, self._label_shapes, shapes = _parse_shapes(
            data_shapes, label_shapes)
        self._reshape_exec(shapes)

    def forward(self, data_batch, is_train=None):
        """Feed the batch and run the graph (training mode records the
        tape for `backward`)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before forward")
        if is_train is None:
            is_train = self.for_training
        feeds = self._batch_feeds(data_batch)
        self._exec.compiled_forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before backward")
        self._exec.compiled_backward(out_grads)

    def fused_step(self, data_batch, eval_metric=None):
        """Forward, backward and the update of every parameter as one
        step (`fused_step.FusedTrainStep`), with ``eval_metric``
        accumulated inside it where it can be.  False, with nothing
        changed, where the reference's returns False (reference
        `module.py:fused_step`): ``MXTPU_FUSED_STEP=0``, a module not
        bound for training or not initialized, a gradient of an input
        (``inputs_need_grad``), a ``grad_req`` other than 'write', a
        batch without every input, or an optimizer without a
        multi-tensor plan; and, unlike the JAX package, a graph holding
        an op no CUDA graph can hold (`graph_compile.one_graph`).  The
        caller then runs ``forward_backward()`` + ``update()``."""
        self.last_step_metric_done = False
        if not (fused_enabled() and self.binded and self.params_initialized
                and self.optimizer_initialized and self.for_training
                and self._kvstore is None and self._exec._monitor is None
                and self._group2ctxs is None and self._one_graph()):
            return False
        if any(getattr(a, "stype", "default") != "default"
               for a in list(data_batch.data) + list(data_batch.label or [])):
            return False
        inputs = self._input_names()
        train_names = []
        for name in self._exec._grad_arg_names:
            if name in inputs or self._exec._grad_req.get(name) != "write":
                return False
            train_names.append(name)
        if not train_names:
            return False
        if data_batch.label is None and self._label_shapes:
            return False
        feeds = self._batch_feeds(data_batch)
        if set(feeds) != inputs - set(self._state_names):
            return False
        fst = self._fused_train_step
        if (fst is None or fst._exec is not self._exec
                or fst._optimizer is not self._optimizer
                or fst._updater is not self._updater
                or fst._train_names != train_names):
            fst = self._fused_train_step = self._exec.make_fused_step(
                self._optimizer, self._updater, train_names)
        fst.attach_metric(eval_metric,
                          [d.name for d in self._label_shapes])
        if not fst.step(feeds):
            _prof.bump_counter("fallback_steps")
            return False
        self.last_step_metric_done = fst.metric_in_trace
        return True

    def _one_graph(self) -> bool:
        """`graph_compile.one_graph` of the module's symbol, computed
        once."""
        if self._one_graph_of[0] is not self.symbol:
            self._one_graph_of = (self.symbol, one_graph(self.symbol))
        return self._one_graph_of[1]

    def update(self):
        """Apply the optimizer to every parameter that has a gradient
        (reference `module.py:644`).  Locally: one multi-tensor update, or
        with ``MXTPU_FUSED_STEP=0`` (or an optimizer without a
        multi-tensor plan) the per-parameter loop.  On a store: one
        ``pushpull`` of every gradient into its weight, keyed by name, in
        parameter order (priority -position)."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer before update")
        skip = self._input_names() | self._fixed_param_names
        items = [(i, self._exec.grad_dict[name], self._exec.arg_dict[name])
                 for i, name in enumerate(self._exec.arg_names)
                 if name not in skip and name in self._exec.grad_dict]
        if self._kvstore is not None:
            names = [self._exec.arg_names[i] for i, _g, _w in items]
            for name, (_i, _g, weight) in zip(names, items):
                if name not in self._kv_inited:
                    self._kvstore.init(name, weight)
                    self._kv_inited.add(name)
            self._kvstore.pushpull(names, [g for _i, g, _w in items],
                                   out=[w for _i, _g, w in items],
                                   priority=[-j for j in range(len(items))])
            return
        if fused_enabled() and self._updater.update_multi(items):
            return
        for index, grad, weight in items:
            self._updater(index, grad, weight)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        """Hand every forward's outputs to ``mon`` (reference
        `module.py:install_monitor`)."""
        mon.install(self._exec)

    def _active_updater(self):
        """The updater that applies the updates: the store's under
        update-on-kvstore, else the module's."""
        if self._kvstore is not None and \
                self._kvstore._updater_obj is not None:
            return self._kvstore._updater_obj
        return self._updater

    # ------------------------------------------------------------------
    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def get_params(self):
        """Copies of the parameters: ``(arg_params, aux_params)``."""
        inputs = self._input_names()
        arg = {n: NDArray(a.data.detach().clone())
               for n, a in self._exec.arg_dict.items() if n not in inputs}
        aux = {n: NDArray(a.data.detach().clone())
               for n, a in self._exec.aux_dict.items()}
        return arg, aux

    # -- states held across batches (reference `module.py:get_states`) ----
    def get_states(self, merge_multi_context=True):
        """Copies of the state arrays, one per ``state_names`` entry, so a
        later `set_states` cannot change a saved snapshot."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before get_states")
        states = [NDArray(self._exec.arg_dict[n].data.detach().clone())
                  for n in self._state_names]
        return states if merge_multi_context else [[s] for s in states]

    def set_states(self, states=None, value=None):
        """Write the states in place, from arrays (`get_states`' merged or
        per-device form) or one scalar ``value``."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before set_states")
        if (states is None) == (value is None):
            raise MXNetError("set_states: give exactly one of states and "
                             "value")
        with torch.no_grad():
            if value is not None:
                for name in self._state_names:
                    self._exec.arg_dict[name].data.fill_(float(value))
                return
            if len(states) != len(self._state_names):
                raise MXNetError(f"set_states: {len(states)} states for "
                                 f"{len(self._state_names)} state_names")
            for name, src in zip(self._state_names, states):
                if isinstance(src, (list, tuple)):
                    src = src[0]
                self._exec.arg_dict[name].data.copy_(_tensor(src))

    # -- checkpoints (reference `module.py:save_checkpoint`) ---------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` and ``prefix-NNNN.params``, and with
        ``save_optimizer_states`` the updater's ``prefix-NNNN.states``."""
        from ..model import save_checkpoint
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self.symbol, arg, aux)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of a checkpoint's symbol whose bind or init_params
        takes the checkpoint's parameters, and whose init_optimizer the
        ``.states`` with ``load_optimizer_states``; ``kwargs`` go to the
        constructor."""
        from ..model import load_checkpoint
        sym, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg, aux)
        mod._preload_states = (f"{prefix}-{epoch:04d}.states"
                               if load_optimizer_states else None)
        return mod

    def save_optimizer_states(self, fname):
        from ..serialization import atomic_write
        if self._updater is None:
            raise MXNetError("call init_optimizer before "
                             "save_optimizer_states")
        atomic_write(fname, self._active_updater().get_states(),
                     checksum=True)

    def load_optimizer_states(self, fname):
        from ..serialization import read_payload
        self.load_optimizer_states_bytes(read_payload(fname))

    def load_optimizer_states_bytes(self, blob: bytes) -> None:
        """Load `Updater.get_states` bytes of either package into the
        active updater; an optimizer in them (with its update counts)
        becomes the module's."""
        if self._updater is None:
            raise MXNetError("call init_optimizer before "
                             "load_optimizer_states")
        upd = self._active_updater()
        upd.set_states(blob)
        if upd is self._updater:
            self._optimizer = upd.optimizer


def _fold_contexts(ctxs, work_load_list, logger):
    """The one context a list folds onto (its first), with the JAX
    package's warnings where it would not split the batch."""
    if len(ctxs) > 1:
        devices = [c.device for c in ctxs]
        if work_load_list is not None and len(set(work_load_list)) > 1:
            logger.warning(
                "non-uniform work_load_list is not supported by the "
                "mesh data-parallel path; running on %s only (use "
                "mxnet_tpu_torch.executor_manager for weighted slicing)",
                ctxs[0])
        elif len(set(devices)) < len(devices):
            logger.warning(
                "context list resolves to duplicate devices (%s); running "
                "single-device on %s", devices, ctxs[0])
        else:
            logger.warning(
                "context list spans %d devices (%s); running single-device "
                "on %s: splitting a batch across cards waits for a run on "
                "two cards", len(devices), devices, ctxs[0])
    return ctxs[0]


def _one_group2ctx(group2ctxs, logger):
    """``group2ctxs`` as one {group: context} map, reduced as the JAX
    package reduces it: a list of per-context maps and a map of
    per-context lists take their first entry."""
    if isinstance(group2ctxs, (list, tuple)) and group2ctxs:
        if len(group2ctxs) > 1:
            logger.info("group2ctxs list has %d per-replica dicts; the "
                        "module runs one executor, using the first",
                        len(group2ctxs))
        group2ctxs = group2ctxs[0]
    if isinstance(group2ctxs, dict):
        return {g: (c[0] if isinstance(c, (list, tuple)) else c)
                for g, c in group2ctxs.items()}
    return None


def _shape_key(executor, shapes=None):
    """The input shapes an executor is bound at, as a key: each argument's
    shape, ``shapes`` overriding."""
    shapes = shapes or {}
    return tuple((n, tuple(shapes.get(n, a.shape)))
                 for n, a in executor.arg_dict.items())


def _same_params(old, cur, shapes) -> bool:
    """Whether ``old`` holds ``cur``'s arrays for every argument and aux
    state that is not an input of ``shapes``."""
    return all(old.arg_dict[n] is a for n, a in cur.arg_dict.items()
               if n not in shapes) and \
        all(old.aux_dict.get(n) is a for n, a in cur.aux_dict.items())


def _parse_shapes(data_shapes, label_shapes):
    data = [d if isinstance(d, DataDesc) else DataDesc(*d[:2])
            for d in data_shapes]
    label = [d if isinstance(d, DataDesc) else DataDesc(*d[:2])
             for d in (label_shapes or [])]
    shapes: Dict[str, tuple] = {d.name: tuple(d.shape) for d in data}
    shapes.update({d.name: tuple(d.shape) for d in label})
    return data, label, shapes
