"""BucketingModule: one `Module` per sequence length, all sharing one set
of parameters (the counterpart of `mxnet_tpu/module/bucketing_module.py`;
reference `python/mxnet/module/bucketing_module.py`), MXNet's way of
training on sentences of varying length.

``sym_gen(bucket_key)`` gives each bucket's ``(symbol, data_names,
label_names)``.  The default bucket's module is bound first; another
bucket's module is bound at its first batch and takes the default
bucket's parameter, gradient and auxiliary arrays by storage (the same
tensors), and the default bucket's optimizer and updater, so an update
from any bucket lands in the one set of weights and optimizer states.
Each bucket key keeps its slot of the program cache (`_graph_programs`):
the bucket's executor builds its `GraphProgram`s there, once.

On the card a bucket module's inference forward replays a CUDA graph
captured per set of bound tensors (their addresses among them), so a
bucket whose arrays were swapped for the default bucket's never replays
a capture made before the swap; `init_params` and `set_params` write the
shared arrays in place, so captures stay valid across them.  As in the
JAX package there is no fused step: ``fit`` runs ``forward_backward()``
+ ``update()`` per batch, the recorded forward and backward eagerly.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 logger=logging, context=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._state_names = list(state_names or [])
        self._buckets: Dict[Any, Module] = {}
        # {bucket key -> the executor's {train -> GraphProgram}}
        self._graph_programs: Dict[Any, Dict] = {}
        self._curr_module: Optional[Module] = None
        self._curr_bucket_key = None
        self._grad_req = "write"
        self._inputs_need_grad = False

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def data_names(self):
        return self._curr_module.data_names

    @property
    def output_names(self):
        return self._curr_module.output_names

    @property
    def symbol(self):
        """The current bucket's symbol."""
        return None if self._curr_module is None \
            else self._curr_module.symbol

    @symbol.setter
    def symbol(self, value):
        """Per-bucket symbols come from ``sym_gen``; `BaseModule` sets
        None."""

    def _gen_module(self, bucket_key) -> Module:
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    def _adopt_programs(self, mod: Module, bucket_key) -> None:
        mod._exec._programs = self._graph_programs.setdefault(bucket_key,
                                                              {})

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        """Bind the default bucket's module; the others bind the same way
        at their first batch.  ``force_rebind`` starts again from
        ``sym_gen``, keeping the trained parameters' values."""
        if self.binded and not force_rebind:
            return
        self._grad_req = grad_req
        self._inputs_need_grad = inputs_need_grad
        snapshot = self.get_params() if (self.binded and
                                         self.params_initialized) else None
        self._buckets = {}
        self._graph_programs = {}
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                 force_rebind=False, grad_req=grad_req)
        self._adopt_programs(mod, self._default_bucket_key)
        if snapshot is not None:
            mod.init_params(arg_params=snapshot[0], aux_params=snapshot[1],
                            force_init=True)
        self._buckets[self._default_bucket_key] = mod
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        self.for_training = for_training
        self.optimizer_initialized = False

    def _share_optimizer(self, mod: Module) -> None:
        """``mod`` takes the default bucket's optimizer and updater (its
        states, one per parameter index, created once)."""
        default = self._buckets[self._default_bucket_key]
        mod._optimizer = default._optimizer
        mod._updater = default._updater
        mod._kvstore = default._kvstore
        mod._kv_inited = default._kv_inited
        mod.optimizer_initialized = default.optimizer_initialized

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding its module at first use
        with the default bucket's arrays (reference
        `bucketing_module.py:switch_bucket`)."""
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        if bucket_key not in self._buckets:
            mod = self._gen_module(bucket_key)
            mod.bind(data_shapes, label_shapes, self.for_training,
                     self._inputs_need_grad, force_rebind=False,
                     grad_req=self._grad_req)
            default = self._buckets[self._default_bucket_key]
            inputs = mod._input_names()
            ex, dex = mod._exec, default._exec
            for name, arr in dex.arg_dict.items():
                if name in ex.arg_dict and name not in inputs and \
                        tuple(arr.shape) == tuple(ex.arg_dict[name].shape):
                    ex.arg_dict[name] = arr
                    if name in ex.grad_dict and name in dex.grad_dict:
                        ex.grad_dict[name] = dex.grad_dict[name]
            for name, arr in dex.aux_dict.items():
                if name in ex.aux_dict:
                    ex.aux_dict[name] = arr
            mod.params_initialized = default.params_initialized
            self._share_optimizer(mod)
            self._adopt_programs(mod, bucket_key)
            self._buckets[bucket_key] = mod
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    # ------------------------------------------------------------------
    def init_params(self, **kwargs):
        """Fill the shared parameters, in place (through the current
        bucket's module)."""
        if not self.binded:
            raise MXNetError("call bind before init_params")
        self._curr_module.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """Create the optimizer once, on the default bucket's module, and
        share it with every bucket bound so far (later ones take it at
        their bind)."""
        if self.optimizer_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_optimizer")
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params,
                               force_init=force_init)
        for mod in self._buckets.values():
            if mod is not default:
                self._share_optimizer(mod)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        """Forward through the batch's bucket (``data_batch.bucket_key``,
        the current one when None)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind and init_params before forward")
        key = getattr(data_batch, "bucket_key", None)
        if key is not None and key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def get_states(self, merge_multi_context=True):
        """The current bucket's states (reference
        `bucketing_module.py:get_states`)."""
        if not self.binded:
            raise MXNetError("call bind before get_states")
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        if not self.binded:
            raise MXNetError("call bind before set_states")
        self._curr_module.set_states(states=states, value=value)

    def get_params(self):
        return self._curr_module.get_params()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Hand every bucket's forward outputs to ``mon``."""
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def _active_updater(self):
        return self._buckets[self._default_bucket_key]._active_updater()

    def load_optimizer_states_bytes(self, blob: bytes) -> None:
        default = self._buckets[self._default_bucket_key]
        default.load_optimizer_states_bytes(blob)
        for mod in self._buckets.values():
            if mod is not default:
                self._share_optimizer(mod)
