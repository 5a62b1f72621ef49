"""SequentialModule: chain modules, feeding each one's outputs to the next
(the counterpart of `mxnet_tpu/module/sequential_module.py`; reference
`python/mxnet/module/sequential_module.py`).  ``add(module,
take_labels=True)`` hands a module the batch's labels; ``auto_wiring``
renames the previous module's outputs to this one's data names.  Every
module after the first binds with ``inputs_need_grad``, so the backward
carries each module's input gradients to the one before."""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(kwargs)
        return self

    @property
    def symbol(self):
        """Last module's symbol (reference `sequential_module.py`:
        checkpoint callbacks save the chain tail)."""
        return self._modules[-1].symbol if self._modules else None

    @symbol.setter
    def symbol(self, v):
        pass  # BaseModule.__init__ assigns None; per-module symbols rule

    @property
    def data_names(self):
        return self._modules[0].data_names

    @property
    def output_names(self):
        return self._modules[-1].output_names

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert self._modules, "add modules first"
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            take_labels = meta.get(self.META_TAKE_LABELS, False)
            if meta.get(self.META_AUTO_WIRING, False) and i > 0:
                # rewire: previous outputs feed this module's inputs by
                # position (reference auto_wiring)
                my_data_shapes = [
                    DataDesc(name, d.shape) for name, d in
                    zip(module.data_names, my_data_shapes)]
            module.bind(my_data_shapes,
                        label_shapes if take_labels or
                        i == len(self._modules) - 1 else None,
                        for_training=for_training,
                        inputs_need_grad=(inputs_need_grad or i > 0),
                        force_rebind=force_rebind, grad_req=grad_req)
            my_data_shapes = [
                DataDesc(name, shape) for name, shape in
                zip(module.output_names,
                    [s for _, s in module.output_shapes])]
        self.binded = True
        self.for_training = for_training

    def init_params(self, **kwargs):
        """Every module's parameters; ``arg_params`` may name the whole
        chain's, each module takes its own (the others are extra to it)."""
        kwargs.setdefault("allow_extra", True)
        for m in self._modules:
            m.init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        for m in self._modules:
            m.init_optimizer(**kwargs)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            outs = module.get_outputs()
            batch = DataBatch(data=outs, label=data_batch.label,
                              pad=getattr(data_batch, "pad", 0))

    def backward(self, out_grads=None):
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self):
        return self._modules[0].get_input_grads()

    def get_params(self):
        arg, aux = {}, {}
        for m in self._modules:
            a, x = m.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._modules[-1].update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for m in self._modules:
            m.install_monitor(mon)
