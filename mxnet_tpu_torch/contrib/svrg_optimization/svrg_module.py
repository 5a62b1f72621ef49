"""SVRG training (the counterpart of
`mxnet_tpu/contrib/svrg_optimization/svrg_module.py`; reference
`python/mxnet/contrib/svrg_optimization/`).

Stochastic Variance-Reduced Gradient: every `update_freq` epochs a full
pass computes the exact gradient at a snapshot of the weights; each
minibatch then steps with  g(w) - g(w_snapshot) + g_full  — variance
shrinks as w approaches the snapshot.  `SVRGModule` drives two `Module`s
(live weights and snapshot weights) and corrects the gradients between
backward and update, the reference's `_SVRGOptimizer` arithmetic without
its key-mangling indirection.  The full-gradient sums and the averaged
gradients stay on the module's device, in the gradients' dtype, summed
in batch order as the JAX package sums them on the host.  The correction
sits between backward and update, so ``fit`` drives forward, backward,
the correction and ``update`` itself and never takes `Module`'s fused
one-program step."""
from __future__ import annotations

from ...module.module import Module

__all__ = ["SVRGModule"]


class SVRGModule(Module):
    """Module with SVRG gradient correction (reference `svrg_module.py`).

    Parameters mirror `Module`, plus `update_freq`: the number of epochs
    between full-gradient snapshots."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), update_freq: int = 2,
                 **kwargs):
        super().__init__(symbol, data_names=data_names,
                         label_names=label_names, **kwargs)
        if update_freq < 1:
            raise ValueError("update_freq must be >= 1")
        self.update_freq = update_freq
        self._mod_aux = Module(symbol, data_names=data_names,
                               label_names=label_names, **kwargs)
        self._param_dict = None      # full gradients at the snapshot
        self._snapshot_epoch = -1

    # -- snapshot machinery ---------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        super().bind(data_shapes, label_shapes, for_training, **kwargs)
        self._mod_aux.bind(data_shapes, label_shapes, for_training,
                           **kwargs)

    def take_snapshot(self):
        """Copy live weights into the snapshot module."""
        args, auxs = self.get_params()
        self._mod_aux.init_params(arg_params=args, aux_params=auxs,
                                  allow_missing=False, force_init=True)

    def update_full_grads(self, train_data):
        """One full pass at the snapshot weights -> averaged gradients
        (reference `svrg_module.py:update_full_grads`)."""
        train_data.reset()
        accum = None
        nbatch = 0
        for batch in train_data:
            self._mod_aux.forward(batch, is_train=True)
            self._mod_aux.backward()
            grads = [g.data for g in
                     self._mod_aux._exec.grad_arrays if g is not None]
            if accum is None:
                accum = [g.clone() for g in grads]
            else:
                for a, g in zip(accum, grads):
                    a.add_(g)
            nbatch += 1
        self._param_dict = [a / nbatch for a in accum]
        train_data.reset()

    def _svrg_correct_gradients(self, batch):
        """g <- g - g_snapshot(batch) + g_full  on the live module's grad
        arrays (the reference does this inside _SVRGOptimizer.update)."""
        self._mod_aux.forward(batch, is_train=True)
        self._mod_aux.backward()
        snap = [g for g in self._mod_aux._exec.grad_arrays if g is not None]
        live = [g for g in self._exec.grad_arrays if g is not None]
        for g, gs, gf in zip(live, snap, self._param_dict):
            g.data.copy_(g.data - gs.data + gf)

    # -- training loop ----------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            num_epoch=None, optimizer="sgd", optimizer_params=None,
            initializer=None, batch_end_callback=None,
            epoch_end_callback=None, validation_metric=None, **kwargs):
        """Reference `svrg_module.py:fit`: Module.fit's loop with the
        snapshot + full-grad pass every `update_freq` epochs."""
        assert num_epoch is not None, "please specify num_epoch"
        from ... import metric as metric_mod
        from ... import initializer as init_mod
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True)
        self.init_params(initializer=initializer or init_mod.Uniform(0.01))
        self._mod_aux.init_params(
            initializer=initializer or init_mod.Uniform(0.01))
        self.init_optimizer(optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(num_epoch):
            if epoch % self.update_freq == 0:
                self.take_snapshot()
                self.update_full_grads(train_data)
                self._snapshot_epoch = epoch
            eval_metric.reset()
            train_data.reset()
            for nbatch, batch in enumerate(train_data):
                self.forward(batch, is_train=True)
                self.backward()
                self._svrg_correct_gradients(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback:
                    from ...module.base_module import _BatchEndParam
                    for cb in (batch_end_callback
                               if isinstance(batch_end_callback, list)
                               else [batch_end_callback]):
                        cb(_BatchEndParam(epoch, nbatch, eval_metric,
                                          locals()))
            if epoch_end_callback:
                args, auxs = self.get_params()
                for cb in (epoch_end_callback
                           if isinstance(epoch_end_callback, list)
                           else [epoch_end_callback]):
                    cb(epoch, self.symbol, args, auxs)
            if eval_data is not None:
                vm = validation_metric or eval_metric
                if not isinstance(vm, metric_mod.EvalMetric):
                    vm = metric_mod.create(vm)
                self.score(eval_data, vm)
