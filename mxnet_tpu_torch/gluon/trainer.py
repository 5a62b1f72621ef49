"""Gluon Trainer (the counterpart of `mxnet_tpu/gluon/trainer.py`;
reference `python/mxnet/gluon/trainer.py:27`).

`step(batch_size)` sets ``rescale_grad = scale / batch_size``, reduces the
gradients across a parameter's replicas (`allreduce_grads`) and updates
every parameter whose gradient a backward wrote since the last update
(the stale-gradient guard raises otherwise, unless
``ignore_stale_grad``).  With one replica per parameter and no store in
the middle, the whole update runs through the multi-tensor path
(`Updater.update_multi`, `unified_step.multi_tensor_apply`: a few
``torch._foreach_*`` launches per group of parameters that share their
op and hyperparameters), with the same numbers as the per-parameter loop,
which runs otherwise and under ``MXTPU_FUSED_STEP=0``.

With one context per parameter and no ``dist`` store the Trainer skips
the store, whether ``kvstore`` names one or is a `kvstore.KVStore` (its
reduce is the identity, as in the reference's `_init_kvstore`).  With
replicas on several contexts (``initialize(ctx=[...])``) it creates the
store: one ``pushpull`` of every gradient sums the replicas on the first
one's device and writes the sum back into each (or, with
``update_on_kvstore``, the store runs the optimizer and each replica
pulls the weight).  Each replica has its own updater, seeded from the
first one's states, so the replicas' optimizer states evolve alike.  A
``dist`` store raises until the port's distributed plane comes.
"""
from __future__ import annotations

from typing import Dict, List

from .. import optimizer as opt
from .. import profiler as _prof
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies an Optimizer to a set of Parameters."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}.")
        self._params: List[Parameter] = []
        self._param2idx: Dict[str, int] = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    f"got list of {type(param)}.")
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        # parameters still waiting for their deferred init when the store
        # came up; `_init_params` puts them on the store once they have
        # values
        self._params_to_init = []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params and set(optimizer_params) != {"rescale_grad"}:
                raise ValueError(
                    "optimizer_params must be None if optimizer is an "
                    "instance of Optimizer instead of str")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        # one updater per replica (reference `trainer.py:103`), grown in
        # `_update` as replicas appear
        self._updaters = [opt.get_updater(self._optimizer)]

    @property
    def _updater(self):
        return self._updaters[0]

    def _init_kvstore(self):
        """Create the store where a parameter has several replicas or the
        store is ``dist`` (reference `trainer.py:169`)."""
        self._kv_initialized = True
        kv = self._kv_type
        if kv is None or kv is False:
            return
        replicas = max((len(p.list_ctx()) for p in self._params), default=1)
        if replicas <= 1 and "dist" not in str(getattr(kv, "type", kv)):
            return
        if "dist" in str(getattr(kv, "type", kv)):
            raise MXNetError(
                f"Trainer: kvstore={kv!r} over {replicas} context(s) needs "
                "data parallelism across devices or processes, which comes "
                "with the port's SPMD trainer over torch.distributed.  Use "
                "one context per parameter, or kvstore=None")
        from .. import kvstore as kvs
        self._kvstore = kv if isinstance(kv, kvs.KVStore) \
            else kvs.create(str(kv))
        if self._compression_params:
            self._kvstore.set_gradient_compression(self._compression_params)
        if self._update_on_kvstore is None:
            self._update_on_kvstore = False
        self._params_to_init = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if param._deferred_init is not None:
                self._params_to_init.append((i, param))
            else:
                self._kvstore.init(i, param.list_data()[0])
        if self._update_on_kvstore:
            self._kvstore.set_optimizer(self._optimizer)

    def _init_params(self):
        """Put on the store the parameters that have values since
        `_init_kvstore`, and copy the store's value into every replica
        (reference `trainer.py:_init_params`)."""
        remaining = []
        for i, param in self._params_to_init:
            if param._deferred_init is not None:
                remaining.append((i, param))
                continue
            self._kvstore.init(i, param.list_data()[0])
            self._kvstore.pull(i, param.list_data(), priority=-i)
        self._params_to_init = remaining

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update, gradients scaled by ``1 / batch_size`` (reference
        `trainer.py:302`)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """The gradients' reduction across replicas: the identity with one
        replica."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One ``pushpull`` of every gradient (``push`` under
        ``update_on_kvstore``), front parameters first (``priority=-i``;
        reference `trainer.py:353`)."""
        if self._kvstore is None:
            return
        if self._params_to_init:
            self._init_params()
        keys, grads = [], []
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                keys.append(i)
                grads.append(param.list_grad())
        if not keys:
            return
        prios = [-i for i in keys]
        if self._update_on_kvstore:
            self._kvstore.push(keys, grads, priority=prios)
        else:
            self._kvstore.pushpull(keys, grads, out=grads, priority=prios)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is not None and self._update_on_kvstore:
            raise MXNetError(
                "update() when parameters are updated on kvstore is not "
                "supported; try setting `update_on_kvstore` to False")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _stale(self, param, arr) -> MXNetError:
        return MXNetError(
            f"Gradient of Parameter `{param.name}` on context "
            f"{arr.context} has not been updated by backward since last "
            "`step`. This could mean a bug in your model that made it "
            "only use a subset of the Parameters (Blocks) for this "
            "iteration. If you are intentionally only using a subset, "
            "call step with ignore_stale_grad=True to suppress this "
            "warning and skip updating of Parameters with stale gradient")

    def _update(self, ignore_stale_grad=False):
        from ..fused_step import fused_enabled
        batch = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            datas = param.list_data()
            if not ignore_stale_grad:
                for arr in datas:
                    if not arr._fresh_grad:
                        raise self._stale(param, arr)
            elif not any(arr._fresh_grad for arr in datas):
                continue
            if self._kvstore is not None and self._update_on_kvstore:
                self._kvstore.pull(i, datas, priority=-i)
                for arr in datas:
                    arr._fresh_grad = False
                continue
            if len(datas) > len(self._updaters):
                # a new replica's updater starts from the first one's
                # states (a `load_states` before the first update)
                blob = self._updaters[0].get_states(dump_optimizer=False)
                while len(self._updaters) < len(datas):
                    u = opt.get_updater(self._optimizer)
                    u.set_states(blob)
                    self._updaters.append(u)
            if len(datas) == 1 and len(self._updaters) == 1:
                batch.append((i, datas[0].grad, datas[0]))
                continue
            for upd, arr in zip(self._updaters, datas):
                if ignore_stale_grad and not arr._fresh_grad:
                    continue
                upd(i, arr.grad, arr)
                arr._fresh_grad = False
        if not batch:
            return
        if not (fused_enabled() and self._kvstore is None
                and self._updater.update_multi(batch)):
            if fused_enabled():
                _prof.bump_counter("fallback_steps")
            for i, grad, arr in batch:
                self._updater(i, grad, arr)
        for _, _, arr in batch:
            arr._fresh_grad = False

    def state_bytes(self) -> bytes:
        """The optimizer's states with the optimizer and its update counts,
        as one blob (what `checkpoint.CheckpointManager.save(trainer=...)`
        keeps)."""
        return self._updater.get_states(dump_optimizer=True)

    def load_state_bytes(self, states: bytes) -> None:
        """Load a `state_bytes` blob into every replica's updater; its
        optimizer becomes the trainer's, over the trainer's
        parameters."""
        for updater in self._updaters:
            updater.set_states(states)
            updater.optimizer = self._updaters[0].optimizer
        self._optimizer = self._updaters[0].optimizer

    def save_states(self, fname):
        """`state_bytes` to ``fname``, written atomically with the CRC32
        footer."""
        from ..serialization import atomic_write
        atomic_write(fname, self.state_bytes(), checksum=True)

    def load_states(self, fname):
        from ..serialization import read_payload
        self.load_state_bytes(read_payload(fname))
