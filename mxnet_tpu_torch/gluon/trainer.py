"""Gluon Trainer (the counterpart of `mxnet_tpu/gluon/trainer.py`;
reference `python/mxnet/gluon/trainer.py:27`).

`step(batch_size)` sets ``rescale_grad = scale / batch_size`` and updates
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
reduce is the identity, as in the reference's and the JAX package's
`_init_kvstore`); several contexts, or a ``dist`` store, raise until the
port's SPMD trainer comes.
"""
from __future__ import annotations

from typing import Dict, List

from .. import optimizer as opt
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
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_type = kvstore
        self._kv_checked = False

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
        self._updater = opt.get_updater(self._optimizer)

    def _check_kvstore(self):
        """Skip the store where one context holds every parameter and the
        store is not ``dist`` (the JAX package's `_init_kvstore`); refuse
        the rest, which needs data parallelism."""
        self._kv_checked = True
        kv = self._kv_type
        if kv is None or kv is False:
            return
        replicas = max((len(p.list_ctx()) for p in self._params), default=1)
        if replicas <= 1 and "dist" not in str(kv):
            return
        raise MXNetError(
            f"Trainer: kvstore={kv!r} over {replicas} context(s) needs data "
            "parallelism across devices or processes, which comes with the "
            "port's SPMD trainer over torch.distributed.  Use one context "
            "per parameter, or kvstore=None")

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
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """The gradients' reduction across replicas: the identity with one
        replica."""
        if not self._kv_checked:
            self._check_kvstore()

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_checked:
            self._check_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        from ..fused_step import fused_enabled
        batch = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            arr = param.list_data()[0]
            if not arr._fresh_grad:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Gradient of Parameter `{param.name}` on context "
                    f"{arr.context} has not been updated by backward since "
                    "last `step`. This could mean a bug in your model that "
                    "made it only use a subset of the Parameters (Blocks) "
                    "for this iteration. If you are intentionally only "
                    "using a subset, call step with ignore_stale_grad=True "
                    "to suppress this warning and skip updating of "
                    "Parameters with stale gradient")
            batch.append((i, arr.grad, arr))
        if not batch:
            return
        if not (fused_enabled() and self._updater.update_multi(batch)):
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
        """Load a `state_bytes` blob; its optimizer becomes the trainer's,
        over the trainer's parameters."""
        self._updater.set_states(states)
        self._optimizer = self._updater.optimizer

    def save_states(self, fname):
        """`state_bytes` to ``fname``, written atomically with the CRC32
        footer."""
        from ..serialization import atomic_write
        atomic_write(fname, self.state_bytes(), checksum=True)

    def load_states(self, fname):
        from ..serialization import read_payload
        self.load_state_bytes(read_payload(fname))
