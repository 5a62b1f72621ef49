"""Optimizers (the counterpart of `mxnet_tpu/optimizer/optimizer.py`; reference
`python/mxnet/optimizer/optimizer.py`): `Optimizer` with its per-parameter
lr/wd multipliers, `SGD`, `Adam`, and the `Updater` that holds their
states.

Each `update` runs one registered update op of `ops/optimizer_ops.py` on
the weight's own tensors, in place.  States live on the weight's device,
which is the card unless the caller bound elsewhere.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops import registry as _reg

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register"]

_OPT_REGISTRY: Dict[str, type] = {}


def register(klass):
    """Class decorator: make ``klass`` creatable by its lower-case name
    (reference `Optimizer.register`)."""
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer from its registered name (an instance passes
    through)."""
    if isinstance(name, Optimizer):
        return name
    try:
        return _OPT_REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise MXNetError(f"optimizer {name!r} is not registered") from None


def _zeros_like(weight: NDArray) -> NDArray:
    return NDArray(torch.zeros_like(weight.data))


def _run(op_name: str, tensors, **attrs) -> None:
    _reg.apply_op(op_name, [t.data for t in tensors], attrs)


class Optimizer:
    """Base optimizer (reference `optimizer.py:37`)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, sym=None,
                 begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.idx2name = dict(param_idx2name or {})
        # (attr_dict, arg_names) read by set_lr_mult/set_wd_mult for the
        # per-variable __lr_mult__/__wd_mult__ attrs
        self.sym_info = ((sym.attr_dict(), sym.list_arguments())
                         if sym is not None else ())
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    create_optimizer = staticmethod(create)

    def set_lr_mult(self, args_lr_mult):
        """Symbol ``__lr_mult__`` attrs seed the table; explicit args
        win."""
        self._args_lr_mult = dict(args_lr_mult)
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """No weight decay for a parameter whose name ends in neither
        ``_weight`` nor ``_gamma`` (biases, LayerNorm betas); then the
        symbol's ``__wd_mult__`` attrs; explicit args win (reference
        `optimizer.py:104`)."""
        self._args_wd_mult = dict(args_wd_mult)
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    @property
    def learning_rate(self):
        return self.lr

    def _update_count(self, index):
        count = self._index_update_count.setdefault(index,
                                                    self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _base_kwargs(self, index):
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad)
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(learning_rate={self.learning_rate})"


@register
class SGD(Optimizer):
    """SGD with momentum (reference `optimizer.py:498`)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._base_kwargs(index)
        if state is not None:
            _run("sgd_mom_update", (weight, grad, state),
                 momentum=self.momentum, **kw)
        else:
            _run("sgd_update", (weight, grad), **kw)


@register
class Adam(Optimizer):
    """Adam (reference `optimizer.py:1107`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._base_kwargs(index)
        # bias correction folded into lr (reference optimizer.py:1166)
        kw["lr"] *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        _run("adam_update", (weight, grad, mean, var), beta1=self.beta1,
             beta2=self.beta2, epsilon=self.epsilon, **kw)


class Updater:
    """The optimizer's states, one entry per parameter index (reference
    `optimizer.py:1608`)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def update_multi(self, items) -> bool:
        """Update many parameters (``items``: ``[(index, grad,
        weight)]``), one update op each.  Returns True; one fused update
        over all of them is later work."""
        for index, grad, weight in items:
            self(index, grad, weight)
        return True


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
