"""Optimizers (the counterpart of `mxnet_tpu/optimizer/optimizer.py`; reference
`python/mxnet/optimizer/optimizer.py`): `Optimizer` with its learning-rate
schedule, per-parameter lr/wd multipliers (from the symbol's attrs, the
names, or ``param_dict``) and multi-precision master weights, every
optimizer the JAX package registers (`SGD` with its ``mp_sgd`` ops,
`ccSGD`, `Signum`, `NAG`, `Adam`, `AdaGrad`, `RMSProp`, `AdaDelta`,
`Ftrl`, `Adamax`, `Nadam`, `FTML`, `DCASGD`, `SGLD`, `LBSGD`, `Test`;
`GroupAdaGrad` in `contrib`), and the `Updater` that holds their states.
The optimizers the JAX package writes in NDArray arithmetic are written
here in the same order of operations on the weight's tensors; SGLD's
noise comes from the weight's device generator, so it matches the JAX
package's in distribution only.  A
row-sparse gradient is densified and updates every row, as in the JAX
package: ``lazy_update`` is accepted and stored, with no lazy rows.

Each `update` runs one registered update op of `ops/optimizer_ops.py` on
the weight's own tensors and writes the new weight it returns into the
weight, as the reference's ``out=weight`` does.  ``_fused_plan`` names that op for the
multi-tensor path (`unified_step.multi_tensor_apply`, which
`Updater.update_multi` takes), and ``_fused_scalars`` the lr and wd it
passes, so both paths give the same numbers.  States live on the weight's
device, which is the card unless the caller bound elsewhere.

`Updater.get_states` writes the JAX package's pickle: each state as numpy
arrays, and with ``dump_optimizer`` the optimizer too.  Classes in it are
named by the JAX package's module paths (`_StatePickler`) and read back
onto the port's (`_StateUnpickler`), so a states file of either package
loads in the other; the port never imports the JAX package to do so.
"""
from __future__ import annotations

import io
import math
import pickle
from typing import Any, Dict

import numpy as np
import torch

from .. import random as _random
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops import registry as _reg

__all__ = ["Optimizer", "SGD", "ccSGD", "Signum", "NAG", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "FTML", "DCASGD",
           "SGLD", "LBSGD", "Test", "Updater", "get_updater", "create",
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


@torch.no_grad()
def _run(op_name: str, tensors, **attrs) -> None:
    """Op ``op_name`` on ``tensors`` (weight, grad, states): the states
    update in place, and the new weight is written into the weight."""
    new = _reg.apply_op(op_name, [t.data for t in tensors], attrs)[0]
    tensors[0].data.copy_(new)


class Optimizer:
    """Base optimizer (reference `optimizer.py:37`)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        # per-device update counts (reference `_all_index_update_counts`):
        # each replica of a weight sees t = 1, 2, 3, ...
        self._all_index_update_counts: Dict[int, Dict[Any, int]] = {0: {}}
        self._index_update_count: Dict[Any, int] = \
            self._all_index_update_counts[0]
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = dict(param_dict or {})
        # (attr_dict, arg_names) read by set_lr_mult/set_wd_mult for the
        # per-variable __lr_mult__/__wd_mult__ attrs
        self.sym_info = ((sym.attr_dict(), sym.list_arguments())
                         if sym is not None else ())
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    create_optimizer = staticmethod(create)

    def __getstate__(self):
        # a Trainer's ``param_dict`` holds its live Parameters: the
        # trainer attaches them again after a load
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

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

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        """The schedule's rate at the current update count, or ``lr``."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def _set_current_context(self, device_id: int):
        """Switch to ``device_id``'s update-count table (reference
        `optimizer.py:_set_current_context`)."""
        if device_id not in self._all_index_update_counts:
            self._all_index_update_counts[device_id] = {}
        self._index_update_count = self._all_index_update_counts[device_id]

    def _update_count(self, index):
        count = self._index_update_count.setdefault(index,
                                                    self.begin_num_update)
        self._index_update_count[index] = count + 1
        self.num_update = max(count + 1, self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
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

    def _mp_active(self, weight) -> bool:
        return self.multi_precision and weight.data.element_size() < 4

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision``, a float32 master copy beside the
        state of a weight narrower than 32 bits (reference
        `optimizer.py:375`)."""
        if self._mp_active(weight):
            w32 = NDArray(weight.data.float())
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """`update`, on the float32 master copy when multi-precision
        holds one, which is then copied down into the weight."""
        if not self._mp_active(weight):
            return self.update(index, weight, grad, state)
        inner, w32 = state
        self._update_mp(index, weight, NDArray(grad.data.float()), inner,
                        w32)

    def _update_mp(self, index, weight, grad32, state, weight32):
        """The update on the master copy, rounded into the weight
        (reference `optimizer.py:179`); an optimizer with ``mp_`` ops
        overrides it."""
        self.update(index, weight32, grad32, state)
        weight.data.copy_(weight32.data)

    def _fused_plan(self, index, weight, state):
        """``(op name, static attrs, state NDArrays)``: the one update op
        `update` runs for this weight, for the multi-tensor path; None
        when there is none (the caller then loops `update`)."""
        return None

    def _fused_scalars(self, index):
        """``(lr, wd)`` for the multi-tensor path after
        ``_update_count(index)``, with the host-side factors `update`
        folds into lr."""
        return self._get_lr(index), self._get_wd(index)

    def multi_update(self, items) -> bool:
        """Update many weights (``items``: ``[(index, weight, grad,
        state)]`` in the per-parameter order) through the multi-tensor
        path; False, with nothing changed, when a weight has no plan."""
        from ..unified_step import multi_tensor_apply
        return multi_tensor_apply(self, items)

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

    def create_state_multi_precision(self, index, weight):
        """``(float32 momentum or None, float32 master)`` for a narrow
        weight under ``multi_precision``."""
        if self._mp_active(weight):
            w32 = NDArray(weight.data.float())
            return (None if self.momentum == 0.0 else _zeros_like(w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._base_kwargs(index)
        if state is not None:
            _run("sgd_mom_update", (weight, grad, state),
                 momentum=self.momentum, **kw)
        else:
            _run("sgd_update", (weight, grad), **kw)

    def update_multi_precision(self, index, weight, grad, state):
        """The ``mp_sgd`` ops on the master copy (reference
        `optimizer.py:258`)."""
        if not self._mp_active(weight):
            return self.update(index, weight, grad, state)
        self._update_count(index)
        kw = self._base_kwargs(index)
        mom, w32 = state
        if mom is not None:
            _run("mp_sgd_mom_update", (weight, grad, mom, w32),
                 momentum=self.momentum, **kw)
        else:
            _run("mp_sgd_update", (weight, grad, w32), **kw)

    def _fused_plan(self, index, weight, state):
        if self._mp_active(weight):
            return None  # the per-parameter ``mp_sgd`` ops
        if state is not None:
            return ("sgd_mom_update", {"momentum": self.momentum}, [state])
        return ("sgd_update", {}, [])


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference `optimizer.py:AdaGrad`): ``eps`` keeps the
    history's square root off zero."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        _run("adagrad_update", (weight, grad, state),
             epsilon=self.float_stable_eps, **self._base_kwargs(index))

    def _fused_plan(self, index, weight, state):
        if self._mp_active(weight):
            return None
        return ("adagrad_update", {"epsilon": self.float_stable_eps},
                [state])


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

    def _fused_plan(self, index, weight, state):
        if self._mp_active(weight):
            return None
        mean, var = state
        return ("adam_update", {"beta1": self.beta1, "beta2": self.beta2,
                                "epsilon": self.epsilon}, [mean, var])

    def _fused_scalars(self, index):
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        return lr, wd


@register
class ccSGD(SGD):  # noqa: N801  (the reference's name)
    """The deprecated alias of SGD (reference `optimizer.py:1101`)."""


@register
class Signum(Optimizer):
    """signSGD, and Signum with momentum (reference `optimizer.py:644`);
    ``wd_lh`` decays the weight outside the sign."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._base_kwargs(index)
        if state is not None:
            _run("signum_update", (weight, grad, state),
                 momentum=self.momentum, wd_lh=self.wd_lh, **kw)
        else:
            _run("signsgd_update", (weight, grad), **kw)

    def _fused_plan(self, index, weight, state):
        if self._mp_active(weight):
            return None
        if state is not None:
            return ("signum_update",
                    {"momentum": self.momentum, "wd_lh": self.wd_lh},
                    [state])
        return ("signsgd_update", {}, [])


@register
class NAG(Optimizer):
    """SGD with Nesterov momentum (reference `optimizer.py` NAG)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._base_kwargs(index)
        if state is not None:
            _run("nag_mom_update", (weight, grad, state),
                 momentum=self.momentum, **kw)
        else:
            _run("sgd_update", (weight, grad), **kw)

    def _fused_plan(self, index, weight, state):
        if self._mp_active(weight):
            return None
        if state is not None:
            return ("nag_mom_update", {"momentum": self.momentum}, [state])
        return ("sgd_update", {}, [])


@register
class RMSProp(Optimizer):
    """RMSProp, plain (Tieleman and Hinton) or ``centered`` (Graves)
    (reference `optimizer.py` RMSProp); ``clip_weights`` is accepted and
    unused, as in the JAX package."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_like(weight) for _ in range(3))
        return _zeros_like(weight)

    def _static(self):
        if self.centered:
            return {"gamma1": self.gamma1, "gamma2": self.gamma2,
                    "epsilon": self.epsilon}
        return {"gamma1": self.gamma1, "epsilon": self.epsilon}

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(self._base_kwargs(index), **self._static())
        if self.centered:
            _run("rmspropalex_update", (weight, grad) + tuple(state), **kw)
        else:
            _run("rmsprop_update", (weight, grad, state), **kw)

    def _fused_plan(self, index, weight, state):
        if self._mp_active(weight):
            return None
        if self.centered:
            return ("rmspropalex_update", self._static(), list(state))
        return ("rmsprop_update", self._static(), [state])


def _clipped(opt, g: torch.Tensor) -> torch.Tensor:
    if opt.clip_gradient is not None:
        return g.clamp(-opt.clip_gradient, opt.clip_gradient)
    return g


@register
class AdaDelta(Optimizer):
    """AdaDelta (Zeiler; reference `optimizer.py` AdaDelta): running means
    of g² and of the squared steps; wd decays the weight after the
    step."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        acc_g, acc_delta = (s.data for s in state)
        w = weight.data
        g = _clipped(self, grad.data * self.rescale_grad)
        new_acc_g = self.rho * acc_g + (1.0 - self.rho) * g * g
        delta = ((acc_delta + self.epsilon).sqrt()
                 / (new_acc_g + self.epsilon).sqrt()) * g
        acc_delta.copy_(self.rho * acc_delta
                        + (1.0 - self.rho) * delta * delta)
        acc_g.copy_(new_acc_g)
        w.copy_(w - delta - wd * w)


@register
class Ftrl(Optimizer):
    """FTRL-Proximal (reference `optimizer.py` Ftrl): the ``ftrl_update``
    op."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        _run("ftrl_update", (weight, grad, z, n), lamda1=self.lamda1,
             beta=self.beta, **self._base_kwargs(index))


@register
class Adamax(Optimizer):
    """AdaMax (Kingma and Ba; reference `optimizer.py` Adamax): the
    infinity norm in place of Adam's second moment."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        m, u = (s.data for s in state)
        w = weight.data
        g = _clipped(self, grad.data * self.rescale_grad + wd * w)
        m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
        u.copy_(torch.maximum(self.beta2 * u, g.abs()))
        w.copy_(w - lr * m / u)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (Dozat; reference `optimizer.py`
    Nadam); the momentum schedule's product is the optimizer's, as in the
    reference."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight.data
        g = _clipped(self, grad.data * self.rescale_grad + wd * w)
        mom_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        mom_t1 = self.beta1 * (
            1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * mom_t
        m_schedule_next = self.m_schedule * mom_t1
        m, v = (s.data for s in state)
        g_prime = g / (1.0 - self.m_schedule)
        m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
        v.copy_(self.beta2 * v + (1.0 - self.beta2) * g * g)
        m_prime = m / (1.0 - m_schedule_next)
        v_prime = v / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - mom_t) * g_prime + mom_t1 * m_prime
        w.copy_(w - lr * m_bar / (v_prime.sqrt() + self.epsilon))


@register
class FTML(Optimizer):
    """FTML (Zheng and Kwok; reference `optimizer.py:711`): the gradient
    takes wd before it is clipped, as the reference class has it."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_like(weight) for _ in range(3))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight.data
        g = _clipped(self, grad.data * self.rescale_grad + wd * w)
        d, v, z = (s.data for s in state)
        v.copy_(self.beta2 * v + (1.0 - self.beta2) * g * g)
        d_t = ((1.0 - self.beta1 ** t) / lr) * (
            (v / (1.0 - self.beta2 ** t)).sqrt() + self.epsilon)
        sigma_t = d_t - self.beta1 * d
        z.copy_(self.beta1 * z + (1.0 - self.beta1) * g - sigma_t * w)
        d.copy_(d_t)
        w.copy_(-z / d_t)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (Zheng et al.; reference
    `optimizer.py` DCASGD): the state keeps the previous weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous: Dict[Any, NDArray] = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, NDArray(weight.data.clone()))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight.data
        g = _clipped(self, grad.data * self.rescale_grad)
        mom, previous = state
        prev = previous.data
        delta = -lr * (g + wd * w + self.lamda * g * g * (w - prev))
        if mom is not None:
            mom.data.copy_(self.momentum * mom.data + delta)
            delta = mom.data
        prev.copy_(w)
        w.add_(delta)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (Welling and Teh; reference
    `optimizer.py` SGLD): a half step plus N(0, lr) noise from the
    weight's device generator."""

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight.data
        g = _clipped(self, grad.data * self.rescale_grad)
        noise = torch.empty_like(w).normal_(
            0.0, 1.0, generator=_random.generator(w.device)) * math.sqrt(lr)
        w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class LBSGD(Optimizer):
    """Large-batch SGD (reference `optimizer.py:769`): with
    ``warmup_strategy='lars'`` the lr of each layer scales by its weight
    and gradient norms (LARS)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.adaptive = warmup_strategy == "lars"

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    @staticmethod
    def _get_lars(weight, g, wd):
        w_norm = float(weight.data.norm())
        g_norm = float(g.data.norm())
        if w_norm > 0 and g_norm > 0:
            return w_norm / (g_norm + wd * w_norm + 1e-9) * 0.001
        return 1.0

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._base_kwargs(index)
        if self.adaptive:
            kw["lr"] *= self._get_lars(weight, grad, kw["wd"])
        if state is not None:
            _run("sgd_mom_update", (weight, grad, state),
                 momentum=self.momentum, **kw)
        else:
            _run("sgd_update", (weight, grad), **kw)


class Test(Optimizer):
    """The reference's test optimizer: w += rescale·g, and the state
    holds the new weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.data.add_(grad.data * self.rescale_grad)
        state.data.copy_(weight.data)


register(Test)


class Updater:
    """The optimizer's states, one entry per parameter index (reference
    `optimizer.py:1608`)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}
        # the sharded training step (`unified_step`, MXTPU_SPMD) while it
        # holds the states in its flat buffers: every path that reads or
        # writes them goes through it
        self._spmd_bridge = None

    def _relinquish(self) -> None:
        b = getattr(self, "_spmd_bridge", None)
        if b is not None:
            b.relinquish()

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            # loaded states land on the host; they join their weight's
            # device at first use
            self.states[index] = _to_device(self.states[index],
                                            weight.data.device)
            self.states_synced[index] = True
        return self.states[index]

    def _set_context(self, weight) -> None:
        self.optimizer._set_current_context(weight.context.device_id)

    def __call__(self, index, grad, weight):
        self._relinquish()
        self._set_context(weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self._state(index, weight))

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states as the JAX package pickles them (reference
        `optimizer.py:1668`): ``{index: numpy state}``, or with
        ``dump_optimizer`` ``(states, optimizer)``, the optimizer carrying
        the update counts."""
        b = getattr(self, "_spmd_bridge", None)
        if b is not None:
            b.export_states()
        states = {k: _state_to_numpy(v) for k, v in self.states.items()}
        obj = (states, self.optimizer) if dump_optimizer else states
        buf = io.BytesIO()
        _StatePickler(buf, pickle.DEFAULT_PROTOCOL).dump(obj)
        return buf.getvalue()

    def set_states(self, blob: bytes) -> None:
        """Load `get_states`' blob, of either package; an optimizer in it
        replaces this updater's (its update counts with it)."""
        obj = _StateUnpickler(io.BytesIO(blob)).load()
        if isinstance(obj, tuple) and len(obj) == 2 and \
                isinstance(obj[1], Optimizer):
            states, loaded = obj
            loaded.param_dict = self.optimizer.param_dict
            self.optimizer = loaded
        else:
            states = obj
        self.states = {k: _state_from_numpy(v) for k, v in states.items()}
        self.states_synced = {k: False for k in self.states}
        b = getattr(self, "_spmd_bridge", None)
        if b is not None:
            b.invalidate()

    def update_multi(self, items) -> bool:
        """Update many parameters (``items``: ``[(index, grad, weight)]``)
        through the multi-tensor path, the same numbers as calling the
        updater on each.  False, having at most created the states the
        per-parameter path would create, when the optimizer has no plan
        for one of them."""
        if not items:
            return True
        self._relinquish()
        self._set_context(items[0][2])
        prepared = [(index, weight, grad, self._state(index, weight))
                    for index, grad, weight in items]
        return self.optimizer.multi_update(prepared)


def _state_to_numpy(state):
    if isinstance(state, NDArray):
        return state.asnumpy()
    if isinstance(state, (tuple, list)):
        return tuple(_state_to_numpy(s) for s in state)
    return state


def _state_from_numpy(state):
    if isinstance(state, np.ndarray):
        return NDArray(torch.from_numpy(np.ascontiguousarray(state)))
    if isinstance(state, tuple):
        return tuple(_state_from_numpy(s) for s in state)
    return state


def _to_device(state, device):
    if isinstance(state, NDArray):
        return NDArray(state.data.to(device))
    if isinstance(state, tuple):
        return tuple(_to_device(s, device) for s in state)
    return state


_REF, _PORT = "mxnet_tpu", "mxnet_tpu_torch"


def _renamed(module: str, src: str, dst: str):
    """``module`` moved from package ``src`` to ``dst``, or None."""
    if module == src or module.startswith(src + "."):
        return dst + module[len(src):]
    return None


class _StatePickler(pickle._Pickler):
    """Names the port's classes by the JAX package's module paths (the
    same path below the package), without importing that package."""

    def save_global(self, obj, name=None):
        ref = _renamed(getattr(obj, "__module__", "") or "", _PORT, _REF)
        if ref is None or self.proto < 4:
            return super().save_global(obj, name)
        self.save(ref)
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _StateUnpickler(pickle.Unpickler):
    """Reads the JAX package's classes as the port's of the same path."""

    def find_class(self, module, name):
        port = _renamed(module, _REF, _PORT)
        if port is None:
            return super().find_class(module, name)
        try:
            return super().find_class(port, name)
        except (ImportError, AttributeError) as e:
            raise MXNetError(f"optimizer states name {module}.{name}, which "
                             "the PyTorch port does not have") from e


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
