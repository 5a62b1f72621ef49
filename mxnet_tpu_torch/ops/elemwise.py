"""Elementwise ops of the ported paths (the counterparts of
`mxnet_tpu/ops/elemwise.py`): the unary ``sigmoid``, ``tanh``,
``negative`` and ``rsqrt`` (the LSTM cell, the Symbol sugar and the
``fold_bn`` rewrite emit them), ``identity``/``_copy`` and
``BlockGrad``/``stop_gradient`` (which the ``eliminate`` pass forwards),
and the scalar arithmetic ``_plus/_minus/_rminus/_mul/_div/_rdiv_scalar``."""
from __future__ import annotations

import torch

from .registry import alias, register


def _unary(name, fn):
    def compute(attrs, x, _fn=fn):
        return _fn(x)
    compute.__doc__ = f"Elementwise {name}."
    register(name, num_inputs=1, input_names=["data"])(compute)


for _name, _fn in {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
                   "negative": torch.neg, "rsqrt": torch.rsqrt,
                   "identity": lambda x: x}.items():
    _unary(_name, _fn)

alias("negative", "_np_negative")
alias("identity", "_copy")


@register("BlockGrad", num_inputs=1, input_names=["data"])
def _block_grad(attrs, x):
    """The value, with no gradient flowing back (reference `BlockGrad`)."""
    return x.detach()


alias("BlockGrad", "stop_gradient")


def _scalar_op(name, fn):
    def compute(attrs, x, _fn=fn):
        return _fn(x, attrs.get_float("scalar", 0.0))
    compute.__doc__ = f"Scalar {name} (a float x keeps its dtype)."
    register(name, num_inputs=1, input_names=["data"])(compute)


def _rdiv(x, s):
    # s / x as a true division: a python scalar on the left would go
    # through x.reciprocal() * s, one rounding more than the reference
    if x.is_floating_point():
        return torch.div(torch.as_tensor(s, dtype=x.dtype), x)
    return s / x


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": _rdiv,
}

for _name, _fn in _SCALAR.items():
    _scalar_op(_name, _fn)

alias("_plus_scalar", "_PlusScalar")
alias("_minus_scalar", "_MinusScalar")
alias("_mul_scalar", "_MulScalar")
alias("_div_scalar", "_DivScalar")
