"""Elementwise ops (the counterparts of `mxnet_tpu/ops/elemwise.py`):
the unary math ops (``sigmoid``, ``tanh``, ``relu``, ``abs``, ``square``,
``sqrt``, ``exp``, ``log``, ...), ``identity``/``_copy``,
``BlockGrad``/``stop_gradient`` (which the ``eliminate`` pass forwards),
``cast``, ``clip``, and the scalar arithmetic and comparisons
(``_plus_scalar``, ``_rdiv_scalar``, ``_greater_scalar``, ...)."""
from __future__ import annotations

import torch

from .registry import alias, register


def _unary(name, fn):
    def compute(attrs, x, _fn=fn):
        return _fn(x)
    compute.__doc__ = f"Elementwise {name}."
    register(name, num_inputs=1, input_names=["data"])(compute)


_UNARY = {
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "negative": torch.neg,
    "rsqrt": torch.rsqrt, "identity": lambda x: x, "relu": torch.relu,
    "abs": torch.abs, "sign": torch.sign, "square": torch.square,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "expm1": torch.expm1, "floor": torch.floor, "ceil": torch.ceil,
    "trunc": torch.trunc, "sin": torch.sin, "cos": torch.cos,
    "erf": torch.erf, "softsign": torch.nn.functional.softsign,
    "reciprocal": lambda x: 1.0 / x,
}

for _name, _fn in _UNARY.items():
    _unary(_name, _fn)

alias("negative", "_np_negative")
alias("identity", "_copy")


@register("BlockGrad", num_inputs=1, input_names=["data"])
def _block_grad(attrs, x):
    """The value, with no gradient flowing back (reference `BlockGrad`)."""
    return x.detach()


alias("BlockGrad", "stop_gradient")


@register("cast", num_inputs=1, input_names=["data"])
def _cast(attrs, x):
    return x.to(attrs.get_dtype("dtype"))


alias("cast", "Cast")


@register("clip", num_inputs=1, input_names=["data"],
          attr_names=["a_min", "a_max"])
def _clip(attrs, x):
    """``x`` limited to [a_min, a_max]; a bound not given leaves that side
    open.  The gradient passes on the closed interval, bounds included,
    as the reference's does (a `torch.where` per bound, not
    `torch.clamp`)."""
    lo = attrs.get_float("a_min", None)
    hi = attrs.get_float("a_max", None)
    if hi is not None:
        x = torch.where(x > hi, x.new_full((), hi), x)
    if lo is not None:
        x = torch.where(x < lo, x.new_full((), lo), x)
    return x


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
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(
        torch.as_tensor(s, dtype=x.dtype, device=x.device), x),
    "_maximum_scalar": lambda x, s: torch.clamp_min(x, s),
    "_minimum_scalar": lambda x, s: torch.clamp_max(x, s),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_rmod_scalar": lambda x, s: torch.remainder(
        torch.as_tensor(s, dtype=x.dtype, device=x.device), x),
    "_hypot_scalar": lambda x, s: torch.hypot(
        x, torch.as_tensor(s, dtype=x.dtype, device=x.device)),
    "_logical_and_scalar": lambda x, s: ((x != 0) & (s != 0)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: ((x != 0) | (s != 0)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: ((x != 0) ^ (s != 0)).to(x.dtype),
}

for _name, _fn in _SCALAR.items():
    _scalar_op(_name, _fn)

alias("_plus_scalar", "_PlusScalar")
alias("_minus_scalar", "_MinusScalar")
alias("_mul_scalar", "_MulScalar")
alias("_div_scalar", "_DivScalar")


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward ignores the incoming gradient and
    seeds grad_scale, over the batch ('batch') or over the count of
    elements above valid_thresh ('valid') (reference
    `make_loss-inl.h:91-119`)."""

    @staticmethod
    def forward(ctx, x, grad_scale, normalization, valid_thresh):
        ctx.save_for_backward(x if normalization == "valid" else None)
        ctx.opts = (grad_scale, normalization, valid_thresh)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        grad_scale, normalization, valid_thresh = ctx.opts
        if normalization == "batch":
            seed = torch.full_like(g, grad_scale / g.shape[0])
        elif normalization == "valid":
            (x,) = ctx.saved_tensors
            count = (x > valid_thresh).to(g.dtype).sum().clamp_min(1.0)
            seed = torch.full_like(g, grad_scale) / count
        else:  # null
            seed = torch.full_like(g, grad_scale)
        return seed, None, None, None


@register("make_loss", num_inputs=1, input_names=["data"])
def _make_loss(attrs, x):
    """Reference `MakeLoss`: x forward; as the loss head, its gradient is
    the seed `_MakeLoss` computes, whatever comes in."""
    return _MakeLoss.apply(x, attrs.get_float("grad_scale", 1.0),
                           attrs.get_str("normalization", "null"),
                           attrs.get_float("valid_thresh", 0.0))
