"""Elementwise ops (the counterparts of `mxnet_tpu/ops/elemwise.py`):
the unary math ops (``sigmoid``, ``tanh``, ``relu``, ``abs``, ``square``,
``sqrt``, ``exp``, ``log``, the trigonometric and hyperbolic functions
and their inverses, ``gamma``, ``gammaln``, ``erfinv``, ``gelu``,
``hard_sigmoid``, the roundings, ...), ``identity``/``_copy``,
``BlockGrad``/``stop_gradient`` (which the ``eliminate`` pass forwards),
``cast``, ``clip``, ``smooth_l1``, and the scalar arithmetic and
comparisons (``_plus_scalar``, ``_rdiv_scalar``, ``_greater_scalar``,
...).

Each follows the JAX package's definition: ``round`` and ``rint`` round
half to even (``jnp.round``, where the reference rounds half away from
zero), ``gamma`` is ``exp(gammaln(x))`` and ``gelu`` the tanh
approximation."""
from __future__ import annotations

import torch

from .registry import alias, register


_GELU_C = 0.7978845608028654  # sqrt(2/pi)


def _cbrt(x):
    """The real cube root (``jnp.cbrt``), negative for negative x."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


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
    "tan": torch.tan, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "round": torch.round, "rint": torch.round, "fix": torch.trunc,
    "cbrt": _cbrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "erfinv": torch.erfinv, "gammaln": torch.lgamma,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "gelu": lambda x: 0.5 * x * (1.0 + torch.tanh(
        _GELU_C * (x + 0.044715 * x ** 3))),
}

for _name, _fn in _UNARY.items():
    _unary(_name, _fn)

alias("negative", "_np_negative")
alias("identity", "_copy")


@register("hard_sigmoid", num_inputs=1, input_names=["data"])
def _hard_sigmoid(attrs, x):
    """clip(alpha*x + beta, 0, 1); the gradient is alpha strictly inside
    (0, 1) and 0 at and beyond the bounds (reference
    `hard_sigmoid_backward`)."""
    lin = attrs.get_float("alpha", 0.2) * x + attrs.get_float("beta", 0.5)
    inside = (lin > 0) & (lin < 1)
    return torch.where(inside, lin, lin.detach().clamp(0.0, 1.0))


@register("smooth_l1", num_inputs=1, input_names=["data"])
def _smooth_l1(attrs, x):
    """0.5 (sigma x)^2 where |x| < 1 / sigma^2, else |x| - 0.5 / sigma^2
    (``scalar`` is sigma)."""
    s2 = attrs.get_float("scalar", 1.0) ** 2
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


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
