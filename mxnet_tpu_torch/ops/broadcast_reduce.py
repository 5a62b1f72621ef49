"""Broadcasting ops and reductions (the counterparts of
`mxnet_tpu/ops/broadcast_reduce.py`): the binary arithmetic and
comparisons with their elemwise aliases and ``arctan2``, the axis
reductions (``sum``, ``mean``, ``prod``, ``nansum``, ``nanprod``, ``max``,
``min`` with ``axis``, ``keepdims`` and ``exclude``), ``norm``, the index
reductions ``argmax``/``argmin``/``argmax_channel``, ``pick`` and the
broadcasts ``broadcast_axis``, ``broadcast_to`` and ``broadcast_like``.
A comparison gives 1 or 0 in the left operand's dtype, as MXNet's do; an
index reduction gives float32 indices, the first of tied entries."""
from __future__ import annotations

import torch

from .registry import alias, register


def _binary(name, fn, aliases):
    def compute(attrs, lhs, rhs, _fn=fn):
        return _fn(lhs, rhs)
    compute.__doc__ = f"Broadcasting {name} (numpy broadcasting)."
    register(name, num_inputs=2, input_names=["lhs", "rhs"])(compute)
    alias(name, *aliases)


_BINARY = {
    "broadcast_add": (lambda l, r: l + r,
                      ("elemwise_add", "_plus", "_Plus", "_add")),
    "broadcast_sub": (lambda l, r: l - r,
                      ("elemwise_sub", "_minus", "_Minus", "_sub")),
    "broadcast_mul": (lambda l, r: l * r, ("elemwise_mul", "_mul", "_Mul")),
    "broadcast_div": (lambda l, r: l / r, ("elemwise_div", "_div", "_Div")),
    "broadcast_mod": (torch.remainder, ("_mod",)),
    "broadcast_power": (torch.pow, ("_power", "_Power", "pow", "power")),
    "broadcast_maximum": (torch.maximum, ("_maximum", "maximum")),
    "broadcast_minimum": (torch.minimum, ("_minimum", "minimum")),
    "broadcast_equal": (lambda l, r: (l == r).to(l.dtype), ("_equal",)),
    "broadcast_not_equal": (lambda l, r: (l != r).to(l.dtype),
                            ("_not_equal",)),
    "broadcast_greater": (lambda l, r: (l > r).to(l.dtype), ("_greater",)),
    "broadcast_greater_equal": (lambda l, r: (l >= r).to(l.dtype),
                                ("_greater_equal",)),
    "broadcast_lesser": (lambda l, r: (l < r).to(l.dtype), ("_lesser",)),
    "broadcast_lesser_equal": (lambda l, r: (l <= r).to(l.dtype),
                               ("_lesser_equal",)),
    "broadcast_hypot": (torch.hypot, ("_hypot",)),
    "broadcast_logical_and": (
        lambda l, r: ((l != 0) & (r != 0)).to(l.dtype), ("_logical_and",)),
    "broadcast_logical_or": (
        lambda l, r: ((l != 0) | (r != 0)).to(l.dtype), ("_logical_or",)),
    "broadcast_logical_xor": (
        lambda l, r: ((l != 0) ^ (r != 0)).to(l.dtype), ("_logical_xor",)),
    "arctan2": (torch.atan2, ("_arctan2",)),
}

for _name, (_fn, _aliases) in _BINARY.items():
    _binary(_name, _fn, _aliases)


def _axes(attrs, nd):
    """The reduced axes: all of them for no ``axis`` or an empty one, the
    others with ``exclude`` (reference `broadcast_reduce_op.h`)."""
    ax = attrs.get_attr("axis", None)
    if ax is None or ax == ():
        axes = tuple(range(nd))
    elif isinstance(ax, int):
        axes = (ax % nd,)
    else:
        axes = tuple(a % nd for a in ax)
    if attrs.get_bool("exclude", False):
        axes = tuple(i for i in range(nd) if i not in axes)
    return axes


def _prod(x, dim, keepdim):
    for a in sorted(dim, reverse=True):
        x = x.prod(dim=a, keepdim=keepdim)
    return x


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


_REDUCE = {
    "sum": torch.sum,
    "mean": torch.mean,
    "prod": _prod,
    "nansum": torch.nansum,
    "nanprod": _nanprod,
    "max": torch.amax,
    "min": torch.amin,
}


def _reduce(name, fn):
    def compute(attrs, x, _fn=fn):
        axes = _axes(attrs, x.dim())
        if not axes:
            return x
        return _fn(x, dim=axes, keepdim=attrs.get_bool("keepdims", False))
    compute.__doc__ = f"Axis reduction {name}."
    register(name, num_inputs=1, input_names=["data"])(compute)


for _name, _fn in _REDUCE.items():
    _reduce(_name, _fn)

alias("sum", "sum_axis")
alias("max", "max_axis")
alias("min", "min_axis")


@register("pick", num_inputs=2, input_names=["data", "index"])
def _pick(attrs, x, index):
    """Reference `pick`: one element along ``axis`` per index, the index
    clipped into range (``mode='clip'``) or wrapped (``'wrap'``)."""
    ax = attrs.get_int("axis", -1) % x.dim()
    idx = index.to(torch.int64)
    if attrs.get_str("mode", "clip") == "clip":
        idx = idx.clamp(0, x.shape[ax] - 1)
    else:
        idx = torch.remainder(idx, x.shape[ax])
    if idx.dim() == x.dim():
        idx = idx.squeeze(ax)
    picked = torch.gather(x, ax, idx.unsqueeze(ax))
    return picked if attrs.get_bool("keepdims", False) \
        else picked.squeeze(ax)


@register("broadcast_axis", num_inputs=1, input_names=["data"])
def _broadcast_axis(attrs, x):
    """Broadcast the size-1 ``axis`` (an int or a tuple) to ``size``; the
    result is a view, as JAX's broadcast is a lazy one."""
    ax = attrs.get_attr("axis", ())
    size = attrs.get_attr("size", ())
    axes = (ax,) if isinstance(ax, int) else tuple(ax)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return x.expand(tuple(tgt))


alias("broadcast_axis", "broadcast_axes")


@register("norm", num_inputs=1, input_names=["data"])
def _norm(attrs, x):
    """The L2 (``ord=2``, the default) or L1 norm over ``axis`` (every axis
    when none is given)."""
    ax = attrs.get_attr("axis", None)
    if ax is None or ax == ():
        axes = tuple(range(x.dim()))
    else:
        axes = (ax,) if isinstance(ax, int) else tuple(ax)
    keep = attrs.get_bool("keepdims", False)
    if not axes:
        return x.abs() if attrs.get_int("ord", 2) == 1 else x
    if attrs.get_int("ord", 2) == 1:
        return torch.sum(torch.abs(x), dim=axes, keepdim=keep)
    return torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=keep))


def _arg_reduce(name, fn):
    def compute(attrs, x, _fn=fn):
        ax = attrs.get_attr("axis", None)
        if ax is None:
            return _fn(x.reshape(-1), 0).to(torch.float32)
        res = _fn(x, int(ax))
        if attrs.get_bool("keepdims", False):
            res = res.unsqueeze(int(ax))
        return res.to(torch.float32)
    compute.__doc__ = (f"{name} along ``axis`` (the flattened array when "
                       "none is given), as float32 indices.")
    register(name, num_inputs=1, input_names=["data"])(compute)


_arg_reduce("argmax", lambda x, d: torch.argmax(x, dim=d))
_arg_reduce("argmin", lambda x, d: torch.argmin(x, dim=d))


@register("argmax_channel", num_inputs=1, input_names=["data"])
def _argmax_channel(attrs, x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register("broadcast_to", num_inputs=1, input_names=["data"])
def _broadcast_to(attrs, x):
    """``x`` broadcast to ``shape``, where a 0 keeps that axis's size."""
    shape = attrs.get_tuple("shape")
    tgt = tuple(x.shape[i] if s == 0 else int(s)
                for i, s in enumerate(shape))
    return x.expand(tgt)


@register("broadcast_like", num_inputs=2, input_names=["lhs", "rhs"])
def _broadcast_like(attrs, lhs, rhs):
    """``lhs`` broadcast to ``rhs``'s shape (the JAX package's form: the
    ``lhs_axes``/``rhs_axes`` attrs are not read)."""
    return lhs.expand(rhs.shape)
