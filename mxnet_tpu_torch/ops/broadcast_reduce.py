"""Broadcasting ops of the ported paths (the counterparts of
`mxnet_tpu/ops/broadcast_reduce.py`): the binary add, sub, mul and div
with their elemwise aliases, and ``broadcast_axis``."""
from __future__ import annotations

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
}

for _name, (_fn, _aliases) in _BINARY.items():
    _binary(_name, _fn, _aliases)


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
