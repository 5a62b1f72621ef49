"""Generated `nd.*` surface: one eager function per registered op (the
counterpart of `mxnet_tpu/ndarray/register.py`)."""
from __future__ import annotations

from typing import Any, Dict

from .. import random as _random
from ..base import _Null
from ..ops import registry as _reg
from .ndarray import NDArray

__all__ = ["invoke", "make_nd_functions"]


def invoke(op_name: str, *args, **kwargs):
    """Run op ``op_name`` on NDArrays; returns an NDArray, or a list of
    them for a multi-output op."""
    op = _reg.get_op(op_name)
    inputs = [a for a in args if a is not None]
    attrs = {k: v for k, v in kwargs.items() if v is not _Null}
    tensors = [a.data for a in inputs]
    gen = _random.generator(tensors[0].device) if op.needs_rng and tensors \
        else None
    outs = _reg.apply_op(op_name, tensors, attrs, generator=gen)
    res = [NDArray(o) for o in outs[:op.num_outputs(_reg.Attrs(attrs))]]
    return res[0] if len(res) == 1 else res


def make_nd_functions(module_dict: Dict[str, Any]) -> None:
    for name in _reg.list_ops():
        if name in module_dict:
            continue

        def f(*args, _n=name, **kwargs):
            return invoke(_n, *args, **kwargs)
        f.__name__ = name
        f.__doc__ = _reg.get_op(name).doc
        module_dict[name] = f
