"""Generated `nd.*` surface: one eager function per registered op (the
counterpart of `mxnet_tpu/ndarray/register.py`).

`invoke` runs an op on NDArrays as the reference's does: tensor inputs may
be passed by name, numbers and arrays become NDArrays on the first
input's device, an op that reads ``__train`` gets
`autograd.is_training()` unless the caller set it, an op's mutated inputs
(MXNet's FMutateInputs, BatchNorm's moving statistics) are written back
into the caller's arrays, and ``out=`` (an NDArray or a list of them)
receives the results and is returned.  Results take the context of the
first input.

Errors that MXNet raises asynchronously are deferred as it defers them:
a sampler given invalid parameters (its validator, run here on the
host-known attrs) or an input that carries a deferred error gives
outputs that carry the error, and it is raised where they are read on
the host (`NDArray.asnumpy`, `wait_to_read`, `waitall`).  A sampler
whose validator failed draws nothing: its outputs are zeros of the right
shape.  Under `autograd.record` the op
runs with torch's grad mode on, so autograd records it; otherwise under
`torch.no_grad()`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .. import autograd
from .. import profiler as _prof
from .. import random as _random
from ..base import MXNetError, _Null
from ..context import default_context
from ..ops import registry as _reg
from ..ops.registry import DEVICE, Attrs
from .ndarray import NDArray, array

__all__ = ["invoke", "make_nd_functions"]


def _split_args(op: _reg.OpDef, args: Sequence, kwargs: Dict[str, Any]):
    """Tensor inputs (positional, then named ones in the op's declared
    order) and attrs (an explicit None is kept, as the reference keeps
    it)."""
    inputs: List = [a for a in args if a is not None]
    inputs, pos_attrs = _reg.split_positional_attrs(op, inputs, kwargs,
                                                    NDArray)
    kwargs = {**kwargs, **pos_attrs}
    if op.input_names:
        named = {n: kwargs.pop(n) for n in list(kwargs)
                 if n in op.input_names}
        if named:
            pos = {op.input_names[i]: v for i, v in enumerate(inputs)}
            pos.update(named)
            inputs = [pos[n] for n in op.input_names if n in pos]
    attrs = {k: v for k, v in kwargs.items() if v is not _Null}
    return inputs, attrs


class _ZeroGrad(torch.autograd.Function):
    """``out`` unchanged, with a zero gradient back to ``inputs``."""

    @staticmethod
    def forward(ctx, out, *inputs):
        ctx.metas = [(i.shape, i.dtype, i.device) for i in inputs]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(torch.zeros(s, dtype=d, device=v)
                               for s, d, v in ctx.metas)


def _keep_on_tape(outs, n_vis, tensors):
    """A recorded op whose float outputs carry no gradient (a comparison,
    ``BlockGrad``) still stands on the tape with a zero gradient, as in
    the reference: a backward from it writes zeros into the variables
    upstream instead of finding nothing to differentiate."""
    live = [t for t in tensors if t.requires_grad]
    if not live:
        return outs
    return tuple(_ZeroGrad.apply(o, *live)
                 if i < n_vis and o.is_floating_point()
                 and not o.requires_grad else o
                 for i, o in enumerate(outs))


def invoke(op_name: str, *args, out=None, **kwargs):
    """Run op ``op_name`` on NDArrays; returns an NDArray, a list of them
    for a multi-output op, or ``out``."""
    op = _reg.get_op(op_name)
    inputs, attrs = _split_args(op, args, kwargs)
    first = next((x for x in inputs if isinstance(x, NDArray)), None)
    ctx = attrs.pop("ctx", None)
    if first is not None:
        ctx = first.context
    nd_inputs: List[NDArray] = []
    for x in inputs:
        if isinstance(x, NDArray):
            nd_inputs.append(x)
        elif isinstance(x, (int, float, list, tuple, np.ndarray,
                            torch.Tensor)):
            nd_inputs.append(array(x, ctx=ctx or default_context(op_name)))
        else:
            raise TypeError(f"op {op_name}: unsupported input type {type(x)}")
    if op.uses_train_mode and "__train" not in attrs:
        attrs["__train"] = autograd.is_training()
    if op.takes_device and DEVICE not in attrs:
        attrs[DEVICE] = (ctx or default_context(op_name)).device
    tensors = [x.data for x in nd_inputs]
    gen = None
    if op.needs_rng:
        gen = _random.generator(tensors[0].device if tensors
                                else attrs[DEVICE])
    a = Attrs(attrs)
    n_vis = op.num_outputs(a)
    deferred = next((x._deferred_error for x in nd_inputs
                     if x._deferred_error is not None), None)
    invalid = None
    vfn = _reg.get_validator(op_name)
    if vfn is not None and deferred is None:
        try:
            vfn(a)
        except MXNetError as e:
            deferred = invalid = e
    _prof.bump_counter("dispatches")  # one host dispatch per op invoke
    if invalid is not None:
        # the validated ops are the zero-input samplers: their placeholder
        # is zeros of the asked shape and dtype
        outs = (torch.zeros(a.get_tuple("shape", ()) or (),
                            dtype=a.get_dtype("dtype", torch.float32),
                            device=attrs[DEVICE]),)
    else:
        with autograd.grad_mode():
            outs = _reg.apply_op(op_name, tensors, attrs, generator=gen)
            if torch.is_grad_enabled():
                outs = _keep_on_tape(outs, n_vis, tensors)
    for slot, val in zip(op.mutate_slots(a), outs[n_vis:]):
        nd_inputs[slot]._set_data(val)
        nd_inputs[slot]._poison(deferred)
    res = [NDArray(o, ctx) for o in outs[:n_vis]]
    if deferred is not None:
        for r in res:
            r._poison(deferred)
    if out is not None:
        dsts = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(dsts, res):
            dst._set_data(src.data.to(dst._tdtype))
            dst._poison(deferred)
        return out
    return res[0] if len(res) == 1 else res


def make_nd_functions(module_dict: Dict[str, Any]) -> None:
    for name in _reg.list_ops():
        if name in module_dict:
            continue

        def f(*args, _n=name, out=None, **kwargs):
            return invoke(_n, *args, out=out, **kwargs)
        f.__name__ = name
        f.__doc__ = _reg.get_op(name).doc
        module_dict[name] = f
