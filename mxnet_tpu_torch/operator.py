"""Custom operators in Python (the counterpart of `mxnet_tpu/operator.py`;
reference `python/mxnet/operator.py` + `src/operator/custom/custom.cc`).

`CustomOpProp` describes an op (arguments, outputs, shapes, types) and
creates its `CustomOp`, whose ``forward`` and ``backward`` the user writes
on NDArrays (typically through numpy).  ``register`` names a prop class;
``Custom(*inputs, op_type=...)`` (``nd.Custom``) runs it eagerly, and the
registry op ``Custom`` (`ops/custom_op.py`) runs it inside a graph.

Both run the user's code through one `torch.autograd.Function`
(`custom_function`): its ``forward`` hands the user's op NDArrays of the
inputs and fills NDArray outputs; its ``backward`` calls the user's
``backward`` with the out-grads; aux states get no gradient.  One
operator instance serves a call's forward and its backward.  The eager
call hands the op the caller's arrays on their device, as the JAX
package does; inside a graph the arrays cross to the host and back (the
reference's cost of a numpy op) and the user's code runs under a CPU
context scope, so its ``nd.array(...)`` lands on the host too.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import autograd
from .base import MXNetError, numpy_dtype, torch_dtype
from .context import Context, cpu
from .ndarray import ndarray as _nd
from .ndarray.ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "Custom"]

_CUSTOM_REGISTRY: Dict[str, type] = {}


class CustomOp:
    """User compute (reference `operator.py:CustomOp`)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst: NDArray, req: str, src):
        """Write ``src`` into ``dst`` by the grad_req (reference
        `CustomOp.assign`): 'null' skips, 'add' accumulates, 'write' and
        'inplace' copy."""
        if req in ("null", None):
            return
        s = src.data if isinstance(src, NDArray) else \
            torch.as_tensor(np.asarray(src))
        s = s.to(device=dst.data.device, dtype=dst._tdtype)
        with torch.no_grad():
            if req == "add":
                dst.data.add_(s)
            else:
                dst.data.copy_(s.expand_as(dst.data))


class CustomOpProp:
    """Op metadata + factory (reference `operator.py:CustomOpProp`)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad
        self.kwargs: Dict[str, str] = {}

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """``@mx.operator.register("my_op")`` over a CustomOpProp subclass
    (reference `operator.py:register`)."""
    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get_all_registered():
    return dict(_CUSTOM_REGISTRY)


def make_prop(op_type: str, kwargs: Dict) -> CustomOpProp:
    """The registered prop of ``op_type`` with its string kwargs (they
    cross as strings, the reference's C-API contract)."""
    if not op_type:
        raise MXNetError("Custom requires op_type=")
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError(f"custom op {op_type!r} is not registered")
    kw = {k: str(v) for k, v in kwargs.items()}
    prop = _CUSTOM_REGISTRY[op_type](**kw)
    prop.kwargs = kw
    return prop


def out_specs(prop: CustomOpProp, shapes: Sequence[tuple],
              dtypes: Sequence[np.dtype]):
    """``[(shape, numpy dtype)]`` of the outputs, from the prop's
    ``infer_shape`` and ``infer_type`` over the arguments."""
    n_args = len(prop.list_arguments())
    _, out_shapes, _ = prop.infer_shape([list(s) for s in shapes[:n_args]])
    _, out_types, _ = prop.infer_type(list(dtypes[:n_args]))
    return [(tuple(int(d) for d in s), np.dtype(t))
            for s, t in zip(out_shapes, out_types)]


class CustomCall:
    """One call of a custom op: the prop, the operator instance its
    forward and backward share, and where the user's code sees the
    arrays (``host``: on the CPU, under a CPU context scope)."""

    def __init__(self, prop: CustomOpProp, op: CustomOp, is_train: bool,
                 specs, host: bool):
        self.prop = prop
        self.op = op
        self.is_train = is_train
        self.specs = specs
        self.host = host
        self.n_args = len(prop.list_arguments())

    def _arrays(self, tensors) -> List[NDArray]:
        return [NDArray(t.detach().cpu() if self.host else t.detach())
                for t in tensors]

    def _scope(self, device):
        """The context scope the user's code runs under."""
        return cpu() if self.host else Context.of(device)

    def forward(self, tensors) -> List[torch.Tensor]:
        device = tensors[0].device
        ins = self._arrays(tensors)
        where = torch.device("cpu") if self.host else device
        outs = [NDArray(torch.zeros(s, dtype=torch_dtype(t), device=where))
                for s, t in self.specs]
        with self._scope(device), autograd.pause(), torch.no_grad():
            self.op.forward(self.is_train, ["write"] * len(outs),
                            ins[:self.n_args], outs, ins[self.n_args:])
        return [o.data.to(device) for o in outs]

    def backward(self, tensors, outputs, grads) -> List[torch.Tensor]:
        device = tensors[0].device
        ins = self._arrays(tensors)
        outs = self._arrays(outputs)
        where = torch.device("cpu") if self.host else device
        out_grad = [NDArray(torch.zeros(o.shape, dtype=o.dtype, device=where)
                            if g is None else
                            (g.detach().cpu() if self.host else g.detach()))
                    for g, o in zip(grads, outputs)]
        in_grad = [NDArray(torch.zeros(t.shape, dtype=t.dtype, device=where))
                   for t in tensors[:self.n_args]]
        with self._scope(device), autograd.pause(), torch.no_grad():
            self.op.backward(["write"] * len(in_grad), out_grad,
                             ins[:self.n_args], outs, in_grad,
                             ins[self.n_args:])
        return [g.data.to(device) for g in in_grad]


class _CustomFunction(torch.autograd.Function):
    """A custom op's call as one node of torch's tape."""

    @staticmethod
    def forward(ctx, call, *tensors):
        outs = call.forward(tensors)
        ctx.call = call
        ctx.n_in = len(tensors)
        ctx.save_for_backward(*tensors, *outs)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        in_grads = ctx.call.backward(ins, outs, grads)
        res = [None] * ctx.n_in
        for i, g in enumerate(in_grads):
            if ctx.needs_input_grad[1 + i]:
                res[i] = g
        # aux states get no gradient
        return (None,) + tuple(res)


def custom_function(call: CustomCall, tensors: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
    """Run ``call`` on ``tensors`` through `_CustomFunction` (recorded
    when grad mode is on and an input requires grad)."""
    return list(_CustomFunction.apply(call, *tensors))


def Custom(*inputs, op_type: str = None, **kwargs):
    """``mx.nd.Custom(x, ..., op_type='my_op')`` (reference custom.cc):
    the op run eagerly on the inputs' device, on the tape under
    `autograd.record`."""
    from .cached_op import note_host_op
    note_host_op("Custom")
    prop = make_prop(op_type, kwargs)
    n_args = len(prop.list_arguments())
    first = next((x for x in inputs if isinstance(x, NDArray)), None)
    ctx = first.context if first is not None else None
    arrays = [x if isinstance(x, NDArray) else _nd.array(x, ctx=ctx)
              for x in inputs]
    shapes = [tuple(x.shape) for x in arrays]
    dtypes = [numpy_dtype(x.dtype) for x in arrays]
    specs = out_specs(prop, shapes, dtypes)
    op = prop.create_operator(arrays[0].context if arrays else None,
                              [list(s) for s in shapes[:n_args]],
                              dtypes[:n_args])
    call = CustomCall(prop, op, autograd.is_training(), specs, host=False)
    with autograd.grad_mode():
        outs = custom_function(call, [x.data for x in arrays])
    res = [NDArray(o) for o in outs]
    return res[0] if len(res) == 1 else res
