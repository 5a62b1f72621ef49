"""`Custom` as a registry op (the counterpart of `mxnet_tpu/ops/custom_op.py`;
reference `src/operator/custom/custom.cc`, NNVM_REGISTER_OP(Custom)), so
``sym.Custom(...)`` composes into executor and CachedOp graphs.

The user's `CustomOp.forward`/`backward` run on the host through
`operator.custom_function`: the inputs are copied to the host and the
results back, at each call, forward and backward (the reference's
cross-device cost of a numpy op, which the JAX package pays through
`jax.pure_callback`).  Those host reads cannot sit inside a CUDA graph, so
`graph_compile.DEFAULT_DENY_OPS` names ``Custom`` and an inference forward
runs it eagerly between captured islands.  Output shapes and dtypes come
from the prop's ``infer_shape``/``infer_type``, never from running the
user's code on meta tensors.  One operator instance serves every call of
one node of one program (a plan: `graph_compile.build_steps`) at one input
signature and mode, its forward and its backward, as the JAX package
creates one per traced program; two programs never share one.  A call
outside a plan (``apply_op``) creates its own.
"""
from __future__ import annotations

import torch

from ..base import numpy_dtype, torch_dtype
from .registry import PROGRAM_STATE, Attrs, register

__all__ = []


def _prop_for(attrs: Attrs):
    from ..operator import make_prop
    kwargs = {k: v for k, v in attrs.items()
              if k not in ("op_type", "__train") and not k.startswith("__")}
    return make_prop(attrs.get_str("op_type"), kwargs)


def _custom_num_outputs(attrs: Attrs) -> int:
    return len(_prop_for(attrs).list_outputs())


@register("Custom", num_inputs=None, uses_train_mode=True,
          num_outputs=_custom_num_outputs, program_state=True)
def _custom(attrs: Attrs, *tensors):
    """The registered custom op's outputs (``op_type`` names it; the
    other attrs are its kwargs)."""
    from ..operator import CustomCall, custom_function, out_specs
    prop = _prop_for(attrs)
    is_train = attrs.get_bool("__train", False)
    n_args = len(prop.list_arguments())
    shapes = [tuple(t.shape) for t in tensors]
    dtypes = [numpy_dtype(t.dtype) for t in tensors]
    specs = out_specs(prop, shapes, dtypes)
    device = tensors[0].device
    if device.type == "meta":
        outs = [torch.empty(s, dtype=torch_dtype(t), device="meta")
                for s, t in specs]
        return tuple(outs) if len(outs) > 1 else outs[0]
    instances = attrs.get(PROGRAM_STATE, {})
    key = (tuple(shapes[:n_args]), tuple(str(d) for d in dtypes[:n_args]),
           is_train)
    op = instances.get(key)
    if op is None:
        from ..context import cpu
        op = instances[key] = prop.create_operator(
            cpu(), [list(s) for s in shapes[:n_args]], dtypes[:n_args])
    outs = custom_function(CustomCall(prop, op, is_train, specs, host=True),
                           tensors)
    return tuple(outs) if len(outs) > 1 else outs[0]
