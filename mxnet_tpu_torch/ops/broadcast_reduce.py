"""Broadcasting binary ops of the encoder path (the counterpart of
`broadcast_add` in `mxnet_tpu/ops/broadcast_reduce.py`)."""
from __future__ import annotations

from .registry import alias, register


@register("broadcast_add", num_inputs=2, input_names=["lhs", "rhs"])
def _broadcast_add(attrs, lhs, rhs):
    """lhs + rhs with numpy broadcasting."""
    return lhs + rhs


alias("broadcast_add", "elemwise_add", "_plus", "_Plus", "_add")
