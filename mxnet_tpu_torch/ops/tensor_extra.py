"""Tensor ops beyond the basic families (the counterpart of
`mxnet_tpu/ops/tensor_extra.py`): ``add_n`` (``ElementWiseSum``)."""
from __future__ import annotations

from .registry import alias, register


@register("add_n", input_names=None)
def _add_n(attrs, *arrays):
    """The elementwise sum of any number of arrays (reference `add_n`,
    `src/operator/tensor/elemwise_sum.cc`), added left to right."""
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


alias("add_n", "ElementWiseSum", "_sum")
