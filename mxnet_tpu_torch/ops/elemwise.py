"""Scalar arithmetic of the encoder path (the counterpart of
`_mul_scalar` in `mxnet_tpu/ops/elemwise.py`)."""
from __future__ import annotations

from .registry import alias, register


@register("_mul_scalar", num_inputs=1, input_names=["data"])
def _mul_scalar(attrs, x):
    """x * scalar (a float x keeps its dtype)."""
    return x * attrs.get_float("scalar", 0.0)


alias("_mul_scalar", "_MulScalar")
