"""ONNX import/export (the counterpart of `mxnet_tpu/contrib/onnx/`;
reference `python/mxnet/contrib/onnx/`).

A real `onnx` package is preferred where installed; otherwise the
vendored wire-format codec (`onnx_shim.py`, this package's own copy)
reads and writes the same protobuf bytes.  The mapping layer translates
between Symbol graphs and ONNX GraphProto for the common vision-model
vocabulary.
"""
from .onnx2mx import import_model  # noqa: F401
from .mx2onnx import export_model  # noqa: F401

__all__ = ["import_model", "export_model"]
