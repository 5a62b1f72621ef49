"""``mx.contrib.tensorrt`` (the counterpart of
`mxnet_tpu/contrib/tensorrt.py`; reference
``python/mxnet/contrib/tensorrt.py``).

TensorRT is not part of this package: the graph optimizer and CUDA-graph
capture are its whole-graph path (`Predictor.export_compiled` writes a
captured, optimized program), and int8 inference is the quantization pass
(`contrib.quantization`).  This module keeps the import path and flag
surface so reference scripts degrade gracefully: the toggle is accepted
(and remembered) but binding through TensorRT raises with a pointer to
those equivalents.
"""
from ..base import MXNetError

_use_tensorrt = False


def set_use_tensorrt(status):
    """Accept the flag for script compatibility (stored, not acted on)."""
    global _use_tensorrt
    _use_tensorrt = bool(status)


def get_use_tensorrt():
    """Current flag value."""
    return _use_tensorrt


def get_optimized_symbol(executor):
    """Not available: there is no TensorRT graph to return."""
    raise MXNetError(
        "TensorRT graph rewriting is not available: the graph optimizer and "
        "CUDA-graph capture make the optimized program "
        "(Predictor.export_compiled writes it); for int8 inference use "
        "contrib.quantization.quantize_model.")


def tensorrt_bind(symbol, ctx, all_params, **kwargs):
    """Not available: bind with `symbol.simple_bind` or serve through
    `Predictor` (CUDA-graph captured), or quantize to int8 with
    `contrib.quantization`."""
    raise MXNetError(
        "tensorrt_bind is not available: use symbol.simple_bind or "
        "Predictor (captured as CUDA graphs, Predictor.export_compiled for "
        "an optimized artifact), or contrib.quantization.quantize_model for "
        "int8 inference.")
