"""mxnet_tpu_torch — the PyTorch/CUDA port of `mxnet_tpu` for NVIDIA
Hopper.

Same user surface and file formats as the JAX package (op names and
attrs, Symbol JSON, `.params` blobs); plain tensor code is PyTorch and the
JAX package's Pallas kernels are rewritten by hand for Hopper
(`ops/hopper_kernels.py`, sources in `csrc/`).  It never imports JAX or
the JAX package.

Ported so far: the deploy path ``Predictor(symbol_json, params,
input_shapes)`` over the ops a BERT encoder uses, with the graph
optimizer's attention swap onto the flash-attention forward kernel.
"""
from . import base, config, ops  # noqa: F401
from .base import MXNetError
from .context import Context, cpu, gpu
from . import ndarray as nd
from . import symbol as sym
from .predictor import Predictor

__all__ = ["MXNetError", "Context", "cpu", "gpu", "nd", "sym", "Predictor"]
