"""Plugin layer (the counterpart of `mxnet_tpu/plugin/`; reference
`plugin/` -- torch/caffe/opencv interop, `plugin/torch/torch_module.cc`,
`plugin/caffe/caffe_op.cc`, `plugin/opencv/opencv.cc`).

* **torch** -- `plugin.torch_bridge`: this package's arrays are torch
  tensors, so torch modules and criterions run on the NDArray's own
  tensor, on its device, and gradients flow through the autograd tape
  into Gluon training.
* **caffe** -- not bridged; caffe has no Python-3 runtime to link against.
* **opencv** -- subsumed: `image` decodes, resizes and augments with PIL,
  numpy and torch, and the native JPEG path is `io_native`.
"""
from . import torch_bridge
from .torch_bridge import (TorchBlock, TorchLoss, ndarray_to_torch,
                           torch_to_ndarray)

__all__ = ["torch_bridge", "TorchBlock", "TorchLoss", "ndarray_to_torch",
           "torch_to_ndarray"]
