"""Torch-backend NDArray functions (the counterpart of `mxnet_tpu/torch.py`;
reference ``python/mxnet/torch.py``, ``mx.th``).

The reference bridges Torch7/LuaJIT functions onto NDArrays when built
with ``USE_TORCH=1``.  The modern analog is the PyTorch bridge in
`plugin/torch_bridge.py`; this module exposes it under the legacy import
path so code written against ``mx.torch`` finds the capability.
"""
from .plugin.torch_bridge import (ndarray_to_torch, torch_to_ndarray,
                                  TorchBlock, TorchLoss)

__all__ = ["ndarray_to_torch", "torch_to_ndarray", "TorchBlock",
           "TorchLoss"]
