"""NDArray: MXNet's array handle over a `torch.Tensor` (a minimal
counterpart of `mxnet_tpu/ndarray/ndarray.py`: creation, shape, dtype,
context and the copy to numpy)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import torch_dtype
from ..context import Context, default_context

__all__ = ["NDArray", "array", "zeros"]


class NDArray:
    """An array on one device.  ``data`` is the tensor itself."""

    __slots__ = ("data",)

    def __init__(self, data: torch.Tensor):
        self.data = data

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def context(self) -> Context:
        return Context.of(self.data.device)

    def asnumpy(self) -> np.ndarray:
        """A host copy (bfloat16 widens to float32, which numpy lacks)."""
        t = self.data.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    def __repr__(self):
        return f"<NDArray {self.shape} {self.dtype} @{self.context}>"


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray from an NDArray, tensor or array-like on ``ctx`` (the
    card when none is given); like MXNet, a non-array source defaults to
    float32."""
    if isinstance(source, NDArray):
        t = source.data
    elif isinstance(source, torch.Tensor):
        t = source
    else:
        t = torch.tensor(np.asarray(source))
        if dtype is None:
            dtype = torch.float32
    device = (ctx or default_context("nd.array")).device
    t = t.to(device=device, dtype=torch_dtype(dtype) if dtype is not None
             else None)
    return NDArray(t)


def zeros(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Zeros on ``ctx`` (the card when none is given)."""
    device = (ctx or default_context("nd.zeros")).device
    return NDArray(torch.zeros(tuple(shape), device=device,
                               dtype=torch_dtype(dtype or "float32")))
