"""Device context: MXNet's `Context{dev_type, dev_id}` over `torch.device`
(the counterpart of `mxnet_tpu/context.py`).

``cpu(i)`` is the host (every id maps to ``torch.device("cpu")``);
``gpu(i)`` is ``torch.device("cuda", i)``.  Where the caller passes no
context, work goes to the card (`default_context`): the CPU is used only
when asked for.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "default_context"]


class Context:
    """A device the framework places arrays and work on."""

    devstr2type = {"cpu": 1, "gpu": 2}

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device(self) -> torch.device:
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    @staticmethod
    def of(device: torch.device) -> "Context":
        """The context a tensor on ``device`` lives in."""
        if device.type == "cuda":
            return Context("gpu", device.index or 0)
        return Context("cpu", 0)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def default_context(what: str) -> Context:
    """The context for ``what`` when its caller names none: ``gpu(0)``, or
    `MXNetError` when there is no CUDA device (never the CPU unasked)."""
    if not torch.cuda.is_available():
        raise MXNetError(f"{what}: no CUDA device is available; pass "
                         "ctx=mx.cpu() to run on the CPU")
    return gpu(0)
