"""Device context: MXNet's `Context{dev_type, dev_id}` over `torch.device`
(the counterpart of `mxnet_tpu/context.py`).

``cpu(i)`` is the host (every id maps to ``torch.device("cpu")``, and so
do ``cpu_pinned`` and ``cpu_shared``); ``gpu(i)`` is
``torch.device("cuda", i)``.  ``with ctx:`` makes ``ctx`` the default of
the calls inside it, on this thread, and restores the outer default on
exit.  Where the caller passes no context and no scope is open, work goes
to the card (`default_context`): the CPU is used only when asked for.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "cpu_shared",
           "num_gpus", "current_context", "default_context"]


class _Scope(threading.local):
    def __init__(self):
        super().__init__()
        self.value = None


_SCOPE = _Scope()


class Context:
    """A device the framework places arrays and work on."""

    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}

    def __init__(self, device_type: str, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self) -> int:
        return self.devstr2type[self.device_type]

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

    # -- scope (with ctx: ...) ------------------------------------------
    def __enter__(self):
        self._old_ctx = _SCOPE.value
        _SCOPE.value = self
        return self

    def __exit__(self, *exc):
        _SCOPE.value = self._old_ctx

    def empty_cache(self):
        """Release the card's cached blocks (reference
        `Context.empty_cache`); nothing to do on the host."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def cpu_shared(device_id: int = 0) -> Context:
    return Context("cpu_shared", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    """The count of CUDA devices (reference `context.py:num_gpus`)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_context(what: str) -> Context:
    """The context for ``what`` when its caller names none: the innermost
    open ``with ctx:`` scope, else ``gpu(0)``, or `MXNetError` when there
    is no CUDA device (never the CPU unasked)."""
    if _SCOPE.value is not None:
        return _SCOPE.value
    if not torch.cuda.is_available():
        raise MXNetError(f"{what}: no CUDA device is available; pass "
                         "ctx=mx.cpu() or open `with mx.cpu():` to run on "
                         "the CPU")
    return gpu(0)


def current_context() -> Context:
    """The context calls without one use here (reference
    `context.py:current_context`): the open scope's, else `gpu(0)`."""
    return default_context("current_context")
