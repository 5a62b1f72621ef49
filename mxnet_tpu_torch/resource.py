"""Resource manager (the counterpart of `mxnet_tpu/resource.py`; reference
`include/mxnet/resource.h:38-66`
`ResourceRequest{kRandom,kTempSpace,kParallelRandom,kCuDNNDropoutDesc}` +
`src/resource.cc` round-robin temp spaces under `MXNET_EXEC_NUM_TEMP`).

The custom-op contract: user ops (`operator.py` CustomOp) that want
reusable scratch buffers or private random streams.  Per context,
``MXNET_EXEC_NUM_TEMP`` round-robin temp spaces, each one byte buffer on
the context's device that grows to its high-water mark and never shrinks
(a request returns a view of it, so two requests of one slot alias, as in
the reference); and seeded, independent random streams, one
`torch.Generator` on the context's device per stream (slot 0 for
``kRandom``, a new slot per ``kParallelRandom`` request), derived from the
seed, the context and the slot, so the same seed gives the same streams
in every process.  The numbers differ from the JAX package's threefry
streams for the same seed.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .context import Context, current_context

__all__ = ["ResourceRequest", "Resource", "request", "seed"]


class ResourceRequest:
    """Resource kinds (reference `resource.h:38` enum)."""
    kRandom = "random"
    kTempSpace = "temp_space"
    kParallelRandom = "parallel_random"
    # kCuDNNDropoutDesc: dropout draws from the device's generator


class _TempSpace:
    """One growable scratch buffer (reference `SpaceAllocator`,
    `src/resource.cc:43`: requests grow the buffer, never shrink it)."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self._buf: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        """High-water scratch size this slot has served."""
        return 0 if self._buf is None else self._buf.numel()

    def get_space(self, shape: Tuple[int, ...], dtype=np.float32):
        """Scratch of ``shape``, contents undefined: a view of this slot's
        buffer, which grows first when the request is larger."""
        from .ndarray.ndarray import NDArray
        tdtype = torch_dtype(dtype)
        itemsize = torch.empty((), dtype=tdtype).element_size()
        count = int(np.prod(shape)) if shape else 1
        need = count * itemsize
        if need > self.nbytes:
            self._buf = torch.empty(need, dtype=torch.uint8,
                                    device=self.ctx.device)
        view = self._buf[:need].view(tdtype).reshape(tuple(shape))
        return NDArray(view, self.ctx)


class Resource:
    """Handle given to op implementations (reference `struct Resource`,
    `resource.h:84`)."""

    def __init__(self, req_type: str, ctx: Context,
                 manager: "_ResourceManager", slot: int):
        self.req_type = req_type
        self.ctx = ctx
        self._mgr = manager
        self._slot = slot

    # -- kTempSpace ------------------------------------------------------
    def get_space(self, shape, dtype=np.float32):
        if self.req_type != ResourceRequest.kTempSpace:
            raise MXNetError("get_space on a non-temp-space resource")
        return self._mgr._temp_spaces[self._slot].get_space(shape, dtype)

    @property
    def space_nbytes(self) -> int:
        """This slot's high-water scratch size."""
        return self._mgr._temp_spaces[self._slot].nbytes

    # -- kRandom / kParallelRandom ---------------------------------------
    def get_key(self) -> torch.Generator:
        """This resource's stream: the `torch.Generator` of its slot, on
        the context's device (the JAX package hands out a threefry key)."""
        if self.req_type == ResourceRequest.kTempSpace:
            raise MXNetError("get_key on a temp-space resource")
        return self._mgr._generator(self._slot)

    def _draw(self, fill, shape, dtype):
        from .ndarray.ndarray import NDArray
        out = torch.empty(tuple(shape), dtype=torch.float32,
                          device=self.ctx.device)
        with self._mgr._lock:
            fill(out, self.get_key())
        return NDArray(out.to(torch_dtype(dtype)), self.ctx)

    def uniform(self, shape, low=0.0, high=1.0, dtype=np.float32):
        return self._draw(lambda t, g: t.uniform_(low, high, generator=g),
                          shape, dtype)

    def normal(self, shape, loc=0.0, scale=1.0, dtype=np.float32):
        return self._draw(lambda t, g: t.normal_(loc, scale, generator=g),
                          shape, dtype)


class _ResourceManager:
    """Per-context pools (reference `ResourceManagerImpl`,
    `src/resource.cc:88`: `MXNET_EXEC_NUM_TEMP` round-robin spaces, one
    global random stream, N parallel streams)."""

    def __init__(self, ctx: Context):
        from .config import get_env
        self.ctx = ctx
        n_temp = max(1, int(get_env("MXNET_EXEC_NUM_TEMP", 1)))
        self._temp_spaces = [_TempSpace(ctx) for _ in range(n_temp)]
        self._rr = 0
        self._lock = threading.RLock()
        self._streams: List[torch.Generator] = []
        self._seed_counter = 0
        self.reseed(None)

    def reseed(self, seed_val: Optional[int]):
        from .random import current_seed
        base = current_seed() if seed_val is None else int(seed_val)
        with self._lock:
            self._base = base
            self._streams = []
            # restart slot assignment so same-seed runs replay identically
            self._seed_counter = 0
            self._rr = 0

    def _generator(self, slot: int) -> torch.Generator:
        with self._lock:
            while len(self._streams) <= slot:
                # crc32, not hash(): stable across processes and hosts
                salt = zlib.crc32(
                    f"{self._base}:{self.ctx.device_type}:"
                    f"{self.ctx.device_id}:{len(self._streams)}".encode())
                gen = torch.Generator(device=self.ctx.device)
                gen.manual_seed(salt)
                self._streams.append(gen)
            return self._streams[slot]

    def request(self, req_type: str) -> Resource:
        with self._lock:
            if req_type == ResourceRequest.kTempSpace:
                slot = self._rr % len(self._temp_spaces)
                self._rr += 1
            elif req_type == ResourceRequest.kRandom:
                slot = 0
            elif req_type == ResourceRequest.kParallelRandom:
                self._seed_counter += 1
                slot = self._seed_counter
            else:
                raise MXNetError(f"unknown resource request {req_type!r}")
        return Resource(req_type, self.ctx, self, slot)


_managers: Dict[Tuple[str, int], _ResourceManager] = {}
_managers_lock = threading.Lock()


def _manager(ctx: Optional[Context] = None) -> _ResourceManager:
    ctx = ctx or current_context()
    key = (ctx.device_type, ctx.device_id)
    with _managers_lock:
        if key not in _managers:
            _managers[key] = _ResourceManager(ctx)
        return _managers[key]


def request(req_type: str, ctx: Optional[Context] = None) -> Resource:
    """Request a resource for ``ctx`` (reference
    `ResourceManager::Request`, `resource.cc:117`); no ``ctx`` means the
    current context."""
    return _manager(ctx).request(req_type)


def seed(seed_val: int, ctx: Optional[Context] = None) -> None:
    """Reseed the resource streams (reference
    `ResourceManager::SeedRandom`, wired from `mx.random.seed`): every
    context's, or only ``ctx``'s."""
    if ctx is None:
        with _managers_lock:
            mgrs = list(_managers.values())
        for m in mgrs:
            m.reseed(seed_val)
    else:
        _manager(ctx).reseed(seed_val)
