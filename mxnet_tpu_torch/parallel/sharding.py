"""Parameter and data sharding rules (the counterpart of
`mxnet_tpu/parallel/sharding.py`).

A `PartitionSpec` names, per tensor dimension, the mesh axis (or axes)
it is split over; a `NamedSharding` pairs one with a mesh.  A global
value that a caller hands in is sliced by each rank to its own block
(`NamedSharding.shard`), as `global_put` does across hosts in the JAX
package; `ShardedTensor` keeps that block with its sharding, and its
``full_tensor()`` gives the global value back on every rank.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .mesh import DP, SP, TP, Mesh

__all__ = ["PartitionSpec", "P", "NamedSharding", "ShardedTensor",
           "global_put", "default_param_rule", "batch_pspec",
           "param_sharding", "data_sharding", "replicated"]


class PartitionSpec(tuple):
    """``PartitionSpec('tp', None)``: dim 0 split over ``tp``, dim 1 whole.
    An entry may also be a tuple of axis names (split over their
    product, the first one major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A mesh and a `PartitionSpec` (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and tuple(other.spec) == tuple(self.spec)

    def __hash__(self):
        return hash((id(self.mesh), tuple(self.spec)))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def dim_axes(self, ndim: int):
        """[(dim, axes)] for the dims the spec splits."""
        out = []
        for d, entry in enumerate(tuple(self.spec)[:ndim]):
            axes = tuple(a for a in _axes_of(entry)
                         if self.mesh.axis_size(a) > 1)
            if axes:
                out.append((d, axes))
        return out

    def block(self, d: int, axes, length: int) -> Tuple[int, int]:
        """(start, size) of this rank's block of a dim of ``length``."""
        parts, idx = 1, 0
        for a in axes:
            n = self.mesh.axis_size(a)
            parts *= n
            idx = idx * n + self.mesh.axis_index(a)
        if length % parts:
            raise ValueError(f"dim {d} of length {length} does not split "
                             f"evenly over {axes} ({parts} blocks)")
        size = length // parts
        return idx * size, size

    def shard(self, value: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``value`` (a view)."""
        out = value
        for d, axes in self.dim_axes(value.dim()):
            start, size = self.block(d, axes, value.shape[d])
            out = out.narrow(d, start, size)
        return out

    def shard_shape(self, shape) -> Tuple[int, ...]:
        shape = list(shape)
        for d, axes in self.dim_axes(len(shape)):
            shape[d] = self.block(d, axes, shape[d])[1]
        return tuple(shape)

    def is_fully_replicated(self) -> bool:
        return not any(_axes_of(e) and any(self.mesh.axis_size(a) > 1
                                           for a in _axes_of(e))
                       for e in self.spec)


class ShardedTensor:
    """This rank's block of a global tensor and its sharding.  Reading it
    (``full_tensor()``, ``np.asarray``, ``float``) gives the global value,
    the same on every rank."""

    __slots__ = ("local", "sharding", "shape")

    def __init__(self, local: torch.Tensor, sharding: NamedSharding,
                 shape=None):
        self.local = local
        self.sharding = sharding
        if shape is None:
            shape = list(local.shape)
            for d, axes in sharding.dim_axes(local.dim()):
                shape[d] *= int(np.prod([sharding.mesh.axis_size(a)
                                         for a in axes]))
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self.local.dtype

    def full_tensor(self) -> torch.Tensor:
        from .collectives import unshard
        return unshard(self.local, self.sharding)

    def numpy(self) -> np.ndarray:
        return self.full_tensor().detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self.full_tensor())

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, local="
                f"{tuple(self.local.shape)}, {self.sharding.spec!r})")


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def default_param_rule(name: str, shape: Tuple[int, ...],
                       mesh: Mesh) -> PartitionSpec:
    """Megatron-style default: shard dim 0 (else dim 1) over tp when it
    divides and is at least 8·tp; replicate small tensors (biases, norm
    scales)."""
    tp = _axis_size(mesh, TP)
    if tp <= 1 or len(shape) < 2:
        return P()
    for dim in (0, 1):
        if shape[dim] % tp == 0 and shape[dim] >= tp * 8:
            spec = [None] * len(shape)
            spec[dim] = TP
            return P(*spec)
    return P()


def batch_pspec(ndim: int, mesh: Mesh, seq_axis: Optional[int] = None,
                lead_axes: int = 0) -> PartitionSpec:
    """Batch tensors shard the batch dim over dp (and a sequence dim over
    sp when ``seq_axis`` is given); ``lead_axes`` skips leading non-batch
    axes (the microbatch axis K of `SPMDTrainer.step_many`)."""
    spec = [None] * ndim
    if _axis_size(mesh, DP) > 1:
        spec[lead_axes] = DP
    if seq_axis is not None and _axis_size(mesh, SP) > 1:
        spec[lead_axes + seq_axis] = SP
    return P(*spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_sharding(mesh: Mesh, name: str, shape,
                   rule: Optional[Callable] = None) -> NamedSharding:
    rule = rule or default_param_rule
    return NamedSharding(mesh, rule(name, tuple(shape), mesh))


def data_sharding(mesh: Mesh, ndim: int,
                  seq_axis: Optional[int] = None) -> NamedSharding:
    return NamedSharding(mesh, batch_pspec(ndim, mesh, seq_axis))


def global_put(value, sharding: NamedSharding) -> ShardedTensor:
    """Place the global ``value`` (array, NDArray or tensor, the same on
    every rank) with ``sharding``: each rank keeps its own block on its
    device.  A `ShardedTensor` already so placed comes back as is."""
    if isinstance(value, ShardedTensor):
        if value.sharding == sharding:
            return value
        value = value.full_tensor()
    t = getattr(value, "data", value) if not isinstance(
        value, (torch.Tensor, np.ndarray)) else value
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    t = torch.as_tensor(t)
    local = sharding.shard(t).to(sharding.mesh.device).contiguous()
    return ShardedTensor(local, sharding, tuple(t.shape))
