"""Device meshes over the process group (the counterpart of
`mxnet_tpu/parallel/mesh.py`).

JAX runs one controller over many devices; PyTorch runs one process per
device.  So a mesh here is a grid of the group's *ranks*, one device
each, with the JAX package's axis names (dp, tp, pp, sp, ep).  The
counterpart of ``jax.devices()`` is `devices()`: every rank's device, in
rank order.  A process with no group has a mesh of one, its own device.

Each axis of a mesh owns the sub-groups its collectives run over: the
ranks that share every other coordinate with this one
(`Mesh.group`).  They are created at first use, by the member ranks
only (``use_local_synchronization``), so a mesh over some of the ranks
never waits for the others.

Why not ``torch.distributed.device_mesh.DeviceMesh``: it forms a
process group even for one rank, and its collectives run on the
backend's device path, which gloo cannot order with CUDA streams on a
card that several ranks share.  The collectives of `collectives.py`
stage through the host in rank order instead (as `distributed.py`
does), so every rank gets the same bits.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import distributed as _dist

__all__ = ["make_mesh", "auto_mesh", "factorize", "device_ids", "devices",
           "RankDevice", "Mesh", "DP", "TP", "PP", "SP", "EP",
           "current_mesh", "mesh_scope"]

# canonical axis names, in the order shardings prefer them
DP = "dp"   # data parallel: the batch dim
TP = "tp"   # tensor parallel: weight channel dims
PP = "pp"   # pipeline parallel: layer stages
SP = "sp"   # sequence parallel: the sequence dim (ring attention)
EP = "ep"   # expert parallel: MoE experts


class RankDevice(NamedTuple):
    """One member of a mesh: a rank of the group and its device.  ``id``
    is the rank, the stable identity `device_ids` reports."""
    id: int
    device: torch.device


def _own_device() -> torch.device:
    """This process's device: the open ``with ctx:`` scope's, else its
    card (``cuda:rank % count``), and an error without one (never the
    CPU unasked)."""
    from ..context import _SCOPE, default_context
    if _SCOPE.value is not None:
        return _SCOPE.value.device
    default_context("parallel mesh")   # raises without a card
    return torch.device("cuda", _dist.rank() % torch.cuda.device_count())


def devices(device=None) -> Tuple[RankDevice, ...]:
    """Every rank's device, in rank order.  ``device`` (a torch device,
    a string or a Context) names this process's device; the default is
    its card (or the open context scope's device)."""
    if device is None:
        dev = _own_device()
    else:
        dev = getattr(device, "device", None)
        dev = torch.device(dev if dev is not None else device)
    n = _dist.size()
    if n == 1:
        return (RankDevice(0, dev),)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        return tuple(RankDevice(r, torch.device("cuda", r % count))
                     for r in range(n))
    return tuple(RankDevice(r, dev) for r in range(n))


class Mesh:
    """A grid of ranks with named axes (``jax.sharding.Mesh``'s surface:
    ``shape``, ``axis_names``, ``devices``, ``size``)."""

    def __init__(self, devices_grid: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices_grid, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {self.devices.shape} devices has "
                             f"{len(self.axis_names)} axis names")
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))
        self.ranks = np.vectorize(lambda d: int(d.id), otypes=[int])(
            self.devices) if self.devices.size else np.zeros((0,), int)
        me = _dist.rank()
        hit = np.argwhere(self.ranks == me)
        self._coords: Optional[Tuple[int, ...]] = \
            tuple(int(c) for c in hit[0]) if len(hit) else None
        self._groups: Dict[str, object] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """This process's device in the mesh."""
        return self.devices[self.coords].device

    @property
    def coords(self) -> Tuple[int, ...]:
        if self._coords is None:
            raise ValueError(f"rank {_dist.rank()} is not in this mesh "
                             f"(ranks {self.ranks.ravel().tolist()})")
        return self._coords

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def line(self, axis: str) -> Tuple[int, ...]:
        """The ranks of this rank's line along ``axis`` (every other
        coordinate fixed), in axis order."""
        i = self.axis_names.index(axis)
        idx = list(self.coords)
        idx[i] = slice(None)
        return tuple(int(r) for r in self.ranks[tuple(idx)])

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; None
        when the line is this rank alone."""
        line = self.line(axis)
        if len(line) == 1:
            return None
        g = self._groups.get(axis)
        if g is None:
            g = _dist.new_group(line)
            self._groups[axis] = g
        return g

    def __repr__(self):
        axes = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({axes}; ranks {self.ranks.ravel().tolist()})"


class _MeshStack(threading.local):
    def __init__(self):
        super().__init__()
        self.stack = []


_CURRENT = _MeshStack()


def factorize(n: int, k: int) -> Sequence[int]:
    """Split n devices into k near-equal factors, largest first
    (e.g. 8,2 -> (4,2); 8,3 -> (2,2,2))."""
    out = []
    rem = n
    for i in range(k - 1, 0, -1):
        target = max(1, round(rem ** (i / (i + 1))))
        f = 1
        for cand in range(target, 0, -1):
            if rem % cand == 0:
                f = cand
                break
        out.append(rem // f)
        rem = f
    out.append(rem)
    return tuple(out)


def device_ids(mesh: Mesh) -> Sequence[int]:
    """The ranks of a mesh's members, row-major: the identity that
    survives a mesh rebuild (coordinates shift, ranks do not)."""
    return tuple(int(d.id) for d in mesh.devices.flat)


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A Mesh from {axis_name: size}; the sizes must multiply to at most
    the device count (the first ones are used)."""
    if devices is None:
        devices = globals()["devices"]()
    devices = list(devices)
    sizes = list(axes.values())
    n = int(np.prod(sizes)) if sizes else 1
    if n > len(devices):
        raise ValueError(
            f"mesh {axes} needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = d
    return Mesh(grid.reshape(sizes), tuple(axes.keys()))


def auto_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1, pp: int = 1, sp: int = 1, ep: int = 1,
              devices=None) -> Mesh:
    """Mesh with the canonical axes; dp fills whatever the others leave.
    Axes of size 1 are kept so sharding rules can name them."""
    if devices is None:
        devices = globals()["devices"]()
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    rest = tp * pp * sp * ep
    if n_devices % rest:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"tp*pp*sp*ep={rest}")
    if dp is None:
        dp = n_devices // rest
    return make_mesh({DP: dp, TP: tp, PP: pp, SP: sp, EP: ep},
                     devices=devices[:dp * rest])


class mesh_scope:
    """``with mesh_scope(mesh): ...`` sets the mesh `current_mesh()` and
    the collectives' axis names resolve against."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        _CURRENT.stack.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _CURRENT.stack.pop()


def current_mesh() -> Optional[Mesh]:
    return _CURRENT.stack[-1] if _CURRENT.stack else None
