"""The one-program data-parallel step of ``Module.fit`` (the counterpart
of `mxnet_tpu/parallel/spmd_step.py`).

The step itself is the sharded profile of `unified_step.UnifiedTrainStep`
(a `ShardingSpec` on the same step the dense profile runs); this module
is its addressing: `spmd_enabled()` / `zero1_enabled()` (``MXTPU_SPMD``,
``MXTPU_SPMD_ZERO1``), `resolve_mesh()` (the ``dp`` mesh of ranks the
knob names) and `SpmdTrainStep`, the step built with that annotation.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .. import config
from ..unified_step import ShardingSpec, UnifiedTrainStep
from . import distributed as _dist
from .mesh import DP, Mesh, devices as _devices

__all__ = ["spmd_enabled", "zero1_enabled", "resolve_mesh", "SpmdTrainStep"]

_OFF = ("", "0", "false", "off")
_MESHES: Dict[Tuple, Mesh] = {}


def spmd_enabled() -> bool:
    """``MXTPU_SPMD`` (default off): ``0``/``off``/unset disables;
    ``auto``/``all``/``on``/``true`` uses every rank of the group; an
    integer n >= 1 the first n ranks (``1`` is a real one-rank mesh, the
    kill-switch parity configuration)."""
    return config.get_env("MXTPU_SPMD", "").strip().lower() not in _OFF


def zero1_enabled() -> bool:
    """``MXTPU_SPMD_ZERO1`` (default on).  Off is the all-reduce
    baseline: every rank updates the whole parameter set."""
    return config.get_env("MXTPU_SPMD_ZERO1", "1").strip().lower() \
        not in ("0", "false", "off")


def resolve_mesh(devices=None) -> Optional[Mesh]:
    """The one-axis ``dp`` mesh ``MXTPU_SPMD`` names (over ``devices``, by
    default every rank's device), or None when the knob is off.  Ranks
    the elastic mesh banned (`elastic_mesh.ban_device`: lost ranks) are
    never adopted.  A count larger than the ranks left is clamped to
    them.  Meshes are kept, so their process groups form once."""
    from .elastic_mesh import banned_ids
    v = config.get_env("MXTPU_SPMD", "").strip().lower()
    if v in _OFF:
        return None
    devs = list(devices) if devices is not None else list(_devices())
    banned = banned_ids()
    if banned:
        devs = [d for d in devs if int(d.id) not in banned]
        if not devs:
            return None
    if v in ("true", "on", "auto", "all"):
        n = len(devs)
    else:
        try:
            n = int(v)
        except ValueError:
            return None
        if n < 1:
            return None
        n = min(n, len(devs))
    key = (tuple(devs[:n]), _dist.size(), banned)
    mesh = _MESHES.get(key)
    if mesh is None:
        grid = np.empty(n, dtype=object)
        for i, d in enumerate(devs[:n]):
            grid[i] = d
        mesh = _MESHES[key] = Mesh(grid, (DP,))
    return mesh


class SpmdTrainStep(UnifiedTrainStep):
    """One SPMD training step: the unified step's sharded profile.
    ``mesh`` defaults to what ``MXTPU_SPMD`` resolves; ZeRO-1 follows
    ``MXTPU_SPMD_ZERO1``."""

    def __init__(self, executor, optimizer, updater, train_names,
                 mesh: Optional[Mesh] = None):
        mesh = mesh if mesh is not None else resolve_mesh()
        if mesh is None:
            raise ValueError("SpmdTrainStep needs a mesh (set MXTPU_SPMD "
                             "or pass mesh=)")
        super().__init__(executor, optimizer, updater, train_names,
                         sharding=ShardingSpec(mesh, zero1=zero1_enabled()))
