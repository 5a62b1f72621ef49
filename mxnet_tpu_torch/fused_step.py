"""The one-step training plane's switch and shim (the counterpart of
`mxnet_tpu/fused_step.py`).

`FusedTrainStep` is `unified_step.UnifiedTrainStep` (the dense profile)
under the JAX package's name, which `Executor.make_fused_step` and
`Module.fused_step` build; `multi_tensor_apply` is re-exported.
`fused_enabled` reads ``MXTPU_FUSED_STEP`` (default on): off, `Module.fit`
runs ``forward_backward()`` + ``update()`` with the per-parameter update,
the same numbers.
"""
from __future__ import annotations

from . import config
from .unified_step import (UnifiedTrainStep, anomaly_guard_enabled,
                           guard_verdict, multi_tensor_apply)

__all__ = ["fused_enabled", "anomaly_guard_enabled", "guard_verdict",
           "multi_tensor_apply", "FusedTrainStep"]


def fused_enabled() -> bool:
    """``MXTPU_FUSED_STEP`` (default on)."""
    return config.get_env("MXTPU_FUSED_STEP", "1").strip().lower() \
        not in ("0", "false", "off")


class FusedTrainStep(UnifiedTrainStep):
    """One training step of an executor as one program: the unified
    step's dense profile."""
