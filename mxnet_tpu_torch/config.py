"""Environment knobs this package reads, under the JAX package's names so
that one variable drives both packages.

``MXTPU_PALLAS`` and ``MXTPU_PALLAS_MIN_FLOPS`` keep their names but select
the hand-written Hopper kernels of `ops/hopper_kernels.py` here:
``MXTPU_PALLAS=auto`` means "the bound device is CUDA with compute
capability (9, 0)", ``1`` swaps on any device (a CPU tensor then takes the
kernel's plain PyTorch version), ``0`` never swaps.
"""
from __future__ import annotations

import os
from collections import namedtuple
from typing import Any, Dict, Optional

__all__ = ["EnvVar", "get_env"]

EnvVar = namedtuple("EnvVar", ["name", "type", "default", "doc"])

_R: Dict[str, EnvVar] = {}


def _reg(name, typ, default, doc):
    _R[name] = EnvVar(name, typ, default, doc)


_reg("MXTPU_GRAPH_OPT", str, "1",
     "graph-rewrite pipeline kill switch; '0'/'false'/'off' runs the bound "
     "symbol unoptimized (graph_opt.graph_opt_enabled)")
_reg("MXTPU_GRAPH_OPT_SKIP", str, "",
     "comma-separated pass names to disable individually "
     "(graph_opt.skipped_passes)")
_reg("MXTPU_PALLAS", str, "auto",
     "Hopper kernel selection: 'auto' swaps matched subgraphs only when "
     "the bound device is CUDA capability (9, 0), '1' on any device, "
     "'0'/'off' never (graph_opt.pallas_mode)")
_reg("MXTPU_PALLAS_MIN_FLOPS", float, 1e6,
     "kernel-selection floor: an attention site below this analytic flop "
     "count keeps the unfused graph (graph_opt pallas_select)")
_reg("MXTPU_UNIFIED_STEP", str, "1",
     "training pass list: on, the unified list (eliminate, cse, dead_aux); "
     "'0'/'false'/'off', the legacy pair (cse, dead_aux) "
     "(graph_opt.train_passes)")


_reg("MXTPU_GRAPH_OPT_FOLD_MAX_MB", int, 64,
     "constant-folding budget: skip the fold when the baked constants "
     "would exceed this many MB (graph_opt fold_const)")
_reg("MXTPU_GRAPH_COMPILE", str, "1",
     "CUDA-graph capture of inference programs and training steps; "
     "'0'/'false'/'off' runs their steps eagerly "
     "(graph_compile.graph_compile_enabled)")
_reg("MXTPU_FUSED_STEP", str, "1",
     "one-step training plane; '0'/'false'/'off' makes Module.fit run "
     "forward_backward + the per-parameter update "
     "(fused_step.fused_enabled)")
_reg("MXTPU_UNIFIED_METRIC", str, "1",
     "fit's metric accumulated inside the training step; "
     "'0'/'false'/'off' keeps the per-step host update_metric "
     "(unified_step.metric_in_trace_enabled)")


def _flag(raw) -> bool:
    """dmlc's bool: "0", "false" and "" are false, anything else true."""
    return str(raw).strip().lower() not in ("0", "false", "")


_reg("MXTPU_ANOMALY_GUARD", _flag, False,
     "device-side finite check of the loss outputs and the global "
     "gradient norm inside the training step: a non-finite step leaves "
     "the parameters, optimizer states and aux states as they were "
     "(unified_step.anomaly_guard_enabled)")


_reg("MXNET_ENGINE_TYPE", str, "ThreadedEnginePerDevice",
     "engine kind: 'NaiveEngine' runs every push synchronously on the "
     "caller's turn (engine.Engine)")
_reg("MXNET_CPU_WORKER_NTHREADS", int, 1,
     "host worker threads: the engine's pool and the native JPEG decode "
     "pool")
_reg("MXTPU_PREFETCH_DEPTH", int, 2,
     "batches PrefetchingIter keeps in flight ahead of the consumer "
     "(io.PrefetchingIter)")
_reg("MXTPU_FAST_DECODE", _flag, True,
     "native JPEG decode with the IFAST DCT and plain chroma upsampling "
     "(about 1 LSB of luma error); 0 decodes exactly (ISLOW)")


_reg("MXTPU_CKPT_DIR", str, "",
     "root directory of the CheckpointManager auto-resume path: set, "
     "Module.fit checkpoints every epoch and resumes from latest_valid() "
     "on restart (params, optimizer states, RNG, epoch); empty = off "
     "(checkpoint.auto_manager)")
_reg("MXTPU_CKPT_KEEP", int, 3,
     "rolling retention: committed checkpoints the CheckpointManager keeps; "
     "older ones (and stale aborted saves) are deleted at each commit")
_reg("MXTPU_CKPT_COMMIT_DELAY", float, 0.0,
     "seconds slept between writing a checkpoint's data files and "
     "committing its MANIFEST.json, which widens the window a crash test "
     "kills in")


def get_env(name: str, default: Optional[Any] = None):
    """Typed env lookup; unregistered names return the raw string (or
    ``default``)."""
    spec = _R.get(name)
    raw = os.environ.get(name)
    if spec is None:
        return raw if raw is not None else default
    if raw is None:
        return default if default is not None else spec.default
    try:
        return spec.type(raw)
    except (TypeError, ValueError):
        return spec.default
