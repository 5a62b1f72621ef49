"""SPMD parallelism over a mesh of ranks (the counterpart of
`mxnet_tpu/parallel/`).

The JAX package runs one controller over a `jax.sharding.Mesh` with named
axes (dp/tp/pp/sp/ep) and lets GSPMD insert the collectives.  Here each
rank of a `torch.distributed` group is one member of the mesh (`mesh.py`)
and runs the step on its blocks: `SPMDTrainer` (data and tensor
parallelism), `ring_attention` / `ulysses_attention` (sequence
parallelism), `pipeline_apply` (GPipe over pp), `moe_ffn` (experts over
ep), with the differentiable collectives of `collectives.py` and
`shard_map` for global values in and out.  `spmd_step` is the one-program
data-parallel step with ZeRO-1 that ``Module.fit`` takes under
``MXTPU_SPMD``.
"""
from . import distributed  # noqa: F401
from .mesh import (DP, EP, PP, SP, TP, auto_mesh, current_mesh, devices,
                   factorize, make_mesh, mesh_scope)
from .sharding import (NamedSharding, PartitionSpec, ShardedTensor,
                       batch_pspec, data_sharding, default_param_rule,
                       global_put, param_sharding, replicated)
from .collectives import (all_gather, all_to_all, allreduce_mean, pmean,
                          ppermute, psum, reduce_scatter, shard_map)
from .functional import functionalize, split_params
from .optim import pure_rule
from .ring_attention import (local_attention, ring_attention,
                             ring_attention_shard, ulysses_attention)
from .pipeline import pipeline_apply, stack_stage_params
from .moe import MoEParams, expert_sharding, init_moe, moe_ffn
from .trainer import SPMDTrainer
from .spmd_step import (SpmdTrainStep, resolve_mesh, spmd_enabled,
                        zero1_enabled)
from .feed import DeviceFeed
from . import failure
from .failure import (HeartbeatClient, HeartbeatMonitor,
                      start_failure_detector)

__all__ = [
    "DP", "TP", "PP", "SP", "EP", "make_mesh", "auto_mesh", "factorize",
    "devices", "current_mesh", "mesh_scope", "default_param_rule",
    "batch_pspec", "param_sharding", "data_sharding", "replicated",
    "global_put", "NamedSharding", "PartitionSpec", "ShardedTensor",
    "psum", "pmean", "all_gather", "reduce_scatter", "ppermute",
    "all_to_all", "allreduce_mean", "shard_map", "functionalize",
    "split_params", "pure_rule", "ring_attention", "ring_attention_shard",
    "ulysses_attention", "local_attention", "SPMDTrainer", "SpmdTrainStep",
    "spmd_enabled", "zero1_enabled", "resolve_mesh", "pipeline_apply",
    "stack_stage_params", "MoEParams", "init_moe", "moe_ffn",
    "expert_sharding", "DeviceFeed", "distributed", "failure",
    "HeartbeatClient", "HeartbeatMonitor", "start_failure_detector",
]
