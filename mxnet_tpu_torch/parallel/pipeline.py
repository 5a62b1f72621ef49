"""Pipeline parallelism over the ``pp`` mesh axis, GPipe schedule (the
counterpart of `mxnet_tpu/parallel/pipeline.py`).

Every pp rank runs the same program on its stage: the stage weights
carry a leading stage axis split over pp, activations hop stage to stage
with ``ppermute`` (one ``batch_isend_irecv``), and the K-microbatch
schedule takes K + S - 1 ticks.  Autograd through the hops is the
pipelined backward: a ``ppermute``'s backward is the reverse hop.  A
stage's rank knows on the host which ticks carry work for it and runs
its stage function only on those; the hops run on every tick, so the
ranks' sends and receives always pair.

Bubble fraction is the GPipe (S-1)/(K+S-1); pick K >= 4*S for <20%.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import collectives as C
from .functional import tree_leaves, tree_map
from .mesh import PP, Mesh
from .sharding import PartitionSpec as P

__all__ = ["pipeline_apply", "stack_stage_params"]


def stack_stage_params(per_stage_params):
    """Stack per-stage parameter trees (dicts, lists, tuples) into one
    tree with a leading stage axis; every stage shares the structure."""
    return tree_map(lambda *xs: torch.stack(
        [torch.as_tensor(x) for x in xs]), *per_stage_params)


def pipeline_apply(stage_fn: Callable, stage_params, x, mesh: Mesh,
                   axis: str = PP, io_spec: P = None):
    """Run ``x`` (K, B, ...) -- K microbatches of B rows -- through S
    stages with the GPipe schedule.

    ``stage_fn(params_one_stage, activation) -> activation`` is the same
    function for every stage; ``stage_params`` is a tree whose leaves
    have leading axis S (`stack_stage_params`), split over ``axis``.
    ``io_spec`` places the microbatches (default ``P()``: every rank
    sees them all; ``P(None, 'dp')`` splits their rows over dp, so each
    dp group pipelines its own rows).  Returns the last stage's (K, B,
    ...) outputs on every rank; differentiable."""
    k = x.shape[0]
    s = mesh.shape[axis]
    if k < s:
        raise ValueError(
            f"pipeline needs at least S={s} microbatches, got {k}")
    n_stages = tree_leaves(stage_params)[0].shape[0]
    if n_stages != s:
        raise ValueError(
            f"stage_params stacks {n_stages} stages but mesh axis "
            f"{axis!r} has size {s}; they must match")
    pspec = tree_map(lambda _: P(axis), stage_params)
    if io_spec is None:
        io_spec = P()

    def run(params, xs):
        params = tree_map(lambda a: a[0], params)
        idx = C.axis_index(axis)
        perm = [(i, (i + 1) % s) for i in range(s)]
        with torch.no_grad():
            zero = torch.zeros_like(stage_fn(params, xs[0]))
        state = None
        outs = [zero] * k
        for t in range(k + s - 1):
            mb = t - idx                 # the microbatch this stage holds
            out = zero
            if 0 <= mb < k:
                out = stage_fn(params, xs[mb] if idx == 0 else state)
                if idx == s - 1:
                    outs[mb] = out
            if t < k + s - 2:
                state = C.ppermute(out, axis, perm)
        # only the last stage filled its outputs; the sum over the stages
        # hands them to every pp rank
        return C.psum(torch.stack(outs), axis)

    return C.shard_map(run, mesh=mesh, in_specs=(pspec, io_spec),
                       out_specs=io_spec)(stage_params, x)
