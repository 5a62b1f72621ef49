"""Named collectives over mesh axes (the counterpart of
`mxnet_tpu/parallel/collectives.py`).

Each verb runs over the sub-group of one axis of the current mesh (the
`shard_map` body's, or `mesh_scope`'s): the ranks that share every
other coordinate.  Each is differentiable as its ``lax`` counterpart
is: a `torch.autograd.Function` whose backward is the transposed verb
(``psum`` gives ``psum``; ``all_gather`` and ``reduce_scatter`` are each
other's transpose; ``ppermute`` runs the reversed permutation;
``all_to_all`` the inverse exchange).

The wire: over gloo a device tensor is copied to the host (a
synchronous copy, so its producer on any stream has finished), gathered
there and copied back; over NCCL it stays on its card.  Sums add the
ranks' parts in rank order, so every rank gets the same bits and
``reduce_scatter``'s block r equals block r of ``psum`` bit for bit.
``ppermute`` pairs sends and receives in one ``batch_isend_irecv``, which
cannot deadlock.  Every wait is bounded by the group's timeout
(`distributed.DEFAULT_TIMEOUT_S`).

`shard_map(f, mesh, in_specs, out_specs)` is a rank running ``f`` on its
blocks of global inputs: each input is sliced by its spec, each output
gathered over its spec's axes, so the caller sees global values on every
rank.  At that boundary gradients follow the SPMD rule: a global input's
gradient is the sum over the ranks of their blocks' gradients (every
rank gets it), and a global output, which every rank holds and uses the
same way, passes 1/N of its gradient to each of the N copies of it.
"""
from __future__ import annotations

import datetime
import threading
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from .. import profiler as _prof
from . import distributed as _dist
from .functional import tree_leaves, tree_map
from .mesh import DP, Mesh, current_mesh, mesh_scope
from .sharding import NamedSharding, PartitionSpec, ShardedTensor

__all__ = ["psum", "pmean", "all_gather", "reduce_scatter", "ppermute",
           "all_to_all", "allreduce_mean", "shard_map", "axis_index",
           "axis_size", "unshard", "reducer"]


def _mesh() -> Mesh:
    m = current_mesh()
    if m is None:
        raise ValueError("a collective needs a mesh: call it inside "
                         "shard_map or `with mesh_scope(mesh):`")
    return m


def _axes(axis_name) -> Tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def axis_index(axis_name: str) -> int:
    """This rank's coordinate along ``axis_name`` (``lax.axis_index``)."""
    return _mesh().axis_index(axis_name)


def axis_size(axis_name: str) -> int:
    return _mesh().axis_size(axis_name)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _wire_time(t0: float, nbytes: int) -> None:
    """A collective's wall seconds (its wait for the tensor's producer
    included) and payload, into the comm counters' ``blocked_s`` and
    ``bytes``: a step's comm share is their delta over its time."""
    _prof.bump_comm("blocked_s", time.perf_counter() - t0)
    _prof.bump_comm("bytes", nbytes)


def _parts(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Every member's ``x`` along ``axis``, in axis order, on the wire
    device."""
    line = mesh.line(axis)
    if len(line) == 1:
        return [x.detach()]
    t0 = time.perf_counter()
    parts = _dist.gather_parts(x.detach(), mesh.group(axis), list(line))
    _wire_time(t0, x.numel() * x.element_size() * len(line))
    return parts


def _psum_raw(x, mesh, axis):
    parts = _parts(x, mesh, axis)
    if len(parts) == 1:
        return x.detach().clone()
    total = parts[0].clone()
    for p in parts[1:]:
        total.add_(p)
    return total.to(x.device)


def _gather_raw(x, mesh, axis, dim, tiled):
    parts = [p.to(x.device) for p in _parts(x, mesh, axis)]
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def _block(x, mesh, axis, dim):
    n = mesh.axis_size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis!r} ({n})")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * size, size)


def _ppermute_raw(x, mesh, axis, perm):
    line = mesh.line(axis)
    me = mesh.axis_index(axis)
    srcs = [s for s, d in perm if d == me]
    dsts = [d for s, d in perm if s == me]
    out = torch.zeros_like(x)
    if len(line) == 1:
        return x.detach().clone() if srcs else out
    t0 = time.perf_counter()
    wire = x.device if _dist.backend() == "nccl" else torch.device("cpu")
    src = x.detach().to(wire).contiguous()
    group = mesh.group(axis)
    ops, recv = [], None
    for d in dsts:
        if d == me:
            out = x.detach().clone()
        else:
            ops.append(tdist.P2POp(tdist.isend, src, line[d], group))
    for s in srcs:
        if s != me:
            recv = torch.empty_like(src)
            ops.append(tdist.P2POp(tdist.irecv, recv, line[s], group))
    if ops:
        timeout = datetime.timedelta(seconds=_dist.DEFAULT_TIMEOUT_S)
        for req in tdist.batch_isend_irecv(ops):
            req.wait(timeout) if _dist.backend() != "nccl" else req.wait()
    if recv is not None:
        out = recv.to(x.device)
    _wire_time(t0, src.numel() * src.element_size() * len(ops))
    return out


def _all_to_all_raw(x, mesh, axis, split_axis, concat_axis):
    n = mesh.axis_size(axis)
    me = mesh.axis_index(axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n}")
    parts = [p.to(x.device) for p in _parts(x, mesh, axis)]
    return torch.cat([p.chunk(n, split_axis)[me] for p in parts],
                     concat_axis)


# ---------------------------------------------------------------------------
# the differentiable verbs
# ---------------------------------------------------------------------------

class _Order(threading.local):
    def __init__(self):
        super().__init__()
        self.token = None


_ORDER = _Order()


class _Collective(torch.autograd.Function):
    """A collective as an autograd node.  Besides its value it threads an
    order token: inside `shard_map` each verb takes the previous verb's
    token and gives the next one, so a verb's backward waits for the
    backward of every verb issued after it.  The ranks then run their
    backward collectives in one order (the reverse of the forward's),
    whatever their graphs look like otherwise (a causal ring's masked
    hops, a pipeline stage's idle ticks), and a verb whose value went
    unused still takes part."""

    @staticmethod
    def forward(ctx, x, token, fwd, bwd):
        ctx.bwd, ctx.has_token = bwd, token is not None
        out = fwd(x)
        if out is x or out._base is x:
            out = out.clone()
        return out, (token.clone() if token is not None
                     else out.new_zeros(()))

    @staticmethod
    def backward(ctx, g, gtoken):
        return (ctx.bwd(g), gtoken if ctx.has_token else None, None,
                None)


def _apply(x, fwd, bwd):
    """``fwd(x)`` as a differentiable collective with backward ``bwd``,
    threaded on the current order token."""
    token = _ORDER.token
    if not torch.is_grad_enabled() or (token is None and
                                       not x.requires_grad):
        with torch.no_grad():
            return fwd(x)
    out, new = _Collective.apply(x, token, fwd, bwd)
    if token is not None:
        _ORDER.token = new
    return out


def _psum_fn(mesh, axis):
    return lambda t: _psum_raw(t, mesh, axis)


def psum(x, axis_name):
    """The sum of ``x`` over the ranks of ``axis_name`` (one name or a
    tuple), the same bits on each."""
    mesh = _mesh()
    for a in _axes(axis_name):
        if mesh.axis_size(a) > 1:
            f = _psum_fn(mesh, a)
            x = _apply(x, f, f)
    return x


def reducer(mesh: Mesh, axes: Sequence[str]) -> Callable:
    """``x -> psum(x)`` over ``axes`` of ``mesh``, bound to the mesh (for
    code that runs outside the mesh's scope, as a backward may)."""
    axes = tuple(a for a in axes if mesh.axis_size(a) > 1)

    def reduce(x):
        for a in axes:
            f = _psum_fn(mesh, a)
            x = _apply(x, f, f)
        return x

    return reduce


def pmean(x, axis_name):
    n = int(np.prod([_mesh().axis_size(a) for a in _axes(axis_name)]))
    return psum(x, axis_name) / n


def all_gather(x, axis_name, *, axis=0, tiled=True):
    mesh = _mesh()
    if mesh.axis_size(axis_name) == 1:
        return x if tiled else x.unsqueeze(axis)

    def bwd(g):
        total = _psum_raw(g, mesh, axis_name)
        mine = _block(total, mesh, axis_name, axis) if tiled else \
            total.select(axis, mesh.axis_index(axis_name))
        return mine.contiguous()

    return _apply(x, lambda t: _gather_raw(t, mesh, axis_name, axis, tiled),
                  bwd)


def reduce_scatter(x, axis_name, *, scatter_dimension=0, tiled=True):
    mesh = _mesh()
    d = scatter_dimension
    if mesh.axis_size(axis_name) == 1:
        return x if tiled else x.squeeze(d)

    def fwd(t):
        total = _psum_raw(t, mesh, axis_name)
        if tiled:
            return _block(total, mesh, axis_name, d).contiguous()
        return total.select(d, mesh.axis_index(axis_name)).contiguous()

    return _apply(x, fwd,
                  lambda g: _gather_raw(g, mesh, axis_name, d, tiled))


def ppermute(x, axis_name, perm):
    """Send ``x`` from axis index s to d for each pair (s, d) of ``perm``;
    a rank that receives nothing gets zeros (``lax.ppermute``)."""
    mesh = _mesh()
    perm = tuple((int(s), int(d)) for s, d in perm)
    inv = tuple((d, s) for s, d in perm)
    return _apply(x, lambda t: _ppermute_raw(t, mesh, axis_name, perm),
                  lambda g: _ppermute_raw(g, mesh, axis_name, inv))


def all_to_all(x, axis_name, split_axis, concat_axis, *, tiled=True):
    """Split ``x`` into N blocks along ``split_axis``; rank j gets block j
    of every rank, joined along ``concat_axis`` in rank order."""
    mesh = _mesh()
    if mesh.axis_size(axis_name) == 1:
        return x
    return _apply(
        x, lambda t: _all_to_all_raw(t, mesh, axis_name, split_axis,
                                     concat_axis),
        lambda g: _all_to_all_raw(g, mesh, axis_name, concat_axis,
                                  split_axis))


# ---------------------------------------------------------------------------
# global values: slicing in, gathering out
# ---------------------------------------------------------------------------

def unshard(local: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The global tensor whose block on this rank is ``local``."""
    mesh = sharding.mesh
    out = local
    for d, axes in sharding.dim_axes(local.dim()):
        for a in reversed(axes):
            out = _gather_raw(out, mesh, a, d, True)
    return out


def _psum_mesh(x, mesh):
    for a in mesh.axis_names:
        if mesh.axis_size(a) > 1:
            x = _psum_raw(x, mesh, a)
    return x


def _shard_in_fn(sharding, shape):
    def bwd(g):
        full = g.new_zeros(shape)
        sharding.shard(full).copy_(g)
        return _psum_mesh(full, sharding.mesh)
    return (lambda t: sharding.shard(t).contiguous()), bwd


def _shard_out_fn(sharding, ndim):
    gathered = 1
    for _d, axes in sharding.dim_axes(ndim):
        for a in axes:
            gathered *= sharding.mesh.axis_size(a)
    factor = gathered / sharding.mesh.size
    return (lambda t: unshard(t, sharding)), \
        (lambda g: (sharding.shard(g) * factor).contiguous())


def _is_spec(s) -> bool:
    return isinstance(s, PartitionSpec) or s is None


def _map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``, with ``specs`` a prefix of it (a
    spec applies to every leaf below it)."""
    if _is_spec(specs):
        spec = specs if specs is not None else PartitionSpec()
        return tree_map(lambda x: fn(x, spec), tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, tree[k], specs[k])) for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, t, s) for t, s in zip(tree, specs)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t, s) for t, s in zip(tree, specs))
    raise TypeError(f"shard_map: spec {specs!r} does not fit {type(tree)}")


def _shard_in(x, mesh, spec):
    if isinstance(x, ShardedTensor):
        return x.local
    if not isinstance(x, torch.Tensor):
        return x
    sh = NamedSharding(mesh, spec)
    if sh.is_fully_replicated() and mesh.size == 1:
        return x
    if x.requires_grad:
        # a global input's gradient: every rank's block gradient, summed
        # over the mesh into the global shape
        return _apply(x, *_shard_in_fn(sh, x.shape))
    return sh.shard(x.detach()).contiguous()


def _shard_out(x, mesh, spec):
    if not isinstance(x, torch.Tensor):
        return x
    if mesh.size == 1:
        return x
    sh = NamedSharding(mesh, spec)
    if x.requires_grad:
        # every rank holds the global output and uses it alike: each
        # copy passes its block's 1/N share of the gradient back
        return _apply(x, *_shard_out_fn(sh, x.dim()))
    return unshard(x, sh)


def shard_map(f: Callable, mesh: Mesh = None, in_specs=None, out_specs=None,
              **_ignored) -> Callable:
    """``f`` run by this rank on its blocks of the global inputs (sliced
    by ``in_specs``), its outputs gathered by ``out_specs`` into global
    values on every rank.  Inside ``f`` the verbs of this module resolve
    axis names against ``mesh``."""

    def mapped(*args):
        # an order token for the region when anything in it can take a
        # gradient (a nested region joins the outer one's)
        outer = _ORDER.token is not None or not torch.is_grad_enabled() \
            or not any(isinstance(t, torch.Tensor) and t.requires_grad
                       for t in tree_leaves(args))
        if not outer:
            _ORDER.token = torch.zeros((), device=mesh.device,
                                       requires_grad=True)
        try:
            local = _map(lambda x, s: _shard_in(x, mesh, s), tuple(args),
                         tuple(in_specs) if not _is_spec(in_specs)
                         else in_specs)
            with mesh_scope(mesh):
                out = f(*local)
            out = _map(lambda x, s: _shard_out(x, mesh, s), out, out_specs)
            if not outer:
                # the last token joins the outputs (adding zero), so the
                # backward reaches every verb of the region in order
                tail = _ORDER.token * 0
                out = tree_map(
                    lambda o: o + tail.to(o.dtype) if isinstance(
                        o, torch.Tensor) and o.requires_grad and
                    o.is_floating_point() else o, out)
            return out
        finally:
            if not outer:
                _ORDER.token = None

    return mapped


def allreduce_mean(stacked, mesh: Mesh, axis_name: str = DP):
    """Mean over a leading replica dim split over one mesh axis (the
    eager stand-in for `KVStoreNCCL`'s grouped allreduce): ``stacked`` is
    the global [n_replicas, ...]; every rank gets the mean."""
    if not isinstance(stacked, torch.Tensor):
        stacked = torch.as_tensor(np.asarray(stacked))

    def body(x):
        return pmean(x.mean(0), axis_name)

    return shard_map(body, mesh=mesh, in_specs=(PartitionSpec(axis_name),),
                     out_specs=PartitionSpec())(
        stacked.to(mesh.device))
