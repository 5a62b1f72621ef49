"""The training step as one program (the counterpart of
`mxnet_tpu/unified_step.py`: its dense profile and, under a
`ShardingSpec`, its sharded profile).

`UnifiedTrainStep` runs forward, backward, the multi-tensor optimizer
update, the in-step metric and the anomaly guard as one step.  On a CUDA
device the step is captured once per shape set as a CUDA graph and
replayed: the counterpart of the JAX package's one donated jit program.
The first step of a shape set runs eagerly on a side stream (the warm-up,
a real step), the capture follows, and every later step is one replay.
On the CPU, and under ``MXTPU_GRAPH_COMPILE=0``, the same step code runs
eagerly.  A capture that fails raises; it never carries on eagerly.

What a replay must not freeze:

* **the per-step scalars.**  The host keeps the reference's bookkeeping
  order (each parameter's update count advances before its lr is read),
  so a schedule's lr, Adam's bias-corrected lr (which depends on t) and
  wd are computed on the host every step and written into one device
  buffer the graph reads.  rescale_grad and clip_gradient are static, as
  in the reference: a new value is a new capture.
* **the random streams.**  Dropout draws from the port's explicit
  generator, which each capture registers, so every replay draws new
  masks.
* **the buffers.**  The batch is copied into the executor's bound inputs
  before each replay; the parameters, the optimizer states and the aux
  states are updated in place.  The outputs are the graph's static
  tensors: ``get_outputs()`` after a step holds that step's outputs until
  the next step, as an MXNet executor's outputs do.

`multi_tensor_apply` is the update alone, grouped per (op, static
hyperparameters, dtype, lr, wd): a few ``torch._foreach_*`` launches per
group instead of a handful per parameter (``Updater.update_multi``).
The JAX package computes this update in XLA, not in a Pallas kernel, so
PyTorch's multi-tensor ops are its counterpart here.

The sharded profile (`ShardingSpec`: a one-axis ``dp`` mesh of ranks and
ZeRO-1 on or off) is the JAX package's one-program SPMD step with each
rank as one replica.  A rank runs forward and backward on its rows of the
global batch (an executor reshaped to them, sharing the parameters), with
BatchNorm's moments and SoftmaxOutput's normalizer taken over the whole
batch (`ops.nn.batch_stats_scope`), so the step is one device's on the
whole batch.  The gradients go into one flat bucket per (update op,
static hyperparameters, dtype, state dtypes, lr, wd) group, padded to a
multiple of 64·N elements.  Under ZeRO-1 each bucket is reduce-scattered
(each rank gets the rank-ordered sum of its 1/N block), the rank updates
its block of the weights with its 1/N of the optimizer state, and the
new weights are all-gathered; without it (the all-reduce baseline) every
rank sums the whole bucket and updates everything.  Block r of the sum is
the same bits either way and the update ops are elementwise, so the two
are bit-equal.  The optimizer state lives in the flat buffers between
steps (the per-parameter states hold 1-element placeholders); the
updater's ``_spmd_bridge`` exports them back for a checkpoint
(`Updater.get_states`), re-imports after a load, and hands authority
back to the per-parameter paths (`relinquish`).  A batch the mesh does
not divide (a ragged tail) falls back to the dense step for that batch.
With one rank the step captures as a CUDA graph on the card, as the dense
one does; with several, the collectives stage through the host in rank
order and the step runs eagerly.

Switches, under the JAX package's names: ``MXTPU_UNIFIED_STEP`` (the
training pass list, and fit's in-step metric), ``MXTPU_UNIFIED_METRIC``
(the metric alone), ``MXTPU_ANOMALY_GUARD`` (the device-side skip of a
non-finite step: the weights, optimizer states and aux states keep their
pre-step values, decided on the device with no host read).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config
from . import profiler as _prof
from . import random as _random
from .graph_compile import (CapturedGraph, build_steps, feed_key,
                            graph_compile_enabled, record_steps, tape_grads,
                            warm_up)
from .graph_opt import training_result
from .ndarray.ndarray import NDArray
from .ops.optimizer_ops import apply_multi
from .ops.registry import canonical_attrs

__all__ = ["unified_enabled", "metric_in_trace_enabled",
           "anomaly_guard_enabled", "guard_verdict", "multi_tensor_apply",
           "ShardingSpec", "UnifiedTrainStep"]


def _on(name: str) -> bool:
    return config.get_env(name, "1").strip().lower() \
        not in ("0", "false", "off")


def unified_enabled() -> bool:
    """``MXTPU_UNIFIED_STEP`` (default on)."""
    return _on("MXTPU_UNIFIED_STEP")


def metric_in_trace_enabled() -> bool:
    """``MXTPU_UNIFIED_METRIC`` (default on; active with the plane)."""
    return _on("MXTPU_UNIFIED_METRIC")


def anomaly_guard_enabled() -> bool:
    """``MXTPU_ANOMALY_GUARD`` (default off)."""
    return bool(config.get_env("MXTPU_ANOMALY_GUARD"))


def _poisoned() -> bool:
    """Whether the active fault plan poisons this step
    (`fault_injection.FaultPlan.poison_step_at`): it then runs eagerly
    with NaN gradients, which the anomaly guard must skip."""
    from . import fault_injection as _fi
    plan = _fi.active()
    return plan is not None and bool(plan.poison_step_at) and \
        plan.poison_step_event()


def _poison(gs: List[torch.Tensor]) -> List[torch.Tensor]:
    return [g + float("nan") for g in gs]


def guard_verdict(outs: Sequence[torch.Tensor], gsq: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ok, grad norm)`` as device tensors: every output finite and the
    global gradient norm (from its square ``gsq``) finite.  A squared sum
    that overflows to inf counts as an anomaly."""
    ok = torch.ones((), dtype=torch.bool, device=gsq.device)
    for o in outs:
        ok = ok & torch.isfinite(o).all()
    gnorm = torch.sqrt(gsq)
    return ok & torch.isfinite(gnorm), gnorm


# ---------------------------------------------------------------------------
# the multi-tensor update
# ---------------------------------------------------------------------------

def _group(plans, ws, lrs, wds):
    """The positions of one update, grouped by (op, static attrs, weight
    dtype and device, lr, wd) in first-seen order: ``[(op, static,
    positions)]`` and each group's ``(lr, wd)``.  Weights on several
    devices (``group2ctx``) make one group per device."""
    groups: Dict[Tuple, List[int]] = {}
    for pos, (op_name, static) in enumerate(plans):
        key = (op_name, canonical_attrs(static), ws[pos].dtype,
               ws[pos].device, lrs[pos], wds[pos])
        groups.setdefault(key, []).append(pos)
    layout = [(key[0], dict(key[1]), poss) for key, poss in groups.items()]
    return layout, [(key[4], key[5]) for key in groups]


def _traced_apply(layout, ws, gs, states, scalars, rescale, clip) -> None:
    """Every group's update in place; ``scalars`` holds each group's
    (lr, wd), floats or 0-dim tensors."""
    for (op_name, static, poss), (lr, wd) in zip(layout, scalars):
        n_slots = len(states[poss[0]])
        apply_multi(op_name, static, [ws[p] for p in poss],
                    [gs[p] for p in poss],
                    [[states[p][k] for p in poss] for k in range(n_slots)],
                    lr, wd, rescale, clip)


def multi_tensor_apply(optimizer, items) -> bool:
    """Apply ``optimizer`` to many parameters at once (``items``: ordered
    ``[(index, weight, grad, state)]``, as the per-parameter loop would
    visit them), with the same numbers as that loop: the host's
    count/lr/wd bookkeeping runs in the same order and each group runs
    the same update op.  False, with nothing changed, when a parameter
    has no plan (the caller then loops)."""
    if not items:
        return True
    if len({id(it[1]) for it in items}) != len(items):
        return False
    plans, state_nds = [], []
    for index, w, _g, state in items:
        plan = optimizer._fused_plan(index, w, state)
        if plan is None:
            return False
        plans.append((plan[0], plan[1]))
        state_nds.append(plan[2])
    lrs, wds = [], []
    for index, _w, _g, _s in items:
        optimizer._update_count(index)
        lr, wd = optimizer._fused_scalars(index)
        lrs.append(float(lr))
        wds.append(float(wd))
    ws = [it[1].data for it in items]
    layout, scalars = _group(plans, ws, lrs, wds)
    clip = None if optimizer.clip_gradient is None \
        else float(optimizer.clip_gradient)
    _traced_apply(layout, ws, [it[2].data for it in items],
           [[s.data for s in sl] for sl in state_nds], scalars,
           float(optimizer.rescale_grad), clip)
    return True


# ---------------------------------------------------------------------------
# the sharding annotation and the bucket layout (the sharded profile)
# ---------------------------------------------------------------------------

#: a shard of a bucket is a multiple of this many elements, so a block
#: and the whole buffer meet the elementwise kernels' vector loops alike
_SHARD_ALIGN = 64


class ShardingSpec:
    """The annotation that turns the dense step into the sharded one:
    ``mesh`` is a one-axis ``dp`` mesh of ranks, ``zero1`` shards the
    update across it (off = the all-reduce baseline); ``redundancy`` keeps
    each rank's ring successor's state shard as a buddy copy (None =
    ``MXTPU_SPMD_SHARD_REDUNDANCY``)."""

    __slots__ = ("mesh", "zero1", "redundancy")

    def __init__(self, mesh, zero1: bool = True, redundancy=None):
        self.mesh = mesh
        self.zero1 = bool(zero1)
        self.redundancy = redundancy


class _Group:
    """One bucket: the members' layout in the flat buffer and the
    per-parameter state NDArrays it exports into."""

    __slots__ = ("op_name", "static", "w_dtype", "slot_dtypes", "names",
                 "positions", "shapes", "sizes", "offsets", "total",
                 "padded", "shard", "slot_nds")

    def __init__(self, op_name, static, w_dtype, slot_dtypes):
        self.op_name, self.static = op_name, static
        self.w_dtype, self.slot_dtypes = w_dtype, slot_dtypes
        self.names: List[str] = []
        self.positions: List[int] = []
        self.shapes: List[Tuple[int, ...]] = []
        self.sizes: List[int] = []
        self.offsets: List[int] = []
        self.total = self.padded = self.shard = 0
        self.slot_nds: List[List[Any]] = []

    def add(self, name, pos, shape, st_nds):
        size = int(np.prod(shape)) if shape else 1
        self.names.append(name)
        self.positions.append(pos)
        self.shapes.append(tuple(shape))
        self.sizes.append(size)
        self.offsets.append(self.total)
        self.total += size
        self.slot_nds.append(list(st_nds))

    def finalize(self, n):
        unit = n * _SHARD_ALIGN
        self.padded = -(-self.total // unit) * unit
        self.shard = self.padded // n


# ---------------------------------------------------------------------------
# the in-step metric
# ---------------------------------------------------------------------------

class _MetricSlot:
    """One fit metric riding the step: its device accumulator (a float32
    scalar of the step's, which the step advances in place and the metric
    reads from), the host instance count (label shapes are static) and
    the (output index, label name) pairs."""

    __slots__ = ("metric", "pairs", "axis", "acc", "host_num")

    def __init__(self, metric, pairs, axis):
        self.metric = metric
        self.pairs = tuple(pairs)
        self.axis = int(axis)
        self.acc: Optional[torch.Tensor] = None
        self.host_num = -1


def _metric_slots(eval_metric, label_names, n_outs):
    """Slots for `metric.Accuracy` and composites of it, paired with the
    labels by position as `Module.fit` pairs them; None when a sub-metric
    is of another kind (fit then keeps the host `update_metric`)."""
    from . import metric as _metric
    ms = (list(eval_metric.metrics)
          if isinstance(eval_metric, _metric.CompositeEvalMetric)
          else [eval_metric])
    if not ms or n_outs == 0 or len(label_names) != n_outs:
        return None
    slots = []
    for m in ms:
        if type(m) is not _metric.Accuracy:
            return None
        if m.output_names is not None or m.label_names is not None:
            return None
        slots.append(_MetricSlot(m, [(j, label_names[j])
                                     for j in range(n_outs)], m.axis))
    return slots


def _metric_incs(slots, outs, labels) -> List[torch.Tensor]:
    """Each slot's correct count for this step, as `metric.Accuracy`'s
    device path counts it (argmax when the shapes differ, int32, equal)."""
    incs = []
    for s in slots:
        inc = None
        for oi, lname in s.pairs:
            p, lab = outs[oi], labels[lname]
            if p.shape != lab.shape:
                p = p.argmax(dim=s.axis)
            c = (p.to(torch.int32).reshape(-1)
                 == lab.to(torch.int32).reshape(-1)).sum()
            inc = c if inc is None else inc + c
        incs.append(inc)
    return incs


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class UnifiedTrainStep:
    """One training step of an `Executor` as one program.

    ``train_names`` are the arguments to differentiate and update; their
    position in ``executor.arg_names`` is the optimizer's index, as on the
    per-parameter path, so the states are shared between the paths.
    Every other argument (data, labels, fixed parameters) rides along
    undifferentiated.  The head gradients are ones, as `Module.fit`'s
    ``backward()`` gives."""

    def __init__(self, executor, optimizer, updater, train_names,
                 sharding: Optional[ShardingSpec] = None):
        self._exec = executor
        self._optimizer = optimizer
        self._updater = updater
        wanted = set(train_names)
        self._train_names = [n for n in executor.arg_names if n in wanted]
        self._train_idx = {n: i for i, n in enumerate(executor.arg_names)
                           if n in wanted}
        # MXTPU_GRAPH_OPT_VERIFY=1 checks the optimized graph against the
        # bound values, on a random stream of its own
        verify_feed = {n: a.data for d in (executor.arg_dict,
                                           executor.aux_dict)
                       for n, a in d.items()}
        sym, reports = training_result(executor._symbol,
                                       verify_feed=verify_feed,
                                       verify_key=0)
        self.opt_reports = list(reports)
        if reports:
            _prof.bump_unified("train_opt_rewrites",
                               sum(r.rewrites for r in reports))
            _prof.set_unified("train_opt_nodes_before",
                              reports[0].nodes_before)
            _prof.set_unified("train_opt_nodes_after",
                              reports[-1].nodes_after)
        self._plan = build_steps(sym)
        self._device = executor._ctx.device
        self._graphs: Dict[Tuple, CapturedGraph] = {}
        self._scalar_bufs: Dict[int, torch.Tensor] = {}
        # the accumulators of the metric slots, by slot position: a new
        # metric reuses them, so it needs no capture of its own
        self._accs: List[torch.Tensor] = []
        self._metric_plan: Optional[List[_MetricSlot]] = None
        self._metric_key = None
        #: whether the last `step` accumulated the fit metric itself
        self.metric_in_trace = False
        #: the anomaly guard's verdict and gradient norm of the last step
        #: (device tensors; True and None with the guard off)
        self.last_step_ok: Any = True
        self.last_grad_norm: Optional[torch.Tensor] = None
        # what `audit` reads of the last step: its update layout and
        # scalars, and the storage of what it updates in place
        self._audit_last: Optional[Dict[str, Any]] = None
        self._capture_ptrs: Dict[Tuple, Dict[str, int]] = {}
        self._spec = sharding
        self._mesh = None
        self._n = 1
        self._zero1 = False
        self._redundancy = False
        if sharding is not None:
            from .parallel import elastic_mesh as _emesh
            if sharding.mesh is None:
                raise ValueError("the sharded profile needs a mesh on its "
                                 "ShardingSpec")
            self._mesh = sharding.mesh
            self._n = int(self._mesh.size)
            self._zero1 = bool(sharding.zero1)
            red = sharding.redundancy
            if red is None:
                red = _emesh.shard_redundancy_enabled()
            # buddy redundancy: each rank also keeps its ring successor's
            # state shard, updated from the summed gradient it holds anyway
            self._redundancy = bool(red) and self._zero1 and self._n > 1
            self._groups: Optional[List[_Group]] = None
            self._flat_states: List[Tuple[torch.Tensor, ...]] = []
            self._buddy_states: Optional[List[Tuple[torch.Tensor, ...]]] = \
                None
            self._stale = True
            self._disabled = False
            self._locals: Dict[Tuple, Any] = {}
            self._split_ok: Dict[Tuple, bool] = {}
            updater._spmd_bridge = self

    @property
    def captured(self) -> bool:
        """Whether steps run as CUDA graphs (the dense profile, and the
        sharded one over one rank)."""
        return self._device.type == "cuda" and graph_compile_enabled() \
            and self._n == 1

    @property
    def sharded(self) -> bool:
        return self._spec is not None

    def rebind(self, executor):
        """Adopt a reshaped executor of the same symbol and arguments."""
        self._exec = executor

    # -- metric ----------------------------------------------------------
    def attach_metric(self, eval_metric, label_names) -> bool:
        """Accumulate ``eval_metric`` inside the step (labels paired by
        position).  False, detached, when a sub-metric is unsupported or
        the plane is off: the caller keeps the host `update_metric`."""
        key = (id(eval_metric), tuple(label_names))
        if self._metric_key == key and self._metric_plan is not None:
            return True
        self._detach_metric()
        if eval_metric is None or not (unified_enabled()
                                       and metric_in_trace_enabled()):
            return False
        self._metric_plan = _metric_slots(eval_metric, list(label_names),
                                          len(self._exec.output_names))
        self._metric_key = key if self._metric_plan is not None else None
        return self._metric_plan is not None

    def _detach_metric(self) -> None:
        """Hand each attached metric a copy of its sum: the accumulators
        go on to serve the next metric."""
        for s in self._metric_plan or []:
            if s.metric.sum_metric is s.acc:
                s.metric.sum_metric = s.acc.clone()
        self._metric_plan = self._metric_key = None

    def _metric_prepare(self) -> None:
        """Seed each accumulator from its metric where the metric moved on
        without this step (a reset, a host update)."""
        for j, s in enumerate(self._metric_plan or []):
            m = s.metric
            if j == len(self._accs):
                self._accs.append(torch.zeros((), dtype=torch.float32,
                                              device=self._device))
            s.acc = self._accs[j]
            if m.sum_metric is not s.acc or int(m.num_inst) != s.host_num:
                with torch.no_grad():
                    s.acc.copy_(torch.as_tensor(m.sum_metric))
                s.host_num = int(m.num_inst)

    def _metric_commit(self, label_shapes) -> None:
        for s in self._metric_plan or []:
            for _oi, lname in s.pairs:
                n = 1
                for d in label_shapes[lname]:
                    n *= int(d)
                s.host_num += n
            s.metric.sum_metric = s.acc
            s.metric.num_inst = s.host_num
        self.metric_in_trace = bool(self._metric_plan)

    # -- the step ----------------------------------------------------------
    def _host_scalars(self, opt):
        """Each parameter's (lr, wd) in the per-parameter order: its update
        count advances before its lr is read."""
        lrs, wds = [], []
        for name in self._train_names:
            i = self._train_idx[name]
            opt._update_count(i)
            lr, wd = opt._fused_scalars(i)
            lrs.append(float(lr))
            wds.append(float(wd))
        return lrs, wds

    def _scalars(self, values) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each group's (lr, wd) as views of one device buffer, written
        with this step's values (a buffer per group count, so a capture
        keeps reading the buffer it captured)."""
        flat = [v for pair in values for v in pair]
        buf = self._scalar_bufs.get(len(flat))
        if buf is None:
            buf = self._scalar_bufs[len(flat)] = torch.zeros(
                len(flat), dtype=torch.float32, device=self._device)
        buf.copy_(torch.tensor(flat, dtype=torch.float32))
        return [(buf[2 * j], buf[2 * j + 1]) for j in range(len(values))]

    def step(self, feeds: Dict[str, Any]) -> bool:
        """Run one step on ``feeds`` (data and label arrays by argument
        name).  True with the executor's outputs set; False, with nothing
        changed, when the optimizer has no multi-tensor plan for a
        parameter (the caller then runs ``forward_backward`` +
        ``update``), or, sharded, when this batch cannot run sharded (the
        state authority then goes back to the updater)."""
        self.metric_in_trace = False
        if self._spec is not None:
            return self._step_sharded(feeds)
        exec_, upd = self._exec, self._updater
        opt = upd.optimizer
        b = getattr(upd, "_spmd_bridge", None)
        if b is not None:
            b.relinquish()
        ws_nd = [exec_.arg_dict[n] for n in self._train_names]
        if len({id(w) for w in ws_nd}) != len(ws_nd):
            return False
        opt._set_current_context(exec_._ctx.device_id)
        plans, state_nds = [], []
        for name, w in zip(self._train_names, ws_nd):
            i = self._train_idx[name]
            plan = opt._fused_plan(i, w, upd._state(i, w))
            if plan is None:
                return False
            plans.append((plan[0], plan[1]))
            state_nds.append(plan[2])
        lrs, wds = self._host_scalars(opt)
        ws = [w.data for w in ws_nd]
        layout, values = _group(plans, ws, lrs, wds)
        rescale = float(opt.rescale_grad)
        clip = None if opt.clip_gradient is None \
            else float(opt.clip_gradient)
        guard = anomaly_guard_enabled()
        with torch.no_grad():
            for name, arr in feeds.items():
                src = arr.data if isinstance(arr, NDArray) else \
                    torch.as_tensor(arr)
                exec_.arg_dict[name].data.copy_(src)
        scalars = self._scalars(values)
        self._metric_prepare()
        slots = self._metric_plan or []
        states = [[s.data for s in sl] for sl in state_nds]
        feed = exec_._feed()
        gen = _random.generator(self._device)
        names = self._train_names
        aux_dict = exec_.aux_dict

        poison = _poisoned()

        def body():
            outs, aux, tape = record_steps(self._plan, feed, names, gen)
            grads = tape_grads(tape, [torch.ones_like(o) for o in outs])
            gs = [grads[n] if grads[n] is not None else torch.zeros_like(w)
                  for n, w in zip(names, ws)]
            if poison:
                gs = _poison(gs)
            ok = gnorm = None
            with torch.no_grad():
                if guard:
                    gsq = torch.zeros((), dtype=torch.float32,
                                      device=self._device)
                    for g in gs:
                        gsq = gsq + g.float().square().sum()
                    ok, gnorm = guard_verdict(outs, gsq)
                    kept = ws + [t for sl in states for t in sl] + \
                        [aux_dict[n].data for n in aux if n in aux_dict]
                    before = [t.clone() for t in kept]
                _traced_apply(layout, ws, gs, states, scalars, rescale, clip)
                for name, val in aux.items():
                    if name in aux_dict:
                        aux_dict[name].data.copy_(val)
                if guard:
                    for t, b in zip(kept, before):
                        t.copy_(torch.where(ok, t, b))
                for s, inc in zip(slots, _metric_incs(slots, outs, feed)):
                    s.acc.add_(inc)
            return outs, ok, gnorm

        inplace = {f"weight:{n}": w for n, w in zip(names, ws)}
        inplace.update({f"state{k}:{names[p]}": t
                        for p in range(len(names))
                        for k, t in enumerate(states[p])})
        ptrs_before = {k: t.data_ptr() for k, t in inplace.items()}
        if self.captured and not poison:
            key = (tuple((op, canonical_attrs(st), tuple(p))
                         for op, st, p in layout), rescale, clip, guard,
                   tuple((s.axis, s.pairs) for s in slots),
                   feed_key({**feed, **{f"state{j}": t for j, t in
                                        enumerate(t for sl in states
                                                  for t in sl)}}))
            graph = self._graphs.get(key)
            if graph is None:
                res = warm_up(body, self._device)
                self._graphs[key] = CapturedGraph(body, self._device, gen)
                self._capture_ptrs[key] = dict(ptrs_before)
            else:
                res = graph.replay()
            ptrs_before = self._capture_ptrs[key]
        else:
            res = body()
        self._audit_last = {
            "layout": layout, "values": values, "feed": feed,
            "before": ptrs_before,
            "after": {k: t.data_ptr() for k, t in inplace.items()}}
        outs, ok, gnorm = res
        # host dict adds around the replay, never inside the captured body
        _prof.bump_counter("dispatches")
        _prof.bump_counter("fused_steps")
        _prof.bump_counter("multi_tensor_groups", len(layout))
        if unified_enabled():
            _prof.bump_unified("unified_steps")
        if slots:
            _prof.bump_unified("metric_in_trace_steps")
        exec_.outputs = [NDArray(o) for o in outs]
        exec_._tape = None
        self.last_step_ok = ok if guard else True
        self.last_grad_norm = gnorm
        self._metric_commit({n: tuple(exec_.arg_dict[n].shape)
                             for s in slots for _oi, n in s.pairs})
        return True

    # -- the sharded profile: the bridge to the updater's states ----------
    def _gather_full(self, buf: torch.Tensor) -> torch.Tensor:
        """A flat state buffer whole (its shards gathered under ZeRO-1)."""
        from .parallel import collectives as C
        from .parallel.mesh import DP
        if self._zero1 and self._n > 1:
            return C._gather_raw(buf, self._mesh, DP, 0, True)
        return buf

    def export_states(self) -> None:
        """Write the flat buffers back into the per-parameter state
        NDArrays (the checkpoint format); the buffers stay the authority.
        Under ZeRO-1 over several ranks every rank must call it together
        (the shards are gathered)."""
        if not self.sharded or self._groups is None or self._stale:
            return
        for grp, bufs in zip(self._groups, self._flat_states):
            for k in range(len(grp.slot_dtypes)):
                full = self._gather_full(bufs[k])
                for m, (size, off, shape) in enumerate(
                        zip(grp.sizes, grp.offsets, grp.shapes)):
                    grp.slot_nds[m][k]._set_data(
                        full[off:off + size].reshape(shape).clone())

    def relinquish(self) -> None:
        """Hand the state authority back to the updater's per-parameter
        states (a dense or per-parameter update is next): export, and
        import again before the next sharded step."""
        if not self.sharded:
            return
        if self._groups is not None and not self._stale:
            self.export_states()
            self._stale = True
            _prof.bump_spmd("resharding_events")

    def invalidate(self) -> None:
        """The updater's states were replaced (a checkpoint load): import
        them at the next step."""
        if self.sharded:
            self._stale = True

    def release(self) -> None:
        """Detach from the updater (the module replaces this step)."""
        if not self.sharded:
            return
        self.relinquish()
        if getattr(self._updater, "_spmd_bridge", None) is self:
            self._updater._spmd_bridge = None

    def recover_lost(self, lost):
        """Make the updater's per-parameter states the authority again
        after losing mesh positions ``lost``, without anything of the lost
        ranks.  ``"none-needed"``: they already are, or the survivors hold
        everything (stale buffers, the all-reduce baseline, a stateless
        optimizer); ``"buddy"``: the survivors gathered their shards and
        the buddy copies of the lost ones (over a fresh group of theirs)
        and merged them into the per-parameter states; False: a lost
        shard has no surviving copy (no redundancy, or its buddy holder is
        lost too), the caller restores a checkpoint.  On success the flat
        buffers are stale, so the rebuilt step imports the merged state."""
        from .parallel import distributed as _dist
        lost_set = {int(r) for r in lost}
        if not self.sharded or self._groups is None or self._stale:
            return "none-needed"
        if not self._zero1 or self._n == 1:
            self.export_states()
            self._stale = True
            _prof.bump_spmd("resharding_events")
            return "none-needed"
        if not any(grp.slot_dtypes for grp in self._groups):
            self._stale = True
            return "none-needed"
        if not self._redundancy or self._buddy_states is None:
            return False
        n = self._n
        if any((r - 1) % n in lost_set for r in lost_set):
            return False   # a lost rank's buddy holder is lost too
        survivors = [p for p in range(n) if p not in lost_set]
        ranks = [int(self._mesh.ranks.flat[p]) for p in survivors]
        group = _dist.new_group(ranks) if len(ranks) > 1 else None
        for grp, bufs, buddies in zip(self._groups, self._flat_states,
                                      self._buddy_states):
            sz = grp.shard
            for k, dt in enumerate(grp.slot_dtypes):
                mine = torch.stack([bufs[k], buddies[k]])
                parts = [mine] if group is None else [
                    t.to(self._device) for t in
                    _dist.gather_parts(mine, group, line=ranks)]
                full = torch.empty(grp.padded, dtype=dt, device=self._device)
                for p, part in zip(survivors, parts):
                    full[p * sz:(p + 1) * sz] = part[0]
                    q = (p + 1) % n
                    if q in lost_set:
                        full[q * sz:(q + 1) * sz] = part[1]
                for m, (size, off, shape) in enumerate(
                        zip(grp.sizes, grp.offsets, grp.shapes)):
                    grp.slot_nds[m][k]._set_data(
                        full[off:off + size].reshape(shape).clone())
        self._stale = True
        self._buddy_states = None
        _prof.bump_spmd("resharding_events")
        return "buddy"

    def _build_groups(self, lrs, wds) -> None:
        exec_, upd = self._exec, self._updater
        opt = upd.optimizer
        by_key: Dict[Tuple, _Group] = {}
        order: List[_Group] = []
        for pos, name in enumerate(self._train_names):
            i = self._train_idx[name]
            w = exec_.arg_dict[name]
            plan = opt._fused_plan(i, w, upd._state(i, w))
            op_name, static, st_list = plan
            key = (op_name, canonical_attrs(static), w._tdtype,
                   tuple(s._tdtype for s in st_list), lrs[pos], wds[pos])
            grp = by_key.get(key)
            if grp is None:
                grp = by_key[key] = _Group(op_name, dict(static),
                                           w._tdtype, key[3])
                order.append(grp)
            grp.add(name, pos, tuple(w.shape), st_list)
        for grp in order:
            grp.finalize(self._n)
        self._groups = order
        self._graphs.clear()

    def _refresh_slots(self) -> None:
        """Point each member at the updater's current state NDArrays (a
        checkpoint load replaces them)."""
        exec_, upd = self._exec, self._updater
        opt = upd.optimizer
        for grp in self._groups:
            for m, name in enumerate(grp.names):
                i = self._train_idx[name]
                w = exec_.arg_dict[name]
                grp.slot_nds[m] = list(opt._fused_plan(
                    i, w, upd._state(i, w))[2])

    def _import_states(self) -> None:
        """Flatten the per-parameter states into each bucket's buffer
        (this rank's block under ZeRO-1) and leave 1-element placeholders
        behind, so the state really is O(P/N) between checkpoints."""
        from .parallel.mesh import DP
        r = self._mesh.axis_index(DP)
        s = (r + 1) % self._n
        flat_states, buddy_states = [], []
        for grp in self._groups:
            bufs, buddies = [], []
            for k, dt in enumerate(grp.slot_dtypes):
                parts = [grp.slot_nds[m][k].data.reshape(-1).to(
                    self._device, dt) for m in range(len(grp.names))]
                pad = grp.padded - grp.total
                if pad:
                    parts.append(torch.zeros(pad, dtype=dt,
                                             device=self._device))
                flat = torch.cat(parts)
                if self._redundancy:
                    # the successor's shard, from step 0 on
                    buddies.append(
                        flat[s * grp.shard:(s + 1) * grp.shard].clone())
                if self._zero1:
                    flat = flat[r * grp.shard:(r + 1) * grp.shard].clone()
                bufs.append(flat)
            flat_states.append(tuple(bufs))
            buddy_states.append(tuple(buddies))
            for m in range(len(grp.names)):
                for k, dt in enumerate(grp.slot_dtypes):
                    grp.slot_nds[m][k]._set_data(
                        torch.zeros(1, dtype=dt, device=self._device))
        self._flat_states = flat_states
        self._buddy_states = buddy_states if self._redundancy else None
        self._stale = False
        self._graphs.clear()
        _prof.bump_spmd("resharding_events")
        self._record_shard_fraction()

    def _record_shard_fraction(self) -> None:
        """The optimizer state this rank holds over the logical total,
        from the live buffers."""
        local = total = 0
        for grp, bufs in zip(self._groups or [], self._flat_states):
            for b in bufs:
                local += b.numel() * b.element_size()
                total += grp.padded * b.element_size()
        # the buddy copies count toward the bytes held, not the total
        for bufs in self._buddy_states or []:
            for b in bufs:
                local += b.numel() * b.element_size()
        if total == 0:   # a stateless optimizer: the update's share
            frac = (1.0 / self._n) if self._zero1 else 1.0
        else:
            frac = local / total
        _prof.set_spmd("shard_fraction", frac)
        _prof.set_spmd("state_bytes_per_replica", float(local))
        _prof.set_spmd("state_bytes_total", float(total))

    def _fallback(self, transient: bool = True) -> bool:
        self.relinquish()
        if not transient:
            self._disabled = True
        return False

    def _local_exec(self, feeds, local_batch):
        """The executor at this rank's rows (sharing the parameters), one
        per input shape set."""
        exec_ = self._exec
        if self._n == 1:
            return exec_
        shapes = {n: (local_batch,) + tuple(a.shape)[1:]
                  for n, a in feeds.items()}
        key = (id(exec_), tuple(sorted(shapes.items())))
        hit = self._locals.get(key)
        if hit is None or hit[0] is not exec_:
            hit = self._locals[key] = (exec_, exec_.reshape(**shapes))
        return hit[1]

    def _outputs_split(self, feeds, batch) -> bool:
        """Every output's dim 0 splits with the batch: at the rows of one
        rank it is 1/N of the whole batch's, the other dims the same (a
        batch-major (B·L, V) head too), so the gather over dp in rank
        order reassembles it."""
        key = (id(self._exec._symbol),
               tuple(sorted((n, tuple(a.shape)) for n, a in feeds.items())))
        hit = self._split_ok.get(key)
        if hit is not None:
            return hit
        shapes = {n: tuple(a.shape) for n, a in self._exec.arg_dict.items()}
        shapes.update({n: tuple(a.shape) for n, a in feeds.items()})
        local = dict(shapes)
        local.update({n: (batch // self._n,) + tuple(a.shape)[1:]
                      for n, a in feeds.items()})
        try:
            _, whole, _ = self._exec._symbol.infer_shape(**shapes)
            _, part, _ = self._exec._symbol.infer_shape(**local)
            ok = all(w and p and p[0] * self._n == w[0] and p[1:] == w[1:]
                     for w, p in zip(whole, part))
        except Exception:  # noqa: BLE001 -- any failure: not splittable
            ok = False
        self._split_ok[key] = ok
        return ok

    # -- the sharded profile: the step --------------------------------------
    def _step_sharded(self, feeds) -> bool:
        from .ops.nn import batch_stats_scope
        from .parallel import collectives as C
        from .parallel import elastic_mesh as _emesh
        from .parallel.mesh import DP
        exec_, upd = self._exec, self._updater
        opt = upd.optimizer
        if self._disabled:
            return False
        if getattr(upd, "_spmd_bridge", None) is not self:
            upd._spmd_bridge = self
        ws_nd = [exec_.arg_dict[n] for n in self._train_names]
        if len({id(w) for w in ws_nd}) != len(ws_nd):
            return self._fallback()
        batches = {tuple(a.shape)[0] for a in feeds.values()
                   if tuple(getattr(a, "shape", ()))}
        if len(batches) != 1:
            return self._fallback()
        batch = batches.pop()
        if batch % self._n:
            return self._fallback()   # a ragged tail: the dense step
        if any(getattr(a, "stype", "default") != "default"
               for a in feeds.values()):
            return self._fallback()
        if not self._outputs_split(feeds, batch):
            return self._fallback(transient=False)
        for name, w in zip(self._train_names, ws_nd):
            i = self._train_idx[name]
            if opt._fused_plan(i, w, upd._state(i, w)) is None:
                return self._fallback(transient=False)
        # mesh health (MXTPU_MESH_ELASTIC): the bounded probe runs before
        # anything mutates (the update counts advance just below), so a
        # lost rank raises MeshDegradedError here with nothing applied and
        # the supervisor's retry of this batch counts it once
        if _emesh.elastic_enabled():
            _emesh.monitor_for(self._mesh).check()
            if _emesh.shrink_count():
                _prof.bump_mesh("degraded_steps")
        opt._set_current_context(exec_._ctx.device_id)
        # the update counts advance here, after every fallback check
        lrs, wds = self._host_scalars(opt)
        if self._groups is None or any(
                len({(lrs[p], wds[p]) for p in g.positions}) > 1
                for g in self._groups):
            self.relinquish()
            self._build_groups(lrs, wds)
        if self._stale:
            self._refresh_slots()
            self._import_states()

        mesh, n, zero1 = self._mesh, self._n, self._zero1
        r = mesh.axis_index(DP)
        lexec = self._local_exec(feeds, batch // n)
        lb = batch // n
        with torch.no_grad():
            for name, arr in feeds.items():
                src = arr.data if isinstance(arr, NDArray) else \
                    torch.as_tensor(arr)
                lexec.arg_dict[name].data.copy_(src[r * lb:(r + 1) * lb])
        values = [(lrs[g.positions[0]], wds[g.positions[0]])
                  for g in self._groups]
        scalars = self._scalars(values)
        rescale = float(opt.rescale_grad)
        clip = None if opt.clip_gradient is None \
            else float(opt.clip_gradient)
        guard = anomaly_guard_enabled()
        self._metric_prepare()
        slots = self._metric_plan or []
        feed = lexec._feed()
        gen = _random.generator(self._device)
        names = self._train_names
        ws = [w.data for w in ws_nd]
        aux_dict = exec_.aux_dict
        groups, flat_states = self._groups, self._flat_states
        buddy_states = self._buddy_states or []
        succ = (r + 1) % n
        reduce = C.reducer(mesh, (DP,)) if n > 1 else None

        def psum(x):
            return C._psum_raw(x, mesh, DP) if n > 1 else x

        poison = _poisoned()

        def body():
            scope = batch_stats_scope(reduce, n) if n > 1 else \
                batch_stats_scope(None, 1)
            with scope:
                outs, aux, tape = record_steps(self._plan, feed, names, gen)
                grads = tape_grads(tape, [torch.ones_like(o) for o in outs])
            gs = [grads[nm] if grads[nm] is not None else
                  torch.zeros_like(w) for nm, w in zip(names, ws)]
            if poison:
                gs = _poison(gs)
            ok = gnorm = None
            with torch.no_grad():
                gsq = torch.zeros((), dtype=torch.float32,
                                  device=self._device)
                plans, buddy_plans = [], []
                for gi, grp in enumerate(groups):
                    pad = grp.padded - grp.total
                    parts = [gs[p].reshape(-1) for p in grp.positions]
                    wparts = [ws[p].reshape(-1) for p in grp.positions]
                    if pad:
                        z = torch.zeros(pad, dtype=grp.w_dtype,
                                        device=self._device)
                        parts.append(z)
                        wparts.append(z)
                    flat_g = torch.cat(parts)
                    flat_w = torch.cat(wparts)
                    if zero1 and n > 1:
                        full_g = psum(flat_g)
                        g = C._block(full_g, mesh, DP, 0)
                        w = flat_w[r * grp.shard:(r + 1) * grp.shard]
                        w = w.clone()
                        if buddy_states:
                            # the successor's block of the same sum and of
                            # the same replicated weights: its update, bit
                            # for bit, with no traffic of its own
                            lo, hi = succ * grp.shard, (succ + 1) * grp.shard
                            buddy_plans.append((flat_w[lo:hi].clone(),
                                                full_g[lo:hi]))
                    else:
                        g, w = psum(flat_g), flat_w
                    if guard:
                        gsq = gsq + g.float().square().sum()
                    plans.append((w, g))
                if guard:
                    if zero1 and n > 1:
                        gsq = psum(gsq)
                    bad = torch.zeros((), dtype=torch.float32,
                                      device=self._device)
                    for o in outs:
                        bad = bad + (~torch.isfinite(o).all()).float()
                    ok, gnorm = guard_verdict([], gsq)
                    ok = ok & (psum(bad) == 0)
                    kept = [t for t, _ in plans] + \
                        [t for st in flat_states for t in st] + \
                        [t for st in buddy_states for t in st]
                    before = [t.clone() for t in kept]
                for gi, (grp, (w, g)) in enumerate(zip(groups, plans)):
                    lr, wd = scalars[gi]
                    apply_multi(grp.op_name, grp.static, [w], [g],
                                [[t] for t in flat_states[gi]], lr, wd,
                                rescale, clip)
                for gi, (grp, (w, g)) in enumerate(zip(groups, buddy_plans)):
                    lr, wd = scalars[gi]
                    apply_multi(grp.op_name, grp.static, [w], [g],
                                [[t] for t in buddy_states[gi]], lr, wd,
                                rescale, clip)
                if guard:
                    for t, b in zip(kept, before):
                        t.copy_(torch.where(ok, t, b))
                for grp, (w, _g) in zip(groups, plans):
                    full = C._gather_raw(w, mesh, DP, 0, True) \
                        if zero1 and n > 1 else w
                    for p, size, off in zip(grp.positions, grp.sizes,
                                            grp.offsets):
                        ws[p].view(-1).copy_(full[off:off + size])
                for nm, val in aux.items():
                    if nm in aux_dict:
                        new = val if not guard else \
                            torch.where(ok, val, aux_dict[nm].data)
                        aux_dict[nm].data.copy_(new)
                for s, inc in zip(slots, _metric_incs(slots, outs, feed)):
                    s.acc.add_(psum(inc.float()))
            return outs, ok, gnorm

        if self.captured and not poison:
            key = ("sharded", tuple(g.op_name for g in groups), rescale,
                   clip, guard, tuple((s.axis, s.pairs) for s in slots),
                   feed_key({**feed, **{f"state{j}": t for j, t in
                                        enumerate(t for st in flat_states
                                                  for t in st)}}))
            graph = self._graphs.get(key)
            if graph is None:
                res = warm_up(body, self._device)
                self._graphs[key] = CapturedGraph(body, self._device, gen)
            else:
                res = graph.replay()
        else:
            res = body()
        outs, ok, gnorm = res
        _prof.bump_counter("dispatches")
        _prof.bump_counter("spmd_steps")
        _prof.bump_spmd("spmd_steps")
        if unified_enabled():
            _prof.bump_unified("unified_steps")
        if slots:
            _prof.bump_unified("metric_in_trace_steps")
        _prof.set_spmd("replicas", float(n))
        if zero1 and n > 1:
            moved = float(sum(g.padded * torch.empty(
                (), dtype=g.w_dtype).element_size() for g in groups))
            _prof.bump_spmd("reduce_scatter_bytes", moved)
            _prof.bump_spmd("all_gather_bytes", moved)
        self._record_shard_fraction()
        if n > 1:
            outs = [C._gather_raw(o, mesh, DP, 0, True) for o in outs]
        exec_.outputs = [NDArray(o) for o in outs]
        exec_._tape = None
        lexec._tape = None
        self.last_step_ok = ok if guard else True
        self.last_grad_norm = gnorm
        self._metric_commit({nm: tuple(exec_.arg_dict[nm].shape)
                             for s in slots for _oi, nm in s.pairs})
        return True

    def audit(self):
        """Statically audit the last step (`analysis.program_audit`): no
        host-bound op in the training plan, no float64 promotion, no
        lr/wd among an update group's static hyperparameters or the
        plan's attrs (they must come from the step's device buffer), and
        every weight and optimizer state the update writes in place kept
        its storage across the step and since its capture.  Runs no
        kernel.  Returns the Finding list (empty = clean)."""
        from .analysis import program_audit as _audit
        last = self._audit_last
        if last is None:
            raise RuntimeError("audit() needs a step first -- call step() "
                               "once, then audit")
        lrs = [float(v[0]) for v in last["values"]]
        wds = [float(v[1]) for v in last["values"]]
        hazards = {"lr": lrs, "wd": wds}
        findings = _audit.audit_plan("fused_step", self._plan,
                                     feed=last["feed"],
                                     hazard_values=hazards)
        for j, (op, static, _poss) in enumerate(last["layout"]):
            for key, value in static.items():
                hit = None if isinstance(value, bool) else \
                    _audit._matches(value, _audit._hazards(hazards))
                if hit is not None:
                    findings.append(_audit.Finding(
                        "fused_step", _audit.R_RETRACE, f"groups[{j}]",
                        f"{hit[0]}={hit[1]!r} is a static hyperparameter "
                        f"{key!r} of the `{op}` update group: a new value "
                        "is a new capture", primitive=str(op),
                        extra={"label": hit[0], "value": hit[1]}))
        findings += _audit.audit_storage("fused_step", last["before"],
                                         last["after"])
        return _audit.record(findings)
