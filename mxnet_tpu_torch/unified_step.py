"""The training step as one program (the counterpart of the dense profile
of `mxnet_tpu/unified_step.py`; its sharded profile, `ShardingSpec`, waits
for `parallel/`).

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

Switches, under the JAX package's names: ``MXTPU_UNIFIED_STEP`` (the
training pass list, and fit's in-step metric), ``MXTPU_UNIFIED_METRIC``
(the metric alone), ``MXTPU_ANOMALY_GUARD`` (the device-side skip of a
non-finite step: the weights, optimizer states and aux states keep their
pre-step values, decided on the device with no host read).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

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
           "UnifiedTrainStep"]


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

    def __init__(self, executor, optimizer, updater, train_names):
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

    @property
    def captured(self) -> bool:
        """Whether steps run as CUDA graphs."""
        return self._device.type == "cuda" and graph_compile_enabled()

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
        ``update``)."""
        exec_, upd = self._exec, self._updater
        opt = upd.optimizer
        self.metric_in_trace = False
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

        def body():
            outs, aux, tape = record_steps(self._plan, feed, names, gen)
            grads = tape_grads(tape, [torch.ones_like(o) for o in outs])
            gs = [grads[n] if grads[n] is not None else torch.zeros_like(w)
                  for n, w in zip(names, ws)]
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
        if self.captured:
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
