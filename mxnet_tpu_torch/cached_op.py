"""CachedOp: the program ``hybridize()`` runs a Block's forward through (the
counterpart of `mxnet_tpu/cached_op.py`; reference
`src/imperative/cached_op.cc`).

The JAX package compiles one jitted program per (train mode, input
signature), and under `autograd.record` adds one tape node whose vjp is
the whole compiled backward.  Here, on a CUDA device:

* a predict-mode forward is captured as a CUDA graph once per input
  signature (the structure, shapes, dtypes and devices of the inputs, and
  the addresses, shapes and dtypes of the parameters) and replayed: the
  inputs are copied into the graph's static input tensors, and every call
  hands back outputs of its own;
* a forward under `autograd.record` in train mode is captured as two CUDA
  graphs per signature (which inputs require gradients is part of it): the
  forward, with torch's autograd recording inside the capture, and its
  backward (`torch.autograd.grad` of the outputs with respect to the
  inputs and parameters that require gradients), in one memory pool.  A
  call replays the forward and records one node on torch's tape (a
  `torch.autograd.Function`) whose backward replays the second graph.
  BatchNorm's moving statistics are written in place inside the forward
  graph; Dropout draws from the device's generator, registered with the
  capture, so each replay draws new masks.  While a call's backward is
  still to come, the next call of the signature captures a program of its
  own (a replay would overwrite the saved activations), up to
  `MAX_TRAIN_PROGRAMS` per signature; past that a call runs eagerly, so
  the pools kept stay bounded.  A backward after its program has run
  again raises, and so does a ``create_graph`` backward through a replay
  (the JAX package raises for its CachedOp node too).  Programs captured
  over parameter tensors the block no longer holds (``reset_ctx``,
  ``cast``, a ``set_data`` of another shape) are dropped.

The first call of a signature runs eagerly on a side stream
(`graph_compile.warm_up`, so cuDNN and cuBLAS set up outside a capture);
in predict mode the capture follows at once, in training at the next call
(after the warm-up's backward has run).  A forward in train mode outside
`record`, in predict mode under `record`, with nothing to differentiate,
on the CPU or with ``MXTPU_GRAPH_COMPILE=0`` runs eagerly under torch's
autograd.  A capture that fails raises.

A block whose imperative forward reads the host (`nd.contrib.cond`'s
predicate, `nd.contrib.while_loop`'s condition, a Python `Custom` op: each
calls `note_host_op`, seen during the settling forward below) is not
captured whole.  Its predict-mode calls on the card run the block's traced
graph (``F = sym``) through a `graph_compile.GraphProgram` over the
parameters, one per input signature, fed from static input tensors the
call's inputs are copied into (so the program's captures stay one per
signature): one CUDA graph where every op can be captured (a symbolic
``while_loop`` can), else the island plan, with the ``Custom`` and
``_cond`` nodes run eagerly between captured islands.  Its recorded
training calls run eagerly.

Before the first call, one predict-mode forward settles deferred
initialization without moving BatchNorm's statistics.  While a CachedOp
runs its block, hybridized children inline into it (`is_tracing`).  A
predict-mode forward draws no random numbers, so a deterministic net
consumes nothing of the random stream, hybridized or not.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import autograd
from . import random as _random
from .base import MXNetError
from .graph_compile import CapturedGraph, graph_compile_enabled, warm_up
from .ndarray.ndarray import NDArray

__all__ = ["CachedOp", "is_tracing", "tracing_scope"]

# captured training programs kept per input signature: each holds a pool
# with one call's saved activations
MAX_TRAIN_PROGRAMS = 2


class _TraceState(threading.local):
    def __init__(self):
        super().__init__()
        self.active = False
        # the host-reading ops a settling forward met, while one runs
        self.host_ops = None


_TRACE = _TraceState()


def note_host_op(name: str) -> None:
    """Called by an imperative op that reads the host: a CachedOp
    settling its block then runs it as a graph (the module docstring)."""
    if _TRACE.host_ops is not None:
        _TRACE.host_ops.add(name)


def is_tracing() -> bool:
    """True while a CachedOp or the Symbol tracer runs block code: nested
    hybridized children then run inline."""
    return _TRACE.active


class tracing_scope:
    def __enter__(self):
        self._old = _TRACE.active
        _TRACE.active = True
        return self

    def __exit__(self, *exc):
        _TRACE.active = self._old


def _flatten(obj) -> Tuple[List[Any], Callable]:
    """The leaves of nested lists and tuples, and the function that puts
    new leaves back in the same structure."""
    if isinstance(obj, (list, tuple)):
        parts = [_flatten(o) for o in obj]
        leaves = [x for p in parts for x in p[0]]
        sizes = [len(p[0]) for p in parts]
        kind = type(obj)

        def rebuild(vals, _parts=parts, _sizes=sizes, _kind=kind):
            out, i = [], 0
            for (_, r), n in zip(_parts, _sizes):
                out.append(r(vals[i:i + n]))
                i += n
            return _kind(out)
        return leaves, rebuild
    return [obj], lambda vals: vals[0]


def _captures(device) -> bool:
    """Whether calls on ``device`` are captured: a CUDA device, with
    ``MXTPU_GRAPH_COMPILE`` on."""
    return device is not None and device.type == "cuda" and \
        graph_compile_enabled()


def _leaf_key(x):
    if isinstance(x, NDArray):
        t = x.data
        return ("nd", tuple(t.shape), t.dtype, t.device)
    return ("py", repr(x))


class _Program:
    """One captured forward: its static inputs, graph and output
    structure."""

    def __init__(self, static: List[Optional[torch.Tensor]],
                 graph: CapturedGraph, rebuild_out: Callable):
        self.static = static
        self.graph = graph
        self.rebuild_out = rebuild_out


class _Call:
    """What one training replay leaves for its backward: the program's
    run it belongs to, and whether a backward has read it."""
    __slots__ = ("run", "done", "__weakref__")

    def __init__(self, run: int):
        self.run = run
        self.done = False


class _TrainProgram:
    """A recorded train-mode forward and its backward, captured as two
    CUDA graphs over one memory pool.  The capture reads the parameters
    through aliases (new leaves over the same memory), so the captured
    autograd graph holds none of the parameters' own gradient
    accumulators: those belong to the caller's tape, which may be alive
    during a capture on another stream (a recorded call still pending, a
    loss kept from the step before)."""

    def __init__(self, cached_op, leaves, rebuild, param_nds, device):
        self.static = [
            x.data.detach().clone().requires_grad_(x.data.requires_grad)
            if isinstance(x, NDArray) else None for x in leaves]
        call_args = rebuild([NDArray(s) if s is not None else x
                             for s, x in zip(self.static, leaves)])
        params = [d.data for d in param_nds]
        alias = [p.detach().requires_grad_(p.requires_grad) for p in params]
        diff_in = [s for s in self.static
                   if s is not None and s.requires_grad] + \
            [a for a in alias if a.requires_grad]
        structure = {}

        def forward():
            for d, a in zip(param_nds, alias):
                d.data = a
            try:
                out_leaves, rebuild_out = _flatten(
                    cached_op._forward(call_args))
            finally:
                for d, p in zip(param_nds, params):
                    d.data = p
            structure["rebuild"] = rebuild_out
            return [o.data for o in out_leaves]

        pool = torch.cuda.graph_pool_handle()
        self.fwd = CapturedGraph(forward, device,
                                 _random.generator(device), pool)
        outs = self.fwd.outputs
        self.rebuild_out = structure["rebuild"]
        self.diff_out = [i for i, o in enumerate(outs) if o.requires_grad]
        self.grad_out = [torch.empty_like(outs[i]) for i in self.diff_out]

        def backward():
            return torch.autograd.grad([outs[i] for i in self.diff_out],
                                       diff_in, grad_outputs=self.grad_out,
                                       allow_unused=True)

        self.bwd = CapturedGraph(backward, device, pool=pool)
        self.fwd.outputs = [o.detach() for o in outs]
        self.runs = 0
        self.pending = None

    @property
    def busy(self) -> bool:
        """Whether a replay's backward is still to come."""
        call = self.pending() if self.pending is not None else None
        return call is not None and not call.done

    def __call__(self, leaves, params):
        diff = [x.data for x in leaves
                if isinstance(x, NDArray) and x.data.requires_grad] + \
            [p for p in params if p.requires_grad]
        with torch.no_grad():
            for s, x in zip(self.static, leaves):
                if s is not None:
                    s.copy_(x.data)
        outs = _Replay.apply(self, *diff)
        return self.rebuild_out([NDArray(o) for o in outs])


class _Replay(torch.autograd.Function):
    """One training replay as one node of torch's tape."""

    @staticmethod
    def forward(ctx, prog, *diff):
        outs = [o.clone() for o in prog.fwd.replay()]
        prog.runs += 1
        ctx.prog = prog
        ctx.call = _Call(prog.runs)
        prog.pending = weakref.ref(ctx.call)
        ctx.mark_non_differentiable(*[o for i, o in enumerate(outs)
                                      if i not in prog.diff_out])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            raise MXNetError(
                "create_graph=True: a captured CachedOp graph is not "
                "supported for higher-order gradients (set "
                "MXTPU_GRAPH_COMPILE=0 to differentiate it eagerly)")
        prog = ctx.prog
        if ctx.call.run != prog.runs:
            raise MXNetError(
                "CachedOp: this recorded call's captured forward has run "
                "again since; backward through it once, before the next "
                "call (or set MXTPU_GRAPH_COMPILE=0)")
        with torch.no_grad():
            for buf, i in zip(prog.grad_out, prog.diff_out):
                buf.copy_(grads[i])
        gs = prog.bwd.replay()
        ctx.call.done = True
        return (None,) + tuple(g.clone() if g is not None else None
                               for g in gs)


class CachedOp:
    """One captured forward per input signature of a hybridized block, and
    one captured forward and backward per signature of a recorded
    train-mode call."""

    def __init__(self, block):
        self.block = block
        self._params = None
        self._programs: Dict[Tuple, _Program] = {}
        self._train_programs: Dict[Tuple, List[_TrainProgram]] = {}
        self._addrs: Optional[Tuple[int, ...]] = None
        #: the host-reading ops of the block's imperative forward
        self.host_ops = frozenset()
        # input signature -> (GraphProgram, its static feed, output count)
        self._graph_programs: Dict[Tuple, Tuple[Any, Dict, int]] = {}

    @property
    def num_programs(self) -> int:
        return len(self._programs)

    @property
    def num_train_programs(self) -> int:
        return sum(len(v) for v in self._train_programs.values())

    def _settle_init(self, args):
        """One eager predict-mode forward to finish deferred
        initialization (reference `_deferred_infer_shape`); the user's
        forward hooks do not see it."""
        _TRACE.host_ops = set()
        try:
            with autograd.pause(train_mode=False), tracing_scope():
                self.block.forward(*args)
        finally:
            self.host_ops = frozenset(_TRACE.host_ops)
            _TRACE.host_ops = None
        self._params = [p for _, p in
                        sorted(self.block.collect_params().items())]

    def _forward(self, args):
        with tracing_scope():
            return self.block.forward(*args)

    def _drop_stale(self, params: List[torch.Tensor]):
        """Drop every program when the block's parameter tensors are no
        longer those the programs were captured over (a pending replay
        keeps its own program until its backward)."""
        addrs = tuple(p.data_ptr() for p in params)
        if addrs != self._addrs:
            self._addrs = addrs
            self._programs.clear()
            self._train_programs.clear()
            self._graph_programs.clear()

    def __call__(self, *args):
        if self._params is None:
            self._settle_init(args)
        leaves, rebuild = _flatten(list(args))
        nds = [x for x in leaves if isinstance(x, NDArray)]
        device = nds[0].data.device if nds else None
        if not _captures(device):
            return self._forward(args)
        if autograd.is_recording() or autograd.is_training():
            if self.host_ops or not (autograd.is_recording()
                                     and autograd.is_training()):
                return self._forward(args)
            return self._train_call(args, leaves, rebuild, device)
        if self.host_ops and all(isinstance(x, NDArray) for x in args):
            return self._graph_call(args, device)
        self._drop_stale([d.data for p in self._params
                          for d in p.list_data()])
        key = (tuple(_leaf_key(x) for x in leaves),
               tuple((d.data.data_ptr(), tuple(d.shape), d.dtype)
                     for p in self._params for d in p.list_data()))
        prog = self._programs.get(key)
        if prog is None:
            return self._capture(key, leaves, rebuild, device)
        with torch.no_grad():
            for s, x in zip(prog.static, leaves):
                if s is not None:
                    s.copy_(x.data)
        outs = prog.graph.replay()
        return prog.rebuild_out([NDArray(o.clone()) for o in outs])

    def _graph_call(self, args, device):
        """A predict-mode call of a host-reading block: its traced graph
        run by a `GraphProgram` per input signature (captured whole, or
        as islands around the uncapturable nodes), fed from static
        inputs."""
        from .graph_compile import GraphProgram
        from .symbol.tracer import trace_block
        self._drop_stale([d.data for p in self._params
                          for d in p.list_data()])
        params = {p.name: p.data(args[0].context).data
                  for p in self._params}
        key = tuple(_leaf_key(x) for x in args)
        entry = self._graph_programs.get(key)
        if entry is None:
            names = [f"data{i}" for i in range(len(args))]
            with tracing_scope():
                sym, _ = trace_block(self.block, names)
            feed = {n: a.data.detach().clone() for n, a in zip(names, args)}
            feed.update(params)
            prog = GraphProgram(sym, False,
                                {n: t.shape for n, t in feed.items()},
                                device, {n: t.dtype for n, t in
                                         feed.items()})
            entry = self._graph_programs[key] = (prog, feed,
                                                 len(sym.list_outputs()))
        prog, feed, n_out = entry
        with torch.no_grad():
            for i, a in enumerate(args):
                feed[f"data{i}"].copy_(a.data)
            outs, _ = prog.forward(feed)
        res = [NDArray(o) for o in outs]
        return res[0] if n_out == 1 else res

    def _train_call(self, args, leaves, rebuild, device):
        param_nds = [d for p in self._params for d in p.list_data()]
        params = [d.data for d in param_nds]
        if not any(p.requires_grad for p in params) and not any(
                isinstance(x, NDArray) and x.data.requires_grad
                for x in leaves):
            return self._forward(args)
        self._drop_stale(params)
        key = (tuple(_leaf_key(x) + ((x.data.requires_grad,)
                                     if isinstance(x, NDArray) else ())
                     for x in leaves),
               tuple((p.data_ptr(), tuple(p.shape), p.dtype,
                      p.requires_grad) for p in params))
        progs = self._train_programs.get(key)
        if progs is None:
            self._train_programs[key] = []

            def run():
                out_leaves, rebuild_out = _flatten(self._forward(args))
                return [o.data for o in out_leaves], rebuild_out
            outs, rebuild_out = warm_up(run, device)
            return rebuild_out([NDArray(o) for o in outs])
        prog = next((p for p in progs if not p.busy), None)
        if prog is None:
            if len(progs) >= MAX_TRAIN_PROGRAMS:
                return self._forward(args)
            prog = _TrainProgram(self, leaves, rebuild, param_nds, device)
            progs.append(prog)
        return prog(leaves, params)

    def _capture(self, key, leaves, rebuild, device):
        static = [x.data.detach().clone() if isinstance(x, NDArray)
                  else None for x in leaves]
        call_args = rebuild([NDArray(s) if s is not None else x
                             for s, x in zip(static, leaves)])
        structure = {}

        def run():
            out_leaves, rebuild_out = _flatten(self._forward(call_args))
            structure["rebuild"] = rebuild_out
            return [o.data for o in out_leaves]

        outs = warm_up(run, device)
        graph = CapturedGraph(run, device)
        self._programs[key] = _Program(static, graph, structure["rebuild"])
        return structure["rebuild"]([NDArray(o) for o in outs])
