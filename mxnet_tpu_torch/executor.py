"""Executor: a Symbol bound to arrays on one device (the counterpart of
`mxnet_tpu/executor.py`; reference `include/mxnet/executor.h`).

``forward`` runs the bound graph as composed; ``compiled_forward`` runs it
through the executor's `GraphProgram` for the mode, the graph optimizer's
output (the path `Predictor` serves and `Module` trains).  With
``is_train=True`` and gradient arguments bound, the forward records an
autograd tape with those arguments as leaves; ``backward`` (or
``compiled_backward``) turns the head gradients, ones by default, into
``grad_dict`` by each argument's ``grad_req``.  A train-mode forward
writes the new values of the auxiliary states it mutates (BatchNorm's
moving statistics) into ``aux_dict``, in place.  ``make_fused_step``
builds the one-step training program of `fused_step`, and
``fused_train_step`` runs one step of it.
`set_monitor_callback` installs a callback that every forward calls
with each output's name and value (`monitor.Monitor`).  Bound arrays are
dense: a sparse array fed or bound is densified through its ``data``.

A graph that holds a denied op (`graph_compile.deny_ops`, ``Custom`` by
default) trains on the classic path: ``compiled_forward`` in train mode
runs the composed graph recorded on the tape, as the JAX package's
executor does for a program with fallback islands.  `reshape` gives an
executor at new input shapes over the same parameters, with the
reference's rules (`reshape`'s docstring).

Model parallelism (``group2ctx``, a map from ``ctx_group`` names to
contexts): each variable lives in its group's context (`group_placement`),
each op runs on its group's device, and a value crossing groups is copied
at the boundary, forward and backward; gradients land on their
variable's device.  Such an executor runs its graph eagerly, as composed,
with no rewrite and no capture.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import profiler as _prof
from . import random as _random
from .base import MXNetError
from .context import Context, default_context
from .graph_compile import (GraphCompiler, GraphProgram, Tape, backward_tape,
                            build_steps, record_steps, run_steps)
from .ndarray.ndarray import NDArray, zeros

__all__ = ["Executor", "build_graph_fn", "group_placement"]


def build_graph_fn(symbol, train: bool = False):
    """The symbol DAG as a function ``fn(feed: {name: tensor}, generator)
    -> (outputs, aux_updates)``: each op's registered function runs in
    topological order, under `torch.inference_mode`."""
    plan = build_steps(symbol)

    def fn(feed: Dict[str, torch.Tensor],
           generator: Optional[torch.Generator] = None):
        return run_steps(plan, feed, train, generator)

    return fn


_GRAD_REQS = ("null", "write", "add")


def group_placement(symbol, group2ctx) -> Dict[str, Context]:
    """The context of each variable under ``group2ctx`` (the JAX
    package's `simple_bind` rule, reference `PlaceDevice`): a variable's
    own ``ctx_group`` wins, else the group of its first consumer in
    topological order that has one; variables of neither stay in the
    executor's default context."""
    from .symbol.symbol import _topo
    var_ctx: Dict[str, Context] = {}
    if not group2ctx:
        return var_ctx
    for node in _topo(symbol._heads):
        g = node.attrs.get("ctx_group")
        if node.is_var:
            if g in group2ctx:
                var_ctx[node.name] = group2ctx[g]
            continue
        if g not in group2ctx:
            continue
        for (inp, _i) in node.inputs:
            if inp.is_var and inp.attrs.get("ctx_group") not in group2ctx:
                var_ctx.setdefault(inp.name, group2ctx[g])
    return var_ctx


class Executor:
    """Reference `include/mxnet/executor.h` surface: arg_dict, grad_dict,
    aux_dict, forward, backward, outputs."""

    def __init__(self, symbol, ctx: Optional[Context] = None, args=None,
                 args_grad=None, grad_req="write", aux_states=None,
                 group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else default_context("bind")
        self._group2ctx = dict(group2ctx) if group2ctx else None
        self._var_ctx = group_placement(symbol, self._group2ctx)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict: Dict[str, NDArray] = {
            n: self._bound(n, a)
            for n, a in _by_name(args, self.arg_names, "args").items()}
        self.aux_dict: Dict[str, NDArray] = {
            n: self._bound(n, a)
            for n, a in _by_name(aux_states, self.aux_names, "aux_states",
                                 allow_missing=True).items()}
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self.arg_names, grad_req))
        else:
            self._grad_req = {n: grad_req.get(n, "null")
                              for n in self.arg_names}
        bad = {r for r in self._grad_req.values() if r not in _GRAD_REQS}
        if bad:
            raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{sorted(bad)}")
        # a gradient buffer lives where its argument does
        self.grad_dict: Dict[str, NDArray] = {
            n: self._bound(n, g, self.arg_dict[n].context)
            for n, g in _by_name(args_grad, self.arg_names, "args_grad",
                                 allow_missing=True).items()}
        self.outputs: List[NDArray] = []
        # (optimizer, updater, train_names, step) of `fused_train_step`
        self._fused_step_cache: Optional[tuple] = None
        # mode -> {signature: program}, shared with reshaped executors
        # (`GraphCompiler`); this executor's own by mode
        self._programs: Dict[bool, Dict[tuple, GraphProgram]] = {}
        self._own_programs: Dict[bool, GraphProgram] = {}
        self._graph_plan = None
        # each plan step's device under group2ctx, else None
        self._placement = None
        self._tape: Optional[Tape] = None
        self._tape_program: Optional[GraphProgram] = None
        self._monitor = None
        # name -> the storage a shrunk argument views (`reshape`)
        self._roots: Dict[str, torch.Tensor] = {}

    def _bound(self, name, value, ctx: Optional[Context] = None) -> NDArray:
        """``value`` as the array bound for ``name``: in ``ctx``, else in
        the variable's group context, else the executor's.  Under
        ``group2ctx`` an NDArray keeps the context the caller made it
        in."""
        if ctx is None:
            ctx = self._var_ctx.get(name, self._ctx)
            if self._group2ctx and isinstance(value, NDArray):
                ctx = value.context
        return NDArray(_tensor(value).to(ctx.device), ctx)

    def _plan(self):
        """The composed graph's plan and, under ``group2ctx``, each step's
        device, built on first use."""
        if self._graph_plan is None:
            self._graph_plan = build_steps(self._symbol)
            if self._group2ctx:
                from .symbol.symbol import _topo
                self._placement = [
                    self._node_context(n).device
                    for n in _topo(self._symbol._heads) if not n.is_var]
        return self._graph_plan

    def _node_context(self, node) -> Context:
        """The context a node's values live in: its group's (a variable's
        by `group_placement`), else the executor's."""
        if node.is_var:
            return self._var_ctx.get(node.name, self._ctx)
        return (self._group2ctx or {}).get(node.attrs.get("ctx_group"),
                                           self._ctx)

    @property
    def _grad_arg_names(self) -> List[str]:
        """The arguments whose gradients this executor computes."""
        return [n for n in self.arg_names
                if self._grad_req.get(n, "null") != "null"
                and n in self.grad_dict]

    @property
    def grad_arrays(self) -> List[Optional[NDArray]]:
        return [self.grad_dict.get(n) for n in self.arg_names]

    @property
    def arg_arrays(self) -> List[NDArray]:
        return [self.arg_dict[n] for n in self.arg_names]

    @property
    def aux_arrays(self) -> List[NDArray]:
        return [self.aux_dict[n] for n in self.aux_names]

    def _ingest_inputs(self, kwargs):
        """Copy forward kwargs into the bound arrays, in place (device and
        dtype stay those of the bind)."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown input {k!r}")
            self.arg_dict[k].data.copy_(_tensor(v))

    def _feed(self) -> Dict[str, torch.Tensor]:
        feed = {n: a.data for n, a in self.arg_dict.items()}
        feed.update({n: a.data for n, a in self.aux_dict.items()})
        return feed

    def _write_aux(self, aux: Dict[str, torch.Tensor]) -> None:
        """The mutated auxiliary states' new values, copied in place."""
        with torch.no_grad():
            for name, val in aux.items():
                if name in self.aux_dict:
                    self.aux_dict[name].data.copy_(val)

    def _record(self, program: Optional[GraphProgram], names):
        """A train-mode forward of the composed graph (``program`` None)
        or of the training program, recorded for backward."""
        gen = _random.generator(self._ctx.device)
        if program is None:
            return record_steps(self._plan(), self._feed(), names, gen,
                                self._placement)
        if not program.train:
            program = self.graph_program(True)
        _prof.bump_counter("dispatches")
        return program.forward_train(self._feed(), names, gen)

    def _run(self, program: Optional[GraphProgram],
             is_train: bool) -> List[NDArray]:
        self._tape_program = program
        names = self._grad_arg_names if is_train else []
        if names:
            outs, aux, self._tape = self._record(program, names)
        else:
            feed, gen = self._feed(), _random.generator(self._ctx.device)
            outs, aux = run_steps(self._plan(), feed, is_train, gen,
                                  self._placement) \
                if program is None else program.forward(feed, gen)
            self._tape = None
        if is_train:
            self._write_aux(aux)
        self.outputs = [NDArray(o, self._node_context(node))
                        for o, (node, _i) in zip(outs, self._symbol._heads)]
        if self._monitor is not None:
            for name, arr in zip(self.output_names, self.outputs):
                self._monitor(name, arr)
        return self.outputs

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` for each output after every
        forward (reference `Executor.set_monitor_callback`); as in the
        JAX package, the outputs are what it sees, with or without
        ``monitor_all``."""
        self._monitor = callback

    def forward(self, is_train=False, **kwargs) -> List[NDArray]:
        """Run the graph as composed (no rewrites)."""
        self._ingest_inputs(kwargs)
        self._plan()
        _prof.bump_counter("dispatches")
        return self._run(None, bool(is_train))

    def graph_program(self, train=False) -> GraphProgram:
        """This executor's `GraphProgram` for ``train`` mode, built on
        first use from the bound shapes and device."""
        return GraphCompiler.program_for(self, train)

    def compiled_forward(self, is_train=False, **kwargs) -> List[NDArray]:
        """Forward through the optimized `GraphProgram` of the mode; a
        training forward over a graph with fallback islands, and any
        forward under ``group2ctx``, runs the composed graph instead
        (`forward`)."""
        if self._group2ctx:
            return self.forward(is_train=is_train, **kwargs)
        program = self.graph_program(is_train)
        if is_train and program.has_islands:
            return self.forward(is_train=True, **kwargs)
        self._ingest_inputs(kwargs)
        return self._run(program, bool(is_train))

    def backward(self, out_grads=None) -> List[Optional[NDArray]]:
        """Reference `Executor::Backward`: head gradients default to ones
        (a loss head such as SoftmaxOutput ignores them).  After a forward
        that recorded no tape (``is_train=False``, or a backward already
        taken), the forward runs again in train mode, as the reference's
        backward recomputes it."""
        if not self.outputs:
            raise MXNetError("backward called before forward")
        names = self._grad_arg_names
        if not names:
            return self.grad_arrays
        if self._tape is None:
            _, _, self._tape = self._record(self._tape_program, names)
        if out_grads is None:
            cts = [torch.ones_like(o.data) for o in self.outputs]
        else:
            if isinstance(out_grads, (NDArray, np.ndarray, torch.Tensor)):
                out_grads = [out_grads]
            cts = [_tensor(g) for g in out_grads]
        tape, self._tape = self._tape, None
        _prof.bump_counter("dispatches")
        backward_tape(tape, cts, self._grad_req,
                      {n: self.grad_dict[n].data for n in names})
        return self.grad_arrays

    def compiled_backward(self, out_grads=None) -> List[Optional[NDArray]]:
        """Backward of the last `compiled_forward` (the same tape walk as
        `backward`; the training program built no other)."""
        return self.backward(out_grads)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs) -> "Executor":
        """A new executor over the same parameters at new input shapes
        (reference `GraphExecutor::Reshape`): an array whose shape stays
        is shared; a shrunk one is a write-through view of the first
        elements of its *root* storage (the buffer of the executor it was
        first bound in), so shrinking and growing back reuses the
        original storage; a larger one needs ``allow_up_sizing`` and is
        new zeros; an argument not named in ``kwargs`` may change shape
        only with ``partial_shaping``.  Gradients are reallocated, the
        monitor carries over and the program cache is shared."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        roots: Dict[str, torch.Tensor] = {}

        def remap(name, cur, shape):
            if tuple(cur.shape) == tuple(shape):
                if name in self._roots:
                    roots[name] = self._roots[name]
                return cur
            if not (partial_shaping or name in kwargs):
                raise MXNetError(
                    f"Shape of unspecified array arg:{name} changed. This "
                    "can cause the new executor to not share parameters "
                    "with the old one. Please check for error in network. "
                    "If this is intended, set partial_shaping=True to "
                    "suppress this warning.")
            root = self._roots.get(name, cur.data)
            n = int(np.prod(shape))
            if n <= root.numel():
                roots[name] = root
                return NDArray(root.view(-1)[:n].view(tuple(shape)),
                               cur.context)
            if not allow_up_sizing:
                raise MXNetError(
                    f"New shape of arg:{name} larger than original. First "
                    "making a big executor then down sizing it is more "
                    "efficient than the reverse. If you really want to "
                    "up size, set allow_up_sizing=True to enable "
                    "allocation of new arrays.")
            return NDArray(torch.zeros(tuple(shape), dtype=cur._tdtype,
                                       device=cur.data.device), cur.context)

        args = {n: remap(n, self.arg_dict[n], s)
                for n, s in zip(self.arg_names, arg_shapes)}
        aux = {n: remap(n, self.aux_dict[n], s)
               for n, s in zip(self.aux_names, aux_shapes)
               if n in self.aux_dict}
        grads = {n: zeros(args[n].shape, ctx=args[n].context,
                          dtype=args[n]._tdtype)
                 for n in self.grad_dict}
        new = Executor(self._symbol, self._ctx, args=args, args_grad=grads,
                       grad_req=dict(self._grad_req), aux_states=aux,
                       group2ctx=self._group2ctx)
        # the same arrays, not new handles over their tensors
        new.arg_dict.update(args)
        new.aux_dict.update(aux)
        new._roots = roots
        new._monitor = self._monitor
        new._programs = self._programs
        return new

    def make_fused_step(self, optimizer, updater, train_names):
        """The whole training step of this executor (forward, backward,
        the multi-tensor update) as one program (`fused_step`)."""
        from .fused_step import FusedTrainStep
        return FusedTrainStep(self, optimizer, updater, train_names)

    def fused_train_step(self, optimizer, updater, feed, train_names=None):
        """One training step over ``feed`` (data and label arrays by
        argument name) through `make_fused_step`'s program, kept for the
        next call with the same optimizer, updater and ``train_names``
        (default: every argument with a gradient that ``feed`` does not
        hold).  Returns the outputs; raises `MXNetError` where the step
        declines (an optimizer without a multi-tensor plan): `Module` and
        `gluon.Trainer` fall back by themselves."""
        if train_names is None:
            train_names = [n for n in self._grad_arg_names if n not in feed]
        cached = self._fused_step_cache
        if cached is None or cached[0] is not optimizer or \
                cached[1] is not updater or cached[2] != tuple(train_names):
            cached = (optimizer, updater, tuple(train_names),
                      self.make_fused_step(optimizer, updater, train_names))
            self._fused_step_cache = cached
        if not cached[3].step(feed):
            raise MXNetError(
                f"fused_train_step: no fused plan for "
                f"{type(optimizer).__name__}")
        return self.outputs

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False) -> None:
        """Copy parameters into the bound arrays, in place (reference
        `executor.py:copy_params_from`)."""
        for src, dst, what in ((arg_params, self.arg_dict, "argument"),
                               (aux_params or {}, self.aux_dict, "aux")):
            for name, arr in src.items():
                if name in dst:
                    with torch.no_grad():
                        dst[name].data.copy_(_tensor(arr))
                elif not allow_extra_params:
                    raise MXNetError(f"copy_params_from: no {what} "
                                     f"{name!r} in the executor")

    def __repr__(self):
        return (f"<Executor outputs={self.output_names} "
                f"args={len(self.arg_names)} ctx={self._ctx}>")


def _by_name(values, names, what, allow_missing=False) -> Dict:
    """``values`` (a dict, or a list in ``names`` order) as a dict over
    ``names``."""
    if values is None:
        values = {}
    elif isinstance(values, (list, tuple)):
        values = dict(zip(names, values))
    if not allow_missing:
        missing = [n for n in names if n not in values]
        if missing:
            raise MXNetError(f"executor: {what} missing entries {missing}")
    return {n: values[n] for n in names if n in values}


def _tensor(v) -> torch.Tensor:
    if isinstance(v, NDArray):
        return v.data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))
