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
builds the one-step training program of `fused_step`.
`set_monitor_callback` installs a callback that every forward calls
with each output's name and value (`monitor.Monitor`).  Bound arrays are
dense: a sparse array fed or bound is densified through its ``data``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .context import Context, default_context
from .graph_compile import (GraphCompiler, GraphProgram, Tape, backward_tape,
                            build_steps, record_steps, run_steps)
from .ndarray.ndarray import NDArray

__all__ = ["Executor", "build_graph_fn"]


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


class Executor:
    """Reference `include/mxnet/executor.h` surface: arg_dict, grad_dict,
    aux_dict, forward, backward, outputs."""

    def __init__(self, symbol, ctx: Optional[Context] = None, args=None,
                 args_grad=None, grad_req="write", aux_states=None):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else default_context("bind")
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        device = self._ctx.device
        self.arg_dict: Dict[str, NDArray] = {
            n: NDArray(_tensor(a).to(device))
            for n, a in _by_name(args, self.arg_names, "args").items()}
        self.aux_dict: Dict[str, NDArray] = {
            n: NDArray(_tensor(a).to(device))
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
            n: NDArray(_tensor(g).to(device))
            for n, g in _by_name(args_grad, self.arg_names, "args_grad",
                                 allow_missing=True).items()}
        self.outputs: List[NDArray] = []
        self._programs: Dict[bool, GraphProgram] = {}
        self._graph_plan = None
        self._tape: Optional[Tape] = None
        self._tape_program: Optional[GraphProgram] = None
        self._monitor = None

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
            return record_steps(self._graph_plan, self._feed(), names, gen)
        if not program.train:
            program = self.graph_program(True)
        return program.forward_train(self._feed(), names, gen)

    def _run(self, program: Optional[GraphProgram],
             is_train: bool) -> List[NDArray]:
        self._tape_program = program
        names = self._grad_arg_names if is_train else []
        if names:
            outs, aux, self._tape = self._record(program, names)
        else:
            feed, gen = self._feed(), _random.generator(self._ctx.device)
            outs, aux = run_steps(self._graph_plan, feed, is_train, gen) \
                if program is None else program.forward(feed, gen)
            self._tape = None
        if is_train:
            self._write_aux(aux)
        self.outputs = [NDArray(o) for o in outs]
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
        if self._graph_plan is None:
            self._graph_plan = build_steps(self._symbol)
        return self._run(None, bool(is_train))

    def graph_program(self, train=False) -> GraphProgram:
        """This executor's `GraphProgram` for ``train`` mode, built on
        first use from the bound shapes and device."""
        return GraphCompiler.program_for(self, train)

    def compiled_forward(self, is_train=False, **kwargs) -> List[NDArray]:
        """Forward through the optimized `GraphProgram` of the mode."""
        program = self.graph_program(is_train)
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
        backward_tape(tape, cts, self._grad_req,
                      {n: self.grad_dict[n].data for n in names})
        return self.grad_arrays

    def compiled_backward(self, out_grads=None) -> List[Optional[NDArray]]:
        """Backward of the last `compiled_forward` (the same tape walk as
        `backward`; the training program built no other)."""
        return self.backward(out_grads)

    def make_fused_step(self, optimizer, updater, train_names):
        """The whole training step of this executor (forward, backward,
        the multi-tensor update) as one program (`fused_step`)."""
        from .fused_step import FusedTrainStep
        return FusedTrainStep(self, optimizer, updater, train_names)

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
