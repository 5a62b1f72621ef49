"""GraphProgram: the one program a bound graph runs in one mode (the
counterpart of `mxnet_tpu/graph_compile.py`).

At build it runs `graph_opt.optimize` over the symbol once, with the
inference pass list or, for ``train=True``, the training list (which never
swaps kernels in), and plans the optimized graph into a flat list of
steps.  An inference ``forward`` runs the steps eagerly in topological
order under `torch.inference_mode`.  A training program's
``forward_train`` runs them in train mode (Dropout draws masks) with
autograd on and the gradient arguments as leaves, and returns a `Tape`;
`backward_tape` turns the tape and the head gradients into the gradient
arguments' gradients, with ``grad_req='add'`` folded in.  Capturing the
steps as a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from . import graph_opt
from .attribute import strip_annotations
from .base import MXNetError
from .ops import registry as _reg
from .ops.registry import Attrs
from .symbol.symbol import _entry_key, _topo, _value_key

__all__ = ["GraphProgram", "GraphCompiler", "Tape", "build_steps",
           "run_steps", "record_steps", "backward_tape"]


def build_steps(symbol):
    """Plan ``symbol`` for execution: ``(var_names, steps, head_keys)``
    where each step is ``(op, attrs, input keys, output keys)``."""
    nodes = _topo(symbol._heads)
    steps = []
    for node in nodes:
        if node.is_var:
            continue
        attrs = Attrs(strip_annotations(node.attrs))
        op = _reg.get_op(node.op)
        steps.append((op, attrs, [_value_key(e) for e in node.inputs],
                      [_entry_key((node, i))
                       for i in range(op.num_outputs(attrs))]))
    return ([n.name for n in nodes if n.is_var], steps,
            [_value_key(e) for e in symbol._heads])


def _run(plan, feed, train, generator) -> List[torch.Tensor]:
    var_names, steps, head_keys = plan
    vals: Dict[str, torch.Tensor] = {}
    for name in var_names:
        try:
            vals[name] = feed[name]
        except KeyError:
            raise MXNetError(f"executor: missing input {name!r}") from None
    for op, attrs, in_keys, out_keys in steps:
        if op.uses_train_mode:
            attrs = Attrs(attrs, __train=train)
        ins = [vals[k] for k in in_keys]
        out = op.fn(attrs, generator, *ins) if op.needs_rng else \
            op.fn(attrs, *ins)
        outs = out if isinstance(out, tuple) else (out,)
        for k, o in zip(out_keys, outs):
            vals[k] = o
    return [vals[k] for k in head_keys]


def run_steps(plan, feed: Mapping[str, torch.Tensor], train: bool = False,
              generator: Optional[torch.Generator] = None
              ) -> List[torch.Tensor]:
    """Run a `build_steps` plan on ``feed`` {variable name -> tensor}
    under `torch.inference_mode`; ``train`` switches the train-mode ops
    (Dropout draws from ``generator``)."""
    with torch.inference_mode():
        return _run(plan, feed, train, generator)


class Tape:
    """What a recorded forward keeps for its backward: the leaves it
    differentiates, by name, and the outputs autograd recorded."""
    __slots__ = ("leaves", "outputs")

    def __init__(self, leaves: Dict[str, torch.Tensor],
                 outputs: List[torch.Tensor]):
        self.leaves = leaves
        self.outputs = outputs


def record_steps(plan, feed: Mapping[str, torch.Tensor],
                 grad_names: Sequence[str], generator: torch.Generator
                 ) -> Tuple[List[torch.Tensor], Tape]:
    """Run a plan in train mode with autograd recording, the
    ``grad_names`` inputs as leaves (views of the bound tensors, so an
    in-place write to one between forward and backward is caught by
    autograd).  Returns the outputs, detached, and the tape."""
    leaves = {n: feed[n].detach().requires_grad_(True) for n in grad_names}
    with torch.enable_grad():
        outs = _run(plan, {**feed, **leaves}, True, generator)
    return [o.detach() for o in outs], Tape(leaves, outs)


def backward_tape(tape: Tape, head_grads: Sequence[torch.Tensor],
                  grad_req: Mapping[str, str],
                  grad_dict: Mapping[str, torch.Tensor]) -> None:
    """Backpropagate ``head_grads`` through a tape and write each leaf's
    gradient into ``grad_dict`` by its ``grad_req``: 'write' copies,
    'add' accumulates.  A leaf no output depends on gets zeros, as JAX's
    vjp gives.  The tape's graph is freed."""
    outs, cts = [], []
    for o, g in zip(tape.outputs, head_grads):
        if o.requires_grad:
            outs.append(o)
            cts.append(g.to(device=o.device, dtype=o.dtype))
    names = list(tape.leaves)
    grads = torch.autograd.grad(outs, [tape.leaves[n] for n in names],
                                grad_outputs=cts, allow_unused=True) \
        if outs else [None] * len(names)
    with torch.no_grad():
        for name, g in zip(names, grads):
            dst = grad_dict[name]
            if g is None:
                if grad_req[name] != "add":
                    dst.zero_()
            elif grad_req[name] == "add":
                dst.add_(g.to(dst.dtype))
            else:
                dst.copy_(g)
    tape.outputs = []


class GraphProgram:
    """The program for one bound graph in one mode."""

    def __init__(self, symbol, train: bool = False,
                 input_shapes: Optional[Dict[str, Tuple]] = None,
                 device: Optional[torch.device] = None,
                 input_dtypes: Optional[Dict[str, torch.dtype]] = None):
        self.train = bool(train)
        opt = graph_opt.optimize(symbol, shapes=input_shapes, device=device,
                                 train=self.train, dtypes=input_dtypes)
        if self.train and opt.symbol is not symbol:
            graph_opt._check_train_invariants(symbol, opt.symbol)
        self._run_symbol = opt.symbol
        self.opt_reports = list(opt.reports)
        self._plan = build_steps(self._run_symbol)

    def forward(self, feed: Mapping[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """The optimized graph's outputs for ``feed``, nothing recorded
        (in train mode, Dropout still draws masks)."""
        return run_steps(self._plan, feed, self.train, generator)

    def forward_train(self, feed: Mapping[str, torch.Tensor],
                      grad_names: Sequence[str],
                      generator: torch.Generator
                      ) -> Tuple[List[torch.Tensor], Tape]:
        """A train-mode forward recorded for `backward_tape`."""
        if not self.train:
            raise MXNetError("GraphProgram: an inference program records "
                             "no tape")
        return record_steps(self._plan, feed, grad_names, generator)


class GraphCompiler:
    """Builds and caches an executor's `GraphProgram`s, one per mode."""

    @staticmethod
    def program_for(executor, train: bool) -> GraphProgram:
        train = bool(train)
        prog = executor._programs.get(train)
        if prog is None:
            bound = {**executor.arg_dict, **executor.aux_dict}
            prog = GraphProgram(executor._symbol, train,
                                input_shapes={n: a.shape
                                              for n, a in bound.items()},
                                device=executor._ctx.device,
                                input_dtypes={n: a.data.dtype
                                              for n, a in bound.items()})
            executor._programs[train] = prog
        return prog
