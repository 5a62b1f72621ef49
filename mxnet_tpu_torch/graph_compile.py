"""GraphProgram: the one program a bound graph runs in one mode (the
counterpart of `mxnet_tpu/graph_compile.py`).

At build it runs `graph_opt.optimize` over the symbol once, with the
inference pass list or, for ``train=True``, the training list (which never
swaps kernels in), keeps the pipeline's ``const_feed`` (the values
``fold_const`` baked) on the device, and plans the optimized graph into a
flat list of steps.  Every feed of the program is merged with the
``const_feed``.

An inference ``forward`` runs the steps in topological order under
`torch.inference_mode`.  On a CUDA device it is captured as a CUDA graph,
one per set of input tensors (their addresses, shapes and dtypes), and
replayed: the counterpart of the JAX package's one jit program per
(symbol, mode).  The first forward of a set runs eagerly on a side stream
(the warm-up, whose outputs it returns), then the capture follows; every
forward hands back outputs of its own, as the reference's do.
``MXTPU_GRAPH_COMPILE=0`` (the JAX package's switch) runs the steps
eagerly; nothing else does, and a capture that fails raises.

A training program's ``forward_train`` runs the steps in train mode
(Dropout draws masks) with autograd on and the gradient arguments as
leaves, and returns a `Tape`; `backward_tape` turns the tape and the head
gradients into the gradient arguments' gradients, with ``grad_req='add'``
folded in.  The whole training step's capture is `unified_step`'s.

A kernel launch inside a capture runs no kernel: `CapturedGraph` keeps
the launches each capture records out of `hopper_kernels.LAUNCHES` and
adds them there at every replay.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from . import config, graph_opt
from .attribute import strip_annotations
from .base import MXNetError
from .ops import registry as _reg
from .ops.hopper_kernels import LAUNCHES
from .ops.registry import DEVICE, Attrs
from .symbol.symbol import _entry_key, _topo, _value_key

__all__ = ["GraphProgram", "GraphCompiler", "Tape", "CapturedGraph",
           "graph_compile_enabled", "build_steps", "run_plan", "run_steps",
           "record_steps", "tape_grads", "backward_tape", "warm_up",
           "feed_key"]


def graph_compile_enabled() -> bool:
    """Capture switch (``MXTPU_GRAPH_COMPILE``, default on): off, every
    program and training step runs its steps eagerly."""
    return config.get_env("MXTPU_GRAPH_COMPILE", "1").strip().lower() \
        not in ("0", "false", "off")


def build_steps(symbol):
    """Plan ``symbol`` for execution: ``(var_names, steps, head_keys)``
    where each step is ``(op, attrs, input keys, output keys, mutated
    variable names)``; an op's mutated inputs (MXNet's FMutateInputs,
    BatchNorm's moving statistics) take the values that follow its
    visible outputs."""
    nodes = _topo(symbol._heads)
    steps = []
    for node in nodes:
        if node.is_var:
            continue
        attrs = Attrs(strip_annotations(node.attrs))
        op = _reg.get_op(node.op)
        mutated = [node.inputs[s][0].name if node.inputs[s][0].is_var
                   else None for s in op.mutate_slots(attrs)]
        steps.append((op, attrs, [_value_key(e) for e in node.inputs],
                      [_entry_key((node, i))
                       for i in range(op.num_outputs(attrs))], mutated))
    return ([n.name for n in nodes if n.is_var], steps,
            [_value_key(e) for e in symbol._heads])


def run_plan(plan, feed: Mapping[str, torch.Tensor], train: bool = False,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """A `build_steps` plan run on ``feed`` under the caller's grad mode
    (with grad on, autograd records the steps on the feed's own tensors,
    as a `gluon.SymbolBlock` under `autograd.record` needs): the outputs
    and the mutated variables' new values."""
    var_names, steps, head_keys = plan
    vals: Dict[str, torch.Tensor] = {}
    for name in var_names:
        try:
            vals[name] = feed[name]
        except KeyError:
            raise MXNetError(f"executor: missing input {name!r}") from None
    device = next(iter(feed.values())).device if feed else None
    aux: Dict[str, torch.Tensor] = {}
    for op, attrs, in_keys, out_keys, mutated in steps:
        if op.uses_train_mode:
            attrs = Attrs(attrs, __train=train)
        if op.takes_device:
            attrs = Attrs(attrs, **{DEVICE: device})
        ins = [vals[k] for k in in_keys]
        out = op.fn(attrs, generator, *ins) if op.needs_rng else \
            op.fn(attrs, *ins)
        outs = out if isinstance(out, tuple) else (out,)
        for k, o in zip(out_keys, outs):
            vals[k] = o
        for name, o in zip(mutated, outs[len(out_keys):]):
            if name is not None:
                aux[name] = vals[name] = o
    return [vals[k] for k in head_keys], aux


def run_steps(plan, feed: Mapping[str, torch.Tensor], train: bool = False,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Run a `build_steps` plan on ``feed`` {variable name -> tensor}
    under `torch.inference_mode`; ``train`` switches the train-mode ops
    (Dropout draws from ``generator``).  Returns the outputs and the new
    values of the mutated variables."""
    with torch.inference_mode():
        return run_plan(plan, feed, train, generator)


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
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor],
                            Tape]:
    """Run a plan in train mode with autograd recording, the
    ``grad_names`` inputs as leaves (views of the bound tensors, so an
    in-place write to one between forward and backward is caught by
    autograd).  Returns the outputs, detached, the mutated variables' new
    values, and the tape."""
    leaves = {n: feed[n].detach().requires_grad_(True) for n in grad_names}
    with torch.enable_grad():
        outs, aux = run_plan(plan, {**feed, **leaves}, True, generator)
    return [o.detach() for o in outs], aux, Tape(leaves, outs)


def tape_grads(tape: Tape, head_grads: Sequence[torch.Tensor]
               ) -> Dict[str, Optional[torch.Tensor]]:
    """The gradient of each leaf for ``head_grads``, None where no output
    depends on it.  The tape's graph is freed."""
    outs, cts = [], []
    for o, g in zip(tape.outputs, head_grads):
        if o.requires_grad:
            outs.append(o)
            cts.append(g.to(device=o.device, dtype=o.dtype))
    names = list(tape.leaves)
    grads = torch.autograd.grad(outs, [tape.leaves[n] for n in names],
                                grad_outputs=cts, allow_unused=True) \
        if outs else [None] * len(names)
    tape.outputs = []
    return dict(zip(names, grads))


def backward_tape(tape: Tape, head_grads: Sequence[torch.Tensor],
                  grad_req: Mapping[str, str],
                  grad_dict: Mapping[str, torch.Tensor]) -> None:
    """Backpropagate ``head_grads`` through a tape and write each leaf's
    gradient into ``grad_dict`` by its ``grad_req``: 'write' copies,
    'add' accumulates.  A leaf no output depends on gets zeros, as JAX's
    vjp gives."""
    grads = tape_grads(tape, head_grads)
    with torch.no_grad():
        for name, g in grads.items():
            dst = grad_dict[name]
            if g is None:
                if grad_req[name] != "add":
                    dst.zero_()
            elif grad_req[name] == "add":
                dst.add_(g.to(dst.dtype))
            else:
                dst.copy_(g)


# ---------------------------------------------------------------------------
# CUDA graphs
# ---------------------------------------------------------------------------

def feed_key(feed: Mapping[str, torch.Tensor]) -> Tuple:
    """What a capture depends on in its feed: each tensor's address, shape,
    strides and dtype."""
    return tuple((n, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 for n, t in sorted(feed.items()))


def warm_up(fn: Callable, device: torch.device):
    """``fn()`` on a side stream, the main stream waiting for it: the
    eager run a capture needs first.  Its tensor outputs are marked as
    used on the main stream, so the caller may keep them."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    for t in _tensors(out):
        t.record_stream(main)
    return out


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (list, tuple)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


class CapturedGraph:
    """``fn`` captured once as a CUDA graph (after the caller's
    `warm_up`), its outputs kept as the graph's static tensors.  The
    kernel launches the capture records count at each `replay`, not at
    the capture; ``generator`` (the stream Dropout draws from) is
    registered, so each replay draws new numbers.  Graphs given one
    ``pool`` (`torch.cuda.graph_pool_handle`) share their memory, so a
    later capture may read what an earlier one left (a backward reading
    its forward's saved tensors)."""

    def __init__(self, fn: Callable, device: torch.device,
                 generator: Optional[torch.Generator] = None, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            if not hasattr(self.graph, "register_generator_state"):
                raise MXNetError(
                    "this PyTorch cannot register a generator with a CUDA "
                    "graph; set MXTPU_GRAPH_COMPILE=0 to run eagerly")
            self.graph.register_generator_state(generator)
        before = dict(LAUNCHES)
        try:
            # thread-local: a loader thread staging the next batch on its
            # own stream (io._Stager) may synchronize or allocate while
            # this thread captures
            with torch.cuda.device(device), \
                    torch.cuda.graph(self.graph, pool=pool,
                                     capture_error_mode="thread_local"):
                self.outputs = fn()
        except Exception as e:
            raise MXNetError(f"CUDA graph capture failed: {e}; set "
                             "MXTPU_GRAPH_COMPILE=0 to run eagerly") from e
        finally:
            self.launches = {k: LAUNCHES[k] - before[k] for k in before}
            LAUNCHES.update(before)

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        return self.outputs


class GraphProgram:
    """The program for one bound graph in one mode."""

    def __init__(self, symbol, train: bool = False,
                 input_shapes: Optional[Dict[str, Tuple]] = None,
                 device: Optional[torch.device] = None,
                 input_dtypes: Optional[Dict[str, torch.dtype]] = None):
        self.train = bool(train)
        self.device = device if device is not None else torch.device("cpu")
        opt = graph_opt.optimize(symbol, shapes=input_shapes, device=device,
                                 train=self.train, dtypes=input_dtypes)
        if self.train and opt.symbol is not symbol:
            graph_opt._check_train_invariants(symbol, opt.symbol)
        self._run_symbol = opt.symbol
        self.opt_reports = list(opt.reports)
        self.const_feed = {n: v.to(self.device)
                           for n, v in opt.const_feed.items()}
        self._plan = build_steps(self._run_symbol)
        self._graphs: Dict[Tuple, CapturedGraph] = {}

    @property
    def captured(self) -> bool:
        """Whether inference forwards run as CUDA graphs."""
        return (not self.train and self.device.type == "cuda"
                and graph_compile_enabled())

    def forward(self, feed: Mapping[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """The optimized graph's outputs for ``feed`` and its mutated
        variables' new values, nothing recorded (in train mode, Dropout
        still draws masks)."""
        feed = {**feed, **self.const_feed}
        if not self.captured:
            return run_steps(self._plan, feed, self.train, generator)
        key = feed_key(feed)
        graph = self._graphs.get(key)
        if graph is None:
            def run():
                return run_steps(self._plan, feed, False)[0]
            outs = warm_up(run, self.device)
            self._graphs[key] = CapturedGraph(run, self.device)
            return outs, {}
        return [o.clone() for o in graph.replay()], {}

    def forward_train(self, feed: Mapping[str, torch.Tensor],
                      grad_names: Sequence[str],
                      generator: torch.Generator):
        """A train-mode forward recorded for `backward_tape`: outputs,
        mutated variables and the tape."""
        if not self.train:
            raise MXNetError("GraphProgram: an inference program records "
                             "no tape")
        return record_steps(self._plan, {**feed, **self.const_feed},
                            grad_names, generator)


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
