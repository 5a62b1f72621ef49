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

Observability: `profiler.graph_counters()` (``graph_compiles``,
``graph_cache_hits``, ``retraces``, ``dispatches_saved``,
``fallback_island_nodes``) and the step counters ``dispatches`` and
``graph_captures`` (the JAX package's ``jit_traces``); every program
build runs inside a ``telemetry.span("graph.compile")``.

Fallback islands.  `deny_ops` (``DEFAULT_DENY_OPS`` = ``{"Custom"}`` plus
``MXTPU_GRAPH_COMPILE_DENY``) are the ops that stay out of one program, as
in the JAX package: a program over a graph that holds one is partitioned
by `GraphCompileProperty` (`subgraph.partition`) and counts its
``islands`` and ``fallback_nodes``.  The port cannot capture a host read
either, so its own set, `uncapturable_ops`, adds ``_cond`` (whose
predicate is read on the host; XLA traces `lax.cond` into one program, a
CUDA graph cannot hold it).  On the card an inference forward over a graph
holding one of those runs the island plan: each `_subgraph_op` island is
captured as a CUDA graph of its own (keyed by the bound tensors it reads;
what an eager node made is copied into the island's static inputs) and the
uncapturable nodes run eagerly between them.  A training program with
islands takes no tape: its graph trains on the executor's classic path
(`forward_train` and `backward` raise), and `Module` never builds the
one-graph training step over a graph that holds an uncapturable op
(`one_graph`).  `lower_step_fn` refuses denied ops, with the JAX
package's message.  An op inside a control-flow body (`_foreach`,
`_while_loop`, `_cond`, `_subgraph_op`) counts as the node's own for
these decisions (`graph_ops`): a ``_foreach`` whose body holds a
``_cond`` runs eagerly between islands, its body included.  The island
counts follow the JAX package, which looks at the top level only.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import functools
import gc
import threading

import numpy as np
import torch

from . import config, graph_opt
from . import profiler as _prof
from . import telemetry
from .attribute import strip_annotations
from .base import MXNetError
from .ops import registry as _reg
from .ops.hopper_kernels import count_launch, recording_launches
from .ops.registry import DEVICE, PROGRAM_STATE, Attrs
from .subgraph import (SubgraphProperty, SubgraphSelector,
                       register_subgraph_property)
from .symbol.symbol import _entry_key, _topo, _value_key

__all__ = ["GraphProgram", "GraphCompiler", "Tape", "CapturedGraph",
           "graph_compile_enabled", "build_steps", "run_plan", "run_steps",
           "record_steps", "tape_grads", "backward_tape", "warm_up",
           "feed_key", "deny_ops", "DEFAULT_DENY_OPS", "uncapturable_ops",
           "one_graph", "graph_ops", "lower_step_fn",
           "GraphCompileProperty", "StaticProgram",
           "program_for"]


def graph_compile_enabled() -> bool:
    """Capture switch (``MXTPU_GRAPH_COMPILE``, default on): off, every
    program and training step runs its steps eagerly."""
    return config.get_env("MXTPU_GRAPH_COMPILE", "1").strip().lower() \
        not in ("0", "false", "off")


#: ops the whole-graph program refuses by default, the JAX package's set:
#: `Custom` runs user Python on the host (`ops/custom_op.py`), so it runs
#: between captured islands instead
DEFAULT_DENY_OPS = frozenset({"Custom"})


def deny_ops() -> frozenset:
    """The active non-lowerable op set: :data:`DEFAULT_DENY_OPS` plus
    ``MXTPU_GRAPH_COMPILE_DENY`` (comma-separated op names -- the test
    hook and escape hatch for an op that mis-lowers in one trace)."""
    extra = config.get_env("MXTPU_GRAPH_COMPILE_DENY", "")
    return DEFAULT_DENY_OPS | {t.strip() for t in extra.split(",")
                               if t.strip()}


def uncapturable_ops() -> frozenset:
    """The ops a CUDA graph cannot hold: `deny_ops` and ``_cond``, whose
    predicate is read on the host."""
    return deny_ops() | {"_cond"}


#: the attrs that carry a control-flow node's body graphs as JSON
_BODY_ATTRS = ("__subgraph__", "__body__", "__cond__", "__then__",
               "__else__")


@functools.lru_cache(maxsize=None)
def _json_ops(graph_json: str) -> frozenset:
    from .symbol.symbol import load_json
    return graph_ops(load_json(graph_json))


def node_ops(node) -> frozenset:
    """A compute node's op and every op inside its bodies, at any
    depth."""
    ops = {node.op}
    for key in _BODY_ATTRS:
        text = node.attrs.get(key)
        if isinstance(text, str):
            ops |= _json_ops(text)
    return frozenset(ops)


def graph_ops(symbol) -> frozenset:
    """Every op ``symbol`` runs, those inside control-flow bodies too."""
    ops = set()
    for n in _topo(symbol._heads):
        if not n.is_var:
            ops |= node_ops(n)
    return frozenset(ops)


def one_graph(symbol) -> bool:
    """Whether every op of ``symbol``, inside bodies too, can sit in one
    CUDA graph."""
    return not graph_ops(symbol) & uncapturable_ops()


class _LowerableSelector(SubgraphSelector):
    """Select every compute node outside the denied set; with ``nested``,
    a node whose body holds a denied op is denied too."""

    def __init__(self, deny, nested=False):
        self._deny = frozenset(deny)
        self._nested = nested

    def select(self, node) -> bool:
        if node.is_var:
            return False
        ops = node_ops(node) if self._nested else {node.op}
        return not ops & self._deny


@register_subgraph_property("graph_compile")
class GraphCompileProperty(SubgraphProperty):
    """Partition property behind the fallback-island carve-out: maximal
    convex lowerable regions fuse into `_subgraph_op` islands (one
    captured graph each); whatever remains -- denied ops, plus lowerable
    nodes the convexity shrink evicted -- runs op by op between them.  A
    single-node island is still one captured unit, hence min_nodes=1."""

    def __init__(self, deny=None, nested=False):
        self._deny = frozenset(deny) if deny is not None else deny_ops()
        self._nested = nested

    def create_subgraph_selector(self):
        return _LowerableSelector(self._deny, self._nested)

    def min_nodes(self) -> int:
        return 1


def build_steps(symbol):
    """Plan ``symbol`` for execution: ``(var_names, steps, head_keys)``
    where each step is ``(op, attrs, input keys, output keys, mutated
    variable names)``; an op's mutated inputs (MXNet's FMutateInputs,
    BatchNorm's moving statistics) take the values that follow its
    visible outputs.  A ``program_state`` op's step gets a state dict of
    its own (`registry.PROGRAM_STATE`)."""
    nodes = _topo(symbol._heads)
    steps = []
    for node in nodes:
        if node.is_var:
            continue
        attrs = Attrs(strip_annotations(node.attrs))
        op = _reg.get_op(node.op)
        if op.program_state:
            attrs[PROGRAM_STATE] = {}
        mutated = [node.inputs[s][0].name if node.inputs[s][0].is_var
                   else None for s in op.mutate_slots(attrs)]
        steps.append((op, attrs, [_value_key(e) for e in node.inputs],
                      [_entry_key((node, i))
                       for i in range(op.num_outputs(attrs))], mutated))
    return ([n.name for n in nodes if n.is_var], steps,
            [_value_key(e) for e in symbol._heads])


def run_plan(plan, feed: Mapping[str, torch.Tensor], train: bool = False,
             generator: Optional[torch.Generator] = None,
             device: Optional[torch.device] = None,
             placement: Optional[Sequence[torch.device]] = None
             ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """A `build_steps` plan run on ``feed`` under the caller's grad mode
    (with grad on, autograd records the steps on the feed's own tensors,
    as a `gluon.SymbolBlock` under `autograd.record` needs): the outputs
    and the mutated variables' new values.  Zero-input ops build on
    ``device``, by default the feed's.  ``placement`` gives each step's
    device (``group2ctx``): a step's inputs are copied there first, so a
    run of steps on one device is a segment with a copy at each boundary,
    and autograd carries the gradients back across it."""
    var_names, steps, head_keys = plan
    vals: Dict[str, torch.Tensor] = {}
    for name in var_names:
        try:
            vals[name] = feed[name]
        except KeyError:
            raise MXNetError(f"executor: missing input {name!r}") from None
    if device is None and feed:
        device = next(iter(feed.values())).device
    aux: Dict[str, torch.Tensor] = {}
    for i, (op, attrs, in_keys, out_keys, mutated) in enumerate(steps):
        ins = [vals[k] for k in in_keys]
        dev = device
        if placement is not None:
            dev = placement[i]
            ins = [t if t.device == dev else t.to(dev) for t in ins]
        outs = _call(op, attrs, ins, train, generator, dev)
        for k, o in zip(out_keys, outs):
            vals[k] = o
        for name, o in zip(mutated, outs[len(out_keys):]):
            if name is not None:
                aux[name] = vals[name] = o
    return [vals[k] for k in head_keys], aux


def _call(op, attrs, ins, train, generator, device) -> Tuple:
    """One plan step's op on ``ins``: its outputs as a tuple."""
    if op.uses_train_mode:
        attrs = Attrs(attrs, __train=train)
    if op.takes_device:
        attrs = Attrs(attrs, **{DEVICE: device})
    out = op.fn(attrs, generator, *ins) if op.needs_rng else \
        op.fn(attrs, *ins)
    return out if isinstance(out, tuple) else (out,)


def run_steps(plan, feed: Mapping[str, torch.Tensor], train: bool = False,
              generator: Optional[torch.Generator] = None,
              placement: Optional[Sequence[torch.device]] = None
              ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """Run a `build_steps` plan on ``feed`` {variable name -> tensor}
    under `torch.inference_mode`; ``train`` switches the train-mode ops
    (Dropout draws from ``generator``).  Returns the outputs and the new
    values of the mutated variables."""
    with torch.inference_mode():
        return run_plan(plan, feed, train, generator, placement=placement)


class Tape:
    """What a recorded forward keeps for its backward: the leaves it
    differentiates, by name, and the outputs autograd recorded."""
    __slots__ = ("leaves", "outputs")

    def __init__(self, leaves: Dict[str, torch.Tensor],
                 outputs: List[torch.Tensor]):
        self.leaves = leaves
        self.outputs = outputs


def record_steps(plan, feed: Mapping[str, torch.Tensor],
                 grad_names: Sequence[str], generator: torch.Generator,
                 placement: Optional[Sequence[torch.device]] = None
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor],
                            Tape]:
    """Run a plan in train mode with autograd recording, the
    ``grad_names`` inputs as leaves (views of the bound tensors, so an
    in-place write to one between forward and backward is caught by
    autograd).  Returns the outputs, detached, the mutated variables' new
    values, and the tape."""
    leaves = {n: feed[n].detach().requires_grad_(True) for n in grad_names}
    with torch.enable_grad():
        outs, aux = run_plan(plan, {**feed, **leaves}, True, generator,
                             placement=placement)
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
    `warm_up`), its outputs kept as the graph's static tensors, and ``fn``
    itself, so the tensors it reads outlive the capture.  The
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
        # no garbage collection while capturing: a program and its graph
        # form a reference cycle (the graph keeps the function that reads
        # the program), so a collection can destroy a dead program's
        # graph, which is not permitted during a capture and invalidates
        # it
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread-local: a loader thread staging the next batch on its
            # own stream (io._Stager), or a serving thread replaying
            # another graph, may synchronize or allocate while this
            # thread captures; the launches on the capture stream count
            # apart from theirs
            with torch.cuda.device(device), \
                    torch.cuda.graph(self.graph, pool=pool,
                                     capture_error_mode="thread_local"):
                with recording_launches(torch.cuda.current_stream(
                        device).cuda_stream) as recorded:
                    self.outputs = fn()
        except Exception as e:
            raise MXNetError(f"CUDA graph capture failed: {e}; set "
                             "MXTPU_GRAPH_COMPILE=0 to run eagerly") from e
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: n for k, n in recorded.items() if n}
        # a replay reads the addresses the capture recorded: keep what the
        # function reads (its closure's tensors) alive with the graph
        self._fn = fn
        _prof.bump_counter("graph_captures")

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            count_launch(k, n)
        return self.outputs


class StaticProgram:
    """A `build_steps` plan at fixed input shapes on one device, fed
    through static input buffers: the unit the serving pool holds per
    (device, ladder rung).

    ``weights`` ({name: tensor on ``device``}) are read in place;
    ``inputs`` are ``[(name, shape, numpy dtype)]``, each given a static
    buffer of that shape.  On a CUDA device (unless
    ``MXTPU_GRAPH_COMPILE=0``) the plan is warmed and captured here,
    once, and every call replays it; elsewhere every call runs the same
    plan eagerly.  A call writes its arrays into the static inputs (with
    ``rows``, each padded up to its buffer's leading dimension by
    repeating its last row), runs, and copies every output (its first
    ``rows`` rows) to the host before the next call may touch the
    buffers: calls are serialized by ``lock`` (one per device replica, so
    the rungs of one replica never run at once), and no result aliases a
    static buffer."""

    def __init__(self, plan, weights: Mapping[str, torch.Tensor],
                 inputs: Sequence[Tuple[str, Tuple[int, ...], np.dtype]],
                 device: torch.device,
                 lock: Optional[threading.Lock] = None):
        self.device = device
        self.lock = lock if lock is not None else threading.Lock()
        self._names = [n for n, _s, _d in inputs]
        self.static = {
            n: torch.zeros(tuple(shape),
                           dtype=torch.from_numpy(np.zeros((), d)).dtype,
                           device=device)
            for n, shape, d in inputs}
        # the program holds its weights: a capture reads their addresses
        self._feed = feed = {**weights, **self.static}

        def run():
            return run_steps(plan, feed, False)[0]
        self._graph = None
        self._run = run
        if device.type == "cuda" and graph_compile_enabled():
            with torch.cuda.device(device):
                warm_up(run, device)
                self._graph = CapturedGraph(run, device)
            self._run = self._graph.replay

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, arrays: Sequence[np.ndarray],
                 rows: Optional[int] = None) -> List[np.ndarray]:
        padded = []
        for name, arr in zip(self._names, arrays):
            want = tuple(self.static[name].shape)
            if rows is not None and arr.shape[0] < want[0]:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], want[0] - arr.shape[0],
                                    axis=0)], axis=0)
            if tuple(arr.shape) != want:
                raise MXNetError(f"input {name!r}: shape {arr.shape} does "
                                 f"not match the program's {want}")
            padded.append(torch.from_numpy(np.ascontiguousarray(arr)))
        with self.lock:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    return self._call(padded, rows)
            return self._call(padded, rows)

    def _call(self, padded, rows) -> List[np.ndarray]:
        with torch.no_grad():
            for name, src in zip(self._names, padded):
                self.static[name].copy_(src)
        outs = self._run()
        if rows is not None:
            outs = [o[:rows] for o in outs]
        # the host copies end the use of the static buffers
        return [o.to("cpu").numpy() if o.is_cuda else o.clone().numpy()
                for o in outs]


class _Island:
    """One `_subgraph_op` step of the island plan, captured once per set
    of the bound tensors it reads.  An input an eager node made is copied
    into the island's static input first."""

    def __init__(self, op, attrs, in_keys, bound):
        self.op = op
        self.attrs = attrs
        self.direct = [k in bound for k in in_keys]
        self._graphs: Dict[Tuple, Tuple[List, CapturedGraph]] = {}

    def __call__(self, ins, device):
        key = tuple((t.data_ptr(),) + _sig(t) if d else _sig(t)
                    for t, d in zip(ins, self.direct))
        entry = self._graphs.get(key)
        if entry is None:
            static = [t if d else t.clone() for t, d in zip(ins, self.direct)]

            def run():
                with torch.inference_mode():
                    return list(_call(self.op, self.attrs, static, False,
                                      None, device))
            outs = warm_up(run, device)
            self._graphs[key] = (static, CapturedGraph(run, device))
            return outs
        static, graph = entry
        for s_, t, d in zip(static, ins, self.direct):
            if not d:
                s_.copy_(t)
        return graph.replay()


def _sig(t: torch.Tensor) -> Tuple:
    return (tuple(t.shape), t.stride(), t.dtype)


class GraphProgram:
    """The program for one bound graph in one mode."""

    def __init__(self, symbol, train: bool = False,
                 input_shapes: Optional[Dict[str, Tuple]] = None,
                 device: Optional[torch.device] = None,
                 input_dtypes: Optional[Dict[str, torch.dtype]] = None):
        from .subgraph import partition
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
        run_nodes = [n for n in _topo(self._run_symbol._heads)
                     if not n.is_var]
        # the JAX package's counts, over its deny set
        deny = deny_ops()
        self._psym = None
        self.islands = self.fallback_nodes = 0
        if any(n.op in deny for n in run_nodes):
            self._psym = partition(self._run_symbol,
                                   GraphCompileProperty(deny))
            for n in _topo(self._psym._heads):
                if n.is_var:
                    continue
                if n.op == SubgraphProperty.subgraph_op:
                    self.islands += 1
                else:
                    self.fallback_nodes += 1
        # the capture's own plan, over what a CUDA graph cannot hold,
        # inside bodies too
        bad = uncapturable_ops()
        self._island_plan = None
        self._islands_of: Dict[int, _Island] = {}
        if any(node_ops(n) & bad for n in run_nodes):
            self._island_plan = build_steps(partition(
                self._run_symbol, GraphCompileProperty(bad, nested=True)))

    @property
    def has_islands(self) -> bool:
        """True when the graph holds a denied op: it runs islands and
        fallback nodes, and trains on the executor's classic path."""
        return self._psym is not None

    @property
    def one_graph(self) -> bool:
        """Whether an inference forward is one CUDA graph (no island
        plan)."""
        return self._island_plan is None

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
            # eager: one host dispatch per step of the plan
            _prof.bump_counter("dispatches", len(self._plan[1]))
            return run_steps(self._plan, feed, self.train, generator)
        if not self.one_graph:
            return self._forward_islands(feed), {}
        key = feed_key(feed)
        graph = self._graphs.get(key)
        _prof.bump_counter("dispatches")
        if graph is None:
            def run():
                return run_steps(self._plan, feed, False)[0]
            outs = warm_up(run, self.device)
            if self._graphs:
                _prof.bump_graph("retraces")
            self._graphs[key] = CapturedGraph(run, self.device)
            return outs, {}
        _prof.bump_graph("dispatches_saved", max(0, len(self._plan[1]) - 1))
        return [o.clone() for o in graph.replay()], {}

    def _forward_islands(self, feed) -> List[torch.Tensor]:
        """The island plan: each island a captured graph of its own (run
        eagerly where nothing is captured), the uncapturable nodes
        eagerly between them."""
        var_names, steps, head_keys = self._island_plan
        _prof.bump_counter("dispatches", len(steps))
        vals = {n: feed[n] for n in var_names}
        gen = None
        for i, (op, attrs, in_keys, out_keys, _mut) in enumerate(steps):
            ins = [vals[k] for k in in_keys]
            if op.name == SubgraphProperty.subgraph_op and self.captured:
                island = self._islands_of.get(i)
                if island is None:
                    island = self._islands_of[i] = _Island(
                        op, attrs, in_keys, set(var_names))
                outs = island(ins, self.device)
            else:
                if op.needs_rng and gen is None:
                    from . import random as _random
                    gen = _random.generator(self.device)
                with torch.inference_mode():
                    outs = _call(op, attrs, ins, False, gen, self.device)
            vals.update(zip(out_keys, outs))
        return [vals[k].clone() for k in head_keys]

    def audit(self, feed: Optional[Mapping[str, torch.Tensor]] = None):
        """Statically audit the plan this program captures
        (`analysis.program_audit`): no host-bound op outside declared
        fallback islands (for a program with islands, the island plan,
        whose eager nodes are declared), and, given ``feed`` (the bound
        inputs), no float64 promotion.  Runs no kernel.  Returns the
        Finding list (empty = clean), counted in the ``audit`` family."""
        from .analysis import program_audit as _audit
        islands = self._island_plan is not None
        plan = self._island_plan if islands else self._plan
        if feed is not None:
            feed = {**feed, **self.const_feed}
        return _audit.record(_audit.audit_plan(
            "graph_program:" + ("train" if self.train else "fwd"), plan,
            feed=feed, islands=islands))

    def forward_train(self, feed: Mapping[str, torch.Tensor],
                      grad_names: Sequence[str],
                      generator: torch.Generator):
        """A train-mode forward recorded for `backward`: outputs, mutated
        variables and the tape."""
        if not self.train:
            raise MXNetError("GraphProgram: an inference program records "
                             "no tape")
        if self.has_islands:
            raise MXNetError(
                "GraphProgram.forward_train: graph has fallback islands; "
                "use Executor.forward")
        return record_steps(self._plan, {**feed, **self.const_feed},
                            grad_names, generator)

    def backward(self, tape: Tape, head_grads: Sequence[torch.Tensor],
                 grad_req: Mapping[str, str],
                 grad_dict: Mapping[str, torch.Tensor]) -> None:
        """`backward_tape` of a `forward_train` tape."""
        if self.has_islands:
            raise MXNetError(
                "GraphProgram.backward: graph has fallback islands; "
                "use Executor.backward")
        backward_tape(tape, head_grads, grad_req, grad_dict)

    def __repr__(self):
        return (f"<GraphProgram train={self.train} islands={self.islands} "
                f"fallback_nodes={self.fallback_nodes}>")


class GraphCompiler:
    """Builds and caches an executor's `GraphProgram`s, one per mode and
    bound signature (each bound array's name, shape and dtype).  The cache
    ``executor._programs`` maps a mode to ``{signature: program}`` and is
    shared by the executors `Executor.reshape` makes (and by a bucket's
    modules), so a reshape back finds its program.  An executor's bound
    shapes never change, so it computes its signature and looks up each
    mode's program once."""

    @staticmethod
    def program_for(executor, train: bool) -> GraphProgram:
        train = bool(train)
        prog = executor._own_programs.get(train)
        if prog is not None:
            _prof.bump_graph("graph_cache_hits")
            return prog
        bound = {**executor.arg_dict, **executor.aux_dict}
        sig = tuple(sorted((n, tuple(a.shape), a.data.dtype)
                           for n, a in bound.items()))
        by_sig = executor._programs.setdefault(train, {})
        prog = by_sig.get(sig)
        if prog is None:
            with telemetry.span("graph.compile", train=train,
                                outputs=",".join(executor.output_names[:4])):
                prog = by_sig[sig] = GraphProgram(
                    executor._symbol, train,
                    input_shapes={n: a.shape for n, a in bound.items()},
                    device=executor._ctx.device,
                    input_dtypes={n: a.data.dtype
                                  for n, a in bound.items()})
            _prof.bump_graph("graph_compiles")
            if prog.fallback_nodes:
                _prof.bump_graph("fallback_island_nodes",
                                 prog.fallback_nodes)
        else:
            _prof.bump_graph("graph_cache_hits")
        executor._own_programs[train] = prog
        return prog


program_for = GraphCompiler.program_for


def lower_step_fn(symbol, train: bool = False):
    """``symbol`` as one function ``fn(feed, generator) -> (outputs,
    aux_updates)`` to embed inside a larger captured program (the
    generation plane's decode step).  Any op of `deny_ops`, inside a
    control-flow body too, is refused with the JAX package's message: an
    island inside a decode loop would cross to the host at every step."""
    bad = sorted(graph_ops(symbol) & deny_ops())
    if bad:
        raise MXNetError(
            f"lower_step_fn: op(s) {bad} cannot lower into a donated "
            "step program (host-callback islands are denied inside "
            "scan bodies); run them op-by-op outside the decode loop")
    from .executor import build_graph_fn
    return build_graph_fn(symbol, train=train)
