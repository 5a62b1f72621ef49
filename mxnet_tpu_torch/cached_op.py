"""CachedOp: the program ``hybridize()`` runs a Block's forward through (the
counterpart of `mxnet_tpu/cached_op.py`; reference
`src/imperative/cached_op.cc`).

The JAX package compiles one jitted program per (train mode, input
signature).  Here, a predict-mode forward on a CUDA device is captured as
a CUDA graph once per input signature (the structure, shapes, dtypes and
devices of the inputs, and the addresses, shapes and dtypes of the
parameters) and replayed: the inputs are copied into the graph's static
input tensors, and every call hands back outputs of its own.  The first
call of a signature runs eagerly on a side stream (`graph_compile.warm_up`,
so cuDNN picks its algorithms and workspace outside the capture) and
returns that run's outputs; the capture follows.  A forward under
`autograd.record`, in train mode, on the CPU or with
``MXTPU_GRAPH_COMPILE=0`` runs eagerly, so torch's autograd records it
and Dropout draws its masks from the device's stream as the imperative
forward does.

Before the first call, one predict-mode forward settles deferred
initialization without moving BatchNorm's statistics.  While a CachedOp
runs its block, hybridized children inline into it (`is_tracing`).  A
predict-mode forward draws no random numbers, so a deterministic net
consumes nothing of the random stream, hybridized or not.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import autograd
from .graph_compile import CapturedGraph, graph_compile_enabled, warm_up
from .ndarray.ndarray import NDArray

__all__ = ["CachedOp", "is_tracing", "tracing_scope"]


class _TraceState(threading.local):
    def __init__(self):
        super().__init__()
        self.active = False


_TRACE = _TraceState()


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


class CachedOp:
    """One captured forward per input signature of a hybridized block."""

    def __init__(self, block):
        self.block = block
        self._params = None
        self._programs: Dict[Tuple, _Program] = {}

    @property
    def num_programs(self) -> int:
        return len(self._programs)

    def _settle_init(self, args):
        """One eager predict-mode forward to finish deferred
        initialization (reference `_deferred_infer_shape`); the user's
        forward hooks do not see it."""
        with autograd.pause(train_mode=False), tracing_scope():
            self.block.forward(*args)
        self._params = [p for _, p in
                        sorted(self.block.collect_params().items())]

    def _forward(self, args):
        with tracing_scope():
            return self.block.forward(*args)

    def __call__(self, *args):
        if self._params is None:
            self._settle_init(args)
        leaves, rebuild = _flatten(list(args))
        nds = [x for x in leaves if isinstance(x, NDArray)]
        device = nds[0].data.device if nds else None
        if (autograd.is_recording() or autograd.is_training()
                or device is None or device.type != "cuda"
                or not graph_compile_enabled()):
            return self._forward(args)
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
