"""GraphProgram: the one program a bound inference graph runs (the
counterpart of `mxnet_tpu/graph_compile.py`, inference only).

At build it runs `graph_opt.optimize` over the symbol once, with the
bound input shapes and device, and plans the optimized graph into a flat
list of steps.  ``forward`` then runs the steps eagerly in topological
order under `torch.inference_mode`.  Capturing the steps as a CUDA graph
is later work.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import graph_opt
from .attribute import strip_annotations
from .base import MXNetError
from .ops import registry as _reg
from .ops.registry import Attrs
from .symbol.symbol import _entry_key, _topo, _value_key

__all__ = ["GraphProgram", "build_steps", "run_steps"]


def build_steps(symbol):
    """Plan ``symbol`` for execution: ``(var_names, steps, head_keys)``
    where each step is ``(fn, attrs, input keys, output keys)``."""
    nodes = _topo(symbol._heads)
    steps = []
    for node in nodes:
        if node.is_var:
            continue
        attrs = Attrs(strip_annotations(node.attrs))
        n_out = _reg.get_op(node.op).num_outputs(attrs)
        steps.append((_reg.get_op(node.op).fn, attrs,
                      [_value_key(e) for e in node.inputs],
                      [_entry_key((node, i)) for i in range(n_out)]))
    return ([n.name for n in nodes if n.is_var], steps,
            [_value_key(e) for e in symbol._heads])


def run_steps(plan, feed: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Run a `build_steps` plan on ``feed`` {variable name -> tensor}."""
    var_names, steps, head_keys = plan
    vals: Dict[str, torch.Tensor] = {}
    for name in var_names:
        try:
            vals[name] = feed[name]
        except KeyError:
            raise MXNetError(f"executor: missing input {name!r}") from None
    with torch.inference_mode():
        for fn, attrs, in_keys, out_keys in steps:
            out = fn(attrs, *[vals[k] for k in in_keys])
            outs = out if isinstance(out, tuple) else (out,)
            for k, o in zip(out_keys, outs):
                vals[k] = o
    return [vals[k] for k in head_keys]


class GraphProgram:
    """The program for one bound inference graph."""

    def __init__(self, symbol, input_shapes: Optional[Dict[str, Tuple]] = None,
                 device: Optional[torch.device] = None):
        opt = graph_opt.optimize(symbol, shapes=input_shapes, device=device)
        self._run_symbol = opt.symbol
        self.opt_reports = list(opt.reports)
        self._plan = build_steps(self._run_symbol)

    def forward(self, feed: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """The optimized graph's outputs for ``feed``."""
        return run_steps(self._plan, feed)
