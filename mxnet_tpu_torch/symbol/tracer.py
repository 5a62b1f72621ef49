"""Trace a Gluon HybridBlock into a Symbol graph (the counterpart of
`mxnet_tpu/symbol/tracer.py`): calling the block on Symbol variables runs
``hybrid_forward`` with ``F = sym``, which composes the graph that
`HybridBlock.export` writes."""
from __future__ import annotations

from typing import Dict, Sequence

__all__ = ["trace_block"]


def trace_block(block, input_names: Sequence[str] = ("data",)):
    """``(symbol, arg_dict)``: the composed graph and the current value of
    every initialized parameter, keyed by its name."""
    from . import Group, var
    out = block(*[var(n) for n in input_names])
    sym = Group(list(out)) if isinstance(out, (list, tuple)) else out
    arg_dict: Dict = {name: p.data()
                      for name, p in block.collect_params().items()
                      if p._data is not None}
    return sym, arg_dict
