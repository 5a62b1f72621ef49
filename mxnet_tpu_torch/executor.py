"""Executor: a Symbol bound to arrays on one device (the counterpart of
`mxnet_tpu/executor.py`, inference only).

``forward`` runs the bound graph as composed; ``compiled_forward`` runs it
through the executor's `GraphProgram`, the graph optimizer's output (the
path `Predictor` serves).  Training (``is_train=True``, backward) arrives
with the slice that ports the attention backward kernels.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError
from .context import Context, default_context
from .graph_compile import GraphProgram, build_steps, run_steps
from .ndarray.ndarray import NDArray

__all__ = ["Executor", "build_graph_fn"]


def build_graph_fn(symbol):
    """The symbol DAG as a function ``fn(feed: {name: tensor}) ->
    [outputs]``: each op's registered function runs in topological
    order."""
    plan = build_steps(symbol)

    def fn(feed: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        return run_steps(plan, feed)

    return fn


class Executor:
    """Reference `include/mxnet/executor.h` surface for inference:
    arg_dict/aux_dict, forward, outputs."""

    def __init__(self, symbol, ctx: Optional[Context] = None, args=None,
                 grad_req="null", aux_states=None):
        if grad_req != "null":
            raise NotImplementedError(
                "gradients arrive with the training slice: bind with "
                "grad_req='null'")
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else default_context("bind")
        self.arg_names = symbol.list_arguments()
        self.output_names = symbol.list_outputs()
        device = self._ctx.device
        if isinstance(args, (list, tuple)):
            args = dict(zip(self.arg_names, args))
        args = args or {}
        missing = [n for n in self.arg_names if n not in args]
        if missing:
            raise MXNetError(f"executor: args missing entries {missing}")
        self.arg_dict: Dict[str, NDArray] = {
            n: NDArray(_tensor(args[n]).to(device)) for n in self.arg_names}
        self.aux_dict: Dict[str, NDArray] = {
            n: NDArray(_tensor(a).to(device))
            for n, a in (aux_states or {}).items()}
        self.outputs: List[NDArray] = []
        self._program: Optional[GraphProgram] = None
        self._graph_fn = None

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

    def forward(self, is_train=False, **kwargs) -> List[NDArray]:
        """Run the graph as composed (no rewrites)."""
        _check_inference(is_train)
        self._ingest_inputs(kwargs)
        if self._graph_fn is None:
            self._graph_fn = build_graph_fn(self._symbol)
        self.outputs = [NDArray(o) for o in self._graph_fn(self._feed())]
        return self.outputs

    def graph_program(self, train=False) -> GraphProgram:
        """This executor's `GraphProgram`, built on first use from the
        bound shapes and device."""
        _check_inference(train)
        if self._program is None:
            shapes = {n: a.shape for n, a in self.arg_dict.items()}
            shapes.update({n: a.shape for n, a in self.aux_dict.items()})
            self._program = GraphProgram(self._symbol, input_shapes=shapes,
                                         device=self._ctx.device)
        return self._program

    def compiled_forward(self, is_train=False, **kwargs) -> List[NDArray]:
        """Forward through the optimized `GraphProgram`."""
        program = self.graph_program(is_train)
        self._ingest_inputs(kwargs)
        self.outputs = [NDArray(o) for o in program.forward(self._feed())]
        return self.outputs

    def __repr__(self):
        return (f"<Executor outputs={self.output_names} "
                f"args={len(self.arg_names)} ctx={self._ctx}>")


def _check_inference(train):
    if train:
        raise NotImplementedError(
            "training arrives with the slice that ports the attention "
            "backward kernels (K2, K3)")


def _tensor(v) -> torch.Tensor:
    if isinstance(v, NDArray):
        return v.data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))
