"""Define-by-run autograd (the counterpart of `mxnet_tpu/autograd.py`;
reference `python/mxnet/autograd.py`).

Torch's autograd is the tape.  While `record` is on, every `nd` op runs
with torch's grad mode on, so the ops on variables build torch's graph;
outside it, `nd` runs under `torch.no_grad()` and records nothing.  A
variable (`mark_variables`, `NDArray.attach_grad`) is a leaf tensor that
requires grad, with a gradient buffer beside it; `backward` asks
`torch.autograd.grad` for the gradients of the live variables the heads
depend on and writes each into its buffer by its ``grad_req``: 'write'
copies, 'add' accumulates, 'null' variables are not variables at all.
``create_graph`` keeps the gradients differentiable (their buffers are
rebound to them), so a second `backward` gives second derivatives.

`Function` is a user-defined op over `torch.autograd.Function`.
`get_symbol` raises, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "grad_mode",
           "mark_variables", "backward", "grad", "get_symbol", "Function",
           "NotImplementedForSymbolError"]


class _State(threading.local):
    def __init__(self):
        super().__init__()
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


def grad_mode():
    """torch's grad mode for an op run now: on while recording."""
    return torch.enable_grad() if _STATE.recording else torch.no_grad()


class _Scope:
    def __init__(self, recording: Optional[bool], training: Optional[bool]):
        self._rec = recording
        self._train = training

    def __enter__(self):
        if self._rec is not None:
            self._prev_rec = set_recording(self._rec)
        if self._train is not None:
            self._prev_train = set_training(self._train)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            set_recording(self._prev_rec)
        if self._train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True) -> _Scope:
    """Scope: record ops for autograd, in train mode unless told not to
    (reference `autograd.record`)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False) -> _Scope:
    return _Scope(False, train_mode)


def train_mode() -> _Scope:
    return _Scope(None, True)


def predict_mode() -> _Scope:
    return _Scope(None, False)


def _as_list(x):
    from .ndarray.ndarray import NDArray
    if x is None:
        return None
    if isinstance(x, NDArray):
        return [x]
    return list(x)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make ``variables`` differentiable with ``gradients`` as their
    buffers (reference `MarkVariables`); bare NDArrays or sequences."""
    from .ndarray.ndarray import NDArray, VARIABLES
    if isinstance(variables, NDArray) != isinstance(gradients, NDArray):
        raise MXNetError("mark_variables: variables and gradients must "
                         "both be NDArrays or both be sequences")
    variables = _as_list(variables)
    gradients = _as_list(gradients)
    if len(variables) != len(gradients):
        raise MXNetError(
            f"mark_variables: {len(variables)} variables but "
            f"{len(gradients)} gradients; counts must match")
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    elif len(grad_reqs) != len(variables):
        raise MXNetError(
            f"mark_variables: {len(variables)} variables but "
            f"{len(grad_reqs)} grad_reqs; counts must match")
    for var, g, req in zip(variables, gradients, grad_reqs):
        var._grad = g
        var._grad_req = req
        if req == "null":
            var.data = var.data.detach()
            VARIABLES.pop(id(var), None)
            continue
        if not (var.data.is_leaf and var.data.requires_grad):
            var.data = var.data.detach().requires_grad_(True)
        VARIABLES[id(var)] = var


def _heads_and_seeds(heads, head_grads):
    from .ndarray.ndarray import NDArray
    heads = _as_list(heads)
    head_grads = _as_list(head_grads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    if len(head_grads) != len(heads):
        raise MXNetError(
            f"backward: got {len(heads)} heads but {len(head_grads)} "
            "head gradients; counts must match")
    outs, seeds = [], []
    for h, g in zip(heads, head_grads):
        if not h.data.requires_grad:
            continue
        outs.append(h.data)
        if g is None:
            seeds.append(torch.ones_like(h.data))
        else:
            t = g.data if isinstance(g, NDArray) else torch.as_tensor(g)
            seeds.append(t.to(device=h.data.device, dtype=h.data.dtype))
    if not outs:
        raise MXNetError("cannot differentiate: outputs are not on the tape "
                         "(was this computed under autograd.record()?)")
    return outs, seeds


def _grads(outs, seeds, tensors, retain_graph, create_graph):
    with torch.enable_grad() if create_graph else contextlib.nullcontext():
        return torch.autograd.grad(outs, tensors, grad_outputs=seeds,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True, create_graph: bool = False):
    """Gradients of ``heads`` (seeded with ``head_grads``, ones by
    default) into the buffers of the variables they depend on, by each
    one's ``grad_req`` (reference `Imperative::Backward`)."""
    from .ndarray.ndarray import NDArray, VARIABLES
    outs, seeds = _heads_and_seeds(heads, head_grads)
    variables = [v for v in list(VARIABLES.values())
                 if v.data.requires_grad and v._grad_req != "null"]
    grads = _grads(outs, seeds, [v.data for v in variables],
                   retain_graph or create_graph, create_graph) \
        if variables else []
    # a deferred error on a head reaches every gradient written from it
    poison = next((h._deferred_error for h in
                   (heads if isinstance(heads, (list, tuple)) else [heads])
                   if isinstance(h, NDArray) and h._deferred_error
                   is not None), None)
    written = []
    for v, g in zip(variables, grads):
        if g is None:
            continue
        g = g.to(v._tdtype)
        if create_graph:
            # rebind: the gradient stays on the graph
            if v._grad is None:
                v._grad = NDArray(g)
            elif v._grad_req == "add":
                v._grad.data = v._grad.data + g
            else:
                v._grad.data = g
        elif v._grad is None:
            v._grad = NDArray(g.detach())
        else:
            with torch.no_grad():
                if v._grad_req == "add":
                    v._grad.data.add_(g)
                else:
                    v._grad.data.copy_(g)
        v._fresh_grad = True
        v._grad._poison(poison)
        written.append(v._grad)
    return written


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new arrays; no buffer changes (reference `autograd.grad`).  Zeros for
    a variable the heads do not depend on."""
    from .ndarray.ndarray import NDArray
    if retain_graph is None:
        retain_graph = create_graph
    variables = _as_list(variables)
    if not variables:
        raise MXNetError("grad: need at least one variable to "
                         "differentiate with respect to")
    for v in variables:
        if not v.data.requires_grad:
            raise MXNetError("grad: a variable was not marked; call "
                             "attach_grad() before record()")
    outs, seeds = _heads_and_seeds(heads, head_grads)
    grads = _grads(outs, seeds, [v.data for v in variables], retain_graph,
                   create_graph)
    return [NDArray(g.to(v._tdtype) if create_graph
                    else g.detach().to(v._tdtype))
            if g is not None else NDArray(torch.zeros_like(v.data.detach()))
            for v, g in zip(variables, grads)]


def get_symbol(x):
    """Reference `autograd.get_symbol`: lifting recorded history into a
    Symbol.  Not provided, as in the JAX package (a block's graph comes
    from the Symbol tracer, `HybridBlock.export`): raises
    `NotImplementedForSymbolError`."""
    raise NotImplementedForSymbolError()


class NotImplementedForSymbolError(MXNetError):
    """`get_symbol` is not provided (the JAX package's error)."""


class Function:
    """A user-defined differentiable op (reference `autograd.Function`):
    subclass it and write `forward` and `backward` over NDArrays.  Under
    `record` it runs as a `torch.autograd.Function`, whose backward calls
    this one's."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *out_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        func = self
        meta = {}

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                with pause(is_training()):
                    outs = func.forward(*[NDArray(t) for t in tensors])
                meta["single"] = not isinstance(outs, (list, tuple))
                outs = [outs] if meta["single"] else list(outs)
                return tuple(o.data for o in outs)

            @staticmethod
            def backward(ctx, *cts):
                with pause(is_training()):
                    g = func.backward(*[NDArray(c) for c in cts])
                g = [g] if not isinstance(g, (list, tuple)) else list(g)
                return tuple(x.data if isinstance(x, NDArray) else x
                             for x in g)

        if is_recording() and any(i.data.requires_grad for i in inputs):
            with torch.enable_grad():
                outs = _Op.apply(*[i.data for i in inputs])
            outs = [NDArray(o) for o in outs]
            return outs[0] if meta["single"] else outs
        with pause(is_training()):
            return self.forward(*inputs)
