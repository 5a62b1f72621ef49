"""`mx.nd.contrib` (the counterpart of `mxnet_tpu/ndarray/contrib.py`;
reference `python/mxnet/ndarray/contrib.py`): the ``_contrib_*`` ops the
port registers under their short names, the imperative control flow and a
few helpers.

Imperative control flow runs as host loops, as in the reference's
imperative fallback: `foreach` loops over dim 0 and stacks the outputs;
`while_loop` reads its condition on the host each step, stops with
``break`` and zero-pads the stacked outputs to ``max_iterations``; `cond`
reads its predicate and runs one branch.  Under `autograd.record` every
op lands on the tape, so gradients flow through the loop.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError
from ..cached_op import note_host_op
from .ndarray import NDArray
from .register import invoke

__all__ = ["foreach", "while_loop", "cond", "boolean_mask", "isinf",
           "isnan", "isfinite", "rand_zipfian"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _stack(slot):
    return invoke("stack", *slot, axis=0, num_args=len(slot))


def foreach(body: Callable, data, init_states):
    """Scan `body(item, states) -> (out, new_states)` over dim 0
    (reference `control_flow.cc:1255 _foreach`)."""
    states = _as_list(init_states)
    single_state = not isinstance(init_states, (list, tuple))
    data_list = _as_list(data)
    single_data = not isinstance(data, (list, tuple))
    outputs = None
    for i in range(data_list[0].shape[0]):
        items = [d[i] for d in data_list]
        out, states = body(items[0] if single_data else items,
                           states[0] if single_state else states)
        states = _as_list(states)
        out = _as_list(out)
        if outputs is None:
            outputs = [[] for _ in out]
        for slot, o in zip(outputs, out):
            slot.append(o)
    stacked = [_stack(slot) for slot in (outputs or [])]
    out_val = stacked[0] if len(stacked) == 1 else stacked
    return out_val, (states[0] if single_state else states)


def while_loop(cond_fn: Callable, func: Callable, loop_vars,
               max_iterations: int = None):
    """Reference `control_flow.cc:1316 _while_loop`: run `func` while
    `cond_fn` holds; the outputs of each step are stacked and padded with
    zeros to ``max_iterations`` (the reference's static output shape).
    ``loop_vars`` are unpacked into both (``cond(*loop_vars)``)."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    note_host_op("_while_loop")
    single = not isinstance(loop_vars, (list, tuple))
    vs = _as_list(loop_vars)
    outputs = None
    steps = 0
    while steps < max_iterations:
        c = cond_fn(*vs)
        if not bool(c.asscalar() if isinstance(c, NDArray) else c):
            break
        out, vs_new = func(*vs)
        vs = _as_list(vs_new)
        out = _as_list(out)
        if outputs is None:
            outputs = [[] for _ in out]
        for slot, o in zip(outputs, out):
            slot.append(o)
        steps += 1
    stacked = []
    for slot in (outputs or []):
        arr = _stack(slot)
        if steps < max_iterations:
            pad = torch.zeros((max_iterations - steps,) + arr.shape[1:],
                              dtype=arr._tdtype, device=arr.data.device)
            arr = invoke("Concat", arr, NDArray(pad), dim=0, num_args=2)
        stacked.append(arr)
    out_val = (stacked[0] if len(stacked) == 1 else stacked) \
        if stacked else []
    return out_val, (vs[0] if single else vs)


def cond(pred, then_func: Callable, else_func: Callable):
    """Reference `control_flow.cc:1378 _cond`: the predicate is read on
    the host and one branch runs."""
    note_host_op("_cond")
    p = bool(pred.asscalar() if isinstance(pred, NDArray) else pred)
    return then_func() if p else else_func()


def boolean_mask(data: NDArray, index: NDArray, axis: int = 0):
    """Reference `contrib/boolean_mask.cc`: the slices of ``data`` along
    ``axis`` where ``index`` is nonzero (its shape depends on the data,
    so the mask is read on the host)."""
    keep = np.nonzero(np.asarray(index.asnumpy(), bool))[0]
    idx = torch.as_tensor(keep, dtype=torch.int64, device=data.data.device)
    with autograd.grad_mode():
        return NDArray(torch.index_select(data.data, axis, idx))


def _float_of(fn, data):
    return NDArray(fn(data.data).to(torch.float32))


def isinf(data):
    return _float_of(torch.isinf, data)


def isnan(data):
    return _float_of(torch.isnan, data)


def isfinite(data):
    return _float_of(torch.isfinite, data)


def rand_zipfian(true_classes, num_sampled, range_max, ctx=None):
    """Candidate sampling from the approximate log-uniform (Zipfian)
    distribution P(c) = (log(c+2) - log(c+1)) / log(range_max+1),
    reference `python/mxnet/ndarray/contrib.py:35`.  Returns (samples,
    expected_count_true, expected_count_sampled), int32 and float32 as
    the JAX package gives them."""
    import math
    from . import random as _random
    if ctx is None:
        ctx = true_classes.context
    log_range = math.log(range_max + 1)
    draws = _random.uniform(0, log_range, shape=(num_sampled,), ctx=ctx)
    samples = (invoke("exp", draws) - 1).astype("int32") % range_max

    def expected_count(classes_f):
        upper = invoke("log", (classes_f + 2.0) / (classes_f + 1.0))
        return upper * (num_sampled / log_range)

    exp_true = expected_count(true_classes.astype("float32"))
    exp_sampled = expected_count(samples.astype("float32"))
    return samples, exp_true, exp_sampled


def _attach_contrib_ops():
    """The ``_contrib_*`` registry ops under their short names
    (``nd.contrib.ctc_loss`` is ``_contrib_ctc_loss``)."""
    from ..ops import registry as _reg
    g = globals()
    for name in _reg.list_ops():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if short not in g:
                def f(*args, _n=name, **kwargs):
                    return invoke(_n, *args, **kwargs)
                f.__name__ = short
                f.__doc__ = _reg.get_op(name).doc
                g[short] = f


_attach_contrib_ops()
