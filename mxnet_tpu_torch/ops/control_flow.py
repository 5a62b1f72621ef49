"""Symbolic control flow: `_foreach`, `_while_loop` and `_cond` (the
counterpart of `mxnet_tpu/ops/control_flow.py`; reference
`src/operator/control_flow.cc:1255,1316,1378`).

Each node carries its body graph(s) as JSON attrs, planned once per node
of a program (`graph_compile.build_steps`, kept in the step's
``PROGRAM_STATE``, so a `Custom` op in a body belongs to that program)
and run with the JAX package's feed layout: data, states and free
variables by name.

* `_foreach` is a Python loop over the leading axis with the per-step
  outputs stacked.  Its trip count is static, so a CUDA graph records the
  whole loop.
* `_while_loop` is the JAX package's masked fixed-trip scan: it runs
  exactly ``max_iterations`` steps; a 0-d device flag ``active`` ANDs in
  the condition; state and output updates are gated with `torch.where`
  and outputs past the exit are zeros; once the loop has logically
  exited, the body's inputs are gated back to the *initial* loop
  variables, so a body that is finite only while the condition holds
  cannot poison the gradient with 0·NaN.  Nothing reads the flag on the
  host, so the loop can be captured.
* `_cond` evaluates one branch, as `lax.cond` does.  Its predicate is
  read on the host, so it cannot sit inside a CUDA graph:
  `graph_compile.uncapturable_ops` names it, and a node whose body holds
  an uncapturable op is uncapturable too (`graph_compile.graph_ops`).

On ``meta`` tensors (shape inference) `_foreach` and `_while_loop` run
their body once and stack; `_cond` runs both branches, which must agree
in count, shape and dtype (the reference demands it), and answers with
the then-branch.  Aux-state writes inside a body are not written back
(the JAX package's choice).
"""
from __future__ import annotations

import functools
import json
from typing import Dict, List, Sequence

import torch

from ..base import MXNetError
from .registry import PROGRAM_STATE, Attrs, register

__all__ = ["body_plan"]


def _build(graph_json: str):
    from ..graph_compile import build_steps
    from ..symbol.symbol import load_json
    return build_steps(load_json(graph_json))


_shape_plan = functools.lru_cache(maxsize=None)(_build)


def body_plan(attrs: Attrs, key: str, meta: bool = False):
    """The `build_steps` plan of the body graph under ``attrs[key]``: the
    program's own, built once per node (kept in ``PROGRAM_STATE``); on
    ``meta`` tensors one shared per JSON; outside a plan a new one."""
    state = attrs.get(PROGRAM_STATE)
    if state is None:
        return _shape_plan(attrs.get_str(key)) if meta else \
            _build(attrs.get_str(key))
    plan = state.get(key)
    if plan is None:
        plan = state[key] = _build(attrs.get_str(key))
    return plan


def _names(attrs: Attrs, key: str) -> List[str]:
    return json.loads(attrs.get_str(key))


def _run(attrs: Attrs, graph_key: str, feed: Dict[str, torch.Tensor],
         generator, device) -> List[torch.Tensor]:
    """One body graph's outputs on ``feed``, under the caller's grad
    mode."""
    from ..graph_compile import run_plan
    outs, _aux = run_plan(body_plan(attrs, graph_key,
                                    device.type == "meta"), feed,
                          attrs.get_bool("__train", False), generator,
                          device=device)
    return outs


def _stacked(per_step: Sequence[Sequence[torch.Tensor]], n: int,
             length: int, meta: bool) -> List[torch.Tensor]:
    """The ``n`` per-step outputs stacked along a new leading axis of
    ``length`` (on ``meta``, from the one step that ran)."""
    if meta:
        return [torch.empty((length,) + tuple(o.shape), dtype=o.dtype,
                            device="meta") for o in per_step[0][:n]]
    return [torch.stack([step[i] for step in per_step]) for i in range(n)]


def _as_meta(tensors):
    return [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in tensors]


def _pack(outs):
    outs = tuple(outs)
    return outs if len(outs) > 1 else outs[0]


def _foreach_nout(attrs: Attrs) -> int:
    return attrs.get_int("__num_out_data__") + attrs.get_int(
        "__num_states__")


@register("_foreach", num_inputs=None, input_names=None,
          num_outputs=_foreach_nout, needs_rng=True, uses_train_mode=True,
          program_state=True)
def _foreach(attrs, generator, *inputs):
    """Scan the body over dim 0 of the data inputs, carrying the states;
    the per-step outputs stacked, then the final states."""
    data_names = _names(attrs, "__data_names__")
    state_names = _names(attrs, "__state_names__")
    free_names = _names(attrs, "__free_names__")
    nd_, ns = len(data_names), len(state_names)
    if len(inputs) != nd_ + ns + len(free_names):
        raise MXNetError(
            f"_foreach: got {len(inputs)} inputs, wants "
            f"{nd_ + ns + len(free_names)}")
    data_in = inputs[:nd_]
    carry = list(inputs[nd_:nd_ + ns])
    free = dict(zip(free_names, inputs[nd_ + ns:]))
    n_out = attrs.get_int("__num_out_data__")
    device = data_in[0].device
    length = data_in[0].shape[0]
    meta = device.type == "meta" or length == 0
    if meta:
        # one step on meta tensors gives the shapes
        data_in = _as_meta(data_in)
        carry0, carry = carry, _as_meta(carry)
        free = dict(zip(free, _as_meta(free.values())))
    per_step = []
    for t in range(1 if meta else length):
        feed = dict(free)
        feed.update(zip(state_names, carry))
        feed.update(zip(data_names, (d[t] for d in data_in)))
        outs = _run(attrs, "__subgraph__", feed, generator,
                    torch.device("meta") if meta else device)
        per_step.append(outs)
        carry = list(outs[n_out:])
    ys = _stacked(per_step, n_out, length, meta)
    if meta and device.type != "meta":
        # a zero-length scan: empty outputs, the states as they came
        ys = [torch.empty(y.shape, dtype=y.dtype, device=device) for y in ys]
        carry = carry0
    return _pack(ys + carry)


def _while_nout(attrs: Attrs) -> int:
    return attrs.get_int("__num_out_data__") + attrs.get_int(
        "__num_states__")


@register("_while_loop", num_inputs=None, input_names=None,
          num_outputs=_while_nout, needs_rng=True, uses_train_mode=True,
          program_state=True)
def _while_loop(attrs, generator, *inputs):
    """The masked fixed-trip scan (the module docstring): the stacked,
    zero-padded per-step outputs, then the final loop variables."""
    var_names = _names(attrs, "__var_names__")
    cond_free = _names(attrs, "__cond_free__")
    body_free = _names(attrs, "__body_free__")
    nv = len(var_names)
    loop0 = list(inputs[:nv])
    cond_in = dict(zip(cond_free, inputs[nv:nv + len(cond_free)]))
    body_in = dict(zip(body_free, inputs[nv + len(cond_free):]))
    n_out = attrs.get_int("__num_out_data__")
    max_iter = attrs.get_int("__max_iterations__")
    device = loop0[0].device
    meta = device.type == "meta" or max_iter == 0
    if meta:
        loop0 = _as_meta(loop0)
        cond_in = dict(zip(cond_in, _as_meta(cond_in.values())))
        body_in = dict(zip(body_in, _as_meta(body_in.values())))
    run_dev = torch.device("meta") if meta else device
    lv = list(loop0)
    active = torch.ones((), dtype=torch.bool, device=run_dev)
    per_step = []
    for _ in range(1 if meta else max_iter):
        feed_c = dict(cond_in)
        feed_c.update(zip(var_names, lv))
        (c,) = _run(attrs, "__cond__", feed_c, generator, run_dev)
        act = active & (c.reshape(()) != 0)
        # after the logical exit the body still runs (static trip count):
        # it is fed the initial variables, a state it evaluates on entry
        # anyway, never the frozen terminal one
        safe = [torch.where(act, v, v0.to(v.dtype))
                for v, v0 in zip(lv, loop0)]
        feed_b = dict(body_in)
        feed_b.update(zip(var_names, safe))
        outs = _run(attrs, "__body__", feed_b, generator, run_dev)
        lv = [torch.where(act, n.to(o.dtype), o)
              for n, o in zip(outs[n_out:], lv)]
        per_step.append([torch.where(act, o, torch.zeros_like(o))
                         for o in outs[:n_out]])
        active = act
    ys = _stacked(per_step, n_out, max_iter, meta)
    if meta and device.type != "meta":
        ys = [torch.zeros(y.shape, dtype=y.dtype, device=device) for y in ys]
        lv = list(inputs[:nv])
    return _pack(ys + lv)


def _cond_nout(attrs: Attrs) -> int:
    return attrs.get_int("__num_outputs__")


@register("_cond", num_inputs=None, input_names=None,
          num_outputs=_cond_nout, needs_rng=True, uses_train_mode=True,
          program_state=True)
def _cond(attrs, generator, *inputs):
    """The then-branch's outputs where the predicate is nonzero, else the
    else-branch's; only the branch taken runs."""
    then_free = _names(attrs, "__then_free__")
    else_free = _names(attrs, "__else_free__")
    pred = inputs[0]
    then_in = dict(zip(then_free, inputs[1:1 + len(then_free)]))
    else_in = dict(zip(else_free, inputs[1 + len(then_free):]))
    device = pred.device
    if device.type == "meta":
        t = _run(attrs, "__then__", then_in, generator, device)
        e = _run(attrs, "__else__", else_in, generator, device)
        if [(o.shape, o.dtype) for o in t] != \
                [(o.shape, o.dtype) for o in e]:
            raise MXNetError(
                "cond: the branches' outputs differ in shape or dtype: "
                f"then {[(tuple(o.shape), o.dtype) for o in t]}, else "
                f"{[(tuple(o.shape), o.dtype) for o in e]}")
        return _pack(t)
    if bool(pred.reshape(()) != 0):
        return _pack(_run(attrs, "__then__", then_in, generator, device))
    return _pack(_run(attrs, "__else__", else_in, generator, device))
