"""Optimizer update ops (the counterparts of `sgd_update`, `sgd_mom_update`,
`adam_update`, `adagrad_update` (alias `_sparse_adagrad_update`),
`multi_sgd_update` and `multi_sgd_mom_update` in
`mxnet_tpu/ops/optimizer_ops.py`; reference `src/operator/optimizer_op.cc`).

Each update is written once, over lists of tensors and a set of list
ops: `apply_multi` runs it with ``torch._foreach_*`` on a whole group of
weights that share the op, its static hyperparameters and their dtype,
in a few launches for the group (the JAX package computes these updates
in XLA, outside any Pallas kernel, so PyTorch's multi-tensor ops are
their counterpart here), and the registered op on one weight with the
plain tensor ops.  Static hyperparameters ride the fused ``alpha`` and
``value`` forms.  The per-step
scalars ``lr`` and ``wd`` may be Python floats or 0-dim tensors on the
weights' device (a captured step rewrites those before each replay); on
the CPU both give the same bits.  `apply_multi` updates weights and
states in place under `torch.no_grad()`; the gradient is prepared in the
reference's order: rescale, then clip, then add ``wd·w``.

The registered ops keep MXNet's contract: the weight input is left as it
was and the new weight is returned (callers pass ``out=weight`` to update
it), while the state inputs (momentum, Adam's mean and var) are updated
in place (MXNet's FMutateInputs).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import torch

from .registry import alias, register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "adagrad_update",
           "multi_sgd_update", "multi_sgd_mom_update", "apply_multi",
           "MULTI_UPDATES"]

Scalar = Union[float, torch.Tensor]


class _Lists:
    """An update's arithmetic over lists of tensors: ``torch._foreach_*``,
    a few launches for a whole group."""
    mul = staticmethod(torch._foreach_mul)
    mul_ = staticmethod(torch._foreach_mul_)
    add = staticmethod(torch._foreach_add)
    add_ = staticmethod(torch._foreach_add_)
    sub_ = staticmethod(torch._foreach_sub_)
    addcmul_ = staticmethod(torch._foreach_addcmul_)
    addcdiv_ = staticmethod(torch._foreach_addcdiv_)
    sqrt = staticmethod(torch._foreach_sqrt)
    div = staticmethod(torch._foreach_div)
    clamp_min_ = staticmethod(torch._foreach_clamp_min_)
    clamp_max_ = staticmethod(torch._foreach_clamp_max_)


def _x(other):
    return other[0] if isinstance(other, list) else other


class _One:
    """The same arithmetic over a one-tensor list by the plain tensor ops,
    which a single weight's update takes (one launch each, without the
    multi-tensor launch's setup).  On the CPU the multi-tensor ops run
    these very ops, so both give the same bits."""
    mul = staticmethod(lambda ts, s: [ts[0] * s])
    mul_ = staticmethod(lambda ts, s: ts[0].mul_(s))
    add = staticmethod(lambda ts, o: [ts[0] + _x(o)])
    add_ = staticmethod(lambda ts, o, alpha=1: ts[0].add_(o[0], alpha=alpha))
    sub_ = staticmethod(lambda ts, o: ts[0].sub_(o[0]))
    addcmul_ = staticmethod(
        lambda ts, a, b, value: ts[0].addcmul_(a[0], b[0], value=value))
    addcdiv_ = staticmethod(
        lambda ts, a, b, value: ts[0].addcdiv_(a[0], b[0], value=value))
    sqrt = staticmethod(lambda ts: [ts[0].sqrt()])
    div = staticmethod(lambda ts, o: [ts[0] / o[0]])
    clamp_min_ = staticmethod(lambda ts, v: ts[0].clamp_min_(v))
    clamp_max_ = staticmethod(lambda ts, v: ts[0].clamp_max_(v))


def _common(attrs):
    return (attrs.get_float("lr"), attrs.get_float("wd", 0.0),
            attrs.get_float("rescale_grad", 1.0),
            attrs.get_float("clip_gradient", -1.0))


def _grads(ops, ws, gs, wd: Scalar, rescale, clip):
    """rescale·g, clipped to ±clip, plus wd·w (in w's dtype)."""
    g = ops.mul([x.to(w.dtype) for x, w in zip(gs, ws)], rescale)
    if clip is not None and clip > 0:
        ops.clamp_min_(g, -clip)
        ops.clamp_max_(g, clip)
    return ops.add(g, ops.mul(ws, wd))


def _sgd(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """w -= lr·(g + wd·w)."""
    ops.sub_(ws, ops.mul(_grads(ops, ws, gs, wd, rescale, clip), lr))


def _sgd_mom(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """mom = momentum·mom - lr·(g + wd·w); w += mom."""
    (moms,) = states
    d = _grads(ops, ws, gs, wd, rescale, clip)
    ops.mul_(moms, float(static.get("momentum", 0.0)))
    ops.sub_(moms, ops.mul(d, lr))
    ops.add_(ws, moms)


def _adam(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """Adam with the bias correction folded into lr by the caller; wd
    joins the gradient after clipping (MXNet's L2 form)."""
    means, vars_ = states
    b1 = float(static.get("beta1", 0.9))
    b2 = float(static.get("beta2", 0.999))
    eps = float(static.get("epsilon", 1e-8))
    g = _grads(ops, ws, gs, wd, rescale, clip)
    ops.mul_(means, b1)
    ops.add_(means, g, alpha=1 - b1)
    ops.mul_(vars_, b2)
    ops.addcmul_(vars_, g, g, value=1 - b2)
    denom = ops.add(ops.sqrt(vars_), eps)
    ops.addcdiv_(ws, ops.mul(means, lr), denom, value=-1.0)


def _adagrad(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """history += g²; w -= lr·(g / sqrt(history + eps) + wd·w), the
    gradient rescaled and clipped first (the JAX package's
    `adagrad_update`: wd stays out of the history)."""
    (hist,) = states
    eps = float(static.get("epsilon", 1e-7))
    g = _grads(ops, ws, gs, 0.0, rescale, clip)
    ops.addcmul_(hist, g, g, value=1.0)
    step = ops.add(ops.div(g, ops.sqrt(ops.add(hist, eps))),
                   ops.mul(ws, wd))
    ops.sub_(ws, ops.mul(step, lr))


#: op name -> its update ``fn(ops, ws, gs, state lists, lr, wd, rescale,
#: clip, static attrs)``
MULTI_UPDATES: Dict[str, Callable] = {
    "sgd_update": _sgd,
    "sgd_mom_update": _sgd_mom,
    "adam_update": _adam,
    "adagrad_update": _adagrad,
}


@torch.no_grad()
def apply_multi(op_name: str, static: Dict, ws: Sequence[torch.Tensor],
                gs: Sequence[torch.Tensor],
                states: Sequence[Sequence[torch.Tensor]], lr: Scalar,
                wd: Scalar, rescale: float, clip, ops=_Lists) -> None:
    """Update op ``op_name`` over a group of weights in place: ``states``
    holds one list per state slot (momentum; Adam's mean and var), in the
    op's input order; ``lr`` and ``wd`` are the group's."""
    MULTI_UPDATES[op_name](ops, list(ws), list(gs),
                           [list(s) for s in states], lr, wd, rescale,
                           clip, static)


def _single(op_name, attrs, weight, grad, states: List[torch.Tensor]):
    """The new weight (the input stays as it was); ``states`` update in
    place."""
    lr, wd, rescale, clip = _common(attrs)
    new = weight.detach().clone()
    apply_multi(op_name, attrs, [new], [grad], [[s] for s in states],
                lr, wd, rescale, clip, ops=_One)
    return new


@register("sgd_update", num_inputs=2, input_names=["weight", "grad"])
def sgd_update(attrs, weight, grad):
    return _single("sgd_update", attrs, weight, grad, [])


@register("sgd_mom_update", num_inputs=3,
          input_names=["weight", "grad", "mom"], mutate_inputs=(2,))
def sgd_mom_update(attrs, weight, grad, mom):
    return _single("sgd_mom_update", attrs, weight, grad, [mom])


@register("adam_update", num_inputs=4,
          input_names=["weight", "grad", "mean", "var"],
          mutate_inputs=(2, 3))
def adam_update(attrs, weight, grad, mean, var):
    return _single("adam_update", attrs, weight, grad, [mean, var])


@register("adagrad_update", num_inputs=3,
          input_names=["weight", "grad", "history"], mutate_inputs=(2,))
def adagrad_update(attrs, weight, grad, history):
    return _single("adagrad_update", attrs, weight, grad, [history])


alias("adagrad_update", "_sparse_adagrad_update")


def _multi(op_name, attrs, tensors, per):
    """The reference's multi-weight form: inputs interleaved per weight
    (``per`` tensors each: weight, grad, then states), ``lrs`` and ``wds``
    one per weight.  Returns the new weights; states update in place.
    Weights sharing (lr, wd) update as one `apply_multi` group."""
    n = attrs.get_int("num_weights", len(tensors) // per)
    lrs = [float(v) for v in attrs.get_tuple("lrs")][:n]
    wds = [float(v) for v in attrs.get_tuple("wds")][:n]
    rescale = attrs.get_float("rescale_grad", 1.0)
    clip = attrs.get_float("clip_gradient", -1.0)
    news = [tensors[per * i].detach().clone() for i in range(n)]
    groups: Dict[tuple, List[int]] = {}
    for i in range(n):
        groups.setdefault((lrs[i], wds[i]), []).append(i)
    for (lr, wd), idx in groups.items():
        apply_multi(op_name, attrs, [news[i] for i in idx],
                    [tensors[per * i + 1] for i in idx],
                    [[tensors[per * i + k] for i in idx]
                     for k in range(2, per)], lr, wd, rescale, clip)
    return tuple(news)


def _multi_outputs(attrs):
    return attrs.get_int("num_weights", 1)


@register("multi_sgd_update", num_inputs=None, num_outputs=_multi_outputs)
def multi_sgd_update(attrs, *tensors):
    """Reference `multi_sgd_update`: [w0, g0, w1, g1, ...]."""
    return _multi("sgd_update", attrs, tensors, 2)


@register("multi_sgd_mom_update", num_inputs=None,
          num_outputs=_multi_outputs)
def multi_sgd_mom_update(attrs, *tensors):
    """Reference `multi_sgd_mom_update`: [w0, g0, m0, ...]; the momenta
    update in place."""
    return _multi("sgd_mom_update", attrs, tensors, 3)
