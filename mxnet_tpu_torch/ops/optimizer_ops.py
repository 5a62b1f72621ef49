"""Optimizer update ops (the counterparts of every op of
`mxnet_tpu/ops/optimizer_ops.py`; reference `src/operator/optimizer_op.cc`,
`contrib/adamw.cc`, `contrib/optimizer_op.cc`).

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

The updates that select per element are written on one weight with the
plain tensor ops only: `apply_multi` runs `ftrl_update` weight by weight,
and `ftml_update`, the AdamW pair and `_contrib_group_adagrad_update`
have no list form.

The registered ops keep MXNet's contract: the weight input is left as it
was and the new weight is returned (callers pass ``out=weight`` to update
it), while the state inputs (momentum, Adam's mean and var, a master
copy) are updated in place (MXNet's FMutateInputs).  The ``mp_`` forms
take a float32 master copy of a narrower weight: the update runs on the
master, which is then rounded into the new weight.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import torch

from .registry import alias, register

__all__ = ["apply_multi", "MULTI_UPDATES"]

Scalar = Union[float, torch.Tensor]


def _list_mul(ts, s):
    """``ts * s``.  A 0-d float32 tensor ``s`` (a captured step's lr or
    wd) times a narrower list goes through float32: a Python scalar
    multiplies a bfloat16 or float16 tensor in float32 with one rounding,
    where the card casts a device scalar to the list's dtype first."""
    if isinstance(s, torch.Tensor) and ts and \
            ts[0].element_size() < s.element_size():
        return [t.to(ts[0].dtype)
                for t in torch._foreach_mul([t.float() for t in ts], s)]
    return torch._foreach_mul(ts, s)


def _list_mul_(ts, s):
    """``ts *= s``.  The CPU's in-place list form rounds a Python scalar
    to a narrow list's dtype before it multiplies, where ``t.mul_(s)``
    and the out-of-place list form multiply in float32: a narrow list
    takes the out-of-place form."""
    if ts and ts[0].element_size() < 4:
        torch._foreach_copy_(ts, _list_mul(ts, s))
    else:
        torch._foreach_mul_(ts, s)


class _Lists:
    """An update's arithmetic over lists of tensors: ``torch._foreach_*``,
    a few launches for a whole group."""
    mul = staticmethod(_list_mul)
    mul_ = staticmethod(_list_mul_)
    add = staticmethod(torch._foreach_add)
    add_ = staticmethod(torch._foreach_add_)
    sub_ = staticmethod(torch._foreach_sub_)
    addcmul_ = staticmethod(torch._foreach_addcmul_)
    addcdiv_ = staticmethod(torch._foreach_addcdiv_)
    sqrt = staticmethod(torch._foreach_sqrt)
    div = staticmethod(torch._foreach_div)
    clamp_min_ = staticmethod(torch._foreach_clamp_min_)
    clamp_max_ = staticmethod(torch._foreach_clamp_max_)
    sign = staticmethod(torch._foreach_sign)
    copy_ = staticmethod(torch._foreach_copy_)


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
    sign = staticmethod(lambda ts: [ts[0].sign()])
    copy_ = staticmethod(lambda ts, o: ts[0].copy_(o[0]))


def _common(attrs):
    return (attrs.get_float("lr"), attrs.get_float("wd", 0.0),
            attrs.get_float("rescale_grad", 1.0),
            attrs.get_float("clip_gradient", -1.0))


def _prepped(ops, ws, gs, rescale, clip):
    """rescale·g, clipped to ±clip (in w's dtype)."""
    g = ops.mul([x.to(w.dtype) for x, w in zip(gs, ws)], rescale)
    if clip is not None and clip > 0:
        ops.clamp_min_(g, -clip)
        ops.clamp_max_(g, clip)
    return g


def _grads(ops, ws, gs, wd: Scalar, rescale, clip):
    """rescale·g, clipped to ±clip, plus wd·w (in w's dtype)."""
    return ops.add(_prepped(ops, ws, gs, rescale, clip), ops.mul(ws, wd))


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
    g = _prepped(ops, ws, gs, rescale, clip)
    ops.addcmul_(hist, g, g, value=1.0)
    step = ops.add(ops.div(g, ops.sqrt(ops.add(hist, eps))),
                   ops.mul(ws, wd))
    ops.sub_(ws, ops.mul(step, lr))


def _nag_mom(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """mom = momentum·mom + g'; w -= lr·(g' + momentum·mom), g' = g +
    wd·w (Nesterov's look-ahead)."""
    (moms,) = states
    momentum = float(static.get("momentum", 0.0))
    d = _grads(ops, ws, gs, wd, rescale, clip)
    ops.mul_(moms, momentum)
    ops.add_(moms, d)
    ops.sub_(ws, ops.mul(ops.add(d, ops.mul(moms, momentum)), lr))


def _rmsprop(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """n = γ1·n + (1-γ1)·g'²; w -= lr·g' / sqrt(n + eps) (Tieleman and
    Hinton's RMSProp)."""
    (ns,) = states
    g1 = float(static.get("gamma1", 0.95))
    eps = float(static.get("epsilon", 1e-8))
    d = _grads(ops, ws, gs, wd, rescale, clip)
    ops.mul_(ns, g1)
    ops.addcmul_(ns, d, d, value=1 - g1)
    ops.addcdiv_(ws, ops.mul(d, lr), ops.sqrt(ops.add(ns, eps)), value=-1.0)


def _rmspropalex(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """Graves' centered RMSProp: n and the mean gradient gbar decay by γ1,
    delta = γ2·delta - lr·g' / sqrt(n - gbar² + eps); w += delta."""
    ns, gbars, deltas = states
    g1 = float(static.get("gamma1", 0.95))
    g2 = float(static.get("gamma2", 0.9))
    eps = float(static.get("epsilon", 1e-8))
    d = _grads(ops, ws, gs, wd, rescale, clip)
    ops.mul_(ns, g1)
    ops.addcmul_(ns, d, d, value=1 - g1)
    ops.mul_(gbars, g1)
    ops.add_(gbars, d, alpha=1 - g1)
    var = ops.add(ns, eps)
    ops.addcmul_(var, gbars, gbars, value=-1.0)
    ops.mul_(deltas, g2)
    ops.addcdiv_(deltas, ops.mul(d, lr), ops.sqrt(var), value=-1.0)
    ops.add_(ws, deltas)


def _signsgd(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """w -= lr·(sign(g) + wd·w)."""
    step = ops.add(ops.sign(_prepped(ops, ws, gs, rescale, clip)),
                   ops.mul(ws, wd))
    ops.sub_(ws, ops.mul(step, lr))


def _signum(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """mom = momentum·mom - (1-momentum)·(g + wd·w); w = (1 - lr·wd_lh)·w
    + lr·sign(mom)."""
    (moms,) = states
    momentum = float(static.get("momentum", 0.0))
    wd_lh = float(static.get("wd_lh", 0.0))
    d = _grads(ops, ws, gs, wd, rescale, clip)
    ops.mul_(moms, momentum)
    ops.add_(moms, d, alpha=-(1 - momentum))
    if wd_lh:
        ops.mul_(ws, 1 - lr * wd_lh)
    ops.add_(ws, ops.mul(ops.sign(moms), lr))


def _mp_sgd(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """`_sgd` on the float32 master copies, rounded into the weights."""
    (w32s,) = states
    _sgd(ops, w32s, gs, [], lr, wd, rescale, clip, static)
    ops.copy_(ws, w32s)


def _mp_sgd_mom(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """`_sgd_mom` on the float32 master copies, rounded into the
    weights."""
    moms, w32s = states
    _sgd_mom(ops, w32s, gs, [moms], lr, wd, rescale, clip, static)
    ops.copy_(ws, w32s)


def _prep_one(grad, dtype, rescale, clip):
    g = grad.to(dtype) * rescale
    return g.clamp(-clip, clip) if clip is not None and clip > 0 else g


def _div(x: torch.Tensor, s: Scalar) -> torch.Tensor:
    """``x / s``, the same bits for a Python float ``s`` and for a 0-d
    float32 tensor (a captured step's lr): a true division, in float32
    for a narrower ``x``.  The card divides by a Python scalar through its
    rounded reciprocal, and casts a device scalar to a narrow ``x``'s
    dtype first."""
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(s, device=x.device,
                         dtype=torch.float64 if x.dtype == torch.float64
                         else torch.float32)
    if x.element_size() < s.element_size():
        return (x.float() / s).to(x.dtype)
    return x / s


def _ftrl(ops, ws, gs, states, lr, wd, rescale, clip, static):
    """FTRL-Proximal (McMahan et al.), weight by weight: z and n
    accumulate, and a weight whose |z| stays within lamda1 is zero."""
    lamda1 = float(static.get("lamda1", 0.01))
    beta = float(static.get("beta", 1.0))
    for w, grad, z, n in zip(ws, gs, *states):
        g = _prep_one(grad, w.dtype, rescale, clip)
        new_n = n + g * g
        sigma = _div(new_n.sqrt() - n.sqrt(), lr)
        new_z = z + g - sigma * w
        w.copy_(torch.where(
            new_z.abs() <= lamda1, torch.zeros_like(w),
            -(new_z - new_z.sign() * lamda1)
            / (_div(beta + new_n.sqrt(), lr) + wd)))
        z.copy_(new_z)
        n.copy_(new_n)


#: op name -> its update ``fn(ops, ws, gs, state lists, lr, wd, rescale,
#: clip, static attrs)``
MULTI_UPDATES: Dict[str, Callable] = {
    "sgd_update": _sgd,
    "sgd_mom_update": _sgd_mom,
    "adam_update": _adam,
    "adagrad_update": _adagrad,
    "nag_mom_update": _nag_mom,
    "rmsprop_update": _rmsprop,
    "rmspropalex_update": _rmspropalex,
    "signsgd_update": _signsgd,
    "signum_update": _signum,
    "mp_sgd_update": _mp_sgd,
    "mp_sgd_mom_update": _mp_sgd_mom,
    "ftrl_update": _ftrl,
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


@register("nag_mom_update", num_inputs=3,
          input_names=["weight", "grad", "mom"], mutate_inputs=(2,))
def nag_mom_update(attrs, weight, grad, mom):
    return _single("nag_mom_update", attrs, weight, grad, [mom])


@register("rmsprop_update", num_inputs=3,
          input_names=["weight", "grad", "n"], mutate_inputs=(2,))
def rmsprop_update(attrs, weight, grad, n):
    return _single("rmsprop_update", attrs, weight, grad, [n])


@register("rmspropalex_update", num_inputs=5,
          input_names=["weight", "grad", "n", "g", "delta"],
          mutate_inputs=(2, 3, 4))
def rmspropalex_update(attrs, weight, grad, n, g, delta):
    return _single("rmspropalex_update", attrs, weight, grad, [n, g, delta])


@register("signsgd_update", num_inputs=2, input_names=["weight", "grad"])
def signsgd_update(attrs, weight, grad):
    return _single("signsgd_update", attrs, weight, grad, [])


@register("signum_update", num_inputs=3,
          input_names=["weight", "grad", "mom"], mutate_inputs=(2,))
def signum_update(attrs, weight, grad, mom):
    return _single("signum_update", attrs, weight, grad, [mom])


@register("mp_sgd_update", num_inputs=3,
          input_names=["weight", "grad", "weight32"], mutate_inputs=(2,))
def mp_sgd_update(attrs, weight, grad, weight32):
    """Multi-precision SGD: the update on the float32 ``weight32``."""
    return _single("mp_sgd_update", attrs, weight, grad, [weight32])


@register("mp_sgd_mom_update", num_inputs=4,
          input_names=["weight", "grad", "mom", "weight32"],
          mutate_inputs=(2, 3))
def mp_sgd_mom_update(attrs, weight, grad, mom, weight32):
    return _single("mp_sgd_mom_update", attrs, weight, grad,
                   [mom, weight32])


@register("multi_mp_sgd_update", num_inputs=None,
          num_outputs=_multi_outputs)
def multi_mp_sgd_update(attrs, *tensors):
    """Reference `multi_mp_sgd_update`: [w0, g0, w32_0, ...]; the master
    copies update in place."""
    return _multi("mp_sgd_update", attrs, tensors, 3)


@register("multi_mp_sgd_mom_update", num_inputs=None,
          num_outputs=_multi_outputs)
def multi_mp_sgd_mom_update(attrs, *tensors):
    """Reference `multi_mp_sgd_mom_update`: [w0, g0, m0, w32_0, ...]."""
    return _multi("mp_sgd_mom_update", attrs, tensors, 4)


@register("multi_sum_sq", num_inputs=None)
def multi_sum_sq(attrs, *arrays):
    """Each array's sum of squares, in float32 (LARS's norms)."""
    return torch.stack([a.float().square().sum() for a in arrays])


@register("ftrl_update", num_inputs=4,
          input_names=["weight", "grad", "z", "n"], mutate_inputs=(2, 3))
def ftrl_update(attrs, weight, grad, z, n):
    """FTRL-Proximal (McMahan et al.): z and n accumulate, and a weight
    whose |z| stays within lamda1 is zero."""
    return _single("ftrl_update", attrs, weight, grad, [z, n])


@register("ftml_update", num_inputs=5,
          input_names=["weight", "grad", "d", "v", "z"],
          mutate_inputs=(2, 3, 4))
@torch.no_grad()
def ftml_update(attrs, weight, grad, d, v, z):
    """FTML (Zheng and Kwok) at step ``t``; ``clip_grad`` clips (the
    reference's name), else ``clip_gradient``."""
    lr, wd, rescale, clip = _common(attrs)
    t = attrs.get_int("t", 1)
    b1 = attrs.get_float("beta1", 0.6)
    b2 = attrs.get_float("beta2", 0.999)
    eps = attrs.get_float("epsilon", 1e-8)
    clip = attrs.get_float("clip_grad", clip if clip else -1.0)
    g = _prep_one(grad, weight.dtype, rescale, clip) + wd * weight
    v_new = b2 * v + (1 - b2) * g * g
    d_new = (1 - b1 ** t) / lr * ((v_new / (1 - b2 ** t)).sqrt() + eps)
    sigma = d_new - b1 * d
    z_new = b1 * z + (1 - b1) * g - sigma * weight
    d.copy_(d_new)
    v.copy_(v_new)
    z.copy_(z_new)
    return -z_new / d_new


def _adamw(attrs, weight, grad, mean, var, rescale_grad):
    """AdamW's new float32 weight; mean and var update in place.  A scale
    that is not finite, or 0, skips the update."""
    lr = attrs.get_float("lr")
    eta = attrs.get_float("eta", 1.0)
    wd = attrs.get_float("wd", 0.0)
    b1 = attrs.get_float("beta1", 0.9)
    b2 = attrs.get_float("beta2", 0.999)
    eps = attrs.get_float("epsilon", 1e-8)
    clip = attrs.get_float("clip_gradient", -1.0)
    scale = rescale_grad.reshape(()).float()
    ok = torch.isfinite(scale) & (scale != 0)
    g = grad.float() * torch.where(ok, scale, torch.zeros_like(scale))
    if clip > 0:
        g = g.clamp(-clip, clip)
    m_new = b1 * mean + (1 - b1) * g
    v_new = b2 * var + (1 - b2) * g * g
    upd = eta * (lr * m_new / (v_new.sqrt() + eps) + wd * weight)
    mean.copy_(torch.where(ok, m_new, mean))
    var.copy_(torch.where(ok, v_new, var))
    return torch.where(ok, weight - upd, weight)


@register("_adamw_update", num_inputs=5,
          input_names=["weight", "grad", "mean", "var", "rescale_grad"],
          mutate_inputs=(2, 3))
@torch.no_grad()
def adamw_update(attrs, weight, grad, mean, var, rescale_grad):
    """Reference `_adamw_update` (`contrib/adamw.cc`): Adam with weight
    decay decoupled from the gradient, ``rescale_grad`` a tensor."""
    return _adamw(attrs, weight, grad, mean, var,
                  rescale_grad).to(weight.dtype)


@register("_mp_adamw_update", num_inputs=6,
          input_names=["weight", "grad", "mean", "var", "weight32",
                       "rescale_grad"], mutate_inputs=(2, 3, 4))
@torch.no_grad()
def mp_adamw_update(attrs, weight, grad, mean, var, weight32, rescale_grad):
    """AdamW on the float32 master copy, rounded into the weight."""
    new32 = _adamw(attrs, weight32, grad, mean, var, rescale_grad)
    weight32.copy_(new32)
    return new32.to(weight.dtype)


@register("_contrib_group_adagrad_update", num_inputs=3,
          input_names=["weight", "grad", "history"], mutate_inputs=(2,))
@torch.no_grad()
def group_adagrad_update(attrs, weight, grad, history):
    """AdaGrad with one accumulator per row: history += mean(g², rows);
    w -= lr·g / sqrt(history + eps) (reference `contrib/optimizer_op.cc`)."""
    lr = attrs.get_float("lr")
    rescale = attrs.get_float("rescale_grad", 1.0)
    clip = attrs.get_float("clip_gradient", -1.0)
    eps = attrs.get_float("epsilon", 1e-5)
    g = _prep_one(grad, weight.dtype, rescale, clip)
    if g.dim() > 1:
        h_new = history + (g * g).mean(dim=tuple(range(1, g.dim()))) \
            .reshape(history.shape)
    else:
        h_new = history + g * g
    history.copy_(h_new)
    bshape = (-1,) + (1,) * (g.dim() - 1)
    return weight - lr * g / (h_new.reshape(bshape) + eps).sqrt()


alias("_contrib_group_adagrad_update", "group_adagrad_update")
alias("_adamw_update", "_contrib_adamw_update")
alias("_mp_adamw_update", "_contrib_mp_adamw_update")
