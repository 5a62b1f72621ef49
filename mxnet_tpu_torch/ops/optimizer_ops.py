"""Optimizer update ops (the counterparts of `sgd_update`, `sgd_mom_update`
and `adam_update` in `mxnet_tpu/ops/optimizer_ops.py`; reference
`src/operator/optimizer_op.cc`).

Each op updates its weight and states in place under `torch.no_grad()`
and returns the new weight, as MXNet's ``out=weight`` calls do.  The JAX
package computes these in XLA, outside any Pallas kernel, so plain
in-place torch is their counterpart here.  The gradient is prepared in
the reference's order: rescale, then clip, then add ``wd·w``.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _common(attrs):
    return (attrs.get_float("lr"), attrs.get_float("wd", 0.0),
            attrs.get_float("rescale_grad", 1.0),
            attrs.get_float("clip_gradient", -1.0))


def _prep_grad(grad, rescale, clip, dtype):
    g = grad.to(dtype) * rescale
    if clip is not None and clip > 0:
        g = g.clamp_(-clip, clip)
    return g


@register("sgd_update", num_inputs=2, input_names=["weight", "grad"])
@torch.no_grad()
def sgd_update(attrs, weight, grad):
    """w -= lr·(g + wd·w)."""
    lr, wd, rescale, clip = _common(attrs)
    g = _prep_grad(grad, rescale, clip, weight.dtype)
    return weight.sub_(lr * (g + wd * weight))


@register("sgd_mom_update", num_inputs=3,
          input_names=["weight", "grad", "mom"], mutate_inputs=(2,))
@torch.no_grad()
def sgd_mom_update(attrs, weight, grad, mom):
    """mom = momentum·mom - lr·(g + wd·w); w += mom."""
    lr, wd, rescale, clip = _common(attrs)
    momentum = attrs.get_float("momentum", 0.0)
    g = _prep_grad(grad, rescale, clip, weight.dtype)
    mom.mul_(momentum).sub_(lr * (g + wd * weight))
    return weight.add_(mom)


@register("adam_update", num_inputs=4,
          input_names=["weight", "grad", "mean", "var"],
          mutate_inputs=(2, 3))
@torch.no_grad()
def adam_update(attrs, weight, grad, mean, var):
    """Adam with the bias correction folded into lr by the caller; wd
    joins the gradient after clipping (MXNet's L2 form)."""
    lr, wd, rescale, clip = _common(attrs)
    b1 = attrs.get_float("beta1", 0.9)
    b2 = attrs.get_float("beta2", 0.999)
    eps = attrs.get_float("epsilon", 1e-8)
    g = _prep_grad(grad, rescale, clip, weight.dtype).add_(weight, alpha=wd)
    mean.mul_(b1).add_(g, alpha=1 - b1)
    var.mul_(b2).addcmul_(g, g, value=1 - b2)
    return weight.sub_(lr * mean / (var.sqrt() + eps))
