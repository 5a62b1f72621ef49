"""Neural-network ops of the BERT path (the counterparts of
`mxnet_tpu/ops/nn.py`): FullyConnected, Activation, LeakyReLU, softmax,
LayerNorm, BatchNorm, Dropout and SoftmaxOutput, as plain PyTorch
functions whose gradients are autograd's own, except SoftmaxOutput's,
which is the op's defined gradient.

The large products go to `torch.nn.functional.linear`, as the JAX package
leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from ..base import MXNetError
from .registry import alias, register


@register("FullyConnected", num_inputs=None,
          input_names=["data", "weight", "bias"])
def _fully_connected(attrs, data, weight, bias=None):
    """out = data @ weight.T + bias; weight is (num_hidden, in_dim)."""
    num_hidden = attrs.get_int("num_hidden", 0)
    if num_hidden and weight.dim() == 2 and weight.shape[0] != num_hidden:
        raise MXNetError(
            f"FullyConnected: weight shape {tuple(weight.shape)} "
            f"inconsistent with num_hidden={num_hidden}")
    if attrs.get_bool("flatten", True) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    if attrs.get_bool("no_bias", False):
        bias = None
    return F.linear(data, weight, bias)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation", num_inputs=1, input_names=["data"])
def _activation(attrs, x):
    act = attrs.get_str("act_type", "relu")
    if act not in _ACTIVATIONS:
        raise ValueError(f"unknown act_type {act}")
    return _ACTIVATIONS[act](x)


@register("LeakyReLU", num_inputs=None, input_names=["data", "gamma"],
          needs_rng=True, uses_train_mode=True)
def _leaky_relu(attrs, generator, x, gamma=None):
    """leaky/prelu/elu/selu/gelu/rrelu family; gelu is the exact (erf)
    form.  rrelu draws one slope per element, uniform in [lower_bound,
    upper_bound], from ``generator`` in training, and takes the mean
    slope at inference."""
    act = attrs.get_str("act_type", "leaky")
    slope = attrs.get_float("slope", 0.25)
    if act == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act == "prelu":
        g = gamma
        if g.dim() == 1 and x.dim() > 1:
            g = g.reshape((1, -1) + (1,) * (x.dim() - 2))
        return torch.where(x > 0, x, g * x)
    if act == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act == "selu":
        return F.selu(x)
    if act == "gelu":
        return F.gelu(x, approximate="none")
    if act == "rrelu":
        lo = attrs.get_float("lower_bound", 0.125)
        hi = attrs.get_float("upper_bound", 0.334)
        if attrs.get_bool("__train", False):
            r = torch.empty(x.shape, dtype=x.dtype, device=x.device) \
                .uniform_(lo, hi, generator=generator)
        else:
            r = (lo + hi) / 2.0
        return torch.where(x > 0, x, r * x)
    raise ValueError(f"unknown act_type {act}")


@register("softmax", num_inputs=1, input_names=["data"])
def _softmax(attrs, x):
    t = attrs.get_attr("temperature", None)
    if t not in (None, "None"):
        x = x / float(t)
    return torch.softmax(x, dim=attrs.get_int("axis", -1))


@register("LayerNorm", num_inputs=3, input_names=["data", "gamma", "beta"],
          num_outputs=lambda a: 3 if a.get_bool("output_mean_var", False)
          else 1)
def _layer_norm(attrs, data, gamma, beta):
    ax = attrs.get_int("axis", -1) % data.dim()
    eps = attrs.get_float("eps", 1e-5)
    x = data.movedim(ax, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma, beta, eps).movedim(-1, ax)
    if attrs.get_bool("output_mean_var", False):
        # reference layer_norm.cc: (mean, std) with the axis kept as 1
        mean = data.mean(dim=ax, keepdim=True)
        var = data.var(dim=ax, keepdim=True, unbiased=False)
        return out, mean, torch.sqrt(var + eps)
    return out


@register("BatchNorm", num_inputs=5,
          input_names=["data", "gamma", "beta", "moving_mean", "moving_var"],
          num_outputs=lambda a: 3 if a.get_bool("output_mean_var", False)
          else 1,
          mutate_inputs=(3, 4), uses_train_mode=True)
def _batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """Reference `BatchNorm` (`src/operator/nn/batch_norm.cc`): normalizes
    over every axis but ``axis``.  In training (unless
    ``use_global_stats``) it uses the batch's mean and variance and moves
    the moving statistics toward them by ``momentum``; the new moving
    statistics follow the visible outputs (MXNet's FMutateInputs), and
    ``output_mean_var`` adds the mean and variance it used."""
    ax = attrs.get_int("axis", 1) % data.dim()
    eps = attrs.get_float("eps", 1e-3)
    momentum = attrs.get_float("momentum", 0.9)
    train = attrs.get_bool("__train", False) and \
        not attrs.get_bool("use_global_stats", False)
    red = tuple(i for i in range(data.dim()) if i != ax)
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    if attrs.get_bool("fix_gamma", True):
        gamma = torch.ones_like(gamma)
    if train:
        x = data.float()
        mean = x.mean(dim=red)
        var = x.var(dim=red, unbiased=False)
        new_mm = (momentum * moving_mean + (1 - momentum) * mean).detach()
        new_mv = (momentum * moving_var + (1 - momentum) * var).detach()
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(bshape).to(data.dtype)) \
        * (inv.reshape(bshape) * gamma.reshape(bshape)).to(data.dtype) \
        + beta.reshape(bshape).to(data.dtype)
    if attrs.get_bool("output_mean_var", False):
        return out, mean, var, new_mm, new_mv
    return out, new_mm, new_mv


@register("Dropout", num_inputs=1, input_names=["data"], needs_rng=True,
          uses_train_mode=True)
def _dropout(attrs, generator, data):
    """Reference `Dropout` (`src/operator/nn/dropout.cc`): in training (or
    with ``mode='always'``) each element is kept with probability 1 - p
    and scaled by 1/(1 - p); the identity at inference or when p is 0.
    ``axes`` shares one mask value along each listed axis (variational
    dropout).  The mask comes from ``generator``, the device's stream."""
    p = attrs.get_float("p", 0.5)
    train = attrs.get_bool("__train", False)
    if (not train and attrs.get_str("mode", "training") != "always") \
            or p == 0.0:
        return data
    axes = attrs.get_tuple("axes", None) or ()
    shape = [1 if a in axes else n for a, n in enumerate(data.shape)]
    keep = torch.empty(shape, device=data.device).bernoulli_(
        1.0 - p, generator=generator)
    return torch.where(keep.bool(), data / (1.0 - p),
                       torch.zeros((), dtype=data.dtype, device=data.device))


# ---------------------------------------------------------------------------
# SoftmaxOutput (reference src/operator/softmax_output.cc)
# ---------------------------------------------------------------------------

class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax over the last axis; backward the op's *defined*
    gradient (reference `softmax_output-inl.h:156-270`, the JAX package's
    `_smo_bwd`), which folds the cross-entropy loss into the op:

    * soft labels (label.shape == out.shape): (out - label)·grad_scale,
      no normalization;
    * hard labels: out - target, the target label-smoothed by
      ``smooth_alpha``, rows of ``ignore_label`` zeroed under
      ``use_ignore``; 'batch' divides by N (times the spatial positions
      with ``multi_output``), 'valid' by the count of labels other than
      ``ignore_label`` (counted even without ``use_ignore``), 'null' by
      the spatial positions only;
    * the incoming gradient is ignored unless ``out_grad``.

    The target is never materialized as a one-hot: the gradient is the
    probabilities with the label's entry lowered in place, which keeps a
    (4096, 30522) head at one extra copy of the logits."""

    @staticmethod
    def forward(ctx, data, label, ignore_label, use_ignore, grad_scale,
                normalization, multi, out_grad, smooth_alpha):
        out = torch.softmax(data, dim=-1)
        ctx.save_for_backward(out, label)
        ctx.opts = (ignore_label, use_ignore, grad_scale, normalization,
                    multi, out_grad, smooth_alpha)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        (ignore_label, use_ignore, grad_scale, normalization, multi,
         out_grad, smooth_alpha) = ctx.opts
        if tuple(label.shape) == tuple(out.shape):
            grad = (out - label) * grad_scale
            return (grad * g if out_grad else grad), None, *([None] * 7)
        k = out.shape[-1]
        idx = label.to(torch.int64)
        # a label outside [0, k) has an all-zero one-hot row
        hit = ((idx >= 0) & (idx < k)).to(out.dtype)
        if smooth_alpha:
            off = smooth_alpha / max(k - 1, 1)
            grad = out - off
            hit = hit * (1.0 - smooth_alpha - off)
        else:
            grad = out.clone()
        grad.scatter_add_(-1, idx.clamp(0, k - 1).unsqueeze(-1),
                          -hit.unsqueeze(-1))
        if use_ignore:
            grad *= (label != ignore_label).to(out.dtype).unsqueeze(-1)
        spatial = (label.numel() // label.shape[0]) if multi else 1
        if normalization == "batch":
            denom = float(label.shape[0] * spatial)
        elif normalization == "valid":
            denom = (idx != int(ignore_label)).sum().to(out.dtype) \
                .clamp_min(1.0)
        else:  # null
            denom = float(spatial)
        grad *= grad_scale / denom
        if out_grad:
            grad *= g
        return grad, None, *([None] * 7)


@register("SoftmaxOutput", num_inputs=2, input_names=["data", "label"])
def _softmax_output(attrs, data, label):
    """Reference `SoftmaxOutput`: forward is softmax over the last axis
    (over axis 1 with ``multi_output``); the gradient is the op's defined
    one, (softmax - one_hot(label)) normalized as the attrs say (see
    `_SoftmaxOutput`)."""
    multi = attrs.get_bool("multi_output", False)
    if multi:  # (N, C, d...) -> softmax over C
        data = data.movedim(1, -1)
        if label.dim() == data.dim():
            label = label.movedim(1, -1)
    out = _SoftmaxOutput.apply(
        data, label.detach(), attrs.get_float("ignore_label", -1.0),
        attrs.get_bool("use_ignore", False),
        attrs.get_float("grad_scale", 1.0),
        attrs.get_str("normalization", "null"), multi,
        attrs.get_bool("out_grad", False),
        attrs.get_float("smooth_alpha", 0.0))
    return out.movedim(-1, 1) if multi else out


alias("SoftmaxOutput", "Softmax")
