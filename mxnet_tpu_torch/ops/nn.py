"""Neural-network ops of the encoder path (the counterparts of
`mxnet_tpu/ops/nn.py`): FullyConnected, Activation, LeakyReLU, softmax,
LayerNorm and Dropout, as plain PyTorch functions.

The large products go to `torch.nn.functional.linear`, as the JAX package
leaves them to XLA outside any Pallas kernel.  Only inference is ported:
the ops that draw random numbers in training raise there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


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


@register("LeakyReLU", num_inputs=None, input_names=["data", "gamma"])
def _leaky_relu(attrs, x, gamma=None):
    """leaky/prelu/elu/selu/gelu/rrelu family; gelu is the exact (erf)
    form, rrelu uses its mean slope (inference)."""
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
        return torch.where(x > 0, x, (lo + hi) / 2.0 * x)
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


@register("Dropout", num_inputs=1, input_names=["data"])
def _dropout(attrs, data):
    """Identity at inference; ``mode='always'`` would draw a random mask,
    which arrives with the training slice."""
    if attrs.get_str("mode", "training") == "always" and \
            attrs.get_float("p", 0.5) > 0.0:
        raise NotImplementedError(
            "Dropout(mode='always') draws random masks: not ported yet "
            "(training slice)")
    return data
