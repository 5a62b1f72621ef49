"""Neural-network ops (the counterparts of `mxnet_tpu/ops/nn.py`):
FullyConnected, Convolution, Deconvolution, Pooling, Activation,
LeakyReLU, softmax (with its ``length`` input), softmin, log_softmax,
LayerNorm, InstanceNorm, BatchNorm, L2Normalization, LRN, UpSampling,
Dropout, SequenceMask, SequenceLast, SequenceReverse, SoftmaxOutput,
softmax_cross_entropy and the regression heads (Linear-, MAE- and
LogisticRegressionOutput), as plain PyTorch functions whose gradients are
autograd's own, except the output heads', which are the ops' defined
gradients.

The large products and the convolutions go to
`torch.nn.functional.linear` and ``conv*d`` (cuDNN on the card), as the
JAX package leaves them to XLA (``dot_general``,
``conv_general_dilated``) outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from ..base import MXNetError
from .registry import alias, register


def _pair(v, n):
    """An n-tuple of ints from an int, a shorter tuple or None (ones)."""
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t if len(t) == n else t * n


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


# ---------------------------------------------------------------------------
# Convolution / Deconvolution (reference src/operator/nn/convolution.cc,
# deconvolution.cc)
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _layout_perm(layout):
    """The permutation taking an operand in ``layout`` (e.g. NHWC, whose
    weight is OHWI) to N, C, then the spatial axes in the layout's order;
    None for the default NC* layouts."""
    n = len(layout) - 2
    if layout in (None, "None") or layout == "NC" + "DHW"[-n:]:
        return None
    sp = [i for i, c in enumerate(layout) if c not in "NC"]
    return [layout.index("N"), layout.index("C")] + sp


# MXTPU_CONV_LAYOUT=NHWC runs 2-D convolution and pooling channels-last:
# the operands keep their NCHW shapes in torch's channels_last memory
# format, which cuDNN takes natively.  Read once at import, as the JAX
# package reads it, so set it before importing the package.
from ..config import get_env as _get_env
_NHWC_LAYOUT = _get_env("MXTPU_CONV_LAYOUT", "").upper() == "NHWC"


def _use_nhwc():
    return _NHWC_LAYOUT


def _channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


def _conv_args(attrs, n):
    return (_pair(attrs.get_tuple("stride", None), n),
            _pair(attrs.get_tuple("pad", None) or (0,) * n, n),
            _pair(attrs.get_tuple("dilate", None), n))


@register("Convolution", num_inputs=None,
          input_names=["data", "weight", "bias"])
def _convolution(attrs, data, weight, bias=None):
    """Reference `Convolution`: weight (num_filter, C / num_group, *kernel)
    in the NC* layouts; an explicit ``layout`` (NWC, NHWC, NDHWC) takes
    the operands in that layout, the weight with N -> O and C -> I
    (NHWC's weight is OHWI), and gives the output in it."""
    n = len(attrs.get_tuple("kernel"))
    stride, pad, dilate = _conv_args(attrs, n)
    if attrs.get_bool("no_bias", False):
        bias = None
    layout = attrs.get_str("layout", None) or \
        attrs.get_str("__layout__", None)
    perm = _layout_perm(layout) if layout else None
    if perm is not None:
        data = data.permute(perm)
        weight = weight.permute(perm)
    elif n == 2 and _use_nhwc():
        data, weight = _channels_last(data), _channels_last(weight)
    out = _CONV[n](data, weight, bias, stride, pad, dilate,
                   attrs.get_int("num_group", 1))
    if perm is not None:
        inv = [perm.index(i) for i in range(len(perm))]
        out = out.permute(inv)
    return out


@register("Deconvolution", num_inputs=None,
          input_names=["data", "weight", "bias"])
def _deconvolution(attrs, data, weight, bias=None):
    """Reference `Deconvolution`, the gradient of a convolution with
    respect to its input: weight (C, num_filter / num_group, *kernel);
    ``adj`` adds rows at the high edge and ``target_shape`` overrides pad
    and adj (`deconvolution-inl.h:121-142`).  NC* layouts only, as in the
    reference."""
    kernel = attrs.get_tuple("kernel")
    n = len(kernel)
    layout = attrs.get_str("layout", None)
    if layout is not None and _layout_perm(layout) is not None:
        raise NotImplementedError(
            f"Deconvolution: layout={layout!r} is not supported; use the "
            "default NC* layouts")
    stride, pad, dilate = _conv_args(attrs, n)
    adj = _pair(attrs.get_tuple("adj", None) or (0,) * n, n)
    target = attrs.get_tuple("target_shape", None)
    if target and any(t != 0 for t in target):
        if len(target) != n:
            raise ValueError(
                f"Deconvolution: target_shape {target} must have "
                f"{n} dims to match kernel {kernel}")
        pad, adj = list(pad), list(adj)
        for i in range(n):
            dk = (kernel[i] - 1) * dilate[i] + 1
            total = stride[i] * (data.shape[2 + i] - 1) + dk - target[i]
            if total < 0:
                raise ValueError(
                    f"Deconvolution: too big target shape {target[i]} "
                    f"for dim {i} (max "
                    f"{stride[i] * (data.shape[2 + i] - 1) + dk})")
            adj[i] = total % 2
            pad[i] = (total + 1) // 2
    if attrs.get_bool("no_bias", True):
        bias = None
    return _CONV_T[n](data, weight, bias, stride, tuple(pad), tuple(adj),
                      attrs.get_int("num_group", 1), dilate)


# ---------------------------------------------------------------------------
# Pooling (reference src/operator/nn/pooling.cc, pool.h)
# ---------------------------------------------------------------------------

def _window_sum(x, kernel, stride, pads):
    """The sum over each window of ``x`` (N, C, *spatial) after zero
    padding ``pads`` [(lo, hi)] per spatial axis."""
    n = len(kernel)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat)
    if n == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if n == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _window_max(x, kernel, stride, pads):
    n = len(kernel)
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[n]
    sym = [lo for lo, hi in pads]
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, kernel)):
        return pool(x, kernel, stride, sym)
    low = -float("inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return pool(F.pad(x, flat, value=low), kernel, stride)


@register("Pooling", num_inputs=1, input_names=["data"])
def _pooling(attrs, data):
    """Reference `Pooling`: max, avg, sum or lp over windows of the
    spatial axes the ``layout`` names (NC* by default), or over all of
    them with ``global_pool``.  The ``full`` convention (out = ceil((x + 2p
    - k) / s) + 1) pads the high edge; ``same`` gives ceil(x / s) windows
    clipped at the right edge.  An average with ``count_include_pad``
    divides by the window clipped to the padded extent (`pool.h:376-377`),
    so a ``full`` edge window divides by less than the kernel's size;
    without it, by the count of real elements."""
    kernel = tuple(attrs.get_tuple("kernel", None) or (1, 1))
    n = len(kernel)
    pool_type = attrs.get_str("pool_type", "max")
    stride = _pair(attrs.get_tuple("stride", None), n)
    pad = _pair(attrs.get_tuple("pad", None) or (0,) * n, n)
    conv = attrs.get_str("pooling_convention", "valid")
    layout = attrs.get_str("layout", None) or "NC" + "DHW"[-n:]
    sp_axes = tuple(i for i, ch in enumerate(layout) if ch not in "NC")
    if len(sp_axes) != n:
        raise ValueError(f"Pooling: layout {layout} for kernel {kernel}")
    if attrs.get_bool("global_pool", False):
        if pool_type == "max":
            return data.amax(dim=sp_axes, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=sp_axes, keepdim=True)
        return data.mean(dim=sp_axes, keepdim=True)
    perm = _layout_perm(layout)
    x = data.permute(perm) if perm is not None else data
    if perm is None and n == 2 and _use_nhwc():
        x = _channels_last(x)
    size = x.shape[2:]
    if conv == "full":
        pads = []
        for i in range(n):
            out = -(-(size[i] + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            need = (out - 1) * stride[i] + kernel[i] - size[i]
            pads.append((pad[i], max(need - pad[i], pad[i])))
    elif conv == "same":
        if any(p != 0 for p in pad):
            raise ValueError("'same' pooling convention disables the pad "
                             "parameter (reference pooling.cc:106)")
        pads = []
        for i in range(n):
            out = -(-size[i] // stride[i])
            pads.append((0, max((out - 1) * stride[i] + kernel[i]
                                - size[i], 0)))
    else:
        pads = [(p, p) for p in pad]
    if pool_type == "max":
        out = _window_max(x, kernel, stride, pads)
    elif pool_type in ("avg", "sum"):
        out = _window_sum(x, kernel, stride, pads)
        if pool_type == "avg":
            if not attrs.get_bool("count_include_pad", True):
                ones = torch.ones((1, 1) + tuple(size), dtype=x.dtype,
                                  device=x.device)
                out = out / _window_sum(ones, kernel, stride, pads)
            elif any(hi > p for (_, hi), p in zip(pads, pad)):
                ext = torch.ones((1, 1) + tuple(s + 2 * p for s, p in
                                                zip(size, pad)),
                                 dtype=x.dtype, device=x.device)
                out = out / _window_sum(ext, kernel, stride,
                                        [(0, hi - p) for (_, hi), p in
                                         zip(pads, pad)])
            else:
                denom = 1.0
                for k in kernel:
                    denom *= k
                out = out / denom
    elif pool_type == "lp":
        p = attrs.get_int("p_value", 2)
        out = _window_sum(x.abs() ** p, kernel, stride, pads) ** (1.0 / p)
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    if perm is not None:
        out = out.permute([perm.index(i) for i in range(len(perm))])
    return out


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


@register("softmax", num_inputs=None, input_names=["data", "length"])
def _softmax(attrs, x, length=None):
    """Reference `softmax` (`softmax-inl.h`); with ``length`` (data's shape
    without the softmax axis) the lanes past each length are masked and
    output exactly 0."""
    ax = attrs.get_int("axis", -1)
    t = attrs.get_attr("temperature", None)
    if t not in (None, "None"):
        x = x / float(t)
    if length is None:
        return torch.softmax(x, dim=ax)
    axp = ax % x.dim()
    pos = torch.arange(x.shape[axp], device=x.device).reshape(
        [-1 if i == axp else 1 for i in range(x.dim())])
    mask = pos < length.to(torch.int32).unsqueeze(axp)
    out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=ax)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


@register("log_softmax", num_inputs=1, input_names=["data"])
def _log_softmax(attrs, x):
    t = attrs.get_attr("temperature", None)
    if t not in (None, "None"):
        x = x / float(t)
    return torch.log_softmax(x, dim=attrs.get_int("axis", -1))


@register("softmin", num_inputs=1, input_names=["data"])
def _softmin(attrs, x):
    return torch.softmax(-x, dim=attrs.get_int("axis", -1))


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


@register("InstanceNorm", num_inputs=3,
          input_names=["data", "gamma", "beta"])
def _instance_norm(attrs, data, gamma, beta):
    """Reference `InstanceNorm`: each (sample, channel) normalized over
    its spatial axes."""
    eps = attrs.get_float("eps", 1e-3)
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, unbiased=False)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape)
            + beta.reshape(shape))


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
        # ones that stay on the graph: gamma gets its zero gradient
        gamma = gamma * 0 + 1
    if not attrs.get_bool("output_mean_var", False):
        # one fused normalization (cuDNN's on the card); the moving
        # statistics take the batch's biased variance, as MXNet's do
        x = data.movedim(ax, 1) if ax != 1 else data
        if train:
            out = F.batch_norm(x, None, None, gamma, beta, True, 0.0, eps)
            with torch.no_grad():
                var, mean = torch.var_mean(data.float(), dim=red,
                                           unbiased=False)
                new_mm = momentum * moving_mean + (1 - momentum) * mean
                new_mv = momentum * moving_var + (1 - momentum) * var
        else:
            out = F.batch_norm(x, moving_mean, moving_var, gamma, beta,
                               False, 0.0, eps)
            new_mm, new_mv = moving_mean, moving_var
        return (out.movedim(1, ax) if ax != 1 else out), new_mm, new_mv
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
    return out, mean, var, new_mm, new_mv


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
# sequence ops (reference src/operator/sequence_{mask,last,reverse}.cc):
# data is (T, N, ...) with ``axis`` 0, or (N, T, ...) with ``axis`` 1
# ---------------------------------------------------------------------------

def _lengths(sequence_length, like):
    """The per-sample lengths as int64 indices on ``like``'s device."""
    return sequence_length.to(device=like.device, dtype=torch.int64)


@register("SequenceMask", num_inputs=None,
          input_names=["data", "sequence_length"])
def _sequence_mask(attrs, data, sequence_length=None):
    """Positions at or past each sample's length set to ``value``."""
    if not attrs.get_bool("use_sequence_length", False) \
            or sequence_length is None:
        return data
    ax = attrs.get_int("axis", 0)
    pos = torch.arange(data.shape[ax], device=data.device)
    lens = _lengths(sequence_length, data)
    mask = pos[:, None] < lens[None, :] if ax == 0 else \
        pos[None, :] < lens[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full(
        (), attrs.get_float("value", 0.0), dtype=data.dtype,
        device=data.device))


@register("SequenceLast", num_inputs=None,
          input_names=["data", "sequence_length"])
def _sequence_last(attrs, data, sequence_length=None):
    """Each sample's last valid step."""
    ax = attrs.get_int("axis", 0)
    if not attrs.get_bool("use_sequence_length", False) \
            or sequence_length is None:
        return data.select(ax, data.shape[ax] - 1)
    idx = _lengths(sequence_length, data) - 1
    shape = ((1, -1) if ax == 0 else (-1, 1)) + (1,) * (data.dim() - 2)
    idx = idx.reshape(shape).expand(
        *((1,) + data.shape[1:] if ax == 0
          else (data.shape[0], 1) + data.shape[2:]))
    return torch.gather(data, ax, idx).squeeze(ax)


@register("SequenceReverse", num_inputs=None,
          input_names=["data", "sequence_length"])
def _sequence_reverse(attrs, data, sequence_length=None):
    """The first ``length`` steps of each sample reversed along axis 0,
    the padding after them left in place."""
    if not attrs.get_bool("use_sequence_length", False) \
            or sequence_length is None:
        return torch.flip(data, (0,))
    lens = _lengths(sequence_length, data)[None, :]
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    src = torch.where(pos < lens, lens - 1 - pos, pos)
    src = src.reshape(src.shape + (1,) * (data.dim() - 2)).expand(
        data.shape)
    return torch.gather(data, 0, src)


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


# ---------------------------------------------------------------------------
# the regression heads (reference src/operator/regression_output-inl.h)
# ---------------------------------------------------------------------------

class _RegressionOutput(torch.autograd.Function):
    """Forward the identity (sigmoid for ``logistic``); backward
    (out - label)·scale (sign(data - label)·scale for ``mae``), the
    incoming gradient ignored (a loss head)."""

    @staticmethod
    def forward(ctx, data, label, scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out if kind == "logistic" else data, label)
        ctx.scale, ctx.kind = scale, kind
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pred, label = ctx.saved_tensors
        diff = pred - label.reshape(pred.shape)
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        return diff * ctx.scale, None, None, None


def _regression(kind):
    def compute(attrs, data, label):
        num_output = 1
        for s in label.shape[1:]:
            num_output *= int(s)
        scale = attrs.get_float("grad_scale", 1.0) / max(num_output, 1)
        return _RegressionOutput.apply(data, label.detach(), scale, kind)
    return compute


_REGRESSION_DOC = """Reference `{name}`: the gradient's seed is
    grad_scale / num_output, num_output = label.size / batch
    (`regression_output-inl.h:200-206`), whatever gradient comes in."""

for _kind, _name in (("linear", "LinearRegressionOutput"),
                     ("mae", "MAERegressionOutput"),
                     ("logistic", "LogisticRegressionOutput")):
    _fn = _regression(_kind)
    _fn.__doc__ = _REGRESSION_DOC.format(name=_name)
    register(_name, num_inputs=2, input_names=["data", "label"])(_fn)


@register("softmax_cross_entropy", num_inputs=2,
          input_names=["data", "label"])
def _softmax_cross_entropy(attrs, data, label):
    """The summed negative log-likelihood of ``label`` under the softmax
    of ``data``'s last axis, as a 1-element vector."""
    logp = torch.log_softmax(data, dim=-1)
    nll = -logp.gather(-1, label.to(torch.int64)[..., None])
    return nll.sum().reshape(1)


@register("L2Normalization", num_inputs=1, input_names=["data"])
def _l2_normalization(attrs, data):
    """``data`` over its L2 norm (plus ``eps`` under the root) per
    instance (every axis but the first), per ``channel`` (axis 1) or per
    ``spatial`` position set (the axes past 1)."""
    eps = attrs.get_float("eps", 1e-10)
    mode = attrs.get_str("mode", "instance")
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.sum(torch.square(data), dim=red,
                                       keepdim=True) + eps)


@register("LRN", num_inputs=1, input_names=["data"])
def _lrn(attrs, data):
    """Local response normalization across channels (`lrn.cc`):
    x / (knorm + alpha / nsize · Σ x²)^beta over a window of ``nsize``
    channels centred on each."""
    alpha = attrs.get_float("alpha", 1e-4)
    beta = attrs.get_float("beta", 0.75)
    knorm = attrs.get_float("knorm", 2.0)
    nsize = attrs.get_int("nsize")
    half = nsize // 2
    c = data.shape[1]
    sq = torch.square(data)
    pad = [0, 0] * (data.dim() - 2) + [half, half]
    sq = F.pad(sq, pad)
    ssum = sq.narrow(1, 0, c)
    for i in range(1, nsize):
        ssum = ssum + sq.narrow(1, i, c)
    return data / torch.pow(knorm + alpha / nsize * ssum, beta)


@register("UpSampling", num_inputs=None, input_names=None)
def _upsampling(attrs, *inputs):
    """``nearest``: each input's pixels repeated ``scale`` times in both
    spatial axes, the inputs brought to the largest size and concatenated
    along channels; ``bilinear``: the first input resized by ``scale``
    with half-pixel centres (the JAX package's `jax.image.resize`)."""
    scale = attrs.get_int("scale")
    if attrs.get_str("sample_type", "nearest") == "nearest":
        outs = [x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
                for x in inputs]
        if len(outs) == 1:
            return outs[0]
        h = max(o.shape[2] for o in outs)
        w = max(o.shape[3] for o in outs)
        outs = [o if (o.shape[2] == h and o.shape[3] == w) else
                o.repeat_interleave(h // o.shape[2], 2)
                .repeat_interleave(w // o.shape[3], 3) for o in outs]
        return torch.cat(outs, 1)
    x = inputs[0]
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)
