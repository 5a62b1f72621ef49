"""int8 inference ops (the counterpart of `mxnet_tpu/ops/quantized_ops.py`):
quantized convolution, pooling, flatten, concat and ReLU.

Reference `src/operator/quantization/{quantized_conv,quantized_pooling,
quantized_concat,quantized_flatten}.cc`.  The conventions are those of
the quantize ops in `contrib_ops.py`: int8 payloads in int8 tensors,
ranges as (min, max) float scalars, int8 x int8 sums in int32 with the
output range d_range * w_range * 127.

The convolution's int32 accumulators are bit-equal to the JAX package's
(``lax.conv_general_dilated`` with ``preferred_element_type=int32``).
PyTorch's CUDA convolutions take no integers, so on the card the input is
unfolded (im2col, in float16, which holds every int8 value exactly) and
multiplied by ``contrib_ops.int8_gemm`` (``torch._int_mm``); on the CPU a
float64 convolution gives the same sums exactly (they stay far below
2^53; float32 would round the sums above 2^24 that a K = 4608 reduction
reaches).  Pooling works on the int8 values in float32, which holds them
and their window sums exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .contrib_ops import _bias_counts, _range, int8_gemm, \
    split_quantized_inputs
from .registry import register


def int8_conv2d(data, weight, stride, pad, dilate, groups):
    """NCHW int8 data and OIHW int8 weight -> int32 sums, exactly."""
    if data.device.type != "cuda":
        out = F.conv2d(data.to(torch.float64), weight.to(torch.float64),
                       stride=tuple(stride), padding=tuple(pad),
                       dilation=tuple(dilate), groups=groups)
        return out.to(torch.int32)
    N, C, H, W = data.shape
    CO, CI, kh, kw = weight.shape
    OH = (H + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    OW = (W + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    cols = F.unfold(data.to(torch.float16), (kh, kw), dilation=tuple(dilate),
                    padding=tuple(pad), stride=tuple(stride))
    # (N, C*kh*kw, L) -> groups of (N*L, CI*kh*kw)
    cols = cols.reshape(N, groups, CI * kh * kw, OH * OW)
    outs = []
    cog = CO // groups
    for g in range(groups):
        a = cols[:, g].transpose(1, 2).reshape(-1, CI * kh * kw).to(
            torch.int8)
        b = weight[g * cog:(g + 1) * cog].reshape(cog, -1).t()
        outs.append(int8_gemm(a, b).reshape(N, OH * OW, cog))
    out = torch.cat(outs, dim=2) if groups > 1 else outs[0]
    return out.transpose(1, 2).reshape(N, CO, OH, OW)


@register("_contrib_quantized_conv", num_inputs=None, num_outputs=3)
def _quantized_conv(attrs, *ins):
    """int8 Convolution -> int32 accumulators (`quantized_conv.cc`); 6
    inputs without a bias, 9 with one, as quantized FC."""
    (data, weight, bias, min_data, max_data, min_weight, max_weight,
     min_bias, max_bias) = split_quantized_inputs(ins, "quantized_conv")
    stride = attrs.get_tuple("stride", (1, 1))
    dilate = attrs.get_tuple("dilate", (1, 1))
    pad = attrs.get_tuple("pad", (0, 0))
    groups = attrs.get_int("num_group", 1)
    out = int8_conv2d(data, weight, stride, pad, dilate, groups)
    d_range = _range(min_data, max_data)
    w_range = _range(min_weight, max_weight)
    out_range = d_range * w_range * 127.0
    if bias is not None and min_bias is not None:
        out = out + _bias_counts(bias, min_bias, max_bias, d_range,
                                 w_range).reshape(1, -1, 1, 1)
    return out, -out_range, out_range


@register("_contrib_quantized_pooling", num_inputs=3,
          input_names=["data", "min_data", "max_data"], num_outputs=3)
def _quantized_pooling(attrs, data, min_data, max_data):
    """int8 Pooling (`quantized_pooling.cc`): max stays exact; avg sums in
    int32 precision, divides by the window in float32 and rounds; the
    range is unchanged."""
    kh, kw = attrs.get_tuple("kernel", (2, 2))
    stride = attrs.get_tuple("stride", None) or (1, 1)
    pad = attrs.get_tuple("pad", (0, 0))
    ptype = attrs.get_str("pool_type", "max")
    conv = attrs.get_str("pooling_convention", "valid")
    if attrs.get_bool("global_pool", False):
        kh, kw = data.shape[2], data.shape[3]
        stride, pad, conv = (1, 1), (0, 0), "valid"
    # the JAX package's explicit padding: "full" pads the high edge so
    # the last window fits (ceil), with the reduction's init value
    lo, hi = list(pad), list(pad)
    if conv == "full":
        for i, k in enumerate((kh, kw)):
            size = data.shape[2 + i] + 2 * pad[i]
            out_sz = -(-(size - k) // stride[i]) + 1
            need = (out_sz - 1) * stride[i] + k - data.shape[2 + i]
            hi[i] = max(need - pad[i], pad[i])
    x = data.to(torch.float32)
    fill = -128.0 if ptype == "max" else 0.0
    x = F.pad(x, (lo[1], hi[1], lo[0], hi[0]), value=fill)
    if ptype == "max":
        out = F.max_pool2d(x, (kh, kw), tuple(stride)).to(torch.int8)
    else:
        acc = F.avg_pool2d(x, (kh, kw), tuple(stride), divisor_override=1)
        out = torch.clamp(torch.round(acc / float(kh * kw)), -128,
                          127).to(torch.int8)
    return out, min_data, max_data


@register("_contrib_quantized_flatten", num_inputs=3,
          input_names=["data", "min_data", "max_data"], num_outputs=3)
def _quantized_flatten(attrs, data, min_data, max_data):
    """`quantized_flatten.cc`: layout only, the range passes through."""
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_concat", num_inputs=None, num_outputs=3)
def _quantized_concat(attrs, *ins):
    """`quantized_concat.cc`: inputs [data]*n + [min_i, max_i]*n, each
    rescaled into the widest range before the int8 concat."""
    n = attrs.get_int("num_args", len(ins) // 3)
    dim = attrs.get_int("dim", 1)
    datas = ins[:n]
    ranges = [_range(ins[n + 2 * i], ins[n + 2 * i + 1]) for i in range(n)]
    out_range = ranges[0]
    for r in ranges[1:]:
        out_range = torch.maximum(out_range, r)
    scaled = []
    for d, r in zip(datas, ranges):
        f = d.to(torch.float32) * (r / torch.clamp(out_range, min=1e-12))
        scaled.append(torch.clamp(torch.round(f), -127, 127).to(torch.int8))
    out_range = out_range.to(torch.float32)
    return torch.cat(scaled, dim=dim), -out_range, out_range


@register("_contrib_quantized_act", num_inputs=3,
          input_names=["data", "min_data", "max_data"], num_outputs=3)
def _quantized_act(attrs, data, min_data, max_data):
    """int8 ReLU (`mkldnn_quantized_act.cc`): the payload clamped at zero,
    the range unchanged (its scale is range / 127 everywhere)."""
    if attrs.get_str("act_type", "relu") != "relu":
        raise ValueError("only relu supported in int8")
    return torch.clamp(data, min=0), min_data, max_data
