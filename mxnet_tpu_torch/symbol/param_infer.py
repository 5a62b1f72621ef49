"""Backward parameter-shape inference for the layered ops (the FC,
Convolution, Deconvolution, LayerNorm, InstanceNorm, BatchNorm, PReLU,
Embedding, RNN and SoftmaxOutput rules of
`mxnet_tpu/symbol/param_infer.py`): the shapes of a node's parameter and
label variables from its data shape, so a graph binds from data shapes
alone."""
from __future__ import annotations

from typing import Dict

from ..attribute import strip_annotations
from ..ops.registry import Attrs

__all__ = ["infer_param_shapes"]


def _fc(a, data):
    nh = a.get_int("num_hidden")
    if a.get_bool("flatten", True):
        in_dim = 1
        for s in data[1:]:
            in_dim *= s
    else:
        in_dim = data[-1]
    out = {1: (nh, in_dim)}
    if not a.get_bool("no_bias", False):
        out[2] = (nh,)
    return out


def _conv(a, data):
    nf = a.get_int("num_filter")
    out = {1: (nf, data[1] // a.get_int("num_group", 1))
           + tuple(a.get_tuple("kernel"))}
    if not a.get_bool("no_bias", False):
        out[2] = (nf,)
    return out


def _deconv(a, data):
    nf = a.get_int("num_filter")
    out = {1: (data[1], nf // a.get_int("num_group", 1))
           + tuple(a.get_tuple("kernel"))}
    if not a.get_bool("no_bias", True):
        out[2] = (nf,)
    return out


def _in_norm(a, data):
    return {1: (data[1],), 2: (data[1],)}


def _leaky(a, data):
    if a.get_str("act_type", "leaky") == "prelu":
        return {1: (data[1],)}
    return {}


def _ln(a, data):
    c = data[a.get_int("axis", -1)]
    return {1: (c,), 2: (c,)}


def _bn(a, data):
    c = (data[a.get_int("axis", 1)],)
    return {1: c, 2: c, 3: c, 4: c}


def _embedding(a, data):
    return {1: (a.get_int("input_dim"), a.get_int("output_dim"))}


def _rnn(a, data):
    """The fused ``RNN`` op's packed vector and (L·D, N, H) states from
    (T, N, C) data."""
    from ..ops.rnn_op import param_size
    mode = a.get_str("mode", "lstm")
    nl, nh = a.get_int("num_layers", 1), a.get_int("state_size")
    d = 2 if a.get_bool("bidirectional", False) else 1
    out = {1: (param_size(mode, nl, data[2], nh, d),),
           2: (nl * d, data[1], nh)}
    if mode == "lstm":
        out[3] = out[2]
    return out


def _softmax_output_label(a, data):
    """The label has the data's shape without the class axis: the last
    one, or axis 1 with ``multi_output``."""
    if a.get_bool("multi_output", False):
        return {1: (data[0],) + tuple(data[2:])}
    return {1: tuple(data[:-1])}


_RULES = {
    "FullyConnected": _fc,
    "Convolution": _conv,
    "Deconvolution": _deconv,
    "LayerNorm": _ln,
    "InstanceNorm": _in_norm,
    "LeakyReLU": _leaky,
    "BatchNorm": _bn,
    "Embedding": _embedding,
    "RNN": _rnn,
    "SoftmaxOutput": _softmax_output_label,
    "Softmax": _softmax_output_label,
}


def infer_param_shapes(node, shapes) -> Dict[str, tuple]:
    """Shapes of ``node``'s variable inputs deducible from its data input
    (slot 0), given ``shapes`` {value key -> shape or None}."""
    rule = _RULES.get(node.op)
    if rule is None or not node.inputs:
        return {}
    inp, idx = node.inputs[0]
    data = shapes.get(inp.name if inp.is_var else f"{inp.name}#{idx}")
    if data is None:
        return {}
    out = {}
    for slot, shape in rule(Attrs(strip_annotations(node.attrs)),
                            data).items():
        if slot < len(node.inputs) and node.inputs[slot][0].is_var:
            out[node.inputs[slot][0].name] = tuple(int(s) for s in shape)
    return out
