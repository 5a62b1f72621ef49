"""Backward parameter-shape inference for the layered ops (the FC,
Convolution, Deconvolution, LayerNorm, InstanceNorm, BatchNorm, PReLU,
Embedding, RNN and SoftmaxOutput rules of
`mxnet_tpu/symbol/param_infer.py`): the shapes of a node's parameter and
label variables from its data shape, so a graph binds from data shapes
alone.  Through `_subgraph_op`, `_foreach` and `_while_loop` the inner or
body graph's own partial inference runs on the known shapes and its
resolved free variables map back to the outer ones (the JAX package's
`_subgraph_rule`, `_foreach_rule` and `_while_rule`)."""
from __future__ import annotations

import json
from typing import Dict, Optional

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


def _regression_label(a, data):
    """A regression head's label has the data's shape."""
    return {1: tuple(data)}


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
    "LinearRegressionOutput": _regression_label,
    "MAERegressionOutput": _regression_label,
    "LogisticRegressionOutput": _regression_label,
}


def _in_shape(node, slot, shapes) -> Optional[tuple]:
    if slot >= len(node.inputs):
        return None
    inp, idx = node.inputs[slot]
    return shapes.get(inp.name if inp.is_var else f"{inp.name}#{idx}")


def _var_name(node, slot) -> Optional[str]:
    if slot >= len(node.inputs):
        return None
    inp, _ = node.inputs[slot]
    return inp.name if inp.is_var else None


def _resolved(inner, known) -> Optional[Dict[str, tuple]]:
    """The inner graph's argument and aux shapes given ``known``, or None
    when its partial inference fails."""
    try:
        arg_shapes, _, aux_shapes = inner.infer_shape_partial(**known)
    except Exception:
        return None
    out = dict(zip(inner.list_arguments(), arg_shapes or []))
    out.update(zip(inner.list_auxiliary_states(), aux_shapes or []))
    return out


def _subgraph_rule(node, shapes) -> Dict[str, tuple]:
    """Back-fill through a fused subgraph node: its inner graph's partial
    inference on the known external shapes, mapped back to the outer
    variables its inputs alias."""
    from .symbol import load_json
    a = Attrs(strip_annotations(node.attrs))
    inner = load_json(a.get_str("__subgraph__"))
    input_names = json.loads(a.get_str("__inputs__"))
    known = {}
    for i, vname in enumerate(input_names):
        s = _in_shape(node, i, shapes)
        if s is not None:
            known[vname] = s
    resolved = _resolved(inner, known) if known else None
    if not resolved:
        return {}
    out = {}
    for i, vname in enumerate(input_names):
        shape = resolved.get(vname)
        name = _var_name(node, i)
        if name is not None and shape is not None \
                and shapes.get(name) is None:
            out[name] = tuple(int(d) for d in shape)
    return out


def _body_backfill(node, shapes, graph_key, ph_shapes, free_names,
                   free_offset) -> Dict[str, tuple]:
    """A control-flow body's partial inference with the placeholder
    shapes, its resolved free variables (the weights it closes over)
    mapped back to the outer variables."""
    from .symbol import load_json
    a = Attrs(strip_annotations(node.attrs))
    known = {k: v for k, v in ph_shapes.items() if v is not None}
    resolved = _resolved(load_json(a.get_str(graph_key)), known) \
        if known else None
    if not resolved:
        return {}
    out = {}
    for j, fname in enumerate(free_names):
        shape = resolved.get(fname)
        name = _var_name(node, free_offset + j)
        if name is not None and shape is not None \
                and shapes.get(name) is None:
            out[name] = tuple(int(d) for d in shape)
    return out


def _foreach_rule(node, shapes) -> Dict[str, tuple]:
    """A foreach body's free variables: per-step data shapes drop the
    scan axis; states keep theirs (reference control_flow.cc
    ForeachShape)."""
    a = Attrs(strip_annotations(node.attrs))
    data_names = json.loads(a.get_str("__data_names__"))
    state_names = json.loads(a.get_str("__state_names__"))
    free_names = json.loads(a.get_str("__free_names__"))
    ph = {}
    for i, n in enumerate(data_names):
        s = _in_shape(node, i, shapes)
        if s is not None and len(s) >= 1:
            ph[n] = tuple(s[1:])
    for i, n in enumerate(state_names):
        s = _in_shape(node, len(data_names) + i, shapes)
        if s is not None:
            ph[n] = tuple(s)
    return _body_backfill(node, shapes, "__subgraph__", ph, free_names,
                          len(data_names) + len(state_names))


def _while_rule(node, shapes) -> Dict[str, tuple]:
    """A while loop's condition and body free variables, from the loop
    variables' shapes."""
    a = Attrs(strip_annotations(node.attrs))
    var_names = json.loads(a.get_str("__var_names__"))
    cond_free = json.loads(a.get_str("__cond_free__"))
    body_free = json.loads(a.get_str("__body_free__"))
    ph = {}
    for i, n in enumerate(var_names):
        s = _in_shape(node, i, shapes)
        if s is not None:
            ph[n] = tuple(s)
    out = _body_backfill(node, shapes, "__cond__", ph, cond_free,
                         len(var_names))
    out.update(_body_backfill(node, shapes, "__body__", ph, body_free,
                              len(var_names) + len(cond_free)))
    return out


_GRAPH_RULES = {
    "_subgraph_op": _subgraph_rule,
    "_foreach": _foreach_rule,
    "_while_loop": _while_rule,
}


def infer_param_shapes(node, shapes) -> Dict[str, tuple]:
    """Shapes of ``node``'s variable inputs deducible from its data input
    (slot 0), given ``shapes`` {value key -> shape or None}."""
    if node.op in _GRAPH_RULES:
        return _GRAPH_RULES[node.op](node, shapes)
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
