"""Network visualization (the counterpart of `mxnet_tpu/visualization.py`;
reference `python/mxnet/visualization.py`): `print_summary`'s table of
layers, output shapes and parameter counts, and `plot_network`, which
needs the graphviz package and otherwise raises ImportError pointing at
`print_summary`, as the JAX package does."""
from __future__ import annotations

import json
from typing import Dict, Optional

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape: Optional[Dict] = None, line_length=120,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Print and return one row per op node (and head variable): its name
    and op, output shape (with ``shape``, the input shapes), parameter
    count and first input; then the total parameter count."""
    shape_dict, arg_dict = {}, {}
    if shape is not None:
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        internals = symbol.get_internals()
        _, int_shapes, _ = internals.infer_shape(**shape)
        shape_dict = dict(zip(internals.list_outputs(), int_shapes))
        arg_dict = dict(zip(symbol.list_arguments(), arg_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = {h[0] for h in conf["heads"]}

    def prod(s):
        out = 1
        for x in s or ():
            out *= x
        return out

    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]
    lines = ["_" * line_length, _row(fields, positions), "=" * line_length]
    total_params = 0
    data_inputs = set(shape or ())
    for i, node in enumerate(nodes):
        op, name = node["op"], node["name"]
        if op == "null" and i not in heads:
            continue
        out_shape = shape_dict.get(f"{name}_output", "")
        params = 0
        for (inp_id, *_) in node.get("inputs", []):
            inp = nodes[inp_id]
            if inp["op"] == "null" and inp["name"] in arg_dict \
                    and inp["name"] not in data_inputs:
                params += prod(arg_dict[inp["name"]])
        total_params += params
        prev = ",".join(nodes[i2[0]]["name"]
                        for i2 in node.get("inputs", [])[:1])
        lines.append(_row([f"{name} ({op})", str(out_shape), str(params),
                           prev], positions))
        lines.append("_" * line_length)
    lines.append(f"Total params: {total_params}")
    lines.append("_" * line_length)
    out = "\n".join(lines)
    print(out)
    return out


def _row(fields, positions):
    line = ""
    for f, p in zip(fields, positions):
        line = (line + str(f))[:p].ljust(p)
    return line


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """A graphviz ``Digraph`` of the symbol: ops as boxes, data inputs as
    ovals, weights hidden with ``hide_weights``."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError(
            "plot_network requires graphviz; use print_summary for a "
            "text rendering") from e
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    dot = Digraph(name=title)
    for node in nodes:
        op, name = node["op"], node["name"]
        if op == "null":
            if hide_weights and not name.endswith("data"):
                continue
            dot.node(name=name, label=name, shape="oval")
        else:
            dot.node(name=name, label=f"{name}\n{op}", shape="box")
        for (inp_id, *_) in node.get("inputs", []):
            inp = nodes[inp_id]
            if inp["op"] == "null" and hide_weights and \
                    not inp["name"].endswith("data"):
                continue
            dot.edge(inp["name"], name)
    return dot
