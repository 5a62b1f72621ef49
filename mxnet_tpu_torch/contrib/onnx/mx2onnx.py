"""Symbol -> ONNX export (the counterpart of
`mxnet_tpu/contrib/onnx/mx2onnx.py`; reference
`contrib/onnx/mx2onnx/export_model.py`).

Walks the Symbol JSON graph and emits the matching ONNX nodes for the same
core vocabulary the importer supports.  The same symbol, parameters and
shapes give the same file, byte for byte, as the JAX package writes
(the producer name stays ``mxnet_tpu``).
"""
from __future__ import annotations

import json

import numpy as np

from ...base import MXNetError
from .onnx2mx import _require_onnx


def export_model(sym, params, input_shape, input_type=np.float32,
                 onnx_file_path="model.onnx", verbose=False):
    """Serialize (sym, params) to ONNX; returns the file path (reference
    `export_model.py:export_model`)."""
    onnx = _require_onnx()
    TensorProto = onnx.TensorProto
    helper = onnx.helper
    numpy_helper = onnx.numpy_helper

    if isinstance(input_shape, (list, tuple)) and input_shape and \
            isinstance(input_shape[0], (list, tuple)):
        input_shapes = [tuple(s) for s in input_shape]
    else:
        input_shapes = [tuple(input_shape)]

    graph = json.loads(sym.tojson())
    nodes = graph["nodes"]
    params = {k.split(":", 1)[-1]: v for k, v in params.items()}

    onnx_nodes, initializers, inputs = [], [], []

    def out_name(nid, idx=0):
        node = nodes[nid]
        if idx and node["op"] != "null":
            raise MXNetError(
                f"onnx export: node {node['name']!r} consumes output {idx} "
                "of a multi-output op; only primary outputs are supported")
        return node["name"]

    data_idx = 0
    for nid, node in enumerate(nodes):
        op, name = node["op"], node["name"]
        attrs = {k: v for k, v in node.get("attrs", {}).items()}
        ins = [out_name(i[0], i[1]) for i in node.get("inputs", [])]
        if op == "null":
            if name in params:
                arr = params[name].asnumpy().astype(np.float32)
                initializers.append(numpy_helper.from_array(arr, name))
            elif name.endswith("label"):
                continue  # training-only label heads are stripped
            else:
                if data_idx >= len(input_shapes):
                    raise MXNetError(
                        f"onnx export: free variable {name!r} has no "
                        "entry in params or input_shape — pass aux "
                        "states (e.g. BatchNorm moving stats) in params, "
                        "or supply one shape per data input")
                shape = input_shapes[data_idx]
                data_idx += 1
                inputs.append(helper.make_tensor_value_info(
                    name, TensorProto.FLOAT, list(shape)))
            continue

        def tup(key, default=None):
            from ...base import str_to_attr
            v = attrs.get(key, default)
            v = str_to_attr(v) if isinstance(v, str) else v
            if v is None:
                return None
            return [int(x) for x in (v if isinstance(v, (list, tuple))
                                     else (v,))]

        if op == "Convolution":
            k = tup("kernel")
            onnx_nodes.append(helper.make_node(
                "Conv", ins, [name], name=name, kernel_shape=k,
                strides=tup("stride", (1,) * len(k)),
                dilations=tup("dilate", (1,) * len(k)),
                pads=tup("pad", (0,) * len(k)) * 2,
                group=int(attrs.get("num_group", 1))))
        elif op == "FullyConnected":
            # MXNet FC flattens >2-D input implicitly (flatten=True
            # default); ONNX Gemm does not — emit an explicit Flatten
            # (identity on 2-D input, so always safe)
            data_in = ins[0]
            if nodes[node["inputs"][0][0]]["op"] not in ("Flatten",
                                                         "flatten"):
                fl = f"{name}_flatten"
                onnx_nodes.append(helper.make_node(
                    "Flatten", [data_in], [fl], name=fl, axis=1))
                data_in = fl
            onnx_nodes.append(helper.make_node(
                "Gemm", [data_in] + ins[1:], [name], name=name, alpha=1.0,
                beta=1.0, transA=0, transB=1))
        elif op == "BatchNorm":
            onnx_nodes.append(helper.make_node(
                "BatchNormalization", ins, [name], name=name,
                epsilon=float(attrs.get("eps", 1e-3)),
                momentum=float(attrs.get("momentum", 0.9))))
        elif op == "Activation":
            act = {"relu": "Relu", "sigmoid": "Sigmoid",
                   "tanh": "Tanh"}.get(attrs.get("act_type", "relu"))
            if act is None:
                raise MXNetError(
                    f"onnx export: unsupported act {attrs.get('act_type')}")
            onnx_nodes.append(helper.make_node(act, ins, [name], name=name))
        elif op in ("softmax", "SoftmaxOutput"):
            onnx_nodes.append(helper.make_node(
                "Softmax", ins[:1], [name], name=name,
                axis=int(attrs.get("axis", -1))))
        elif op == "Pooling":
            if str(attrs.get("global_pool", "0")).lower() in ("1", "true"):
                kind = ("GlobalMaxPool"
                        if attrs.get("pool_type", "max") == "max"
                        else "GlobalAveragePool")
                onnx_nodes.append(helper.make_node(kind, ins, [name],
                                                   name=name))
            else:
                k = tup("kernel")
                kind = ("MaxPool" if attrs.get("pool_type", "max") == "max"
                        else "AveragePool")
                onnx_nodes.append(helper.make_node(
                    kind, ins, [name], name=name, kernel_shape=k,
                    strides=tup("stride", (1,) * len(k)),
                    pads=tup("pad", (0,) * len(k)) * 2))
        elif op in ("elemwise_add", "_add", "_plus", "broadcast_add"):
            onnx_nodes.append(helper.make_node("Add", ins, [name],
                                               name=name))
        elif op in ("elemwise_mul", "_mul", "broadcast_mul"):
            onnx_nodes.append(helper.make_node("Mul", ins, [name],
                                               name=name))
        elif op in ("Concat", "concat"):
            onnx_nodes.append(helper.make_node(
                "Concat", ins, [name], name=name,
                axis=int(attrs.get("dim", 1))))
        elif op in ("Flatten", "flatten"):
            onnx_nodes.append(helper.make_node("Flatten", ins, [name],
                                               name=name))
        elif op == "Dropout":
            onnx_nodes.append(helper.make_node("Dropout", ins, [name],
                                               name=name))
        else:
            raise MXNetError(f"onnx export: unsupported op {op!r} "
                             f"(node {name!r})")

    outputs = [helper.make_tensor_value_info(
        nodes[h[0]]["name"], TensorProto.FLOAT, None)
        for h in graph["heads"]]
    g = helper.make_graph(onnx_nodes, "mxnet_tpu_model", inputs, outputs,
                          initializer=initializers)
    model = helper.make_model(g, producer_name="mxnet_tpu")
    onnx.save(model, onnx_file_path)
    if verbose:
        print(f"exported {onnx_file_path}")
    return onnx_file_path
