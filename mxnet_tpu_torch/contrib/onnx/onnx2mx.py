"""ONNX -> Symbol import (the counterpart of
`mxnet_tpu/contrib/onnx/onnx2mx.py`; reference
`contrib/onnx/onnx2mx/import_model.py`).

Covers the core vision vocabulary: Conv, Gemm, BatchNormalization, Relu,
Sigmoid, Tanh, Softmax, MaxPool/AveragePool/GlobalAveragePool, Add, Mul,
Concat, Flatten, Reshape, Dropout, Identity.  Each ONNX node becomes the
matching registered op; initializers become arg_params on the current
context (the card unless the caller opened ``with cpu():``).
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError


def _require_onnx():
    """Real `onnx` package if installed, else the vendored wire-format
    shim (`onnx_shim.py`) — the converters run either way; files written
    by one load in the other (same protobuf bytes).  The shim is
    returned as a module object, never installed into sys.modules, so
    third-party `import onnx` feature-detection stays truthful."""
    try:
        import onnx  # noqa: F401
        return onnx
    except ImportError:
        from . import onnx_shim
        return onnx_shim


def _sym_pads(attrs, ndim, name):
    """ONNX pads are [begin..., end...]; the Convolution/Pooling ops only
    express symmetric padding — reject the rest loudly."""
    pads = list(attrs.get("pads", [0] * 2 * ndim))
    if pads[:ndim] != pads[ndim:]:
        raise MXNetError(
            f"onnx import: node {name!r} uses asymmetric pads {pads}; "
            "only symmetric padding is supported")
    return pads


def _attr_dict(node, onnx):
    out = {}
    for a in node.attribute:
        out[a.name] = onnx.helper.get_attribute_value(a)
    return out


def import_model(model_file):
    """Returns (sym, arg_params, aux_params) (reference
    `import_model.py:import_model`)."""
    onnx = _require_onnx()
    from ... import symbol as sym_mod
    from ...ndarray import array as nd_array
    from ...symbol.register import invoke_sym

    model = onnx.load(model_file)
    graph = model.graph

    params = {}
    for init in graph.initializer:
        params[init.name] = nd_array(
            onnx.numpy_helper.to_array(init).astype(np.float32))

    built = {}
    for inp in graph.input:
        if inp.name not in params:
            built[inp.name] = sym_mod.var(inp.name)
    for name in params:
        built[name] = sym_mod.var(name)

    def get(n):
        if n not in built:
            raise MXNetError(f"onnx import: undefined input {n!r}")
        return built[n]

    def get_param(n, ctx):
        if n not in params:
            raise MXNetError(
                f"onnx import: {ctx} expects initializer {n!r}; dynamic "
                "(graph-computed) weights/shapes are not supported")
        return params[n]

    aux_params = {}
    consumed_shapes = set()
    for node in graph.node:
        attrs = _attr_dict(node, onnx)
        ins = [get(i) for i in node.input if i]
        op = node.op_type
        name = node.name or node.output[0]
        if op == "Conv":
            k = tuple(attrs.get("kernel_shape"))
            pads = _sym_pads(attrs, len(k), name)
            out = invoke_sym(
                "Convolution", *ins, kernel=k,
                stride=tuple(attrs.get("strides", (1,) * len(k))),
                dilate=tuple(attrs.get("dilations", (1,) * len(k))),
                pad=tuple(pads[:len(k)]),
                num_filter=int(get_param(node.input[1], "Conv").shape[0]),
                num_group=int(attrs.get("group", 1)),
                no_bias=len(ins) < 3, name=name)
        elif op == "Gemm":
            if float(attrs.get("alpha", 1.0)) != 1.0 or \
                    float(attrs.get("beta", 1.0)) != 1.0 or \
                    int(attrs.get("transA", 0)):
                raise MXNetError(
                    f"onnx import: Gemm node {name!r} uses alpha/beta/"
                    "transA; only the FullyConnected form is supported")
            w = get_param(node.input[1], "Gemm")
            if not int(attrs.get("transB", 0)):
                # FullyConnected computes X @ W.T; ONNX default transB=0
                # means X @ W -> store the transposed weight
                params[node.input[1]] = nd_array(w.asnumpy().T.copy())
                w = params[node.input[1]]
            out = invoke_sym("FullyConnected", *ins,
                             num_hidden=int(w.shape[0]),
                             no_bias=len(ins) < 3, name=name)
        elif op == "BatchNormalization":
            out = invoke_sym("BatchNorm", *ins,
                             eps=float(attrs.get("epsilon", 1e-5)),
                             momentum=float(attrs.get("momentum", 0.9)),
                             fix_gamma=False, name=name)
            for i in (3, 4):  # running mean/var are aux states
                pname = node.input[i]
                if pname in params:
                    aux_params[pname] = params.pop(pname)
        elif op in ("Relu", "Sigmoid", "Tanh"):
            out = invoke_sym("Activation", *ins, act_type=op.lower(),
                             name=name)
        elif op == "Softmax":
            opset = max((i.version for i in model.opset_import
                         if i.domain in ("", "ai.onnx")), default=13)
            if "axis" in attrs:
                out = invoke_sym("softmax", *ins,
                                 axis=int(attrs["axis"]), name=name)
            elif opset >= 13:
                out = invoke_sym("softmax", *ins, axis=-1, name=name)
            else:
                # opset<13 default: softmax over dims flattened from axis 1
                out = invoke_sym("SoftmaxActivation", *ins,
                                 mode="instance", name=name)
        elif op in ("MaxPool", "AveragePool"):
            k = tuple(attrs.get("kernel_shape"))
            pads = _sym_pads(attrs, len(k), name)
            out = invoke_sym(
                "Pooling", *ins, kernel=k,
                stride=tuple(attrs.get("strides", (1,) * len(k))),
                pad=tuple(pads[:len(k)]),
                pool_type="max" if op == "MaxPool" else "avg", name=name)
        elif op == "GlobalAveragePool":
            out = invoke_sym("Pooling", *ins, global_pool=True,
                             pool_type="avg", kernel=(1, 1), name=name)
        elif op == "Add":
            out = invoke_sym("elemwise_add", *ins, name=name)
        elif op == "Mul":
            out = invoke_sym("elemwise_mul", *ins, name=name)
        elif op == "Concat":
            out = invoke_sym("concat", *ins,
                             dim=int(attrs.get("axis", 1)), name=name)
        elif op == "Flatten":
            out = invoke_sym("Flatten", *ins, name=name)
        elif op == "Reshape":
            # the shape initializer may be shared by several Reshape
            # nodes: record it for removal AFTER the walk, don't pop now
            shape = get_param(node.input[1], "Reshape").asnumpy().astype(int)
            consumed_shapes.add(node.input[1])
            out = invoke_sym("reshape", ins[0], shape=tuple(shape),
                             name=name)
        elif op in ("Dropout", "Identity"):
            out = ins[0]
        else:
            raise MXNetError(
                f"onnx import: unsupported op {op!r} (node {name!r})")
        outs = [out] if not isinstance(out, (list, tuple)) else list(out)
        for i, oname in enumerate(node.output):
            built[oname] = outs[min(i, len(outs) - 1)]

    for n in consumed_shapes:
        params.pop(n, None)
    heads = [built[o.name] for o in graph.output]
    sym = sym_mod.Group(heads) if len(heads) > 1 else heads[0]
    return sym, params, aux_params
