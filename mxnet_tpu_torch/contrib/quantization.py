"""INT8 quantization: calibration and the graph rewrite (the counterpart
of `mxnet_tpu/contrib/quantization.py`).

Reference `python/mxnet/contrib/quantization.py` (the calibration
driver) and `src/operator/quantization/quantize_graph_pass.cc` (the pass
that rewrites float ops into `_contrib_quantized_*` chains, with quantize
and dequantize at region boundaries and the calibrated ranges fused into
requantize nodes).

The rewrite grows a quantized region through the graph: Convolution and
FullyConnected become int8 ops with offline-quantized weights and a
calibrated requantize; Pooling, Flatten, Concat and ReLU stay in the int8
domain; any other consumer dequantizes back to float.  The pass is the
JAX package's, step for step, so on the same symbol, parameters and
calibration batches it writes the same quantized symbol JSON and the same
``qarg_params``, byte for byte.  On the card the int8 products run
through ``torch._int_mm`` (`ops/quantized_ops.py`).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["quantize_model", "calibrate_ranges"]

_Q_COMPUTE = {"Convolution", "FullyConnected"}
# producers whose output is already 2-D (N, D) — safe for the int8 gemm
_FLAT_PRODUCERS = {"Flatten", "flatten", "FullyConnected"}


def calibrate_ranges(sym, arg_params, aux_params, calib_data,
                     num_calib_examples=None, ctx=None) -> Dict[str, Tuple]:
    """Run calibration batches; collect (min, max) of every internal
    output (reference `_collect_layer_statistics`)."""
    internals = sym.get_internals()
    out_names = internals.list_outputs()
    shapes = {d.name: tuple(d.shape) for d in calib_data.provide_data}
    shapes.update({d.name: tuple(d.shape)
                   for d in (calib_data.provide_label or [])})
    ex = internals.simple_bind(ctx=ctx, grad_req="null", **shapes)
    ex.copy_params_from(arg_params, aux_params, allow_extra_params=True)
    ranges: Dict[str, List[float]] = {}
    seen = 0
    calib_data.reset()
    for batch in calib_data:
        feeds = {d.name: arr for d, arr in
                 zip(calib_data.provide_data, batch.data)}
        if calib_data.provide_label and batch.label:
            feeds.update({d.name: arr for d, arr in
                          zip(calib_data.provide_label, batch.label)})
        outs = ex.forward(is_train=False, **feeds)
        for name, o in zip(out_names, outs):
            v = o.asnumpy()
            lo, hi = float(v.min()), float(v.max())
            if name in ranges:
                ranges[name][0] = min(ranges[name][0], lo)
                ranges[name][1] = max(ranges[name][1], hi)
            else:
                ranges[name] = [lo, hi]
        seen += batch.data[0].shape[0]
        if num_calib_examples is not None and seen >= num_calib_examples:
            break
    return {k: (v[0], v[1]) for k, v in ranges.items()}


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   excluded_sym_names=(), calib_mode="naive",
                   calib_data=None, num_calib_examples=None, ctx=None,
                   quantized_dtype="int8", **kwargs):
    """Reference `quantize_model`: returns (qsym, qarg_params, aux_params)
    with conv/FC rewritten to int8 and pooling/flatten/concat/relu kept in
    the quantized domain."""
    if quantized_dtype not in ("int8", "auto"):
        raise MXNetError(f"unsupported quantized_dtype {quantized_dtype!r}")
    if calib_mode != "none" and calib_data is None:
        raise MXNetError("calib_data required unless calib_mode='none'")

    ranges: Dict[str, Tuple[float, float]] = {}
    if calib_mode != "none":
        ranges = calibrate_ranges(sym, arg_params, aux_params, calib_data,
                                  num_calib_examples, ctx)

    from .. import symbol as sym_mod
    from ..ndarray import array as nd_array
    from ..symbol.register import invoke_sym

    graph = json.loads(sym.tojson())
    nodes = graph["nodes"]
    qargs = dict(arg_params)
    excluded = set(excluded_sym_names)

    def node_range(nid) -> Optional[float]:
        node = nodes[nid]
        key = node["name"] if node["op"] == "null" \
            else f"{node['name']}_output"
        if key not in ranges:
            return None
        lo, hi = ranges[key]
        return max(abs(lo), abs(hi)) or 1.0

    def const(val, name):
        return invoke_sym("_full", shape=(1,), value=float(val), name=name)

    # built[nid] = {"float": Symbol|None, "quant": (q,min,max)|None}
    built: Dict[int, dict] = {}

    def as_float(nid):
        e = build(nid)
        if e["float"] is None:
            q, mn, mx = e["quant"]
            name = nodes[nid]["name"]
            e["float"] = invoke_sym("_contrib_dequantize", q, mn, mx,
                                    name=f"{name}_dequantize")
        return e["float"]

    def as_quant(nid):
        """(q, min, max) for nid's output, quantizing with the calibrated
        range when it is currently float; None when not possible."""
        e = build(nid)
        if e["quant"] is not None:
            return e["quant"]
        r = node_range(nid)
        if r is None or e["float"] is None:
            return None
        name = nodes[nid]["name"]
        qd = invoke_sym("_contrib_quantize_v2", e["float"],
                        min_calib_range=-r, max_calib_range=r,
                        name=f"{name}_quantize")
        e["quant"] = (qd[0], qd[1], qd[2])
        return e["quant"]

    def quantize_weight(pname):
        """Offline int8 weight/bias; returns (var_sym, range)."""
        w = qargs[pname].asnumpy()
        w_range = float(np.abs(w).max()) or 1.0
        qw = np.clip(np.round(w / w_range * 127), -127, 127)
        qargs[f"{pname}_quantized"] = nd_array(
            qw.astype(np.int8), **({} if ctx is None else {"ctx": ctx}))
        return sym_mod.var(f"{pname}_quantized", shape=qw.shape), w_range

    def try_quantized(nid) -> Optional[tuple]:
        """Build the int8 version of node nid, or None to fall back."""
        node = nodes[nid]
        op, name = node["op"], node["name"]
        attrs = dict(node.get("attrs", {}))
        if name in excluded:
            return None
        in_ids = [i[0] for i in node.get("inputs", [])]

        if op in _Q_COMPUTE:
            if f"{name}_weight" not in qargs:
                return None
            if op == "Convolution":
                # the int8 kernel is 2-D NCHW only; 1D/3D convs stay float
                from ..ops.registry import Attrs as _Attrs
                kern = _Attrs(attrs).get_tuple("kernel", ())
                if len(kern) != 2 or attrs.get("layout", "NCHW") != "NCHW":
                    return None
            else:
                # int8 gemm contracts the last axis only; require an input
                # that is already (N, D) — the float FC's implicit
                # flatten=True path falls back to float
                if nodes[in_ids[0]]["op"] not in _FLAT_PRODUCERS:
                    return None
            out_r = node_range(nid)
            dq = as_quant(in_ids[0])
            if out_r is None or dq is None:
                return None
            q, mn, mx = dq
            wsym, w_range = quantize_weight(f"{name}_weight")
            no_bias = str(attrs.get("no_bias", "0")).lower() in ("1", "true")
            opname = ("_contrib_quantized_conv" if op == "Convolution"
                      else "_contrib_quantized_fully_connected")
            if not no_bias and f"{name}_bias" in qargs:
                bsym, b_range = quantize_weight(f"{name}_bias")
                qout = invoke_sym(
                    opname, q, wsym, bsym, mn, mx,
                    const(-w_range, f"{name}_wmin"),
                    const(w_range, f"{name}_wmax"),
                    const(-b_range, f"{name}_bmin"),
                    const(b_range, f"{name}_bmax"),
                    name=f"{name}_int8", **attrs)
            else:
                qout = invoke_sym(
                    opname, q, wsym, mn, mx,
                    const(-w_range, f"{name}_wmin"),
                    const(w_range, f"{name}_wmax"),
                    name=f"{name}_int8", **attrs)
            rq = invoke_sym("_contrib_requantize", qout[0], qout[1], qout[2],
                            min_calib_range=-out_r, max_calib_range=out_r,
                            name=f"{name}_requantize")
            return (rq[0], rq[1], rq[2])

        if op == "Activation":
            if attrs.get("act_type", "relu") != "relu":
                return None
            dq = as_quant(in_ids[0])
            if dq is None:
                return None
            qa = invoke_sym("_contrib_quantized_act", *dq,
                            name=f"{name}_int8", **attrs)
            return (qa[0], qa[1], qa[2])

        if op == "Pooling":
            if attrs.get("pool_type", "max") not in ("max", "avg"):
                return None
            from ..ops.registry import Attrs as _Attrs
            kern = _Attrs(attrs).get_tuple("kernel", ()) or ()
            if len(kern) != 2 and not _Attrs(attrs).get_bool(
                    "global_pool", False):
                return None  # int8 pooling kernel is 2-D only
            dq = as_quant(in_ids[0])
            if dq is None:
                return None
            qp = invoke_sym("_contrib_quantized_pooling", *dq,
                            name=f"{name}_int8", **attrs)
            return (qp[0], qp[1], qp[2])

        if op in ("Flatten", "flatten"):
            dq = as_quant(in_ids[0])
            if dq is None:
                return None
            qf = invoke_sym("_contrib_quantized_flatten", *dq,
                            name=f"{name}_int8")
            return (qf[0], qf[1], qf[2])

        if op in ("Concat", "concat"):
            qs = [as_quant(i) for i in in_ids]
            if any(x is None for x in qs):
                return None
            datas = [x[0] for x in qs]
            rngs: List = []
            for x in qs:
                rngs.extend([x[1], x[2]])
            qc = invoke_sym("_contrib_quantized_concat", *(datas + rngs),
                            num_args=len(datas),
                            dim=int(attrs.get("dim", 1)),
                            name=f"{name}_int8")
            return (qc[0], qc[1], qc[2])

        return None

    def build(nid):
        if nid in built:
            return built[nid]
        node = nodes[nid]
        op, name = node["op"], node["name"]
        if op == "null":
            built[nid] = {"float": sym_mod.var(name), "quant": None}
            return built[nid]
        built[nid] = {"float": None, "quant": None}  # placeholder
        qt = try_quantized(nid)
        if qt is not None:
            built[nid]["quant"] = qt
            return built[nid]
        # float fallback: dequantize quantized producers as needed
        fins = []
        for i in node.get("inputs", []):
            f = as_float(i[0])
            fins.append(f[i[1]] if _n_outputs(i[0]) > 1 else f)
        attrs = {k: v for k, v in node.get("attrs", {}).items()}
        built[nid]["float"] = invoke_sym(op, *fins, name=name, **attrs)
        return built[nid]

    def _n_outputs(nid):
        node = nodes[nid]
        if node["op"] == "null":
            return 1
        from ..ops import registry as _reg
        opdef = _reg.get_op(node["op"])
        return opdef.num_outputs(_reg.Attrs(node.get("attrs", {})))

    heads = []
    for h in graph["heads"]:
        f = as_float(h[0])
        heads.append(f[h[1]] if _n_outputs(h[0]) > 1 else f)
    qsym = sym_mod.Group(heads) if len(heads) > 1 else heads[0]
    # prune params the rewritten graph no longer references (the fp32
    # weights of quantized layers — the reference pass drops them too)
    wanted = set(qsym.list_arguments())
    qargs = {k: v for k, v in qargs.items() if k in wanted}
    return qsym, qargs, dict(aux_params)
