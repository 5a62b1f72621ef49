"""The subgraph partition framework in the port against the JAX package,
case for case with `tests/test_subgraph.py` and
`tests/test_subgraph_op_cases.py`: every graph built by the same code in
both packages partitions to the same Symbol JSON, character for
character; the partitioned executor lists the same arguments and gives
the unpartitioned outputs (and gradients) and the JAX package's.

Tolerances: outputs within FWD_TOL = 1e-5 of the reference's largest
magnitude, gradients within GRAD_TOL = 1e-4.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import subgraph as jsub
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import subgraph
from mxnet_tpu_torch.symbol import symbol as tsym

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
SUB = {mx: jsub, mt: subgraph}


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, what


def _both(fn):
    out = []
    for pkg, names in ((mx, jsym._NAMES), (mt, tsym._NAMES)):
        names.counters.clear()
        if pkg is mt:
            with mt.cpu():
                out.append(fn(pkg))
        else:
            out.append(fn(pkg))
    return out


def _count_ops(symbol, op_name):
    return sum(1 for n in json.loads(symbol.tojson())["nodes"]
               if n["op"] == op_name)


class _ByNames:
    """A property selecting ops by name, for either package."""

    @staticmethod
    def make(pkg, names):
        sub = SUB[pkg]

        class Prop(sub.SubgraphProperty):
            def create_subgraph_selector(self):
                return sub.OpNameSelector(names)
        return Prop()


# ---------------------------------------------------------------------------
# the graphs of tests/test_subgraph_op_cases.py (the reference's seven
# adversarial structures) and of tests/test_subgraph.py
# ---------------------------------------------------------------------------

def _weight_from_external(S):
    d1, d2 = S.var("data1"), S.var("data2")
    c1 = S.Convolution(data=d1, weight=d2, no_bias=True, kernel=(2, 2),
                       num_filter=1)
    c2 = S.Convolution(data=d2, no_bias=True, kernel=(1, 1), num_filter=1)
    return S.Group([c1, c2]), {"data1": (2, 3, 10, 10),
                               "data2": (1, 3, 2, 2)}


def _diamond(S):
    ret = S.exp(S.var("data"))
    return S.cos(ret) + S.sin(ret), {"data": (2, 3, 10, 10)}


def _aux(S):
    ret = S.exp(S.var("data"))
    return (S.BatchNorm(S.BatchNorm(S.cos(ret) + S.sin(ret))),
            {"data": (2, 3, 10, 10)})


def _dup_outputs(S):
    ret = S.exp(S.var("data"))
    return S.Group([ret, ret, ret]), {"data": (2, 3, 10, 10)}


def _dup_inputs(S):
    data = S.var("data")
    return data + data, {"data": (2, 3, 10, 10)}


def _weight_branch(S):
    conv = S.Convolution(data=S.var("data1"), weight=S.sin(S.var("data2")),
                         kernel=(2, 2), num_filter=1)
    return conv, {"data1": (3, 3, 10, 10), "data2": (1, 3, 2, 2)}


def _long_chain(S):
    ret1 = S.sin(S.var("data"))
    ret2 = S.cos(ret1)
    for _ in range(5):
        ret2 = S.cos(ret2)
    return ret1 + ret2, {"data": (1,)}


def _chain(S):
    y = S.FullyConnected(S.var("x"), S.var("w"), num_hidden=6,
                         no_bias=True, name="fc")
    y = S.Activation(y, act_type="relu", name="act")
    y = S.exp(y, name="e")
    return S.elemwise_add(y, y, name="add"), {"x": (4, 5), "w": (6, 5)}


def _convex(S):
    a = S.exp(S.var("x"), name="a")
    b = S.FullyConnected(a, S.var("w"), num_hidden=5, no_bias=True,
                         name="b")
    return S.elemwise_add(a, b, name="c"), {"x": (2, 5), "w": (5, 5)}


def _multi_out(S):
    a = S.exp(S.var("x"), name="a")
    return S.Group([a, S.Activation(a, act_type="relu", name="b")]), \
        {"x": (3, 4)}


def _inter_region(S):
    x = S.var("x")
    a1 = S.exp(x, name="a1")
    fc1 = S.FullyConnected(a1, S.var("w1"), num_hidden=4, no_bias=True,
                           name="FC1")
    b2 = S.exp(S.Activation(fc1, act_type="relu", name="b1"), name="b2")
    fc2 = S.FullyConnected(b2, S.var("w2"), num_hidden=4, no_bias=True,
                           name="FC2")
    return S.Group([S.elemwise_add(a1, fc2, name="a2"),
                    S.elemwise_add(b2, b2, name="b3")]), \
        {"x": (2, 4), "w1": (4, 4), "w2": (4, 4)}


def _small(S):
    return S.exp(S.var("x"), name="only"), {"x": (2, 3)}


CASES = [
    ("weight_from_external", _weight_from_external, ["Convolution"]),
    ("diamond_exp_sin", _diamond, ["exp", "sin", "broadcast_add",
                                   "elemwise_add"]),
    ("diamond_exp_cos", _diamond, ["exp", "cos", "broadcast_add",
                                   "elemwise_add"]),
    ("aux_elemwise", _aux, ["exp", "sin", "elemwise_add", "broadcast_add"]),
    ("aux_exp_bn", _aux, ["exp", "BatchNorm"]),
    ("aux_bn", _aux, ["BatchNorm"]),
    ("duplicate_outputs", _dup_outputs, ["exp"]),
    ("duplicate_inputs", _dup_inputs, ["broadcast_add", "elemwise_add"]),
    ("weight_branch_none", _weight_branch, []),
    ("weight_branch_sin", _weight_branch, ["sin"]),
    ("weight_branch_conv", _weight_branch, ["Convolution"]),
    ("weight_branch_both", _weight_branch, ["sin", "Convolution"]),
    ("long_external_chain", _long_chain, ["sin", "elemwise_add",
                                          "broadcast_add"]),
    ("chain_default", _chain, "default"),
    ("chain_fc_act", _chain, ["FullyConnected", "Activation"]),
    ("convex_default", _convex, "default"),
    ("multi_output", _multi_out, "default"),
    ("inter_region_cycle", _inter_region, "default"),
    ("small_region", _small, "default"),
]


def _inputs(sym, shapes, seed=0):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {n: rs.uniform(size=s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: rs.uniform(size=s).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


@pytest.mark.parametrize("name,build,sel", CASES,
                         ids=[c[0] for c in CASES])
def test_partition_json_and_execution_match_reference(name, build, sel):
    def run(pkg):
        sym, shapes = build(pkg.sym)
        prop = sel if isinstance(sel, str) else _ByNames.make(pkg, sel)
        part = SUB[pkg].partition(sym, prop)
        assert part.list_arguments() == sym.list_arguments()
        assert part.list_auxiliary_states() == sym.list_auxiliary_states()
        args, aux = _inputs(sym, shapes)
        outs = []
        for s in (sym, part):
            ex = s.bind(pkg.cpu(), args={k: pkg.nd.array(v)
                                         for k, v in args.items()},
                        aux_states={k: pkg.nd.array(v)
                                    for k, v in aux.items()},
                        grad_req="null")
            outs.append([o.asnumpy() for o in ex.forward()])
        return part.tojson(), outs

    (rjson, routs), (gjson, gouts) = _both(run)
    assert gjson == rjson
    for g, u, r in zip(gouts[1], gouts[0], routs[1]):
        _close(g, u, FWD_TOL, "partitioned vs whole")
        _close(g, r, FWD_TOL, "vs reference")


def test_registry_surface():
    assert "default" in subgraph.list_subgraph_properties()
    assert "graph_compile" in subgraph.list_subgraph_properties()
    assert isinstance(subgraph.get_subgraph_property("default"),
                      subgraph.SubgraphProperty)
    with pytest.raises(mt.MXNetError, match="unknown subgraph"):
        subgraph.get_subgraph_property("nope")


def test_partition_chain_fuses_elemwise_run():
    with mt.cpu():
        part = subgraph.partition(_chain(mt.sym)[0], "default")
    assert _count_ops(part, "_subgraph_op") == 1
    assert _count_ops(part, "Activation") == 0
    assert _count_ops(part, "exp") == 0
    assert _count_ops(part, "FullyConnected") == 1
    assert _count_ops(subgraph.partition(_small(mt.sym)[0], "default"),
                      "_subgraph_op") == 0


def test_partition_gradients_flow_through_fused_node():
    rs = np.random.RandomState(2)
    x = rs.randn(3, 5).astype(np.float32)
    w = (rs.randn(6, 5) * 0.2).astype(np.float32)

    def run(pkg):
        net = _chain(pkg.sym)[0]
        grads = []
        for s in (net, SUB[pkg].partition(net, "default")):
            ex = s.simple_bind(pkg.cpu(), x=x.shape, w=w.shape,
                               grad_req="write")
            ex.forward(is_train=True, x=pkg.nd.array(x), w=pkg.nd.array(w))
            ex.backward(out_grads=pkg.nd.ones(ex.outputs[0].shape))
            grads.append({k: v.asnumpy() for k, v in ex.grad_dict.items()
                          if v is not None})
        return grads

    ref, got = _both(run)
    for k in ref[1]:
        _close(got[1][k], got[0][k], GRAD_TOL, k)
        _close(got[1][k], ref[1][k], GRAD_TOL, k)


def test_convexity_no_cycle_through_outside_node():
    with mt.cpu():
        part = subgraph.partition(_convex(mt.sym)[0], "default")
    for n in json.loads(part.tojson())["nodes"]:
        if n["op"] == "_subgraph_op":
            inner = n["attrs"]["__subgraph__"]
            assert not ('"a"' in inner and '"c"' in inner)


def test_batchnorm_aux_updates_cross_fused_boundary():
    """FMutateInputs through the fused node: a region holding BatchNorm
    writes back its moving mean, as the JAX package's does."""
    xv = (np.random.RandomState(8).randn(16, 3) * 2 + 1.0).astype(
        np.float32)

    def run(pkg):
        S = pkg.sym
        y = S.BatchNorm(S.var("x"), fix_gamma=False, momentum=0.5,
                        name="bn")
        y = S.Activation(y, act_type="relu", name="act")
        part = SUB[pkg].partition(y, _ByNames.make(
            pkg, {"BatchNorm", "Activation"}))
        assert _count_ops(part, "_subgraph_op") == 1
        ex = part.simple_bind(pkg.cpu(), x=xv.shape, grad_req="write")
        ex.arg_dict["bn_gamma"][:] = pkg.nd.ones((3,))
        ex.arg_dict["bn_beta"][:] = pkg.nd.zeros((3,))
        ex.forward(is_train=True, x=pkg.nd.array(xv))
        return part.tojson(), ex.aux_dict["bn_moving_mean"].asnumpy()

    (rj, rm), (gj, gm) = _both(run)
    assert gj == rj
    _close(gm, 0.5 * xv.mean(0), FWD_TOL)
    _close(gm, rm, FWD_TOL)


def test_env_backend_applies_at_bind(monkeypatch):
    """``MXNET_SUBGRAPH_BACKEND`` partitions at `bind` and `simple_bind`
    (positional lists stay in the original symbol's order); an unknown
    name raises."""
    rs = np.random.RandomState(10)
    vals = {"a": rs.randn(2, 3).astype(np.float32),
            "w": rs.randn(3, 3).astype(np.float32),
            "b": rs.randn(2, 3).astype(np.float32)}
    with mt.cpu():
        S = mt.sym
        out = S.elemwise_add(S.FullyConnected(S.var("a"), S.var("w"),
                                              num_hidden=3, no_bias=True,
                                              name="fc"),
                             S.exp(S.var("b"), name="e"), name="add")
        arg_list = [mt.nd.array(vals[n]) for n in out.list_arguments()]
        ref = out.bind(args=arg_list).forward()[0].asnumpy()
        net = _chain(S)[0]
        x, w = vals["a"][:, :2].repeat(3, 1)[:, :5], \
            np.ones((6, 5), np.float32)
        ref2 = net.simple_bind(x=x.shape, w=w.shape).forward(
            x=mt.nd.array(x), w=mt.nd.array(w))[0].asnumpy()
        monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "default")
        ex = out.bind(args=arg_list)
        assert _count_ops(ex._symbol, "_subgraph_op") == 1
        np.testing.assert_allclose(ex.forward()[0].asnumpy(), ref,
                                   rtol=FWD_TOL)
        ex2 = net.simple_bind(x=x.shape, w=w.shape)
        assert _count_ops(ex2._symbol, "_subgraph_op") == 1
        np.testing.assert_allclose(ex2.forward(
            x=mt.nd.array(x), w=mt.nd.array(w))[0].asnumpy(), ref2,
            rtol=FWD_TOL)
        monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "defualt")
        with pytest.raises(mt.MXNetError, match="unknown subgraph"):
            net.simple_bind(x=(2, 5), w=(6, 5))


def test_get_backend_symbol_partitions():
    with mt.cpu():
        net = _chain(mt.sym)[0]
        assert net.get_backend_symbol("default").tojson() == \
            subgraph.partition(net, "default").tojson()


def test_json_roundtrip_of_partitioned_graph(tmp_path):
    """A partitioned graph saved by either package runs in the other."""
    (rj, gj) = _both(lambda pkg: SUB[pkg].partition(
        _chain(pkg.sym)[0], "default").tojson())
    rs = np.random.RandomState(7)
    x = rs.randn(2, 5).astype(np.float32)
    w = (rs.randn(6, 5) * 0.3).astype(np.float32)
    outs = []
    for text in (rj, gj):
        p = tmp_path / "part.json"
        p.write_text(text)
        with mt.cpu():
            loaded = mt.sym.load(str(p))
            assert _count_ops(loaded, "_subgraph_op") == 1
            outs.append(loaded.simple_bind(x=x.shape, w=w.shape).forward(
                x=mt.nd.array(x), w=mt.nd.array(w))[0].asnumpy())
    ref = mx.sym.load_json(gj).simple_bind(
        mx.cpu(), x=x.shape, w=w.shape).forward(
        x=mx.nd.array(x), w=mx.nd.array(w))[0].asnumpy()
    for o in outs:
        _close(o, ref, FWD_TOL)


def _named(symbol):
    nodes = tsym._topo(symbol._heads)
    return nodes, {n.name: n for n in nodes}


def test_shrink_to_convex_keeps_shared_input_region():
    S = mt.sym
    outside = S.FullyConnected(S.var("x"), num_hidden=4, no_bias=True,
                               name="out_fc")
    y = S.elemwise_add(S.exp(outside, name="a"), S.sin(outside, name="b"),
                       name="add")
    nodes, by = _named(y)
    kept = subgraph._shrink_to_convex([by["a"], by["b"], by["add"]], nodes)
    assert {n.name for n in kept} == {"a", "b", "add"}


def test_shrink_to_convex_evicts_reentrant_consumer():
    S = mt.sym
    a = S.exp(S.var("x"), name="a")
    mid = S.FullyConnected(a, num_hidden=3, no_bias=True, name="mid")
    c = S.elemwise_add(S.sum(a, name="red"), S.sum(mid, name="red2"),
                       name="c")
    nodes, by = _named(c)
    kept = subgraph._shrink_to_convex([by["a"], by["red"], by["c"]], nodes)
    assert {n.name for n in kept} == {"a", "red"}


def test_drop_condensed_cycles_dissolves_self_reaching_region():
    S = mt.sym
    a = S.exp(S.var("x"), name="a")
    c = S.cos(S.sin(a, name="b"), name="c")
    nodes, by = _named(S.elemwise_add(a, c, name="d"))
    regions = [[by["a"], by["d"]], [by["b"], by["c"]]]
    region_of = {id(n): rid for rid, r in enumerate(regions) for n in r}
    subgraph._drop_condensed_cycles(nodes, regions, region_of)
    assert [rid for rid, r in enumerate(regions) if not r]
    assert None in {region_of.get(id(by[n])) for n in "abcd"}


def test_drop_condensed_cycles_leaves_acyclic_regions_alone():
    S = mt.sym
    nodes, by = _named(S.sin(S.exp(S.var("x"), name="a"), name="b"))
    regions = [[by["a"]], [by["b"]]]
    region_of = {id(n): rid for rid, r in enumerate(regions) for n in r}
    subgraph._drop_condensed_cycles(nodes, regions, region_of)
    assert all(regions)
    assert (region_of[id(by["a"])], region_of[id(by["b"])]) == (0, 1)


def test_graph_compile_property_registered():
    from mxnet_tpu_torch.graph_compile import GraphCompileProperty
    prop = subgraph.get_subgraph_property("graph_compile")
    assert isinstance(prop, GraphCompileProperty)
    assert prop.min_nodes() == 1
    sel = prop.create_subgraph_selector()

    class _FakeNode:
        def __init__(self, op, is_var=False):
            self.op, self.is_var = op, is_var

    assert sel.select(_FakeNode("FullyConnected"))
    assert not sel.select(_FakeNode("Custom"))
    assert not sel.select(_FakeNode(None, is_var=True))


def test_subgraph_op_shape_backfill():
    """`simple_bind` of a partitioned graph sizes the weights inside a
    fused node from the data shape (the `_subgraph_rule` back-fill)."""
    def run(pkg):
        S = pkg.sym
        y = S.Activation(S.FullyConnected(S.var("x"), num_hidden=6,
                                          name="fc"), act_type="relu")
        part = SUB[pkg].partition(y, _ByNames.make(
            pkg, {"FullyConnected", "Activation"}))
        return part.infer_shape(x=(3, 5))

    ref, got = _both(run)
    assert got == ref
    assert (6, 5) in got[0]
