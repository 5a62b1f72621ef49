"""Queue C items 13-33 of the port, each held against the JAX package on
the CPU with the same numpy inputs: numpy dtypes on arrays and
parameters (bfloat16 kept through ``astype``/``zeros``), slices of
negative step and of 0-d arrays with their gradient, Symbol composition
by call, op user attrs, pre-1.0 symbol JSON, unknown (0) dims and the
regression heads' labels in shape inference, `Module.bind`'s
``shared_module`` and `Predictor`'s ``output_names``/``input_types``,
repeated ``profiler.dump(False)``, ``%=`` and the ``__div__`` spellings,
``nd.zeros(stype=)`` and fresh element views of a sparse array, deferred
sampler errors, the ``config`` surface with its two knobs, ``nd.imdecode``
and ``gluon.utils.download``, the context an NDArray keeps,
`linalg_potrf` on A's symmetric part, the multi-tensor update of master
copies, Ftrl and bfloat16 weights against the per-parameter one,
`Executor.fused_train_step`, bfloat16 through `infer_type`, the pass
reports as dicts, the per-parameter step's dispatch count, and bfloat16
BERT trained through `Module.fit` on the captured step."""
import io
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.base import MXNetError as JError
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError as TError
from mxnet_tpu_torch.symbol import symbol as tsym

CPU, JCPU = mt.cpu(), mx.cpu()
RS = np.random.RandomState(16)
X = RS.randn(4, 6).astype(np.float32)


@pytest.fixture(autouse=True)
def fresh_names():
    saved = [(m, dict(m.counters)) for m in (jsym._NAMES, tsym._NAMES)]
    for m, _ in saved:
        m.counters.clear()
    yield
    for m, counters in saved:
        m.counters.clear()
        m.counters.update(counters)


def _both(fn):
    """``fn(pkg, ctx)`` for the port and the JAX package."""
    return fn(mt, CPU), fn(mx, JCPU)


# -- 13: an array's dtype is a numpy dtype ----------------------------------

# float64 is left out: without x64 the JAX package narrows it to float32
@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "int8",
                                   "uint8"])
def test_dtype_is_numpy(dtype):
    t, j = _both(lambda p, c: p.nd.array(X * 3, ctx=c, dtype=dtype))
    assert t.dtype == j.dtype == np.dtype(dtype)
    assert np.zeros(2, dtype=t.dtype).dtype == np.dtype(dtype)
    assert t.astype(t.dtype).dtype == j.astype(j.dtype).dtype
    assert mt.nd.zeros((2,), ctx=CPU, dtype=t.dtype).dtype == t.dtype
    sp_t = mt.nd.array(X, ctx=CPU, dtype=dtype).tostype("csr")
    sp_j = mx.nd.array(X, ctx=JCPU, dtype=dtype).tostype("csr")
    assert sp_t.dtype == sp_j.dtype
    assert sp_t.tostype("row_sparse").dtype == \
        sp_j.tostype("row_sparse").dtype
    pt = mt.gluon.Parameter("w", shape=(2,), dtype=dtype, grad_req="null")
    pj = mx.gluon.Parameter("w", shape=(2,), dtype=dtype, grad_req="null")
    assert pt.dtype == pj.dtype
    pt.initialize(ctx=CPU, init="zeros")
    assert pt.data().dtype == np.dtype(dtype)


def test_bfloat16_stays_bfloat16():
    x = mt.nd.array(X, ctx=CPU).astype("bfloat16")
    assert x.data.dtype == torch.bfloat16
    assert x.astype(x.dtype).data.dtype == torch.bfloat16
    assert mt.nd.zeros((2, 3), ctx=CPU, dtype=x.dtype).data.dtype == \
        torch.bfloat16
    assert mt.nd.array(X, ctx=CPU, dtype=x.dtype).data.dtype == \
        torch.bfloat16
    p = mt.gluon.Parameter("b", shape=(3,), dtype="bfloat16")
    p.initialize(ctx=CPU)
    assert p.data().data.dtype == torch.bfloat16
    assert p.dtype == x.dtype
    np.testing.assert_allclose(
        x.asnumpy(), mx.nd.array(X).astype("bfloat16").asnumpy()
        .astype(np.float32))


# -- 14: negative steps and 0-d slices --------------------------------------

KEYS = [np.s_[::-1], np.s_[:, ::-2], np.s_[1:3, ::-1], np.s_[::-2, 1],
        np.s_[-1:0:-1], np.s_[None, ::-1], np.s_[..., ::-1],
        np.s_[3:1:-1, -2::-3]]


@pytest.mark.parametrize("key", KEYS, ids=[str(k) for k in KEYS])
def test_negative_step_slices(key):
    t, j = _both(lambda p, c: p.nd.array(X, ctx=c)[key])
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(t.asnumpy(), X[key])
    val = RS.randn(*X[key].shape).astype(np.float32)

    def write(p, c):
        a = p.nd.array(X, ctx=c)
        a[key] = p.nd.array(val, ctx=c)
        return a
    t, j = _both(write)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_zero_d_whole_slice_and_reversed_gradient():
    t, j = _both(lambda p, c: p.nd.zeros((), ctx=c))
    t[:] = 1
    j[:] = 1
    assert t.shape == j.shape == ()
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    w = RS.randn(4, 6).astype(np.float32)

    def grad(p, c):
        x = p.nd.array(X, ctx=c)
        x.attach_grad()
        with p.autograd.record():
            y = (x[::-1, ::-2] * p.nd.array(w[:, :3], ctx=c)).sum()
        y.backward()
        return x.grad.asnumpy()
    gt, gj = _both(grad)
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-7)


# -- 15-17: Symbol composition, op user attrs, pre-1.0 JSON -----------------

def _compose(p):
    fc1 = p.sym.FullyConnected(p.sym.var("data"), num_hidden=4, name="fc1")
    act0 = p.sym.Activation(p.sym.var("x"), act_type="relu", name="act0")
    return fc1(data=act0), fc1(act0, name="renamed"), fc1


def test_symbol_composition_by_call():
    (tk, tp, tf), (jk, jp, jf) = _compose(mt), _compose(mx)
    assert tk.list_arguments() == jk.list_arguments() == \
        ["x", "fc1_weight", "fc1_bias"]
    assert tk.tojson() == jk.tojson()
    assert tp.tojson() == jp.tojson() and tp.name == "renamed"
    assert tf.list_arguments() == ["data", "fc1_weight", "fc1_bias"]
    for f, err in ((tf, TError), (jf, JError)):
        with pytest.raises(err):
            f(f, data=f)
        with pytest.raises(err):
            f(nope=f)


def _user_attr(p):
    d = p.sym.var("data")
    return p.sym.Convolution(d, kernel=(1, 1), num_filter=1, name="conv",
                             attr={"__mood__": "so so"})


def test_op_user_attrs():
    t, j = _user_attr(mt), _user_attr(mx)
    assert t.attr_dict() == j.attr_dict()
    assert t.attr_dict()["conv"]["__user_keys__"] == "__mood__"
    assert t.attr_dict()["conv_weight"]["__mood__"] == "so so"
    assert t.tojson() == j.tojson()
    x = RS.randn(1, 2, 3, 3).astype(np.float32)
    outs = []
    for p, c in ((mt, CPU), (mx, JCPU)):
        s = _user_attr(p)
        ex = s.simple_bind(c, grad_req="null", data=x.shape)
        ex.arg_dict["conv_weight"][:] = 0.5
        outs.append(ex.forward(data=x)[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)
    for bad in ("mood", "__a,b__", "__a b__"):
        for p, err in ((mt, TError), (mx, JError)):
            with pytest.raises(err):
                p.sym.FullyConnected(p.sym.var("d"), num_hidden=2,
                                     attr={bad: "x"})


LEGACY = {
    "nodes": [
        {"op": "null", "name": "data", "inputs": []},
        {"op": "null", "name": "fc_weight", "inputs": []},
        {"op": "null", "name": "fc_bias", "inputs": []},
        {"op": "FullyConnected", "name": "fc", "param": {"num_hidden": "4"},
         "attr": {"lr_mult": "0.1"}, "inputs": [[0, 0], [1, 0], [2, 0]]},
        {"op": "Flatten_v1", "name": "flat", "attr": {},
         "inputs": [[3, 0]]},
        {"op": "Concat_v1", "name": "cat",
         "param": {"num_args": "1", "dim": "1"}, "inputs": [[4, 0]]},
    ],
    "arg_nodes": [0, 1, 2],
    "heads": [[5, 0]],
}


def test_legacy_json_loads():
    blob = json.dumps(LEGACY)
    t, j = mt.sym.load_json(blob), mx.sym.load_json(blob)
    assert t.list_arguments() == j.list_arguments()
    assert t.tojson() == j.tojson()
    assert t.attr_dict()["fc"]["lr_mult"] == "0.1"
    feed = {"data": RS.randn(2, 8).astype(np.float32),
            "fc_weight": RS.randn(4, 8).astype(np.float32),
            "fc_bias": RS.randn(4).astype(np.float32)}
    ot = t.bind(CPU, args={k: mt.nd.array(v, ctx=CPU)
                           for k, v in feed.items()}).forward()[0]
    oj = j.bind(JCPU, args={k: mx.nd.array(v, ctx=JCPU)
                            for k, v in feed.items()}).forward()[0]
    assert ot.shape == oj.shape
    np.testing.assert_allclose(ot.asnumpy(), oj.asnumpy(), rtol=1e-5,
                               atol=1e-6)


# -- 18: unknown dims and regression labels in shape inference ---------------

def _partial_graphs(p):
    a = p.sym.var("a", shape=(0, 10))
    b = p.sym.var("b", shape=(12, 0))
    data = p.sym.var("data")
    fc = p.sym.FullyConnected(data, num_hidden=1, name="fc")
    heads = [p.sym.LinearRegressionOutput(fc, p.sym.var("lbl")),
             p.sym.MAERegressionOutput(fc, p.sym.var("lbl")),
             p.sym.LogisticRegressionOutput(fc, p.sym.var("lbl"))]
    x = p.sym.var("x", shape=(0, 3, 0, 0))
    conv = p.sym.Convolution(x, kernel=(3, 3), num_filter=2, pad=(1, 1),
                             name="cv")
    y = p.sym.var("y", shape=(4, 2, 5, 5))
    return a + b, heads, conv + y


def test_partial_shapes_and_regression_labels():
    (et, ht, ct), (ej, hj, cj) = _partial_graphs(mt), _partial_graphs(mx)
    assert et.infer_shape() == ej.infer_shape()
    assert et.infer_shape()[0] == [(12, 10), (12, 10)]
    for t, j in zip(ht, hj):
        assert t.infer_shape(data=(4, 8)) == j.infer_shape(data=(4, 8))
        assert t.infer_shape(data=(4, 8))[0][-1] == (4, 1)
    assert ct.infer_shape() == cj.infer_shape()
    assert ct.infer_shape()[0][0] == (4, 3, 5, 5)
    # a graph with every shape known infers what it inferred before
    full = mt.sym.FullyConnected(mt.sym.var("d"), num_hidden=3) + \
        mt.sym.var("e")
    assert full.infer_shape(d=(2, 5), e=(2, 3)) == \
        (mx.sym.FullyConnected(mx.sym.var("d"), num_hidden=3)
         + mx.sym.var("e")).infer_shape(d=(2, 5), e=(2, 3))


# -- 19: shared_module and Predictor's outputs and input types ---------------

def _head(p):
    return p.sym.SoftmaxOutput(
        p.sym.FullyConnected(p.sym.var("data"), num_hidden=4, name="fcs"),
        p.sym.var("softmax_label"), name="sm")


def test_bind_shared_module():
    params = {"fcs_weight": RS.randn(4, 6).astype(np.float32),
              "fcs_bias": RS.randn(4).astype(np.float32)}
    outs = []
    for p, c in ((mt, CPU), (mx, JCPU)):
        train = p.mod.Module(_head(p), context=c)
        train.bind(data_shapes=[("data", (8, 6))],
                   label_shapes=[("softmax_label", (8,))])
        train.init_params(arg_params={k: p.nd.array(v, ctx=c)
                                      for k, v in params.items()})
        val = p.mod.Module(_head(p), context=c)
        val.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))],
                 for_training=False, shared_module=train)
        assert val.params_initialized
        assert val._exec.arg_dict["fcs_weight"] is \
            train._exec.arg_dict["fcs_weight"]
        train._exec.arg_dict["fcs_bias"][:] = 0.25
        val.forward(p.io.DataBatch([p.nd.array(X[:, :6], ctx=c)],
                                   [p.nd.zeros((4,), ctx=c)]),
                    is_train=False)
        outs.append(val.get_outputs()[0].asnumpy())
        wrong = p.mod.Module(_head(p), context=c)
        with pytest.raises(ValueError, match="fcs_weight"):
            wrong.bind(data_shapes=[("data", (4, 10))],
                       label_shapes=[("softmax_label", (4,))],
                       for_training=False, shared_module=train)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def _two_heads(p):
    data = p.sym.var("data")
    fc = p.sym.FullyConnected(data, num_hidden=3, name="r")
    return p.sym.Group([p.sym.relu(fc, name="act"), fc])


def test_predictor_output_names_and_input_types():
    w = RS.randn(3, 5).astype(np.float32)
    b = RS.randn(3).astype(np.float32)
    x = RS.randn(1, 5).astype(np.float32)
    for p in (mt, mx):
        sym = _two_heads(p)
        ctx = CPU if p is mt else JCPU
        blob = p.serialization.dumps_ndarrays(
            {"arg:r_weight": p.nd.array(w, ctx=ctx),
             "arg:r_bias": p.nd.array(b, ctx=ctx)})
        kw = {"ctx": ctx} if p is mt else {}
        pred = p.Predictor(sym.tojson(), blob, {"data": (1, 5)},
                           output_names=["r_output"], **kw)
        pred.forward(data=x)
        out = pred.get_output(0)
        out = out.asnumpy() if hasattr(out, "asnumpy") else np.asarray(out)
        assert out.shape == (1, 3)
        np.testing.assert_allclose(out, x @ w.T + b, rtol=1e-5, atol=1e-6)
    ids = np.array([[1, -2, 3, 0, 5]], np.int8)
    outs = []
    for p in (mt, mx):
        ctx = CPU if p is mt else JCPU
        sym = p.sym.cast(p.sym.var("data"), dtype="float32") * 2
        kw = {"ctx": ctx} if p is mt else {}
        pred = p.Predictor(sym.tojson(), b"", {"data": (1, 5)},
                           input_types={"data": np.int8}, **kw)
        pred.forward(data=ids)
        out = pred.get_output(0)
        outs.append(out.asnumpy() if hasattr(out, "asnumpy")
                    else np.asarray(out))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], ids.astype(np.float32) * 2)


# -- 20: repeated profiler dumps --------------------------------------------

def test_profiler_dump_false_repeats(tmp_path):
    for p, c in ((mt, CPU), (mx, JCPU)):
        fname = str(tmp_path / f"{p.__name__}.json")
        p.profiler.set_config(filename=fname)
        p.profiler.set_state("run")
        last = 0
        for i in range(3):
            (p.nd.ones((20, 20), ctx=c) * i).asnumpy()
            p.profiler.dump(False)
            size = os.path.getsize(fname) if os.path.exists(fname) else 0
            assert size >= last
            last = size
        p.profiler.set_state("stop")
    with open(str(tmp_path / "mxnet_tpu_torch.json")) as f:
        assert json.load(f)["traceEvents"]


# -- 21: %= in place, the __div__ spellings ----------------------------------

def test_inplace_mod_and_div_aliases():
    for p, c in ((mt, CPU), (mx, JCPU)):
        x = p.nd.array([5.0, 7.0], ctx=c)
        y = x
        x %= 3
        assert y is x
        np.testing.assert_array_equal(y.asnumpy(), [2.0, 1.0])
        z = p.nd.array([6.0, 9.0], ctx=c)
        np.testing.assert_array_equal(z.__div__(3).asnumpy(), [2.0, 3.0])
        np.testing.assert_array_equal(z.__rdiv__(18).asnumpy(), [3.0, 2.0])
        w = z
        z.__idiv__(3)
        assert w is z
        np.testing.assert_array_equal(w.asnumpy(), [2.0, 3.0])


# -- 22: nd.zeros(stype=), fresh element views ------------------------------

@pytest.mark.parametrize("stype", ["csr", "row_sparse", "default"])
def test_zeros_stype_and_fresh_views(stype):
    t, j = _both(lambda p, c: p.nd.zeros((2, 3), ctx=c, stype=stype))
    assert t.stype == j.stype == stype
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    for p, err in ((mt, TError), (mx, JError)):
        with pytest.raises(err):
            p.nd.zeros((5,), stype="csr")
    views = []
    for p, c in ((mt, CPU), (mx, JCPU)):
        s = p.nd.array(np.eye(3, dtype=np.float32), ctx=c).tostype(
            "row_sparse" if stype == "row_sparse" else "csr")
        v = s[0, 0]
        assert v.asscalar() == 1.0
        s[:] = np.zeros((3, 3), np.float32)
        views.append(v.asscalar())
    assert views == [0.0, 0.0]


# -- 23: deferred sampler errors --------------------------------------------

SAMPLERS = [("normal", {"loc": 0, "scale": -1}),
            ("gamma", {"alpha": -1, "beta": 1}),
            ("exponential", {"lam": -0.5}),
            ("poisson", {"lam": -4}),
            ("negative_binomial", {"k": 2, "p": 1.5})]


@pytest.mark.parametrize("name,kwargs", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_deferred_sampler_errors(name, kwargs):
    for p, c, err in ((mt, CPU, TError), (mx, JCPU, JError)):
        with c:
            bad = getattr(p.nd.random, name)(shape=(2, 2), **kwargs)
            assert bad.shape == (2, 2)
            chained = p.nd.dot(p.nd.ones((2, 2)), bad)
            for arr in (bad, chained, bad[0], bad.copy(),
                        bad.reshape((4,))):
                with pytest.raises(err):
                    arr.asnumpy()
            with pytest.raises(err):
                chained.wait_to_read()
            good = p.nd.random.normal(0, 1, (2, 2))
            assert good.asnumpy().shape == (2, 2)
            dst = p.nd.zeros((2, 2))
            p.nd.random.normal(0, -1, shape=(2, 2), out=dst)
            with pytest.raises(err):
                dst.asnumpy()
            p.nd.random.normal(0, 1, shape=(2, 2), out=dst)
            assert dst.asnumpy().shape == (2, 2)
    with CPU:
        kept = mt.nd.random.normal(0, -1, shape=(2,))
        with pytest.raises(TError):
            mt.nd.waitall()
        mt.nd.waitall()          # raised once, as MXNet's WaitForAll
        del kept


def test_deferred_error_reaches_gradients():
    for p, c, err in ((mt, CPU, TError), (mx, JCPU, JError)):
        with c:
            w = p.nd.ones((2, 2))
            w.attach_grad()
            bad = p.nd.random.normal(0, -1, (2, 2))
            with p.autograd.record():
                loss = (w * bad).sum()
            loss.backward()
            with pytest.raises(err):
                w.grad.asnumpy()
            with p.autograd.record():
                loss = (w * 2.0).sum()
            loss.backward()
            np.testing.assert_allclose(w.grad.asnumpy(), 2.0)


# -- 24: config, the two knobs, nd.imdecode, gluon.utils.download ------------

def test_config_surface_and_knobs(monkeypatch):
    from mxnet_tpu import config as jc
    from mxnet_tpu_torch import config as tc
    jr, tr = jc.registry(), tc.registry()
    for name in ("MXTPU_GRAPH_OPT_VERIFY", "MXTPU_CONV_LAYOUT"):
        assert name in tr
    for name, spec in tr.items():
        ref = jr[name]
        assert (spec.default, spec.status) == (ref.default, ref.status), \
            name
        assert spec.type.__name__ == ref.type.__name__ or \
            spec.type(ref.default) == ref.default, name
    assert tc.ACTIVE == jc.ACTIVE and tc.SUBSUMED == jc.SUBSUMED
    tc.set_env("MXTPU_GRAPH_OPT_VERIFY", 1)
    assert tc.get_env("MXTPU_GRAPH_OPT_VERIFY") == "1"
    monkeypatch.delenv("MXTPU_GRAPH_OPT_VERIFY")
    assert "MXTPU_CONV_LAYOUT" in tc.summary()


def test_graph_opt_verify_and_channels_last(monkeypatch):
    from mxnet_tpu_torch import graph_opt
    from mxnet_tpu_torch.ops import nn as tnn
    monkeypatch.setenv("MXTPU_GRAPH_OPT_VERIFY", "1")
    x = mt.sym.var("x")
    h = mt.sym.FullyConnected(x, num_hidden=3, name="f")
    sym = mt.sym.make_loss((mt.sym.relu(h) + mt.sym.relu(h)).sum())
    feed = {"x": torch.randn(2, 4), "f_weight": torch.randn(3, 4),
            "f_bias": torch.randn(3)}
    opt, reports = graph_opt.training_result(sym, verify_feed=feed,
                                             verify_key=0)
    assert opt is not sym and any(r.rewrites for r in reports)
    assert graph_opt.verify_bitwise(sym, opt, feed, 0, train=True)
    img = RS.randn(2, 3, 7, 7).astype(np.float32)
    wt = RS.randn(4, 3, 3, 3).astype(np.float32)

    def conv_pool(p, c):
        d = p.nd.array(img, ctx=c)
        y = p.nd.Convolution(d, p.nd.array(wt, ctx=c), kernel=(3, 3),
                             num_filter=4, no_bias=True, pad=(1, 1))
        return p.nd.Pooling(y, kernel=(2, 2), stride=(2, 2),
                            pool_type="max").asnumpy()
    ref = conv_pool(mx, JCPU)
    monkeypatch.setattr(tnn, "_NHWC_LAYOUT", True)
    np.testing.assert_allclose(conv_pool(mt, CPU), ref, rtol=1e-5,
                               atol=1e-5)


def test_imdecode_and_download(tmp_path):
    from PIL import Image
    pixels = RS.randint(0, 255, (5, 7, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, format="PNG")
    png = buf.getvalue()
    t, j = mt.nd.imdecode(png), mx.nd.imdecode(png)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(t.asnumpy(), pixels)
    t = mt.nd.imdecode(png, clip_rect=(1, 1, 4, 3), mean=10.0)
    j = mx.nd.imdecode(png, clip_rect=(1, 1, 4, 3), mean=10.0)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy())
    src = tmp_path / "src.bin"
    src.write_bytes(b"weights")
    for p in (mt, mx):
        out = p.gluon.utils.download(f"file://{src}",
                                     path=str(tmp_path / p.__name__))
        with open(out, "rb") as f:
            assert f.read() == b"weights"


# -- 25: the context an NDArray keeps ---------------------------------------

def test_ndarray_keeps_its_context():
    c1t, c1j = mt.cpu(1), mx.cpu(1)
    t, j = mt.nd.zeros((2,), ctx=c1t), mx.nd.zeros((2,), ctx=c1j)
    assert str(t.context) == str(j.context) == "cpu(1)"
    assert str((t + 1).context) == str((j + 1).context) == "cpu(1)"
    assert str(t[0:1].context) == "cpu(1)"
    assert str(mt.nd.array(X, ctx=mt.cpu_pinned(2)).context) == \
        "cpu_pinned(2)"
    moved_t, moved_j = t.as_in_context(mt.cpu(0)), j.as_in_context(mx.cpu(0))
    assert moved_t is not t and moved_j is not j
    assert str(moved_t.context) == str(moved_j.context) == "cpu(0)"
    assert t.as_in_context(c1t) is t
    moved_t[:] = 5
    assert (t.asnumpy() == 0).all()
    for p in (mt, mx):
        x = p.gluon.Parameter("x", shape=(3,))
        x.initialize(ctx=[p.cpu(0), p.cpu(1)], init="ones")
        assert str(x.data(p.cpu(1)).context) == "cpu(1)"
        assert str(x.grad(p.cpu(0)).context) == "cpu(0)"
        assert [str(d.context) for d in x.list_data()] == \
            ["cpu(0)", "cpu(1)"]


# -- 26: linalg_potrf reads A's symmetric part ------------------------------

def test_potrf_symmetric_part_and_gradient():
    rs = np.random.RandomState(26)
    m = rs.randn(4, 4)
    a = (m @ m.T + 4 * np.eye(4)).astype(np.float32)
    a[0, 2] += 0.3      # not symmetric: every element counts
    head = rs.randn(4, 4).astype(np.float32)
    res = {}
    for p, c in ((mt, CPU), (mx, JCPU)):
        x = p.nd.array(a, ctx=c)
        x.attach_grad()
        with p.autograd.record():
            out = p.nd.linalg_potrf(x)
            loss = (out * p.nd.array(head, ctx=c)).sum()
        loss.backward()
        res[p] = out.asnumpy(), x.grad.asnumpy()
    (ot, gt), (oj, gj) = res[mt], res[mx]
    np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5)

    # central differences of the port's own forward, in float64
    def f(x):
        with CPU:
            return float((mt.nd.linalg_potrf(mt.nd.array(x, dtype="float64"))
                          .asnumpy() * head).sum())
    a64, eps, fd = a.astype(np.float64), 1e-6, np.zeros((4, 4))
    for i in range(4):
        for j in range(4):
            d = np.zeros((4, 4))
            d[i, j] = eps
            fd[i, j] = (f(a64 + d) - f(a64 - d)) / (2 * eps)
    np.testing.assert_allclose(gt, fd, rtol=1e-4, atol=1e-5)


# -- 27-29: the multi-tensor update against the per-parameter one -----------

_SHAPES = [(3, 4), (7,), (2, 3, 2), (1,), (5, 1)]
_MIXED = ["float32", "bfloat16", "float32", "bfloat16", "float32"]


def _updater_run(p, multi, make_opt, dtypes, steps=5):
    rng = np.random.RandomState(3)
    base_w = [rng.randn(*s).astype(np.float32) for s in _SHAPES]
    base_g = [rng.randn(*s).astype(np.float32) for s in _SHAPES]
    ctx = CPU if p is mt else JCPU
    ws = [p.nd.array(w, ctx=ctx, dtype=dt) for w, dt in zip(base_w, dtypes)]
    upd = p.optimizer.get_updater(make_opt(p))
    for step in range(steps):
        items = [(i, p.nd.array(g * (0.5 + 0.25 * step), ctx=ctx,
                                dtype=w.dtype), w)
                 for i, (g, w) in enumerate(zip(base_g, ws))]
        if multi:
            assert upd.update_multi(items), "no multi-tensor plan"
        else:
            for i, g, w in items:
                upd(i, g, w)
    return ws, upd


def _flat_states(upd):
    out = []
    for i in sorted(upd.states):
        st = upd.states[i]
        for s in (st if isinstance(st, tuple) else (st,)):
            if s is not None:
                out.append(s.data.float().numpy())
    return out


@pytest.mark.parametrize("make_opt,dtypes", [
    # 29: bfloat16 weights beside float32 ones, no master copies
    (lambda p: p.optimizer.SGD(learning_rate=0.05, momentum=0.9), _MIXED),
    # 27: master copies and momenta (multi_mp_sgd_mom_update)
    (lambda p: p.optimizer.SGD(learning_rate=0.05, momentum=0.9,
                               multi_precision=True), ["bfloat16"] * 5),
    (lambda p: p.optimizer.SGD(learning_rate=0.05, multi_precision=True),
     ["bfloat16", "bfloat16", "float32", "bfloat16", "float32"]),
    # 28: Ftrl's z and n
    (lambda p: p.optimizer.Ftrl(learning_rate=0.1, wd=1e-3), ["float32"] * 5),
], ids=["sgd-mixed-dtypes", "mp-sgd-momentum", "mp-sgd", "ftrl"])
def test_multi_tensor_update_matches_per_parameter(make_opt, dtypes):
    w_m, u_m = _updater_run(mt, True, make_opt, dtypes)
    w_p, u_p = _updater_run(mt, False, make_opt, dtypes)
    for a, b in zip(w_m, w_p):
        assert torch.equal(a.data, b.data)
    for a, b in zip(_flat_states(u_m), _flat_states(u_p)):
        assert np.array_equal(a, b)
    w_j, _ = _updater_run(mx, False, make_opt, dtypes)
    for a, b, dt in zip(w_m, w_j, dtypes):
        b = np.asarray(b.asnumpy(), np.float32)
        tol = 1e-6 if dt == "float32" else 1e-2
        assert np.abs(a.asnumpy() - b).max() <= tol * max(np.abs(b).max(), 1)


def test_ftrl_master_copies_take_the_loop():
    for p in (mt, mx):
        ctx = CPU if p is mt else JCPU
        w = p.nd.array(X, ctx=ctx, dtype="bfloat16")
        upd = p.optimizer.get_updater(p.optimizer.Ftrl(multi_precision=True))
        assert upd.update_multi([(0, p.nd.array(X, ctx=ctx,
                                                dtype="bfloat16"), w)]) \
            is False


# -- 30: Executor.fused_train_step ------------------------------------------

def _mlp(p):
    net = p.sym.FullyConnected(p.sym.var("data"), num_hidden=12, name="fc1")
    net = p.sym.Activation(net, act_type="relu")
    net = p.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return p.sym.SoftmaxOutput(net, p.sym.var("sm_label"), name="sm")


def _mlp_module(p, opt, **kw):
    ctx = CPU if p is mt else JCPU
    rs = np.random.RandomState(30)
    mod = p.mod.Module(_mlp(p), label_names=("sm_label",), context=ctx)
    mod.bind(data_shapes=[("data", (6, 5))],
             label_shapes=[("sm_label", (6,))])
    shapes = dict(zip(mod._exec.arg_names, _mlp(p).infer_shape(
        data=(6, 5), sm_label=(6,))[0]))
    mod.init_params(arg_params={
        n: p.nd.array(0.3 * rs.randn(*shapes[n]).astype(np.float32),
                      ctx=ctx)
        for n in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias")})
    mod.init_optimizer(optimizer=opt, optimizer_params=kw)
    return mod


def test_executor_fused_train_step(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_STEP", "1")
    rs = np.random.RandomState(31)
    data = rs.randn(6, 5).astype(np.float32)
    label = (np.arange(6) % 4).astype(np.float32)
    res = []
    for p in (mt, mx):
        ctx = CPU if p is mt else JCPU
        mod = _mlp_module(p, "sgd", learning_rate=0.1, momentum=0.9,
                          rescale_grad=1.0 / 6)
        feed = {"data": p.nd.array(data, ctx=ctx),
                "sm_label": p.nd.array(label, ctx=ctx)}
        for _ in range(2):
            outs = mod._exec.fused_train_step(mod._optimizer, mod._updater,
                                              feed)
        res.append((outs[0].asnumpy(),
                    {k: v.asnumpy() for k, v in mod.get_params()[0].items()}))
        bare = _mlp_module(p, "adadelta")
        with pytest.raises((TError, JError), match="fused"):
            bare._exec.fused_train_step(bare._optimizer, bare._updater, feed)
    (ot, pt), (oj, pj) = res
    np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-6)
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-5, atol=1e-6)


# -- 31: bfloat16 through infer_type and simple_bind ------------------------

def _typed(p):
    e = p.sym.Embedding(p.sym.var("data"), p.sym.var("w", dtype="bfloat16"),
                        input_dim=10, output_dim=4, dtype="bfloat16",
                        name="emb")
    h = p.sym.LayerNorm(p.sym.FullyConnected(e, num_hidden=3,
                                             flatten=False, name="fc"),
                        name="ln")
    return p.sym.SoftmaxOutput(p.sym.reshape(h, shape=(-1, 3)),
                               p.sym.reshape(p.sym.var("lab"), shape=(-1,)),
                               name="sm")


def test_infer_type_keeps_bfloat16():
    from mxnet_tpu_torch.base import dtype_name
    (ta, to, _), (ja, jo, _) = _both(
        lambda p, c: _typed(p).infer_type(data="float32", lab="float32"))
    assert [dtype_name(t) for t in ta] == [np.dtype(j).name for j in ja]
    assert [dtype_name(t) for t in to] == [np.dtype(j).name for j in jo]
    assert ta[1] is torch.bfloat16 and ta[0] == np.float32
    exe = _typed(mt).simple_bind(
        ctx=CPU, type_dict={"data": "float32", "lab": "float32"},
        data=(2, 5), lab=(2, 5))
    assert exe.arg_dict["fc_weight"].data.dtype == torch.bfloat16
    assert exe.arg_dict["data"].data.dtype == torch.float32


# -- 32: the graph pass reports as dicts -------------------------------------

def test_pass_report_dicts():
    def dicts(p):
        x = p.sym.var("data")
        net = p.sym.broadcast_add(p.sym.sigmoid(x), p.sym.sigmoid(x))
        res = p.graph_opt.optimize(net, train=False)
        return [dict(d, wall_ms=0.0) for d in res.report_dicts()], \
            [r.to_dict()["name"] for r in res.reports]
    (td, tn), (jd, jn) = _both(lambda p, c: dicts(p))
    assert tn == jn
    for a, b in zip(td, jd):
        assert set(a) == set(b)
        assert {k: a[k] for k in ("name", "nodes_before", "nodes_after",
                                  "rewrites", "parity")} == \
            {k: b[k] for k in ("name", "nodes_before", "nodes_after",
                               "rewrites", "parity")}


# -- 33: the dispatch counts of the per-parameter step -----------------------

def test_unfused_step_dispatch_counts(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_STEP", "0")
    rs = np.random.RandomState(33)
    counts = []
    for p in (mt, mx):
        ctx = CPU if p is mt else JCPU
        mod = _mlp_module(p, "sgd", learning_rate=0.1, momentum=0.9)
        batch = p.io.DataBatch(
            [p.nd.array(rs.randn(6, 5).astype(np.float32), ctx=ctx)],
            [p.nd.array((np.arange(6) % 4).astype(np.float32), ctx=ctx)])
        for _ in range(2):
            p.profiler.reset_step_counters()
            mod.forward_backward(batch)
            mod.update()
        counts.append(p.profiler.step_counters().get("dispatches", 0))
    assert counts[0] == counts[1] == 2 + 4


# -- the path 27 and 31 open: bfloat16 BERT through Module.fit ---------------

BF16_BERT = dict(num_layers=2, hidden=64, heads=4, ffn=128, vocab=97,
                 max_len=32, dropout=0.0)
BB, BL, BSTEPS = 4, 32, 3


def _bf16_fit(p, monkeypatch, fused, dtype="bfloat16"):
    """3 steps of MXNet's mixed-precision recipe (SGD, momentum 0.9,
    ``multi_precision``) on the bfloat16 BERT MLM: the module, the last
    batch's masked-LM loss."""
    from mxnet_tpu_torch.model_zoo import bert_mlm, random_params
    monkeypatch.setenv("MXTPU_FUSED_STEP", "1" if fused else "0")
    ctx = CPU if p is mt else JCPU
    sym = bert_mlm(p.sym, dtype=dtype, **BF16_BERT)
    shapes = dict(data=(BB, BL), positions=(BB, BL), mlm_label=(BB, BL))
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, seed=0)
    rng = np.random.RandomState(7)
    ids = rng.randint(0, BF16_BERT["vocab"], (BB * BSTEPS, BL)) \
        .astype(np.float32)
    lab = np.where(rng.rand(BB * BSTEPS, BL) < 0.15, ids, -1.0) \
        .astype(np.float32)
    pos = np.tile(np.arange(BL, dtype=np.float32), (BB * BSTEPS, 1))
    it = p.io.NDArrayIter({"data": ids, "positions": pos},
                          {"mlm_label": lab}, batch_size=BB)
    mod = p.mod.Module(sym, data_names=("data", "positions"),
                       label_names=("mlm_label",), context=ctx)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(learning_rate=0.1, momentum=0.9,
                                  multi_precision=True),
            arg_params={n: p.nd.array(a, ctx=ctx)
                        for n, a in params.items()})
    probs = np.asarray(mod.get_outputs()[0].asnumpy(), np.float64)
    last = lab[-BB:].reshape(-1)
    keep = last >= 0
    loss = -np.log(probs[keep, last[keep].astype(int)]).mean()
    return mod, loss


def test_bf16_bert_fit_captured_step(monkeypatch):
    mt.profiler.reset_step_counters()
    fused, loss = _bf16_fit(mt, monkeypatch, True)
    assert mt.profiler.step_counters().get("fused_steps") == BSTEPS
    eager, loss_e = _bf16_fit(mt, monkeypatch, False)
    assert loss == loss_e
    names = [n for n in fused._exec.arg_names
             if n not in ("data", "positions", "mlm_label")]
    assert all(fused._exec.arg_dict[n].data.dtype == torch.bfloat16
               for n in names)
    for n in names:
        assert torch.equal(fused._exec.arg_dict[n].data,
                           eager._exec.arg_dict[n].data), n
    for k, st in fused._updater.states.items():
        (mom, w32), (mom_e, w32_e) = st, eager._updater.states[k]
        assert w32.data.dtype == torch.float32
        assert torch.equal(mom.data, mom_e.data)
        assert torch.equal(w32.data, w32_e.data)
    jmod, jloss = _bf16_fit(mx, monkeypatch, True)
    assert abs(loss - jloss) <= 2e-2 * abs(jloss)
    jparams = jmod.get_params()[0]
    for n in names:
        a = fused._exec.arg_dict[n].asnumpy()
        b = np.asarray(jparams[n].asnumpy(), np.float32)
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), n


def test_bf16_bert_fit_sharded_profile(monkeypatch):
    """The one-rank sharded step (``MXTPU_SPMD=1``: the flat buckets carry
    the momenta and the fp32 master copies as slots) against the dense
    captured step, bit for bit."""
    monkeypatch.setenv("MXTPU_SPMD", "1")
    mt.profiler.reset_step_counters()
    with CPU:
        sharded, loss_s = _bf16_fit(mt, monkeypatch, True)
    assert mt.profiler.step_counters().get("spmd_steps") == BSTEPS
    sharded._updater.get_states()     # the flat buffers exported back
    monkeypatch.setenv("MXTPU_SPMD", "")
    dense, loss_d = _bf16_fit(mt, monkeypatch, True)
    assert loss_s == loss_d
    for n in dense._exec._grad_arg_names:
        assert torch.equal(sharded._exec.arg_dict[n].data,
                           dense._exec.arg_dict[n].data), n
    for k, st in dense._updater.states.items():
        for a, b in zip(sharded._updater.states[k], st):
            assert torch.equal(a.data, b.data), k
