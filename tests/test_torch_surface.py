"""The port's NDArray and Symbol surface against the JAX package on the
CPU: `nd.save` files read by the other package both ways (lists and
dicts, dense and sparse); the fluent method sets of NDArray and Symbol,
with each method's values on the same inputs through both packages (1e-5
of the reference's largest magnitude); `infer_type`; symbol JSON under
`NameManager`, `Prefix` and `AttrScope`; `print_summary`'s text; the
module-level helpers of `nd`; `Executor.arg_arrays`/`aux_arrays` and
`Module.output_shapes`."""
import json

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ndarray.ndarray import FLUENT_OP_METHODS as J_FLUENT
from mxnet_tpu.symbol import _SYM_FLUENT_METHODS as J_SYM_FLUENT
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray.ndarray import FLUENT_OP_METHODS as T_FLUENT
from mxnet_tpu_torch.symbol import SYM_FLUENT_METHODS as T_SYM_FLUENT
from mxnet_tpu_torch.symbol import symbol as tsym

TOL = 1e-5
CPU = mt.cpu()
RS = np.random.RandomState(21)
U = RS.uniform(0.2, 0.8, (2, 3)).astype(np.float32)
S = RS.uniform(-2, 2, (2, 3)).astype(np.float32)
ROW = RS.uniform(-1, 1, (1, 3)).astype(np.float32)


@pytest.fixture(autouse=True)
def fresh_names():
    saved = [(m, dict(m.counters)) for m in (jsym._NAMES, tsym._NAMES)]
    for m, _ in saved:
        m.counters.clear()
    yield
    for m, counters in saved:
        m.counters.clear()
        m.counters.update(counters)


def _close(t, j, what):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, what
    if not np.issubdtype(j.dtype, np.floating):
        np.testing.assert_array_equal(t, j, err_msg=what)
        return
    t, j = t.astype(np.float64), j.astype(np.float64)
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t)), what
    if fin.any():
        assert np.abs(t[fin] - j[fin]).max() <= \
            TOL * max(np.abs(j[fin]).max(), 1e-30), what


# -- nd.save / nd.load ------------------------------------------------------

def _payload(pkg, ctx_kw):
    dense = RS.randn(3, 4).astype(np.float32)
    ids = np.array([[1, 0, 0, 2], [0, 0, 3, 0], [4, 0, 0, 0]], np.float32)
    return {
        "w": pkg.nd.array(dense, **ctx_kw),
        "i": pkg.nd.array(np.arange(6, dtype=np.int32), dtype="int32",
                          **ctx_kw),
        "csr": pkg.nd.sparse.csr_matrix(ids, **ctx_kw),
        "rsp": pkg.nd.array(ids, **ctx_kw).tostype("row_sparse"),
    }


@pytest.mark.parametrize("form", ["dict", "list"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_interchange(tmp_path, form, writer):
    src_pkg, dst_pkg = (mt, mx) if writer == "port" else (mx, mt)
    ctx_kw = {"ctx": CPU} if writer == "port" else {}
    data = _payload(src_pkg, ctx_kw)
    if form == "list":
        data = [data[k] for k in sorted(data)]
    path = str(tmp_path / "arrays.params")
    src_pkg.nd.save(path, data)
    loaded = dst_pkg.nd.load(path)
    with open(path, "rb") as f:
        again = dst_pkg.nd.load_frombuffer(f.read())
    if form == "dict":
        assert sorted(loaded) == sorted(data) == sorted(again)
        pairs = [(loaded[k], data[k], again[k]) for k in sorted(data)]
    else:
        pairs = list(zip(loaded, data, again))
    for got, want, buf in pairs:
        assert got.stype == want.stype == buf.stype
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        np.testing.assert_array_equal(buf.asnumpy(), want.asnumpy())
        assert got.asnumpy().dtype == want.asnumpy().dtype


# -- fluent methods -------------------------------------------------------

_UNARY = {"abs": S, "arccos": U, "arccosh": U + 1, "arcsin": U,
          "arcsinh": S, "arctan": S, "arctanh": U, "cbrt": U, "ceil": S * 3,
          "cos": S, "cosh": S, "degrees": S, "exp": S, "expm1": S,
          "fix": S * 3, "floor": S * 3, "log": U, "log10": U, "log1p": U,
          "log2": U, "radians": S, "rcbrt": U, "reciprocal": U, "relu": S,
          "rint": S * 3, "round": S * 3, "rsqrt": U, "sigmoid": S,
          "sign": S, "sin": S, "sinh": S, "sqrt": U, "square": S,
          "tan": U, "tanh": S, "trunc": S * 3, "zeros_like": S,
          "ones_like": S, "flatten": S, "shape_array": S, "size_array": S,
          "transpose": S, "sort": S, "argsort": S, "argmax_channel": S,
          "diag": RS.randn(3, 3).astype(np.float32)}
# name -> (input, further array arguments, attrs)
FLUENT_CALLS = {n: (x, [], {}) for n, x in _UNARY.items()}
FLUENT_CALLS.update({
    "sum": (S, [], {"axis": 1}), "mean": (S, [], {"axis": 0}),
    "max": (S, [], {"axis": 1}), "min": (S, [], {"axis": 1}),
    "prod": (U, [], {"axis": 1}), "nansum": (S, [], {"axis": 1}),
    "nanprod": (U, [], {"axis": 0}), "norm": (S, [], {"axis": 1}),
    "argmax": (S, [], {"axis": 1}), "argmin": (S, [], {"axis": 0}),
    "topk": (S, [], {"k": 2, "ret_typ": "value"}),
    "softmax": (S, [], {"axis": 1}), "softmin": (S, [], {"axis": 0}),
    "log_softmax": (S, [], {"axis": 1}),
    "broadcast_axes": (ROW, [], {"axis": 0, "size": 2}),
    "broadcast_to": (ROW, [], {"shape": (2, 3)}),
    "broadcast_like": (ROW, [S], {}),
    "depth_to_space": (RS.randn(1, 4, 2, 2).astype(np.float32), [],
                       {"block_size": 2}),
    "space_to_depth": (RS.randn(1, 1, 4, 4).astype(np.float32), [],
                       {"block_size": 2}),
    "one_hot": (np.array([0, 2], np.float32), [], {"depth": 3}),
    "pad": (RS.randn(1, 1, 2, 2).astype(np.float32), [],
            {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)}),
    "pick": (S, [np.array([0, 2], np.float32)], {"axis": 1}),
    "repeat": (S, [], {"repeats": 2, "axis": 0}),
    "tile": (S, [], {"reps": (2, 1)}),
    "split": (S, [], {"num_outputs": 3, "axis": 1}),
    "split_v2": (S, [3], {"axis": 1}),
    "swapaxes": (S, [], {"dim1": 0, "dim2": 1}),
    "slice_like": (S, [ROW], {}),
    "flip": (S, [], {"axis": 1}),
    "clip": (S, [], {"a_min": -0.5, "a_max": 0.5}),
    "take": (S, [np.array([1, 0, 1], np.float32)], {}),
    "reshape": (S, [], {"shape": (3, 2)}),
    "reshape_like": (S, [RS.randn(3, 2).astype(np.float32)], {}),
    "slice": (S, [], {"begin": (0, 1), "end": (2, 3)}),
    "slice_axis": (S, [], {"axis": 1, "begin": 0, "end": 2}),
    "expand_dims": (S, [], {"axis": 1}),
    "squeeze": (S.reshape(2, 1, 3), [], {"axis": 1}),
})


def test_fluent_method_sets_match_reference():
    assert tuple(T_FLUENT) == tuple(J_FLUENT)
    assert tuple(T_SYM_FLUENT) == tuple(J_SYM_FLUENT)
    for n in J_FLUENT:
        assert callable(getattr(mt.nd.NDArray, n)), n
    for n in J_SYM_FLUENT:
        assert callable(getattr(mt.sym.Symbol, n)), n
    public = lambda c: {n for n in dir(c) if not n.startswith("_")}  # noqa
    assert public(mx.nd.NDArray) <= public(mt.nd.NDArray)
    assert public(mx.sym.Symbol) <= public(mt.sym.Symbol)
    assert set(FLUENT_CALLS) == set(J_FLUENT) | set(J_SYM_FLUENT)


def _outs(o):
    return [x.asnumpy() for x in (o if isinstance(o, list) else [o])]


@pytest.mark.parametrize("name", sorted(set(J_FLUENT)))
def test_ndarray_fluent_values_match_reference(name):
    x, extra, attrs = FLUENT_CALLS[name]

    def call(pkg, ctx_kw):
        args = [pkg.nd.array(a, **ctx_kw) if isinstance(a, np.ndarray)
                else a for a in extra]
        return _outs(getattr(pkg.nd.array(x, **ctx_kw), name)(*args,
                                                              **attrs))

    for k, (t, j) in enumerate(zip(call(mt, {"ctx": CPU}), call(mx, {}))):
        _close(t, j, f"NDArray.{name} output {k}")


@pytest.mark.parametrize("name", sorted(set(J_SYM_FLUENT)))
def test_symbol_fluent_values_match_reference(name):
    x, extra, attrs = FLUENT_CALLS[name]

    def call(pkg, ctx):
        names = [f"a{i}" for i, a in enumerate(extra)
                 if isinstance(a, np.ndarray)]
        args = iter(pkg.sym.var(n) for n in names)
        sargs = [next(args) if isinstance(a, np.ndarray) else a
                 for a in extra]
        out = getattr(pkg.sym.var("x"), name)(*sargs, **attrs)
        feeds = {"x": pkg.nd.array(x, ctx=ctx)}
        feeds.update({n: pkg.nd.array(a, ctx=ctx) for n, a in
                      zip(names, [a for a in extra
                                  if isinstance(a, np.ndarray)])})
        return _outs(out.bind(ctx, args=feeds, grad_req="null").forward())

    t_out, j_out = call(mt, CPU), call(mx, mx.cpu())
    assert len(t_out) == len(j_out)
    for k, (t, j) in enumerate(zip(t_out, j_out)):
        _close(t, j, f"Symbol.{name} output {k}")


# -- symbol surface ---------------------------------------------------------

def _net(pkg):
    data = pkg.sym.var("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
    act = pkg.sym.Activation(fc, act_type="relu")
    bn = pkg.sym.BatchNorm(act, fix_gamma=False)
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(bn, num_hidden=3),
                                 name="softmax")


def test_infer_type_matches_reference():
    for kw in ({"data": "float16"}, {"data": "float32"}, {}):
        t, j = _net(mt).infer_type(**kw), None
        for m in (jsym._NAMES, tsym._NAMES):
            m.counters.clear()
        j = _net(mx).infer_type(**kw)
        assert t == j, kw
    s = mt.sym.cast(mt.sym.var("x"), dtype="int32") + mt.sym.var("y")
    js = mx.sym.cast(mx.sym.var("x"), dtype="int32") + mx.sym.var("y")
    assert s.infer_type(x="float32") == js.infer_type(x="float32")
    assert s.infer_type_partial() == js.infer_type_partial()


def test_symbol_methods_match_reference():
    t, j = _net(mt), None
    for m in (jsym._NAMES, tsym._NAMES):
        m.counters.clear()
    j = _net(mx)
    assert t.list_inputs() == j.list_inputs()
    assert t.debug_str() == j.debug_str()
    assert t.tojson_dict() == j.tojson_dict()
    assert t.get_children().list_outputs() == j.get_children().list_outputs()
    w = mt.sym.var("w", lr_mult=2.0, attr={"mood": "calm"})
    jw = mx.sym.var("w", lr_mult=2.0, attr={"mood": "calm"})
    for key in ("lr_mult", "__lr_mult__", "mood", "nothing"):
        assert w.attr(key) == jw.attr(key), key
    assert w.list_attr() == jw.list_attr()
    with pytest.raises(NotImplementedError):
        t.gradient(["data"])
    with pytest.raises(mt.base.NotImplementedForSymbol):
        t.asnumpy()
    x = mt.sym.var("x")
    out = (x * 2 + 1).eval(ctx=CPU, x=mt.nd.array(U, ctx=CPU))
    np.testing.assert_allclose(out[0].asnumpy(), U * 2 + 1, rtol=1e-6)


def _scoped_json(pkg):
    with pkg.name.NameManager():
        with pkg.name.Prefix("stage1_"):
            with pkg.AttrScope(ctx_group="dev1", mood="calm"):
                x = pkg.sym.var("data")
                y = pkg.sym.FullyConnected(x, num_hidden=3)
            with pkg.AttrScope(ctx_group="dev2"):
                z = pkg.sym.Activation(y, act_type="tanh")
        return pkg.sym.FullyConnected(z, num_hidden=2, name="head").tojson()


def test_json_under_name_and_attr_scopes_matches_reference():
    t = _scoped_json(mt)
    for m in (jsym._NAMES, tsym._NAMES):
        m.counters.clear()
    j = _scoped_json(mx)
    assert json.loads(t) == json.loads(j)
    names = [n["name"] for n in json.loads(t)["nodes"]]
    assert "stage1_fullyconnected0" in names and "head" in names
    assert mt.name.Prefix("p_").get("w", "fc") == \
        mx.name.Prefix("p_").get("w", "fc")


def test_print_summary_text_matches_reference(capsys):
    t = mt.visualization.print_summary(_net(mt), shape={"data": (2, 5)})
    for m in (jsym._NAMES, tsym._NAMES):
        m.counters.clear()
    j = mx.visualization.print_summary(_net(mx), shape={"data": (2, 5)})
    assert t == j
    assert "Total params: " in t
    assert mt.viz.print_summary is mt.visualization.print_summary


# -- nd helpers, Executor, Module ------------------------------------------

def test_nd_helpers_match_reference():
    a, b = S, U
    for name in ("add", "subtract", "multiply", "divide", "modulo",
                 "power", "maximum", "minimum", "equal", "not_equal",
                 "greater", "greater_equal", "lesser", "lesser_equal",
                 "logical_and", "logical_or", "logical_xor"):
        for lhs, rhs in ((a, b), (a, 0.5), (0.5, b)):
            def wrap(pkg, v, ctx_kw):
                return pkg.nd.array(v, **ctx_kw) \
                    if isinstance(v, np.ndarray) else v
            t = getattr(mt.nd, name)(wrap(mt, lhs, {"ctx": CPU}),
                                     wrap(mt, rhs, {"ctx": CPU}))
            j = getattr(mx.nd, name)(wrap(mx, lhs, {}), wrap(mx, rhs, {}))
            _close(t.asnumpy(), j.asnumpy(), f"{name}({type(lhs)}, "
                                             f"{type(rhs)})")
    _close(mt.nd.eye(4, 3, 1, ctx=CPU).asnumpy(),
           mx.nd.eye(4, 3, 1).asnumpy(), "eye")
    parts = [mt.nd.array(a, ctx=CPU), mt.nd.array(b, ctx=CPU)]
    _close(mt.nd.concatenate(parts, axis=1).asnumpy(),
           mx.nd.concatenate([mx.nd.array(a), mx.nd.array(b)],
                             axis=1).asnumpy(), "concatenate")
    out_t = mt.nd.zeros((2, 4), ctx=CPU)
    out_j = mx.nd.zeros((2, 4))
    mt.nd.onehot_encode(mt.nd.array([1, 3], ctx=CPU), out_t)
    mx.nd.onehot_encode(mx.nd.array([1, 3]), out_j)
    _close(out_t.asnumpy(), out_j.asnumpy(), "onehot_encode")
    for t, j in zip(mt.nd.split_v2(mt.nd.array(a, ctx=CPU), (1,), axis=1),
                    mx.nd.split_v2(mx.nd.array(a), (1,), axis=1)):
        _close(t.asnumpy(), j.asnumpy(), "split_v2")
    assert mt.nd._internal._square_sum is mt.nd._square_sum
    assert mt.nd.CSRNDArray is mt.nd.sparse.CSRNDArray
    assert mt.nd.RowSparseNDArray is mt.nd.sparse.RowSparseNDArray
    x = mt.nd.array(a, ctx=CPU)
    v = x.version
    x[:] = 1.0
    assert x.version == v + 1 and x.ctx == CPU
    np.testing.assert_array_equal(
        mt.nd.from_dlpack(x.to_dlpack_for_read()).asnumpy(), x.asnumpy())


def test_scatter_set_nd_matches_reference():
    lhs = RS.randn(3, 4).astype(np.float32)
    rhs = np.array([5.0, 6.0], np.float32)
    idx = np.array([[0, 2], [1, 3]], np.float32)
    t = mt.nd._scatter_set_nd(*[mt.nd.array(v, ctx=CPU)
                                for v in (lhs, rhs, idx)])
    j = mx.nd._scatter_set_nd(*[mx.nd.array(v) for v in (lhs, rhs, idx)])
    _close(t.asnumpy(), j.asnumpy(), "_scatter_set_nd")


def test_executor_arrays_and_module_output_shapes():
    net = _net(mt)
    ex = net.simple_bind(CPU, data=(2, 5), softmax_label=(2,))
    assert [a.shape for a in ex.arg_arrays] == \
        [ex.arg_dict[n].shape for n in net.list_arguments()]
    assert [a.shape for a in ex.aux_arrays] == [(4,), (4,)]
    mod = mt.mod.Module(_net(mt), context=CPU)
    mod.bind(data_shapes=[("data", (2, 5))],
             label_shapes=[("softmax_label", (2,))])
    for m in (jsym._NAMES, tsym._NAMES):
        m.counters.clear()
    jmod = mx.mod.Module(_net(mx), context=mx.cpu())
    jmod.bind(data_shapes=[("data", (2, 5))],
              label_shapes=[("softmax_label", (2,))])
    assert mod.output_shapes == jmod.output_shapes == [
        ("softmax_output", (2, 3))]


def test_simple_bind_takes_inferred_dtypes():
    """float16 data gives float16 parameters and moving statistics, as the
    JAX package's `simple_bind` infers them (`infer_type`); float64 data
    float64 ones in the port (the JAX package narrows float64 without
    x64)."""
    def dtypes(pkg, ctx, dtype):
        net = _net(pkg)
        ex = net.simple_bind(ctx, type_dict={"data": dtype},
                             data=(2, 5), softmax_label=(2,))
        return ({n: ex.arg_dict[n].asnumpy().dtype
                 for n in net.list_arguments()},
                {n: ex.aux_dict[n].asnumpy().dtype
                 for n in net.list_auxiliary_states()})

    t = dtypes(mt, CPU, "float16")
    for m in (jsym._NAMES, tsym._NAMES):
        m.counters.clear()
    assert t == dtypes(mx, mx.cpu(), "float16")
    assert t[0]["fc_weight"] == np.float16
    for m in (jsym._NAMES, tsym._NAMES):
        m.counters.clear()
    args, aux = dtypes(mt, CPU, "float64")
    assert set(args.values()) | set(aux.values()) == {np.dtype(np.float64)}


# -- the port is whole -------------------------------------------------------

import importlib  # noqa: E402
import os  # noqa: E402

_JAX_ROOT = os.path.dirname(mx.__file__)
_PORT_ROOT = os.path.dirname(mt.__file__)
# the one file of the JAX package whose counterpart has another name
_RENAMED = {"ops/pallas_kernels.py": "ops/hopper_kernels.py"}
# names of the JAX package's `__all__` that are JAX's own and have no
# meaning in the port, each with the reason
_JAX_ONLY = {
    "mxnet_tpu": {"tpu": "a TPU context", "num_tpus": "TPU devices"},
    "mxnet_tpu.context": {"tpu": "a TPU context", "num_tpus": "TPU devices"},
    "mxnet_tpu.analysis": {
        "audit_callable": "audits a jaxpr", "audit_jaxpr": "audits a jaxpr"},
    "mxnet_tpu.analysis.program_audit": {
        n: "audits a jaxpr or its lowering" for n in (
            "HOST_CALLBACK_PRIMITIVES", "audit_jaxpr", "audit_lowered",
            "audit_callable", "abstractify")},
    "mxnet_tpu.autograd": {
        "Node": "a node of the JAX package's own tape; the port records "
                "on torch's"},
    "mxnet_tpu.executor": {
        "bind_symbol_function": "the jitted graph function of the JAX "
                                "package's SymbolBlock; the port's runs its "
                                "graph through GraphProgram"},
    "mxnet_tpu.fused_step": {"TracedAttrs": "attrs holding jax tracers"},
    "mxnet_tpu.unified_step": {"TracedAttrs": "attrs holding jax tracers"},
    "mxnet_tpu.gluon.model_zoo.model_store": {
        "get_model_file": "model_store stays refused (no weights may be "
                          "fetched)",
        "purge": "model_store stays refused"},
    "mxnet_tpu.ndarray.ndarray": {"from_jax": "wraps a jax.Array"},
    "mxnet_tpu.ops.pallas_kernels": {
        "use_interpret": "Pallas's interpret mode"},
    "mxnet_tpu.ops.registry": {
        "compiled_op": "the jit cache of an op",
        "index_dtype": "the x64-off index policy (the port keeps int64)"},
    "mxnet_tpu.random": {
        "next_key": "threefry keys", "host_next_key": "threefry keys",
        "key_provider": "threefry keys"},
}


def _jax_files():
    out = []
    for dirpath, _dirs, files in os.walk(_JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f),
                                           _JAX_ROOT))
    return sorted(out)


def _module_name(pkg, rel):
    parts = rel[:-3].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([pkg] + parts)


def test_every_module_has_its_counterpart():
    """Every `.py` file of `mxnet_tpu/` has its counterpart at the same
    path under `mxnet_tpu_torch/` (`ops/pallas_kernels.py` is
    `ops/hopper_kernels.py`)."""
    files = _jax_files()
    assert len(files) >= 186
    missing = [f for f in files if not os.path.isfile(
        os.path.join(_PORT_ROOT, _RENAMED.get(f, f)))]
    assert not missing, missing


@pytest.mark.parametrize("rel", _jax_files())
def test_public_names_have_their_counterparts(rel):
    """Every name in a JAX module's `__all__` exists in its counterpart,
    but for the JAX-only names of ``_JAX_ONLY``."""
    jname = _module_name("mxnet_tpu", rel)
    jmod = importlib.import_module(jname)
    names = getattr(jmod, "__all__", None)
    if names is None:
        return
    tmod = importlib.import_module(
        _module_name("mxnet_tpu_torch", _RENAMED.get(rel, rel)))
    only = _JAX_ONLY.get(jname, {})
    assert set(only) <= set(names), jname
    missing = [n for n in names if n not in only and not hasattr(tmod, n)]
    assert not missing, f"{tmod.__name__} lacks {missing}"
