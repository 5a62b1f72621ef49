"""The island plan and reshape in the port against the JAX package:
`graph_compile.deny_ops` with ``MXTPU_GRAPH_COMPILE_DENY``, the island and
fallback-node counts of a `GraphProgram` over graphs holding denied ops
equal to the JAX package's, the refusals of a program with islands
(`lower_step_fn`, the training tape), the island-plan forward equal to the
whole graph's, and the rules and messages of `Executor.reshape` and
`Module.reshape` (`tests/test_symbol_module.py`'s reshape cases and
`tests/test_graph_compile.py`'s).

Tolerance: outputs within FWD_TOL = 1e-5 of the reference's largest
magnitude; gradients GRAD_TOL = 1e-4.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import graph_compile as jgc

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import graph_compile as tgc

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, what


def _register(pkg):
    op = pkg.operator

    class _Plus(op.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] + 1)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0])

    @op.register("islands_plus1")
    class _PlusProp(op.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return _Plus()


_register(mx)
_register(mt)


def _mlp(S):
    fc1 = S.FullyConnected(S.Variable("data"), num_hidden=16, name="fc1")
    act = S.Activation(fc1, act_type="tanh", name="act")
    fc2 = S.FullyConnected(act, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(fc2, name="sm")


def _custom_mid(S):
    net = S.Custom(S.Activation(S.Variable("data"), act_type="relu"),
                   op_type="islands_plus1")
    return S.Activation(net, act_type="relu")


def _custom_twice(S):
    a = S.Custom(S.exp(S.Variable("data")), op_type="islands_plus1")
    b = S.FullyConnected(a, num_hidden=3, name="fc")
    c = S.Custom(S.tanh(b), op_type="islands_plus1")
    return S.Group([S.sin(c), S.cos(a)])


def _custom_head(S):
    return S.Custom(S.exp(S.Variable("data")), op_type="islands_plus1")


GRAPHS = {"mlp": _mlp, "custom_mid": _custom_mid,
          "custom_twice": _custom_twice, "custom_head": _custom_head}
SHAPES = {"mlp": dict(data=(8, 32), sm_label=(8,)),
          "custom_mid": dict(data=(4, 5)), "custom_twice": dict(data=(4, 5)),
          "custom_head": dict(data=(4, 5))}


def test_deny_ops_env_extends_default(monkeypatch):
    assert tgc.DEFAULT_DENY_OPS == jgc.DEFAULT_DENY_OPS == {"Custom"}
    assert tgc.deny_ops() == jgc.deny_ops()
    monkeypatch.setenv("MXTPU_GRAPH_COMPILE_DENY", "Activation, Dropout")
    assert tgc.deny_ops() == jgc.deny_ops() == \
        tgc.DEFAULT_DENY_OPS | {"Activation", "Dropout"}
    assert tgc.uncapturable_ops() == tgc.deny_ops() | {"_cond"}


def _args(name, sym, seed=0):
    arg_shapes, _, _ = sym.infer_shape(**SHAPES[name])
    rs = np.random.RandomState(seed)
    return {n: rs.randn(*s).astype(np.float32) * 0.5
            for n, s in zip(sym.list_arguments(), arg_shapes)}


@pytest.mark.parametrize("deny", ["", "Activation"], ids=["default",
                                                          "env"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_island_counts_match_reference(monkeypatch, name, deny):
    """`islands`, `fallback_nodes` and `has_islands` of each package's
    `GraphProgram` over the same graph, inference and training, and the
    island plan's outputs against the whole graph's."""
    monkeypatch.setenv("MXTPU_GRAPH_COMPILE_DENY", deny)
    for train in (False, True):
        ref = jgc.GraphProgram(GRAPHS[name](mx.sym), train)
        with mt.cpu():
            got = tgc.GraphProgram(GRAPHS[name](mt.sym), train)
        assert (got.islands, got.fallback_nodes, got.has_islands) == \
            (ref.islands, ref.fallback_nodes, ref.has_islands)
    with mt.cpu():
        sym = GRAPHS[name](mt.sym)
        args = _args(name, sym)
        whole = [o.asnumpy() for o in sym.bind(
            mt.cpu(), args={k: mt.nd.array(v) for k, v in args.items()},
            grad_req="null").forward()]
        prog = tgc.GraphProgram(sym, False)
        if prog.has_islands:
            outs = prog._forward_islands({k: torch.from_numpy(v)
                                          for k, v in args.items()})
            for o, w in zip(outs, whole):
                _close(o.numpy(), w, FWD_TOL)


def test_island_graph_refuses_the_one_graph_surfaces(monkeypatch):
    """A program with islands records no tape and has no backward of its
    own; the executor's compiled path falls back to the classic one, with
    the classic gradients."""
    monkeypatch.setenv("MXTPU_GRAPH_COMPILE_DENY", "Activation")
    with mt.cpu():
        sym = _mlp(mt.sym)
        args = _args("mlp", sym)
        prog = tgc.GraphProgram(sym, True)
        with pytest.raises(mt.MXNetError, match="fallback islands"):
            prog.forward_train({}, [], None)
        with pytest.raises(mt.MXNetError, match="fallback islands"):
            prog.backward(None, [], {}, {})
        grads = []
        for compiled in (False, True):
            ex = sym.bind(mt.cpu(), args={k: mt.nd.array(v)
                                          for k, v in args.items()},
                          args_grad={k: mt.nd.zeros(v.shape)
                                     for k, v in args.items()
                                     if k not in ("data", "sm_label")})
            if compiled:
                ex.compiled_forward(is_train=True)
                ex.compiled_backward()
            else:
                ex.forward(is_train=True)
                ex.backward()
            grads.append({k: g.asnumpy() for k, g in ex.grad_dict.items()})
    for k in grads[0]:
        assert np.array_equal(grads[0][k], grads[1][k]), k


def test_lower_step_fn_refuses_denied_ops():
    """The JAX package's message, and a working step function for a graph
    without denied ops."""
    with mt.cpu():
        with pytest.raises(mt.MXNetError) as got:
            tgc.lower_step_fn(_custom_head(mt.sym))
    with pytest.raises(mx.MXNetError) as ref:
        jgc.lower_step_fn(_custom_head(mx.sym))
    assert str(got.value) == str(ref.value)
    with mt.cpu():
        fn = tgc.lower_step_fn(mt.sym.exp(mt.sym.var("x")))
        outs, aux = fn({"x": torch.zeros(3)})
    assert outs[0].tolist() == [1.0, 1.0, 1.0] and aux == {}


def test_lower_step_fn_refuses_denied_ops_inside_bodies():
    """A Custom op inside a scan body is refused as one at the top level
    is."""
    with mt.cpu():
        S = mt.sym
        outs, _ = S.contrib.foreach(
            lambda i, s: (S.Custom(s + i, op_type="islands_plus1"), s + i),
            S.var("x"), S.var("s"))
        assert not tgc.one_graph(outs)
        with pytest.raises(mt.MXNetError, match=r"\['Custom'\]"):
            tgc.lower_step_fn(outs)


def test_one_graph_names_the_uncapturable_graphs():
    with mt.cpu():
        S = mt.sym
        x = S.var("x")
        assert tgc.one_graph(_mlp(S))
        assert not tgc.one_graph(_custom_head(S))
        assert not tgc.one_graph(S.contrib.cond(S.sum(x) > 0,
                                                lambda: x * 2,
                                                lambda: x * 3))
        outs, _ = S.contrib.foreach(lambda i, s: (s + i, s + i), x,
                                    S.var("s"))
        assert tgc.one_graph(outs)
        prog = tgc.GraphProgram(S.contrib.cond(S.sum(x) > 0, lambda: x * 2,
                                               lambda: x * 3), False)
        # the JAX package's counts (no denied op), but not one CUDA graph
        assert (prog.islands, prog.has_islands, prog.one_graph) == \
            (0, False, False)


# ---------------------------------------------------------------------------
# Executor.reshape / Module.reshape (tests/test_symbol_module.py)
# ---------------------------------------------------------------------------

def _fc_exec(pkg, name=None):
    y = pkg.sym.FullyConnected(pkg.sym.var("x"), num_hidden=4, name=name)
    return y.simple_bind(pkg.cpu(), x=(5, 4), grad_req="null")


def test_executor_reshape_reference():
    def run(pkg):
        ex = _fc_exec(pkg)
        ex.arg_arrays[0][:] = 1
        ex.arg_arrays[1][:] = pkg.nd.ones((4, 4))
        ex.arg_arrays[2][:] = 0
        new_ex = ex.reshape(x=(3, 4))
        out_new = new_ex.forward(is_train=False)[0].asnumpy()
        out_old = ex.forward(is_train=False)[0].asnumpy()
        up = ex.reshape(allow_up_sizing=True, x=(6, 4))
        up.arg_arrays[0][:] = 0
        assert np.all(ex.arg_arrays[0].asnumpy() == 1)
        assert up.arg_arrays[1] is ex.arg_arrays[1]
        up.arg_arrays[1][:] = 2
        assert np.all(ex.arg_arrays[1].asnumpy() == 2)
        return out_new, out_old

    ref = run(mx)
    with mt.cpu():
        got = run(mt)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert np.all(got[0] == 4)


def test_executor_reshape_shrink_write_through_root_buffer():
    with mt.cpu():
        ex = _fc_exec(mt)
        ex.arg_arrays[0][:] = 1
        small = ex.reshape(x=(3, 4))
        root_ptr = ex.arg_dict["x"].data.data_ptr()
        assert small.arg_dict["x"].data.data_ptr() == root_ptr
        small.arg_arrays[0][:] = 7
        old = ex.arg_arrays[0].asnumpy()
        assert np.all(old[:3] == 7) and np.all(old[3:] == 1)
        ex.arg_arrays[0][:] = 5
        assert np.all(small.arg_arrays[0].asnumpy() == 5)
        smaller = small.reshape(x=(2, 4))
        smaller.arg_arrays[0][:] = 9
        root = ex.arg_arrays[0].asnumpy()
        assert np.all(root[:2] == 9) and np.all(root[2:] == 5)
        regrown = smaller.reshape(x=(5, 4))
        assert regrown.arg_dict["x"].data.data_ptr() == root_ptr
        regrown.arg_arrays[0][:] = 3
        assert np.all(ex.arg_arrays[0].asnumpy() == 3)


def test_executor_reshape_flag_semantics_and_messages():
    """The reference's rules, with the JAX package's messages word for
    word."""
    msgs = []
    for pkg in (mx, mt):
        ctx = mt.cpu() if pkg is mt else None
        with (ctx if ctx is not None else _nullcontext()):
            ex = _fc_exec(pkg, name="fcr")
            got = []
            for kw in (dict(x=(6, 4)), dict(x=(2, 10))):
                with pytest.raises(pkg.MXNetError) as e:
                    ex.reshape(**kw)
                got.append(str(e.value))
            up = ex.reshape(partial_shaping=True, allow_up_sizing=True,
                            x=(2, 10))
            assert up.arg_dict["fcr_weight"].shape == (4, 10)
            msgs.append(got)
    assert "allow_up_sizing" in msgs[1][0]
    assert "partial_shaping" in msgs[1][1]
    assert msgs[0] == msgs[1]


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_executor_reshape_reallocates_grads_keeps_monitor_and_programs():
    with mt.cpu():
        y = mt.sym.FullyConnected(mt.sym.var("x"), num_hidden=4, name="fc")
        ex = y.simple_bind(mt.cpu(), x=(5, 4))
        seen = []
        ex.set_monitor_callback(lambda n, a: seen.append(n))
        ex.compiled_forward(is_train=False)
        new = ex.reshape(x=(3, 4))
        assert new._programs is ex._programs
        assert new._monitor is ex._monitor
        assert new.grad_dict["fc_weight"].data.data_ptr() != \
            ex.grad_dict["fc_weight"].data.data_ptr()
        new.compiled_forward(is_train=False)
        assert len(seen) == 2
        assert len(ex._programs[False]) == 2
        back = new.reshape(x=(5, 4))
        back.compiled_forward(is_train=False)
        assert len(ex._programs[False]) == 2
        assert back.graph_program(False) is ex.graph_program(False)


def test_module_reshape_matches_a_fresh_bind():
    rs = np.random.RandomState(0)
    xb = rs.randn(3, 6).astype(np.float32)

    def run(pkg):
        S = pkg.sym
        net = S.FullyConnected(S.var("data"), num_hidden=3, name="fc")
        mod = pkg.mod.Module(net, label_names=None, context=pkg.cpu())
        mod.bind([("data", (5, 6))], for_training=False)
        w = np.random.RandomState(1).randn(3, 6).astype(np.float32)
        mod.init_params(arg_params={"fc_weight": pkg.nd.array(w),
                                    "fc_bias": pkg.nd.zeros((3,))})
        arg, _ = mod.get_params()
        mod.reshape([("data", (3, 6))])
        mod.forward(pkg.io.DataBatch([pkg.nd.array(xb)]), is_train=False)
        out = mod.get_outputs()[0].asnumpy()
        fresh = pkg.mod.Module(net, label_names=None, context=pkg.cpu())
        fresh.bind([("data", (3, 6))], for_training=False)
        fresh.init_params(arg_params=arg)
        fresh.forward(pkg.io.DataBatch([pkg.nd.array(xb)]), is_train=False)
        assert mod.data_shapes[0].shape == (3, 6)
        return out, fresh.get_outputs()[0].asnumpy()

    ref = run(mx)
    with mt.cpu():
        got = run(mt)
    np.testing.assert_array_equal(got[0], got[1])
    _close(got[0], ref[0], FWD_TOL)


def test_module_forward_reshapes_on_a_ragged_batch():
    """A batch of another shape reshapes the module's executor (the
    reference's `_reshape_exec`), sharing the parameters."""
    with mt.cpu():
        S = mt.sym
        net = S.FullyConnected(S.var("data"), num_hidden=3, name="fc")
        mod = mt.mod.Module(net, label_names=None, context=mt.cpu())
        mod.bind([("data", (5, 6))], for_training=False)
        mod.init_params(initializer=mt.init.Xavier())
        w = mod._exec.arg_dict["fc_weight"]
        x = np.ones((2, 6), np.float32)
        mod.forward(mt.io.DataBatch([mt.nd.array(x)]), is_train=False)
        assert mod.get_outputs()[0].shape == (2, 3)
        assert mod._exec.arg_dict["fc_weight"] is w


def test_module_reshape_back_reuses_the_executor_and_fused_step():
    """A ragged tail batch and the change back: the module returns to the
    executor it was bound with and to its fused step (nothing rebuilt or
    recaptured), and the tail's executor and step are kept for the next
    epoch.  The weights after the five steps equal a module fed the same
    batches one shape at a time, within FWD_TOL."""
    rs = np.random.RandomState(0)
    batches = [rs.randn(n, 6).astype(np.float32) for n in (5, 2, 5, 2, 5)]
    labels = [rs.randint(0, 3, len(b)).astype(np.float32) for b in batches]
    w0 = (rs.randn(3, 6) * 0.3).astype(np.float32)

    def module(shape):
        S = mt.sym
        net = S.SoftmaxOutput(S.FullyConnected(S.var("data"), num_hidden=3,
                                               name="fc"), name="softmax")
        mod = mt.mod.Module(net, context=mt.cpu())
        mod.bind([("data", shape)], [("softmax_label", shape[:1])])
        mod.init_params(arg_params={"fc_weight": mt.nd.array(w0),
                                    "fc_bias": mt.nd.zeros((3,))})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "rescale_grad": 1.0})
        return mod

    def batch(i):
        return mt.io.DataBatch([mt.nd.array(batches[i])],
                               [mt.nd.array(labels[i])])

    with mt.cpu():
        mod = module((5, 6))
        first = mod._exec
        assert mod.fused_step(batch(0))
        fst = mod._fused_train_step
        assert mod.fused_step(batch(1))
        tail, tail_fst = mod._exec, mod._fused_train_step
        assert tail is not first and tail_fst is not fst
        assert mod.fused_step(batch(2))
        assert mod._exec is first and mod._fused_train_step is fst
        assert mod.fused_step(batch(3))
        assert mod._exec is tail and mod._fused_train_step is tail_fst
        assert mod.fused_step(batch(4))
        got = mod.get_params()[0]
        ref = module((5, 6))
        for i in range(5):
            if batches[i].shape[0] != ref._exec.arg_dict["data"].shape[0]:
                ref.reshape([("data", batches[i].shape)],
                            [("softmax_label", labels[i].shape)])
            ref.forward_backward(batch(i))
            ref.update()
        want = ref.get_params()[0]
    for k in want:
        _close(got[k].asnumpy(), want[k].asnumpy(), FWD_TOL, k)
