"""Python custom ops in the port against the JAX package, case for case
with `tests/test_custom_registry_op.py`: ``Custom`` as a registry op
(symbolic forward and backward, several outputs, inside a hybridized
block), the eager ``nd.Custom`` on the tape, and the numpy softmax head of
`example/numpy-ops/custom_softmax.py` training a `Module` through ``fit``
in both packages.  Each prop is registered in both packages from the same
code.

Tolerances: forward results within FWD_TOL = 1e-5 of the reference's
largest magnitude, gradients and trained weights within GRAD_TOL = 1e-4.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ops import apply_op as japply

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import cached_op
from mxnet_tpu_torch.ops import registry as treg

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, what


def _register(pkg):
    """The test props and the example's numpy softmax head in ``pkg``."""
    op = pkg.operator

    @op.register("tsqr_reg")
    class SqrProp(op.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            scale = self.scale

            class Sqr(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[0] * scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2.0 * scale * in_data[0] * out_grad[0])
            return Sqr()

    @op.register("ttwo_out_reg")
    class TwoOutProp(op.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "diff"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class TwoOut(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] + in_data[1])
                    self.assign(out_data[1], req[1], in_data[0] - in_data[1])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                out_grad[0] + out_grad[1])
                    self.assign(in_grad[1], req[1],
                                out_grad[0] - out_grad[1])
            return TwoOut()

    # example/numpy-ops/custom_softmax.py, with the package's nd
    @op.register("tnumpy_softmax_loss")
    class NumpySoftmaxLossProp(op.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class NumpySoftmaxLoss(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    e = np.exp(x - x.max(axis=1, keepdims=True))
                    self.assign(out_data[0], req[0],
                                pkg.nd.array(e / e.sum(axis=1,
                                                       keepdims=True)))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    p = np.array(out_data[0].asnumpy())
                    label = in_data[1].asnumpy().astype(int)
                    p[np.arange(len(label)), label] -= 1.0
                    self.assign(in_grad[0], req[0], pkg.nd.array(p))
                    self.assign(in_grad[1], req[1],
                                pkg.nd.zeros(in_data[1].shape))
            return NumpySoftmaxLoss()


_register(mx)
_register(mt)


@mt.operator.register("tsaved_sqr")
class SavedSqrProp(mt.operator.CustomOpProp):
    """x**2 whose backward reads the input its forward kept on the
    instance (a custom op's usual way to carry state to its backward)."""

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        class SavedSqr(mt.operator.CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                self.saved = in_data[0].asnumpy().copy()
                self.assign(out_data[0], req[0], in_data[0] * in_data[0])

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                self.assign(in_grad[0], req[0], mt.nd.array(
                    2.0 * self.saved * out_grad[0].asnumpy()))
        return SavedSqr()


def _port(fn):
    with mt.cpu():
        return fn(mt)


def test_custom_in_registry():
    assert "Custom" in treg.list_ops()
    assert treg.get_op("Custom").num_inputs is None


def test_custom_apply_op_matches_reference():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    attrs = {"op_type": "tsqr_reg", "scale": "3.0"}
    (ref,) = japply("Custom", [x], attrs)
    (got,) = treg.apply_op("Custom", [torch.from_numpy(x)], attrs)
    _close(got.numpy(), 3.0 * x * x, FWD_TOL)
    _close(got.numpy(), np.asarray(ref), FWD_TOL)


def test_custom_symbolic_forward_backward():
    xv = np.array([[1., 2.], [3., 4.]], np.float32)

    def run(pkg):
        y = pkg.sym.Custom(pkg.sym.Variable("data"), op_type="tsqr_reg",
                           scale="2.0", name="sq")
        exe = pkg.sym.sum(y).bind(ctx=pkg.cpu(),
                                  args={"data": pkg.nd.array(xv)},
                                  args_grad={"data": pkg.nd.zeros((2, 2))})
        fwd = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        return fwd, exe.grad_dict["data"].asnumpy()

    ref, got = run(mx), _port(run)
    _close(got[0], 2.0 * (xv ** 2).sum(), FWD_TOL)
    _close(got[1], 4.0 * xv, GRAD_TOL)
    _close(got[0], ref[0], FWD_TOL)
    _close(got[1], ref[1], GRAD_TOL)


def test_custom_symbolic_multi_output():
    def run(pkg):
        y = pkg.sym.Custom(pkg.sym.Variable("a"), pkg.sym.Variable("b"),
                           op_type="ttwo_out_reg", name="two")
        assert len(y.list_outputs()) == 2
        exe = y.bind(ctx=pkg.cpu(), args={"a": pkg.nd.array([1., 2.]),
                                          "b": pkg.nd.array([10., 20.])},
                     grad_req="null")
        return [o.asnumpy() for o in exe.forward()]

    ref, got = run(mx), _port(run)
    np.testing.assert_array_equal(got[0], [11., 22.])
    np.testing.assert_array_equal(got[1], [-9., -18.])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def _sqr_block(pkg):
    class SqrHalf(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.sum(F.Custom(x * 2.0, op_type="tsqr_reg",
                                  scale="1.0") * 0.5)
    return SqrHalf()


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_custom_inside_cached_op(hybridize):
    """A block around a Custom op: value and gradient (d/dx 0.5 (2x)^2 =
    4x) against the JAX package, imperative and hybridized."""
    xv = np.array([1.0, 3.0], np.float32)

    def run(pkg):
        net = _sqr_block(pkg)
        if hybridize:
            net.hybridize()
        x = pkg.nd.array(xv)
        x.attach_grad()
        with pkg.autograd.record():
            y = net(x)
        y.backward()
        return y.asnumpy(), x.grad.asnumpy()

    ref, got = run(mx), _port(run)
    _close(got[0], 0.5 * (4.0 + 36.0), FWD_TOL)
    _close(got[1], 4.0 * xv, GRAD_TOL)
    _close(got[0], ref[0], FWD_TOL)
    _close(got[1], ref[1], GRAD_TOL)


def test_hybridized_custom_block_runs_the_island_plan(monkeypatch):
    """A hybridized block whose forward holds a Custom op is not captured
    whole: its predict-mode calls run its traced graph through a
    GraphProgram with one island and the Custom as its fallback node (on
    the CPU the program runs eagerly; `_captures` stands in for the
    card)."""
    monkeypatch.setattr(cached_op, "_captures", lambda device: True)
    with mt.cpu():
        net = _sqr_block(mt)
        net.hybridize()
        x = mt.nd.array(np.array([1.0, 3.0, -2.0], np.float32))
        eager = _sqr_block(mt)(x).asnumpy()
        got = net(x).asnumpy()
        op = net._cached_op
        assert op.host_ops == {"Custom"}
        (prog, feed, _n), = op._graph_programs.values()
        assert (prog.islands, prog.fallback_nodes) == (2, 1)
        assert not prog.one_graph
    _close(got, eager, FWD_TOL)


def test_hybridized_host_block_feeds_one_program_from_static_inputs(
        monkeypatch):
    """Calls with new input arrays of one signature reuse one program and
    its static input tensors (their addresses key its captures), each
    call's values copied in; new parameter values are read, and new
    parameter tensors drop the program."""
    monkeypatch.setattr(cached_op, "_captures", lambda device: True)
    rs = np.random.RandomState(0)
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(3, in_units=4))
        net.add(_sqr_block(mt))
        net.initialize(mt.init.Xavier())
        ref = mt.gluon.nn.HybridSequential()
        ref.add(mt.gluon.nn.Dense(3, in_units=4))
        ref.add(_sqr_block(mt))
        ref.initialize()
        ref[0].weight.set_data(net[0].weight.data())
        ref[0].bias.set_data(net[0].bias.data())
        net.hybridize()
        ptrs = set()
        for _ in range(3):
            xv = rs.randn(2, 4).astype(np.float32)
            got = net(mt.nd.array(xv)).asnumpy()
            _close(got, ref(mt.nd.array(xv)).asnumpy(), FWD_TOL)
            (prog, feed, _n), = net._cached_op._graph_programs.values()
            ptrs.add(feed["data0"].data_ptr())
        assert len(ptrs) == 1
        for blk in (net, ref):
            blk[0].weight.set_data(mt.nd.zeros((3, 4)))
        xv = rs.randn(2, 4).astype(np.float32)
        _close(net(mt.nd.array(xv)).asnumpy(),
               ref(mt.nd.array(xv)).asnumpy(), FWD_TOL)
        assert len(net._cached_op._graph_programs) == 1
        net._cached_op._drop_stale([torch.zeros(1)])
        assert not net._cached_op._graph_programs


def test_custom_instance_belongs_to_its_program():
    """Two executors of one graph and shape, forwards and backwards
    interleaved: each program's operator instance keeps its own input, so
    each gradient is 2x of its own input (one instance shared by the
    programs would hand A's backward B's input)."""
    rs = np.random.RandomState(0)
    xs = [rs.randn(3, 2).astype(np.float32) for _ in range(2)]
    with mt.cpu():
        y = mt.sym.sum(mt.sym.Custom(mt.sym.var("data"),
                                     op_type="tsaved_sqr", name="sq"))
        exes = [y.bind(mt.cpu(), args={"data": mt.nd.array(x)},
                       args_grad={"data": mt.nd.zeros(x.shape)})
                for x in xs]
        for ex in exes:
            ex.forward(is_train=True)
        for ex in exes:
            ex.backward()
        for ex, x in zip(exes, xs):
            _close(ex.grad_dict["data"].asnumpy(), 2.0 * x, GRAD_TOL)


def test_custom_unknown_type_raises():
    with pytest.raises(mt.MXNetError):
        treg.apply_op("Custom", [torch.ones(2)],
                      {"op_type": "never_registered_xyz"})
    with pytest.raises(mt.MXNetError):
        _port(lambda pkg: pkg.nd.Custom(pkg.nd.ones((2,)),
                                        op_type="never_registered_xyz"))


def test_eager_custom_on_the_tape():
    """`nd.Custom` of the example's head under `autograd.record`: the
    probabilities and the data gradient (p - onehot) against the JAX
    package."""
    rs = np.random.RandomState(0)
    xv = rs.randn(8, 5).astype(np.float32)
    yv = rs.randint(0, 5, 8).astype(np.float32)

    def run(pkg):
        x = pkg.nd.array(xv)
        x.attach_grad()
        with pkg.autograd.record():
            p = pkg.nd.Custom(x, pkg.nd.array(yv),
                              op_type="tnumpy_softmax_loss")
        p.backward()
        return p.asnumpy(), x.grad.asnumpy()

    ref, got = run(mx), _port(run)
    _close(got[0].sum(axis=1), np.ones(8), FWD_TOL)
    _close(got[0], ref[0], FWD_TOL)
    _close(got[1], ref[1], GRAD_TOL)


def _example_fit(pkg, w0, X, y, head):
    data = pkg.sym.Variable("data")
    label = pkg.sym.Variable("softmax_label")
    fc = pkg.sym.FullyConnected(data, num_hidden=4, name="fc")
    if head == "custom":
        out = pkg.sym.Custom(fc, label, op_type="tnumpy_softmax_loss",
                             name="npsm")
    else:
        out = pkg.sym.SoftmaxOutput(fc, label, name="npsm")
    it = pkg.io.NDArrayIter({"data": X}, {"softmax_label": y},
                            batch_size=32, shuffle=False)
    mod = pkg.mod.Module(out, context=pkg.cpu())
    mod.fit(it, num_epoch=3, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5}, eval_metric="acc",
            arg_params={k: pkg.nd.array(v) for k, v in w0.items()})
    it.reset()
    acc = dict(mod.score(it, "acc"))["accuracy"]
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, acc


def _example_data():
    rng = np.random.RandomState(0)
    X = rng.randn(256, 5).astype(np.float32)
    y = (X @ rng.randn(5, 4).astype(np.float32)).argmax(1).astype(
        np.float32)
    w0 = {"fc_weight": (rng.randn(4, 5) * 0.1).astype(np.float32),
          "fc_bias": np.zeros(4, np.float32)}
    return X, y, w0


def test_custom_softmax_example_fit_matches_reference():
    """The example's Module trained with its numpy head: the port's fit
    (the classic path: a graph with a Custom op takes no one-graph step)
    against the JAX package's, from the same weights, and against the
    port's own fit with the built-in SoftmaxOutput head."""
    X, y, w0 = _example_data()
    ref, racc = _example_fit(mx, w0, X, y, "custom")
    got, gacc = _port(lambda pkg: _example_fit(pkg, w0, X, y, "custom"))
    builtin, _ = _port(lambda pkg: _example_fit(pkg, w0, X, y, "builtin"))
    for k in ref:
        _close(got[k], ref[k], GRAD_TOL, k)
        _close(got[k], builtin[k], GRAD_TOL, k)
    assert gacc == racc and gacc > 0.9


def test_module_with_custom_head_takes_the_classic_path():
    """The refusal is decided from the graph: `fused_step` returns False
    before anything is built, and the program reports its island."""
    X, y, w0 = _example_data()
    with mt.cpu():
        fc = mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=4,
                                   name="fc")
        out = mt.sym.Custom(fc, mt.sym.var("softmax_label"),
                            op_type="tnumpy_softmax_loss", name="npsm")
        mod = mt.mod.Module(out, context=mt.cpu())
        it = mt.io.NDArrayIter({"data": X}, {"softmax_label": y},
                               batch_size=32)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: mt.nd.array(v)
                                    for k, v in w0.items()})
        mod.init_optimizer(optimizer="sgd")
        batch = next(iter(it))
        assert mod.fused_step(batch) is False
        assert mod._fused_train_step is None
        prog = mod._exec.graph_program(False)
        assert prog.has_islands and (prog.islands, prog.fallback_nodes) \
            == (1, 1)
