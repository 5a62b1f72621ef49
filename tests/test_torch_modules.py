"""`SequentialModule`, `PythonModule`/`PythonLossModule`, `Block.summary`
and `Block.optimize_for` in the port against the JAX package (the cases
of `tests/test_breadth.py::test_sequential_module`,
`tests/test_symbol_module.py`'s Python-module cases and
`tests/test_gluon_reshape_slice_grid.py::test_block_apply_and_summary`),
with MXNet's `example/module/sequential_module.py` MLP cut to 16 | 8, 3
classes, batch 10: its weights after 5 steps as a `SequentialModule` of
two `Module`s equal one `Module` of the joined graph, and the JAX
package's.

Tolerance: weights and outputs within TOL = 1e-5 of the reference's
largest magnitude.
"""
import numpy as np

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

TOL = 1e-5


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= tol * scale, what


def _port(fn):
    with mt.cpu():
        return fn(mt)


def test_sequential_module_step():
    """The reference test's two-module chain: one forward, backward and
    update, with the JAX package's outputs and weights."""
    r = np.random.RandomState(0)
    w = {"l1_weight": r.randn(8, 6).astype(np.float32) * 0.3,
         "l1_bias": np.zeros(8, np.float32),
         "l2_weight": r.randn(3, 8).astype(np.float32) * 0.3,
         "l2_bias": np.zeros(3, np.float32)}
    x = r.randn(4, 6).astype(np.float32)

    def run(pkg):
        S = pkg.sym
        s1 = S.Activation(S.FullyConnected(S.var("data"), num_hidden=8,
                                           name="l1"),
                          act_type="relu", name="act1")
        s2 = S.SoftmaxOutput(S.FullyConnected(S.var("act1_output"),
                                              num_hidden=3, name="l2"),
                             S.var("softmax_label"), name="softmax")
        seq = pkg.mod.SequentialModule()
        seq.add(pkg.mod.Module(s1, data_names=("data",), label_names=None,
                               context=pkg.cpu()))
        seq.add(pkg.mod.Module(s2, data_names=("act1_output",),
                               label_names=("softmax_label",),
                               context=pkg.cpu()), take_labels=True)
        seq.bind(data_shapes=[pkg.io.DataDesc("data", (4, 6))],
                 label_shapes=[pkg.io.DataDesc("softmax_label", (4,))])
        seq.init_params(arg_params={k: pkg.nd.array(v) for k, v in
                                    w.items()}, allow_extra=True)
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        batch = pkg.io.DataBatch([pkg.nd.array(x)],
                                 [pkg.nd.array(np.array([0, 1, 2, 1],
                                                        np.float32))])
        seq.forward(batch, is_train=True)
        out = seq.get_outputs()[0].asnumpy()
        seq.backward()
        seq.update()
        return out, {k: v.asnumpy() for k, v in seq.get_params()[0].items()}

    ref, got = run(mx), _port(run)
    assert got[0].shape == (4, 3)
    _close(got[0], ref[0], TOL)
    for k in ref[1]:
        _close(got[1][k], ref[1][k], TOL, k)


def _mnist_like(n=50, seed=0):
    r = np.random.RandomState(seed)
    X = r.rand(n, 20).astype(np.float32)
    y = r.randint(0, 3, n).astype(np.float32)
    return X, y


def _example_params():
    r = np.random.RandomState(1)
    return {"fc1_weight": r.randn(16, 20).astype(np.float32) * 0.2,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": r.randn(8, 16).astype(np.float32) * 0.2,
            "fc2_bias": np.zeros(8, np.float32),
            "fc3_weight": r.randn(3, 8).astype(np.float32) * 0.2,
            "fc3_bias": np.zeros(3, np.float32)}


def _example(pkg, joined):
    """`example/module/sequential_module.py`: fc1 | fc2, fc3, SoftmaxOutput
    as two modules with ``auto_wiring``, or as one graph."""
    S = pkg.sym
    net1 = S.Activation(S.FullyConnected(S.var("data"), name="fc1",
                                         num_hidden=16),
                        name="relu1", act_type="relu")
    data2 = net1 if joined else S.var("data")
    net2 = S.Activation(S.FullyConnected(data2, name="fc2", num_hidden=8),
                        name="relu2", act_type="relu")
    net2 = S.SoftmaxOutput(S.FullyConnected(net2, name="fc3", num_hidden=3),
                           name="softmax")
    if joined:
        return pkg.mod.Module(net2, context=pkg.cpu())
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(net1, label_names=[], context=pkg.cpu()))
    seq.add(pkg.mod.Module(net2, context=pkg.cpu()), take_labels=True,
            auto_wiring=True)
    return seq


def _train_5(pkg, joined):
    X, y = _mnist_like()
    it = pkg.io.NDArrayIter(X, y, batch_size=10)
    mod = _example(pkg, joined)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            arg_params={k: pkg.nd.array(v)
                        for k, v in _example_params().items()},
            allow_missing=False)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_sequential_module_example_matches_joined_module_and_reference():
    ref = _train_5(mx, joined=False)
    got = _port(lambda pkg: _train_5(pkg, joined=False))
    joined = _port(lambda pkg: _train_5(pkg, joined=True))
    assert set(got) == set(ref) == set(_example_params())
    for k in ref:
        _close(got[k], joined[k], TOL, f"{k} vs joined")
        _close(got[k], ref[k], TOL, f"{k} vs reference")


def test_python_loss_module():
    s = np.arange(12, dtype=np.float32).reshape(4, 3)
    lab = np.ones((4, 3), np.float32)

    def run(pkg):
        mod = pkg.mod.PythonLossModule(
            grad_func=lambda sc, la: sc.asnumpy() - la.asnumpy())
        mod.bind(data_shapes=[("data", (4, 3))],
                 label_shapes=[("softmax_label", (4, 3))])
        assert mod.output_shapes[0].shape == (4, 3)
        mod.forward(pkg.io.DataBatch(data=[pkg.nd.array(s)],
                                     label=[pkg.nd.array(lab)]),
                    is_train=True)
        out = mod.get_outputs()[0].asnumpy()
        mod.backward()
        return out, mod.get_input_grads()[0].asnumpy()

    ref, got = run(mx), _port(run)
    np.testing.assert_array_equal(got[0], s)
    np.testing.assert_array_equal(got[1], s - lab)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_python_module_in_sequential():
    """A symbolic body with a Python loss tail trained by ``fit``: the
    body's weight against the JAX package's."""
    X = np.random.RandomState(0).randn(32, 6).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 3, (32,)).astype(np.float32)
    w0 = np.random.RandomState(2).randn(3, 6).astype(np.float32) * 0.3

    def grad(scores, labels):
        p = scores.asnumpy()
        e = np.exp(p - p.max(1, keepdims=True))
        onehot = np.eye(3, dtype=np.float32)[labels.asnumpy().astype(int)]
        return (e / e.sum(1, keepdims=True) - onehot) / p.shape[0]

    def run(pkg):
        body = pkg.mod.Module(pkg.sym.FullyConnected(
            pkg.sym.var("data"), num_hidden=3, name="fc"), label_names=[],
            context=pkg.cpu())
        seq = pkg.mod.SequentialModule()
        seq.add(body).add(pkg.mod.PythonLossModule(grad_func=grad),
                          take_labels=True)
        seq.fit(pkg.io.NDArrayIter(X, y, batch_size=8), num_epoch=3,
                optimizer="sgd", optimizer_params={"learning_rate": 0.5},
                arg_params={"fc_weight": pkg.nd.array(w0),
                            "fc_bias": pkg.nd.zeros((3,))})
        return body.get_params()[0]["fc_weight"].asnumpy()

    ref, got = run(mx), _port(run)
    _close(got, ref, TOL)
    assert not np.allclose(got, w0)


def _dense_net(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="seq_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu", prefix="d0_"),
                pkg.gluon.nn.Dense(4, prefix="d1_"))
    return net


def test_block_summary_text_is_the_references():
    def run(pkg):
        net = _dense_net(pkg)
        net.initialize()
        seen = []
        net.apply(lambda b: seen.append(type(b).__name__))
        assert seen.count("Dense") == 2
        return net.summary(pkg.nd.ones((2, 16)))

    ref, got = run(mx), _port(run)
    assert got == ref
    assert "seq_d0 " in got and "(2, 4)" in got


def test_optimize_for_hybridizes_and_runs():
    xv = np.random.RandomState(3).randn(2, 16).astype(np.float32)

    def run(pkg):
        net = _dense_net(pkg)
        net.initialize(pkg.init.Constant(0.05))
        out = net.optimize_for(pkg.nd.array(xv), backend="default")
        assert net._active
        return out.asnumpy(), net(pkg.nd.array(xv)).asnumpy()

    ref, got = run(mx), _port(run)
    _close(got[0], got[1], TOL)
    _close(got[0], ref[0], TOL)
