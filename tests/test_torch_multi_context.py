"""Several contexts in one process, the port against the JAX package on
the CPU with the same numpy inputs: `Module` over a context list (the
fold onto its first context, an indivisible batch, ``grad_req='add'``,
a checkpoint resumed with its optimizer states, ``score``) within the
reference tests' 2e-5/2e-6; `executor_manager` (slices, two executors'
summed gradients against one's); `gluon.Trainer` over replicas on
cpu(0)/cpu(1) with the ``device`` store within 1e-6; and ``group2ctx``
model parallelism, whose outputs and gradients equal the one-context
executor's bit for bit and the JAX package's within its test's 1e-6
(outputs) and 1e-5 (gradients), each array in its group's context."""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.symbol import symbol as tsym

PKGS = [("port", mt), ("jax", mx)]


@pytest.fixture(autouse=True)
def fresh_names():
    saved = [(m, dict(m.counters)) for m in (jsym._NAMES, tsym._NAMES)]
    for m, _ in saved:
        m.counters.clear()
    yield
    for m, counters in saved:
        m.counters.clear()
        m.counters.update(counters)


def _mlp(p, hidden=16, classes=4):
    x = p.sym.Variable("data")
    y = p.sym.Variable("softmax_label")
    h = p.sym.FullyConnected(x, num_hidden=hidden, name="fc1")
    h = p.sym.Activation(h, act_type="tanh")
    h = p.sym.FullyConnected(h, num_hidden=classes, name="fc2")
    return p.sym.SoftmaxOutput(h, y, name="softmax")


def _module(p, ctx, bs=16, grad_req="write", **kw):
    mod = p.mod.Module(_mlp(p), context=ctx, **kw)
    mod.bind(data_shapes=[("data", (bs, 8))],
             label_shapes=[("softmax_label", (bs,))], grad_req=grad_req)
    r2 = np.random.RandomState(7)
    shapes = {"fc1_weight": (16, 8), "fc1_bias": (16,),
              "fc2_weight": (4, 16), "fc2_bias": (4,)}
    mod.init_params(arg_params={
        k: p.nd.array(r2.randn(*s).astype(np.float32) * 0.1)
        for k, s in shapes.items()})
    return mod


def _batch(p, rng, bs):
    return p.io.DataBatch(
        data=[p.nd.array(rng.randn(bs, 8).astype(np.float32))],
        label=[p.nd.array(rng.randint(0, 4, (bs,)).astype(np.float32))])


def _train(p, ctx, steps=4, bs=16):
    with p.cpu(0):
        mod = _module(p, ctx, bs)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5,
                                             "momentum": 0.9})
        rng = np.random.RandomState(0)
        for _ in range(steps):
            mod.forward(_batch(p, rng, bs), is_train=True)
            mod.backward()
            mod.update()
    return mod


def _params(mod):
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def _close(a, b, rtol=2e-5, atol=2e-6):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# -- Module over a context list ---------------------------------------------

def test_multi_context_matches_single_and_the_reference(caplog):
    with caplog.at_level(logging.WARNING):
        port4 = _train(mt, [mt.cpu(i) for i in range(4)])
    assert "duplicate devices" in caplog.text
    port1 = _train(mt, mt.cpu(0))
    ref4 = _train(mx, [mx.cpu(i) for i in range(4)])
    _close(_params(port4), _params(port1))
    _close(_params(port4), _params(ref4))
    assert str(port4._exec.arg_dict["fc1_weight"].context) == "cpu(0)"


def test_multi_context_fallbacks(caplog):
    outs = []
    for _name, p in PKGS:
        with p.cpu(0):
            mod = _module(p, [p.cpu(0), p.cpu(1), p.cpu(2)], bs=8)
            mod.init_optimizer(optimizer="sgd")
            mod.forward(_batch(p, np.random.RandomState(0), 8),
                        is_train=True)
            mod.backward()
            mod.update()
            outs.append(_params(mod))
    _close(*outs)
    with caplog.at_level(logging.WARNING):
        mt.mod.Module(_mlp(mt), context=[mt.cpu(0), mt.cpu(1)],
                      work_load_list=[1, 3])
    assert "non-uniform work_load_list" in caplog.text
    mod = mt.mod.Module(_mlp(mt), context=[mt.cpu(0), mt.cpu(1)],
                        group2ctxs=[{"g": mt.cpu(1)}, {"g": mt.cpu(0)}],
                        compression_params={"type": "2bit"})
    assert mod._group2ctxs == {"g": mt.cpu(1)}


def test_multi_context_grad_req_add():
    grads = []
    for _name, p in PKGS:
        with p.cpu(0):
            mod = _module(p, [p.cpu(i) for i in range(4)], grad_req="add")
            batch = _batch(p, np.random.RandomState(2), 16)
            mod.forward(batch, is_train=True)
            mod.backward()
            g1 = mod._exec.grad_dict["fc1_weight"].asnumpy().copy()
            mod.forward(batch, is_train=True)
            mod.backward()
            g2 = mod._exec.grad_dict["fc1_weight"].asnumpy()
            np.testing.assert_allclose(g2, 2 * g1, rtol=1e-5, atol=1e-6)
            grads.append(g2)
    np.testing.assert_allclose(grads[0], grads[1], rtol=2e-5, atol=2e-6)


def test_multi_context_checkpoint_resume_and_score(tmp_path):
    results = []
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype(np.float32)
    y = rng.randint(0, 4, (64,)).astype(np.float32)
    for name, p in PKGS:
        ctxs = [p.cpu(i) for i in range(4)]
        mod = _train(p, ctxs, steps=2)
        prefix = str(tmp_path / name)
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        with p.cpu(0):
            mod2 = p.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                     context=ctxs)
            mod2.bind(data_shapes=[("data", (16, 8))],
                      label_shapes=[("softmax_label", (16,))])
            mod2.init_params()
            mod2.init_optimizer(optimizer="sgd",
                                optimizer_params={"learning_rate": 0.5,
                                                  "momentum": 0.9})
            mod2.forward(_batch(p, np.random.RandomState(1), 16),
                         is_train=True)
            mod2.backward()
            mod2.update()
            it = p.io.NDArrayIter({"data": X}, {"softmax_label": y},
                                  batch_size=16)
            score = dict(mod2.score(it, "acc"))["accuracy"]
        results.append((_params(mod2), score))
    _close(results[0][0], results[1][0])
    assert abs(results[0][1] - results[1][1]) < 1e-6


# -- executor_manager --------------------------------------------------------

def _manager_batch(p, bs=8):
    rng = np.random.RandomState(0)
    return p.io.DataBatch(
        data=[p.nd.array(rng.randn(bs, 5).astype(np.float32))],
        label=[p.nd.array(rng.randint(0, 3, (bs,)).astype(np.float32))],
        provide_data=[p.io.DataDesc("data", (bs, 5))],
        provide_label=[p.io.DataDesc("softmax_label", (bs,))])


def _manager_grads(p, ctxs, work_load_list=None):
    from importlib import import_module
    em = import_module(p.__name__ + ".executor_manager")
    with p.cpu(0):
        batch = _manager_batch(p)
        sym = _mlp(p, hidden=8, classes=3)
        mgr = em.DataParallelExecutorManager(sym, ctxs, batch,
                                             work_load_list=work_load_list)
        w = np.random.RandomState(3)
        params = {n: p.nd.array(w.randn(*a[0].shape).astype(np.float32))
                  for n, a in zip(mgr.param_names, mgr.param_arrays)}
        mgr.set_params(params, {})
        mgr.load_data_batch(batch)
        mgr.forward(is_train=True)
        mgr.backward()
        metric = p.metric.Accuracy()
        mgr.update_metric(metric, batch.label)
        out_arg, out_aux = {}, {}
        mgr.copy_to(out_arg, out_aux)
        grads = [sum(g.asnumpy().astype(np.float64) for g in glist)
                 for glist in mgr.grad_arrays]
        return mgr, grads, metric.get()[1], out_arg


def test_split_input_slice_and_check_arguments():
    from mxnet_tpu import executor_manager as jem
    from mxnet_tpu_torch import executor_manager as tem
    for args in ((8, [1, 1]), (9, [1, 2]), (8, [1, 3]), (7, [2, 2, 3])):
        assert tem._split_input_slice(*args) == jem._split_input_slice(*args)
    for em in (tem, jem):
        with pytest.raises(ValueError):
            em._split_input_slice(2, [1, 1, 1, 1])
    a = mt.sym.var("a")
    tem._check_arguments(mt.sym.elemwise_add(a, a))  # one argument


@pytest.mark.parametrize("work_load_list", [None, [1, 3]])
def test_executor_manager_two_contexts(work_load_list):
    ctxs = {"port": [mt.cpu(0), mt.cpu(1)], "jax": [mx.cpu(0), mx.cpu(1)]}
    mgr, g2, acc2, out = _manager_grads(mt, ctxs["port"], work_load_list)
    _, g1, acc1, _ = _manager_grads(mt, [mt.cpu(0)])
    _, gj, accj, _ = _manager_grads(mx, ctxs["jax"], work_load_list)
    assert mgr.param_names == ["fc1_weight", "fc1_bias", "fc2_weight",
                               "fc2_bias"]
    execs = mgr.curr_execgrp.train_execs
    assert [str(e.arg_dict["data"].context) for e in execs] == \
        ["cpu(0)", "cpu(1)"]
    assert execs[0].arg_dict["fc1_weight"] is not \
        execs[1].arg_dict["fc1_weight"]
    for a, b, c in zip(g2, g1, gj):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(a, c, rtol=2e-4, atol=2e-5)
    assert acc2 == acc1 == accj
    assert set(out) == set(mgr.param_names)


def test_executor_group_shares_the_first_groups_arrays():
    from mxnet_tpu_torch.executor_manager import DataParallelExecutorGroup
    with mt.cpu(0):
        batch = _manager_batch(mt, 4)
        sym = _mlp(mt, hidden=8, classes=3)
        names = sym.list_arguments()
        params = [n for n in names if n not in ("data", "softmax_label")]
        g1 = DataParallelExecutorGroup(sym, names, params, [mt.cpu(0)],
                                       [slice(0, 4)], batch)
        g1.train_execs[0].arg_dict["fc1_weight"][:] = 7.0
        g2 = DataParallelExecutorGroup(sym, names, params, [mt.cpu(0)],
                                       [slice(0, 4)], batch, shared_group=g1)
    assert g2.train_execs[0].arg_dict["fc1_weight"] is \
        g1.train_execs[0].arg_dict["fc1_weight"]
    np.testing.assert_array_equal(
        g2.train_execs[0].arg_dict["fc1_weight"].asnumpy(), 7.0)


# -- gluon.Trainer over replicas --------------------------------------------

def _replica_steps(p, kvstore, optimizer, params):
    x = p.gluon.Parameter("x", shape=(10,))
    x.initialize(ctx=[p.cpu(0), p.cpu(1)], init="zeros")
    trainer = p.gluon.Trainer([x], optimizer, params, kvstore=kvstore)
    out = []
    for step in range(3):
        if step == 1:
            x.lr_mult = 0.5
        with p.autograd.record():
            for i, w in enumerate(x.list_data()):
                ((w + 1) * (i + 1.0)).backward()
        trainer.step(1)
        out.append([x.data(c).asnumpy() for c in (p.cpu(0), p.cpu(1))])
    return out


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 1.0, "momentum": 0.5}),
    ("adam", {"learning_rate": 0.1})])
@pytest.mark.parametrize("kvstore", ["device", "local"])
def test_trainer_over_replicas(optimizer, params, kvstore):
    got = _replica_steps(mt, kvstore, optimizer, params)
    want = _replica_steps(mx, kvstore, optimizer, params)
    for (t0, t1), (j0, j1) in zip(got, want):
        np.testing.assert_array_equal(t0, t1)
        np.testing.assert_allclose(t0, j0, rtol=1e-6, atol=1e-7)
    if optimizer == "sgd":
        assert (got[0][0] == -3).all()    # the summed gradient, 1 + 2


def test_trainer_multi_device_allreduce_and_split_and_load():
    ctxs = [mt.cpu(0), mt.cpu(1)]
    p = mt.gluon.Parameter("w", shape=(2,))
    p.initialize(ctx=ctxs, init=mt.init.One())
    trainer = mt.gluon.Trainer({"w": p}, "sgd", {"learning_rate": 1.0},
                               kvstore="device")
    for d, g in zip(p.list_data(), [1.0, 3.0]):
        with mt.autograd.record():
            loss = (d * g).sum()
        loss.backward()
    trainer.step(1)
    for d in p.list_data():
        np.testing.assert_allclose(d.asnumpy(), (1 - 4.0) * np.ones(2),
                                   rtol=1e-6)
    parts = mt.gluon.utils.split_and_load(np.arange(8, dtype=np.float32),
                                          ctxs)
    assert [str(a.context) for a in parts] == ["cpu(0)", "cpu(1)"]
    # a dist store in one process: a one-worker store over the replicas,
    # as the JAX package's (its sum of the replicas' gradients, then SGD)
    got = _replica_steps(mt, "dist_sync", "sgd", {"learning_rate": 1.0})
    want = _replica_steps(mx, "dist_sync", "sgd", {"learning_rate": 1.0})
    for (t0, t1), (j0, _j1) in zip(got, want):
        np.testing.assert_array_equal(t0, t1)
        np.testing.assert_array_equal(t0, j0)


# -- group2ctx ---------------------------------------------------------------

def _two_groups(p):
    data = p.sym.var("data")
    with p.AttrScope(ctx_group="dev1"):
        fc1 = p.sym.FullyConnected(data, num_hidden=8, name="fc1")
        act = p.sym.Activation(fc1, act_type="relu")
    with p.AttrScope(ctx_group="dev2"):
        fc2 = p.sym.FullyConnected(act, num_hidden=3, name="fc2")
        out = p.sym.sum(fc2)
    return out


def _feed():
    rs = np.random.RandomState(0)
    return {"data": rs.randn(4, 5).astype(np.float32),
            "fc1_weight": rs.randn(8, 5).astype(np.float32),
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rs.randn(3, 8).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def _run_groups(p, data_shape=(4, 5)):
    feed = _feed()
    g2c = {"dev1": p.cpu(1), "dev2": p.cpu(2)}
    ex = _two_groups(p).simple_bind(p.cpu(0), group2ctx=g2c,
                                    data=data_shape)
    ex.copy_params_from({k: p.nd.array(v, ctx=p.cpu(0))
                         for k, v in feed.items() if k != "data"})
    y = ex.forward(is_train=True, data=feed["data"][:data_shape[0]])[0]
    ex.backward()
    return ex, y


def test_bind_group2ctx_model_parallel():
    ex, y = _run_groups(mt)
    exj, yj = _run_groups(mx)
    feed = _feed()
    ref = _two_groups(mt).bind(
        mt.cpu(0), args={k: mt.nd.array(v, ctx=mt.cpu(0))
                         for k, v in feed.items()},
        args_grad={k: mt.nd.zeros(v.shape, ctx=mt.cpu(0))
                   for k, v in feed.items()})
    y_ref = ref.forward(is_train=True)[0]
    ref.backward()
    # bit-equal to the one-context executor; against the JAX package
    # within the reference test's own tolerances (its matmuls sum in
    # another order)
    np.testing.assert_array_equal(y.asnumpy(), y_ref.asnumpy())
    np.testing.assert_allclose(y.asnumpy(), yj.asnumpy(), rtol=1e-6)
    assert str(y.context) == str(yj.context) == "cpu(2)"
    for name in ("fc1_weight", "fc2_weight", "data"):
        np.testing.assert_array_equal(ex.grad_dict[name].asnumpy(),
                                      ref.grad_dict[name].asnumpy())
        np.testing.assert_allclose(ex.grad_dict[name].asnumpy(),
                                   exj.grad_dict[name].asnumpy(), rtol=1e-5)
    for name, want in (("fc1_weight", "cpu(1)"), ("fc2_weight", "cpu(2)"),
                       ("data", "cpu(1)")):
        assert str(ex.arg_dict[name].context) == want
        assert str(ex.grad_dict[name].context) == want
        assert str(exj.arg_dict[name].context) == want


def test_group2ctx_survives_reshape_and_var_annotation_wins():
    ex, _ = _run_groups(mt, (4, 5))
    small = ex.reshape(data=(3, 5))
    y = small.forward(is_train=True,
                      data=np.ones((3, 5), np.float32))[0]
    small.backward()
    assert np.isfinite(y.asnumpy()).all()
    assert small.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
    assert str(small.arg_dict["fc1_weight"].context) == "cpu(1)"
    outs = []
    for _name, p in PKGS:
        with p.AttrScope(ctx_group="big"):
            w = p.sym.var("w")
        data = p.sym.var("data")
        with p.AttrScope(ctx_group="small"):
            out = p.sym.sum(p.sym.dot(data, w))
        ex = out.simple_bind(p.cpu(0), group2ctx={"big": p.cpu(3),
                                                  "small": p.cpu(1)},
                             data=(2, 4), w=(4, 3))
        assert str(ex.arg_dict["w"].context) == "cpu(3)"
        assert str(ex.arg_dict["data"].context) == "cpu(1)"
        ex.arg_dict["w"][:] = np.arange(12, dtype=np.float32).reshape(4, 3)
        outs.append(ex.forward(is_train=True,
                               data=np.ones((2, 4), np.float32))[0]
                    .asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_model_parallel_chain_reference():
    res = []
    for _name, p in PKGS:
        ctx1, ctx2 = p.cpu(0), p.cpu(1)
        data1, data2, data3 = (p.sym.var(n) for n in
                               ("data1", "data2", "data3"))
        with p.AttrScope(ctx_group="dev1"):
            net = (data1 + data2) * 3
        with p.AttrScope(ctx_group="dev2"):
            net = net + data3
        shape = (4, 5)
        arr, arr_grad = [], []
        for c in (ctx1, ctx1, ctx2):
            arr.append(p.nd.zeros(shape, ctx=c))
            arr_grad.append(p.nd.zeros(shape, ctx=c))
        ex1 = net.bind(ctx1, args=arr, args_grad=arr_grad,
                       group2ctx={"dev1": ctx1, "dev2": ctx2})
        for a, v in zip(arr, (1.0, 2.0, 3.0)):
            a[:] = v
        ex1.forward(is_train=True)
        out_grad = p.nd.zeros(shape, ctx=ctx1)
        out_grad[:] = 1.0
        ex1.backward([out_grad])
        assert str(ex1.arg_dict["data3"].context) == "cpu(1)"
        res.append([ex1.outputs[0].asnumpy()] +
                   [g.asnumpy() for g in ex1.grad_arrays])
    for a, b in zip(*res):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res[0][0], np.full((4, 5), 12.0))


def test_ctx_group_arg_placement_reference():
    placed = []
    for _name, p in PKGS:
        with p.AttrScope(ctx_group="stage1"):
            data = p.sym.var("data")
            fc1 = p.sym.FullyConnected(data, name="fc1", num_hidden=16)
            act1 = p.sym.Activation(fc1, name="relu1", act_type="relu")
        stage1 = set(act1.list_arguments())
        with p.AttrScope(ctx_group="stage2"):
            fc2 = p.sym.FullyConnected(act1, name="fc2", num_hidden=8)
            fc3 = p.sym.BatchNorm(p.sym.FullyConnected(fc2, name="fc3",
                                                       num_hidden=4))
            mlp = p.sym.SoftmaxOutput(fc3, name="softmax")
        group2ctx = {"stage1": p.cpu(1), "stage2": p.cpu(2)}
        null_req = {a: ("null" if a == "data" else "write")
                    for a in mlp.list_arguments()}
        for grad_req in ("write", null_req):
            ex = mlp.simple_bind(p.cpu(0), group2ctx=group2ctx,
                                 data=(2, 20), grad_req=grad_req)
            ctxs = [str(a.context) for a in ex.arg_arrays]
            for c, name in zip(ctxs, mlp.list_arguments()):
                assert c == ("cpu(1)" if name in stage1 else "cpu(2)")
            assert all(str(a.context) == "cpu(2)" for a in ex.aux_arrays)
            placed.append(ctxs)
    assert placed[:2] == placed[2:]


def test_module_group2ctxs_matches_one_context():
    feed = _feed()
    label = np.array([0, 2, 1, 1], np.float32)

    def head(p):
        data = p.sym.var("data")
        with p.AttrScope(ctx_group="embed"):
            h = p.sym.FullyConnected(data, num_hidden=8, name="fc1")
        with p.AttrScope(ctx_group="dense"):
            h = p.sym.FullyConnected(p.sym.relu(h), num_hidden=3,
                                     name="fc2")
            return p.sym.SoftmaxOutput(h, p.sym.var("softmax_label"),
                                       name="sm")

    grads = []
    for kw in ({"group2ctxs": {"embed": mt.cpu(1), "dense": mt.cpu(2)}},
               {}):
        mod = mt.mod.Module(head(mt), context=mt.cpu(0), **kw)
        mod.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu(0))
                                    for k, v in feed.items()
                                    if k != "data"})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        batch = mt.io.DataBatch([mt.nd.array(feed["data"], ctx=mt.cpu(0))],
                                [mt.nd.array(label, ctx=mt.cpu(0))])
        for _ in range(2):
            mod.forward_backward(batch)
            mod.update()
        grads.append({k: g.asnumpy() for k, g in
                      mod._exec.grad_dict.items()})
        if kw:
            assert str(mod._exec.arg_dict["fc1_weight"].context) == "cpu(1)"
            assert str(mod._exec.arg_dict["fc2_weight"].context) == "cpu(2)"
    for k in grads[1]:
        np.testing.assert_array_equal(grads[0][k], grads[1][k])


def test_feedforward_over_a_context_list():
    rng = np.random.RandomState(4)
    X = rng.randn(32, 8).astype(np.float32)
    y = rng.randint(0, 4, (32,)).astype(np.float32)
    preds = []
    for _name, p in PKGS:
        with p.cpu(0):
            p.random.seed(3)
            model = p.model.FeedForward(
                _mlp(p), ctx=[p.cpu(0), p.cpu(1)], num_epoch=2,
                learning_rate=0.1, initializer=p.init.Constant(0.05))
            model.fit(X, y)
            preds.append(_params(model._module))
    _close(*preds)
