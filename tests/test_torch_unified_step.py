"""The port's one-program training step (`unified_step.UnifiedTrainStep`,
through `Module.fused_step`) on the CPU, where it runs eagerly: bit for bit
the numbers of ``forward_backward()`` + ``update()``, as
`tests/test_unified_step.py` holds the JAX package's, under every switch;
the anomaly guard; the in-step metric; and the reference's conditions for
declining a step.  Inputs are numpy arrays made from a seed, fed to both
packages where a test holds the port against the JAX package."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import unified_step
from mxnet_tpu_torch.model_zoo import bert_mlm, random_params

SGD_TOL = 1e-4
BERT = dict(num_layers=2, hidden=64, heads=4, ffn=256, vocab=100,
            max_len=32, dropout=0.1)
B, L = 2, 32
OPTIMIZERS = {
    "adam": ("adam", dict(learning_rate=1e-3, wd=0.01)),
    "sgd_mom": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4)),
    "sgd": ("sgd", dict(learning_rate=0.1, wd=1e-4, clip_gradient=0.5)),
}


@pytest.fixture(scope="module")
def bert():
    sym = bert_mlm(mt.sym, **BERT)
    shapes = {"data": (B, L), "positions": (1, L), "mlm_label": (B, L)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({n: s for n, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if n not in shapes}, seed=0)
    return sym, params


def _batches(n=3):
    out = []
    for seed in range(n):
        rng = np.random.RandomState(seed)
        d = rng.randint(0, BERT["vocab"], (B, L)).astype(np.float32)
        lab = np.where(rng.rand(B, L) < 0.3, d, -1.0).astype(np.float32)
        out.append(mt.io.DataBatch([d, np.arange(L, dtype=np.float32)[None]],
                                   [lab]))
    return out


def _bert_module(bert, opt):
    sym, params = bert
    mod = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=mt.cpu())
    mod.bind([("data", (B, L)), ("positions", (1, L))],
             [("mlm_label", (B, L))])
    mod.init_params(arg_params=params)
    name, kw = OPTIMIZERS[opt]
    sched = mt.lr_scheduler.PolyScheduler(max_update=10,
                                          base_lr=kw["learning_rate"],
                                          warmup_steps=2)
    mod.init_optimizer(optimizer=name,
                       optimizer_params=dict(kw, lr_scheduler=sched))
    return mod


def _state(mod):
    """Weights, optimizer states and the last outputs, as numpy."""
    w = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    st = {}
    for i, s in mod._updater.states.items():
        for j, t in enumerate(s if isinstance(s, tuple) else (s,)):
            if t is not None:
                st[(i, j)] = t.asnumpy()
    return w, st, mod.get_outputs()[0].asnumpy()


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert set(x) == set(y)
            for k in x:
                assert np.array_equal(x[k], y[k]), k
        else:
            assert np.array_equal(x, y)


def _train(bert, opt, fused, steps=3):
    mt.random.seed(0)
    mod = _bert_module(bert, opt)
    metric = mt.metric.create("acc")
    for b in _batches(steps):
        if fused:
            assert mod.fused_step(b, eval_metric=metric)
            assert mod.last_step_metric_done
        else:
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
    return _state(mod), metric.get()


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_step_equals_forward_backward_update_bitwise(bert, opt):
    """Dropout 0.1 draws the same masks from the same stream on both
    paths, and the scheduler's lr changes at every step."""
    (got, got_metric), (want, want_metric) = (_train(bert, opt, True),
                                              _train(bert, opt, False))
    _same(got, want)
    assert got_metric == want_metric


@pytest.mark.parametrize("switch", ["MXTPU_FUSED_STEP", "MXTPU_UNIFIED_STEP",
                                    "MXTPU_UNIFIED_METRIC",
                                    "MXTPU_GRAPH_COMPILE"])
def test_each_switch_restores_the_same_numbers(bert, switch, monkeypatch):
    """`Module.fit` (here its loop, one step at a time) under each switch
    turned off gives the default's numbers bit for bit."""
    def run():
        mt.random.seed(0)
        mod = _bert_module(bert, "adam")
        metric = mt.metric.create("acc")
        for b in _batches():
            if not mod.fused_step(b, eval_metric=metric):
                mod.forward_backward(b)
                mod.update()
            if not mod.last_step_metric_done:
                mod.update_metric(metric, b.label)
        return _state(mod), metric.get(), mod.last_step_metric_done

    base = run()
    monkeypatch.setenv(switch, "0")
    off = run()
    _same(off[0], base[0])
    assert off[1] == base[1]
    assert off[2] == (switch in ("MXTPU_GRAPH_COMPILE",))


def test_fused_step_declines_where_the_reference_does(bert, monkeypatch):
    mod = _bert_module(bert, "adam")
    b = _batches(1)[0]
    count = dict(mod._optimizer._index_update_count)
    monkeypatch.setenv("MXTPU_FUSED_STEP", "0")
    assert mod.fused_step(b) is False
    monkeypatch.delenv("MXTPU_FUSED_STEP")
    # an input that needs a gradient
    sym, params = bert
    grads = mt.mod.Module(sym, data_names=("data", "positions"),
                          label_names=("mlm_label",), context=mt.cpu())
    grads.bind([("data", (B, L)), ("positions", (1, L))],
               [("mlm_label", (B, L))], inputs_need_grad=True)
    grads.init_params(arg_params=params)
    grads.init_optimizer(optimizer="adam")
    assert grads.fused_step(b) is False
    # grad_req 'add'
    add = mt.mod.Module(sym, data_names=("data", "positions"),
                        label_names=("mlm_label",), context=mt.cpu())
    add.bind([("data", (B, L)), ("positions", (1, L))],
             [("mlm_label", (B, L))], grad_req="add")
    add.init_params(arg_params=params)
    add.init_optimizer(optimizer="adam")
    assert add.fused_step(b) is False
    # an optimizer with no multi-tensor plan: nothing counted
    mod._optimizer._fused_plan = lambda *a: None
    assert mod.fused_step(b) is False
    assert mod._optimizer._index_update_count == count
    assert not mod.last_step_metric_done


def test_multi_tensor_update_equals_the_per_parameter_loop():
    rng = np.random.RandomState(5)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes]
    out = []
    for multi in (True, False):
        opt = mt.optimizer.create("adam", learning_rate=0.01, wd=0.1,
                                  rescale_grad=0.5,
                                  param_idx2name={0: "a_weight", 1: "a_bias",
                                                  2: "b_weight"})
        upd = mt.optimizer.get_updater(opt)
        w = [mt.nd.array(x, ctx=mt.cpu()) for x in ws]
        g = [mt.nd.array(x, ctx=mt.cpu()) for x in gs]
        for _ in range(3):
            items = [(i, g[i], w[i]) for i in range(3)]
            if multi:
                assert upd.update_multi(items)
            else:
                for item in items:
                    upd(*item)
        out.append([x.asnumpy() for x in w])
    for a, b in zip(*out):
        assert np.array_equal(a, b)


def _mlp(pkg):
    d = pkg.sym.var("data")
    h = pkg.sym.FullyConnected(d, num_hidden=8, name="fc1")
    h = pkg.sym.Activation(h, act_type="tanh", name="act1")
    h = pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _mlp_module(pkg, params):
    ctx = mx.cpu() if pkg is mx else mt.cpu()
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    mod.init_params(arg_params={
        k: (mx.nd.array(v) if pkg is mx else mt.nd.array(v, ctx=ctx))
        for k, v in params.items()})
    mod.init_optimizer(optimizer="adam",
                       optimizer_params=dict(learning_rate=0.01))
    return mod


def _mlp_params():
    rng = np.random.RandomState(2)
    return {"fc1_weight": rng.randn(8, 5).astype(np.float32) * 0.3,
            "fc1_bias": rng.randn(8).astype(np.float32) * 0.1,
            "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}


def _mlp_batch(pkg, data, label):
    if pkg is mx:
        return mx.io.DataBatch([mx.nd.array(data)], [mx.nd.array(label)])
    return mt.io.DataBatch([data], [label])


def _weights_and_states(mod):
    w = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    st = {i: tuple(t.asnumpy() for t in s)
          for i, s in mod._updater.states.items()}
    return w, st


def test_anomaly_guard_skips_a_nonfinite_step_in_both_packages(monkeypatch):
    """A NaN in the batch: the step runs, the weights and the optimizer
    states stay as they were, and the verdict is on the device; a clean
    batch then moves the weights as the reference's does."""
    monkeypatch.setenv("MXTPU_ANOMALY_GUARD", "1")
    rng = np.random.RandomState(9)
    clean = rng.randn(4, 5).astype(np.float32)
    label = np.array([0, 1, 2, 1], np.float32)
    bad = clean.copy()
    bad[1, 2] = np.nan
    params = _mlp_params()
    results = []
    for pkg in (mx, mt):
        mod = _mlp_module(pkg, params)
        assert mod.fused_step(_mlp_batch(pkg, clean, label))
        before = _weights_and_states(mod)
        assert mod.fused_step(_mlp_batch(pkg, bad, label))
        step = mod._fused_train_step
        assert not bool(np.asarray(step.last_step_ok if pkg is mx else
                                   step.last_step_ok.cpu()))
        after = _weights_and_states(mod)
        for k in before[0]:
            assert np.array_equal(before[0][k], after[0][k]), k
        for i in before[1]:
            for x, y in zip(before[1][i], after[1][i]):
                assert np.array_equal(x, y)
        assert mod.fused_step(_mlp_batch(pkg, clean, label))
        results.append(_weights_and_states(mod)[0])
    assert isinstance(mod._fused_train_step.last_step_ok, torch.Tensor)
    for k in results[0]:
        np.testing.assert_allclose(results[1][k], results[0][k],
                                   rtol=SGD_TOL, atol=SGD_TOL, err_msg=k)


def test_step_matches_the_reference_step():
    """Three unified steps of the MLP in each package, Adam, the accuracy
    inside the step."""
    rng = np.random.RandomState(4)
    params = _mlp_params()
    data = [rng.randn(4, 5).astype(np.float32) for _ in range(3)]
    label = [rng.randint(0, 3, 4).astype(np.float32) for _ in range(3)]
    out = []
    for pkg in (mx, mt):
        mod = _mlp_module(pkg, params)
        metric = pkg.metric.create("acc")
        for d, lab in zip(data, label):
            assert mod.fused_step(_mlp_batch(pkg, d, lab), eval_metric=metric)
            assert mod.last_step_metric_done
        out.append((_weights_and_states(mod)[0], metric.get()))
    for k in out[0][0]:
        np.testing.assert_allclose(out[1][0][k], out[0][0][k], rtol=SGD_TOL,
                                   atol=SGD_TOL, err_msg=k)
    assert out[1][1][0] == out[0][1][0]
    assert out[1][1][1] == pytest.approx(out[0][1][1])


def test_in_step_metric_hands_back_its_sum_on_detach():
    mod = _mlp_module(mt, _mlp_params())
    rng = np.random.RandomState(6)
    b = _mlp_batch(mt, rng.randn(4, 5).astype(np.float32),
                   np.array([0, 1, 2, 0], np.float32))
    first, second = mt.metric.Accuracy(), mt.metric.Accuracy()
    assert mod.fused_step(b, eval_metric=first)
    value = first.get()
    assert mod.fused_step(b, eval_metric=second)
    assert first.get() == value and first.num_inst == 4
    host = mt.metric.Accuracy()
    mod.update_metric(host, b.label)
    assert second.get() == host.get()


def test_guard_verdict():
    ok, norm = unified_step.guard_verdict([torch.ones(3)],
                                          torch.tensor(4.0))
    assert bool(ok) and float(norm) == 2.0
    ok, _ = unified_step.guard_verdict([torch.tensor([1.0, np.inf])],
                                       torch.tensor(1.0))
    assert not bool(ok)
    ok, _ = unified_step.guard_verdict([torch.ones(2)],
                                       torch.tensor(np.inf))
    assert not bool(ok)


def test_multi_precision_updates_a_float32_master_copy():
    """SGD with ``multi_precision`` on a bfloat16 weight keeps a float32
    copy beside its momentum and steps that copy, as the reference's
    ``mp_sgd_mom_update`` does; its multi-tensor plan is that op with
    the momentum and the master copy as its state slots, as the
    reference's."""
    import jax.numpy as jnp
    rng = np.random.RandomState(12)
    w0 = rng.randn(5, 3).astype(np.float32)
    gs = [rng.randn(5, 3).astype(np.float32) for _ in range(3)]
    out = []
    for pkg in (mx, mt):
        opt = pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                   multi_precision=True, wd=0.01)
        upd = pkg.optimizer.get_updater(opt)
        if pkg is mx:
            w = mx.nd.array(w0, dtype=jnp.bfloat16)
            grads = [mx.nd.array(g, dtype=jnp.bfloat16) for g in gs]
        else:
            w = mt.nd.array(w0, ctx=mt.cpu(), dtype="bfloat16")
            grads = [mt.nd.array(g, ctx=mt.cpu(), dtype="bfloat16")
                     for g in gs]
        for g in grads:
            upd(0, g, w)
        master = upd.states[0][1]
        out.append((np.asarray(w.asnumpy(), np.float32), master.asnumpy()))
        plan = opt._fused_plan(0, w, upd.states[0])
        assert plan[:2] == ("mp_sgd_mom_update", {"momentum": 0.9})
        assert plan[2][0] is upd.states[0][0] and plan[2][1] is master
        if pkg is mt:
            assert master.dtype == np.float32
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-2, atol=1e-2)
