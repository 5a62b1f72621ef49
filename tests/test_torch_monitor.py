"""The PyTorch port's `Monitor` and the executor's monitor callback, and
`Module.fit` with a KVStore, against the JAX package (`mxnet_tpu/monitor.py`,
`mxnet_tpu/executor.py:set_monitor_callback`,
`mxnet_tpu/module/module.py` update-on-kvstore): the same weights and
batches through both packages' `fit`; each monitored statistic within
1e-5 (relative) of the JAX package's, the parameters within 1e-5 of
their largest magnitude."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

CPU = mt.cpu()
TOL = 1e-5


def _mlp(m):
    x = m.sym.var("data")
    h = m.sym.FullyConnected(x, num_hidden=12, name="fc1")
    h = m.sym.Activation(h, act_type="relu", name="relu1")
    h = m.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return m.sym.SoftmaxOutput(h, name="softmax")


def _init(seed=0):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(12, 6) * 0.4, "fc1_bias": rs.randn(12),
            "fc2_weight": rs.randn(4, 12) * 0.4, "fc2_bias": rs.randn(4)}


def _data(seed=1, n=32):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 6).astype(np.float32), \
        rs.randint(0, 4, n).astype(np.float32)


def _fit(m, kvstore="local", monitor=None, epochs=2, **ctx):
    x, y = _data()
    it = m.io.NDArrayIter(x, y, batch_size=8)
    mod = m.mod.Module(_mlp(m), **ctx)
    arr = (lambda v: mt.nd.array(v.astype(np.float32), ctx=CPU)) \
        if m is mt else (lambda v: mx.nd.array(v.astype(np.float32)))
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: arr(v) for k, v in _init().items()},
            kvstore=kvstore, monitor=monitor)
    arg, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in arg.items()}


def _mean_abs(x):
    return float(np.abs(x.asnumpy()).mean())


@pytest.mark.parametrize("interval,pattern,sort", [
    (1, ".*", False), (2, ".*output", True), (3, "softmax.*", False),
    (1, "nomatch", False)])
def test_monitor_through_fit_matches_reference(interval, pattern, sort):
    records = {}
    for m, kw in ((mx, {}), (mt, {"context": CPU})):
        got = records.setdefault(m.__name__, [])
        mon = m.monitor.Monitor(interval, stat_func=_mean_abs,
                                pattern=pattern, sort=sort)
        real = mon.toc_print
        mon.toc_print = lambda real=real, got=got: got.extend(real()) or []
        _fit(m, monitor=mon, **kw)
    j, t = records["mxnet_tpu"], records["mxnet_tpu_torch"]
    assert [(s, n) for s, n, _ in t] == [(s, n) for s, n, _ in j]
    if pattern != "nomatch":
        assert len(t) == -(-8 // interval)         # 2 epochs of 4 batches
    for (_s, _n, a), (_s2, _n2, b) in zip(t, j):
        assert abs(a - b) <= TOL * abs(b)


def test_monitor_statistic_equals_the_outputs():
    """The monitor sees the executor's outputs: its statistic is the
    statistic of `get_outputs` after the same forward."""
    mod, _ = _fit(mt, context=CPU, epochs=1)
    mon = mt.Monitor(1, pattern=".*")
    mod.install_monitor(mon)
    x, y = _data(seed=3, n=8)
    mon.tic()
    mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=CPU)],
                                [mt.nd.array(y, ctx=CPU)]), is_train=False)
    seen = mon.toc()
    want = float(np.abs(mod.get_outputs()[0].asnumpy()).mean())
    # `tic` counts the batch before the forward, as the reference's
    assert [(s, n) for s, n, _ in seen] == [(1, "softmax_output")]
    assert seen[0][2] == want
    assert mon.toc() == []                       # deactivated after toc


def test_monitor_takes_fit_off_the_fused_step():
    mon = mt.Monitor(1)
    mod, _ = _fit(mt, monitor=mon, context=CPU, epochs=1)
    b = mt.io.DataBatch([mt.nd.array(_data()[0][:8], ctx=CPU)],
                        [mt.nd.array(_data()[1][:8], ctx=CPU)])
    assert mod.fused_step(b) is False


@pytest.mark.parametrize("kv_name", ["local", "device", "dist_sync"])
def test_fit_on_a_kvstore_matches_local_and_reference(kv_name):
    _, local = _fit(mt, kvstore="local", context=CPU)
    mod, on_kv = _fit(mt, kvstore=mt.kv.create(kv_name), context=CPU)
    _, ref = _fit(mx, kvstore=mx.kv.create(kv_name))
    assert mod._kvstore is not None and mod._kv_inited == set(local)
    assert mod._active_updater() is mod._kvstore._updater_obj
    for k in local:
        scale = np.abs(local[k]).max()
        np.testing.assert_allclose(on_kv[k], local[k], rtol=0,
                                   atol=TOL * scale)
        np.testing.assert_allclose(on_kv[k], ref[k], rtol=0,
                                   atol=TOL * scale)


def test_fit_with_a_dist_name_creates_a_store():
    mod, _ = _fit(mt, kvstore="dist_sync", context=CPU, epochs=1)
    assert isinstance(mod._kvstore, mt.kv.KVStore)
    assert mod._kvstore.type == "dist_sync"
