"""A factorization machine over sparse storage, trained by both packages
(the model of `tests/test_sparse_fm_train.py`, adapted from the
reference's `tests/python/train/test_sparse_fm.py`: ``csr`` data,
``row_sparse`` ``v`` and ``w1_weight``, `_square_sum`, `Module` with SGD,
Adam and AdaGrad), and `io.LibSVMIter` against the JAX package's on one
file.  The same numpy weights and batches go into both packages: the
first steps' losses agree within 1e-5 (relative), the iterators' batches
exactly."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

CPU = mt.cpu()
FACTOR, FEATURES, BATCH = 4, 1000, 64
LOSS_TOL = 1e-5


def _fm_symbol(m, init=None):
    x = m.sym.Variable("data", stype="csr")
    v = m.sym.var("v", shape=(FEATURES, FACTOR), init=init,
                  stype="row_sparse")
    w1_weight = m.sym.var("w1_weight", shape=(FEATURES, 1), init=init,
                          stype="row_sparse")
    w1_bias = m.sym.var("w1_bias", shape=(1,))
    w1 = m.sym.broadcast_add(m.sym.dot(x, w1_weight), w1_bias)
    v_s = m.sym._internal._square_sum(data=v, axis=1, keepdims=True)
    x_s = m.sym.square(data=x)
    bd_sum = m.sym.dot(x_s, v_s)
    w2 = m.sym.dot(x, v)
    w2_squared = 0.5 * m.sym.square(data=w2)
    w_all = m.sym.Concat(w1, w2_squared, dim=1)
    sum1 = m.sym.sum(data=w_all, axis=1, keepdims=True)
    sum2 = 0.5 * m.sym.negative(bd_sum)
    model = m.sym.elemwise_add(sum1, sum2)
    y = m.sym.Variable("label")
    return m.sym.LinearRegressionOutput(data=model, label=y)


def _dense_data(n, seed=0):
    rs = np.random.RandomState(seed)
    return ((rs.rand(n, FEATURES) < 0.1) * rs.rand(n, FEATURES)).astype(
        np.float32)


def _optimizer(m, name):
    if name == "sgd":
        return m.optimizer.SGD(momentum=0.1, clip_gradient=5.0,
                               learning_rate=0.01, rescale_grad=1.0 / BATCH)
    if name == "adam":
        return m.optimizer.Adam(clip_gradient=5.0, learning_rate=0.0005,
                                rescale_grad=1.0 / BATCH)
    return m.optimizer.AdaGrad(clip_gradient=5.0, learning_rate=0.01,
                               rescale_grad=1.0 / BATCH)


def _module(m, it, params, name, **ctx):
    mod = m.mod.Module(symbol=_fm_symbol(m), data_names=["data"],
                       label_names=["label"], **ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=params)
    mod.init_optimizer(optimizer=_optimizer(m, name))
    return mod


@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad"])
def test_fm_first_losses_match_reference(name):
    dense = _dense_data(4 * BATCH)
    label = np.random.RandomState(1).rand(4 * BATCH, 1).astype(np.float32)
    rs = np.random.RandomState(2)
    init = {"v": rs.randn(FEATURES, FACTOR) * 0.01,
            "w1_weight": rs.randn(FEATURES, 1) * 0.01,
            "w1_bias": np.zeros(1)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    losses = {}
    for m, arr, ctx in ((mx, mx.nd.array, {}),
                        (mt, lambda v: mt.nd.array(v, ctx=CPU),
                         {"context": CPU})):
        it = m.io.NDArrayIter(data=arr(dense).tostype("csr"),
                              label={"label": arr(label)},
                              batch_size=BATCH, last_batch_handle="discard")
        mod = _module(m, it, {k: arr(v) for k, v in init.items()}, name,
                      **ctx)
        got = losses.setdefault(m.__name__, [])
        for _ in range(2):
            it.reset()
            for batch in it:
                assert batch.data[0].stype == "csr"
                mod.forward(batch, is_train=True)
                pred = mod.get_outputs()[0].asnumpy()
                got.append(float(((pred - batch.label[0].asnumpy()) ** 2)
                                 .mean()))
                mod.backward()
                mod.update()
    j, t = np.array(losses["mxnet_tpu"]), np.array(losses["mxnet_tpu_torch"])
    assert len(t) == 8
    np.testing.assert_allclose(t, j, rtol=LOSS_TOL)


@pytest.mark.parametrize("name,num_epochs,expected_mse", [
    ("sgd", 18, 0.02), ("adam", 10, 0.05), ("adagrad", 20, 0.09)])
def test_fm_learns_under_the_reference_thresholds(name, num_epochs,
                                                  expected_mse):
    """`tests/test_sparse_fm_train.py`'s run on the port (its settings and
    thresholds), with the sparse batches kept off the fused step."""
    mt.random.seed(0)
    init = mt.initializer.Normal(sigma=0.01)
    n = 5 * BATCH
    csr = mt.nd.array(_dense_data(n), ctx=CPU).tostype("csr")
    it = mt.io.NDArrayIter(data=csr,
                           label={"label": mt.nd.ones((n, 1), ctx=CPU)},
                           batch_size=BATCH, last_batch_handle="discard")
    mod = mt.mod.Module(symbol=_fm_symbol(mt, init), data_names=["data"],
                        label_names=["label"], context=CPU)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=init)
    mod.init_optimizer(optimizer=_optimizer(mt, name))
    metric = mt.metric.create("MSE")
    for _ in range(num_epochs):
        it.reset()
        metric.reset()
        for batch in it:
            assert mod.fused_step(batch) is False
            mod.forward(batch, is_train=True)
            mod.update_metric(metric, batch.label)
            mod.backward()
            mod.update()
    assert metric.get()[1] < expected_mse


def _libsvm(tmp_path, rows=23, seed=3):
    rs = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        cols = np.sort(rs.choice(FEATURES, rs.randint(0, 6), replace=False))
        feats = " ".join(f"{c}:{rs.rand():.4f}" for c in cols)
        lines.append(f"{rs.randint(0, 2)} {feats}".strip())
    lines.insert(5, "")                          # blank lines are skipped
    path = tmp_path / "data.libsvm"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("batch,round_batch,parts", [
    (5, True, (1, 0)), (5, False, (1, 0)), (23, True, (1, 0)),
    (4, True, (3, 1)), (4, False, (2, 0))])
def test_libsvm_iter_batches_match_reference(tmp_path, batch, round_batch,
                                             parts):
    path = _libsvm(tmp_path)
    kw = dict(data_shape=(FEATURES,), batch_size=batch,
              round_batch=round_batch, num_parts=parts[0],
              part_index=parts[1])
    jit, tit = mx.io.LibSVMIter(path, **kw), mt.io.LibSVMIter(path, **kw)
    assert [tuple(d.shape) for d in tit.provide_data] == \
        [tuple(d.shape) for d in jit.provide_data]
    assert [tuple(d.shape) for d in tit.provide_label] == \
        [tuple(d.shape) for d in jit.provide_label]
    for _ in range(2):
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) > 0
        for a, b in zip(tb, jb):
            c, d = a.data[0], b.data[0]
            assert c.stype == "csr" and c.shape == d.shape
            np.testing.assert_array_equal(c.sp_data.asnumpy(),
                                          np.asarray(d._sp_data))
            np.testing.assert_array_equal(c.indices.asnumpy(),
                                          np.asarray(d._sp_indices))
            np.testing.assert_array_equal(c.indptr.asnumpy(),
                                          np.asarray(d._sp_indptr))
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
            assert a.pad == b.pad
            c.check_format()
        jit.reset()
        tit.reset()
    tit, jit = (m.io.LibSVMIter(path, (FEATURES,), batch_size=4)
                for m in (mt, mx))
    tit.repartition(2, 1)
    jit.repartition(2, 1)
    assert (tit.num_parts, tit.part_index) == (2, 1)
    assert [b.label[0].asnumpy().tolist() for b in tit] == \
        [b.label[0].asnumpy().tolist() for b in jit]
    with pytest.raises(mt.MXNetError, match="part_index"):
        mt.io.LibSVMIter(path, (FEATURES,), num_parts=2, part_index=2)


def test_fm_fit_over_libsvm_iter_learns(tmp_path):
    """`Module.fit` over `LibSVMIter` batches (regression labels): the
    loss falls."""
    rs = np.random.RandomState(4)
    path = tmp_path / "fm.libsvm"
    lines = []
    for _ in range(4 * BATCH):
        cols = np.sort(rs.choice(FEATURES, 12, replace=False))
        lines.append("1 " + " ".join(f"{c}:{rs.rand():.4f}" for c in cols))
    path.write_text("\n".join(lines) + "\n")
    it = mt.io.LibSVMIter(str(path), data_shape=(FEATURES,),
                          batch_size=BATCH)
    mt.random.seed(0)
    init = mt.initializer.Normal(sigma=0.01)
    mod = mt.mod.Module(symbol=_fm_symbol(mt, init), data_names=["data"],
                        label_names=["label"], context=CPU)
    mses = []
    metric = mt.metric.create("MSE")
    mod.fit(it, num_epoch=6, optimizer=_optimizer(mt, "adagrad"),
            initializer=init, eval_metric=metric,
            epoch_end_callback=lambda *a: mses.append(metric.get()[1]))
    assert mses[-1] < 0.5 * mses[0]
