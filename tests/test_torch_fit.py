"""The port's symbolic training loop on the CPU, against the JAX package:
`io.NDArrayIter`, `lr_scheduler`, `metric`, `callback`, and `Module.fit`,
``score`` and ``predict`` on an MLP with SoftmaxOutput and on a 2-layer
narrow BERT MLM, from the same numpy inputs made from a seed."""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.model_zoo import bert_mlm, random_params

# the reference's SGD parity tolerance (tests/test_torch_module.py)
SGD_TOL = 1e-4
METRIC_TOL = 1e-6


def _arrays(pkg, *xs):
    """numpy arrays as each package's NDArrays (the port's on the CPU)."""
    if pkg is mx:
        return [mx.nd.array(x) for x in xs]
    return [mt.nd.array(x, ctx=mt.cpu()) for x in xs]


# ---------------------------------------------------------------------------
# NDArrayIter
# ---------------------------------------------------------------------------

def _epochs(it, n=2):
    """Each epoch's batches as numpy: (data..., label..., pad)."""
    out = []
    for _ in range(n):
        it.reset()
        out.append([([d.asnumpy() for d in b.data],
                     [l.asnumpy() for l in (b.label or [])], b.pad)
                    for b in it])
    return out


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_reference(handle, shuffle):
    rng = np.random.RandomState(3)
    data = rng.randn(11, 3).astype(np.float32)
    label = rng.randint(0, 4, 11).astype(np.float32)
    got = []
    for pkg in (mx, mt):
        np.random.seed(7)
        it = pkg.io.NDArrayIter(data, label, batch_size=4, shuffle=shuffle,
                                last_batch_handle=handle)
        got.append((_epochs(it, 3),
                    [(d.name, tuple(d.shape)) for d in it.provide_data],
                    [(d.name, tuple(d.shape)) for d in it.provide_label]))
    (ref, ref_pd, ref_pl), (port, pd, pl) = got
    assert pd == ref_pd and pl == ref_pl
    assert len(port) == len(ref)
    for e_ref, e_port in zip(ref, port):
        assert len(e_ref) == len(e_port)
        for (d0, l0, p0), (d1, l1, p1) in zip(e_ref, e_port):
            assert p0 == p1
            for a, b in zip(d0 + l0, d1 + l1):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("form", ["dict", "list"])
def test_ndarray_iter_named_inputs(form):
    rng = np.random.RandomState(4)
    a, b = rng.randn(6, 2).astype(np.float32), rng.randn(6, 5)
    lab = rng.randint(0, 2, 6)
    src = {"x": a, "y": b} if form == "dict" else [a, b]
    descs = []
    for pkg in (mx, mt):
        it = pkg.io.NDArrayIter(src, {"lab": lab}, batch_size=3)
        descs.append(([(d.name, tuple(d.shape), np.dtype(d.dtype).name)
                       for d in it.provide_data],
                      [(d.name, tuple(d.shape)) for d in it.provide_label],
                      _epochs(it, 1)))
    assert descs[1][:2] == descs[0][:2]
    for (d0, l0, _), (d1, l1, _) in zip(descs[0][2][0], descs[1][2][0]):
        for x, y in zip(d0 + l0, d1 + l1):
            np.testing.assert_array_equal(x, y)


def test_ndarray_iter_keeps_numpy_on_the_host():
    it = mt.io.NDArrayIter(np.zeros((4, 2), np.float32), batch_size=2)
    assert next(it).data[0].data.device.type == "cpu"


# ---------------------------------------------------------------------------
# lr_scheduler
# ---------------------------------------------------------------------------

SCHEDULES = {
    "factor": lambda p: p.lr_scheduler.FactorScheduler(
        step=7, factor=0.5, base_lr=0.1, stop_factor_lr=1e-3),
    "factor_warmup": lambda p: p.lr_scheduler.FactorScheduler(
        step=10, factor=0.9, base_lr=0.1, warmup_steps=5,
        warmup_begin_lr=0.01),
    "multifactor": lambda p: p.lr_scheduler.MultiFactorScheduler(
        step=[10, 30, 60], factor=0.3, base_lr=0.2, warmup_steps=4,
        warmup_mode="constant", warmup_begin_lr=0.05),
    "poly": lambda p: p.lr_scheduler.PolyScheduler(
        max_update=80, base_lr=0.1, pwr=2, final_lr=1e-3, warmup_steps=10),
    "cosine": lambda p: p.lr_scheduler.CosineScheduler(
        max_update=90, base_lr=0.3, final_lr=0.01, warmup_steps=5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_scheduler_values_over_100_updates(name):
    ref, port = SCHEDULES[name](mx), SCHEDULES[name](mt)
    want = [ref(t) for t in range(100)]
    got = [port(t) for t in range(100)]
    assert got == want


def test_optimizer_reads_the_schedule_like_the_reference():
    """The per-parameter update reads the schedule after its count
    advances, in both packages: the same weights after 5 SGD steps."""
    out = []
    for pkg in (mx, mt):
        sched = pkg.lr_scheduler.PolyScheduler(max_update=10, base_lr=0.5,
                                               warmup_steps=2)
        opt = pkg.optimizer.create("sgd", learning_rate=0.5, momentum=0.9,
                                   lr_scheduler=sched, wd=0.1,
                                   param_idx2name={0: "w_weight"})
        upd = pkg.optimizer.get_updater(opt)
        w, g = _arrays(pkg, np.linspace(-1, 1, 6, dtype=np.float32),
                       np.linspace(2, -3, 6, dtype=np.float32))
        lrs = []
        for _ in range(5):
            upd(0, g, w)
            lrs.append(opt.learning_rate)
        out.append((w.asnumpy(), lrs))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6, atol=1e-7)
    assert out[1][1] == out[0][1]


def test_param_dict_multipliers_like_the_reference():
    class P:
        lr_mult, wd_mult = 0.5, 3.0

    for pkg in (mx, mt):
        opt = pkg.optimizer.create("sgd", learning_rate=0.2, wd=0.1,
                                   param_dict={4: P()}, multi_precision=True)
        assert (opt._get_lr(4), opt._get_wd(4)) == (0.1, pytest.approx(0.3))
        assert opt.multi_precision


# ---------------------------------------------------------------------------
# metric
# ---------------------------------------------------------------------------

_R = np.random.RandomState(11)
_P3 = _R.rand(12, 3).astype(np.float32)
_P3 /= _P3.sum(1, keepdims=True)
_L3 = _R.randint(0, 3, 12).astype(np.float32)
_P2 = _R.rand(10, 2).astype(np.float32)
_L2 = _R.randint(0, 2, 10).astype(np.float32)
_REG_P = _R.randn(9).astype(np.float32)
_REG_L = _R.randn(9).astype(np.float32)

METRIC_CASES = {
    "acc": (("acc",), {}, _L3, _P3),
    "acc_2d_label": (("acc",), {}, _L3.reshape(3, 4),
                     _P3),
    "top_k": (("top_k_accuracy",), {"top_k": 2}, _L3, _P3),
    "f1": (("f1",), {}, _L2, _P2),
    "f1_micro": (("f1",), {"average": "micro"}, _L2, _P2),
    "mcc": (("mcc",), {}, _L2, _P2),
    "perplexity": (("perplexity",), {"ignore_label": None}, _L3, _P3),
    "perplexity_ignore": (("perplexity",), {"ignore_label": 1}, _L3, _P3),
    "mae": (("mae",), {}, _REG_L, _REG_P),
    "mse": (("mse",), {}, _REG_L, _REG_P),
    "rmse": (("rmse",), {}, _REG_L, _REG_P),
    "ce": (("ce",), {}, _L3, _P3),
    "nll": (("nll_loss",), {}, _L3, _P3),
    "pearsonr": (("pearsonr",), {}, _REG_L, _REG_P),
    "loss": (("loss",), {}, _REG_L, _REG_P),
    "composite": ((["acc", "ce"],), {}, _L3, _P3),
}


def _metric_value(pkg, args, kwargs, label, pred, as_nd):
    m = pkg.metric.create(*args, **kwargs)
    for half in (slice(0, None, 2), slice(1, None, 2)):
        lab = label[half] if label.ndim == 1 else label
        prd = pred[half] if label.ndim == 1 else pred
        if as_nd:
            lab, prd = _arrays(pkg, lab, prd)
        m.update([lab], [prd])
    names, values = m.get()
    return (names, np.atleast_1d(np.asarray(values, np.float64)),
            getattr(m, "num_inst", None))


@pytest.mark.parametrize("as_nd", [True, False], ids=["ndarray", "numpy"])
@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metric_matches_reference(case, as_nd):
    args, kwargs, label, pred = METRIC_CASES[case]
    ref = _metric_value(mx, args, kwargs, label, pred, as_nd)
    got = _metric_value(mt, args, kwargs, label, pred, as_nd)
    assert got[0] == ref[0] and got[2] == ref[2]
    np.testing.assert_allclose(got[1], ref[1], rtol=METRIC_TOL,
                               atol=METRIC_TOL)


def test_custom_and_np_metric_match_reference():
    def feval(label, pred):
        return float(np.abs(label - pred).mean())

    for make in (lambda p: p.metric.CustomMetric(feval, name="cmae"),
                 lambda p: p.metric.np(feval, name="npmae")):
        vals = []
        for pkg in (mx, mt):
            m = make(pkg)
            m.update(_arrays(pkg, _REG_L), _arrays(pkg, _REG_P))
            vals.append(m.get())
        assert vals[1] == pytest.approx(vals[0])


def test_device_metric_stays_on_device_until_get():
    m = mt.metric.Accuracy()
    m.update(_arrays(mt, _L3), _arrays(mt, _P3))
    assert isinstance(m.sum_metric, torch.Tensor)
    assert m.get()[1] == pytest.approx(
        float((_P3.argmax(1) == _L3).mean()))


# ---------------------------------------------------------------------------
# callbacks
# ---------------------------------------------------------------------------

def test_callbacks_log_like_the_reference(caplog, capsys):
    m = mt.metric.create("acc")
    m.update(_arrays(mt, _L3), _arrays(mt, _P3))
    param = mt.mod.base_module._BatchEndParam(1, 4, m, {})
    with caplog.at_level(logging.INFO):
        mt.callback.log_train_metric(2)(param)
        mt.callback.LogValidationMetricsCallback()(param)
        speed = mt.callback.Speedometer(batch_size=4, frequent=2,
                                        auto_reset=False)
        speed(mt.mod.base_module._BatchEndParam(1, 0, m, {}))
        speed(param)
    text = caplog.text
    assert "Iter[1] Batch[4] Train-accuracy" in text
    assert "Epoch[1] Validation-accuracy" in text
    assert "Speed:" in text and "samples/sec" in text
    mt.callback.ProgressBar(total=8, length=8)(param)
    assert "[====----] 50.0%" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Module.fit, score, predict
# ---------------------------------------------------------------------------

def _mlp(pkg):
    d = pkg.sym.var("data")
    h = pkg.sym.FullyConnected(d, num_hidden=16, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu", name="relu1")
    h = pkg.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


LR = 0.05


def _fit(pkg, ctx, sym, data, label, params, batch, data_names=("data",),
         label_names=("softmax_label",), epochs=2):
    it = pkg.io.NDArrayIter(data, label, batch_size=batch)
    mod = pkg.mod.Module(sym, data_names=data_names,
                         label_names=label_names, context=ctx)
    sched = pkg.lr_scheduler.PolyScheduler(max_update=4 * epochs,
                                           base_lr=LR, pwr=2,
                                           warmup_steps=2)
    losses = []
    mod.fit(it, num_epoch=epochs, optimizer="adam",
            optimizer_params={"learning_rate": LR, "wd": 1e-3,
                              "lr_scheduler": sched},
            arg_params={k: a for k, a in zip(params, _arrays(
                pkg, *params.values()))},
            eval_metric="acc",
            batch_end_callback=lambda p: losses.append(
                p.eval_metric.get()[1]))
    weights = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    score = mod.score(pkg.io.NDArrayIter(data, label, batch_size=batch),
                      "acc")
    pred = mod.predict(pkg.io.NDArrayIter(data, label, batch_size=batch))
    return weights, losses, score, pred.asnumpy()


def _compare(ref, got, noise=()):
    """Weights within SGD_TOL, the metric's values, score and predict.
    The ``noise`` parameters have a gradient of zero in exact arithmetic
    (a key bias shifts a row's scores alike, which softmax ignores): Adam
    divides their roundoff by its own size, so each step moves them by up
    to about lr, in either direction, in each package alike; they are held
    within the lr summed over the steps."""
    assert set(got[0]) == set(ref[0])
    for n in ref[0]:
        if n in noise:
            assert np.abs(got[0][n] - ref[0][n]).max() <= noise[n], n
            continue
        np.testing.assert_allclose(got[0][n], ref[0][n], rtol=SGD_TOL,
                                   atol=SGD_TOL, err_msg=n)
    np.testing.assert_allclose(got[1], ref[1], rtol=METRIC_TOL,
                               atol=METRIC_TOL)
    assert got[2][0][0] == ref[2][0][0]
    np.testing.assert_allclose(got[2][0][1], ref[2][0][1], atol=METRIC_TOL)
    np.testing.assert_allclose(got[3], ref[3], rtol=SGD_TOL, atol=SGD_TOL)


def test_fit_mlp_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(40, 8).astype(np.float32)
    y = rng.randint(0, 4, 40).astype(np.float32)
    params = {"fc1_weight": rng.randn(16, 8).astype(np.float32) * 0.1,
              "fc1_bias": np.zeros(16, np.float32),
              "fc2_weight": rng.randn(4, 16).astype(np.float32) * 0.1,
              "fc2_bias": np.zeros(4, np.float32)}
    ref = _fit(mx, mx.cpu(), _mlp(mx), x, y, params, 10)
    got = _fit(mt, mt.cpu(), _mlp(mt), x, y, params, 10)
    _compare(ref, got)
    assert got[3].shape == (40, 4)


BERT = dict(num_layers=2, hidden=64, heads=4, ffn=256, vocab=100,
            max_len=32, dropout=0.0)


def test_fit_bert_mlm_matches_reference():
    """2 epochs of 2 batches of a 2-layer narrow BERT MLM; positions ride
    the iterator as one row per sample."""
    n, seq = 4, 32
    rng = np.random.RandomState(1)
    data = rng.randint(0, BERT["vocab"], (n, seq)).astype(np.float32)
    label = np.where(rng.rand(n, seq) < 0.3, data, -1.0).astype(np.float32)
    pos = np.tile(np.arange(seq, dtype=np.float32), (n, 1))
    sym = bert_mlm(mx.sym, **BERT)
    shapes = {"data": (2, seq), "positions": (2, seq), "mlm_label": (2, seq)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    params = random_params({k: s for k, s in zip(sym.list_arguments(),
                                                 arg_shapes)
                            if k not in shapes}, seed=0)
    runs = []
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        runs.append(_fit(pkg, ctx, pkg.sym.load_json(sym.tojson()),
                         {"data": data, "positions": pos},
                         {"mlm_label": label}, params, 2,
                         data_names=("data", "positions"),
                         label_names=("mlm_label",)))
    steps = 2 * n // 2
    _compare(*runs, noise={k: 2 * LR * steps for k in params
                           if k.endswith("_key_bias")})
