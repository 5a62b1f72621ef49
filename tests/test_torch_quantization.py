"""int8 quantization on the port (`mxnet_tpu_torch.contrib.quantization`,
`ops/quantized_ops.py`) against the JAX package's.

* `tests/test_quantization.py`'s cases run on the port with their own
  oracles and tolerances (the module's ``mx``/``nd``/``quantize_model``
  swapped for the port's).
* On the same symbol, parameters and calibration batches the two passes
  write the same quantized symbol JSON and the same ``qarg_params``, byte
  for byte (as ``.params`` files), with ``calib_mode`` ``naive`` and
  ``none``, excluded layers and ``quantized_dtype``.
* The quantized graphs' int32 accumulators (every ``_contrib_quantized_
  conv`` and ``_contrib_quantized_fully_connected`` output) are bit-equal
  between the packages on the same input, and so are their int8 outputs.
* ``.params`` files with int8 and int32 entries load in the other
  package with the same bytes, both ways.
* `example/quantization/quantize_cnn.py`'s flow on the port (its net and
  optimizer, fewer samples and epochs): the int8 accuracy within the
  example's 2 % of fp32.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch.contrib import quantization as tq

import test_quantization as ref

CPU = mt.cpu()


def _on_the_port(monkeypatch):
    for attr, val in (("mx", mt), ("nd", mt.nd),
                      ("quantize_model", tq.quantize_model),
                      ("NDArrayIter", mt.io.NDArrayIter),
                      ("assert_almost_equal",
                       mt.test_utils.assert_almost_equal)):
        monkeypatch.setattr(ref, attr, val)


CASES = ["test_quantized_resnet_top1_within_1pct",
         "test_quantized_pooling_max_exact",
         "test_quantized_concat_rescales_to_widest_range",
         "test_quantized_conv_matches_float_conv",
         "test_quantized_act_preserves_asymmetric_range",
         "test_quantized_pooling_default_stride_matches_float",
         "test_quantize_model_fc_on_conv_output_falls_back",
         "test_quantize_model_prunes_fp32_weights"]


@pytest.mark.parametrize("name", CASES)
def test_reference_case_on_the_port(monkeypatch, name):
    _on_the_port(monkeypatch)
    with CPU:
        getattr(ref, name)()


# -- the pass against the JAX package's ------------------------------------

def _mini_resnet(pkg, monkeypatch):
    monkeypatch.setattr(ref, "mx", pkg)
    return ref._mini_resnet()


def _cnn(pkg):
    """`example/quantization/quantize_cnn.py`'s ``build_net``."""
    sym = pkg.sym
    data = sym.var("data")
    x = sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                        name="conv1")
    x = sym.Activation(x, act_type="relu", name="relu1")
    x = sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool1")
    x = sym.Convolution(x, kernel=(3, 3), num_filter=16, pad=(1, 1),
                        name="conv2")
    x = sym.Activation(x, act_type="relu", name="relu2")
    x = sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1),
                    name="gap")
    x = sym.Flatten(x, name="flat")
    x = sym.FullyConnected(x, num_hidden=4, name="fc")
    return sym.SoftmaxOutput(x, sym.var("softmax_label"), name="softmax")


def _cnn_data(n, rng):
    """The example's 4-class images: class = the bright blob's quadrant."""
    X = rng.rand(n, 3, 16, 16).astype(np.float32) * 0.3
    y = rng.randint(0, 4, n)
    for i, cls in enumerate(y):
        r, c = divmod(int(cls), 2)
        X[i, :, r * 8:(r + 1) * 8, c * 8:(c + 1) * 8] += 0.7
    return X, y.astype(np.float32)


def _numpy_params(sym, shapes, seed=1):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    args = {}
    for name, shp in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        scale = 0.3 if name.endswith("weight") else 0.05
        args[name] = rs.randn(*shp).astype(np.float32) * scale
    auxs = {name: np.zeros(shp, np.float32)
            for name, shp in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _quantize(pkg, qmod, sym, args, auxs, X, Y=None, **kw):
    arr = pkg.nd.array
    it = pkg.io.NDArrayIter(data=X, label=Y, batch_size=8)
    return qmod.quantize_model(
        sym, {k: arr(v) for k, v in args.items()},
        {k: arr(v) for k, v in auxs.items()}, calib_data=it, **kw)


def _params_bytes(pkg, params, path):
    pkg.nd.save(path, {f"arg:{k}": v for k, v in sorted(params.items())})
    with open(path, "rb") as f:
        return f.read()


MODELS = {
    "mini_resnet": (lambda pkg, mp: _mini_resnet(pkg, mp),
                    {"data": (16, 3, 16, 16)}, {}),
    "mini_resnet_excluded": (lambda pkg, mp: _mini_resnet(pkg, mp),
                             {"data": (16, 3, 16, 16)},
                             {"excluded_sym_names": ("stem_conv", "fc"),
                              "num_calib_examples": 8}),
    "cnn_no_calib": (lambda pkg, mp: _cnn(pkg),
                     {"data": (16, 3, 16, 16), "softmax_label": (16,)},
                     {"calib_mode": "none", "quantized_dtype": "auto"}),
    "cnn_excluded_fc": (lambda pkg, mp: _cnn(pkg),
                        {"data": (16, 3, 16, 16), "softmax_label": (16,)},
                        {"excluded_sym_names": ("fc",)}),
}


def _fresh_names(monkeypatch):
    """Both packages' automatic symbol names counted from 0, as in a fresh
    process (``body + b1`` is ``broadcast_add0``)."""
    from mxnet_tpu.symbol import symbol as jsym
    from mxnet_tpu_torch.symbol import symbol as tsym
    for mod in (jsym, tsym):
        monkeypatch.setattr(mod._NAMES, "counters", {})


@pytest.mark.parametrize("model", sorted(MODELS))
def test_pass_writes_the_same_json_and_params(monkeypatch, tmp_path,
                                              model):
    build, shapes, kw = MODELS[model]
    _fresh_names(monkeypatch)
    X, Y = _cnn_data(16, np.random.RandomState(3))
    jsym = build(mx, monkeypatch)
    args, auxs = _numpy_params(jsym, shapes)
    label = Y if "softmax_label" in shapes else None
    jq_sym, jq_args, jq_aux = _quantize(mx, jq, jsym, args, auxs, X, label,
                                        **kw)
    with CPU:
        tsym = build(mt, monkeypatch)
        tq_sym, tq_args, tq_aux = _quantize(mt, tq, tsym, args, auxs, X,
                                            label, **kw)
        tbytes = _params_bytes(mt, tq_args, str(tmp_path / "t.params"))
    assert tq_sym.tojson() == jq_sym.tojson()
    assert sorted(tq_args) == sorted(jq_args)
    jbytes = _params_bytes(mx, jq_args, str(tmp_path / "j.params"))
    assert tbytes == jbytes
    assert sorted(tq_aux) == sorted(jq_aux)


def _internal_outputs(pkg, qsym, qargs, qaux, X, ctx=None):
    """Every int8 layer's outputs: the int32 accumulators of the quantized
    convolutions and dense layers and the int8 payloads after them."""
    internals = qsym.get_internals()
    names = [n for n in internals.list_outputs()
             if n.endswith(("_int8_output0", "_requantize_output0"))]
    group = pkg.sym.Group([internals[n] for n in names])
    kw = {} if ctx is None else {"ctx": ctx}
    ex = group.simple_bind(grad_req="null", data=X.shape, **kw)
    ex.copy_params_from(qargs, qaux, allow_extra_params=True)
    outs = ex.forward(is_train=False, data=pkg.nd.array(X, **kw))
    return dict(zip(names, [o.asnumpy() for o in outs]))


def test_int32_accumulators_bit_equal(monkeypatch):
    X, _ = _cnn_data(16, np.random.RandomState(4))
    _fresh_names(monkeypatch)
    jsym = _mini_resnet(mx, monkeypatch)
    args, auxs = _numpy_params(jsym, {"data": X.shape})
    jout = _internal_outputs(mx, *_quantize(mx, jq, jsym, args, auxs, X), X)
    with CPU:
        tsym = _mini_resnet(mt, monkeypatch)
        tout = _internal_outputs(mt, *_quantize(mt, tq, tsym, args, auxs,
                                                X), X, ctx=CPU)
    assert sorted(tout) == sorted(jout)
    accs = [n for n in jout if n.endswith("_int8_output0") and
            jout[n].dtype == np.int32]
    assert len(accs) >= 5, sorted(jout)
    for name in jout:
        assert tout[name].dtype == jout[name].dtype, name
        np.testing.assert_array_equal(tout[name], jout[name], err_msg=name)


def test_large_reductions_stay_exact():
    """A 3 x 3 convolution over 512 channels (K = 4608) and a dense layer
    over 4608 inputs, all operands +-127: sums past 2^24, exact int32 in
    both packages."""
    x = np.full((2, 512, 3, 3), 127, np.int8)
    w = np.full((4, 512, 3, 3), -127, np.int8)
    w[1] = 127
    rng = [np.array([v], np.float32) for v in (-1.0, 1.0, -1.0, 1.0)]
    jo = mx.nd._contrib_quantized_conv(
        *[mx.nd.array(a, dtype=a.dtype) for a in [x, w] + rng],
        kernel=(3, 3), pad=(1, 1), num_filter=4, no_bias=True)[0].asnumpy()
    with CPU:
        to = mt.nd._contrib_quantized_conv(
            *[mt.nd.array(a, dtype=a.dtype) for a in [x, w] + rng],
            kernel=(3, 3), pad=(1, 1), num_filter=4,
            no_bias=True)[0].asnumpy()
    assert to.dtype == np.int32 and np.abs(to).max() == 4608 * 127 * 127
    np.testing.assert_array_equal(to, jo)


def test_int_params_cross_both_ways(tmp_path):
    a = np.random.RandomState(5).randint(-127, 128, (3, 4)).astype(np.int8)
    b = (np.arange(6, dtype=np.int32).reshape(2, 3) - 3) * 40000
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    mx.nd.save(jpath, {"arg:w_quantized": mx.nd.array(a, dtype=np.int8),
                       "arg:acc": mx.nd.array(b, dtype=np.int32)})
    with CPU:
        mt.nd.save(tpath, {"arg:w_quantized": mt.nd.array(a, dtype=np.int8),
                           "arg:acc": mt.nd.array(b, dtype=np.int32)})
        back = mt.nd.load(jpath)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    theirs = mx.nd.load(tpath)
    for got in (back, theirs):
        assert got["arg:w_quantized"].asnumpy().dtype == np.int8
        assert got["arg:acc"].asnumpy().dtype == np.int32
        np.testing.assert_array_equal(got["arg:w_quantized"].asnumpy(), a)
        np.testing.assert_array_equal(got["arg:acc"].asnumpy(), b)


def test_quantize_cnn_example_on_the_port():
    """The example's flow on the port: train, calibrate on held-out
    batches with the head excluded, rewrite, score; int8 accuracy within
    the example's 2 % of fp32 (the example's own check)."""
    rng = np.random.RandomState(0)
    Xtr, ytr = _cnn_data(256, rng)
    Xte, yte = _cnn_data(128, rng)
    mt.random.seed(0)
    np.random.seed(0)      # NDArrayIter's shuffle draws from numpy's
    with CPU:
        mod = mt.mod.Module(_cnn(mt), context=CPU)
        train_iter = mt.io.NDArrayIter(Xtr, ytr, batch_size=32, shuffle=True)
        mod.fit(train_iter, num_epoch=2, optimizer="adam",
                optimizer_params={"learning_rate": 0.01})
        arg_params, aux_params = mod.get_params()
        test_iter = mt.io.NDArrayIter(Xte, yte, batch_size=32)
        fp32_acc = dict(mod.score(test_iter,
                                  mt.metric.Accuracy()))["accuracy"]
        calib = mt.io.NDArrayIter(Xtr[:64], ytr[:64], batch_size=32)
        qsym, qargs, qauxs = tq.quantize_model(
            mod.symbol, arg_params, aux_params, excluded_sym_names=("fc",),
            calib_mode="naive", calib_data=calib, num_calib_examples=64)
        qmod = mt.mod.Module(qsym, context=CPU)
        test_iter.reset()
        qmod.bind(data_shapes=test_iter.provide_data,
                  label_shapes=test_iter.provide_label, for_training=False)
        qmod.set_params(qargs, qauxs)
        int8_acc = dict(qmod.score(test_iter,
                                   mt.metric.Accuracy()))["accuracy"]
    assert int8_acc >= fp32_acc - 0.02, (int8_acc, fp32_acc)
    assert "_contrib_quantized_conv" in qsym.tojson()


def test_example_script_is_the_one_ported():
    """The net above is the example's, layer for layer."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "example", "quantization",
        "quantize_cnn.py")
    src = open(path).read()
    for layer in ("conv1", "relu1", "pool1", "conv2", "relu2", "gap",
                  "flat", "fc", "softmax"):
        assert f'name="{layer}"' in src, layer
    assert _cnn(mx).tojson() == _cnn(mt).tojson()
