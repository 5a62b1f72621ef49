"""The port's initializers against the JAX package's
(`mxnet_tpu/initializer.py`).  Random draws come from each package's own
generator, so `Uniform`, `Normal`, `Xavier` (every ``rnd_type`` and
``factor_type``), `MSRAPrelu` and `Orthogonal` are held by their
statistics at ResNet-50's shapes: a std within 2 % of the formula (the
standard error at these sizes is under 1 %), a uniform range within its
bound, ``max|W Wᵀ - I|`` of an orthogonal matrix within 1e-4 (scaled
out).  `Bilinear`, `LSTMBias`, `Constant`, `Zero`, `One` and the name
rules must equal the JAX package's exactly, and `Mixed` routes by
pattern.  `tests/test_init_cases.py`'s cases run on the port.
"""
import math

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

STD_TOL = 0.02
ORTHO_TOL = 1e-4
SHAPES = [(64, 3, 7, 7), (256, 64, 1, 1), (512, 128, 3, 3), (1000, 2048)]


def _init(pkg, init, name, shape):
    if pkg is mx:
        arr = mx.nd.zeros(shape)
    else:
        arr = mt.nd.zeros(shape, ctx=mt.cpu())
    init(name, arr)
    return arr.asnumpy()


def _fans(shape):
    hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    return shape[1] * hw, shape[0] * hw


@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
@pytest.mark.parametrize("shape", SHAPES)
def test_xavier_statistics(rnd_type, factor_type, shape):
    mt.random.seed(0)
    w = _init(mt, mt.init.Xavier(rnd_type, factor_type, 2.0), "c_weight",
              shape)
    fan_in, fan_out = _fans(shape)
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = math.sqrt(2.0 / factor)
    std = scale / math.sqrt(3) if rnd_type == "uniform" else scale
    assert abs(w.std() / std - 1) < STD_TOL
    if rnd_type == "uniform":
        assert np.abs(w).max() <= scale


@pytest.mark.parametrize("shape", SHAPES)
def test_msraprelu_statistics(shape):
    mt.random.seed(1)
    w = _init(mt, mt.init.MSRAPrelu("in", 0.25), "c_weight", shape)
    std = math.sqrt(2.0 / (1 + 0.25 ** 2) / _fans(shape)[0])
    assert abs(w.std() / std - 1) < STD_TOL
    assert mt.init.MSRAPrelu().dumps() == mx.init.MSRAPrelu().dumps()


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(64, 3, 7, 7), (256, 64, 1, 1),
                                   (64, 576)])
def test_orthogonal_rows_or_columns(rand_type, shape):
    mt.random.seed(2)
    w = _init(mt, mt.init.Orthogonal(scale=1.5, rand_type=rand_type),
              "c_weight", shape).reshape(shape[0], -1) / 1.5
    q = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
    assert np.abs(q - np.eye(q.shape[0])).max() < ORTHO_TOL


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 5, 5),
                                   (3, 1, 3, 6)])
def test_bilinear_equals_reference(shape):
    np.testing.assert_array_equal(_init(mt, mt.init.Bilinear(), "w", shape),
                                  _init(mx, mx.init.Bilinear(), "w", shape))


def test_bilinear_kernel_of_the_reference_test():
    a = _init(mt, mt.init.Bilinear(), "w", (1, 1, 4, 4))[0, 0]
    row = np.array([0.25, 0.75, 0.75, 0.25])
    np.testing.assert_allclose(a, np.outer(row, row), rtol=1e-6)


@pytest.mark.parametrize("forget_bias", [1.0, 0.5])
def test_lstmbias_equals_reference(forget_bias):
    got = _init(mt, mt.init.LSTMBias(forget_bias), "l_i2h_bias", (32,))
    want = _init(mx, mx.init.LSTMBias(forget_bias), "l_i2h_bias", (32,))
    np.testing.assert_array_equal(got, want)
    # the name rule sends a bias to zero, as in the reference
    np.testing.assert_array_equal(
        _init(mt, mt.init.LSTMBias(forget_bias), "l_i2h_bias", (8,)), 0)


def test_lstmbias_weight_rule():
    b = np.zeros(16, np.float32)
    arr = mt.nd.zeros((16,), ctx=mt.cpu())
    mt.init.LSTMBias(2.0)._init_weight("b", arr)
    b[4:8] = 2.0
    np.testing.assert_array_equal(arr.asnumpy(), b)


def test_mixed_routes_by_pattern():
    for pkg in (mx, mt):
        init = pkg.init.Mixed([".*bias$", ".*"],
                              [pkg.init.Constant(3.0), pkg.init.One()])
        assert (_init(pkg, init, "fc_bias", (4,)) == 3).all()
        assert (_init(pkg, init, "fc_weight", (2, 3)) == 1).all()
        with pytest.raises(ValueError):
            pkg.init.Mixed(["^a$"], [pkg.init.One()])("b", None)


@pytest.mark.parametrize("name", ["fc_bias", "bn_gamma", "bn_beta",
                                  "bn_moving_mean", "bn_running_var",
                                  "fc_weight"])
@pytest.mark.parametrize("init", ["zero", "one", "constant"])
def test_name_rules_equal_reference(name, init):
    kw = {"value": 2.5} if init == "constant" else {}
    got = _init(mt, mt.init.create(init, **kw), name, (3, 2))
    want = _init(mx, mx.init.create(init, **kw), name, (3, 2))
    np.testing.assert_array_equal(got, want)


def test_uniform_and_normal_statistics():
    mt.random.seed(3)
    u = _init(mt, mt.init.Uniform(0.3), "w", (512, 512))
    assert np.abs(u).max() <= 0.3
    assert abs(u.std() / (0.3 / math.sqrt(3)) - 1) < STD_TOL
    n = _init(mt, mt.init.Normal(0.2), "w", (512, 512))
    assert abs(n.std() / 0.2 - 1) < STD_TOL


def test_variable_init_attr_wins_over_global():
    """`tests/test_init_cases.py`'s default-and-variable case."""
    data = mt.sym.Variable("data")
    w = mt.sym.Variable("w", init=mt.init.Constant(3.0), shape=(4, 4))
    mod = mt.mod.Module(mt.sym.dot(data, w), label_names=None,
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (2, 4))])
    mod.init_params(initializer=mt.init.Zero())
    np.testing.assert_allclose(mod.get_params()[0]["w"].asnumpy(), 3.0)


def test_aux_moving_stats_init():
    """`tests/test_init_cases.py`'s aux case: mean 0, var 1."""
    mod = mt.mod.Module(mt.sym.BatchNorm(mt.sym.Variable("data"),
                                         name="bn"), context=mt.cpu())
    mod.bind(data_shapes=[("data", (4, 3, 5, 5))])
    mod.init_params()
    aux = mod.get_params()[1]
    assert (aux["bn_moving_var"].asnumpy() == 1).all()
    assert (aux["bn_moving_mean"].asnumpy() == 0).all()
