"""The port's testing toolkit (`mxnet_tpu_torch.test_utils`) against the
JAX package's on the same symbols and seeded inputs: the numeric and
symbolic checks pass in both and return the same arrays, the consistency
oracle runs over the contexts it is given, and the helpers (tolerances,
generators, sparse builders, env scoping, data contracts) behave alike."""
import os

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import test_utils as jtu

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mt.cpu():
        yield


def _sym(ns, kind):
    x = ns.sym.Variable("x")
    if kind == "fc":
        return ns.sym.FullyConnected(x, num_hidden=3, name="fc")
    if kind == "tanh":
        return ns.sym.tanh(x)
    if kind == "mul":
        return ns.sym.elemwise_mul(x, ns.sym.Variable("y"))
    if kind == "softmax":
        return ns.sym.softmax(ns.sym.broadcast_mul(x, ns.sym.Variable("y")))
    raise ValueError(kind)


def _loc(kind, rng):
    if kind == "fc":
        return {"x": rng.randn(2, 4), "fc_weight": rng.randn(3, 4),
                "fc_bias": rng.randn(3)}
    if kind == "tanh":
        return {"x": rng.randn(3, 5)}
    return {"x": rng.randn(2, 3), "y": rng.randn(2, 3)}


KINDS = ("fc", "tanh", "mul", "softmax")


@pytest.mark.parametrize("kind", KINDS)
def test_check_numeric_gradient_passes_in_both(kind):
    loc = _loc(kind, np.random.RandomState(0))
    tu.check_numeric_gradient(_sym(mt, kind), loc, numeric_eps=1e-3,
                              rtol=1e-2, atol=1e-3)
    jtu.check_numeric_gradient(_sym(mx, kind), loc, numeric_eps=1e-3,
                               rtol=1e-2, atol=1e-3)


def test_check_numeric_gradient_catches_a_wrong_gradient(monkeypatch):
    from mxnet_tpu_torch.executor import Executor
    orig = Executor.backward

    def doubled(self, out_grads=None):
        res = orig(self, out_grads)
        for g in self.grad_dict.values():
            g[:] = g.asnumpy() * 2
        return res

    monkeypatch.setattr(Executor, "backward", doubled)
    with pytest.raises(AssertionError):
        tu.check_numeric_gradient(_sym(mt, "tanh"),
                                  _loc("tanh", np.random.RandomState(0)))


def _np_forward(kind, loc):
    if kind == "fc":
        return loc["x"] @ loc["fc_weight"].T + loc["fc_bias"]
    if kind == "tanh":
        return np.tanh(loc["x"])
    if kind == "mul":
        return loc["x"] * loc["y"]
    z = loc["x"] * loc["y"]
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("kind", KINDS)
def test_check_symbolic_forward_matches_reference(kind):
    loc = _loc(kind, np.random.RandomState(1))
    want = _np_forward(kind, loc)
    got = tu.check_symbolic_forward(_sym(mt, kind), loc, [want],
                                    rtol=1e-4, atol=1e-5)
    ref = jtu.check_symbolic_forward(_sym(mx, kind), loc, [want],
                                     rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0], ref[0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ("tanh", "mul"))
def test_check_symbolic_backward_matches_reference(kind):
    rng = np.random.RandomState(2)
    loc = _loc(kind, rng)
    og = rng.randn(*loc["x"].shape)
    if kind == "tanh":
        want = {"x": og * (1 - np.tanh(loc["x"]) ** 2)}
    else:
        want = {"x": og * loc["y"], "y": og * loc["x"]}
    got = tu.check_symbolic_backward(_sym(mt, kind), loc, [og], want,
                                     rtol=1e-4, atol=1e-5)
    ref = jtu.check_symbolic_backward(_sym(mx, kind), loc, [og], want,
                                      rtol=1e-4, atol=1e-5)
    for name in want:
        np.testing.assert_allclose(got[name], ref[name], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_check_consistency_matches_reference(kind):
    loc = _loc(kind, np.random.RandomState(3))
    params = {k: v.astype(np.float32) for k, v in loc.items()}
    got = tu.check_consistency(_sym(mt, kind), ctx_list=[mt.cpu()],
                               arg_params=params)
    ref = jtu.check_consistency(_sym(mx, kind), arg_params=params)
    np.testing.assert_allclose(got[0], ref[0], rtol=TOL, atol=TOL)


def test_check_consistency_takes_reference_style_dicts():
    sym = _sym(mt, "tanh")
    out = tu.check_consistency(sym, ctx_list=[
        {"ctx": mt.cpu(), "x": (4, 2), "type_dict": {"x": np.float32}},
        {"ctx": mt.cpu(0), "x": (4, 2)}])
    assert out[0].shape == (4, 2)
    assert tu.check_consistency(sym, arg_params={"x": np.ones((2, 2))})[0] \
        .shape == (2, 2)


def test_device_lists():
    assert tu.list_gpus() == []
    assert tu.list_tpus() == []
    assert isinstance(tu.default_context(), mt.Context)
    tu.set_default_context(mt.cpu())
    assert tu.default_context() == mt.cpu()


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_tolerances_match_reference(dtype):
    a = np.ones(4, dtype)
    b = a + np.asarray(2e-5, dtype)
    assert tu.almost_equal(a, b) == jtu.almost_equal(a, b)
    assert tu._tols(a, b, None, None) == jtu._tols(a, b, None, None)
    assert tu.same(a, a.copy()) and not tu.same(a, b) or dtype == np.float16


def test_assert_almost_equal_accepts_ndarrays_and_raises():
    x = mt.nd.array(np.arange(4, dtype=np.float32))
    tu.assert_almost_equal(x, np.arange(4, dtype=np.float32))
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(x, np.arange(4, dtype=np.float32) + 1)


def test_numeric_grad_matches_reference():
    x = np.random.RandomState(4).randn(3, 2)
    f = lambda v: float((v ** 3).sum())  # noqa: E731
    np.testing.assert_allclose(tu.numeric_grad(f, x.copy()),
                               jtu.numeric_grad(f, x.copy()))


def test_simple_forward_matches_reference():
    x = np.random.RandomState(5).randn(2, 3).astype(np.float32)
    np.testing.assert_allclose(tu.simple_forward(_sym(mt, "tanh"), x=x),
                               jtu.simple_forward(_sym(mx, "tanh"), x=x),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("axis,keepdims", [(None, False), (1, True),
                                           ((0, 2), False), (2, True)])
def test_np_reduce_matches_reference(axis, keepdims):
    x = np.random.RandomState(6).rand(2, 3, 4)
    np.testing.assert_array_equal(tu.np_reduce(x, axis, keepdims, np.sum),
                                  jtu.np_reduce(x, axis, keepdims, np.sum))


def test_nan_tolerant_comparisons_match_reference():
    a = np.array([1.0, np.nan, 3.0])
    b = np.array([1.0, 2.0, np.nan])
    assert tu.almost_equal_ignore_nan(a, b) == \
        jtu.almost_equal_ignore_nan(a, b) is True
    tu.assert_almost_equal_ignore_nan(a, b)
    c = np.array([1.0, 2.5, 3.0])
    assert tu.find_max_violation(a[[0, 2]], c[[0, 2]]) == \
        jtu.find_max_violation(a[[0, 2]], c[[0, 2]])


def test_generators_and_elementwise_helpers():
    np.random.seed(0)
    s = tu.rand_shape_nd(3, 5)
    assert len(s) == 3 and all(1 <= d <= 5 for d in s)
    assert len(tu.rand_shape_2d()) == 2 and len(tu.rand_shape_3d()) == 3
    a, b = tu.random_arrays((2, 3), (4,))
    assert a.shape == (2, 3) and b.shape == (4,)
    assert len(tu.random_sample(list(range(10)), 4)) == 4
    x = np.arange(4.0)
    np.testing.assert_array_equal(tu.assign_each(x, lambda v: v * 2),
                                  jtu.assign_each(x, lambda v: v * 2))
    np.testing.assert_array_equal(
        tu.assign_each2(x, x, lambda u, v: u + v),
        jtu.assign_each2(x, x, lambda u, v: u + v))
    tu.compare_ndarray_tuple((x, (x,)), (x, (x,)))
    r = tu.rand_ndarray((3, 2))
    assert r.shape == (3, 2) and r.context == mt.cpu()
    assert tu.get_rtol() == jtu.get_rtol() and \
        tu.get_atol() == jtu.get_atol()
    assert tu.default_dtype() == np.float32


def test_assert_exception_and_retry():
    tu.assert_exception(lambda: 1 / 0, ZeroDivisionError)
    with pytest.raises(AssertionError):
        tu.assert_exception(lambda: 1, ZeroDivisionError)
    calls = []

    @tu.retry(3)
    def flaky():
        calls.append(1)
        assert len(calls) >= 2

    flaky()
    assert len(calls) == 2
    with pytest.raises(ValueError):
        tu.retry(0)


def test_env_scoping():
    key = "MXTPU_TEST_UTILS_SCOPE"
    with tu.EnvManager(key, "1"):
        assert os.environ[key] == "1"
    assert key not in os.environ
    prev = tu.set_env_var(key, "2")
    assert prev == "" and os.environ[key] == "2"
    del os.environ[key]
    with tu.discard_stderr():
        import sys
        sys.stderr.write("hidden")


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_sparse_builders(stype):
    rng = np.random.RandomState(7)
    arr, dense = tu.rand_sparse_ndarray((6, 4), stype, density=0.5, rng=rng)
    assert arr.stype == stype
    np.testing.assert_array_equal(arr.asnumpy(), dense)
    made = tu.create_sparse_array((6, 4), stype, data_init=2.0)
    vals = made.asnumpy()
    assert set(np.unique(vals)) <= {0.0, 2.0}
    zd = tu.create_sparse_array_zd((5, 3), stype, density=0.0)
    assert not zd.asnumpy().any()


def test_rsp_indices_builder():
    arr = tu.create_sparse_array((5, 2), "row_sparse", data_init=1.5,
                                 rsp_indices=[4, 1, 9])
    np.testing.assert_array_equal(arr.asnumpy()[[1, 4]], np.full((2, 2),
                                                                 1.5))
    assert not arr.asnumpy()[[0, 2, 3]].any()


def test_shuffle_csr_column_indices_keeps_rows():
    import scipy.sparse as sps
    m = sps.csr_matrix(np.eye(4) + np.eye(4, k=1))
    before = m.toarray()
    np.random.seed(0)
    tu.shuffle_csr_column_indices(m)
    assert sorted(m.indices.tolist()) == sorted(
        sps.csr_matrix(before).indices.tolist())


def test_same_array_follows_storage():
    a = mt.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert tu.same_array(a, a)
    assert not tu.same_array(a, a.copy())
    view = mt.nd.NDArray(a.data[1:])
    assert tu.same_array(a, view)


def test_compare_optimizer_same_trajectory():
    tu.compare_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9),
                         mt.optimizer.SGD(learning_rate=0.1, momentum=0.9),
                         (3, 4))
    with pytest.raises(AssertionError):
        tu.compare_optimizer(mt.optimizer.SGD(learning_rate=0.1),
                             mt.optimizer.SGD(learning_rate=0.2), (3, 4))


def test_check_speed_times_the_symbol():
    sym = _sym(mt, "fc")
    loc = {k: v.astype(np.float32)
           for k, v in _loc("fc", np.random.RandomState(8)).items()}
    assert tu.check_speed(sym, location=loc, N=2) > 0
    assert tu.check_speed(sym, location=loc, N=2, typ="forward") > 0
    with pytest.raises(MXNetError):
        tu.check_speed(sym, location=loc, typ="half")


def test_distribution_checks():
    gen = lambda n: np.random.RandomState(9).normal(0.0, 1.0, n)  # noqa
    assert tu.mean_check(gen, 0.0, 1.0, 20000)
    assert tu.var_check(gen, 1.0, 20000)
    from scipy.stats import norm
    buckets, probs = tu.gen_buckets_probs_with_ppf(norm.ppf, 5)
    assert (buckets, probs) == jtu.gen_buckets_probs_with_ppf(norm.ppf, 5)
    _stat, p = tu.chi_square_check(gen, buckets, probs, 20000)
    assert p > 1e-4
    assert len(tu.verify_generator(gen, buckets, probs, 20000,
                                   nrepeat=2)) == 2


def test_dummy_iter_repeats_the_first_batch():
    it = mt.io.NDArrayIter(np.arange(12, dtype=np.float32).reshape(6, 2),
                           batch_size=2)
    d = tu.DummyIter(it)
    first = next(d)
    assert next(d) is first and d.batch_size == 2
    d.reset()


def test_no_network_contracts(tmp_path):
    with pytest.raises(MXNetError, match="no network"):
        tu.download("http://example.invalid/x.bin", dirname=str(tmp_path))
    with pytest.raises(mx.base.MXNetError, match="no network"):
        jtu.download("http://example.invalid/x.bin", dirname=str(tmp_path))
    src = tmp_path / "local.bin"
    src.write_bytes(b"abc")
    got = tu.download("file://" + str(src), dirname=str(tmp_path / "d"))
    assert open(got, "rb").read() == b"abc"
    assert tu.download("file://" + str(src),
                       fname=got) == got  # present: kept
    with pytest.raises(MXNetError):
        tu.get_mnist_ubyte(str(tmp_path))
    with pytest.raises(MXNetError):
        tu.get_cifar10(str(tmp_path))
    with pytest.raises(MXNetError):
        tu.get_mnist_pkl(str(tmp_path / "m"))
    assert tu.get_im2rec_path().endswith(os.path.join("tools", "im2rec.py"))


def test_get_mnist_equals_reference():
    got, ref = tu.get_mnist(), jtu.get_mnist()
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    train, val = tu.get_mnist_iterator(10, (1, 28, 28))
    assert next(iter(val)).data[0].shape == (10, 1, 28, 28)


def test_public_names_cover_the_reference():
    import inspect
    public = [n for n, v in vars(jtu).items()
              if not n.startswith("_") and (inspect.isfunction(v)
                                            or inspect.isclass(v))
              and getattr(v, "__module__", "") == jtu.__name__]
    missing = [n for n in public if not hasattr(tu, n)]
    assert not missing
    assert set(tu.__all__) == set(jtu.__all__)
