"""The port's samplers (`ops/random_ops.py`, `nd.random`, `sym.random`,
`mx.random`/`mx.rnd`) on the CPU.  torch's streams are not JAX's
threefry, so the two packages are held to the same distributions, not
the same numbers: each distribution by a Kolmogorov-Smirnov (continuous)
or chi-square (discrete) test against `scipy.stats` with p > 1e-3 and by
its moments, mirroring `tests/test_random_distributions.py` and
`tests/test_random_surface.py`; every op's output shape and dtype against
the JAX package's for the same call; `seed` giving bit-equal reruns;
`shuffle` a permutation; and `multinomial`'s ``get_prob`` gradient
(count / p at the drawn entries) against the JAX package's rule."""
import numpy as np
import pytest
import scipy.stats as ss

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

N = 100_000
P_MIN = 1e-3
CPU = mt.cpu()


@pytest.fixture(autouse=True)
def cpu_scope():
    with mt.cpu():
        yield


def _ks(samples, cdf):
    p = ss.kstest(samples.astype(np.float64), cdf).pvalue
    assert p > P_MIN, p


def _chi2(samples, pmf, support):
    """Chi-square over ``support`` with the tail folded into the last
    bin."""
    s = samples.astype(np.int64)
    counts = np.array([(s == k).sum() for k in support[:-1]]
                      + [(s >= support[-1]).sum()], np.float64)
    probs = np.array([pmf(k) for k in support[:-1]])
    probs = np.append(probs, 1.0 - probs.sum())
    p = ss.chisquare(counts, probs * len(s)).pvalue
    assert p > P_MIN, p


CONTINUOUS = {
    "normal": (lambda: mt.nd.random.normal(1.5, 2.0, shape=(N,)),
               ss.norm(1.5, 2.0)),
    "uniform": (lambda: mt.nd.random.uniform(-2.0, 3.0, shape=(N,)),
                ss.uniform(-2.0, 5.0)),
    "gamma": (lambda: mt.nd.random.gamma(3.0, 2.0, shape=(N,)),
              ss.gamma(a=3.0, scale=2.0)),
    "gamma_small_shape": (lambda: mt.nd.random.gamma(0.5, 1.0, shape=(N,)),
                          ss.gamma(a=0.5)),
    "exponential": (lambda: mt.nd.random.exponential(2.5, shape=(N,)),
                    ss.expon(scale=2.5)),
    "randn": (lambda: mt.nd.random.randn(N, loc=-1.0, scale=0.5),
              ss.norm(-1.0, 0.5)),
    "normal_like": (lambda: mt.nd.random.normal_like(
        mt.nd.zeros((N,)), loc=2.0, scale=3.0), ss.norm(2.0, 3.0)),
    "exponential_like": (lambda: mt.nd.random.exponential_like(
        mt.nd.zeros((N,)), lam=4.0), ss.expon(scale=0.25)),
    "sample_uniform_row": (lambda: mt.nd.sample_uniform(
        mt.nd.array([1.0, -3.0]), mt.nd.array([2.0, 3.0]),
        shape=(N,))[1], ss.uniform(-3.0, 6.0)),
    "sample_normal_row": (lambda: mt.nd.sample_normal(
        mt.nd.array([0.0, 5.0]), mt.nd.array([1.0, 0.1]),
        shape=(N,))[1], ss.norm(5.0, 0.1)),
    "sample_gamma_row": (lambda: mt.nd.sample_gamma(
        mt.nd.array([2.0, 9.0]), mt.nd.array([1.0, 0.5]),
        shape=(N,))[1], ss.gamma(a=9.0, scale=0.5)),
    "sample_exponential_row": (lambda: mt.nd.sample_exponential(
        mt.nd.array([1.0, 3.0]), shape=(N,))[1], ss.expon(scale=1 / 3)),
}


@pytest.mark.parametrize("case", sorted(CONTINUOUS))
def test_continuous_distribution(case):
    draw, dist = CONTINUOUS[case]
    mt.random.seed(7)
    s = draw().asnumpy().ravel()
    _ks(s, dist.cdf)
    assert abs(s.mean() - dist.mean()) < 5 * dist.std() / np.sqrt(len(s))


def _negbin(k, p):
    return ss.nbinom(k, p)


def _gen_negbin(mu, alpha):
    # mean mu, variance mu + alpha mu^2: nbinom(1/alpha, 1/(1 + alpha mu))
    return ss.nbinom(1.0 / alpha, 1.0 / (1.0 + alpha * mu))


DISCRETE = {
    "poisson": (lambda: mt.nd.random.poisson(4.0, shape=(N,)),
                ss.poisson(4.0), 12),
    "poisson_like": (lambda: mt.nd.random.poisson_like(
        mt.nd.zeros((N,)), lam=0.7), ss.poisson(0.7), 5),
    "negative_binomial": (lambda: mt.nd.random.negative_binomial(
        5, 0.4, shape=(N,)), _negbin(5, 0.4), 20),
    "generalized_negative_binomial": (
        lambda: mt.nd.random.generalized_negative_binomial(
            3.0, 0.4, shape=(N,)), _gen_negbin(3.0, 0.4), 12),
    "randint": (lambda: mt.nd.random.randint(-3, 7, shape=(N,)) + 3,
                ss.randint(0, 10), 10),
    "sample_poisson_row": (lambda: mt.nd.sample_poisson(
        mt.nd.array([1.0, 6.0]), shape=(N,))[1], ss.poisson(6.0), 14),
    "sample_negative_binomial_row": (
        lambda: mt.nd.sample_negative_binomial(
            mt.nd.array([2.0, 3.0]), mt.nd.array([0.5, 0.6]),
            shape=(N,))[1], _negbin(3, 0.6), 8),
    "multinomial": (lambda: mt.nd.random.multinomial(
        mt.nd.array([0.1, 0.2, 0.3, 0.4]), shape=(N,)),
        ss.rv_discrete(values=([0, 1, 2, 3], [0.1, 0.2, 0.3, 0.4])), 4),
}


@pytest.mark.parametrize("case", sorted(DISCRETE))
def test_discrete_distribution(case):
    draw, dist, top = DISCRETE[case]
    mt.random.seed(8)
    s = draw().asnumpy().ravel()
    _chi2(s, dist.pmf, list(range(top)))
    assert abs(s.mean() - dist.mean()) < 5 * dist.std() / np.sqrt(len(s))


# one call per sampler op: (inputs as numpy, attrs)
_P2 = np.array([[0.5, 1.0, 2.0], [1.5, 2.5, 3.0]], np.float32)
_PR = np.array([[0.2, 0.3, 0.5], [0.6, 0.3, 0.1]], np.float32)
_DATA = np.zeros((2, 3), np.float32)
_ADJ = np.array([[0, 1, 2, 0, 0], [1, 0, 0, 3, 0], [2, 0, 0, 4, 5],
                 [0, 3, 4, 0, 0], [0, 0, 5, 0, 0]], np.float32)
CALLS = {
    "_random_uniform": ([], {"low": -1, "high": 2, "shape": (3, 4)}),
    "_random_normal": ([], {"loc": 1, "scale": 2, "shape": (3, 4)}),
    "_random_gamma": ([], {"alpha": 2, "beta": 3, "shape": (5,)}),
    "_random_exponential": ([], {"lam": 2, "shape": (2, 2)}),
    "_random_poisson": ([], {"lam": 3, "shape": (4,)}),
    "_random_negative_binomial": ([], {"k": 3, "p": 0.5, "shape": (4,)}),
    "_random_generalized_negative_binomial": (
        [], {"mu": 2, "alpha": 0.5, "shape": (4,)}),
    "_random_randint": ([], {"low": 0, "high": 5, "shape": (6,)}),
    "_random_uniform_float16": ([], {"shape": (3,), "dtype": "float16"}),
    "_random_uniform_like": ([_DATA], {"low": 1, "high": 2}),
    "_random_normal_like": ([_DATA], {}),
    "_random_gamma_like": ([_DATA], {"alpha": 2}),
    "_random_exponential_like": ([_DATA], {"lam": 3}),
    "_random_poisson_like": ([_DATA], {"lam": 2}),
    "_random_negative_binomial_like": ([_DATA], {"k": 2, "p": 0.3}),
    "_random_generalized_negative_binomial_like": ([_DATA], {"mu": 2,
                                                             "alpha": 1}),
    "sample_uniform": ([_P2, _P2 + 1], {"shape": (4,)}),
    "sample_normal": ([_P2, _P2], {"shape": (2, 2)}),
    "sample_gamma": ([_P2, _P2], {}),
    "sample_exponential": ([_P2], {"shape": (3,)}),
    "sample_poisson": ([_P2], {"shape": (3,)}),
    "sample_negative_binomial": ([_P2 + 1, _PR], {"shape": (2,)}),
    "sample_generalized_negative_binomial": ([_P2, _PR], {"shape": (2,)}),
    "_sample_multinomial": ([_PR], {"shape": (3, 2)}),
    "_sample_multinomial_one": ([_PR[0]], {}),
    "_sample_multinomial_get_prob": ([_PR], {"shape": 5, "get_prob": True}),
    "_shuffle": ([_P2], {}),
    "_contrib_dgl_csr_neighbor_uniform_sample": (
        [_ADJ, np.array([0, 2], np.float32)],
        {"num_neighbor": 2, "max_num_vertices": 6}),
    "_contrib_dgl_csr_neighbor_non_uniform_sample": (
        [_ADJ, np.array([0.1, 0.2, 0.3, 0.2, 0.2], np.float32),
         np.array([2, 3], np.float32)],
        {"num_neighbor": 3, "max_num_vertices": 7}),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_sampler_shapes_and_dtypes_match_reference(case):
    inputs, attrs = CALLS[case]
    name = case
    while name not in treg.list_ops():
        name = name.rsplit("_", 1)[0]
    jout = getattr(mx.nd, name)(*[mx.nd.array(x) for x in inputs], **attrs)
    tout = getattr(mt.nd, name)(*[mt.nd.array(x) for x in inputs], **attrs)
    jout = jout if isinstance(jout, list) else [jout]
    tout = tout if isinstance(tout, list) else [tout]
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        assert t.shape == j.shape
        assert t.asnumpy().dtype == j.asnumpy().dtype
        assert np.isfinite(t.asnumpy()).all()


def test_every_sampler_op_is_called():
    samplers = {n for n in treg.list_ops()
                if treg.get_op(n).needs_rng and n not in (
                    "Dropout", "RNN", "LeakyReLU", "_sample_unique_zipfian",
                    # graph ops: the generator goes to their bodies' ops
                    "_foreach", "_while_loop", "_cond", "_subgraph_op")
                and not n.startswith("_image_")}
    called = {treg.get_op(c).name for c in CALLS if c in treg.list_ops()}
    assert {treg.get_op(n).name for n in samplers} <= called


def test_seed_gives_bit_equal_reruns():
    def draws():
        return [mt.nd.random.normal(0, 1, shape=(100,)).asnumpy(),
                mt.nd.random.gamma(2.0, 1.0, shape=(50,)).asnumpy(),
                mt.nd.random.poisson(3.0, shape=(50,)).asnumpy(),
                mt.nd.random.shuffle(mt.nd.arange(20)).asnumpy(),
                mt.nd.random.multinomial(mt.nd.array(_PR), shape=7)
                .asnumpy()]
    mt.random.seed(42)
    a = draws()
    mt.random.seed(42)
    b = draws()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = draws()
    assert not np.array_equal(a[0], c[0])


def test_shuffle_is_a_permutation_of_rows():
    mt.random.seed(16)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    firsts = []
    for _ in range(300):
        y = mt.nd.random.shuffle(mt.nd.array(x)).asnumpy()
        assert sorted(map(tuple, y)) == sorted(map(tuple, x))
        firsts.append(int(y[0, 0]) // 4)
    freq = np.bincount(firsts, minlength=6) / len(firsts)
    assert freq.max() < 0.35


def test_multinomial_get_prob_gradient_matches_reference_rule():
    probs_np = np.array([[0.1, 0.2, 0.3, 0.4],
                         [0.4, 0.3, 0.2, 0.1]], np.float32)
    mt.random.seed(5)
    s, lp = mt.nd.random.multinomial(mt.nd.array(probs_np), shape=(3, 4),
                                     get_prob=True)
    assert s.shape == lp.shape == (2, 3, 4)
    assert s.dtype == mt.nd.array(np.zeros(1), dtype="int32").dtype
    s_np, lp_np = s.asnumpy().astype(int), lp.asnumpy()
    for r in range(2):
        np.testing.assert_allclose(lp_np[r], np.log(probs_np[r][s_np[r]]),
                                   rtol=1e-6)
    probs = mt.nd.array(probs_np)
    probs.attach_grad()
    with mt.autograd.record():
        s2, lp2 = mt.nd.random.multinomial(probs, shape=100, get_prob=True)
        lp2.sum().backward()
    g = probs.grad.asnumpy()
    assert np.isfinite(g).all()
    s2_np = s2.asnumpy().astype(int)
    for r in range(2):
        counts = np.bincount(s2_np[r], minlength=4)
        np.testing.assert_allclose(g[r], counts / probs_np[r], rtol=1e-6)


def test_sym_random_and_module_delegates():
    s = mt.sym.random.normal(0.0, 1.0, shape=(3, 4))
    assert s.bind(CPU, args={}, grad_req="null").forward()[0].shape == (3, 4)
    e = mt.sym.random.exponential(2.0, shape=(5,))
    out = e.bind(CPU, args={}, grad_req="null").forward()[0].asnumpy()
    assert out.shape == (5,) and (out >= 0).all()
    r = mt.sym.random.randn(2, 3)
    assert r.bind(CPU, args={}, grad_req="null").forward()[0].shape == (2, 3)
    assert mt.random.uniform(0, 1, (2, 2)).shape == (2, 2)
    assert mt.rnd.normal(0, 1, (2, 2)).shape == (2, 2)
    assert mt.random.randn(4, 5).shape == (4, 5)
    assert mt.random.shuffle(mt.nd.arange(4)).shape == (4,)
    m = mt.nd.random.multinomial(mt.nd.array([0.0, 1.0]), shape=8)
    np.testing.assert_array_equal(m.asnumpy(), np.ones(8))
    assert sorted(set(mx.nd.random.__all__)) == sorted(
        set(mt.nd.random.__all__))


def test_randint_keeps_a_64_bit_dtype():
    """``dtype='int64'`` stays int64 (the JAX package narrows it to int32
    without x64)."""
    out = mt.nd.random.randint(0, 5, shape=(6,), dtype="int64").asnumpy()
    assert out.dtype == np.int64 and out.min() >= 0 and out.max() < 5


def test_invalid_parameters_raise():
    # the error is deferred to where the values are read, as MXNet's
    with pytest.raises(mt.MXNetError, match="scale"):
        mt.nd.random.normal(0, -1.0, shape=(2,)).asnumpy()
    with pytest.raises(mt.MXNetError, match="alpha and beta"):
        mt.nd.random.gamma(-1.0, 1.0, shape=(2,)).asnumpy()
    with pytest.raises(mt.MXNetError, match="negative_binomial"):
        mt.nd.random.negative_binomial(2, 1.5, shape=(2,)).asnumpy()
