"""The port's named collectives (`mxnet_tpu_torch.parallel.collectives`)
against the JAX package's (`tests/test_collectives.py`).

Four gloo ranks run the checks once (`torch_spmd_worker.suite_
collectives`); the JAX package runs the same bodies in this process over
four of its virtual devices.  The reference's bitwise contracts hold
within the port: ``reduce_scatter``'s block r is block r of ``psum`` bit
for bit, and ``all_gather(reduce_scatter(x)) == psum(x)`` on every rank.
Each verb's backward is held against ``jax.grad`` of the same program.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from mxnet_tpu.parallel import collectives as JC
from mxnet_tpu.parallel.mesh import DP, make_mesh

from torch_spmd_launch import run_suite
import torch_spmd_worker as W
from mxnet_tpu_torch.parallel import collectives as C

N = 4


@pytest.fixture(scope="module")
def ranks():
    return run_suite("collectives", N)


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh({DP: N}, devices=jax.devices()[:N])


def _jrun(jmesh, body, x):
    x = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, JP(DP)))
    return np.asarray(JC.shard_map(body, mesh=jmesh, in_specs=(JP(DP),),
                                   out_specs=JP(DP))(x))


def test_shard_map_is_callable():
    assert callable(C.shard_map) and callable(JC.shard_map)


def test_reduce_scatter_shard_is_bitwise_psum_slice(ranks):
    for res in ranks:
        assert res["rs_bitwise"].all()


def test_all_gather_round_trips_reduce_scatter(ranks, jmesh):
    x = np.random.RandomState(1).randn(N, 40).astype(np.float32)
    ref = _jrun(jmesh, lambda xs: JC.all_gather(
        JC.reduce_scatter(xs[0], DP), DP)[None], x)
    for res in ranks:
        got = res["ag_rs"]
        for r in range(N):
            assert np.array_equal(got[r], res["psum"][r])
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[0], x.sum(0, dtype=np.float64),
                                   rtol=1e-5)


def test_reduce_scatter_sums_across_replicas(ranks, jmesh):
    x = np.arange(N * 24, dtype=np.float32).reshape(N, 24)
    ref = _jrun(jmesh, lambda xs: JC.reduce_scatter(xs[0], DP)[None], x)
    shard = 24 // N
    full = x.sum(0)
    for res in ranks:
        np.testing.assert_array_equal(res["rs_vals"], ref)
        for r in range(N):
            np.testing.assert_array_equal(
                res["rs_vals"][r], full[r * shard:(r + 1) * shard])


def test_all_gather_tiled_concatenates_in_rank_order(ranks):
    want = np.repeat(np.arange(N, dtype=np.int32), 3)
    for res in ranks:
        for r in range(N):
            assert np.array_equal(res["ag_order"][r], want)


def test_allreduce_mean_eager_entry(ranks, jmesh):
    x = np.random.RandomState(2).randn(N, 5, 3).astype(np.float32)
    ref = np.asarray(JC.allreduce_mean(jnp.asarray(x), jmesh))
    for res in ranks:
        np.testing.assert_allclose(res["mean"], x.mean(0), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(res["mean"], ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("verb", ["psum", "all_gather", "reduce_scatter",
                                  "ppermute", "all_to_all"])
def test_verb_value_and_transpose_match_jax(ranks, jmesh, verb):
    """Each verb's value, and its gradient (the transposed verb), equal
    the JAX package's ``lax`` verb under ``jax.grad`` of one program."""
    x, w = W.collective_grad_inputs(N)
    body = W.collective_bodies(JC, DP, N)[verb]
    spec = JP(DP)
    sm = JC.shard_map(body, mesh=jmesh, in_specs=(spec,), out_specs=spec)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec))
    out = np.asarray(sm(xs))
    grad = np.asarray(jax.grad(lambda a: (sm(a) * w).sum())(xs))
    for res in ranks:
        np.testing.assert_allclose(res[f"verb_{verb}"], out, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(res[f"grad_{verb}"], grad, rtol=1e-5,
                                   atol=1e-5)
