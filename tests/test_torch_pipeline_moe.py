"""pp (the GPipe pipeline) and ep (the Switch MoE) of the port
(`mxnet_tpu_torch.parallel.pipeline`, `.moe`) against the JAX package's
(`tests/test_pipeline_moe.py`).

Four gloo ranks run the multi-rank cases once (`torch_spmd_worker.
suite_pipeline_moe`: pp = 2 with dp = 2, pp = 4, ep = 4); the JAX package
runs them on four of this process's virtual devices, and both are held
against the sequential oracles with the same seeded weights.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from mxnet_tpu import parallel as jpar

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.parallel.mesh import RankDevice

from torch_spmd_launch import run_suite
import torch_spmd_worker as W

N = 4


@pytest.fixture(scope="module")
def ranks():
    return run_suite("pipeline_moe", N)


def _jfn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jstages(stages):
    return [{k: jnp.asarray(v) for k, v in st.items()} for st in stages]


def _seq(stages, x):
    ref = jnp.asarray(x)
    for p in _jstages(stages):
        ref = _jfn(p, ref)
    return np.asarray(ref)


@pytest.mark.parametrize("s,k", [(2, 4), (4, 8)])
def test_pipeline_matches_sequential(ranks, s, k):
    stages = W.stage_weights(0, s, 6)
    x = np.random.RandomState(1).randn(k, 3, 6).astype(np.float32)
    jmesh = jpar.auto_mesh(N, pp=s, devices=jax.devices()[:N])
    jout = np.asarray(jpar.pipeline_apply(
        _jfn, jpar.stack_stage_params(_jstages(stages)), jnp.asarray(x),
        jmesh))
    ref = _seq(stages, x)
    for res in ranks:
        np.testing.assert_allclose(res[f"pipe_{s}_{k}"], ref, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res[f"pipe_{s}_{k}"], jout, rtol=1e-5,
                                   atol=1e-6)


def test_pipeline_backward_matches_sequential(ranks):
    """Autograd through the hops is the pipelined backward: the stacked
    stage gradients equal the sequential net's (and the JAX package's
    ``jax.grad`` of its sequential oracle)."""
    stages = W.stage_weights(1, 2, 5)
    x = jnp.asarray(np.random.RandomState(2).randn(6, 2, 5)
                    .astype(np.float32))

    def seq_loss(st):
        ref = x
        for p in st:
            ref = _jfn(p, ref)
        return (ref * ref).mean()

    g = jpar.stack_stage_params(jax.grad(seq_loss)(_jstages(stages)))
    for res in ranks:
        np.testing.assert_allclose(res["pipe_dw"], np.asarray(g["w"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["pipe_db"], np.asarray(g["b"]),
                                   rtol=1e-4, atol=1e-5)


def test_pipeline_composes_with_dp(ranks):
    """io_spec P(None, 'dp'): each dp group pipelines its own rows."""
    stages = W.stage_weights(4, 2, 5)
    x = np.random.RandomState(5).randn(4, 4, 5).astype(np.float32)
    jmesh = jpar.auto_mesh(N, pp=2, devices=jax.devices()[:N])
    jout = np.asarray(jpar.pipeline_apply(
        _jfn, jpar.stack_stage_params(_jstages(stages)), jnp.asarray(x),
        jmesh, io_spec=JP(None, "dp")))
    for res in ranks:
        np.testing.assert_allclose(res["pipe_dp"], _seq(stages, x),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(res["pipe_dp"], jout, rtol=1e-5,
                                   atol=1e-6)


def test_pipeline_needs_enough_microbatches():
    mesh = par.auto_mesh(4, pp=4, devices=[
        RankDevice(i, torch.device("cpu")) for i in range(4)])
    stages = par.stack_stage_params([
        {k: torch.tensor(v) for k, v in st.items()}
        for st in W.stage_weights(0, 4, 4)])
    with pytest.raises(ValueError, match="microbatches"):
        par.pipeline_apply(lambda p, a: a, stages, torch.zeros(2, 2, 4),
                           mesh)


def _moe_params(pkg_params, weights, mesh=None):
    router, w_in, w_out = weights
    return pkg_params(router, w_in, w_out)


def _moe_oracle(weights, x, cap):
    """Sequential per-token Switch with FIFO capacity, in float64."""
    router, w_in, w_out = (np.asarray(a, np.float64) for a in weights)
    x = np.asarray(x, np.float64)
    logits = x @ router
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    counts = np.zeros(router.shape[1], int)
    y = np.zeros_like(x)
    for t in range(x.shape[0]):
        ei = int(gates[t].argmax())
        if counts[ei] < cap:
            counts[ei] += 1
            h = np.asarray(jax.nn.gelu(x[t] @ w_in[ei]))
            y[t] = gates[t, ei] * (h @ w_out[ei])
    return y


@pytest.mark.parametrize("with_mesh", [False, True])
def test_moe_matches_dense_oracle(ranks, with_mesh):
    """Top-1 Switch MoE (experts over ep = 4 with the mesh) against the
    sequential oracle and the JAX package's `moe_ffn`, values and (with
    the mesh) the gradients of the three weights."""
    weights = W.moe_weights(0, 8, 16, 4)
    x = np.random.RandomState(2).randn(32, 8).astype(np.float32)
    cap = int(-(-32 * 1.25 // 4))
    jp = jpar.MoEParams(*(jnp.asarray(a) for a in weights))
    jy, jaux = jpar.moe_ffn(jp, jnp.asarray(x), capacity_factor=1.25)
    oracle = _moe_oracle(weights, x, cap)
    if not with_mesh:
        p = par.MoEParams(*(torch.tensor(a) for a in weights))
        y, aux = par.moe_ffn(p, torch.tensor(x), capacity_factor=1.25)
        got = [(y.numpy(), float(aux["dropped_frac"]),
                float(aux["aux_loss"]))]
    else:
        got = [(r["moe_y"], float(r["moe_dropped"]), float(r["moe_aux"]))
               for r in ranks]
        jg = jax.grad(lambda q: (jpar.moe_ffn(q, jnp.asarray(x))[0] ** 2)
                      .sum())(jp)
        for r in ranks:
            for name, g in zip(("router", "w_in", "w_out"), jg):
                np.testing.assert_allclose(r[f"moe_d{name}"], np.asarray(g),
                                           rtol=1e-4, atol=1e-5)
    for y, dropped, aux_loss in got:
        np.testing.assert_allclose(y, oracle, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(y, np.asarray(jy), rtol=1e-5, atol=1e-6)
        assert 0.0 <= dropped < 0.5
        assert dropped == pytest.approx(float(jaux["dropped_frac"]))
        assert aux_loss == pytest.approx(float(jaux["aux_loss"]), rel=1e-5)


def test_moe_capacity_drops_tokens():
    """Past capacity, tokens come back as exact zeros."""
    rs = np.random.RandomState(3)
    t, d, h, e = 16, 4, 8, 2
    p = par.init_moe(1, d, h, e)
    p = p._replace(router=torch.tensor(np.stack(
        [np.full(d, 5.0), np.full(d, -5.0)], 1).astype(np.float32)))
    x = torch.tensor(np.abs(rs.randn(t, d)).astype(np.float32) + 0.1)
    y, aux = par.moe_ffn(p, x, capacity_factor=0.5)
    cap = int(-(-t * 0.5 // e))
    zeros = np.count_nonzero(~np.any(y.numpy() != 0, axis=1))
    assert zeros == t - cap
    np.testing.assert_allclose(float(aux["dropped_frac"]), (t - cap) / t,
                               rtol=1e-6)


def test_moe_bf16_stays_bf16():
    p = par.init_moe(3, 4, 8, 2, dtype=torch.bfloat16)
    y, _ = par.moe_ffn(p, torch.ones(8, 4, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16


def test_moe_expert_sharding_placement():
    """The expert axis of w_in and w_out goes on ep, the router stays
    replicated, as in the JAX package; `init_moe` places on the mesh's
    device."""
    mesh = par.auto_mesh(8, ep=2, devices=[
        RankDevice(i, torch.device("cpu")) for i in range(8)])
    router, w_in, w_out = par.expert_sharding(mesh)
    jmesh = jpar.auto_mesh(8, ep=2)
    jr, ji, jo = jpar.expert_sharding(jmesh)
    assert tuple(router.spec) == tuple(jr.spec)
    assert tuple(w_in.spec) == tuple(ji.spec) and w_in.spec[0] == "ep"
    assert tuple(w_out.spec) == tuple(jo.spec)
    assert w_in.shard_shape((2, 4, 8)) == (1, 4, 8)
    with mt.cpu():
        p = par.init_moe(2, 4, 8, 2, mesh=par.auto_mesh(1))
    assert p.w_in.device.type == "cpu"
