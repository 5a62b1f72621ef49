"""The port's SPMD plane (`mxnet_tpu_torch.parallel`) against the JAX
package's (`tests/test_parallel.py`): meshes, `SPMDTrainer`, ring and
Ulysses attention, `allreduce_mean`, `pure_rule`, the parameter rule and
the heartbeat failure detector.

The multi-rank cases run once, as four gloo ranks
(`torch_spmd_worker.suite_parallel`: dp x tp = 2 x 2 training, dp = 4
against one device, sp = 4 attention), and are held against the JAX
package on four of this process's virtual devices with the same seeded
weights and batches: `SPMDTrainer` against one device within the
reference's 2e-4 / 2e-5, ring and Ulysses attention within 2e-5.  The
one-rank cases run here, on a mesh of this process's CPU.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jgloss

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.parallel.mesh import RankDevice
from mxnet_tpu_torch.serialization import block_params_from_numpy

from torch_spmd_launch import run_suite
import torch_spmd_worker as W

N = 4
CPU = mt.cpu()


@pytest.fixture(scope="module")
def ranks():
    return run_suite("parallel", N)


def _jdev():
    return jax.devices()[:N]


def _fake(n):
    """n members (rank ids) of a mesh built on one process: enough for
    the shape logic, no collective runs."""
    return [RankDevice(i, torch.device("cpu")) for i in range(n)]


def _jtrainer(weights, prefix, opt, mesh, **kw):
    net = W.gluon_mlp(mx, weights, prefix=prefix)
    return jpar.SPMDTrainer(net, opt, jgloss.SoftmaxCrossEntropyLoss(),
                            mesh=mesh, **kw)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_mesh_factorize():
    for n, k in ((8, 3), (12, 2), (1, 2), (8, 2)):
        assert par.factorize(n, k) == jpar.factorize(n, k)
    assert np.prod(par.factorize(8, 3)) == 8


def test_auto_mesh_axes():
    mesh = par.auto_mesh(8, tp=2, sp=2, devices=_fake(8))
    ref = jpar.auto_mesh(8, tp=2, sp=2)
    assert dict(mesh.shape) == dict(ref.shape)
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.coords == (0, 0, 0, 0, 0)


def test_param_rule_shards_large_dims():
    mesh = par.auto_mesh(8, tp=2, devices=_fake(8))
    jmesh = jpar.auto_mesh(8, tp=2)
    for name, shape in (("dense0_weight", (128, 64)), ("bias", (128,)),
                        ("w", (4, 64)), ("tiny", (6, 6))):
        got = par.default_param_rule(name, shape, mesh)
        want = jpar.default_param_rule(name, shape, jmesh)
        assert tuple(got) == tuple(want), name
    assert tuple(par.default_param_rule("dense0_weight", (128, 64), mesh)) \
        == ("tp", None)


# ---------------------------------------------------------------------------
# SPMDTrainer over ranks
# ---------------------------------------------------------------------------

def test_spmd_trainer_loss_decreases(ranks):
    """dp x tp = 2 x 2: the losses fall, and follow the JAX package's
    trainer on the same mesh shape step for step."""
    jtr = _jtrainer(W.mlp_weights(20, 0), "mlp_",
                    mx.optimizer.SGD(learning_rate=0.2, momentum=0.9),
                    jpar.auto_mesh(N, tp=2, devices=_jdev()))
    x, y = W.trainer_data(10, 32, 20)
    ref = [float(jtr.step(x, y)) for _ in range(5)]
    for res in ranks:
        losses = res["tp_losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] - 0.05
        np.testing.assert_allclose(losses[:5], ref, rtol=1e-4)
        np.testing.assert_array_equal(losses, ranks[0]["tp_losses"])


def test_spmd_trainer_matches_single_device_sgd(ranks):
    """dp = 4 equals one device's SGD step on the whole batch (the JAX
    package's autograd oracle) within the reference's 2e-4 / 2e-5."""
    w0 = W.mlp_weights(12, 1)
    x, y = W.trainer_data(11, 16, 12)
    net = W.gluon_mlp(mx, w0, prefix="sgd_")
    with mx.autograd.record():
        l = jgloss.SoftmaxCrossEntropyLoss()(net(mx.nd.array(x)),
                                             mx.nd.array(y)).mean()
    l.backward()
    for res in ranks:
        for k, p in net.collect_params().items():
            want = p.data().asnumpy() - 0.05 * p.data().grad.asnumpy()
            np.testing.assert_allclose(res[f"sgd_{k}"], want, rtol=2e-4,
                                       atol=2e-5, err_msg=k)
        np.testing.assert_allclose(res["sgd_loss"], float(l.asnumpy()),
                                   rtol=1e-5)


def test_spmd_trainer_step_many_matches_per_step(ranks):
    """K steps through `step_many` land where K `step` calls do; placed
    inputs pass through; the flop count is per step either way."""
    jtr = _jtrainer(W.mlp_weights(12, 3), "many_",
                    mx.optimizer.SGD(learning_rate=0.05, momentum=0.9),
                    jpar.auto_mesh(N, devices=_jdev()))
    xk, yk = W.trainer_data(13, 8, 12, k=4)
    ref = np.asarray(jax.device_get(jtr.step_many(xk, yk)))
    for res in ranks:
        np.testing.assert_allclose(res["many_losses"],
                                   res["single_losses"], rtol=1e-5)
        np.testing.assert_allclose(res["many_losses"], ref, rtol=1e-4)
        assert int(res["many_num_update"]) == 4
        for k in [k for k in res if k.startswith("many_w_")]:
            np.testing.assert_allclose(
                res[k], res["single_w_" + k[len("many_w_"):]], rtol=1e-5,
                atol=1e-6)
        assert np.isfinite(res["placed_losses"]).all()
        f_many, f_single = float(res["many_flops"]), \
            float(res["single_flops"])
        assert f_many > 0 and abs(f_many - f_single) / f_single < 0.05


def test_spmd_trainer_adam_runs(ranks):
    jtr = _jtrainer(W.mlp_weights(6, 4), "adam_",
                    mx.optimizer.Adam(learning_rate=0.01),
                    jpar.auto_mesh(N, tp=2, devices=_jdev()))
    x, y = W.trainer_data(14, 8, 6)
    ref = [float(jtr.step(x, y)) for _ in range(2)]
    for res in ranks:
        assert np.isfinite(res["adam_losses"]).all()
        np.testing.assert_allclose(res["adam_losses"], ref, rtol=1e-4)


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_local(ranks, causal):
    """Ring attention over sp = 4 (each hop's block K1's plain version,
    or the plain per-block softmax with MXTPU_RING_FLASH=0) against the
    JAX package's ring and one device's attention within 2e-5; the
    gradients of q, k and v (through the hops' merge, so K1's lse takes a
    cotangent) against ``jax.grad`` of the JAX package's one-device
    attention."""
    q, k, v, w = W.attention_inputs(2, (2, 4, 64, 16))
    jmesh = jpar.make_mesh({"sp": N}, devices=_jdev())
    out = np.asarray(jpar.ring_attention(q, k, v, jmesh, causal=causal))

    def jlocal(a, b, c):
        return jpar.local_attention(a, b, c, causal=causal)

    grads = jax.grad(lambda a, b, c: (jlocal(a, b, c) * w).sum(),
                     argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    local = np.asarray(jlocal(q, k, v))
    for res in ranks:
        for flash in ("1", "0"):
            tag = f"ring_{int(causal)}_{flash}"
            np.testing.assert_allclose(res[tag], out, rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(res[tag], local, rtol=2e-5,
                                       atol=2e-5)
            for name, g in zip("qkv", grads):
                np.testing.assert_allclose(res[f"{tag}_d{name}"],
                                           np.asarray(g), rtol=2e-5,
                                           atol=2e-5, err_msg=tag + name)


def test_ulysses_attention_matches_local(ranks):
    q, k, v, _w = W.attention_inputs(3, (2, 8, 64, 8))
    jmesh = jpar.make_mesh({"sp": N}, devices=_jdev())
    out = np.asarray(jpar.ulysses_attention(q, k, v, jmesh, causal=True))
    for res in ranks:
        np.testing.assert_allclose(res["ulysses"], out, rtol=2e-5,
                                   atol=2e-5)


def _jax_ring_lm(params, tokens, targets, heads):
    """`example/long_context/train_ring_lm.py`'s forward and loss on one
    device (its attention the JAX package's `local_attention`)."""
    b, seq_len = tokens.shape
    dim = params["emb"].shape[1]
    hd = dim // heads

    def ln(x):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) * jax.lax.rsqrt(var + 1e-6)

    x = params["emb"][tokens] + params["pos"][None]
    q, k, v = jnp.split(ln(x) @ params["wqkv"], 3, axis=-1)

    def split_heads(t):
        return t.reshape(b, seq_len, heads, hd).transpose(0, 2, 1, 3)

    o = jpar.local_attention(split_heads(q), split_heads(k),
                             split_heads(v), causal=True)
    x = x + o.transpose(0, 2, 1, 3).reshape(b, seq_len, dim) @ params["wo"]
    x = x + jax.nn.relu(ln(x) @ params["wff"])
    logits = ln(x) @ params["wout"]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)
    return nll[:, 1:, 0].mean(), logits


def test_ring_lm_matches_the_example(ranks):
    """The ring LM (`model_zoo.ring_lm`) over sp = 4 against the JAX
    example's model on one device, same weights and needle batch: the
    loss, the logits and every parameter's gradient."""
    p_np, tok, tgt = W.ring_lm_inputs()
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}

    def lossf(p):
        return _jax_ring_lm(p, jnp.asarray(tok), jnp.asarray(tgt),
                            W.RING_LM["heads"])

    (loss, logits), grads = jax.value_and_grad(lossf, has_aux=True)(jp)
    for res in ranks:
        np.testing.assert_allclose(res["ring_lm_loss"], float(loss),
                                   rtol=2e-5)
        np.testing.assert_allclose(res["ring_lm_logits"],
                                   np.asarray(logits), rtol=2e-4, atol=2e-4)
        for k, g in grads.items():
            g = np.asarray(g)
            err = np.abs(res[f"ring_lm_d{k}"] - g).max()
            assert err <= 2e-4 * max(np.abs(g).max(), 1e-30), k


def test_allreduce_mean(ranks):
    x = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    for res in ranks:
        np.testing.assert_allclose(res["allreduce_mean"], x.mean(0),
                                   rtol=1e-6)


def test_ring_attention_on_one_rank_is_local_attention():
    q, k, v, _w = W.attention_inputs(4, (1, 2, 32, 16))
    with CPU:
        mesh = par.make_mesh({"sp": 1})
        qt, kt, vt = (torch.tensor(a) for a in (q, k, v))
        for causal in (False, True):
            got = par.ring_attention(qt, kt, vt, mesh, causal=causal)
            want = par.local_attention(qt, kt, vt, causal=causal)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the pure update rules
# ---------------------------------------------------------------------------

_OPTS = [
    ("SGD", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("Adam", dict(learning_rate=0.01, wd=1e-3)),
    ("AdaGrad", dict(learning_rate=0.1, wd=1e-3)),
    ("Signum", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("Signum", dict(learning_rate=0.1, momentum=0.0, wd=1e-3)),
    ("RMSProp", dict(learning_rate=0.01, wd=1e-3)),
    ("RMSProp", dict(learning_rate=0.01, centered=True)),
    ("NAG", dict(learning_rate=0.1, momentum=0.9)),
]


@pytest.mark.parametrize("name,kw", _OPTS)
def test_pure_rule_matches_imperative_ops(name, kw):
    """pure_rule equals the port's update ops step for step, and the JAX
    package's pure_rule on the same inputs."""
    rs = np.random.RandomState(7)
    w_np = rs.randn(5, 4).astype(np.float32)
    grads = [rs.randn(5, 4).astype(np.float32) for _ in range(3)]
    opt_imp = getattr(mt.optimizer, name)(**kw)
    w_imp = mt.nd.array(w_np, ctx=CPU)
    state_imp = opt_imp.create_state(0, w_imp)
    opt = getattr(mt.optimizer, name)(**kw)
    init_fn, update_fn = par.pure_rule(opt)
    w = torch.tensor(w_np)
    state = init_fn("w", w)
    jopt = getattr(mx.optimizer, name)(**kw)
    jinit, jupdate = jpar.pure_rule(jopt)
    jw = jnp.asarray(w_np)
    jstate = jinit("w", jw)
    for t, g in enumerate(grads, 1):
        opt_imp.update(0, w_imp, mt.nd.array(g, ctx=CPU), state_imp)
        w, state = update_fn(w, torch.tensor(g), state,
                             torch.tensor(t, dtype=torch.int32),
                             float(np.float32(opt.lr)),
                             float(np.float32(opt.wd)))
        jw, jstate = jupdate(jw, jnp.asarray(g), jstate,
                             jnp.asarray(t, jnp.int32),
                             np.float32(jopt.lr), np.float32(jopt.wd))
        np.testing.assert_allclose(w.numpy(), w_imp.asnumpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# one rank: mixed precision
# ---------------------------------------------------------------------------

def _bn_net(pkg, ctx=None):
    nn = pkg.gluon.nn
    net = nn.HybridSequential(prefix="bf_")
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Flatten(),
                nn.Dense(4))
    kw = {"ctx": ctx} if ctx is not None else {}
    net.initialize(**kw)
    net(pkg.nd.zeros((2, 3, 8, 8), **kw))
    return net


def test_spmd_trainer_bf16_mixed_precision():
    """bf16 forward and backward, fp32 master weights, optimizer state
    and aux; the loss converges, and its first step follows the JAX
    package's from the same weights within bf16's precision."""
    rs = np.random.RandomState(1)
    X = rs.randn(16, 3, 8, 8).astype(np.float32)
    X[:, 0] += np.arange(16).reshape(-1, 1, 1) % 4
    Y = (np.arange(16) % 4).astype(np.float32)
    jnet = _bn_net(mx)
    with CPU:
        net = block_params_from_numpy(_bn_net(mt, ctx=CPU), {
            k: p.data().asnumpy() for k, p in jnet.collect_params().items()})
        tr = par.SPMDTrainer(net, mt.optimizer.SGD(learning_rate=0.1),
                             gloss.SoftmaxCrossEntropyLoss(),
                             compute_dtype="bfloat16")
        l0 = float(tr.step(X, Y))
        for _ in range(80):
            last = float(tr.step(X, Y))
    jtr = jpar.SPMDTrainer(jnet, mx.optimizer.SGD(learning_rate=0.1),
                           jgloss.SoftmaxCrossEntropyLoss(),
                           mesh=jpar.auto_mesh(1, devices=jax.devices()[:1]),
                           compute_dtype="bfloat16")
    jl0 = float(np.asarray(jtr.step(X, Y)))
    assert last < l0 * 0.6, (l0, last)
    assert abs(l0 - jl0) < 2e-2 * abs(jl0)
    assert all(p.dtype == torch.float32 for p in tr.params.values())
    assert all(a.dtype == torch.float32 for a in tr.aux.values())


def test_spmd_trainer_fp16_dynamic_loss_scaling():
    """fp16: the loss scale engages, an overflow step is skipped (the
    scale halves, the weights stay), clean steps converge."""
    rs = np.random.RandomState(4)
    with CPU:
        net = W.gluon_mlp(mt, W.mlp_weights(10, 5), prefix="fp16_",
                          ctx=CPU)
        tr = par.SPMDTrainer(net, mt.optimizer.SGD(learning_rate=0.5),
                             gloss.SoftmaxCrossEntropyLoss(),
                             compute_dtype="float16")
        assert tr.loss_scale == 2.0 ** 15
        data = rs.randn(16, 10).astype(np.float32)
        label = rs.randint(0, 10, (16,)).astype(np.float32)
        losses = [float(tr.step(data, label)) for _ in range(25)]
        assert all(np.isfinite(l) for l in losses)
        assert losses[-1] < losses[0]
        w_before = {k: np.asarray(v).copy() for k, v in tr.params.items()}
        scale_before = tr.loss_scale
        tr.step(np.full((16, 10), 1e30, np.float32), label)
        assert tr.loss_scale == scale_before / 2
        for k, v in tr.params.items():
            np.testing.assert_array_equal(np.asarray(v), w_before[k])
        assert np.isfinite(float(tr.step(data, label)))


# ---------------------------------------------------------------------------
# the heartbeat failure detector (plain Python, the port's own copy)
# ---------------------------------------------------------------------------

def test_failure_detector_heartbeat():
    from mxnet_tpu_torch.parallel.failure import (HeartbeatClient,
                                                  HeartbeatMonitor)
    mon = HeartbeatMonitor(port=0, timeout=1.0)
    seen = []
    mon.on_failure(lambda r: seen.extend(r))
    c0 = HeartbeatClient("127.0.0.1", mon.port, rank=0, interval=0.2)
    c1 = HeartbeatClient("127.0.0.1", mon.port, rank=1, interval=0.2)
    try:
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and len(mon.alive_ranks()) < 2:
            time.sleep(0.05)
        assert mon.alive_ranks() == [0, 1]
        c1.close()
        deadline = time.monotonic() + 6.0
        while time.monotonic() < deadline and not seen:
            time.sleep(0.1)
        assert mon.dead_ranks() == [1] and 0 in mon.alive_ranks()
        assert seen == [1]
    finally:
        c0.close()
        c1.close()
        mon.close()


def test_start_failure_detector_single_process(monkeypatch):
    monkeypatch.setenv("MXTPU_HEARTBEAT_PORT", "0")
    mon, client = par.start_failure_detector(timeout=2.0, interval=0.2)
    try:
        assert mon is not None
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not mon.alive_ranks():
            time.sleep(0.05)
        assert mon.alive_ranks() == [0]
    finally:
        client.close()
        mon.close()


def test_failure_detector_never_pinged_rank():
    from mxnet_tpu_torch.parallel.failure import (HeartbeatClient,
                                                  HeartbeatMonitor)
    mon = HeartbeatMonitor(port=0, timeout=0.5, expected=2,
                           startup_grace=1.0)
    c0 = HeartbeatClient("127.0.0.1", mon.port, rank=0, interval=0.1)
    try:
        deadline = time.monotonic() + 6.0
        while time.monotonic() < deadline and 1 not in mon.dead_ranks():
            time.sleep(0.1)
        assert 1 in mon.dead_ranks() and 0 in mon.alive_ranks()
    finally:
        c0.close()
        mon.close()


def test_failure_detector_callback_exception_survives():
    from mxnet_tpu_torch.parallel.failure import HeartbeatMonitor
    mon = HeartbeatMonitor(port=0, timeout=0.5, expected=3,
                           startup_grace=0.5)
    calls = []

    def bad(r):
        calls.append(tuple(r))
        raise RuntimeError("boom")

    mon.on_failure(bad)
    try:
        deadline = time.monotonic() + 6.0
        while time.monotonic() < deadline and len(mon._reported) < 3:
            time.sleep(0.1)
        assert mon._reported == {0, 1, 2} and calls
    finally:
        mon.close()


def test_timing_helpers():
    """`bounded_cost_flops` reads the trainer's per-step flop count (the
    JAX package's `timing` contract: None before a step); the slope fit
    of `fit_steps_per_sec` cancels a constant sync cost."""
    from mxnet_tpu_torch.parallel import timing
    with CPU:
        net = W.gluon_mlp(mt, W.mlp_weights(12, 6), prefix="tm_", ctx=CPU)
        tr = par.SPMDTrainer(net, mt.optimizer.SGD(learning_rate=0.1),
                             gloss.SoftmaxCrossEntropyLoss())
        assert timing.bounded_cost_flops(tr) is None
        x, y = W.trainer_data(15, 8, 12)
        tr.step(x, y)
        flops = timing.bounded_cost_flops(tr)
    # the three dense layers' forward and weight gradients, and the
    # input gradients of the two above the first (2 flops a MAC, 8 rows)
    macs = 12 * 32 + 32 * 16 + 16 * 10
    assert flops == 2 * 8 * (2 * macs + macs - 12 * 32)
    clock = {"t": 0.0}

    def dispatch():
        clock["t"] += 0.01          # 10 ms a dispatch

    def sync(_out):
        clock["t"] += 0.5           # a constant sync cost

    real = time.perf_counter
    time.perf_counter = lambda: clock["t"]
    try:
        rate, info = timing.fit_steps_per_sec(dispatch, sync, 4, 2, 10)
    finally:
        time.perf_counter = real
    assert info["method"] == "slope"
    assert rate == pytest.approx(400.0)


def test_global_mesh_is_the_group():
    with CPU:
        mesh = par.distributed.global_mesh()
    assert mesh.size == 1 and dict(mesh.shape)["dp"] == 1


def test_mesh_without_a_card_or_scope_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(mt.base.MXNetError, match="CUDA"):
        par.auto_mesh()
