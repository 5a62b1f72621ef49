"""The elastic mesh of the port (`mxnet_tpu_torch.parallel.elastic_mesh`,
the buddy redundancy and `recover_lost` of the sharded step,
`TrainingSupervisor.on_mesh_degraded`) against `tests/test_elastic_mesh.py`.

The reference's 12 cases, with 8 -> 7 devices replaced by 4 -> 3 gloo
ranks: one launch (`torch_spmd_launch.run_ranks`) of WORLD ranks of
`tests/torch_elastic_worker.py` runs every multi-rank case, each loss on
a victim rank of its own that really exits or stops at its probe.

Four reference cases pass under the installed jax (a kill surfacing at
once, a banned device never adopted again, the policy parsing and the
error's shape, the heartbeat's forgiveness path): the port is held
against the JAX package's records of them.  The other eight fail there,
so the port is held against the spec the JAX package's change log
writes for them: a stopped rank detected within the watchdog bound with a
census; the probe before any mutation (``num_update`` unchanged); a
shrink 4 -> 3 with the buddy copy and with the disk checkpoint, each
bit-equal to a fresh n' = 3 fit resumed from the same state; ``preempt``
stopping with a committed checkpoint; the kill switch bit-equal with the
plan never consulted; buddy redundancy bit-neutral at a 2/N state gauge.
"""
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import fault_injection as jfi
from mxnet_tpu.parallel import elastic_mesh as jem

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.parallel import elastic_mesh as em
from mxnet_tpu_torch.parallel.failure import HeartbeatMonitor

from torch_spmd_launch import run_ranks
import torch_elastic_worker as W

NAMES = ("MXTPU_MESH_ELASTIC", "MXTPU_MESH_STEP_TIMEOUT_S",
         "MXTPU_MESH_ON_LOSS", "MXTPU_SPMD_SHARD_REDUNDANCY")


@pytest.fixture(scope="module")
def ranks():
    return run_ranks("torch_elastic_worker.py", "elastic", W.GROUPS,
                     timeout=300)


def _results(ranks, group, survivors):
    codes, results, text = ranks
    assert codes[group][:survivors] == [0] * survivors, text[-8000:]
    return results[group][:survivors]


def _get(res, tag):
    params = {k.split("/p/")[1]: v for k, v in res.items()
              if k.startswith(tag + "/p/")}
    states = {k.split("/s/")[1]: v for k, v in res.items()
              if k.startswith(tag + "/s/")}
    return params, states


def _assert_bitwise(a, b, what):
    assert a[0] and a[0].keys() == b[0].keys(), what
    assert a[1] and a[1].keys() == b[1].keys(), what
    for k in a[0]:
        assert np.array_equal(a[0][k], b[0][k]), f"{what}: param {k}"
    for k in a[1]:
        assert np.array_equal(a[1][k], b[1][k]), f"{what}: state {k}"


def _jax_module(batch=W.B):
    mod = mx.mod.Module(W.mlp(mx), data_names=["data"],
                        label_names=["softmax_label"])
    mod.bind(data_shapes=[("data", (batch, W.FEAT))],
             label_shapes=[("softmax_label", (batch,))], for_training=True)
    mx.random.seed(0)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 1e-3})
    return mod


def test_knobs_as_the_reference():
    from mxnet_tpu import config as jc
    jr, tr = jc.registry(), tconfig.registry()
    for name in NAMES:
        assert (tr[name].default, tr[name].status) == \
            (jr[name].default, jr[name].status), name


def test_every_rank_ends_as_its_role_says(ranks):
    """Survivors exit 0, a killed rank with the injected code, a stopped
    one is still stopped when the others are done (the launcher kills
    it); only survivors write results."""
    codes, results, text = ranks
    assert codes == W.EXIT_CODES, text[-8000:]
    for group, expect in zip(results, W.EXIT_CODES):
        assert [r is not None for r in group] == [c == 0 for c in expect]


def test_hang_detected_within_timeout_and_structured(ranks):
    """A rank stopped at step 2's probe: the watchdog bounds the wait, the
    census names it, nothing of the step ran."""
    for res in _results(ranks, 0, 1):
        dt = float(res["hang/seconds"])
        assert float(W.TIMEOUT_S) <= dt < 10.0
        assert res["hang/lost"].tolist() == [3]
        assert int(res["hang/mesh_size"]) == 4
        assert str(res["hang/reason"]) == "device_hang"
        assert int(res["hang/step"]) == 2
        assert res["hang/census"].tolist() == [True, True, True, False]
        assert float(res["hang/timeout_s"]) == pytest.approx(
            float(W.TIMEOUT_S))
        assert res["hang/lost_device_ids"].tolist() == [3]
        assert res["hang/plan"].tolist() == [1, 0, 2]
        assert res["hang/device_losses"].tolist() == [1, 1]


def test_kill_surfaces_immediately(ranks, monkeypatch):
    """A rank killed at its first probe surfaces as ``device_killed``
    naming the mesh's last position, as the JAX package's injected kill
    does on as many devices (2 here: the port's group has lost two ranks
    in the cases before)."""
    monkeypatch.setenv("MXTPU_SPMD", "2")
    jem.reset_state()
    mod = _jax_module()
    plan = jfi.install(jfi.FaultPlan(kill_device_at=1))
    try:
        with pytest.raises(jem.MeshDegradedError) as ei:
            x, y = W.step_batches(1)[0]
            mod.fused_step(mx.io.DataBatch(data=[mx.nd.array(x)],
                                           label=[mx.nd.array(y)]))
    finally:
        jfi.clear()
        jem.reset_state()
    ref = ei.value
    (res,) = _results(ranks, 0, 1)
    assert str(res["kill/reason"]) == ref.reason == "device_killed"
    assert res["kill/lost"].tolist() == ref.lost == [1]
    assert int(res["kill/mesh_size"]) == ref.mesh_size == 2
    assert int(res["kill/step"]) == ref.step == 1
    assert int(res["kill/plan"][1]) == plan.summary()["device_kills"] == 1
    assert res["kill/lost_device_ids"].tolist() == [1]
    assert float(res["kill/seconds"]) < 10.0


def test_probe_fires_before_any_state_mutation(ranks):
    """A rank killed at step 2: Adam's ``num_update`` stays at 1."""
    (res,) = _results(ranks, 0, 1)
    assert res["mutation/num_update"].tolist() == [1, 1]
    assert str(res["mutation/reason"]) == "device_killed"
    assert int(res["mutation/step"]) == 2
    assert res["mutation/lost"].tolist() == [2]


@pytest.mark.parametrize("group,tag,counters", [
    (1, "buddy", [1, 1, 0, 1]),  # device_losses, buddy, disk, reshards
    (2, "disk", [1, 0, 1, 1]),
], ids=["buddy_recovery", "disk_fallback"])
def test_hang_shrink_bitwise_vs_fresh_n3(ranks, group, tag, counters):
    """A rank stopped at epoch 1's first step; the supervisor shrinks
    4 -> 3 and training continues bit-equal (weights and Adam states) to a
    fresh n' = 3 fit resumed from the epoch-0 checkpoint of a clean n = 4
    epoch; the lost shard comes from its buddy copy (no disk read) or,
    with redundancy off, from `latest_valid()`."""
    fresh = _results(ranks, 1, 2)
    # group 1's rank 2 is lost later, in the preempt case
    chaos = _results(ranks, group, 2 if group == 1 else 3)
    for rank, res in enumerate(chaos):
        _assert_bitwise(_get(res, tag), _get(fresh[0], "fresh_n3"),
                        f"rank {rank} shrink ({tag}) vs fresh n'=3")
        c = res[f"{tag}/counters"].tolist()
        assert c[:4] == counters, c
        assert c[4] >= 1                       # degraded steps
        assert float(res[f"{tag}/reshard_ms"]) > 0
        assert res[f"{tag}/after"].tolist() == [3, 1]
    _assert_bitwise(_get(fresh[1], "fresh_n3"), _get(fresh[0], "fresh_n3"),
                    "the fresh ranks agree")


def test_on_loss_preempt_policy(ranks):
    """``MXTPU_MESH_ON_LOSS=preempt``: the bounded final checkpoint (the
    buddy copies merged first) and `TrainingPreempted`, no shrink."""
    for res in _results(ranks, 1, 2):
        assert bool(res["preempt/committed"])
        # the preemption checkpoint: epoch 1, before its first batch
        assert res["preempt/latest"].tolist() == [1, 0]
        c = res["preempt/counters"].tolist()
        assert (c[0], c[3]) == (1, 0)
        assert int(res["preempt/shrinks"]) == 0


def test_kill_switch_restores_the_step_bitwise(ranks):
    for res in _results(ranks, 0, 1):
        assert res["switch_plan"].tolist() == [0, 0, 0]
        assert bool(res["switch_counters_flat"])
        _assert_bitwise(_get(res, "switch_off"), _get(res, "switch_on"),
                        "elastic on-vs-off")


def test_buddy_redundancy_is_bitwise_neutral(ranks):
    for res in _results(ranks, 0, 1):
        _assert_bitwise(_get(res, "redundancy0"), _get(res, "redundancy1"),
                        "redundancy on-vs-off")


def test_buddy_redundancy_state_is_o_2p_over_n(ranks):
    for res in _results(ranks, 0, 1):
        assert float(res["buddy_fraction"]) == pytest.approx(2.0 / 4,
                                                             abs=1e-9)


def test_banned_device_never_readopted(ranks, monkeypatch):
    """Every rank asked for, one banned: the mesh is one smaller and never
    holds it; a reset heals it.  The JAX package asked for all of its 8
    virtual devices gives the same pattern."""
    from mxnet_tpu.parallel.mesh import device_ids
    from mxnet_tpu.parallel.spmd_step import resolve_mesh
    monkeypatch.setenv("MXTPU_SPMD", "8")
    jem.reset_state()
    mesh = resolve_mesh()
    ids = device_ids(mesh)
    jem.ban_device(ids[-1])
    shrunk = resolve_mesh()
    ref = [mesh.size, shrunk.size, int(ids[-1] in device_ids(shrunk))]
    jem.reset_state()
    ref.append(resolve_mesh().size)
    assert ref == [8, 7, 0, 8]
    for res in _results(ranks, 0, 1):
        assert res["banned"].tolist() == [4, 3, 0, 4]


def test_policy_parsing_and_error_shape(monkeypatch):
    for v in ("preempt", "shrink", "", "garbage", "PREEMPT"):
        monkeypatch.setenv("MXTPU_MESH_ON_LOSS", v)
        assert em.on_loss_policy() == jem.on_loss_policy()
    args = ([2], 8, "device_hang")
    kw = dict(step=5, timeout_s=1.0, lost_device_ids=[12])
    e, r = em.MeshDegradedError(*args, **kw), \
        jem.MeshDegradedError(*args, **kw)
    assert str(e) == str(r)
    assert (e.lost, e.mesh_size, e.reason, e.census, e.step, e.timeout_s,
            e.lost_device_ids) == (r.lost, r.mesh_size, r.reason, r.census,
                                   r.step, r.timeout_s, r.lost_device_ids)
    assert "unattributed" in str(em.MeshDegradedError([], 8, "mesh_wedged"))
    assert isinstance(e, mt.base.MXNetError)


def _forgiveness(monitor_cls):
    mon = monitor_cls(port=0, timeout=30.0, expected=2, startup_grace=60.0)
    trace = []
    try:
        reported = []
        mon.on_failure(lambda ranks: reported.extend(ranks))
        with mon._lock:
            mon._last_seen[0] = time.monotonic()
            mon._last_seen[1] = time.monotonic()
        trace.append(list(mon.dead_ranks()))
        mon.report_device_loss(1)
        trace.append(list(mon.dead_ranks()))
        mon.sweep_once()
        trace.append(list(reported))
        mon.sweep_once()
        trace.append(list(reported))
        mon.forget(1)
        trace.append(list(mon.dead_ranks()))
        mon.sweep_once()
        trace.append(list(reported))
        with mon._lock:
            mon._last_seen[1] = time.monotonic()
        mon.report_device_loss(1)
        mon.sweep_once()
        trace.append(list(reported))
    finally:
        mon.close()
    return trace


def test_heartbeat_device_loss_forgiveness_path():
    from mxnet_tpu.parallel.failure import HeartbeatMonitor as JHB
    got = _forgiveness(HeartbeatMonitor)
    assert got == _forgiveness(JHB)
    assert got == [[], [1], [1], [1], [], [1], [1, 1]]


def test_one_rank_mesh_loss_surfaces_at_once(monkeypatch):
    """A mesh of one has no survivor to see a loss: the injected kill
    surfaces in the probe, as the JAX package's does, and the profiler's
    family counts it."""
    monkeypatch.setenv("MXTPU_SPMD", "1")
    monkeypatch.setenv("MXTPU_MESH_STEP_TIMEOUT_S", "0.5")
    em.reset_state()
    mt.profiler.reset_mesh_counters()
    from mxnet_tpu_torch import fault_injection as fi
    with mt.cpu():
        mod = W.make_module()
    plan = fi.install(fi.FaultPlan(kill_device_at=2))
    try:
        x, y = W.step_batches(1)[0]
        assert mod.fused_step(W.batch(x, y))
        with pytest.raises(em.MeshDegradedError) as ei:
            mod.fused_step(W.batch(x, y))
    finally:
        fi.clear()
    assert (ei.value.reason, ei.value.lost, ei.value.step) == \
        ("device_killed", [0], 2)
    assert mod._updater.optimizer.num_update == 1
    assert plan.summary()["device_kills"] == 1
    assert mt.profiler.mesh_counters()["device_losses"] == 1
