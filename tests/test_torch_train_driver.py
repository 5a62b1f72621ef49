"""The port's preemption-safe training driver (`mxnet_tpu_torch.
train_driver`) against the JAX package's (`tests/test_train_driver.py`):
the same kill matrix in one process, with seeded `FaultPlan` driver
events, fake worker processes and injectable clocks -- the mid-epoch
preemption checkpoint and its bit-equal resume, the anomaly guard's skip,
escalation and clean-path parity, the SIGTERM chain with telemetry's
flight recorder, worker supervision (seeded backoff, the crash-loop
breaker, heartbeat deaths), the heartbeat accounting and the checkpoint
retention pin.  The MLP and its synthetic MNIST batches are the
reference's, the weights one seeded set that both packages load; the
uninterrupted fit is held against the JAX package's, and the seeded
respawn backoff equals its delays.
"""
import os
import signal
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import train_driver as jdrv

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import fault_injection as fi
from mxnet_tpu_torch import profiler as _prof
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch import train_driver as drv
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.parallel.failure import (HeartbeatClient,
                                              HeartbeatMonitor)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "example", "image-classification"))

_EPOCHS = 3
_BATCH = 50
_N = 200  # 4 batches an epoch
CPU = mt.cpu()


def _weights():
    rs = np.random.RandomState(42)
    shapes = {"fc1": (128, 784), "fc2": (64, 128), "fc3": (10, 64)}
    out = {}
    for name, (o, i) in shapes.items():
        out[f"{name}_weight"] = (rs.randn(o, i) * (2.0 / i) ** 0.5
                                 ).astype(np.float32)
        out[f"{name}_bias"] = np.zeros(o, np.float32)
    return out


def _mlp(pkg):
    """`example/image-classification/train_mnist.py`'s ``mlp()`` in
    ``pkg``."""
    sym = pkg.sym
    fl = sym.Flatten(sym.var("data"), name="flatten")
    f1 = sym.FullyConnected(fl, num_hidden=128, name="fc1")
    a1 = sym.Activation(f1, act_type="relu", name="relu1")
    f2 = sym.FullyConnected(a1, num_hidden=64, name="fc2")
    a2 = sym.Activation(f2, act_type="relu", name="relu2")
    f3 = sym.FullyConnected(a2, num_hidden=10, name="fc3")
    return sym.SoftmaxOutput(f3, sym.var("softmax_label"), name="softmax")


def _data(nan_batches=()):
    import train_mnist as T
    X, Y = T.synthetic_mnist(_N, seed=5)
    X = np.array(X)
    for b in nan_batches:
        X[b * _BATCH:(b + 1) * _BATCH] = np.nan
    return X, Y


def _fit(X, Y, epochs=_EPOCHS, sup=None, pkg=mt):
    """One deterministic MLP fit in ``pkg``; the final arg params."""
    kw = {"context": CPU} if pkg is mt else {}
    akw = {"ctx": CPU} if pkg is mt else {}
    it = pkg.io.NDArrayIter(X, Y, _BATCH, shuffle=False)
    mod = pkg.mod.Module(_mlp(pkg), data_names=("data",),
                         label_names=("softmax_label",), **kw)
    try:
        if sup is not None:
            sup.activate()
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: pkg.nd.array(v, **akw)
                            for k, v in _weights().items()})
    finally:
        if sup is not None:
            sup.deactivate()
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def _assert_bitwise(a, b, msg):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), \
            f"{msg}: {k} max|d|={np.abs(a[k] - b[k]).max()}"


# ---------------------------------------------------------------------------
# preemption: FaultPlan preempt_at -> bounded checkpoint -> bitwise resume
# ---------------------------------------------------------------------------

def test_fault_plan_preempt_then_bitwise_resume(tmp_path, monkeypatch):
    X, Y = _data()
    monkeypatch.setenv("MXTPU_CKPT_DIR", str(tmp_path / "clean"))
    ref = _fit(X, Y, sup=drv.TrainingSupervisor())

    chaos_dir = str(tmp_path / "chaos")
    monkeypatch.setenv("MXTPU_CKPT_DIR", chaos_dir)
    _prof.reset_driver_counters()
    fi.install(fi.FaultPlan(preempt_at=6))
    try:
        with pytest.raises(drv.TrainingPreempted) as ei:
            _fit(X, Y, sup=drv.TrainingSupervisor())
    finally:
        fi.clear()
    assert ei.value.committed and ei.value.epoch == 1 \
        and ei.value.batch == 2

    mgr = CheckpointManager(chaos_dir)
    loaded = mgr.load(mgr.latest_valid())
    assert (loaded["extra"] or {}).get("preempted")
    assert loaded["epoch"] == 1 and loaded["batch"] == 2
    c = _prof.driver_counters()
    assert c.get("preempts") == 1 and c.get("preempt_ckpt_commits") == 1

    resumed = _fit(X, Y, sup=drv.TrainingSupervisor())
    _assert_bitwise(ref, resumed, "preempt resume diverged")


def test_epoch_boundary_preempt_reuses_epoch_checkpoint(tmp_path,
                                                        monkeypatch):
    X, Y = _data()
    monkeypatch.setenv("MXTPU_CKPT_DIR", str(tmp_path / "clean"))
    ref = _fit(X, Y, sup=drv.TrainingSupervisor())
    monkeypatch.setenv("MXTPU_CKPT_DIR", str(tmp_path / "chaos"))
    fi.install(fi.FaultPlan(preempt_at=4))
    try:
        with pytest.raises(drv.TrainingPreempted) as ei:
            _fit(X, Y, sup=drv.TrainingSupervisor())
    finally:
        fi.clear()
    assert ei.value.epoch == 0 and ei.value.batch == 4
    resumed = _fit(X, Y, sup=drv.TrainingSupervisor())
    _assert_bitwise(ref, resumed, "epoch-boundary preempt diverged")


def test_kill_switch_restores_existing_paths(monkeypatch):
    """MXTPU_DRIVER=0: nothing installs, no plan is consulted, and the
    fit equals the fit without a supervisor (which follows the JAX
    package's fit from the same weights)."""
    monkeypatch.delenv("MXTPU_CKPT_DIR", raising=False)
    X, Y = _data()
    ref = _fit(X, Y)
    jref = _fit(X, Y, pkg=mx)
    for k in ref:
        np.testing.assert_allclose(ref[k], jref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    monkeypatch.setenv("MXTPU_DRIVER", "0")
    sup = drv.TrainingSupervisor()
    before = signal.getsignal(signal.SIGTERM)
    assert sup.activate() is sup and drv.current() is None
    assert sup.install_signal_handlers() is False
    assert signal.getsignal(signal.SIGTERM) is before
    fi.install(fi.FaultPlan(preempt_at=2))
    try:
        off = _fit(X, Y, sup=sup)
        assert fi.active().driver_steps == 0
    finally:
        fi.clear()
        sup.deactivate()
    _assert_bitwise(ref, off, "MXTPU_DRIVER=0 changed the train path")


# ---------------------------------------------------------------------------
# anomaly guard: skip, escalate, parity, no extra dispatch
# ---------------------------------------------------------------------------

def test_anomaly_guard_off_on_parity_and_flat_counters(monkeypatch):
    monkeypatch.delenv("MXTPU_CKPT_DIR", raising=False)
    X, Y = _data()
    _prof.reset_step_counters()
    off = _fit(X, Y)
    base = _prof.step_counters()
    monkeypatch.setenv("MXTPU_ANOMALY_GUARD", "1")
    _prof.reset_step_counters()
    _prof.reset_driver_counters()
    on = _fit(X, Y)
    guarded = _prof.step_counters()
    _assert_bitwise(off, on, "anomaly guard changed clean-path numerics")
    assert guarded.get("dispatches") == base.get("dispatches")
    assert guarded.get("fused_steps") == base.get("fused_steps")
    assert not _prof.driver_counters().get("anomaly_skipped_steps")


def test_anomaly_guard_skips_poisoned_steps(monkeypatch):
    """One NaN batch an epoch: the device skips its update (never
    escalating: not consecutive), every weight stays finite, and the run
    equals one whose poisoned steps were never applied."""
    monkeypatch.delenv("MXTPU_CKPT_DIR", raising=False)
    monkeypatch.setenv("MXTPU_ANOMALY_GUARD", "1")
    monkeypatch.setenv("MXTPU_ANOMALY_LIMIT", "3")
    _prof.reset_driver_counters()
    X, Y = _data(nan_batches=(1,))
    params = _fit(X, Y)
    c = _prof.driver_counters()
    assert c.get("anomaly_skipped_steps") == _EPOCHS
    assert not c.get("anomaly_trips")
    for k, v in params.items():
        assert np.isfinite(v).all(), f"{k} poisoned despite guard"


def test_anomaly_guard_escalates_after_limit(monkeypatch):
    monkeypatch.delenv("MXTPU_CKPT_DIR", raising=False)
    monkeypatch.setenv("MXTPU_ANOMALY_GUARD", "1")
    monkeypatch.setenv("MXTPU_ANOMALY_LIMIT", "2")
    _prof.reset_driver_counters()
    X, Y = _data(nan_batches=(1, 2))
    with pytest.raises(drv.GradientAnomalyError) as ei:
        _fit(X, Y)
    assert ei.value.skips == 2 and ei.value.limit == 2
    c = _prof.driver_counters()
    assert c.get("anomaly_skipped_steps") == 2
    assert c.get("anomaly_trips") == 1
    assert "grad_anomaly" in [r.get("kind")
                              for r in telemetry.flight_records()]


@pytest.mark.parametrize("spmd", ["", "1"])
def test_fault_plan_poisoned_step_is_skipped(monkeypatch, spmd):
    """A step the fault plan poisons (``poison_step_at``: NaN head
    gradients) is skipped by the guard, on the dense step and on the
    sharded one, and leaves the weights as they were before it."""
    monkeypatch.delenv("MXTPU_CKPT_DIR", raising=False)
    monkeypatch.setenv("MXTPU_ANOMALY_GUARD", "1")
    monkeypatch.setenv("MXTPU_SPMD", spmd)
    X, Y = _data()
    before = _fit(X, Y, epochs=1)      # 4 clean steps
    _prof.reset_driver_counters()
    plan = fi.install(fi.FaultPlan(poison_step_at=5))
    try:
        after = _fit(X, Y, epochs=2)   # step 5 is epoch 1's first
    finally:
        fi.clear()
    # the sharded step's elastic-mesh probe consults the plan once a step
    mesh_steps = 8 if spmd else 0
    assert plan.poisoned_steps == 1 and plan.summary() == \
        fi.FaultPlan().summary() | {"driver_steps": 0,
                                    "mesh_steps": mesh_steps}
    assert _prof.driver_counters().get("anomaly_skipped_steps") == 1
    for k, v in after.items():
        assert np.isfinite(v).all(), k
        assert not np.array_equal(v, before[k]) or k.endswith("bias"), k


# ---------------------------------------------------------------------------
# signal composition with telemetry's flight-recorder handler
# ---------------------------------------------------------------------------

def test_sigterm_chains_with_flight_recorder():
    orig = signal.getsignal(signal.SIGTERM)
    sup = drv.TrainingSupervisor()
    try:
        telemetry.install_crash_handlers()
        tele_h = signal.getsignal(signal.SIGTERM)
        assert sup.install_signal_handlers()
        ours = signal.getsignal(signal.SIGTERM)
        assert ours is not tele_h
        assert getattr(ours, "_mxtpu_sigterm_chain", False)
        telemetry.install_crash_handlers()
        assert signal.getsignal(signal.SIGTERM) is ours
        telemetry.reset()
        telemetry.event("pre-preempt-marker")
        ours(signal.SIGTERM, None)
        assert sup.stop_requested()
        assert any(r.get("name") == "driver.preempt_requested"
                   for r in telemetry.flight_records())
        assert signal.getsignal(signal.SIGTERM) is ours
        sup.restore_signal_handlers()
        assert signal.getsignal(signal.SIGTERM) is tele_h
    finally:
        sup.restore_signal_handlers()
        signal.signal(signal.SIGTERM, orig)


def test_sigint_opt_in(monkeypatch):
    monkeypatch.setenv("MXTPU_DRIVER_SIGINT", "1")
    orig = signal.getsignal(signal.SIGINT)
    sup = drv.TrainingSupervisor()
    try:
        assert sup.install_signal_handlers()
        h = signal.getsignal(signal.SIGINT)
        assert getattr(h, "_mxtpu_sigterm_chain", False)
        h(signal.SIGINT, None)
        assert sup.stop_requested()
    finally:
        sup.restore_signal_handlers()
        signal.signal(signal.SIGINT, orig)


# ---------------------------------------------------------------------------
# worker supervision: respawn, backoff, clean-preempt exits, crash loop
# ---------------------------------------------------------------------------

class _FakeProc:
    def __init__(self, code=None):
        self.code = code
        self.killed = self.terminated = False

    def poll(self):
        return self.code

    def kill(self):
        self.killed = True
        self.code = -9

    def terminate(self):
        self.terminated = True
        self.code = -15


def _fake_supervisor(codes_by_attempt, module=drv, **kw):
    spawned, sleeps = [], []

    def spawn(slot, attempt):
        p = _FakeProc(codes_by_attempt.get(attempt, None))
        spawned.append((slot, attempt, p))
        return p

    sup = module.TrainingSupervisor(
        spawn=spawn, backoff_base_s=0.2, backoff_max_s=5.0,
        crash_window_s=30.0, crash_limit=3, seed=0,
        clock=lambda: 0.0, sleep=sleeps.append, **kw)
    return sup, spawned, sleeps


def test_supervisor_respawns_crashed_worker_with_backoff():
    _prof.reset_driver_counters()
    sup, spawned, sleeps = _fake_supervisor({0: 1, 1: None})
    sup.spawn_workers(1)
    assert sup.check_once() == [0]
    assert [(s, a) for s, a, _ in spawned] == [(0, 0), (0, 1)]
    assert len(sleeps) == 1 and 0.1 <= sleeps[0] < 0.3
    assert sup.check_once() == []
    assert _prof.driver_counters().get("worker_restarts") == 1
    # the seeded jitter is the JAX package's, delay for delay
    jsup, _, jsleeps = _fake_supervisor({0: 1, 1: None}, module=jdrv)
    jsup.spawn_workers(1)
    jsup.check_once()
    assert sleeps == jsleeps


def test_supervisor_never_respawns_clean_preempt_exit():
    _prof.reset_driver_counters()
    sup, spawned, _ = _fake_supervisor({0: drv.PREEMPTED_EXIT_CODE})
    sup.spawn_workers(1)
    assert sup.check_once() == []
    assert len(spawned) == 1
    assert sup.exit_code() == drv.PREEMPTED_EXIT_CODE == 75
    assert _prof.driver_counters().get("worker_preempts") == 1


def test_supervisor_crash_loop_breaker():
    _prof.reset_driver_counters()
    sup, spawned, sleeps = _fake_supervisor({0: 1, 1: 1, 2: 1, 3: 1})
    sup.spawn_workers(1)
    sup.check_once()
    sup.check_once()
    from mxnet_tpu_torch.serving_fleet import CrashLoopError
    with pytest.raises(CrashLoopError):
        sup.check_once()
    assert drv.CrashLoopError is CrashLoopError
    c = _prof.driver_counters()
    assert c.get("crash_loop_opens") == 1 and c.get("worker_restarts") == 2
    assert len(sleeps) == 2 and sleeps[1] > sleeps[0]


def test_supervisor_heartbeat_death_triggers_respawn():
    _prof.reset_driver_counters()
    sup, spawned, _ = _fake_supervisor({0: None, 1: None})
    sup.spawn_workers(1)

    class _Mon:
        def __init__(self):
            self.cbs, self.forgotten = [], []

        def on_failure(self, cb):
            self.cbs.append(cb)

        def forget(self, rank):
            self.forgotten.append(rank)

    mon = _Mon()
    sup.attach_heartbeat(mon)
    mon.cbs[0]([0])
    assert spawned[0][2].killed
    assert sup.check_once() == [0]
    assert mon.forgotten == [0]
    c = _prof.driver_counters()
    assert c.get("heartbeat_deaths") == 1 and c.get("worker_restarts") == 1


def test_fault_plan_kill_worker_event_kills_lowest_live_slot():
    sup, spawned, _ = _fake_supervisor({0: None})
    sup.spawn_workers(2)
    plan = fi.FaultPlan(kill_worker_at=2)
    fi.install(plan)
    try:
        sup.on_step_end()
        sup.on_step_end()
        assert spawned[0][2].killed and not spawned[1][2].killed
        assert plan.injected["worker_kills"] == 1
    finally:
        fi.clear()


def test_fault_plan_driver_events_from_spec():
    plan = fi.FaultPlan.from_spec("preempt_at=3+5,kill_worker_at=4")
    fired = []
    plan.on_preempt = lambda n: fired.append(("p", n))
    plan.on_kill_worker = lambda n: fired.append(("k", n))
    for _ in range(6):
        plan.driver_step_event()
    assert fired == [("p", 3), ("k", 4), ("p", 5)]
    assert plan.injected["preempts"] == 2
    assert plan.injected["worker_kills"] == 1
    assert plan.summary()["driver_steps"] == 6


def test_main_guard_maps_preemption_to_exit_75():
    sup = drv.TrainingSupervisor()
    with pytest.raises(SystemExit) as ei:
        with sup.main_guard():
            raise drv.TrainingPreempted("test", epoch=0, batch=1,
                                        committed=True)
    assert ei.value.code == drv.PREEMPTED_EXIT_CODE
    with pytest.raises(ValueError):
        with sup.main_guard():
            raise ValueError("a crash propagates")


# ---------------------------------------------------------------------------
# heartbeat detector accounting (parallel/failure.py)
# ---------------------------------------------------------------------------

def _quiet_monitor(**kw):
    mon = HeartbeatMonitor(port=0, **kw)
    mon._stop.set()
    mon._sweep_thread.join(2.0)
    mon._accept_thread.join(2.0)
    mon._stop.clear()
    return mon


def test_heartbeat_recovered_rank_can_die_again():
    mon = _quiet_monitor(timeout=0.5, expected=2, startup_grace=1000.0)
    fired = []
    mon.on_failure(lambda ranks: fired.append(list(ranks)))
    now = time.monotonic()
    with mon._lock:
        mon._last_seen[0] = now
        mon._last_seen[1] = now - 10.0
    assert mon.sweep_once() == [1]
    assert mon.sweep_once() == []
    with mon._lock:
        mon._last_seen[1] = time.monotonic()
    assert mon.sweep_once() == []
    with mon._lock:
        mon._last_seen[1] = time.monotonic() - 10.0
    assert mon.sweep_once() == [1]
    assert fired == [[1], [1]]
    mon.close()


def test_heartbeat_forget_grants_fresh_grace():
    mon = _quiet_monitor(timeout=0.2, expected=2, startup_grace=30.0)
    with mon._lock:
        mon._start -= 100.0
        mon._last_seen[0] = time.monotonic()
    assert mon.dead_ranks() == [1]
    mon.sweep_once()
    mon.forget(1)
    assert mon.dead_ranks() == []
    assert 1 not in mon._reported
    mon.close()


def test_heartbeat_client_pings_monitor():
    mon = HeartbeatMonitor(port=0, timeout=5.0, expected=1)
    client = HeartbeatClient("127.0.0.1", mon.port, rank=0, interval=0.1)
    try:
        deadline = time.monotonic() + 10
        while mon.alive_ranks() != [0]:
            assert time.monotonic() < deadline, "ping never arrived"
            time.sleep(0.05)
        assert mon.dead_ranks() == []
    finally:
        client.close()
        mon.close()


# ---------------------------------------------------------------------------
# checkpoint retention pin; the metrics surface
# ---------------------------------------------------------------------------

def test_retention_never_deletes_pinned_latest_valid(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=1)
    w = mt.nd.ones((2, 2), ctx=CPU)
    mgr.save(0, params={"arg:w": w})
    mgr.save(1, params={"arg:w": w})
    ck = mgr.latest_valid()
    assert ck.step == 1
    mgr.save(2, params={"arg:w": w})
    mgr.save(3, params={"arg:w": w})
    assert os.path.isdir(mgr.step_dir(1)), "pinned checkpoint deleted"
    assert mgr.validate(1) is not None
    assert mgr.load(ck)["params"], "pinned checkpoint unreadable"
    assert not os.path.isdir(mgr.step_dir(0))
    assert not os.path.isdir(mgr.step_dir(2))
    assert mgr.latest_valid().step == 3
    mgr.save(4, params={"arg:w": w})
    assert not os.path.isdir(mgr.step_dir(1))


def test_metrics_surface_has_driver_family():
    _prof.reset_driver_counters()
    _prof.bump_driver("preempts")
    snap = _prof.metrics_snapshot()
    assert snap["driver"]["preempts"] == 1
    assert "mxtpu_driver_preempts 1" in _prof.metrics_text()
    line = drv.dump_counters()
    assert line.startswith("DRIVER-COUNTERS") and "preempts" in line
