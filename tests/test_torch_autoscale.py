"""The port's autoscaler (`mxnet_tpu_torch.autoscale`) against the JAX
package's, after `tests/test_autoscale.py`: each scenario (scale-up on
queue or p99 pressure and the warm-up promotion, cooldown, warm-up wait
and timeout, the max bound's brownout, sustained-idle scale-down to the
floor, the dead band, a SIGKILL in the scale-up window) drives one fleet
of in-process CPU replicas per package under the same fake clock and
seed, and both packages must take the same actions and count the same;
then admission control (deadline and priority sheds), the brownout
ladder's restore, FaultPlan's autoscale hooks, the seeded jitter, the
kill switch and the clock audit."""
import inspect
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autoscale as jautoscale
from mxnet_tpu import fault_injection as jfault
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import serving as jserving
from mxnet_tpu import serving_fleet as jfleet
from mxnet_tpu import telemetry as jtele

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autoscale as tautoscale
from mxnet_tpu_torch import fault_injection, profiler, serving
from mxnet_tpu_torch import serving_fleet as tfleet
from mxnet_tpu_torch import telemetry as tele
from mxnet_tpu_torch.autoscale import Autoscaler, autoscale_enabled
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.fault_injection import FaultPlan
from mxnet_tpu_torch.serving import (MicroBatchQueue, ServerOverloadError)
from mxnet_tpu_torch.serving_fleet import (CircuitBreaker,
                                           ReplicaSupervisor, Router)

CPU = mt.cpu()


def _mlp(pkg, seed=0):
    """The same 2-layer MLP predictor in ``pkg`` (``mt`` or ``mx``)."""
    data = pkg.sym.var("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=3, name="fc2")
    out = pkg.sym.softmax(fc2, name="out")
    rng = np.random.RandomState(seed)
    arrays = {"arg:fc1_weight": rng.randn(8, 5).astype(np.float32),
              "arg:fc1_bias": np.zeros(8, np.float32),
              "arg:fc2_weight": rng.randn(3, 8).astype(np.float32),
              "arg:fc2_bias": np.zeros(3, np.float32)}
    if pkg is mt:
        params = mt.serialization.dumps_ndarrays(
            {k: mt.nd.array(v, ctx=CPU) for k, v in arrays.items()})
        return mt.Predictor(out.tojson(), params, {"data": (4, 5)}, ctx=CPU)
    params = mx.serialization.dumps_ndarrays(
        {k: mx.nd.array(v) for k, v in arrays.items()})
    return mx.Predictor(out.tojson(), params, {"data": (4, 5)})


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    d = tmp_path_factory.mktemp("autoscale_blobs")
    out = {}
    for name, pkg in (("port", mt), ("reference", mx)):
        p = str(d / f"{name}.blob")
        _mlp(pkg).export_compiled(p, dynamic_batch=True)
        out[name] = p
    return out


PKGS = {
    "port": SimpleNamespace(
        fleet=tfleet, autoscale=tautoscale, fault=fault_injection,
        prof=profiler, tele=tele, serving=serving,
        pool=lambda blob: serving.CompiledModelPool(
            blob, batch_ladder=[4], devices=[CPU])),
    "reference": SimpleNamespace(
        fleet=jfleet, autoscale=jautoscale, fault=jfault, prof=jprofiler,
        tele=jtele, serving=jserving,
        pool=lambda blob: jserving.CompiledModelPool(blob,
                                                     batch_ladder=[4])),
}


@pytest.fixture(autouse=True)
def _fresh_counters():
    for ns in PKGS.values():
        ns.prof.reset_router_counters()
        ns.prof.reset_autoscale_counters()
    yield
    for ns in PKGS.values():
        ns.fault.clear()


def _pinned_input(rows=4, seed=1):
    return {"data": np.random.RandomState(seed)
            .randn(rows, 5).astype(np.float32)}


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class _FakeProc:
    def __init__(self, slot, gen):
        self.slot, self.gen = slot, gen
        self.dead = False
        self.returncode = None

    def poll(self):
        return -9 if self.dead else None

    def kill(self):
        self.dead = True


class _AutoFleet:
    """Router + ReplicaSupervisor + in-process replicas of package
    ``name``, every clock injectable and health driven by hand.  Slots
    >= ``dead_from`` spawn with an address nothing listens on."""

    def __init__(self, name, blobs, n=1, dead_from=None, **router_kw):
        self.ns = ns = PKGS[name]
        self.blob = blobs[name]
        self.clk = _Clock()
        self.dead_from = dead_from
        self.servers = {}
        self.spawned = []
        router_kw.setdefault("start_health", False)
        router_kw.setdefault("health_interval", 0.05)
        self.router = ns.fleet.Router([("127.0.0.1", 1)] * n, **router_kw)
        self.sup = ns.fleet.ReplicaSupervisor(
            self._spawn, slots=n, router=self.router, seed=0,
            clock=self.clk, sleep=lambda s: None)
        self.sup.start(monitor=False)
        self.router.health_cycle()

    def _spawn(self, slot):
        proc = _FakeProc(slot, len(self.spawned))
        self.spawned.append(proc)
        if self.dead_from is not None and slot >= self.dead_from:
            return proc, ("127.0.0.1", 1)
        srv = self.ns.serving.ModelServer(self.ns.pool(self.blob),
                                          max_delay_ms=5.0,
                                          model_version="v1")
        addr = srv.serve("127.0.0.1", 0)
        self.servers.setdefault(slot, []).append(srv)
        return proc, addr

    def scaler(self, **kw):
        kw.setdefault("up_queue_rows", 30)
        kw.setdefault("down_queue_rows", 1)
        kw.setdefault("idle_window_s", 10.0)
        kw.setdefault("cooldown_s", 0.0)
        kw.setdefault("min_replicas", 1)
        kw.setdefault("max_replicas", 8)
        kw.setdefault("interval_s", 0.01)
        kw.setdefault("drain_wait_s", 0.5)
        kw.setdefault("clock", self.clk)
        kw.setdefault("sleep", lambda s: None)
        return self.ns.autoscale.Autoscaler(self.router, self.sup, seed=0,
                                            **kw)

    def set_load(self, rows=0, p99=0.0):
        for rep in self.router.replicas:
            if rep.state == "active":
                rep.queue_rows = rows
                rep.p99_ms = p99

    def state(self):
        return {"states": [r.state for r in self.router.replicas],
                "retired": self.sup.retired,
                "procs": len(self.sup.procs),
                "autoscale": self.ns.prof.autoscale_counters(),
                "restarts": self.ns.prof.router_counters().get(
                    "replica_restarts", 0)}

    def close(self):
        self.router.close()
        self.sup.stop()
        for servers in self.servers.values():
            for srv in servers:
                try:
                    srv.close()
                except Exception:
                    pass


def _both(blobs, scenario, **fleet_kw):
    """``scenario(fleet)`` -> its record, in each package; the records
    must be equal."""
    out = {}
    for name in ("port", "reference"):
        fleet = _AutoFleet(name, blobs, **fleet_kw)
        try:
            out[name] = scenario(fleet)
        finally:
            fleet.close()
    assert out["port"] == out["reference"], out
    return out["port"]


# ---------------------------------------------------------------------------
# scenarios: the same actions in both packages
# ---------------------------------------------------------------------------

def test_scale_up_on_queue_pressure_then_warmup_promotes(blobs):
    def scenario(fleet):
        scaler = fleet.scaler()
        fleet.set_load(rows=50)
        acts = [scaler.poll_once()]
        picked = fleet.router._pick(set())
        picked.inflight -= 1
        mid = (fleet.state(), picked.idx)
        acts.append(scaler.poll_once())
        return acts, mid, fleet.state()

    acts, (mid, picked), end = _both(blobs, scenario, n=1)
    assert acts == ["scale_up", "hold"]
    assert mid["states"] == ["active", "warming"] and picked == 0
    assert end["states"] == ["active", "active"]
    assert end["autoscale"]["scale_ups"] == 1
    assert end["autoscale"]["warmups"] == 1


def test_scale_up_on_p99_pressure(blobs):
    def scenario(fleet):
        scaler = fleet.scaler(up_queue_rows=1000, up_p99_ms=100.0)
        fleet.set_load(rows=0, p99=500.0)
        return scaler.poll_once(), fleet.state()

    act, st = _both(blobs, scenario, n=1)
    assert act == "scale_up" and st["states"] == ["active", "warming"]


def test_cooldown_spaces_scale_actions(blobs):
    def scenario(fleet):
        scaler = fleet.scaler(cooldown_s=10.0)
        acts = []
        for dt in (0.0, 0.0, 11.0):
            fleet.clk.t += dt
            fleet.set_load(rows=100)
            acts.append(scaler.poll_once())
        return acts, fleet.state()

    acts, st = _both(blobs, scenario, n=1)
    assert acts == ["scale_up", "cooldown", "scale_up"]
    assert st["procs"] == 3 and st["autoscale"]["cooldown_holds"] == 1


def test_warmup_wait_and_timeout_retire(blobs):
    def scenario(fleet):
        scaler = fleet.scaler(warmup_timeout_s=30.0)
        acts = []
        for dt in (0.0, 0.0, 31.0):
            fleet.clk.t += dt
            fleet.set_load(rows=50)
            acts.append(scaler.poll_once())
        n = len(fleet.spawned)
        fleet.spawned[1].dead = True
        fleet.sup.check_once()
        return acts, fleet.state(), len(fleet.spawned) - n

    acts, st, respawned = _both(blobs, scenario, n=1, dead_from=1)
    assert acts == ["scale_up", "warmup_wait", "scale_up"]
    assert st["states"][1] == "retired" and st["retired"][1]
    assert st["autoscale"]["warmup_failures"] == 1
    assert respawned == 0


def test_max_bound_enters_brownout_not_thrash(blobs):
    def scenario(fleet):
        scaler = fleet.scaler(max_replicas=1)
        srv = fleet.servers[0][0]
        base = srv._queue.max_delay_s
        acts, delays = [], []
        for rows in (50, 50, 0):
            fleet.set_load(rows=rows)
            acts.append(scaler.poll_once())
            delays.append(round(srv._queue.max_delay_s / base, 6))
        return acts, delays, fleet.state()

    acts, delays, st = _both(blobs, scenario, n=1)
    assert acts == ["brownout_enter", "hold", "brownout_exit"]
    assert delays == [4.0, 4.0, 1.0]
    assert st["procs"] == 1
    assert st["autoscale"]["brownout_enters"] == 1
    assert st["autoscale"]["brownout_exits"] == 1


def test_scale_down_after_sustained_idle_to_the_floor(blobs):
    def scenario(fleet):
        scaler = fleet.scaler()
        fleet.set_load(rows=0)
        acts = [scaler.poll_once()]
        for dt in (11.0, 100.0):
            fleet.clk.t += dt
            acts.append(scaler.poll_once())
        n = len(fleet.spawned)
        fleet.sup.check_once()
        return acts, fleet.state(), fleet.spawned[1].dead, \
            len(fleet.spawned) - n

    acts, st, killed, respawned = _both(blobs, scenario, n=2)
    assert acts == ["hold", "scale_down", "hold"]
    assert st["states"] == ["active", "retired"] and killed
    assert st["autoscale"]["scale_downs"] == 1 and respawned == 0


def test_scale_down_drains_inflight_before_retiring(blobs):
    def scenario(fleet):
        seen = []

        def sleep(_s):
            seen.append(fleet.router.replicas[1].state)
            fleet.router.replicas[1].inflight = 0

        scaler = fleet.scaler(sleep=sleep)
        fleet.set_load(rows=0)
        scaler.poll_once()
        fleet.clk.t += 11.0
        fleet.router.replicas[1].inflight = 1
        return scaler.poll_once(), seen, fleet.state()["states"]

    act, seen, states = _both(blobs, scenario, n=2)
    assert act == "scale_down" and seen == ["draining"]
    assert states[1] == "retired"


def test_dead_band_resets_idle_window(blobs):
    def scenario(fleet):
        scaler = fleet.scaler(up_queue_rows=30, down_queue_rows=2)
        acts = []
        for dt, rows in ((0.0, 0), (6.0, 10), (6.0, 0), (11.0, 0)):
            fleet.clk.t += dt
            fleet.set_load(rows=rows)
            acts.append(scaler.poll_once())
        return acts

    assert _both(blobs, scenario, n=2) == ["hold", "hold", "hold",
                                           "scale_down"]


def test_sigkill_mid_scale_up_absorbed(blobs):
    """The fresh replica dies after its spawn and before its warm-up:
    the supervisor respawns the slot, which stays warming until a probe
    passes -- in both packages alike."""
    def scenario(fleet):
        def kill_newest(_n):
            proc = fleet.spawned[-1]
            proc.dead = True
            for srv in fleet.servers.get(proc.slot, []):
                srv.close()

        plan = fleet.ns.fault.install(fleet.ns.fault.FaultPlan(
            kill_replica_during_scale=(1,),
            on_kill_replica_during_scale=kill_newest))
        scaler = fleet.scaler()
        fleet.set_load(rows=50)
        acts = [scaler.poll_once()]
        warming = fleet.router.replicas[1].state
        fleet.sup.check_once()
        respawned = fleet.router.replicas[1].state
        acts.append(scaler.poll_once())
        return acts, warming, respawned, fleet.state(), plan.summary()

    acts, warming, respawned, st, summary = _both(blobs, scenario, n=1)
    assert acts[0] == "scale_up"
    assert warming == respawned == "warming"
    assert st["states"][1] == "active" and st["restarts"] == 1
    assert st["autoscale"]["warmups"] == 1
    assert summary["scale_kills"] == 1


def test_same_seed_same_actions_under_jittered_thread(blobs):
    """The control loop on its thread with the same seed: both packages
    draw the same jittered sleeps (Python's ``random``)."""
    def scenario(fleet):
        sleeps = []
        done = threading.Event()

        def sleep(s):
            sleeps.append(round(s, 12))
            if len(sleeps) >= 5:
                done.set()
            time.sleep(0.002)

        scaler = fleet.ns.autoscale.Autoscaler(
            fleet.router, fleet.sup, interval_s=0.01, seed=7,
            clock=fleet.clk, sleep=sleep)
        with scaler:
            scaler.start()
            assert done.wait(timeout=5.0)
        return sleeps[:5], scaler.snapshot()["active"]

    sleeps, active = _both(blobs, scenario, n=1)
    assert all(0.008 <= s < 0.012 for s in sleeps) and active == 1


# ---------------------------------------------------------------------------
# admission control, brownout ladder, kill switch (the port's fleet)
# ---------------------------------------------------------------------------

def test_autoscale_kill_switch(monkeypatch, blobs):
    monkeypatch.setenv("MXTPU_SERVE_AUTOSCALE", "0")
    assert not autoscale_enabled()
    with pytest.raises(MXNetError, match="MXTPU_SERVE_AUTOSCALE"):
        Autoscaler(None, None)
    plan = fault_injection.install(FaultPlan(
        traffic_spike_at=(1,), kill_replica_during_scale=(1,)))
    fleet = _AutoFleet("port", blobs, n=2)
    try:
        x = _pinned_input()
        routed = fleet.router.infer(x)
        direct = fleet.servers[0][0].infer(x)
        assert routed[0].tobytes() == direct[0].tobytes()
        assert profiler.autoscale_counters() == {}
        assert plan.summary()["autoscale_polls"] == 0
    finally:
        fleet.close()
    monkeypatch.setenv("MXTPU_SERVE_AUTOSCALE", "1")
    assert autoscale_enabled()


def test_inverted_hysteresis_refused():
    with pytest.raises(MXNetError, match="hysteresis"):
        Autoscaler(None, None, up_queue_rows=8, down_queue_rows=8)


def test_brownout_rung_cap_and_restore(blobs):
    fleet = _AutoFleet("port", blobs, n=1)
    try:
        srv = fleet.servers[0][0]
        base_batch = srv._queue.max_batch
        base_delay_s = srv._queue.max_delay_s
        assert fleet.router.enter_brownout(delay_factor=3.0, rung_cap=2)
        assert srv._queue.max_batch == 2
        assert srv._queue.max_delay_s == pytest.approx(0.015)
        assert not fleet.router.enter_brownout()
        assert fleet.router.exit_brownout()
        assert srv._queue.max_batch == base_batch
        assert srv._queue.max_delay_s == pytest.approx(base_delay_s)
        assert not fleet.router.exit_brownout()
    finally:
        fleet.close()


def test_deadline_shed_refused_not_queued_to_die(blobs):
    fleet = _AutoFleet("port", blobs, n=1)
    try:
        rep = fleet.router.replicas[0]
        rep.queue_rows, rep.p99_ms = 1000, 100.0
        reply = fleet.router.route_infer(
            "r1", _pinned_input(), ctx={"deadline_ms": 50.0})
        assert reply[0] == "err" and reply[2] == "overload"
        info = reply[4]
        assert info["reason"] == "deadline"
        assert 1.0 <= info["retry_after_ms"] <= 1000.0
        assert {"requested", "pending_rows", "limit"} <= set(info)
        assert profiler.autoscale_counters()["deadline_sheds"] == 1
        assert "deadline_shed" in [r.get("kind")
                                   for r in tele.flight_records()]
        assert "responses" not in profiler.router_counters()
        rep.queue_rows, rep.p99_ms = 0, 0.0
        reply = fleet.router.route_infer(
            "r2", _pinned_input(), ctx={"deadline_ms": 1e6})
        assert reply[0] == "ok"
    finally:
        fleet.close()


def test_priority_shed_only_in_brownout_and_client_stamps(blobs,
                                                           monkeypatch):
    fleet = _AutoFleet("port", blobs, n=1)
    try:
        assert fleet.router.route_infer(
            "r0", _pinned_input(), ctx={"priority": "low"})[0] == "ok"
        fleet.router.enter_brownout()
        reply = fleet.router.route_infer(
            "r1", _pinned_input(), ctx={"priority": "low"})
        assert reply[0] == "err" and reply[4]["reason"] == "priority"
        assert reply[4]["brownout"] is True
        assert fleet.router.route_infer(
            "r2", _pinned_input(), ctx={"priority": "high"})[0] == "ok"
        # a ServeClient stamps MXTPU_SERVE_PRIORITY into the frame's ctx
        monkeypatch.setenv("MXTPU_SERVE_PRIORITY", "low")
        host, port = fleet.router.serve("127.0.0.1", 0)
        with serving.ServeClient(host, port, retry_deadline=0.5,
                                 seed=0) as cli:
            with pytest.raises(ServerOverloadError):
                cli.infer(_pinned_input())
        with serving.ServeClient(host, port, retry_deadline=2.0, seed=0,
                                 priority="high") as cli:
            assert cli.infer(_pinned_input())[0].shape == (4, 3)
        assert profiler.autoscale_counters()["priority_sheds"] >= 2
    finally:
        fleet.close()


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_fault_plan_autoscale_hooks_and_spec(pkg):
    fi = PKGS[pkg].fault
    spikes, kills = [], []
    plan = fi.FaultPlan(traffic_spike_at=(2,), on_traffic_spike=spikes.append,
                        kill_replica_during_scale=(1,),
                        on_kill_replica_during_scale=kills.append)
    assert [plan.autoscale_poll_event() for _ in range(3)] == [1, 2, 3]
    assert spikes == [2]
    assert plan.scale_event() == 1 and kills == [1]
    s = plan.summary()
    assert s["traffic_spikes"] == 1 and s["scale_kills"] == 1
    assert s["autoscale_polls"] == 3 and s["scale_actions"] == 1
    p2 = fi.FaultPlan.from_spec(
        "traffic_spike_at=2+4,kill_replica_during_scale=1")
    assert p2.traffic_spike_at == frozenset({2, 4})
    assert p2.kill_replica_during_scale == frozenset({1})


def test_router_jitter_matches_reference():
    r1 = Router([("127.0.0.1", 1)], start_health=False, seed=3)
    r2 = jfleet.Router([("127.0.0.1", 1)], start_health=False, seed=3)
    try:
        assert [r1._jitter_rng.random() for _ in range(10)] == \
            [r2._jitter_rng.random() for _ in range(10)]
    finally:
        r1.close()
        r2.close()


def test_no_wall_clock_in_deadline_paths():
    """Every deadline, cooldown and backoff reads time.monotonic or an
    injected clock; the one wall-clock read of the serving planes is the
    replica's start-time identity in stats."""
    for mod in (tfleet, tautoscale):
        assert "time.time()" not in inspect.getsource(mod), mod.__name__
    lines = [ln for ln in inspect.getsource(serving).splitlines()
             if "time.time()" in ln]
    assert all("_start_time" in ln for ln in lines), lines
    for cls in (MicroBatchQueue, CircuitBreaker, ReplicaSupervisor,
                Autoscaler):
        sig = inspect.signature(cls.__init__)
        assert sig.parameters["clock"].default is time.monotonic, cls
