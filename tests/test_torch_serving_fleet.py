"""The port's fleet tier (`mxnet_tpu_torch.serving_fleet`) against the JAX
package's, after `tests/test_serving_fleet.py`: the circuit breaker, the
registry, FaultPlan's router hooks and the replica supervisor driven by
the same scripts in both packages (same transitions, backoffs and
counters), the retry_after_ms client contract against a scripted front
door, and the Router end to end over in-process CPU `ModelServer`
replicas (parity with a direct replica, failover, rolling deploy, canary
refusal and rollback, corrupt-blob rollback, generate through the
router), plus one real replica process (``--ctx cpu``) SIGKILLed and
respawned by the supervisor."""
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import fault_injection as jfault
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import serving_fleet as jfleet

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import fault_injection, profiler, ps_wire
from mxnet_tpu_torch import serving_fleet as tfleet
from mxnet_tpu_torch import telemetry as tele
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serialization import dumps_ndarrays
from mxnet_tpu_torch.serving import (CompiledModelPool, DrainTimeoutError,
                                     ModelServer, NoHealthyReplicaError,
                                     ServeClient, ServerOverloadError)
from mxnet_tpu_torch.serving_fleet import (CanaryMismatchError,
                                           ModelRegistry,
                                           ReplicaSupervisor, Router,
                                           fleet_enabled,
                                           spawn_replica_process)

CPU = mt.cpu()
PKGS = {"port": (tfleet, fault_injection, profiler),
        "reference": (jfleet, jfault, jprofiler)}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _mlp_predictor(batch=4, seed=0):
    data = mt.sym.var("data")
    fc1 = mt.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = mt.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mt.sym.FullyConnected(act, num_hidden=3, name="fc2")
    out = mt.sym.softmax(fc2, name="out")
    rng = np.random.RandomState(seed)
    params = dumps_ndarrays({k: mt.nd.array(v, ctx=CPU) for k, v in {
        "arg:fc1_weight": rng.randn(8, 5).astype(np.float32),
        "arg:fc1_bias": np.zeros(8, np.float32),
        "arg:fc2_weight": rng.randn(3, 8).astype(np.float32),
        "arg:fc2_bias": np.zeros(3, np.float32)}.items()})
    return Predictor(out.tojson(), params, {"data": (batch, 5)}, ctx=CPU)


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    """v1 and v2 share weights (a good deploy: the canary passes
    bitwise); v3 has other weights (the canary must refuse it)."""
    d = tmp_path_factory.mktemp("fleet_blobs")
    paths = {}
    for name, seed in [("v1", 0), ("v2", 0), ("v3", 7)]:
        p = str(d / f"{name}.mxtblob")
        _mlp_predictor(seed=seed).export_compiled(p, dynamic_batch=True)
        paths[name] = p
    return paths


def _pinned_input(rows=4, seed=1):
    return {"data": np.random.RandomState(seed)
            .randn(rows, 5).astype(np.float32)}


def _pool(blob, ladder=(4,)):
    return CompiledModelPool(blob, batch_ladder=list(ladder), devices=[CPU])


class _Fleet:
    """N in-process CPU ModelServer replicas + a Router with health
    driven by hand (start_health=False)."""

    def __init__(self, blob, n=3, version="v1", registry=None,
                 canary=None, **router_kw):
        self.servers = []
        addrs = []
        for _ in range(n):
            srv = ModelServer(_pool(blob), max_delay_ms=5.0,
                              model_version=version)
            addrs.append(srv.serve("127.0.0.1", 0))
            self.servers.append(srv)
        router_kw.setdefault("health_interval", 0.05)
        router_kw.setdefault("start_health", False)
        self.router = Router(addrs, registry=registry, canary=canary,
                             **router_kw)
        self.router.health_cycle()

    def close(self):
        self.router.close()
        for srv in self.servers:
            try:
                srv.close()
            except Exception:
                pass


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiler.reset_router_counters()
    jprofiler.reset_router_counters()
    yield
    fault_injection.clear()
    jfault.clear()


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# pure logic, the same script through both packages
# ---------------------------------------------------------------------------

def _breaker_script(fleet):
    clk = _Clock()
    log = []
    br = fleet.CircuitBreaker(failures=3, cooldown_s=2.0, clock=clk,
                              on_transition=lambda o, n, r:
                              log.append((o, n, r)))
    states = [br.state]
    for step in ("f", "f", "s", "f", "f", "f", "gate", "+2.5", "gate",
                 "f", "+2.5", "gate", "s", "f", "reset"):
        if step == "f":
            br.record_failure()
        elif step == "s":
            br.record_success()
        elif step == "gate":
            states.append(("gate", br.probe_gate()))
        elif step == "reset":
            br.reset()
        else:
            clk.t += float(step)
        states.append((br.state, br.allow()))
    return states, log


def test_breaker_transitions_match_reference():
    mine, ref = _breaker_script(tfleet), _breaker_script(jfleet)
    assert mine == ref
    states, log = mine
    assert ("closed", "open", "failure") in log
    assert ("open", "half_open", "cooldown_expired") in log
    assert ("half_open", "open", "probe_failed:failure") in log
    assert ("half_open", "closed", "recovered") in log


def test_breaker_opens_after_consecutive_failures():
    clk = _Clock()
    transitions = []
    br = tfleet.CircuitBreaker(failures=3, cooldown_s=2.0, clock=clk,
                               on_transition=lambda o, n, r:
                               transitions.append((o, n)))
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"
    br.record_success()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    assert transitions == [("closed", "open")]


def test_breaker_half_open_probe_decides():
    clk = _Clock()
    br = tfleet.CircuitBreaker(failures=1, cooldown_s=2.0, clock=clk)
    br.record_failure()
    assert br.state == "open"
    assert not br.probe_gate()
    clk.t += 2.5
    assert br.probe_gate()
    assert br.state == "half_open"
    assert not br.allow()
    br.record_failure()
    assert br.state == "open"
    clk.t += 2.5
    assert br.probe_gate()
    br.record_success()
    assert br.state == "closed" and br.allow()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fault_plan_router_dispatch_hooks(pkg):
    fi = PKGS[pkg][1]
    killed, hung = [], []
    plan = fi.FaultPlan(
        kill_replica_at=(2,), on_kill_replica=killed.append,
        hang_replica_at=(3,), on_hang_replica=hung.append,
        corrupt_blob_on_deploy=(1, 3))
    assert [plan.router_dispatch_event() for _ in range(3)] == [1, 2, 3]
    assert killed == [2] and hung == [3]
    assert [plan.deploy_event() for _ in range(3)] == [True, False, True]
    s = plan.summary()
    assert s["replica_kills"] == 1 and s["replica_hangs"] == 1
    assert s["blob_corruptions"] == 2
    assert s["router_dispatches"] == 3 and s["deploys"] == 3


def test_fault_plan_spec_roundtrip():
    plan = fault_injection.FaultPlan.from_spec(
        "kill_replica_at=2+5,corrupt_blob_on_deploy=1")
    assert plan.kill_replica_at == frozenset({2, 5})
    assert plan.corrupt_blob_on_deploy == frozenset({1})


class _FakeProc:
    def __init__(self, slot, gen):
        self.slot, self.gen = slot, gen
        self.dead = False
        self.returncode = None

    def poll(self):
        return -9 if self.dead else None

    def kill(self):
        self.dead = True


def _supervisor_script(fleet, prof):
    """Deaths in two slots, a crash loop and a window that ages out;
    returns the sleeps taken, the spawn order and the counters."""
    clk = _Clock()
    sleeps, spawned = [], []

    def spawn(slot):
        proc = _FakeProc(slot, len(spawned))
        spawned.append(slot)
        return proc, ("127.0.0.1", 9000 + len(spawned))

    sup = fleet.ReplicaSupervisor(spawn, slots=2, backoff_base_s=0.2,
                                  backoff_max_s=5.0, crash_window_s=5.0,
                                  crash_limit=3, seed=3, clock=clk,
                                  sleep=sleeps.append)
    sup.start(monitor=False)
    for slot, dt in ((0, 1.0), (0, 1.0), (1, 0.5), (0, 0.1), (0, 0.1),
                     (1, 10.0), (1, 1.0)):
        sup.procs[slot].dead = True
        sup.check_once()
        clk.t += dt
    out = (sleeps, spawned, sup.crash_looped,
           {k: prof.router_counters().get(k, 0)
            for k in ("replica_restarts", "crash_loop_opens")})
    sup.stop()
    return out


def test_supervisor_backoff_and_crash_loop_match_reference():
    mine = _supervisor_script(tfleet, profiler)
    ref = _supervisor_script(jfleet, jprofiler)
    assert mine == ref
    sleeps, spawned, looped, counters = mine
    assert looped == [True, False]
    assert counters["crash_loop_opens"] == 1
    assert 0.1 <= sleeps[0] < 0.3 and 0.2 <= sleeps[1] < 0.6


def test_supervisor_crash_loop_hits_flight_recorder():
    spawned = []

    def spawn(slot):
        proc = _FakeProc(slot, len(spawned))
        spawned.append(proc)
        return proc, ("127.0.0.1", 9100)

    sup = ReplicaSupervisor(spawn, slots=1, crash_window_s=30.0,
                            crash_limit=3, seed=0, clock=_Clock(),
                            sleep=lambda s: None)
    sup.start(monitor=False)
    for _ in range(3):
        sup.procs[0].dead = True
        sup.check_once()
    assert sup.crash_looped[0]
    n = len(spawned)
    sup.procs[0].dead = True
    sup.check_once()
    assert len(spawned) == n
    assert any(r.get("kind") == "crash_loop"
               for r in tele.flight_records())
    sup.stop()


def test_registry_register_resolve_and_versions(blobs, tmp_path):
    reg = ModelRegistry()
    reg.register("v1", blobs["v1"])
    reg.register("v2", blobs["v2"])
    path, crc = reg.resolve("v1")
    assert path == blobs["v1"] and isinstance(crc, int)
    assert sorted(reg.versions()) == ["v1", "v2"]
    with pytest.raises(MXNetError, match="v1"):
        reg.resolve("nope")
    bad = str(tmp_path / "bad.mxtblob")
    data = bytearray(open(blobs["v1"], "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(bad, "wb").write(bytes(data))
    with pytest.raises(MXNetError):
        reg.register("bad", bad)
    assert "bad" not in reg.versions()


def test_registry_current_previous_match_reference(tmp_path):
    out = []
    for fleet in (tfleet, jfleet):
        reg = fleet.ModelRegistry()
        seen = [(reg.current, reg.previous)]
        for v in ("v1", "v2"):
            p = tmp_path / v
            p.write_bytes(b"not a real blob")
            reg.register(v, str(p), verify=False)
        for v in ("v1", "v2", "v2", "v1"):
            reg.set_current(v)
            seen.append((reg.current, reg.previous))
        out.append(seen)
    assert out[0] == out[1]
    assert out[0][-1] == ("v1", "v2")


def test_fleet_kill_switch(monkeypatch):
    monkeypatch.setenv("MXTPU_SERVE_FLEET", "0")
    assert not fleet_enabled()
    with pytest.raises(MXNetError, match="MXTPU_SERVE_FLEET"):
        Router([("127.0.0.1", 1)], start_health=False)
    monkeypatch.setenv("MXTPU_SERVE_FLEET", "1")
    assert fleet_enabled()


# ---------------------------------------------------------------------------
# retry_after_ms client contract (scripted front door, no model)
# ---------------------------------------------------------------------------

def _scripted_front_door(replies):
    received = []
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def run():
        conn, _ = srv.accept()
        try:
            while True:
                msg = ps_wire.recv_frame(conn)
                if msg is None:
                    return
                received.append(msg)
                idx = min(len(received), len(replies)) - 1
                ps_wire.send_frame(conn, replies[idx](msg))
        except (ps_wire.WireError, OSError):
            pass
        finally:
            conn.close()

    threading.Thread(target=run, daemon=True).start()
    return srv.getsockname()[:2], received, srv.close


def _overload_reply(hint):
    def make(msg):
        info = {"requested": 4, "pending_rows": 32, "limit": 32}
        if hint is not None:
            info["retry_after_ms"] = hint
        return ps_wire.err_frame(msg[1], "overload", "queue full", info)
    return make


def test_client_honors_retry_after_hint():
    addr, received, closer = _scripted_front_door([
        _overload_reply(hint=10.0),
        lambda msg: ("ok", msg[1], [np.zeros((4, 3), np.float32)]),
    ])
    try:
        cli = ServeClient(*addr, retry_deadline=5.0, seed=0)
        out = cli.infer(_pinned_input())
        assert len(out) == 1 and out[0].shape == (4, 3)
        assert len([m for m in received if m[0] == "infer"]) == 2
        cli.close()
    finally:
        closer()


def test_client_never_retries_hintless_shed():
    addr, received, closer = _scripted_front_door(
        [_overload_reply(hint=None)])
    try:
        cli = ServeClient(*addr, retry_deadline=5.0)
        with pytest.raises(ServerOverloadError) as ei:
            cli.infer(_pinned_input())
        assert ei.value.retry_after_ms is None
        assert len([m for m in received if m[0] == "infer"]) == 1
        cli.close()
    finally:
        closer()


# ---------------------------------------------------------------------------
# router end to end over in-process CPU replicas
# ---------------------------------------------------------------------------

def test_router_parity_bitwise(blobs):
    fleet = _Fleet(blobs["v1"], n=2)
    try:
        x = _pinned_input()
        direct = fleet.servers[0].infer(x)
        for _ in range(4):
            routed = fleet.router.infer(x)
            assert len(routed) == len(direct)
            for a, b in zip(routed, direct):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        c = profiler.router_counters()
        assert c.get("requests", 0) == c.get("responses", 0) == 4
        assert c.get("failovers", 0) == 0
    finally:
        fleet.close()


def test_reference_client_through_port_router(blobs):
    """The JAX package's ServeClient talks to the port's router front
    door (the same wire), stats included."""
    from mxnet_tpu.serving import ServeClient as JaxClient
    fleet = _Fleet(blobs["v1"], n=2)
    try:
        addr = fleet.router.serve("127.0.0.1", 0)
        x = _pinned_input()
        with JaxClient(*addr, retry_deadline=5.0) as cli:
            got = cli.infer(x)
            assert cli.ping()
            st = cli.stats()
        assert got[0].tobytes() == fleet.servers[0].infer(x)[0].tobytes()
        assert [r["model_version"] for r in st["replicas"]] == ["v1", "v1"]
    finally:
        fleet.close()


def test_front_door_stats_and_replica_identity(blobs):
    fleet = _Fleet(blobs["v1"], n=2, version="v1")
    try:
        with ServeClient(*fleet.servers[0].address) as direct:
            st = direct.stats()
        assert st["model_version"] == "v1"
        assert isinstance(st["blob_crc"], int)
        assert st["pid"] == os.getpid()
        assert st["draining"] is False
        snap = fleet.router.fleet_stats()
        assert [r["model_version"] for r in snap["replicas"]] == ["v1", "v1"]
        assert all(r["blob_crc"] == st["blob_crc"]
                   for r in snap["replicas"])
    finally:
        fleet.close()


def test_failover_past_dead_replica(blobs):
    fleet = _Fleet(blobs["v1"], n=2, breaker_failures=1)
    try:
        fleet.servers[0].close()
        x = _pinned_input()
        for _ in range(4):
            assert len(fleet.router.infer(x)) == 1
        c = profiler.router_counters()
        assert c.get("responses", 0) == 4
        assert c.get("failovers", 0) + c.get("drain_bounces", 0) >= 1
        assert fleet.router.replicas[0].breaker.state == "open"
        before = profiler.router_counters().get("health_probes", 0)
        fleet.router.health_cycle()
        assert profiler.router_counters().get("health_probes", 0) == \
            before + 1
    finally:
        fleet.close()


def test_failover_past_unreachable_replica(blobs):
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))
    dead_addr = probe.getsockname()[:2]
    probe.close()
    srv = ModelServer(_pool(blobs["v1"]), model_version="v1")
    live_addr = srv.serve("127.0.0.1", 0)
    router = Router([dead_addr, live_addr], start_health=False,
                    breaker_failures=1)
    try:
        for _ in range(3):
            assert len(router.infer(_pinned_input())) == 1
        c = profiler.router_counters()
        assert c.get("responses", 0) == 3
        assert c.get("failovers", 0) >= 1
        assert router.replicas[0].breaker.state == "open"
    finally:
        router.close()
        srv.close()


def test_no_healthy_replica_error(blobs):
    fleet = _Fleet(blobs["v1"], n=1, breaker_failures=1)
    try:
        fleet.servers[0].close()
        with pytest.raises(NoHealthyReplicaError) as ei:
            fleet.router.infer(_pinned_input())
        with pytest.raises(NoHealthyReplicaError):
            fleet.router.infer(_pinned_input())
        assert ei.value.wire_info()["replicas"] == 1
        assert any(r.get("kind") == "no_healthy_replica"
                   for r in tele.flight_records())
    finally:
        fleet.close()


def _registry_for(blobs, *versions):
    reg = ModelRegistry()
    for v in versions:
        reg.register(v, blobs[v])
    reg.set_current(versions[0])
    return reg


def test_rolling_deploy_zero_loss(blobs):
    reg = _registry_for(blobs, "v1", "v2")
    fleet = _Fleet(blobs["v1"], n=3, registry=reg, canary=_pinned_input())
    try:
        addr = fleet.router.serve("127.0.0.1", 0)
        x = _pinned_input()
        baseline = fleet.router.infer(x)
        stop = threading.Event()
        errors, served = [], [0]

        def traffic():
            with ServeClient(*addr, retry_deadline=10.0) as cli:
                while not stop.is_set():
                    try:
                        cli.infer(x)
                        served[0] += 1
                    except Exception as e:
                        errors.append(e)
                        return

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        time.sleep(0.05)
        fleet.router.deploy("v2")
        time.sleep(0.05)
        stop.set()
        t.join(timeout=10.0)
        assert errors == [] and served[0] > 0
        assert reg.current == "v2" and reg.previous == "v1"
        fleet.router.health_cycle()
        snap = fleet.router.fleet_stats()
        assert [r["model_version"] for r in snap["replicas"]] == ["v2"] * 3
        assert fleet.router.infer(x)[0].tobytes() == baseline[0].tobytes()
        c = profiler.router_counters()
        assert c.get("hot_swaps", 0) == 3 and c.get("canary_passes", 0) == 3
        assert c.get("deploys", 0) == 1 and c.get("deploy_failures", 0) == 0
    finally:
        fleet.close()


def test_canary_mismatch_aborts_and_rolls_back(blobs):
    reg = _registry_for(blobs, "v1", "v3")
    fleet = _Fleet(blobs["v1"], n=2, registry=reg, canary=_pinned_input())
    try:
        x = _pinned_input()
        baseline = fleet.router.infer(x)
        with pytest.raises(CanaryMismatchError):
            fleet.router.deploy("v3")
        assert reg.current == "v1"
        fleet.router.health_cycle()
        snap = fleet.router.fleet_stats()
        assert [r["model_version"] for r in snap["replicas"]] == ["v1", "v1"]
        assert fleet.router.infer(x)[0].tobytes() == baseline[0].tobytes()
        c = profiler.router_counters()
        assert c.get("canary_mismatches", 0) == 1
        assert c.get("deploy_failures", 0) == 1 and c.get("deploys", 0) == 0
        assert c.get("rollbacks", 0) >= 1
        assert any(r.get("kind") == "canary_mismatch"
                   for r in tele.flight_records())
    finally:
        fleet.close()


def _int8_predictor(pkg, ctx_kw, dumps, batch=4):
    """int8 enters as int8 (``input_types``) and dequantizes in the
    graph, the JAX fleet test's model."""
    data = pkg.sym.var("data")
    x = pkg.sym.Cast(data, dtype="float32", name="deq") * (1.0 / 127.0)
    fc = pkg.sym.FullyConnected(x, num_hidden=3, name="fc")
    rng = np.random.RandomState(7)
    params = dumps({
        "arg:fc_weight": pkg.nd.array(rng.randn(3, 6).astype(np.float32),
                                      **ctx_kw),
        "arg:fc_bias": pkg.nd.array(np.zeros(3, np.float32), **ctx_kw)})
    return pkg.Predictor(fc.tojson(), params, {"data": (batch, 6)},
                         input_types={"data": np.int8}, **ctx_kw)


def test_int8_blobs_through_router_end_to_end(tmp_path):
    """int8 blobs on the whole fleet path, as the JAX package's test:
    registered, routed bit-equal to a direct pool run, hot-swapped to a
    second int8 version and still bit-equal; the values equal the JAX
    package's Predictor on the same input."""
    import mxnet_tpu as mx
    from mxnet_tpu.serialization import dumps_ndarrays as jdumps
    blob_i1 = str(tmp_path / "i1.mxtblob")
    blob_i2 = str(tmp_path / "i2.mxtblob")
    for blob in (blob_i1, blob_i2):
        _int8_predictor(mt, {"ctx": CPU}, dumps_ndarrays).export_compiled(
            blob, dynamic_batch=True)
    reg = ModelRegistry()
    reg.register("i1", blob_i1)
    reg.register("i2", blob_i2)
    reg.set_current("i1")
    x = {"data": np.random.RandomState(8).randint(
        -128, 128, size=(4, 6)).astype(np.int8)}
    ref = _int8_predictor(mx, {}, jdumps)
    ref.forward(**x)
    fleet = _Fleet(blob_i1, n=2, version="i1", registry=reg, canary=x)
    try:
        pool = _pool(blob_i1)
        assert pool.input_dtypes["data"] == np.int8
        direct = pool.run(x)[0]
        np.testing.assert_allclose(direct, np.asarray(ref.get_output(0)),
                                   rtol=1e-5, atol=1e-6)
        for _ in range(4):
            routed = fleet.router.infer(x)
            assert routed[0].dtype == direct.dtype
            assert routed[0].tobytes() == direct.tobytes()
        fleet.router.deploy("i2")
        fleet.router.health_cycle()
        snap = fleet.router.fleet_stats()
        assert [r["model_version"] for r in snap["replicas"]] == ["i2"] * 2
        assert fleet.router.infer(x)[0].tobytes() == direct.tobytes()
        c = profiler.router_counters()
        assert c.get("hot_swaps", 0) == 2 and c.get("canary_passes", 0) == 2
        assert c.get("deploy_failures", 0) == 0
    finally:
        fleet.close()


def test_corrupt_blob_deploy_rolls_back(blobs):
    reg = _registry_for(blobs, "v1", "v2")
    fleet = _Fleet(blobs["v1"], n=2, registry=reg, canary=_pinned_input())
    try:
        plan = fault_injection.install(
            fault_injection.FaultPlan(corrupt_blob_on_deploy=(1,)))
        x = _pinned_input()
        baseline = fleet.router.infer(x)
        with pytest.raises(MXNetError):
            fleet.router.deploy("v2")
        assert plan.summary()["blob_corruptions"] == 1
        assert reg.current == "v1"
        assert fleet.router.infer(x)[0].tobytes() == baseline[0].tobytes()
        fault_injection.clear()
        fleet.router.deploy("v2")
        assert reg.current == "v2"
    finally:
        fleet.close()


def test_instant_rollback_and_front_door_ops(blobs):
    reg = _registry_for(blobs, "v1", "v2")
    fleet = _Fleet(blobs["v1"], n=2, registry=reg, canary=_pinned_input())
    try:
        fleet.router.deploy("v2")
        swaps = profiler.router_counters().get("hot_swaps", 0)
        assert fleet.router.rollback() == "v1"
        assert reg.current == "v1" and reg.previous == "v2"
        assert profiler.router_counters().get("hot_swaps", 0) == swaps + 2
        addr = fleet.router.serve("127.0.0.1", 0)
        s = socket.create_connection(addr)
        try:
            ps_wire.send_frame(s, ("deploy", 1, {"version": "v2"}))
            assert ps_wire.recv_frame(s)[:2] == ("ok", 1)
            assert reg.current == "v2"
            ps_wire.send_frame(s, ("rollback", 2))
            reply = ps_wire.recv_frame(s)
            assert reply[:2] == ("ok", 2) and reply[2]["version"] == "v1"
            ps_wire.send_frame(s, ("deploy", 3, {"version": "ghost"}))
            reply = ps_wire.recv_frame(s)
            assert reply[0] == "err" and reply[2] == "deploy_failed"
        finally:
            s.close()
    finally:
        fleet.close()


def test_drain_timeout_hits_flight_recorder(blobs):
    srv = ModelServer(_pool(blobs["v1"]), model_version="v1")
    try:
        with srv._cond:
            srv._inflight += 1
        with pytest.raises(DrainTimeoutError) as ei:
            srv.wait_drained(timeout=0.05)
        assert ei.value.inflight == 1
        assert any(r.get("kind") == "drain_timeout"
                   for r in tele.flight_records())
    finally:
        with srv._cond:
            srv._inflight -= 1
        srv.close()


def test_half_open_capacity_never_spent_on_user_traffic(blobs):
    fleet = _Fleet(blobs["v1"], n=2, breaker_failures=1,
                   breaker_cooldown_s=0.05)
    try:
        rep0 = fleet.router.replicas[0]
        addr0 = rep0.addr
        fleet.servers[0].close()
        fleet.router.health_cycle()
        assert rep0.breaker.state == "open"
        time.sleep(0.06)
        outs = [fleet.router.infer(_pinned_input()) for _ in range(4)]
        assert len(outs) == 4 and rep0.breaker.state == "open"
        r = profiler.router_counters()
        assert r.get("failovers", 0) == 0 and r.get("replica_errors", 0) == 0
        srv = ModelServer(_pool(blobs["v1"]), max_delay_ms=5.0,
                          model_version="v1")
        srv.serve(addr0[0], addr0[1])
        fleet.servers[0] = srv
        fleet.router.health_cycle()
        assert rep0.breaker.state == "closed" and rep0.breaker.allow()
        snap = profiler.metrics_snapshot()
        assert snap["router"].get("breaker_open", 0) >= 1
        assert "autoscale" in snap
    finally:
        fleet.close()


def test_router_generate_failover_and_parity():
    """``generate`` through the router with the infer lane's failover:
    bit-equal to the sequential oracle, and to the JAX package's oracle,
    before and after one replica dies."""
    from mxnet_tpu import generation as jgen
    from mxnet_tpu_torch.generation import (DecodeEngine, DecodeService,
                                            make_tanh_rnn_cell)
    cell = make_tanh_rnn_cell(vocab=16, embed=8, hidden=16, seed=0, ctx=CPU)
    servers, addrs = [], []
    for _ in range(2):
        eng = DecodeEngine(cell, slots=2, chunk_steps=4, max_prompt=8,
                           max_tokens=16)
        srv = ModelServer(CompiledModelPool(_mlp_predictor(),
                                            batch_ladder=[4],
                                            devices=[CPU]),
                          max_delay_ms=5.0, model_version="v1",
                          decode=DecodeService(eng, continuous=True,
                                               queue_limit=8))
        addrs.append(srv.serve("127.0.0.1", 0))
        servers.append(srv)
    router = Router(addrs, start_health=False, health_interval=0.05)
    try:
        router.health_cycle()
        snap = router.fleet_stats()
        assert all(r.get("gen_slots") == 2 for r in snap["replicas"])
        rng = np.random.RandomState(9)
        prompts = [rng.randint(0, 16, size=4).astype(np.int32)
                   for _ in range(4)]
        want = jgen.DecodeEngine(
            jgen.make_tanh_rnn_cell(vocab=16, embed=8, hidden=16, seed=0),
            slots=2, chunk_steps=4, max_prompt=8,
            max_tokens=16).decode_sequential(prompts, [6] * 4)
        for p, w in zip(prompts, want):
            assert np.array_equal(router.generate(p, max_new_tokens=6), w)
        servers[0].close()
        for p, w in zip(prompts, want):
            assert np.array_equal(router.generate(p, max_new_tokens=6), w)
        c = profiler.router_counters()
        assert c.get("responses", 0) >= 8 and c.get("failovers", 0) >= 1
    finally:
        router.close()
        for s in servers:
            try:
                s.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# one real replica process
# ---------------------------------------------------------------------------

def test_replica_process_sigkilled_and_respawned(blobs):
    """``python -m mxnet_tpu_torch.serving_fleet --replica --ctx cpu``:
    a request through the router, a SIGKILL, the supervisor's respawn,
    and a health probe readmitting the slot."""
    spawn = lambda slot: spawn_replica_process(  # noqa: E731
        blobs["v1"], version="v1", ctx="cpu", ready_timeout=60.0,
        env={"MXTPU_SERVE_BATCH_LADDER": "4"})
    router = Router([("127.0.0.1", 1)], start_health=False,
                    breaker_failures=1)
    sup = ReplicaSupervisor(spawn, slots=1, router=router,
                            backoff_base_s=0.01, seed=0)
    try:
        sup.start(monitor=False)
        router.health_cycle()
        x = _pinned_input()
        want = _pool(blobs["v1"]).run(x)[0]
        assert router.infer(x)[0].tobytes() == want.tobytes()
        pid = sup.procs[0].pid
        assert router.replicas[0].pid == pid
        os.kill(pid, signal.SIGKILL)
        sup.procs[0].wait(timeout=10.0)
        with pytest.raises(NoHealthyReplicaError):
            router.infer(x)
        sup.check_once()
        assert sup.procs[0].pid != pid and sup.procs[0].poll() is None
        router.health_cycle()
        assert router.replicas[0].breaker.state == "closed"
        assert router.replicas[0].pid == sup.procs[0].pid
        assert router.infer(x)[0].tobytes() == want.tobytes()
        assert profiler.router_counters().get("replica_restarts", 0) == 1
    finally:
        sup.stop()
        router.close()


def test_replica_without_cuda_refuses_the_cpu(blobs):
    """A replica asked for the card on a box without CUDA raises rather
    than serve on the CPU."""
    import subprocess
    import sys
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.serving_fleet",
         "--replica", "--blob", blobs["v1"]], capture_output=True,
        text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "REPLICA-READY" not in proc.stdout
