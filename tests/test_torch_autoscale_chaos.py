"""The port's autoscale chaos lane, after `tests/test_autoscale_chaos.py`:
real replica subprocesses (``--ctx cpu``) behind the Router, a ~10x
no-backoff traffic spike, and a real SIGKILL inside the scale-up's
spawn-to-warm-up window.  The Autoscaler must grow the fleet (the
newcomer takes no traffic until a probe passes), the supervisor must
respawn the killed fresh replica, zero non-shed requests may be lost,
and once the spike passes the fleet must return to its floor.  Marked
slow, as the reference's lane is."""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import fault_injection, profiler
from mxnet_tpu_torch.autoscale import Autoscaler
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serialization import dumps_ndarrays
from mxnet_tpu_torch.serving import ServeClient, ServerOverloadError
from mxnet_tpu_torch.serving_fleet import (ReplicaSupervisor, Router,
                                     spawn_replica_process)

pytestmark = pytest.mark.slow

LADDER = {"MXTPU_SERVE_BATCH_LADDER": "1,2,4,8"}


def _mlp_predictor(batch=4, seed=0):
    data = mt.sym.var("data")
    fc1 = mt.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = mt.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = mt.sym.FullyConnected(act, num_hidden=3, name="fc2")
    out = mt.sym.softmax(fc2, name="out")
    rng = np.random.RandomState(seed)
    cpu = mt.cpu()
    params = dumps_ndarrays({
        "arg:fc1_weight": mt.nd.array(rng.randn(8, 5).astype(np.float32),
                                      ctx=cpu),
        "arg:fc1_bias": mt.nd.array(np.zeros(8, np.float32), ctx=cpu),
        "arg:fc2_weight": mt.nd.array(rng.randn(3, 8).astype(np.float32),
                                      ctx=cpu),
        "arg:fc2_bias": mt.nd.array(np.zeros(3, np.float32), ctx=cpu),
    })
    return Predictor(out.tojson(), params, {"data": (batch, 5)}, ctx=cpu)


def test_spike_scales_up_sigkill_mid_scale_then_back_to_floor(tmp_path):
    profiler.reset_router_counters()
    profiler.reset_autoscale_counters()
    blob = str(tmp_path / "v1.mxtblob")
    _mlp_predictor().export_compiled(blob, dynamic_batch=True)

    def spawn(slot):
        return spawn_replica_process(blob, version="v1", ctx="cpu",
                                     env=LADDER)

    canary = {"data": np.random.RandomState(1)
              .randn(4, 5).astype(np.float32)}
    floor = 2
    router = Router([("127.0.0.1", 1)] * floor, canary=canary,
                    start_health=False, breaker_failures=2,
                    breaker_cooldown_s=0.3, health_interval=0.1)
    sup = ReplicaSupervisor(spawn, slots=floor, router=router,
                            backoff_base_s=0.1, backoff_max_s=0.5,
                            crash_limit=10, seed=0)
    scale_kill = {}

    def sigkill_mid_scale(_scale_idx):
        proc = sup.procs[-1]  # the replica add_slot just spawned
        scale_kill["pid"] = proc.pid
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    plan = fault_injection.install(fault_injection.FaultPlan(
        kill_replica_during_scale=(1,),
        on_kill_replica_during_scale=sigkill_mid_scale))
    scaler = None
    stop = threading.Event()
    spike_stop = threading.Event()
    try:
        sup.start(monitor=True)
        router.health_cycle()
        router.start_health()
        addr = router.serve("127.0.0.1", 0)

        lost, sheds, latencies = [], [0], []
        x = {"data": np.random.RandomState(2)
             .randn(4, 5).astype(np.float32)}

        def traffic(seed, spike):
            with ServeClient(*addr, retry_deadline=10.0,
                             seed=seed) as cli:
                while not (spike_stop if spike else stop).is_set():
                    t0 = time.monotonic()
                    try:
                        cli.infer(x)
                        latencies.append(time.monotonic() - t0)
                    except ServerOverloadError:
                        sheds[0] += 1  # shed is a contract, not a loss
                    except Exception as e:
                        lost.append(e)
                        return
                    if not spike:
                        time.sleep(0.02)

        base = [threading.Thread(target=traffic, args=(s, False),
                                 daemon=True) for s in (0, 1)]
        for t in base:
            t.start()
        time.sleep(0.3)

        # the up/down gap is sized for real-replica noise: a stats poll
        # that catches a single queued 4-row micro-batch reads mean
        # pressure 4/3 — that must land BELOW the idle watermark, not
        # in the dead band, or the idle window never completes
        scaler = Autoscaler(router, sup, min_replicas=floor,
                            max_replicas=floor + 1, up_queue_rows=6,
                            down_queue_rows=2, idle_window_s=1.5,
                            cooldown_s=1.0, interval_s=0.2,
                            warmup_timeout_s=120.0, drain_wait_s=5.0,
                            seed=0)
        scaler.start()
        spike = [threading.Thread(target=traffic, args=(10 + s, True),
                                  daemon=True) for s in range(12)]
        for t in spike:
            t.start()

        # the spike must force a scale-up; the chaos SIGKILL murders
        # the fresh replica before warm-up, the supervisor respawns it,
        # and the warm-up gate must still promote it (warmups >= 1)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            c = profiler.autoscale_counters()
            if c.get("scale_ups", 0) >= 1 and c.get("warmups", 0) >= 1:
                break
            time.sleep(0.2)
        else:
            pytest.fail("autoscaler never grew the fleet under the "
                        "spike (or the newcomer never passed warm-up)")
        assert scale_kill.get("pid"), "chaos SIGKILL never armed"
        time.sleep(0.5)  # spike traffic through the grown fleet
        spike_stop.set()
        for t in spike:
            t.join(timeout=30.0)

        # recovery: only the base trickle remains -> sustained idle
        # -> one replica drained + retired -> back at the floor
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            c = profiler.autoscale_counters()
            n_active = sum(1 for r in router.replicas
                           if r.state == "active")
            if (n_active == floor and c.get("scale_downs", 0) >= 1
                    and not router.brownout):
                break
            time.sleep(0.2)
        else:
            pytest.fail("fleet never scaled back down to its floor")
        stop.set()
        for t in base:
            t.join(timeout=30.0)
        scaler.stop()

        counters = profiler.router_counters()
        auto = profiler.autoscale_counters()
        summary = plan.summary()
        print("ROUTER-COUNTERS " + json.dumps(counters, sort_keys=True))
        print("AUTOSCALE-COUNTERS " + json.dumps(auto, sort_keys=True))
        print(f"CHAOS-SUMMARY served={len(latencies)} sheds={sheds[0]} "
              f"lost={len(lost)} "
              f"p99_s={np.percentile(latencies, 99):.3f}"
              if latencies else "CHAOS-SUMMARY no traffic")

        assert lost == [], f"non-shed requests lost: {lost!r}"
        assert len(latencies) > 50
        assert auto.get("scale_ups", 0) >= 1
        assert auto.get("warmups", 0) >= 1, \
            "the respawned replica never passed warm-up"
        assert auto.get("scale_downs", 0) >= 1
        assert summary.get("scale_kills", 0) == 1
        assert counters.get("replica_restarts", 0) >= 1, \
            "supervisor never respawned the SIGKILLed fresh replica"
        # the scaled-down slot is retired, never respawned
        assert any(r.state == "retired" for r in router.replicas)
        assert sum(1 for r in router.replicas
                   if r.state == "active") == floor
        # bounded tail through spike + SIGKILL: under the client retry
        # deadline with margin (bounded, not a hung fleet)
        assert float(np.percentile(latencies, 99)) < 10.0
    finally:
        fault_injection.clear()
        spike_stop.set()
        stop.set()
        if scaler is not None:
            scaler.stop()
        sup.stop()
        router.close()
