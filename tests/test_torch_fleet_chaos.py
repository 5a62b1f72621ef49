"""The port's fleet chaos lane, after `tests/test_fleet_chaos.py`:
real replica subprocesses (``python -m mxnet_tpu_torch.serving_fleet
--replica --ctx cpu``), a real SIGKILL in the middle of a rolling deploy,
continuous client traffic -- zero non-shed requests may be lost, the
supervisor must replace the killed process and the router must keep
answering throughout.  Marked slow, as the reference's lane is: it runs
three replica processes for tens of seconds."""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import fault_injection, profiler
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.serialization import dumps_ndarrays
from mxnet_tpu_torch.serving import ServeClient, ServerOverloadError
from mxnet_tpu_torch.serving_fleet import (ModelRegistry, ReplicaSupervisor,
                                     Router, spawn_replica_process)

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


def test_sigkill_mid_rolling_deploy_zero_nonshed_loss(tmp_path):
    profiler.reset_router_counters()
    blobs = {}
    for name in ("v1", "v2"):  # same weights: bitwise-equal canary
        blobs[name] = str(tmp_path / f"{name}.mxtblob")
        _mlp_predictor().export_compiled(blobs[name], dynamic_batch=True)

    reg = ModelRegistry()
    reg.register("v1", blobs["v1"])
    reg.register("v2", blobs["v2"])
    reg.set_current("v1")

    def spawn(slot):
        path, _ = reg.resolve(reg.current)
        return spawn_replica_process(path, version=reg.current,
                                     ctx="cpu", env=LADDER)

    canary = {"data": np.random.RandomState(1)
              .randn(4, 5).astype(np.float32)}
    # placeholder addresses: the supervisor repoints every slot via
    # set_replica_addr as it spawns the real processes
    router = Router([("127.0.0.1", 1)] * 3, registry=reg,
                    canary=canary, start_health=False,
                    breaker_failures=2, breaker_cooldown_s=0.3,
                    health_interval=0.1)
    sup = ReplicaSupervisor(spawn, slots=3, router=router,
                            backoff_base_s=0.1, backoff_max_s=0.5,
                            crash_limit=10, seed=0)
    victim = {}
    kill_done = threading.Event()

    def sigkill(dispatch_idx):
        proc = sup.procs[1]
        victim["pid"] = proc.pid
        os.kill(proc.pid, signal.SIGKILL)
        kill_done.set()

    plan = fault_injection.install(
        fault_injection.FaultPlan(kill_replica_at=(25,),
                                  on_kill_replica=sigkill))
    try:
        sup.start(monitor=True)
        router.health_cycle()  # learn identities before opening up
        router.start_health()
        addr = router.serve("127.0.0.1", 0)

        stop = threading.Event()
        lost, sheds, latencies = [], [0], []
        x = {"data": np.random.RandomState(2)
             .randn(4, 5).astype(np.float32)}

        def traffic(seed):
            with ServeClient(*addr, retry_deadline=20.0,
                             seed=seed) as cli:
                while not stop.is_set():
                    t0 = time.monotonic()
                    try:
                        cli.infer(x)
                        latencies.append(time.monotonic() - t0)
                    except ServerOverloadError:
                        sheds[0] += 1  # shed is a contract, not a loss
                    except Exception as e:
                        lost.append(e)
                        return
                    time.sleep(0.005)

        threads = [threading.Thread(target=traffic, args=(s,),
                                    daemon=True) for s in (0, 1)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        router.deploy("v2")  # the SIGKILL fires mid-deploy, by count
        assert kill_done.wait(timeout=20.0), \
            "chaos kill never fired: traffic too thin?"
        time.sleep(1.0)  # let the supervisor notice and respawn
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            proc = sup.procs[1]
            if proc.pid != victim["pid"] and proc.poll() is None:
                break
            time.sleep(0.1)
        else:
            pytest.fail("supervisor never replaced the killed replica")
        time.sleep(0.5)  # post-restart traffic through the new process
        stop.set()
        for t in threads:
            t.join(timeout=30.0)

        counters = profiler.router_counters()
        print("ROUTER-COUNTERS " + json.dumps(counters, sort_keys=True))
        print(f"CHAOS-SUMMARY served={len(latencies)} sheds={sheds[0]} "
              f"lost={len(lost)} "
              f"p99_s={np.percentile(latencies, 99):.3f}"
              if latencies else "CHAOS-SUMMARY no traffic")

        assert lost == [], f"non-shed requests lost: {lost!r}"
        assert len(latencies) > 50
        assert reg.current == "v2"
        assert counters.get("replica_restarts", 0) >= 1
        # every request the clients counted as served WAS served: the
        # p99 over the whole chaos window stays under the client retry
        # deadline with margin (bounded tail, not a hung fleet)
        assert float(np.percentile(latencies, 99)) < 10.0
    finally:
        fault_injection.clear()
        sup.stop()
        router.close()
