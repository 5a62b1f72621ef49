"""Chaos-test worker of the PyTorch port for `tests/test_torch_dist_chaos.py`
(the counterpart of `tests/ps_chaos_worker.py`): joins the parent's
KVStoreServer over TCP, runs sync push/pull rounds, and reports what the
fault-tolerant transport did — in machine-greppable lines:

* ``VICTIM_READY``      — the designated victim finished round 1 and is
  now idle, waiting for the parent's SIGKILL;
* ``DEAD_WORKER_ERR worker=<wid>`` — a survivor's blocked pull/barrier
  failed with the structured dead-worker error (default degradation);
* ``CHAOS_OK final=<v>`` — all rounds completed (eviction mode: rounds
  past the kill apply at the reduced membership count);
* ``PS-CLIENT-COUNTERS {...}`` — the transport retry counters, surfaced
  in the CI log on failure.

Faults can additionally be injected into this worker's transport via
the MXTPU_PS_FAULT_PLAN env hook (`mxnet_tpu_torch.fault_injection`).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from mxnet_tpu_torch import ps_server  # noqa: E402


def main():
    assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
    rank = int(os.environ["CHAOS_RANK"])
    rounds = int(os.environ["CHAOS_ROUNDS"])
    victim = int(os.environ.get("CHAOS_VICTIM", "-1"))
    port = int(os.environ["CHAOS_PORT"])
    client = ps_server.PSClient("127.0.0.1", port, worker_id=f"w{rank}")
    key = 0
    client.init(key, np.zeros(4, np.float32))
    val = None
    for r in range(1, rounds + 1):
        client.push(key, np.full(4, float(rank + 1), np.float32))
        if rank == victim:
            # round-1 contribution is in; park here so the parent's
            # SIGKILL lands mid-round-2 from the fabric's point of view
            print("VICTIM_READY", flush=True)
            time.sleep(600)
        try:
            val = np.asarray(client.pull(key))
        except ps_server.DeadWorkerError as e:
            print(f"DEAD_WORKER_ERR worker={e.worker}", flush=True)
            print("PS-CLIENT-COUNTERS", client.counters, flush=True)
            return 0
        print(f"ROUND {r} val={val[0]:.1f}", flush=True)
    print(f"CHAOS_OK final={val[0]:.1f}", flush=True)
    print("PS-CLIENT-COUNTERS", client.counters, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
