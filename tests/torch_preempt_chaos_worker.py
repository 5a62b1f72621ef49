"""Worker of the PyTorch port for `tests/test_torch_preempt_chaos.py` (the
counterpart of `tests/preempt_chaos_worker.py`; it imports neither JAX
nor the JAX package).

Two modes (``PREEMPT_MODE``):

* ``fit`` — trains the example MLP (`torch_chaos_mlp`) on the host under
  an activated `TrainingSupervisor` with MXTPU_CKPT_DIR auto-resume.  A
  real SIGTERM from the parent lands in the supervisor's chained
  handler, the loop stops at the next step boundary, writes the bounded
  mid-epoch checkpoint and exits `PREEMPTED_EXIT_CODE` (75) through
  ``main_guard``.  An uninterrupted (or resumed) run dumps its final arg
  params to ``PREEMPT_OUT`` (npz) and prints ``PREEMPT-DONE``.  Per-step
  lines: ``PREEMPT-STEP <epoch> <batch>`` (throttled by
  ``PREEMPT_STEP_SLEEP`` so the parent can aim a signal mid-epoch);
  driver counters on a ``DRIVER-COUNTERS`` line.

* ``dist`` — one slot of a 2-worker elastic PS job supervised by the
  parent's `TrainingSupervisor`: slot 1 attempt 0 parks after its first
  round (``WORKER-PARKED``) and is SIGKILLed; its fresh-identity
  respawn (attempt > 0, worker_id ``w<slot>r<attempt>``) `join()`s the
  membership plane and finishes the joint rounds; slot 0 survives the
  transition.  ``CHAOS_OK final=<v>`` marks completion.

Env: PREEMPT_MODE, PREEMPT_EPOCHS, PREEMPT_OUT, PREEMPT_STEP_SLEEP,
PREEMPT_SLOT, PREEMPT_ATTEMPT, ELASTIC_PORT (plus MXTPU_CKPT_DIR etc.
set by the parent).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

KEY = 0
#: key the survivor creates AFTER its solo rounds — the server-visible
#: signal the (immediately-respawned) replacement waits on before
#: join(), so the rejoin lands at a round boundary like the parent-
#: orchestrated elastic chaos test, not in the middle of a pending round
DONE_KEY = 1


def main_fit():
    from mxnet_tpu_torch import train_driver as drv
    import torch_chaos_mlp as M

    epochs = int(os.environ["PREEMPT_EPOCHS"])
    out = os.environ["PREEMPT_OUT"]
    step_sleep = float(os.environ.get("PREEMPT_STEP_SLEEP", "0"))

    def on_batch(param):
        print(f"PREEMPT-STEP {param.epoch} {param.nbatch}", flush=True)
        if step_sleep:
            time.sleep(step_sleep)

    sup = drv.TrainingSupervisor()
    sup.activate()
    assert sup.install_signal_handlers(), "driver off or not main thread"
    with sup.main_guard():  # TrainingPreempted -> sys.exit(75)
        mod = M.fit(epochs, batch_end_callback=on_batch)
    arg, _ = mod.get_params()
    np.savez(out, **{k: v.asnumpy() for k, v in arg.items()})
    drv.dump_counters(file=sys.stdout)
    print("PREEMPT-DONE", flush=True)


def main_dist():
    from mxnet_tpu_torch import ps_server

    slot = int(os.environ["PREEMPT_SLOT"])
    attempt = int(os.environ["PREEMPT_ATTEMPT"])
    port = int(os.environ["ELASTIC_PORT"])
    wid = f"w{slot}" + (f"r{attempt}" if attempt else "")
    client = ps_server.PSClient("127.0.0.1", port, worker_id=wid)

    def rounds(lo, hi, value):
        val = None
        for r in range(lo, hi + 1):
            client.push(KEY, np.full(2, value, np.float32))
            val = np.asarray(client.pull(KEY))
            print(f"ROUND {r} val={val[0]:.1f}", flush=True)
        return val

    def wait_membership(size, timeout=60):
        deadline = time.monotonic() + timeout
        while client.stats()["membership_size"] != size:
            if time.monotonic() > deadline:
                raise TimeoutError(f"membership never reached {size}")
            time.sleep(0.2)

    if slot == 0:
        # survivor: round 1 joint with the victim, rounds 2-5 solo once
        # the dead lease evicts it, then signal round-boundary reached
        # (DONE_KEY) and finish jointly with the respawned identity
        client.init(KEY, np.zeros(2, np.float32))
        rounds(1, 5, 1.0)
        client.init(DONE_KEY, np.ones(1, np.float32))
        print("WORKER-WAITING", flush=True)
        wait_membership(2)
        val = rounds(6, 8, 1.0)
        print(f"CHAOS_OK final={val[0]:.1f}", flush=True)
    elif attempt == 0:
        # victim: one round, then park for the parent's real SIGKILL
        client.init(KEY, np.zeros(2, np.float32))
        rounds(1, 1, 2.0)
        print("WORKER-PARKED", flush=True)
        time.sleep(600)
    else:
        # fresh-identity respawn: the supervisor restarts us within
        # ~0.1s of the SIGKILL — wait for the survivor's round-boundary
        # signal so the rejoin does not change membership under its
        # in-flight solo rounds, then join and finish the joint rounds
        deadline = time.monotonic() + 90
        while client.stats()["keys"] < 2:
            if time.monotonic() > deadline:
                raise TimeoutError("survivor never finished solo rounds")
            time.sleep(0.2)
        info = client.join()
        print(f"JOINED epoch={info['epoch']} rank={info['rank']}",
              flush=True)
        client.init(KEY, np.zeros(2, np.float32))
        val = rounds(6, 8, 2.0)
        print(f"CHAOS_OK final={val[0]:.1f}", flush=True)


def main():
    assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
    mode = os.environ.get("PREEMPT_MODE", "fit")
    if mode == "fit":
        main_fit()
    elif mode == "dist":
        main_dist()
    else:
        raise SystemExit(f"unknown PREEMPT_MODE {mode!r}")


if __name__ == "__main__":
    main()
