"""Embedding-chaos worker of the PyTorch port for
`tests/test_torch_embed_chaos.py` (the counterpart of
`tests/embed_chaos_worker.py`; its table's rows land on the host): connects an
`EmbeddingPlane` to the parent's KVStoreServer and plays one role in a
sync-mode sharded-embedding run that loses a real process mid-epoch —
in machine-greppable lines:

* ``VICTIM_READY``  — the victim finished round 1 and is idle, waiting
  for the parent's real SIGKILL;
* ``SURVIVOR_WAITING`` — the survivor finished its solo rounds (lease
  eviction unblocked them) and now polls membership for the rejoin;
* ``CHAOS_OK final=<v>`` — the role completed every round; ``<v>`` is
  the touched rows' value after the last joint round (no-optimizer
  embed rounds accumulate each round's aggregated sum, so round 1
  (1+2) + solo rounds 2..5 (4*1) + joint rounds 6..8 (3*(1+2)) must
  read 16.0 from every process);
* ``EMBED-COUNTERS {...}`` — the profiler embed family for the CI log.

Roles (EMBED_ROLE):

* ``survivor``     — joint round 1, solo rounds 2..5 (the victim dies
  mid-epoch; eviction lets the pending round complete at reduced
  membership), then joint rounds 6..8 with the replacement;
* ``victim``       — round 1, then parks for SIGKILL;
* ``replacement``  — joins under a FRESH worker_id, opens the existing
  table, and runs joint rounds 6..8 (its push cursor fast-forwards to
  the in-flight round — no lost or doubled row updates).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from mxnet_tpu_torch import cpu, profiler  # noqa: E402
from mxnet_tpu_torch.embedding_plane import EmbeddingPlane  # noqa: E402

VOCAB, DIM = 32, 2
ROWS = np.array([0, 3, 7], np.int64)


def _table(plane):
    # no optimizer: each sync round accumulates its aggregated sum onto
    # exactly the touched rows — final values are exact integers
    return plane.table("emb", VOCAB, DIM, init="zeros", ctx=cpu())


def _wait_membership(plane, size, timeout=60):
    deadline = time.monotonic() + timeout
    while plane.clients[0].stats()["membership_size"] != size:
        if time.monotonic() > deadline:
            raise TimeoutError(f"membership never reached {size}")
        time.sleep(0.2)


def _rounds(tbl, lo, hi, value):
    val = None
    for r in range(lo, hi + 1):
        lk = tbl.lookup(ROWS)
        tbl.push_grad(lk, np.full((len(ROWS), DIM), value, np.float32))
        val = np.asarray(tbl.lookup(ROWS).value)  # blocks on the round
        print(f"ROUND {r} val={val[0, 0]:.1f}", flush=True)
    return val


def main():
    assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
    role = os.environ["EMBED_ROLE"]
    port = int(os.environ["EMBED_PORT"])
    wid = os.environ["EMBED_WID"]
    plane = EmbeddingPlane.connect([("127.0.0.1", port)], worker_id=wid)

    if role == "victim":
        tbl = _table(plane)
        _rounds(tbl, 1, 1, 2.0)
        print("VICTIM_READY", flush=True)
        time.sleep(600)  # parked for the parent's SIGKILL

    elif role == "survivor":
        tbl = _table(plane)
        val = _rounds(tbl, 1, 5, 1.0)  # 2..5 complete after eviction
        print("SURVIVOR_WAITING", flush=True)
        _wait_membership(plane, 2)     # the fresh identity rejoined
        val = _rounds(tbl, 6, 8, 1.0)
        print(f"CHAOS_OK final={val[0, 0]:.1f}", flush=True)

    elif role == "replacement":
        info = plane.clients[0].join()  # fresh worker_id, new epoch
        print(f"JOINED epoch={info['epoch']} rank={info['rank']}",
              flush=True)
        tbl = _table(plane)
        val = _rounds(tbl, 6, 8, 2.0)
        print(f"CHAOS_OK final={val[0, 0]:.1f}", flush=True)

    else:
        raise SystemExit(f"unknown role {role!r}")

    print("EMBED-COUNTERS", profiler.embed_counters(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
