"""dist_async correctness worker of the PyTorch port (the counterpart of
`tests/dist_async_worker.py`), spawned through `tools/launch.py
--launcher local -s 1` with BYTEPS_ENABLE_ASYNC=1: the same command run
under DMLC_ROLE=server imports the package and so becomes the port's
parameter server (`mxnet_tpu_torch.kvstore_server`).

Asserts the fork's async semantics across processes
(`kvstore_dist_server.h:786-792`):
  * a worker's push is visible to itself immediately (no barrier);
  * after both workers barrier, the store holds the SUM of everything
    pushed (async accumulate), not a per-round aggregate.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402


def main():
    assert "jax" not in sys.modules and "mxnet_tpu" not in sys.modules
    rank = int(os.environ["DMLC_WORKER_ID"])
    nworker = int(os.environ["DMLC_NUM_WORKER"])
    with mt.cpu():
        kv = mt.kv.create("dist_async")
        assert kv._ps is not None, "async hook set but PS path not taken"

        kv.init("w", mt.nd.zeros((4,)))
        kv._ps.barrier()  # all inits landed (set-if-absent keeps zeros)

        # each worker pushes (rank+1) K times; every push applies at once
        K = 5
        out = mt.nd.zeros((4,))
        for i in range(K):
            kv.push("w", mt.nd.ones((4,)) * (rank + 1))
            kv.pull("w", out=out)
            # own pushes are visible IMMEDIATELY: the pulled value holds
            # at least my (i+1) contributions, with no wait on the other
            # worker (under sync semantics this pull would block)
            assert out.asnumpy()[0] >= (i + 1) * (rank + 1), \
                (rank, i, out.asnumpy())

        kv._ps.barrier()  # both workers done pushing
        kv.pull("w", out=out)
        total = K * sum(r + 1 for r in range(nworker))
        np.testing.assert_allclose(out.asnumpy(), total)
        print(f"rank {rank}: ASYNC OK (final={out.asnumpy()[0]})",
              flush=True)
        kv._ps.barrier()  # hold the server up until every rank asserted


if __name__ == "__main__":
    main()
