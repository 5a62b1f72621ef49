"""A really stopped rank in the port's elastic mesh (the slow lane of
`tests/test_mesh_chaos.py`, marked slow as the lane it copies).

Four gloo ranks of `tests/torch_elastic_worker.py` (``suite_mesh_chaos``)
fit the reference's MLP under a `TrainingSupervisor` with buddy
redundancy and no fault plan; rank 3 stops itself (SIGSTOP) as it
fetches epoch 1's first batch.  The survivors' real sentinel misses its
bound, the census attributes the loss to rank 3 from the real roll call,
the mesh shrinks 4 -> 3 with the buddy copy, training completes, and the
weights and Adam states are bit-equal to a fresh n' = 3 fit resumed from
the epoch-0 checkpoint.
"""
import numpy as np
import pytest

from torch_spmd_launch import run_ranks

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def survivors():
    codes, results, text = run_ranks("torch_elastic_worker.py",
                                     "mesh_chaos", (4,), timeout=300)
    assert codes == [[0, 0, 0, -9]], text[-8000:]
    return results[0][:3]


def test_real_hang_bounded_detection_census_attributed(survivors):
    for res in survivors:
        assert str(res["chaos/reason"]) == "device_hang"
        assert res["chaos/lost"].tolist() == [3]
        assert res["chaos/census"].tolist() == [True, True, True, False]
        assert float(res["chaos/timeout_s"]) == pytest.approx(1.0)
        assert 1.0 <= float(res["chaos/seconds"]) < 10.0


def test_real_hang_shrink_completes_bitwise_vs_fresh_resume(survivors):
    for rank, res in enumerate(survivors):
        assert res["chaos/counters"].tolist() == [1, 1, 0, 1]
        keys = sorted(k for k in res if k.startswith("chaos/p/")
                      or k.startswith("chaos/s/"))
        assert keys
        for k in keys:
            ref = res["fresh_n3/" + k.split("/", 1)[1]]
            assert np.array_equal(res[k], ref), f"rank {rank}: {k}"
