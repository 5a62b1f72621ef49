"""The gradient-communication plane of the PyTorch port
(`mxnet_tpu_torch/comm_plane.py`): the JAX package's
`tests/test_comm_plane.py` run on the port (`torch_ps_parity.port_copy`),
each test that reaches a parameter server held against the JAX
package's on the same request sequence (`torch_ps_parity.held`).

Buckets against the per-key path bit for bit, frames per bucket, the cap
and dtype homogeneity, priority order on the frame log, pending pulls
landing at the next read, the kill switches, sparse outs, the 2-bit
residual, wire v2, batched PS frames under faults and a server restart,
and the Trainer's priorities.
"""
import pytest

import test_comm_plane as jref
import torch_ps_parity as parity

parity.port_copy("test_comm_plane.py", globals())


@pytest.fixture(autouse=True)
def _held_against_jax(request, monkeypatch):
    yield from parity.held(request, monkeypatch, jref)
