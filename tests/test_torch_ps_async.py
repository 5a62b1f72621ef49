"""The asynchronous parameter server of the PyTorch port
(`mxnet_tpu_torch/ps_server.py`): the JAX package's `tests/test_ps_async.py`
run on the port, each test held against the JAX package's server and
client on the same request sequence (`torch_ps_parity.held`): every value
a client reads bit-equal.

Sync rounds with immediate acks and pulls that wait for their round,
async ``stored += recved``, the server's optimizer (the port's pickled
optimizer, run on host tensors), the batched frames, exactly-once under
faults, and two worker processes plus a server process through
`tools/launch.py -n 2 -s 1` (`tests/torch_dist_async_worker.py`; not
rerun in the JAX package here, whose own file runs its launcher test).
"""
import pytest

import test_ps_async as jref
import torch_ps_parity as parity

parity.port_copy("test_ps_async.py", globals())

_NO_RERUN = {"test_dist_async_two_processes_through_launcher"}


@pytest.fixture(autouse=True)
def _held_against_jax(request, monkeypatch):
    yield from parity.held(request, monkeypatch, jref, skip=_NO_RERUN)
