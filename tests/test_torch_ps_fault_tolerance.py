"""Fault tolerance of the PyTorch port's parameter server: the JAX
package's `tests/test_ps_fault_tolerance.py` run on the port
(`torch_ps_parity.port_copy`), each test held against the JAX package's
server and client on the same request sequence (`torch_ps_parity.held`):
every value a client reads bit-equal.

Dropped requests and lost replies against the dedup window, duplicated
delivery, delayed acks, a poisoned connection, kill and restart from a
snapshot, leases, dead workers, eviction, round timeouts, the stats op,
the store's `ps_counters` and `MXTPU_PS_FAULT_PLAN`.
"""
import pytest

import test_ps_fault_tolerance as jref
import torch_ps_parity as parity

parity.port_copy("test_ps_fault_tolerance.py", globals())


@pytest.fixture(autouse=True)
def _held_against_jax(request, monkeypatch):
    yield from parity.held(request, monkeypatch, jref)
