"""Elastic membership of the PyTorch port's parameter server: the JAX
package's `tests/test_ps_elastic.py` run on the port
(`torch_ps_parity.port_copy`), each test held against the JAX package's
server and client on the same request sequence (`torch_ps_parity.held`).

Join and leave mid-run, in-flight rounds at the old membership, barriers
not torn by a join, kill and rejoin under a fresh identity, bounded
staleness (refuse and block), the store's epoch-aware rank and
callback, cold join, the fault plan's membership events and
`io.NDArrayIter.repartition`.
"""
import pytest

import test_ps_elastic as jref
import torch_ps_parity as parity

parity.port_copy("test_ps_elastic.py", globals())


@pytest.fixture(autouse=True)
def _held_against_jax(request, monkeypatch):
    yield from parity.held(request, monkeypatch, jref)
