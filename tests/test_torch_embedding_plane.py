"""The sparse embedding plane of the PyTorch port
(`mxnet_tpu_torch/embedding_plane.py`): the JAX package's
`tests/test_embedding_plane.py` run on the port
(`torch_ps_parity.port_copy`), each test held against the JAX package's
plane on the same request sequence (`torch_ps_parity.held`): every row
the shards serve bit-equal, so the port's ordered segment sum pushes
what the JAX package's scatter-add pushes.

The hash ring, lookup and training against the numpy simulation, partial
pulls bit-equal to dense ones, a million-row vocabulary with bytes
proportional to the touched rows, the SSP self-heal, join and leave
under a fault plan, prefetch modes, `row_sparse_pull`'s dedup and the
kill switch.
"""
import pytest

import test_embedding_plane as jref
import torch_ps_parity as parity

parity.port_copy("test_embedding_plane.py", globals())


@pytest.fixture(autouse=True)
def _held_against_jax(request, monkeypatch):
    yield from parity.held(request, monkeypatch, jref)
