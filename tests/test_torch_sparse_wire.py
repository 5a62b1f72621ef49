"""Row-sparse values on the PyTorch port's parameter-server wire: the JAX
package's `tests/test_sparse_wire.py` run on the port
(`torch_ps_parity.port_copy`), each test held against the JAX package's
server and client on the same request sequence (`torch_ps_parity.held`).

Row pushes touch only their rows, exactly once under faults and across a
server restart; sync rounds keep untouched rows; ``pull_rows`` equals a
full pull; `KVStore.row_sparse_pull` rides it; the comm plane's row
pushes save wire bytes.
"""
import pytest

import test_sparse_wire as jref
import torch_ps_parity as parity

parity.port_copy("test_sparse_wire.py", globals())


@pytest.fixture(autouse=True)
def _held_against_jax(request, monkeypatch):
    yield from parity.held(request, monkeypatch, jref)
