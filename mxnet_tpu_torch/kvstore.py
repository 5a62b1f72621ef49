"""KVStore: the local key-value store (the counterpart of
`mxnet_tpu/kvstore.py`; reference `python/mxnet/kvstore.py`,
`src/kvstore/kvstore_local.h`).

``local``, ``device`` and ``nccl`` keep each key's value on the device it
was initialized from; ``push`` sums a key's replicas and either writes
the sum into the store or, after `set_optimizer`, runs the optimizer on
it against the stored weight (update-on-kvstore, the reference's
``ApplyUpdates``); ``pull`` copies the stored value into each out array;
``row_sparse_pull`` gathers requested rows.  Keys of one call are applied
one at a time in descending ``priority`` (stable), as the JAX package's
per-key path does; its bucketing and overlap plane (`comm_plane.py`)
waits, with every store across processes, for the port of the
distributed group.  ``dist_sync`` and ``dist_device_sync`` in one
process are the local store with rank 0 of 1, as in the JAX package;
``dist_async`` without the BytePS hook warns and does the same, and with
the hook (``BYTEPS_ENABLE_ASYNC=1`` and ``MXTPU_PS_ADDR``) raises, since
the parameter server (`ps_server.py`) is a later slice.

`set_gradient_compression` quantizes each dense push to {-t, 0, +t} with
an error-feedback residual per key (`gradient_compression.py`).
"""
from __future__ import annotations

import os
import pickle
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from . import profiler as _prof
from .base import MXNetError
from .config import get_env
from .ndarray import ndarray as _nd
from .ndarray.ndarray import NDArray
from .ndarray.sparse import BaseSparseNDArray, RowSparseNDArray

__all__ = ["KVStore", "create"]

_KNOWN = ("local", "device", "nccl", "dist_sync", "dist_async",
          "dist_device_sync", "dist_async_device", "dist")


def _byteps_hook() -> bool:
    """The JAX package's asynchronous parameter-server switch."""
    flag = os.environ.get("BYTEPS_ENABLE_ASYNC", "").strip().lower()
    return flag not in ("", "0", "false") and \
        bool(get_env("MXTPU_PS_ADDR"))


class KVStore:
    """A store in one process (reference `kvstore_local.h:KVStoreLocal`)."""

    def __init__(self, name="local"):
        if name.startswith("dist") and torch.distributed.is_available() \
                and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise MXNetError(f"KVStore {name!r} across "
                             f"{torch.distributed.get_world_size()} "
                             "processes waits for the port of the "
                             "distributed store (comm_plane.py, ps_*)")
        self._name = name
        self._store: Dict[Any, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._updater_obj = None
        self._compression_params = None
        self._gc = None

    @property
    def type(self):
        return self._name

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    # -- core ops -------------------------------------------------------
    def init(self, key, value):
        """Initialize key(s) (reference `kvstore.py:116`); a key already
        present keeps its value."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if self._gc is not None:
                # a key initialized anew starts a fresh error feedback
                self._gc.reset_residual(k)
            if k not in self._store:
                self._store[k] = v.copy()

    @staticmethod
    def _reduce(values):
        """The sum of a key's replicas (reference `comm.h:Reduce`), on the
        first one's device."""
        if len(values) == 1:
            return values[0].copy()
        dev = values[0].data.device
        total = values[0].data
        for v in values[1:]:
            total = total + v.data.to(dev)
        return NDArray(total)

    def _check(self, k):
        if k not in self._store:
            raise MXNetError(f"key {k!r} has not been initialized")

    def _push_one(self, k, merged):
        """One key's push: the 2-bit quantization of a dense value under
        compression, then the optimizer (or a plain write)."""
        # the JAX package's comm plane counts every local key on its
        # per-key path (no buckets without a second process)
        _prof.bump_comm("fallback_keys")
        _prof.bump_comm("fallback_keys_sparse"
                        if isinstance(merged, BaseSparseNDArray)
                        else "fallback_keys_dense")
        if self._gc is not None and \
                not isinstance(merged, BaseSparseNDArray):
            merged = NDArray(self._gc.quantize(k, merged.data).to(
                merged._tdtype))
        if self._updater is not None:
            self._updater(_as_int_key(k), merged, self._store[k])
        else:
            self._store[k] = merged

    def _pull_one(self, k, outs):
        src = self._store[k].data
        with torch.no_grad():
            for o in outs:
                o._set_data(src.to(device=o.data.device, dtype=o._tdtype))

    def _pull_outs(self, k, olist, ignore_sparse):
        """The dense outs of a pull: ``ignore_sparse`` skips sparse ones,
        else they are refused (`row_sparse_pull` is the sparse path)."""
        self._check(k)
        dense = []
        for o in olist:
            if isinstance(o, BaseSparseNDArray):
                if not ignore_sparse:
                    raise MXNetError(
                        f"pull into a {o.stype!r} array for key {k!r} is "
                        "not supported with ignore_sparse=False; use "
                        "row_sparse_pull for sparse destinations")
                continue
            dense.append(o)
        return dense

    def push(self, key, value, priority=0):
        """Aggregate value(s) into the store (reference `kvstore.py:160`),
        keys in descending ``priority``."""
        keys, values = _key_value_list(key, value)
        merged = []
        for k, vlist in zip(keys, values):
            self._check(k)
            merged.append(self._reduce(vlist))
        for i in _order(len(keys), priority):
            self._push_one(keys[i], merged[i])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the stored value(s) into ``out`` (reference
        `kvstore.py:240`)."""
        assert out is not None
        keys, outs = _key_value_list(key, out)
        dense = [self._pull_outs(k, o, ignore_sparse)
                 for k, o in zip(keys, outs)]
        for i in _order(len(keys), priority):
            self._pull_one(keys[i], dense[i])

    def pushpull(self, key, value, out=None, priority=0):
        """Each key's push, then its pull, keys in descending
        ``priority`` (reference `kvstore.py:pushpull`)."""
        keys, values = _key_value_list(key, value)
        _, outs = _key_value_list(key, out if out is not None else value)
        merged = []
        for k, vlist in zip(keys, values):
            self._check(k)
            merged.append(self._reduce(vlist))
        dense = [self._pull_outs(k, o, True) for k, o in zip(keys, outs)]
        for i in _order(len(keys), priority):
            self._push_one(keys[i], merged[i])
            self._pull_one(keys[i], dense[i])

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the rows in ``row_ids`` (reference `kvstore.py:314`): the
        ids are deduplicated and sorted, so a `RowSparseNDArray` out keeps
        strictly ascending indices; a dense out gets those rows and zeros
        elsewhere.  ``row_ids`` is one id set for all outs or one per
        out."""
        assert out is not None and row_ids is not None
        keys, outs = _key_value_list(key, out)
        for k, olist in zip(keys, outs):
            self._check(k)
            src = self._store[k].data
            if isinstance(row_ids, (list, tuple)):
                rid_list = list(row_ids) if len(row_ids) == len(olist) \
                    else [row_ids[0]] * len(olist)
            else:
                rid_list = [row_ids] * len(olist)
            for o, rids in zip(olist, rid_list):
                raw = rids.asnumpy() if isinstance(rids, NDArray) else rids
                uids = np.unique(np.asarray(raw).reshape(-1).astype(np.int64))
                dev = o._sp_data.device if isinstance(
                    o, BaseSparseNDArray) else o.data.device
                ids = torch.from_numpy(uids).to(src.device)
                rows = src.index_select(0, ids)
                if isinstance(o, RowSparseNDArray):
                    o._adopt(RowSparseNDArray(rows.to(dev), ids.to(dev),
                                              tuple(src.shape)))
                    o._sp_shape = tuple(src.shape)
                else:
                    dense = torch.zeros_like(src).index_copy_(0, ids, rows)
                    o._set_data(dense.to(device=dev, dtype=o._tdtype))

    # -- optimizer ------------------------------------------------------
    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on each push (reference `kvstore.py:450`); the
        store takes a copy through a pickle round trip, as the reference
        ships it to its server."""
        from . import optimizer as opt
        optimizer = pickle.loads(pickle.dumps(optimizer))
        self._updater_obj = opt.get_updater(optimizer)
        self._updater = self._updater_obj

    def set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback on every later dense push
        (reference `kvstore.py:set_gradient_compression`)."""
        from .gradient_compression import GradientCompression
        self._compression_params = dict(compression_params or {})
        self._gc = GradientCompression(compression_params) \
            if compression_params else None

    def barrier(self):
        """One process: nothing to wait for."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The store's optimizer states, written atomically with the CRC32
        footer (reference `kvstore.py:save_optimizer_states`)."""
        if self._updater_obj is None:
            raise MXNetError("Cannot save states for distributed training")
        from .serialization import atomic_write
        atomic_write(fname, self._updater_obj.get_states(dump_optimizer),
                     checksum=True)

    def load_optimizer_states(self, fname):
        if self._updater_obj is None:
            raise MXNetError("Cannot load states for distributed training")
        from .serialization import read_payload
        self._updater_obj.set_states(read_payload(fname))

    def __repr__(self):
        return f"<KVStore {self._name} rank={self.rank}/{self.num_workers}>"


def _order(n, priority):
    """Key positions in descending priority, stable (an int, or one per
    key)."""
    if isinstance(priority, (list, tuple)):
        if len(priority) != n:
            raise MXNetError(f"got {len(priority)} priorities for {n} keys")
        prios = [int(p) for p in priority]
    else:
        prios = [int(priority)] * n
    return sorted(range(n), key=lambda i: (-prios[i], i))


def _as_int_key(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _key_value(key, value):
    """(keys, one NDArray per key)."""
    if isinstance(key, (list, tuple)):
        return list(key), [v if isinstance(v, NDArray) else _nd.array(v)
                           for v in value]
    return [key], [value if isinstance(value, NDArray) else _nd.array(value)]


def _key_value_list(key, value):
    """(keys, a list of NDArrays per key)."""
    if isinstance(key, (list, tuple)):
        return list(key), [list(v) if isinstance(v, (list, tuple)) else [v]
                           for v in value]
    if isinstance(value, (list, tuple)) and (
            not value or isinstance(value[0], NDArray)):
        return [key], [list(value)]
    return [key], [[value]]


def create(name="local"):
    """A store by type name (reference `kvstore.cc:41`, matched by
    substring)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if not any(name.startswith(k) or k in name for k in _KNOWN):
        raise MXNetError(f"unknown KVStore type {name!r}")
    if "async" in name:
        if _byteps_hook():
            raise MXNetError(
                f"KVStore {name!r} with BYTEPS_ENABLE_ASYNC and "
                "MXTPU_PS_ADDR needs the asynchronous parameter server "
                "(the JAX package's ps_server.py), a later slice of the "
                "PyTorch port")
        warnings.warn(
            f"KVStore type {name!r} is served with synchronous (dist_sync) "
            "semantics: set BYTEPS_ENABLE_ASYNC=1 and MXTPU_PS_ADDR for "
            "asynchronous training", UserWarning, stacklevel=2)
    return KVStore(name)
