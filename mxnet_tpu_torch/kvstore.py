"""KVStore: data-parallel parameter synchronization (the counterpart of
`mxnet_tpu/kvstore.py`; reference `python/mxnet/kvstore.py`,
`src/kvstore/`).

Store types:

- ``local`` / ``device`` / ``nccl`` (reference `kvstore_local.h`,
  `comm.h`): one process; ``push`` sums a key's replicas on the first
  one's device.
- ``dist_sync`` / ``dist_device_sync`` (reference `kvstore_dist.h` worker
  + `kvstore_dist_server.h` server over ps-lite): the server role
  collapses into a symmetric sum over the process group
  (`parallel.distributed`, over gloo or NCCL), joined from the
  launcher's ``DMLC_*`` env when the store is created.  One process is
  the local store with rank 0 of 1, as the reference under
  ``launch.py -n 1``; a group that cannot form raises.
- ``dist_async``: the fork's BytePS hook (`kvstore_dist_server.h:182`
  ``BYTEPS_ENABLE_ASYNC``).  With the hook set and a parameter server's
  address (``MXTPU_PS_ADDR``, or the launcher's ``-s 1``), push and pull
  go through the host-side `ps_server.KVStoreServer` with true
  asynchronous staleness (``stored += recved`` per push,
  `kvstore_dist_server.h:786-792`); ``init`` is set-if-absent on the
  server.  Without the hook it warns and has ``dist_sync``'s semantics.

``set_optimizer`` runs the updater on the summed gradient at push time
(the reference server's ``ApplyUpdates``; on the parameter server the
pickled optimizer is shipped to it), so ``update_on_kvstore`` training
has the same semantics everywhere.  ``set_gradient_compression``
quantizes each dense push to {-t, 0, +t} with an error-feedback residual
per key (`gradient_compression.py`); across processes the packed words
are gathered and each rank sums their dequantized values.

Every push / pull / pushpull goes through the gradient-communication
plane (`comm_plane.py`): dense ``dist`` gradients are bucketed into
dtype-homogeneous flat buffers (one collective or one PS wire frame per
bucket), work is ordered by the caller's ``priority``, and with
``MXTPU_COMM_OVERLAP=1`` communication runs on the engine's lane,
overlapped with compute.
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
from .comm_plane import CommPlane
from .config import get_env
from .ndarray import ndarray as _nd
from .ndarray.ndarray import NDArray
from .ndarray.sparse import BaseSparseNDArray, RowSparseNDArray
from .parallel import distributed as _dist

__all__ = ["KVStore", "create"]

_KNOWN = ("local", "device", "nccl", "dist_sync", "dist_async",
          "dist_device_sync", "dist_async_device", "dist")


class KVStore:
    """A store over device replicas and, for ``dist`` types, the
    processes of a job (reference `kvstore_local.h:KVStoreLocal`,
    `kvstore_dist.h:KVStoreDist`)."""

    def __init__(self, name="local"):
        self._name = name
        self._store: Dict[Any, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._updater_obj = None
        self._compression_params = None
        self._gc = None
        # the gradient-communication scheduler every push/pull/pushpull
        # routes through: bucketing, priority ordering, optional overlap
        self._comm = CommPlane(self)
        # BytePS async hook: dist_async + BYTEPS_ENABLE_ASYNC=1 + a
        # reachable PS routes push/pull through the host-side server
        self._ps = None
        # elastic membership: last epoch acted on + user reshard callback
        self._seen_epoch = 0
        self._epoch_cb = None
        if "async" in name:
            from . import ps_server
            addr = ps_server.resolve_addr()
            if ps_server.async_enabled() and addr:
                host, _, port = addr.rpartition(":")
                # mxtpu-lint: disable=raw-env-read -- DMLC_* launcher protocol
                rank_env = os.environ.get("DMLC_RANK")
                self._ps = ps_server.PSClient(
                    host or "127.0.0.1", int(port),
                    worker_id=rank_env,
                    rank=int(rank_env) if rank_env is not None else None)
                if get_env("MXTPU_PS_ELASTIC_JOIN"):
                    # cold join: this worker was added to a RUNNING job;
                    # incumbents reshard at their next epoch check
                    self._ps.join()
                self._seen_epoch = self._ps.epoch
                # the client's transport counters and membership on the
                # one metrics surface (the server's own counters are its
                # process's `ps_server` family)
                _prof.register_metrics_family(
                    "ps_client", lambda: dict(
                        self._ps.counters,
                        membership_epoch=self._ps.epoch,
                        membership_size=self._ps.membership_size)
                    if self._ps is not None else {})
        if name.startswith("dist") and self._ps is None:
            # the launcher's DMLC_* env names the group; one that cannot
            # form raises here instead of training alone
            _dist.initialize()

    # -- identification -------------------------------------------------
    @property
    def type(self):
        return self._name

    @property
    def rank(self):
        """This worker's rank.  On the elastic PS path it is the
        server-assigned dense slot of the CURRENT membership epoch
        (refresh with :meth:`check_epoch`); otherwise the group's."""
        if self._ps is not None and self._ps.assigned_rank is not None:
            return self._ps.assigned_rank
        return _dist.rank() if self._name.startswith("dist") else 0

    @property
    def num_workers(self):
        """World size: the server's current membership size on the
        elastic PS path, else the group's."""
        if self._ps is not None and self._ps.membership_size > 0:
            return self._ps.membership_size
        return _dist.size() if self._name.startswith("dist") else 1

    def _across(self) -> bool:
        """Whether pushes are summed across processes."""
        return self._name.startswith("dist") and _dist.size() > 1

    # -- core ops -------------------------------------------------------
    def init(self, key, value):
        """Initialize key(s) (reference `kvstore.py:116`); a key already
        present keeps its value."""
        keys, values = _key_value(key, value)
        self._comm.flush()  # never race in-flight gradient traffic
        for k, v in zip(keys, values):
            if self._gc is not None:
                # a key initialized anew starts a fresh error feedback
                self._gc.reset_residual(k)
            if k in self._store:
                continue
            self._store[k] = v.copy()
            if self._ps is not None:
                # every worker sends init (the MXNet contract); the
                # server applies set-if-absent, so the key exists before
                # this worker's first push or pull
                self._ps.init(_as_int_key(k), v.asnumpy())

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
        return NDArray(total, values[0].context)

    def _allreduce_across_workers(self, value: NDArray) -> NDArray:
        """The sum over the group's processes (the ps-lite push/aggregate
        path, `kvstore_dist_server.h:365`, as a symmetric collective)."""
        if not self._across():
            return value
        return NDArray(_dist.all_gather_sum(value.data), value.context)

    def _apply_push_merged(self, k, merged: NDArray):
        """After the sum: the optimizer when one is set (the reference
        server's ApplyUpdates), else a plain write.  Runs on the comm
        plane's lane."""
        if self._updater is not None:
            self._updater(_as_int_key(k), merged, self._store[k])
        else:
            self._store[k] = merged

    def _push_fallback(self, k, merged: NDArray):
        """One key's push (sparse, compressed, local stores, bucketing
        off): 2-bit quantization of a dense value under compression (its
        packed words gathered across processes), else the group's sum;
        then the apply."""
        dense = not isinstance(merged, BaseSparseNDArray)
        if self._gc is not None and dense:
            if self._across():
                packed = self._gc.compress(k, merged.data)
                gathered = _dist.all_gather(packed)
                merged = NDArray(self._gc.decompress_sum(
                    gathered, merged.shape, merged._tdtype), merged.context)
            else:
                merged = NDArray(self._gc.quantize(k, merged.data).to(
                    merged._tdtype), merged.context)
        elif self._across():
            merged = self._allreduce_across_workers(merged)
        self._apply_push_merged(k, merged)

    def _cache(self, k, value: np.ndarray, device=None) -> NDArray:
        """Keep a value pulled from the parameter server as the key's
        local copy, on the device of the copy it replaces (else
        ``device``, else the host)."""
        cur = self._store.get(k)
        if cur is not None:
            device = cur.data.device
        t = torch.tensor(np.asarray(value))
        arr = NDArray(t.to(device) if device is not None else t)
        self._store[k] = arr
        return arr

    def _check(self, k):
        # PS mode: another worker may have initialized the key on the
        # server (reference workers push without a local init)
        if k not in self._store and self._ps is None:
            raise MXNetError(f"key {k!r} has not been initialized")

    def push(self, key, value, priority=0):
        """Aggregate value(s) into the store (reference `kvstore.py:160`),
        through the comm plane: keys in descending ``priority`` (an int,
        or one per key), dense ``dist`` gradients bucketed, and with
        overlap on the call enqueues and returns."""
        keys, values = _key_value_list(key, value)
        pairs = []
        for k, vlist in zip(keys, values):
            self._check(k)
            pairs.append((k, self._reduce(vlist)))
        self._comm.push(pairs, priority)

    def _pull_pairs(self, keys, outs, ignore_sparse):
        """The dense outs of each key's pull: ``ignore_sparse`` skips
        sparse ones, else they are refused (`row_sparse_pull` is the
        sparse path); a key with no dense out is left out."""
        pairs = []
        for k, olist in zip(keys, outs):
            self._check(k)
            dense = []
            for o in olist:
                if isinstance(o, BaseSparseNDArray):
                    if not ignore_sparse:
                        raise MXNetError(
                            f"pull into a {o.stype!r} array for key {k!r} "
                            "is not supported with ignore_sparse=False; "
                            "use row_sparse_pull for sparse destinations")
                    continue
                dense.append(o)
            if dense:
                pairs.append((k, dense))
        return pairs

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the stored value(s) into ``out`` (reference
        `kvstore.py:240`).  With overlap on, each out gets a pending
        handle that lands at its next read or write; the PS path batches
        a multi-key pull into one ``pull_batch`` frame."""
        assert out is not None
        keys, outs = _key_value_list(key, out)
        self._comm.pull(self._pull_pairs(keys, outs, ignore_sparse),
                        priority)

    def pushpull(self, key, value, out=None, priority=0):
        """Each key's push, then its pull, bucket by bucket in descending
        ``priority`` (reference `kvstore.py:pushpull`)."""
        keys, values = _key_value_list(key, value)
        _, outs = _key_value_list(key, out if out is not None else value)
        push_pairs = []
        for k, vlist in zip(keys, values):
            self._check(k)
            push_pairs.append((k, self._reduce(vlist)))
        pull_pairs = self._pull_pairs(keys, outs, True)
        if len(pull_pairs) != len(push_pairs):
            # some keys' outs were all sparse: the two-phase form
            self._comm.push(push_pairs, priority)
            self._comm.pull(pull_pairs, priority)
            return
        self._comm.pushpull(push_pairs, pull_pairs, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the rows in ``row_ids`` (reference `kvstore.py:314`): the
        ids are deduplicated and sorted, so a `RowSparseNDArray` out keeps
        strictly ascending indices; a dense out gets those rows and zeros
        elsewhere.  ``row_ids`` is one id set for all outs or one per
        out.  On the parameter server with the embedding plane on, only
        those rows travel (one ``pull_rows`` frame) and refresh the
        local copy."""
        from .embedding_plane import embed_plane_enabled
        assert out is not None and row_ids is not None
        self._comm.flush()  # reads the store behind the plane's back
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
                if self._ps is not None and embed_plane_enabled():
                    wire_rows = self._ps.pull_rows(_as_int_key(k), uids)
                    with torch.no_grad():
                        src.index_copy_(0, ids, torch.tensor(
                            np.asarray(wire_rows)).to(src.device, src.dtype))
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
        """Run ``optimizer`` on each push (reference `kvstore.py:450`).
        On the parameter server the pickled optimizer is shipped to it;
        else the store takes a copy through a pickle round trip, as the
        reference ships it to its server."""
        from . import optimizer as opt
        self._comm.flush()
        if self._ps is not None:
            self._ps.set_optimizer(optimizer)
            return
        optimizer = pickle.loads(pickle.dumps(optimizer))
        self._updater_obj = opt.get_updater(optimizer)
        self._updater = self._updater_obj

    def set_updater(self, updater):
        self._comm.flush()
        self._updater = updater

    @property
    def comm(self):
        """The gradient-communication plane this store routes through:
        its ``frame_log`` records every comm round in issue order; the
        totals are in ``profiler.comm_counters()``."""
        return self._comm

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback on every later dense push
        (reference `kvstore.py:set_gradient_compression`); not applied
        on the parameter-server path, which carries full gradients."""
        from .gradient_compression import GradientCompression
        gc = GradientCompression(compression_params) \
            if compression_params else None
        if gc is not None and self._ps is not None:
            warnings.warn(
                "gradient compression is not applied on the async "
                "parameter-server path — pushes carry full-precision "
                "gradients", UserWarning, stacklevel=2)
        self._compression_params = dict(compression_params or {})
        self._gc = gc

    # -- elastic membership ---------------------------------------------
    def set_epoch_callback(self, fn):
        """The membership-epoch callback, ``fn(epoch, rank,
        num_workers)``, fired by :meth:`check_epoch` once per observed
        transition, after the comm plane was flushed and its bucket plan
        dropped: where the data plane reshards (``iter.repartition(
        num_workers, rank)``)."""
        self._epoch_cb = fn

    def check_epoch(self):
        """Poll the elastic PS membership.  If the epoch moved since the
        last check: flush in-flight comm, drop the comm plane's bucket
        plan, fire the epoch callback, and return the new epoch.  None
        when nothing changed or this store is not on the PS path."""
        if self._ps is None:
            return None
        self._ps.membership()
        epoch = self._ps.epoch
        if epoch == self._seen_epoch:
            return None
        self._seen_epoch = epoch
        self._comm.on_epoch_change(epoch)
        if self._epoch_cb is not None:
            self._epoch_cb(epoch, self.rank, self.num_workers)
        return epoch

    def join(self):
        """Join the running job's PS membership (cold join); see
        `ps_server.PSClient.join`.  Returns the admission info."""
        if self._ps is None:
            raise MXNetError("join() needs the elastic PS path "
                             "(dist_async + BYTEPS_ENABLE_ASYNC)")
        out = self._ps.join()
        self.check_epoch()
        return out

    def leave(self):
        """Drain this worker out of PS membership; the store keeps
        serving local reads but its identity is retired."""
        if self._ps is None:
            raise MXNetError("leave() needs the elastic PS path "
                             "(dist_async + BYTEPS_ENABLE_ASYNC)")
        self._comm.flush()
        return self._ps.leave()

    def ps_counters(self):
        """The async-PS path's client transport counters merged with the
        server's ``stats`` op; None when this store is not on it."""
        if self._ps is None:
            return None
        self._comm.flush()
        out = {"client": dict(self._ps.counters),
               "membership_epoch": self._ps.epoch}
        try:
            out["server"] = self._ps.stats()
            out["membership_epoch"] = out["server"].get(
                "membership_epoch", out["membership_epoch"])
        except (RuntimeError, OSError) as e:
            out["server"] = {"unreachable": str(e)}
        return out

    # -- distributed control (reference kvstore.h:269-364) --------------
    def barrier(self):
        """Every worker waits for the others, after this one's in-flight
        comm has finished."""
        self._comm.flush()
        if self._across():
            _dist.barrier("mxnet_tpu_kvstore_barrier")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The store's optimizer states, written atomically with the CRC32
        footer (reference `kvstore.py:save_optimizer_states`)."""
        if self._updater_obj is None:
            raise MXNetError("Cannot save states for distributed training")
        self._comm.flush()  # states must reflect every applied push
        from .serialization import atomic_write
        atomic_write(fname, self._updater_obj.get_states(dump_optimizer),
                     checksum=True)

    def load_optimizer_states(self, fname):
        if self._updater_obj is None:
            raise MXNetError("Cannot load states for distributed training")
        self._comm.flush()
        from .serialization import read_payload
        self._updater_obj.set_states(read_payload(fname))

    def __repr__(self):
        return f"<KVStore {self._name} rank={self.rank}/{self.num_workers}>"


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
        from . import ps_server
        if not (ps_server.async_enabled() and ps_server.resolve_addr()):
            # without the fork's hook (kvstore_dist_server.h:182) and a
            # server, dist_async has dist_sync semantics: warned at the
            # call site
            warnings.warn(
                "KVStore type %r is served with synchronous (dist_sync) "
                "semantics — set BYTEPS_ENABLE_ASYNC=1 and MXTPU_PS_ADDR "
                "(host:port of a ps_server.KVStoreServer) for true "
                "asynchronous training" % name, UserWarning, stacklevel=2)
    return KVStore(name)
