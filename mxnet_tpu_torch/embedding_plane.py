"""Sparse embedding plane: server-sharded large-vocab tables with
deferred partial row pulls over the elastic PS plane (the counterpart of
`mxnet_tpu/embedding_plane.py`).

The workload the source fork was created for (ByteDance's BytePS MXNet
— `kvstore_dist_server.h` async hook — trains large sparse recommender
models): embedding tables of shape ``(vocab, dim)`` where a batch
touches thousands of rows of a multi-million-row table.  The same
O(touched)/O(total) insight as ZeRO-1 (arxiv 2004.13336) applied to
embeddings:

* **Row sharding** — each table lives row-sharded across the PS server
  shards on a deterministic consistent-hash ring (`HashRing`) keyed by
  row id.  The ring is a pure function of ``(shard id, vnode index)``,
  so an elastic join/leave remaps ONLY the arc the changed shard owned;
  every other row keeps its home.
* **Deferred partial pull** — `EmbeddingTable.prefetch` dedups the
  batch's ids (`np.unique`), splits them by owning shard, and issues
  per-shard ``embed_pull`` frames on the engine comms lane so the wire
  time overlaps forward compute.  Workers never materialize a full
  table; per-step pull bytes ∝ touched rows, not vocab.
* **On-device gather/scatter** — `lookup` gathers the pulled unique
  rows back to batch positions with one ``index_select`` on the table's
  device; `push_grad` segment-sums the batch gradient to unique rows
  with the ordered segment sum of `ndarray.sparse` (each row's
  contributions added in batch order, the same bits on every call,
  where an atomic ``index_add_`` would not be) before it ever touches
  the wire.
* **Server-side lazy state** — the server applies the row-sparse
  gradient with per-row optimizer state allocated on first touch
  (sparse SGD/AdaGrad), so server memory is O(touched-vocab) too.
* **SSP default** — the plane inherits the server's bounded-staleness async
  mode as its default; a refused stale push self-heals with a refresh
  pull + one retry (``embed.stale_refreshes`` counts them).  Sync mode
  is the bitwise parity baseline.

A table's device is ``ctx`` (the card when none is given), where
`lookup` returns its rows and `push_grad` sums its gradient; the
server shards are host processes.

Kill switch: ``MXTPU_EMBED_PLANE=0`` makes `EmbeddingPlane` refuse to
construct and restores every pre-existing row-sparse path (densifying
PS push, local-cache `row_sparse_pull`) exactly.
"""
from __future__ import annotations

import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import profiler as _prof
from .base import MXNetError
from .config import get_env
from .context import default_context
from .ndarray.ndarray import NDArray
from .ndarray.sparse import _segment_sum
from .ps_server import PSClient, StalePushError

__all__ = ["embed_plane_enabled", "HashRing", "EmbeddingPlane",
           "EmbeddingTable", "Lookup", "PendingRows"]


def embed_plane_enabled() -> bool:
    """The MXTPU_EMBED_PLANE kill switch (default on)."""
    return bool(get_env("MXTPU_EMBED_PLANE"))


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized: a cheap, deterministic, well-
    mixed uint64 hash of row ids (row ids are often dense 0..n, which
    must not map to adjacent ring positions)."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x & np.uint64(0xFFFFFFFF)


class HashRing:
    """Deterministic consistent-hash ring over server shards.

    Each shard owns MXTPU_EMBED_VNODES points on a 32-bit ring (crc32
    of ``"shard:<id>:vnode:<k>"`` — a pure function of the shard id, so
    every worker, and every worker incarnation, builds the identical
    ring).  A row id hashes to a ring position and belongs to the next
    point clockwise.  Adding or removing one shard moves only the arcs
    adjacent to that shard's vnodes: the elastic-membership property
    the embedding plane needs (join/leave remaps ~1/n of the rows, the
    rest keep their home shard and their lazily-materialized state).
    """

    def __init__(self, shard_ids: Sequence[Any], vnodes: Optional[int] = None):
        shard_ids = list(shard_ids)
        if not shard_ids:
            raise ValueError("HashRing needs at least one shard")
        if vnodes is None:
            vnodes = int(get_env("MXTPU_EMBED_VNODES"))
        vnodes = max(1, int(vnodes))
        points = []
        for idx, sid in enumerate(shard_ids):
            for v in range(vnodes):
                h = zlib.crc32(f"shard:{sid}:vnode:{v}".encode())
                points.append((h, idx))
        points.sort()
        self.shard_ids = shard_ids
        self.num_shards = len(shard_ids)
        self._hashes = np.array([p[0] for p in points], np.uint64)
        self._owners = np.array([p[1] for p in points], np.int64)

    def shard_of(self, row_ids) -> np.ndarray:
        """Owning shard INDEX (0..num_shards-1) for each row id."""
        h = _mix64(np.asarray(row_ids, np.int64))
        idx = np.searchsorted(self._hashes, h, side="left")
        idx = idx % len(self._hashes)
        return self._owners[idx]


class PendingRows:
    """Handle for a deferred partial pull: the per-shard ``embed_pull``
    frames run on the engine comms lane; `wait()` blocks until the
    reassembled ``(n_unique, dim)`` block is ready.  Forward compute
    between `prefetch` and `wait` overlaps the wire time."""

    def __init__(self, uids: np.ndarray, inverse: np.ndarray,
                 batch_shape, future=None, rows: Optional[np.ndarray] = None):
        self.uids = uids
        self.inverse = inverse
        self.batch_shape = tuple(batch_shape)
        self._future = future
        self._rows = rows

    def wait(self) -> np.ndarray:
        if self._rows is None:
            self._rows = self._future.result()
            self._future = None
        return self._rows


class Lookup:
    """One lookup's forward value plus the dedup bookkeeping `push_grad`
    needs to route the backward scatter: ``value`` (an NDArray on the
    table's device) has shape ``batch_shape + (dim,)``;
    ``uids``/``inverse`` are the sorted-unique row ids and the gather
    map back to batch positions."""

    __slots__ = ("value", "uids", "inverse", "batch_shape")

    def __init__(self, value, uids, inverse, batch_shape):
        self.value = value
        self.uids = uids
        self.inverse = inverse
        self.batch_shape = tuple(batch_shape)


class EmbeddingPlane:
    """Worker-side handle on the sharded embedding service: one
    `PSClient` per server shard plus the deterministic `HashRing` that
    routes row ids to shards."""

    def __init__(self, clients: Sequence[PSClient]):
        if not embed_plane_enabled():
            raise MXNetError(
                "the sparse embedding plane is disabled "
                "(MXTPU_EMBED_PLANE=0); unset the kill switch or use "
                "the dense row_sparse_pull paths")
        self._clients: List[PSClient] = list(clients)
        if not self._clients:
            raise ValueError("EmbeddingPlane needs at least one "
                             "server-shard client")
        self.ring = HashRing(range(len(self._clients)))
        self._tables: Dict[str, "EmbeddingTable"] = {}
        self._lock = threading.Lock()

    @classmethod
    def connect(cls, addrs: Sequence, worker_id: Optional[str] = None,
                **kw) -> "EmbeddingPlane":
        """Dial a list of ``(host, port)`` server shards.  All shards
        see the same worker identity, so dedup windows and membership
        line up across the plane."""
        clients = [PSClient(h, p, worker_id=worker_id, **kw)
                   for h, p in addrs]
        return cls(clients)

    @property
    def num_shards(self) -> int:
        return len(self._clients)

    @property
    def clients(self) -> List[PSClient]:
        return list(self._clients)

    def table(self, name: str, vocab: int, dim: int, dtype="float32",
              init="normal", init_scale=0.01, seed: int = 0,
              optimizer: Optional[Dict[str, Any]] = None, ctx=None
              ) -> "EmbeddingTable":
        """Create (or re-open: server side is set-if-absent) a sharded
        table.  ``optimizer`` is the sparse-optimizer spec dict
        installed server-side (``{"kind": "sgd"|"adagrad", "lr", ...}``);
        None = plain aggregation.  ``ctx`` is where lookups land (the
        card when none is given)."""
        with self._lock:
            tbl = self._tables.get(name)
            if tbl is None:
                tbl = EmbeddingTable(self, name, vocab, dim, dtype,
                                     init, init_scale, seed, optimizer,
                                     ctx=ctx)
                self._tables[name] = tbl
            return tbl

    def close(self):
        for c in self._clients:
            c.close()


class EmbeddingTable:
    """One logical ``(vocab, dim)`` table, row-sharded over the plane's
    server shards.  The worker never holds more than the rows the
    current batch touches."""

    def __init__(self, plane: EmbeddingPlane, name: str, vocab: int,
                 dim: int, dtype="float32", init="normal",
                 init_scale=0.01, seed: int = 0,
                 optimizer: Optional[Dict[str, Any]] = None, ctx=None):
        self._plane = plane
        self.ctx = ctx or default_context("EmbeddingTable")
        self.name = str(name)
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self._engine_var = None
        self._state_rows_seen: Dict[int, int] = {}
        for c in plane._clients:
            c.embed_init(self.name, self.vocab, self.dim,
                         self.dtype.name, str(init), float(init_scale),
                         int(seed))
        if optimizer is not None:
            for c in plane._clients:
                c.embed_set_optimizer(self.name, optimizer)

    # -- id plumbing -----------------------------------------------------
    @staticmethod
    def _as_ids(ids) -> np.ndarray:
        if hasattr(ids, "asnumpy"):   # NDArray
            ids = ids.asnumpy()
        return np.asarray(ids).astype(np.int64, copy=False)

    def _dedup(self, ids):
        flat = self._as_ids(ids)
        shape = flat.shape
        flat = flat.reshape(-1)
        uids, inverse = np.unique(flat, return_inverse=True)
        _prof.bump_embed("ids_requested", int(flat.size))
        return uids, inverse.reshape(shape), shape

    # -- wire ------------------------------------------------------------
    def _pull_rows(self, uids: np.ndarray) -> np.ndarray:
        """Fetch the (already sorted-unique) rows, one frame per shard
        that owns any of them, and reassemble in uid order."""
        rows = np.empty((uids.shape[0], self.dim), self.dtype)
        owners = self._plane.ring.shard_of(uids)
        frames = 0
        for s in range(self._plane.num_shards):
            mask = owners == s
            if not mask.any():
                continue
            rows[mask] = self._plane._clients[s].embed_pull(
                self.name, uids[mask])
            frames += 1
        itemsize = self.dtype.itemsize
        _prof.bump_embed("rows_pulled", int(uids.shape[0]))
        _prof.bump_embed("pull_frames", frames)
        _prof.bump_embed("pull_bytes", int(rows.nbytes))
        _prof.bump_embed(
            "bytes_saved_vs_dense",
            int((self.vocab - uids.shape[0]) * self.dim * itemsize))
        return rows

    def _push_rows(self, uids: np.ndarray, grads: np.ndarray) -> None:
        owners = self._plane.ring.shard_of(uids)
        frames = 0
        for s in range(self._plane.num_shards):
            mask = owners == s
            if not mask.any():
                continue
            client = self._plane._clients[s]
            sub_ids, sub_g = uids[mask], grads[mask]
            try:
                rep = client.embed_push(self.name, sub_ids, sub_g)
            except StalePushError:
                # SSP refusal self-heal (same discipline as the comm
                # plane's dense path): refresh our pulled-version with
                # a pull of the same rows, then retry exactly once
                _prof.bump_embed("stale_refreshes")
                client.embed_pull(self.name, sub_ids)
                rep = client.embed_push(self.name, sub_ids, sub_g)
            if isinstance(rep, dict) and "state_rows" in rep:
                # cumulative server-side gauge; max across shards'
                # reports would under-count a sharded table, so sum the
                # latest report per shard
                self._state_rows_seen[s] = int(rep["state_rows"])
                _prof.set_embed("state_rows_alloc",
                                sum(self._state_rows_seen.values()))
            frames += 1
        _prof.bump_embed("rows_pushed", int(uids.shape[0]))
        _prof.bump_embed("push_frames", frames)
        _prof.bump_embed("push_bytes", int(grads.nbytes))

    # -- the step API ----------------------------------------------------
    def prefetch(self, ids) -> PendingRows:
        """Dedup the batch's ids and start the partial pull.  With
        MXTPU_EMBED_PREFETCH (default) the per-shard frames run on the
        engine comms lane, so the caller's forward compute between
        `prefetch` and `lookup` overlaps the wire time."""
        uids, inverse, shape = self._dedup(ids)
        if bool(get_env("MXTPU_EMBED_PREFETCH")):
            from .engine import get_engine
            eng = get_engine()
            if self._engine_var is None:
                self._engine_var = eng.new_variable()
            fut = eng.push(lambda: self._pull_rows(uids),
                           mutable_vars=(self._engine_var,))
            return PendingRows(uids, inverse, shape, future=fut)
        return PendingRows(uids, inverse, shape,
                           rows=self._pull_rows(uids))

    def lookup(self, ids=None, pending: Optional[PendingRows] = None
               ) -> Lookup:
        """Gather the batch's rows on device: ``value[b] = table[ids[b]]``
        with shape ``ids.shape + (dim,)``.  Pass a `PendingRows` from an
        earlier `prefetch` to consume the overlapped pull; otherwise the
        pull happens here."""
        if pending is None:
            if ids is None:
                raise ValueError("lookup needs ids or a prefetch handle")
            pending = self.prefetch(ids)
        rows = pending.wait()
        dev = self.ctx.device
        inv = torch.from_numpy(pending.inverse.reshape(-1)).to(dev)
        dense = torch.from_numpy(rows).to(dev).index_select(0, inv)
        dense = dense.reshape(pending.batch_shape + (self.dim,))
        return Lookup(NDArray(dense, self.ctx), pending.uids,
                      pending.inverse, pending.batch_shape)

    def push_grad(self, lookup: Lookup, grad_out) -> None:
        """Row-sparse partial push of ``dL/d value``: segment-sum the
        batch gradient to the unique rows on the device, each row's
        contributions in batch order, then ship O(touched) rows to their
        owning shards.  The server applies them with the table's lazy
        per-row optimizer."""
        dev = self.ctx.device
        if isinstance(grad_out, NDArray):
            g = grad_out.data
        else:
            g = torch.as_tensor(np.asarray(grad_out) if not isinstance(
                grad_out, torch.Tensor) else grad_out)
        g = g.to(dev).reshape(-1, self.dim)
        inv = lookup.inverse.reshape(-1)
        order = np.argsort(inv, kind="stable")
        counts = np.bincount(inv, minlength=lookup.uids.shape[0])
        seg = _segment_sum(
            g.index_select(0, torch.from_numpy(order).to(dev)),
            torch.from_numpy(counts).to(dev))
        self._push_rows(lookup.uids, seg.detach().cpu().numpy().astype(
            self.dtype, copy=False))

    def pull_all(self) -> np.ndarray:
        """Dense full-table pull — the parity/eval baseline ONLY (this
        is exactly the O(vocab) transfer the plane exists to avoid; fine
        for small-vocab tests and end-of-training evaluation)."""
        return self._pull_rows(np.arange(self.vocab, dtype=np.int64))
