"""Overlapped, bucketed gradient-communication plane (the counterpart of
`mxnet_tpu/comm_plane.py`).

Every push, pull and pushpull of a `kvstore.KVStore` goes through its
plane.  Instead of one blocking collective (or one PS round trip) per
parameter key, strictly after backward, the plane issues O(#buckets)
comm rounds and overlaps them with compute:

**Bucketing.**  Dense, uncompressed gradients headed for the group's
collective (or the PS wire) are packed into dtype-homogeneous flat
buffers of at most ``MXTPU_COMM_BUCKET_BYTES`` (default 4 MiB): one
``all_gather_sum`` / one ``push_batch`` wire frame per bucket instead of
per key.  Bitwise equal to the per-key path: the group's sum adds the
ranks' contributions in rank order, elementwise
(`parallel.distributed.all_gather_sum`), so summing a concatenation
equals concatenating the sums, bit for bit.  Sparse, compressed, or
otherwise non-bucketable keys take the per-key path
(:meth:`~mxnet_tpu_torch.kvstore.KVStore._push_fallback`).

**Overlap.**  With ``MXTPU_COMM_OVERLAP=1`` (default), comm jobs run on
the Engine's worker pool serialized by one plane-owned engine variable:
``push`` enqueues and returns, ``pull`` attaches a pending handle to
each destination NDArray that resolves at its next read or write
(``NDArray._pending`` -> ``_resolve_pending``), and
``Engine.wait_for_all`` / ``NaiveEngine`` keep their usual semantics.
Device hand-offs: at submission the plane records a CUDA event on the
caller's current stream and the job's thread makes its own stream wait
on it before reading the gradients; a pull job synchronizes its stream
before its future resolves, so a pulled buffer is complete when the
caller's next kernel reads it.

**Priority.**  ``pushpull`` honors the P3/ByteScheduler discipline:
work is sorted by descending priority (gluon/Module pass ``-i`` per
layer) at submission, BEFORE the FIFO lane, because the collective path
needs every worker to issue collectives in the same order: a runtime
priority *queue* would make the issue order timing-dependent and
deadlock mismatched workers.  The cost of that determinism is
observable priority inversion (a later-submitted higher-priority job
waiting behind an earlier one), which the plane counts.

Observability: ``profiler.comm_counters()`` (bytes, frames, buckets,
overlap fraction, inversions) and the plane's bounded ``frame_log``
(kind / keys / priority / bytes per comm round, in issue order).

Kill switches: ``MXTPU_COMM_OVERLAP=0`` runs every job inline;
``MXTPU_COMM_BUCKET_BYTES=0`` disables bucketing.  Both together give
the per-key synchronous behavior.

**Elastic membership.**  Bucket packings are memoized per submission
signature (key/dtype/bytes/priority tuple), the *bucket plan*.  When
the PS membership epoch changes (`KVStore.check_epoch`), the plane
flushes every in-flight job and drops the plan cache
(:meth:`CommPlane.on_epoch_change`), so no bucketed collective or PS
batch frame ever spans two memberships.  Async pushes refused by the
server's bounded-staleness guard (`StalePushError`) self-heal: the plane
pulls the refused keys (refreshing this worker's pulled-version) and
retries the frame once.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import profiler as _prof
from . import telemetry as _tele
from .config import get_env

__all__ = ["CommPlane", "PendingPull", "bucket_bytes", "overlap_enabled"]


def bucket_bytes() -> int:
    """Bucket size target in bytes; <= 0 disables bucketing.  Read per
    call so tests can flip the kill switch at runtime."""
    return int(get_env("MXTPU_COMM_BUCKET_BYTES"))


def overlap_enabled() -> bool:
    return bool(get_env("MXTPU_COMM_OVERLAP"))


class PendingPull:
    """Handle to one destination array of an in-flight pull job.  The
    job's future resolves to the list of new buffers for every target
    it served; this handle picks its own.  `NDArray._resolve_pending`
    calls :meth:`result` at the array's next read/write."""

    __slots__ = ("_future", "_index")

    def __init__(self, future, index: int):
        self._future = future
        self._index = index

    def result(self):
        was_done = self._future.done()
        t0 = time.perf_counter()
        out = self._future.result()
        if not was_done:
            _prof.bump_comm("blocked_s", time.perf_counter() - t0)
        return out[self._index]


class _Item:
    """One key's worth of submitted comm work."""
    __slots__ = ("key", "value", "targets", "priority", "kind")

    def __init__(self, key, value, targets, priority, kind):
        self.key = key
        self.value = value        # locally-reduced NDArray (push), or None
        self.targets = targets    # [(out NDArray, device, np dtype)] or None
        self.priority = priority
        self.kind = kind          # 'bucket' | 'ps' | 'fallback'


def _nbytes(value) -> int:
    sp = getattr(value, "_sp_data", None)
    if sp is not None:
        # sparse payload: count what actually travels (kept rows +
        # index vector), NOT the dense shape — reading `.data` here
        # would densify the array just to size it
        ind = value._sp_indices
        total = sp.numel() * sp.element_size()
        total += ind.numel() * ind.element_size()
        indptr = getattr(value, "_sp_indptr", None)
        if indptr is not None:
            total += indptr.numel() * indptr.element_size()
        return total
    arr = value.data
    return max(1, arr.numel()) * arr.element_size()


def _cuda_device(values):
    """The first CUDA device among ``values``' tensors, or None."""
    for v in values:
        t = getattr(v, "_sp_data", None)
        if t is None and v is not None:
            t = v.data
        if t is not None and t.is_cuda:
            return t.device
    return None


class CommPlane:
    """Per-KVStore gradient-communication scheduler (see module doc)."""

    def __init__(self, kv):
        self._kv = kv
        self._lock = threading.Lock()
        self._engine_var = None
        self._seq = 0
        # (priority, seq) of submitted-but-not-started jobs, for the
        # inversion counter
        self._queued: List[Tuple[int, int]] = []
        self.frame_log: List[Dict[str, Any]] = []
        self._log_cap = 4096
        # memoized bucket plans (signature -> index lists), dropped
        # whenever the membership epoch changes so bucketed collectives
        # never mix memberships
        self._plan_cache: Dict[Any, List[List[int]]] = {}
        self._epoch = 0

    # ------------------------------------------------------------------
    # scheduling substrate
    # ------------------------------------------------------------------
    def _overlap_on(self) -> bool:
        """Overlap applies to stores with real comms (dist collectives
        or the PS wire); local/device stores stay inline-synchronous."""
        kv = self._kv
        return overlap_enabled() and (
            kv._ps is not None or kv._name.startswith("dist"))

    def _submit(self, fn, priority: int, overlap: bool, device=None):
        """Run ``fn`` on the comms lane.  Overlap on: enqueued on the
        engine pool serialized by this plane's ordering var — strict
        FIFO, so the collective issue order is the (deterministic)
        submission order on every worker.  Overlap off: run inline.
        Returns the engine Future, or None when run inline.  ``overlap``
        is decided ONCE per public call so a mid-call env flip cannot
        strand half a submission on the wrong lane."""
        if not overlap:
            fn()
            return None
        from .engine import get_engine
        eng = get_engine()
        # the gradients were made on the caller's stream: the job's
        # thread waits on this event before its first read of them
        ready = None
        if device is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        # capture the submitter's trace id: the job body runs on the
        # comms lane thread, whose thread-local context is empty — this
        # is what stitches a training step's trace through its async
        # pushes (and onward over the wire to the PS server)
        tid = _tele.current_trace()
        with self._lock:
            if self._engine_var is None:
                self._engine_var = eng.new_variable()
            self._seq += 1
            token = (int(priority), self._seq)
            self._queued.append(token)

        def run():
            with self._lock:
                try:
                    self._queued.remove(token)
                except ValueError:
                    pass
                if any(p > token[0] for p, _ in self._queued):
                    # a higher-priority job is waiting behind this one:
                    # the price of deterministic collective ordering
                    _prof.bump_comm("inversions")
            t0 = time.perf_counter()
            if ready is not None:
                torch.cuda.current_stream(device).wait_event(ready)
            try:
                if tid is None:
                    return fn()
                with _tele.trace(tid):
                    return fn()
            finally:
                _prof.bump_comm("busy_s", time.perf_counter() - t0)

        return eng.push(run, mutable_vars=(self._engine_var,))

    def flush(self):
        """Barrier: wait for every submitted comm job to complete (and
        re-raise the first failure).  Store-mutating control ops
        (init / set_optimizer / barrier / checkpoint IO) call this so
        they never race in-flight gradient traffic."""
        if self._engine_var is None:
            return
        from .engine import get_engine
        t0 = time.perf_counter()
        get_engine().wait_for_var(self._engine_var)
        dt = time.perf_counter() - t0
        if dt > 1e-6:
            _prof.bump_comm("blocked_s", dt)

    def _log(self, kind: str, keys: Sequence, priority: int, nbytes: int):
        rec = {"kind": kind, "keys": list(keys),
               "priority": int(priority), "bytes": int(nbytes)}
        with self._lock:
            self.frame_log.append(rec)
            if len(self.frame_log) > self._log_cap:
                del self.frame_log[:len(self.frame_log) - self._log_cap]
        # every comm frame is a telemetry event too (flight recorder +
        # merged trace); runs on the comms lane with the submitter's
        # trace ambient, so frames join their training step's trace
        _tele.event(f"comm.{kind}", nkeys=len(rec["keys"]),
                    bytes=rec["bytes"], priority=rec["priority"])

    # ------------------------------------------------------------------
    # classification / bucketing
    # ------------------------------------------------------------------
    @staticmethod
    def _norm_priorities(n: int, priority) -> List[int]:
        if isinstance(priority, (list, tuple)):
            if len(priority) != n:
                raise ValueError(
                    f"got {len(priority)} priorities for {n} keys")
            return [int(p) for p in priority]
        return [int(priority)] * n

    def _classify(self, merged) -> str:
        """Which lane a locally-reduced dense/sparse value takes."""
        kv = self._kv
        if kv._ps is not None:
            return "ps"
        from .ndarray.sparse import BaseSparseNDArray
        if (isinstance(merged, BaseSparseNDArray) or kv._gc is not None
                or not kv._name.startswith("dist")
                or bucket_bytes() <= 0):
            return "fallback"
        return "bucket"

    def _pack_buckets(self, items: List[_Item],
                      size_of) -> List[List[_Item]]:
        """Greedy order-preserving packing under the byte cap.  Items
        arrive priority-sorted; buckets keep that order.  ``size_of``
        maps an item to its payload bytes.  The packing (the *bucket
        plan*) is memoized per submission signature and invalidated on
        membership-epoch change — see :meth:`on_epoch_change`."""
        cap = max(1, bucket_bytes())
        sizes = [size_of(it) for it in items]
        sig = (cap, tuple(
            (it.key,
             str(it.value._tdtype) if it.value is not None else None,
             nb, it.priority, it.kind)
            for it, nb in zip(items, sizes)))
        with self._lock:
            plan = self._plan_cache.get(sig)
        if plan is not None:
            _prof.bump_comm("bucket_plan_hits")
            return [[items[i] for i in b] for b in plan]
        _prof.bump_comm("bucket_plan_misses")
        buckets: List[List[int]] = []
        open_ent: Dict[Any, list] = {}   # group key -> [bucket, bytes]
        for idx, it in enumerate(items):
            gk = it.value._tdtype if it.value is not None else None
            nb = sizes[idx]
            ent = open_ent.get(gk)
            if ent is not None and ent[1] + nb > cap:
                ent = None
            if ent is None:
                ent = [[], 0]
                buckets.append(ent[0])
            ent[0].append(idx)
            ent[1] += nb
            open_ent[gk] = ent
        with self._lock:
            if len(self._plan_cache) > 256:
                self._plan_cache.clear()
            self._plan_cache[sig] = buckets
        return [[items[i] for i in b] for b in buckets]

    def on_epoch_change(self, epoch: Optional[int] = None):
        """Membership-epoch transition: drain every in-flight comm job
        (rounds issued under the old membership complete before any new
        one starts) and drop the memoized bucket plans, so no bucket or
        PS batch frame ever spans two memberships."""
        self.flush()
        with self._lock:
            self._plan_cache.clear()
            if epoch is not None:
                self._epoch = int(epoch)
        _prof.bump_comm("epoch_changes")

    def _sorted_items(self, items: List[_Item]) -> List[_Item]:
        """Deterministic priority order: descending priority, stable on
        submission index (the P3 discipline — see module doc)."""
        return [items[i] for i in sorted(
            range(len(items)),
            key=lambda i: (-items[i].priority, i))]

    @staticmethod
    def _runs(items: List[_Item]):
        """Split a sorted item list into maximal same-kind runs so
        mixed submissions keep their global priority order."""
        run: List[_Item] = []
        for it in items:
            if run and run[-1].kind != it.kind:
                yield run[0].kind, run
                run = []
            run.append(it)
        if run:
            yield run[0].kind, run

    # ------------------------------------------------------------------
    # job bodies (run on the comms lane)
    # ------------------------------------------------------------------
    def _run_bucket_push(self, items: List[_Item]):
        """One comm round for a dtype-homogeneous bucket: flatten +
        concat, one sum over the group, split + apply per key.

        With one process the sum is the identity and concat→slice→reshape
        is a bitwise no-op, so the flat buffer is skipped entirely — the
        bucket still counts as ONE frame (it is one comm round; there is
        just no wire under it)."""
        from .ndarray.ndarray import NDArray
        from .parallel import distributed as _dist
        kv = self._kv
        nbytes = sum(_nbytes(it.value) for it in items)
        _prof.bump_comm("frames")
        _prof.bump_comm("buckets")
        _prof.bump_comm("bytes", nbytes)
        self._log("allreduce", [it.key for it in items],
                  items[0].priority, nbytes)
        if _dist.size() <= 1:
            for it in items:
                kv._apply_push_merged(it.key, it.value)
            return
        flats = [it.value.data.reshape(-1) for it in items]
        flat = flats[0] if len(flats) == 1 else torch.cat(flats)
        flat = _dist.all_gather_sum(flat)
        off = 0
        for it in items:
            n = max(1, it.value.size)
            seg = flat[off:off + n].reshape(it.value.shape)
            off += n
            kv._apply_push_merged(it.key, NDArray(seg, it.value.context))

    def _run_fallback_push(self, items: List[_Item]):
        from .ndarray.sparse import BaseSparseNDArray
        kv = self._kv
        for it in items:
            _prof.bump_comm("fallback_keys")
            # split the fallback cause: sparse values can never bucket
            # (a capacity fact), dense ones here mean bucketing was off
            # or compression was on (a configuration fact)
            _prof.bump_comm("fallback_keys_sparse"
                            if isinstance(it.value, BaseSparseNDArray)
                            else "fallback_keys_dense")
            if kv._name.startswith("dist"):
                # per-key comm round (what bucketing collapses)
                _prof.bump_comm("frames")
                _prof.bump_comm("bytes", _nbytes(it.value))
                self._log("push", [it.key], it.priority, _nbytes(it.value))
            kv._push_fallback(it.key, it.value)

    def _run_ps_push(self, items: List[_Item]):
        kv = self._kv
        nbytes = sum(_nbytes(it.value) for it in items)
        _prof.bump_comm("frames")
        _prof.bump_comm("buckets")
        _prof.bump_comm("bytes", nbytes)
        self._log("ps_push_batch", [it.key for it in items],
                  items[0].priority, nbytes)
        from .embedding_plane import embed_plane_enabled
        from .kvstore import _as_int_key
        from .ps_server import StalePushError, rsp_wire

        def _wire_val(v):
            sp = getattr(v, "_sp_indices", None)
            if sp is not None and getattr(v, "stype", "") == "row_sparse" \
                    and embed_plane_enabled():
                # ship O(touched) rows as a row-sparse wire value; the
                # server merges exactly the touched rows.  Ids must be
                # strictly ascending on the wire (the server's touched-
                # row bookkeeping and the rsp contract both assume it),
                # so coalesce duplicates here if the producer didn't.
                ids = sp.cpu().numpy().astype(np.int64)
                data = v.sp_data.asnumpy()
                if ids.size and not np.all(np.diff(ids) > 0):
                    uids, inv = np.unique(ids, return_inverse=True)
                    merged = np.zeros((uids.shape[0],) + data.shape[1:],
                                      data.dtype)
                    np.add.at(merged, inv, data)
                    ids, data = uids, merged
                return rsp_wire(ids, data)
            # kill switch / dense value: the pre-plane densifying path
            return v.asnumpy()

        pairs = [(_as_int_key(it.key), _wire_val(it.value))
                 for it in items]

        def _push_once():
            if len(pairs) == 1:
                kv._ps.push(*pairs[0])
            else:
                kv._ps.push_batch(pairs)

        try:
            _push_once()
        except StalePushError:
            # bounded-staleness refusal: pull the refused keys (the pull
            # refreshes this worker's server-side pulled-version) and
            # retry the frame ONCE — the staleness bound degrades into a
            # forced sync point instead of a lost gradient
            _prof.bump_comm("stale_refreshes")
            keys = [k for k, _v in pairs]
            vals = (kv._ps.pull_batch(keys) if len(keys) > 1
                    else [kv._ps.pull(keys[0])])
            for it, val in zip(items, vals):
                kv._cache(it.key, val)
            _push_once()

    def _run_local_pull(self, items: List[_Item]) -> list:
        """Read the store and stage each target's new buffer (a copy, so
        a later push into the store never reaches a pull not yet landed);
        returns the buffers in target order (PendingPull picks by
        index)."""
        kv = self._kv
        out = []
        for it in items:
            src = kv._store[it.key]
            for _o, dev, dt, _shp in it.targets:
                out.append(src.data.to(device=dev, dtype=dt, copy=True))
        return _staged(out)

    def _run_ps_pull(self, items: List[_Item]) -> list:
        from .kvstore import _as_int_key
        kv = self._kv
        keys = [_as_int_key(it.key) for it in items]
        nbytes = sum(_item_pull_bytes(it) for it in items)
        _prof.bump_comm("frames")
        _prof.bump_comm("bytes", nbytes)
        self._log("ps_pull_batch", [it.key for it in items],
                  items[0].priority, nbytes)
        try:
            vals = (kv._ps.pull_batch(keys) if len(keys) > 1
                    else [kv._ps.pull(keys[0])])
        except RuntimeError as e:
            if "not initialized" in str(e):
                from .base import MXNetError
                raise MXNetError(
                    f"key {keys[0]!r} has not been initialized") from e
            raise
        out = []
        for it, val in zip(items, vals):
            # cache the server's latest value like the per-key path did
            src = kv._cache(it.key, val,
                            it.targets[0][1] if it.targets else None)
            for _o, dev, dt, _shp in it.targets:
                out.append(src.data.to(device=dev, dtype=dt, copy=True))
        return _staged(out)

    # ------------------------------------------------------------------
    # pull plumbing (pending handles vs inline apply)
    # ------------------------------------------------------------------
    def _submit_pull(self, kind: str, items: List[_Item], overlap: bool):
        if kind == "ps":
            runner = self._run_ps_pull
        else:
            # local broadcast (no wire on the collective path): logged
            # for the ordering tests, not counted as a comm frame
            def runner(its=items, knd=kind):
                self._log("bcast" if knd == "bucket" else "pull",
                          [it.key for it in its], its[0].priority, 0)
                return self._run_local_pull(its)
        targets = [t for it in items for t in it.targets]
        if not targets:
            return
        if not overlap:
            bufs = runner(items)
            for (o, _dev, _dt, _shp), buf in zip(targets, bufs):
                o._set_data(buf)
            return
        fut = self._submit(lambda: runner(items), items[0].priority, True)
        for idx, (o, _dev, _dt, _shp) in enumerate(targets):
            o._pending = PendingPull(fut, idx)

    @staticmethod
    def _capture_targets(outs) -> list:
        """Snapshot each destination's device + dtype + shape on the
        caller's thread.  The job must NOT touch the out arrays at all
        (even reading ``.shape`` goes through ``.data`` and would
        resolve the very pending handle the job feeds — a
        self-deadlock); it works purely from these captures."""
        return [(o, o.data.device, o._tdtype, o.shape) for o in outs]

    # ------------------------------------------------------------------
    # public API (called by KVStore)
    # ------------------------------------------------------------------
    def push(self, pairs, priority=0):
        """``pairs``: [(key, locally-reduced NDArray)].  Buckets and
        enqueues the cross-worker aggregation + apply."""
        overlap = self._overlap_on()
        prios = self._norm_priorities(len(pairs), priority)
        items = [_Item(k, v, None, p, self._classify(v))
                 for (k, v), p in zip(pairs, prios)]
        for kind, run in self._runs(self._sorted_items(items)):
            self._emit_push(kind, run, overlap)

    def _emit_push(self, kind: str, run: List[_Item], overlap: bool):
        if kind == "bucket":
            for b in self._pack_buckets(run, _item_push_bytes):
                self._submit(lambda b=b: self._run_bucket_push(b),
                             b[0].priority, overlap, _device_of(b))
        elif kind == "ps":
            frames = (self._pack_buckets(run, _item_push_bytes)
                      if bucket_bytes() > 0 else [[it] for it in run])
            for f in frames:
                self._submit(lambda f=f: self._run_ps_push(f),
                             f[0].priority, overlap, _device_of(f))
        else:
            self._submit(lambda r=run: self._run_fallback_push(r),
                         run[0].priority, overlap, _device_of(run))

    def pull(self, pairs, priority=0):
        """``pairs``: [(key, [out NDArray, ...])]."""
        overlap = self._overlap_on()
        prios = self._norm_priorities(len(pairs), priority)
        items = [_Item(k, None, self._capture_targets(outs), p,
                       "ps" if self._kv._ps is not None else
                       ("bucket" if self._kv._name.startswith("dist")
                        and bucket_bytes() > 0 else "fallback"))
                 for (k, outs), p in zip(pairs, prios)]
        for kind, run in self._runs(self._sorted_items(items)):
            self._emit_pull(kind, run, overlap)

    def _emit_pull(self, kind: str, run: List[_Item], overlap: bool):
        if kind == "ps":
            frames = (self._pack_buckets(run, _item_pull_bytes)
                      if bucket_bytes() > 0 else [[it] for it in run])
            for f in frames:
                self._submit_pull("ps", f, overlap)
        elif kind == "bucket":
            # local broadcast: no wire, group per bucket for one job
            for b in self._pack_buckets(run, _item_pull_bytes):
                self._submit_pull("bucket", b, overlap)
        else:
            for it in run:
                self._submit_pull("fallback", [it], overlap)

    def pushpull(self, push_pairs, pull_pairs, priority=0):
        """Interleaved push→pull per bucket: each bucket's pull is
        enqueued immediately after its push, so front-layer params land
        before back-layer buckets even start — with overlap off this is
        still the same ordered, deterministic sequence."""
        overlap = self._overlap_on()
        n = len(push_pairs)
        prios = self._norm_priorities(n, priority)
        items = []
        for ((k, v), (_k2, outs), p) in zip(push_pairs, pull_pairs, prios):
            it = _Item(k, v, self._capture_targets(outs), p,
                       self._classify(v))
            items.append(it)
        for kind, run in self._runs(self._sorted_items(items)):
            if kind == "bucket":
                for b in self._pack_buckets(run, _item_push_bytes):
                    self._submit(lambda b=b: self._run_bucket_push(b),
                                 b[0].priority, overlap, _device_of(b))
                    self._submit_pull("bucket", b, overlap)
            elif kind == "ps":
                frames = (self._pack_buckets(run, _item_push_bytes)
                          if bucket_bytes() > 0 else [[it] for it in run])
                for f in frames:
                    self._submit(lambda f=f: self._run_ps_push(f),
                                 f[0].priority, overlap, _device_of(f))
                    self._submit_pull("ps", f, overlap)
            else:
                for it in run:
                    self._submit(
                        lambda it=it: self._run_fallback_push([it]),
                        it.priority, overlap, _device_of([it]))
                    self._submit_pull("fallback", [it], overlap)


def _item_push_bytes(it: _Item) -> int:
    return _nbytes(it.value)


def _item_pull_bytes(it: _Item) -> int:
    total = 0
    for _o, _dev, dt, shp in it.targets:
        total += (int(np.prod(shp, dtype=np.int64)) if shp else 1) \
            * dt.itemsize
    return max(1, total)


def _device_of(items: List[_Item]):
    """The CUDA device a push job's values live on, or None."""
    return _cuda_device([it.value for it in items])


def _staged(bufs: list) -> list:
    """A pull job's buffers, complete on the device before the job's
    future resolves (the caller's next kernel reads them on another
    stream)."""
    for dev in {b.device for b in bufs if b.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return bufs
