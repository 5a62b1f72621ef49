"""Host-side parameter server: the ByteDance fork's asynchronous training
hook (the counterpart of `mxnet_tpu/ps_server.py`, copied with its
semantics, wire ops, errors, counters and snapshot format; reference
`src/kvstore/kvstore_dist_server.h`).

The server and its client are numpy and sockets on the host, in both
packages, so a `PSClient` of either package talks to a `KVStoreServer` of
the other.  What differs here: the server's optimizer runs on host
tensors (``ctx=cpu()``, since a server process need not own a card), and
the optimizer blob that ``set_optimizer`` ships is the port's pickled
class.

The fork's one defining delta from upstream MXNet is BytePS async mode:
``sync_mode_ = !dmlc::GetEnv("BYTEPS_ENABLE_ASYNC", false)``
(`kvstore_dist_server.h:182`).  Semantics rebuilt here:

* **sync** (`kvstore_dist_server.h:784-806,365-380`): a worker's nth
  push to a key is round n's contribution to its merge buffer; when
  every worker's nth push has landed the round is applied — ``updater
  (key, merged, stored)`` when an optimizer runs on the server, else
  ``stored = merged`` (the ``CopyFromTo(update_buf->merged, &stored)``
  at h:374).  Pushes are ACKED IMMEDIATELY (ps-lite ZPush never holds
  the worker's ordered channel hostage — a blocking push would deadlock
  workers pushing keys in different orders); instead, a worker's PULL
  waits until every round its own pushes feed has applied, so
  pull-after-push always sees the fresh round and never a half-merged
  one.
* **async** (`kvstore_dist_server.h:786-792` ``stored += recved``):
  each push is applied IMMEDIATELY — ``updater(key, recved, stored)``
  with a server optimizer, else ``stored += recved`` — and returns
  without waiting for other workers.  Staleness is real: a fast worker
  sees its own updates before slow workers have pushed anything.

The transport is a length-prefixed TCP protocol instead of ps-lite/ZMQ —
same request surface (init / push / pull / set-optimizer / barrier /
stats, plus the multi-key ``push_batch`` / ``pull_batch`` frames the
comm plane batches small keys into), one thread per worker connection
on the server.  Frame bodies use the zero-pickle raw-buffer **wire
format v2** (`ps_wire.py`): struct headers (key / dtype / shape / seq)
followed by the raw tensor bytes, the ps-lite KVPairs shape.  Nothing
on the wire is pickled; the `set_optimizer` command's payload is an
opaque blob exactly as in the reference CommandHandle.

Fault tolerance (what ps-lite's van layer absorbs in the reference):

* **Idempotent wire protocol** — every request carries ``(worker_id,
  seq)``; the server keeps a per-worker dedup window (state-mutating
  ops only), so a retried push/barrier/init applies exactly once and a
  retry of a lost-reply request gets the ORIGINAL result back.
* **Transparent reconnect** — on any socket error or timeout the client
  discards the poisoned connection (a ``socket.timeout`` mid-reply
  leaves the length-prefixed stream desynchronized — the old socket is
  never reused), redials with exponential backoff + jitter under
  ``MXTPU_PS_RETRY_DEADLINE`` / ``MXTPU_PS_RETRY_BASE``, re-identifies
  via the ``hello`` handshake (round positions are keyed by worker id,
  so they survive), and replays the in-flight request.
* **Liveness + graceful degradation** — each client heartbeats on a
  side connection feeding a server-side lease table
  (``MXTPU_PS_HEARTBEAT_INTERVAL`` / ``MXTPU_PS_LEASE_TIMEOUT``).  When
  a lease expires mid-sync-round, blocked pulls/barriers fail with a
  structured error naming the dead worker (default) or, under
  ``MXTPU_PS_EVICT_DEAD=1``, the worker is evicted and remaining
  rounds complete at the reduced membership — logged and counted,
  never silent.  Any blocked wait is additionally bounded by
  ``MXTPU_PS_ROUND_TIMEOUT``.
* **Determinstic fault injection** — `fault_injection`
  wraps the client side of this transport (env hook
  ``MXTPU_PS_FAULT_PLAN`` or ``fault_injection.install``), so tests
  replay exact drop/duplicate/delay/kill interleavings.
* **Introspection** — a ``stats`` op reports rounds applied, pending
  rounds, live/dead/evicted workers and dedup hits;
  ``KVStoreServer.snapshot()`` / ``restore=`` pickle the durable state
  across a kill+restart.

Elastic membership (what the reference leaves to a full job restart):

* **Membership epochs** — membership is a first-class versioned state
  machine: every join / graceful leave / eviction bumps
  ``membership_epoch`` and lands in the ``membership_log``.  Each sync
  round and barrier is stamped with the epoch + expected contributor
  count at the moment it OPENS, so in-flight rounds complete at the old
  membership while rounds opened after the transition require the new
  one — memberships never mix inside a round, and there are no torn
  barriers.
* **join / leave wire ops** — a worker joins mid-run with the ``join``
  op (its per-key round positions are fast-forwarded past every round
  opened before its admission, and it is assigned the next free rank)
  or drains gracefully with ``leave`` (its past contributions stay
  merged; rounds it would have fed complete at the reduced count).
  Both are state-mutating and ride the (worker_id, seq) dedup window.
* **Rejoinable eviction** — an evicted or drained worker *identity*
  stays retired forever (its round positions are poisoned), but the
  process behind it may rejoin at any time under a FRESH worker_id via
  ``join``; every op from a retired identity returns the structured
  :class:`EvictedError` carrying that rejoin hint.
* **Bounded staleness (SSP)** — in async mode the server tracks a
  per-key version (bumped per applied push) and each worker's
  pulled-version per key.  With ``MXTPU_PS_MAX_STALENESS`` >= 0 a push
  whose own pulled-version is more than N versions behind is REFUSED
  with :class:`StalePushError` (the worker must pull — the comm plane
  auto-refreshes and retries once), and under
  ``MXTPU_PS_STALENESS_MODE=block`` a push that would leave any live
  member more than N versions behind BLOCKS until the laggard pulls or
  is presumed dead.  Staleness histograms export via ``stats``.

The synchronous data path of a ``dist_sync`` store is the process group's
collective in `kvstore.py`; this server exists so that ``dist_async`` +
``BYTEPS_ENABLE_ASYNC=1`` gives true asynchronous semantics rather than a
sync alias.
"""
from __future__ import annotations

import logging
import os
# mxtpu-lint: disable=pickle-in-wire -- the optimizer blob and the snapshot pickle optimizer objects (the reference's CommandHandle); tensor frames are the binary codec
import pickle
import random
import socket
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Set

import numpy as np

from . import config, fault_injection, ps_wire
from . import telemetry as _tele
# imported at module scope on purpose: server handler threads run while
# the main thread may still be inside the package's import (the reference
# server role's serve_forever happens during package import), and a lazy
# ``from . import profiler`` there blocks forever on the package's
# import lock.  telemetry (above) already finished importing profiler,
# so this is cycle-free.
from . import profiler as _prof

__all__ = ["KVStoreServer", "PSClient", "PSError", "DeadWorkerError",
           "RoundTimeoutError", "EvictedError", "StalePushError",
           "async_enabled", "ps_port", "resolve_addr"]

# framing is shared with every other wire-v2 transport (serving front
# door included) — ps_wire owns the length prefix and its bounds check
_LEN = ps_wire.LEN_PREFIX
_LOG = logging.getLogger("mxnet_tpu_torch.ps_server")


class PSError(RuntimeError):
    """Base class for structured parameter-server failures."""


class DeadWorkerError(PSError):
    """A sync round or barrier is blocked by a worker whose liveness
    lease expired (``.worker`` names it)."""

    def __init__(self, msg, worker=None):
        super().__init__(msg)
        self.worker = worker


class RoundTimeoutError(PSError):
    """A blocked sync round/barrier exceeded MXTPU_PS_ROUND_TIMEOUT."""


class EvictedError(PSError):
    """This worker identity was retired from membership (evicted after
    its lease expired, or gracefully drained via ``leave``).  The
    IDENTITY stays dead — its sync-round positions are poisoned — but
    the process may rejoin at any time under a fresh worker_id:
    ``PSClient(..., worker_id=<new id>).join()`` (``.worker`` names the
    retired identity)."""

    def __init__(self, msg, worker=None):
        super().__init__(msg)
        self.worker = worker


class StalePushError(PSError):
    """An async push was refused by the bounded-staleness guard: the
    pusher's pulled-version of the key is more than
    ``MXTPU_PS_MAX_STALENESS`` versions behind (``.staleness`` /
    ``.max_staleness``).  Recovery: pull the key (refreshing the
    server-side pulled-version), then push again — the comm plane does
    this automatically once per frame."""

    def __init__(self, msg, staleness=None, max_staleness=None):
        super().__init__(msg)
        self.staleness = staleness
        self.max_staleness = max_staleness


_REJOIN_HINT = ("the identity stays retired; rejoin under a FRESH "
                "worker_id via PSClient(worker_id=...).join()")


def _cfg(name):
    from .config import get_env
    return get_env(name)


def async_enabled() -> bool:
    """The fork's hook, read the same way dmlc::GetEnv does
    (`kvstore_dist_server.h:182`)."""
    v = os.environ.get("BYTEPS_ENABLE_ASYNC", "")
    return v.lower() not in ("", "0", "false")


def ps_port() -> int:
    """The ONE port convention: MXTPU_PS_PORT, else one above the DMLC
    scheduler port.  Server bind and worker dial must both use this."""
    port = config.get_env("MXTPU_PS_PORT", 0)
    if port:
        return int(port)
    # mxtpu-lint: disable=raw-env-read -- DMLC_* is the launcher's wire
    # protocol (tracker-assigned per process), not a user knob
    return int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")) + 1


def resolve_addr():
    """Where the async PS lives, or None: explicit MXTPU_PS_ADDR wins;
    the DMLC-derived fallback applies only when the launcher actually
    spawned a server (DMLC_NUM_SERVER > 0) — otherwise dist_async must
    fall back to the warn-and-alias-sync path, not stall dialing a
    server that does not exist."""
    addr = config.get_env("MXTPU_PS_ADDR")
    if addr:
        return addr
    # mxtpu-lint: disable=raw-env-read -- DMLC_* launcher protocol
    uri = os.environ.get("DMLC_PS_ROOT_URI")
    # mxtpu-lint: disable=raw-env-read -- DMLC_* launcher protocol
    n_srv = int(os.environ.get("DMLC_NUM_SERVER", "0"))
    if uri and n_srv > 0:
        return f"{uri}:{ps_port()}"
    return None


def _send_msg(sock: socket.socket, obj) -> int:
    """Encode one protocol message as a wire-v2 frame and send it;
    returns the frame's byte length (for the comm counters)."""
    return ps_wire.send_frame(sock, obj)


def _recv_msg(sock: socket.socket):
    # a malformed body (or implausible length prefix) raises
    # ps_wire.WireError (a ConnectionError): both ends treat it as a
    # poisoned connection, like a mid-frame desync — discard and
    # (client side) replay under the dedup window
    return ps_wire.recv_frame(sock)


_recv_exact = ps_wire.recv_exact


class _KeyState:
    __slots__ = ("pending", "rounds")

    def __init__(self):
        # round number -> [merge buffer, contributor wid set, dtype]; a
        # worker's nth push to the key is round n's contribution, so a
        # fast worker pushing ahead lands in a LATER round instead of
        # double-counting into the open one, and the contributor SET
        # (not a bare count) makes a duplicated delivery structurally
        # unable to over-fill a round
        self.pending: Dict[int, list] = {}
        self.rounds: int = 0     # completed (applied) rounds


class _WorkerState:
    """Per-worker durable identity: sync round positions (survive a
    reconnect), the idempotency dedup window, the liveness lease, and
    the elastic-membership / staleness bookkeeping."""
    __slots__ = ("pushes", "dedup", "max_seq", "lease", "joined_epoch",
                 "pulled", "last_pull_version", "async_pushes", "pulls")

    def __init__(self):
        self.pushes: Dict[Any, int] = {}
        # seq -> {"ev": Event, "resp": reply tuple once executed}.  An
        # entry present but unset means the op is STILL EXECUTING — a
        # retry joins that wait instead of re-applying.
        self.dedup: "OrderedDict[int, dict]" = OrderedDict()
        self.max_seq: int = 0
        self.lease: Optional[float] = None   # None = liveness not opted in
        # membership epoch at which this identity was admitted (0 for
        # workers present from the start) — a barrier round opened under
        # an older epoch must not count this worker's arrival
        self.joined_epoch: int = 0
        # async bounded staleness: per-key version at this worker's last
        # pull (init counts), plus observability counts
        self.pulled: Dict[Any, int] = {}
        self.last_pull_version: int = 0
        self.async_pushes: int = 0
        self.pulls: int = 0


# reserved key namespace for embedding tables inside the version /
# round-position maps ("\x00" cannot appear in user keys, which are
# ints or plain parameter names)
_EMBED_PREFIX = "\x00embed:"

_RSP_TAG = "__rsp__"


def rsp_wire(indices, data):
    """Wrap a row-sparse value for the wire: ``(tag, row ids, row
    block)``.  `push`/`push_batch` accept these in place of a dense
    ndarray — the server merges/applies only the named rows, so the
    frame carries O(touched rows) bytes instead of O(vocab)."""
    return (_RSP_TAG, np.asarray(indices, np.int64), np.asarray(data))


def _rsp_parts(value):
    if (isinstance(value, tuple) and len(value) == 3
            and value[0] == _RSP_TAG):
        return np.asarray(value[1], np.int64), np.asarray(value[2])
    return None


def _norm_push_val(value):
    rsp = _rsp_parts(value)
    return value if rsp is not None else np.asarray(value)


class _EmbedTable:
    """One server shard of a ``(vocab, dim)`` embedding table: rows and
    per-row optimizer state materialize lazily on first touch, so a
    shard's memory is O(rows ever touched), never O(vocab).  Row init
    is a pure function of ``(init seed, row id)``: any shard — and any
    shard restarted from a snapshot — materializes bit-identical rows,
    which is what lets the hash ring move a row between shards without
    shipping untouched state."""

    __slots__ = ("vocab", "dim", "dtype", "init_kind", "init_scale",
                 "init_seed", "rows", "state", "opt", "rounds", "pending",
                 "row_updates", "state_rows_alloc")

    def __init__(self, vocab, dim, dtype="float32", init_kind="normal",
                 init_scale=0.01, init_seed=0):
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.init_kind = str(init_kind)
        self.init_scale = float(init_scale)
        self.init_seed = int(init_seed)
        self.rows: Dict[int, np.ndarray] = {}
        self.state: Dict[int, np.ndarray] = {}
        self.opt: Optional[Dict[str, Any]] = None
        # sync-mode round accounting (mirrors _KeyState, but the merge
        # buffer is a {row id: f64 row} dict — O(touched), never dense):
        # round -> [acc dict, contributor wid set, epoch, expected]
        self.rounds = 0
        self.pending: Dict[int, list] = {}
        self.row_updates = 0
        self.state_rows_alloc = 0

    def row(self, rid: int) -> np.ndarray:
        r = self.rows.get(rid)
        if r is None:
            if self.init_kind == "zeros":
                r = np.zeros(self.dim, self.dtype)
            else:
                rng = np.random.RandomState(
                    (self.init_seed * 1000003 + rid) % 2147483629)
                if self.init_kind == "uniform":
                    r = ((rng.rand(self.dim) * 2.0 - 1.0)
                         * self.init_scale).astype(self.dtype)
                else:  # "normal"
                    r = (rng.randn(self.dim)
                         * self.init_scale).astype(self.dtype)
            self.rows[rid] = r
        return r

    def apply_row(self, rid: int, grad: np.ndarray) -> None:
        """One row's update with lazily-allocated optimizer state (the
        sparse-optimizer contract: rows a batch never touches cost no
        state memory and no compute)."""
        w = self.row(rid)
        self.row_updates += 1
        opt = self.opt
        if opt is None:
            w += np.asarray(grad, w.dtype)  # plain aggregate
            return
        g = np.asarray(grad, np.float64)
        rescale = float(opt.get("rescale_grad", 1.0))
        if rescale != 1.0:
            g = g * rescale
        wd = float(opt.get("wd", 0.0))
        if wd:
            g = g + wd * w.astype(np.float64)
        lr = float(opt.get("lr", 0.01))
        if opt.get("kind", "sgd") == "adagrad":
            h = self.state.get(rid)
            if h is None:
                h = np.zeros(self.dim, np.float64)
                self.state[rid] = h
                self.state_rows_alloc += 1
            h += g * g
            eps = float(opt.get("eps", 1e-7))
            w -= (lr * g / (np.sqrt(h) + eps)).astype(w.dtype)
        else:  # sgd, optional momentum
            mom = float(opt.get("momentum", 0.0))
            if mom:
                m = self.state.get(rid)
                if m is None:
                    m = np.zeros(self.dim, np.float64)
                    self.state[rid] = m
                    self.state_rows_alloc += 1
                m *= mom
                m -= lr * g
                w += m.astype(w.dtype)
            else:
                w -= (lr * g).astype(w.dtype)


# ops that mutate server state and therefore must apply exactly once;
# pull/stats/heartbeat/membership are read-only or naturally idempotent
# and bypass the window (their duplicated replies are discarded
# client-side by seq)
_DEDUP_OPS = frozenset({"init", "push", "push_batch", "barrier",
                        "set_optimizer", "join", "leave",
                        "embed_init", "embed_set_optimizer", "embed_push"})


class KVStoreServer:
    """The server role of `tools/launch.py` (reference DMLC_ROLE=server,
    `kvstore_dist_server.h:KVStoreDistServer`)."""

    def __init__(self, num_workers: int, port: int = 0,
                 host: str = "127.0.0.1", restore: Optional[bytes] = None):
        self.num_workers = int(num_workers)
        self.sync_mode = not async_enabled()  # kvstore_dist_server.h:182
        self._store: Dict[Any, np.ndarray] = {}
        self._state: Dict[Any, _KeyState] = {}
        # sparse embedding tables (embedding_plane.py server side): a
        # separate namespace — table rows never mix with dense keys
        self._embed: Dict[str, _EmbedTable] = {}
        # worker id (from the "hello" handshake) -> durable state; lets a
        # reconnecting worker resume its round positions and replay its
        # in-flight request against the dedup window
        self._workers: Dict[Any, _WorkerState] = {}
        self._dead: Set[Any] = set()      # lease expired, not (yet) evicted
        self._evicted: Set[Any] = set()   # removed from sync membership
        self._left: Set[Any] = set()      # gracefully drained (retired too)
        # -- elastic membership state machine ----------------------------
        self._epoch = 0                   # bumps on every join/leave/evict
        self._size = self.num_workers     # current membership size
        self._joined: Set[Any] = set()    # identities admitted via `join`
        self._ranks: Dict[Any, int] = {}  # wid -> dense rank, compacted
        self._membership_log: list = []   # [{epoch, event, worker, size}]
        # -- async bounded staleness --------------------------------------
        self._versions: Dict[Any, int] = {}        # key -> applied pushes
        self._staleness_hist: Dict[int, int] = {}  # staleness -> count
        self._updater: Optional[Callable] = None
        self._updater_blob: Optional[bytes] = None
        self._lock = threading.Condition()
        self._barrier_round = 0
        self._barrier_arrived: Set[Any] = set()
        # expected count + epoch stamped when a barrier round OPENS (first
        # arrival), so a membership change mid-barrier cannot tear it
        self._barrier_expected: Optional[int] = None
        self._barrier_epoch = 0
        self.counters: Dict[str, int] = {
            "rounds_applied": 0, "dedup_hits": 0, "stale_dups": 0,
            "evictions": 0, "heartbeats": 0, "dead_worker_errors": 0,
            "round_timeouts": 0, "max_round_contribs": 0,
            "joins": 0, "leaves": 0,
            "stale_push_refusals": 0, "stale_push_blocks": 0}
        # publish this server's counters + core gauges on the one
        # metrics surface (latest server in the process wins the name)
        _prof.register_metrics_family(
            "ps_server", lambda: dict(
                self.counters,
                keys=len(self._store),
                membership_epoch=self._epoch,
                membership_size=self._size,
                staleness_hist={str(k): v for k, v in
                                self._staleness_hist.items()}))
        self._conns: Set[socket.socket] = set()
        self._stop = threading.Event()
        if restore is not None:
            self._restore(restore)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            # a server restarted after a crash must rebind its port even
            # while the dead incarnation's accepted sockets linger in
            # FIN_WAIT (REUSEADDR alone only covers TIME_WAIT)
            self._sock.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEPORT, 1)
        self._sock.bind((host, port))
        # every worker dials TWICE (data + heartbeat side connection),
        # and reconnect storms after a fault add more: an undersized
        # backlog silently delays the liveness plane under load
        self._sock.listen(max(16, 2 * self.num_workers + 4))
        self.port = self._sock.getsockname()[1]
        threading.Thread(target=self._monitor_loop, daemon=True,
                         name="ps-lease-monitor").start()

    # -- env knobs (read per use so tests can flip them at runtime) ------
    @staticmethod
    def _lease_timeout() -> float:
        return float(_cfg("MXTPU_PS_LEASE_TIMEOUT"))

    @staticmethod
    def _round_timeout() -> float:
        return float(_cfg("MXTPU_PS_ROUND_TIMEOUT"))

    @staticmethod
    def _dedup_window() -> int:
        return int(_cfg("MXTPU_PS_DEDUP_WINDOW"))

    @staticmethod
    def _max_staleness() -> int:
        v = _cfg("MXTPU_PS_MAX_STALENESS")
        return int(v) if v is not None else -1

    @staticmethod
    def _staleness_mode() -> str:
        return str(_cfg("MXTPU_PS_STALENESS_MODE") or "refuse")

    def _expected(self) -> int:
        """How many contributors a NEWLY-OPENED sync round needs: the
        current membership size (configured workers, plus joins, minus
        leaves/evictions), floored at 1 so a lone survivor proceeds.
        Already-open rounds use the count stamped at their open."""
        return max(1, self._size)

    def _retired(self, wid) -> bool:
        """A retired identity (evicted or drained) can never act again;
        the process rejoins under a fresh worker_id."""
        return wid in self._evicted or wid in self._left

    def _retired_err(self, wid):
        how = ("was evicted from membership after its lease expired"
               if wid in self._evicted else "left the job (drained)")
        return ("err", f"worker {wid!r} {how}; {_REJOIN_HINT}",
                {"kind": "evicted", "worker": wid})

    # -- lifecycle -------------------------------------------------------
    def serve_forever(self):
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()
        try:
            self._sock.close()
        except OSError:
            pass

    def start(self) -> "KVStoreServer":
        threading.Thread(target=self.serve_forever, daemon=True).start()
        return self

    def shutdown(self):
        self._stop.set()
        with self._lock:
            self._lock.notify_all()

    def kill(self):
        """Abrupt crash (vs the graceful `shutdown`): every connection is
        reset without a farewell and the port is freed — tests restart a
        server from `snapshot()` on the same port to model recovery."""
        self._stop.set()
        with self._lock:
            self._lock.notify_all()
            conns = list(self._conns)
        try:
            self._sock.close()
        except OSError:
            pass
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    # -- durable state (kill + restart recovery) -------------------------
    def snapshot(self) -> bytes:
        """Pickle the durable state — store, per-key round accounting,
        per-worker round positions and dedup results, eviction set —
        enough for a restarted server on the same port to resume the job
        where the crash left it (clients replay their in-flight request;
        the restored dedup window keeps the replay exactly-once).
        Leases are NOT snapshot: workers re-announce liveness via
        heartbeats.  A server-side optimizer is re-installed from its
        original pickle, so optimizer slot state restarts fresh — exact
        for stateless optimizers like plain SGD."""
        with self._lock:
            state = {
                "num_workers": self.num_workers,
                "sync_mode": self.sync_mode,
                "store": {k: v.copy() for k, v in self._store.items()},
                "keys": {k: (st.rounds,
                             {r: (p[0].copy(), set(p[1]), p[2],
                                  p[3], p[4],
                                  (set(p[5]) if len(p) > 5
                                   and p[5] is not None else None))
                              for r, p in st.pending.items()})
                         for k, st in self._state.items()},
                "embed": {name: {
                    "meta": (t.vocab, t.dim, t.dtype.str, t.init_kind,
                             t.init_scale, t.init_seed),
                    "rows": {rid: v.copy() for rid, v in t.rows.items()},
                    "state": {rid: v.copy()
                              for rid, v in t.state.items()},
                    "opt": dict(t.opt) if t.opt is not None else None,
                    "rounds": t.rounds,
                    "pending": {r: ({rid: a.copy()
                                     for rid, a in p[0].items()},
                                    set(p[1]), p[2], p[3])
                                for r, p in t.pending.items()},
                    "row_updates": t.row_updates,
                    "state_rows_alloc": t.state_rows_alloc,
                } for name, t in self._embed.items()},
                "workers": {w: (dict(ws.pushes), ws.max_seq,
                                {s: e["resp"]
                                 for s, e in ws.dedup.items()
                                 if e["ev"].is_set()},
                                {"joined_epoch": ws.joined_epoch,
                                 "pulled": dict(ws.pulled),
                                 "last_pull_version": ws.last_pull_version,
                                 "async_pushes": ws.async_pushes,
                                 "pulls": ws.pulls})
                            for w, ws in self._workers.items()},
                "evicted": set(self._evicted),
                "left": set(self._left),
                "epoch": self._epoch,
                "size": self._size,
                "joined": set(self._joined),
                "ranks": dict(self._ranks),
                "membership_log": list(self._membership_log),
                "versions": dict(self._versions),
                "staleness_hist": dict(self._staleness_hist),
                "barrier_round": self._barrier_round,
                "updater_blob": self._updater_blob,
                "counters": dict(self.counters),
            }
        return pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)

    def _restore(self, blob: bytes) -> None:
        state = pickle.loads(blob)
        self.num_workers = state["num_workers"]
        self.sync_mode = state["sync_mode"]
        self._store = dict(state["store"])
        for k, (rounds, pending) in state["keys"].items():
            st = _KeyState()
            st.rounds = rounds
            for r, p in pending.items():
                p = list(p)
                if len(p) < 5:
                    p += [0, self.num_workers]
                if len(p) < 6:
                    p.append(None)  # pre-rsp snapshot: dense round
                st.pending[r] = p
            self._state[k] = st
        for name, e in state.get("embed", {}).items():
            t = _EmbedTable(*e["meta"])
            t.rows = dict(e["rows"])
            t.state = dict(e["state"])
            t.opt = e["opt"]
            t.rounds = e["rounds"]
            t.pending = {r: [dict(p[0]), set(p[1]), p[2], p[3]]
                         for r, p in e["pending"].items()}
            t.row_updates = e["row_updates"]
            t.state_rows_alloc = e["state_rows_alloc"]
            self._embed[name] = t
        for w, wstate in state["workers"].items():
            pushes, max_seq, dedup = wstate[:3]
            ws = _WorkerState()
            ws.pushes = pushes
            ws.max_seq = max_seq
            for s, resp in dedup.items():
                ev = threading.Event()
                ev.set()
                ws.dedup[s] = {"ev": ev, "resp": resp}
            if len(wstate) > 3:
                extra = wstate[3]
                ws.joined_epoch = extra.get("joined_epoch", 0)
                ws.pulled = dict(extra.get("pulled", {}))
                ws.last_pull_version = extra.get("last_pull_version", 0)
                ws.async_pushes = extra.get("async_pushes", 0)
                ws.pulls = extra.get("pulls", 0)
            self._workers[w] = ws
        self._evicted = set(state["evicted"])
        self._left = set(state.get("left", ()))
        self._epoch = state.get("epoch", 0)
        self._size = state.get(
            "size", max(1, self.num_workers - len(self._evicted)))
        self._joined = set(state.get("joined", ()))
        self._ranks = dict(state.get("ranks", {}))
        self._membership_log = list(state.get("membership_log", ()))
        self._versions = dict(state.get("versions", {}))
        self._staleness_hist = dict(state.get("staleness_hist", {}))
        self._barrier_round = state["barrier_round"]
        self.counters.update(state.get("counters", {}))
        if state.get("updater_blob"):
            from .optimizer import optimizer as opt
            self._updater_blob = state["updater_blob"]
            self._updater = opt.get_updater(
                pickle.loads(self._updater_blob))
        _LOG.info("ps: restored %d keys, %d workers, barrier round %d",
                  len(self._store), len(self._workers),
                  self._barrier_round)

    # -- liveness --------------------------------------------------------
    def _monitor_loop(self):
        while not self._stop.wait(0.1):
            now = time.monotonic()
            with self._lock:
                newly = [w for w, ws in self._workers.items()
                         if ws.lease is not None and now > ws.lease
                         and w not in self._dead
                         and not self._retired(w)]
                if not newly:
                    continue
                evict = bool(_cfg("MXTPU_PS_EVICT_DEAD"))
                for w in newly:
                    self._dead.add(w)
                    _LOG.warning(
                        "ps: worker %r presumed dead — no heartbeat "
                        "within its lease (MXTPU_PS_LEASE_TIMEOUT=%.3gs)",
                        w, self._lease_timeout())
                    if evict:
                        self._evict_locked(w)
                self._lock.notify_all()

    def _log_membership_locked(self, event: str, wid):
        self._membership_log.append({
            "epoch": self._epoch, "event": event, "worker": str(wid),
            "size": self._size, "time": time.time()})
        _tele.event("ps.membership", transition=event, worker=str(wid),
                    epoch=self._epoch, size=self._size)
        if len(self._membership_log) > 512:
            del self._membership_log[:len(self._membership_log) - 512]

    def _retire_locked(self, wid, event: str):
        """Shared join/leave/evict bookkeeping for a departure: bump the
        membership epoch, shrink the size, free + compact the rank table
        (ranks stay dense 0..size-1 so data-plane resharding is a pure
        function of the roster), and release anything the departed
        worker was the last holdout for."""
        self._epoch += 1
        self._size = max(0, self._size - 1)
        freed = self._ranks.pop(wid, None)
        if freed is not None:
            for w, r in self._ranks.items():
                if r > freed:
                    self._ranks[w] = r - 1
        ws = self._workers.get(wid)
        if ws is not None:
            ws.lease = None   # stop liveness-monitoring a retired identity
        self._dead.discard(wid)
        self._log_membership_locked(event, wid)
        # rounds and barriers the departed worker was the last holdout
        # for can now complete at the reduced membership
        for key, st in self._state.items():
            self._advance_rounds_locked(key, st)
        for name, tbl in self._embed.items():
            self._advance_embed_rounds_locked(name, tbl)
        self._check_barrier_locked()
        self._lock.notify_all()

    def _evict_locked(self, wid):
        if self._retired(wid):
            return
        self._evicted.add(wid)
        self.counters["evictions"] += 1
        _LOG.warning(
            "ps: evicted dead worker %r; sync membership now %d of %d "
            "configured workers (epoch %d) — subsequent rounds apply at "
            "the reduced count; %s", wid, max(1, self._size - 1),
            self.num_workers, self._epoch + 1, _REJOIN_HINT)
        self._retire_locked(wid, "evict")

    def _leave_locked(self, wid):
        """Graceful drain: past contributions stay merged; rounds opened
        before the leave complete without the leaver (reduced count)."""
        if self._retired(wid):
            return
        self._left.add(wid)
        self.counters["leaves"] += 1
        _LOG.info("ps: worker %r left gracefully; membership now %d "
                  "(epoch %d)", wid, max(0, self._size - 1),
                  self._epoch + 1)
        self._retire_locked(wid, "leave")

    @staticmethod
    def _open_max(st: _KeyState) -> int:
        """Highest round of `st` already opened (applied or pending) —
        rounds a joiner must NOT be expected to feed.  Pending rounds
        are contiguous above `rounds` (each worker pushes its rounds in
        order), so the max is well-defined."""
        return max([st.rounds] + list(st.pending))

    def _join_locked(self, wid, ws: _WorkerState):
        """Admit `wid` into membership at a new epoch.  Its per-key push
        positions fast-forward past every already-opened round, so its
        first push on each key lands in the first round opened under a
        membership that includes it."""
        if wid in self._joined or self._ranks.get(wid) is not None:
            # idempotent re-join of a current member (dedup covers the
            # retried frame; this covers a genuine second call)
            return {"epoch": self._epoch, "size": self._size,
                    "rank": self._ranks.get(wid),
                    "sync_mode": self.sync_mode}
        self._epoch += 1
        self._size += 1
        self._joined.add(wid)
        ws.joined_epoch = self._epoch
        rank = (max(self._ranks.values()) + 1 if self._ranks
                else self._size - 1)
        self._ranks[wid] = rank
        for key, st in self._state.items():
            ws.pushes[key] = self._open_max(st)
            if not self.sync_mode:
                # async: joiner starts current on every key it has not
                # pulled yet, so its first push is not spuriously stale
                ws.pulled.setdefault(key, self._versions.get(key, 0))
        for name, tbl in self._embed.items():
            ekey = _EMBED_PREFIX + name
            ws.pushes[ekey] = max([tbl.rounds] + list(tbl.pending))
            if not self.sync_mode:
                ws.pulled.setdefault(ekey, self._versions.get(ekey, 0))
        self.counters["joins"] += 1
        self._log_membership_locked("join", wid)
        _LOG.info("ps: worker %r joined at epoch %d (rank %d, "
                  "membership %d)", wid, self._epoch, rank, self._size)
        self._lock.notify_all()
        return {"epoch": self._epoch, "size": self._size, "rank": rank,
                "sync_mode": self.sync_mode}

    def _worker_locked(self, wid) -> _WorkerState:
        ws = self._workers.get(wid)
        if ws is None:
            ws = _WorkerState()
            self._workers[wid] = ws
        return ws

    def _handle_heartbeat(self, wid):
        with self._lock:
            if self._retired(wid):
                return
            ws = self._worker_locked(wid)
            ws.lease = time.monotonic() + self._lease_timeout()
            self.counters["heartbeats"] += 1
            if wid in self._dead:
                self._dead.discard(wid)
                _LOG.warning("ps: worker %r heartbeat resumed before "
                             "degradation; lease renewed", wid)
                self._lock.notify_all()

    # -- request handling (reference DataHandleEx / CommandHandle) -------
    def _serve_conn(self, conn: socket.socket):
        conn_state = {"wid": None, "ws": None, "stop_after_send": False}
        with self._lock:
            self._conns.add(conn)
        try:
            while not self._stop.is_set():
                msg = _recv_msg(conn)
                if msg is None:
                    return
                reply = self._handle_msg(msg, conn_state)
                if reply is not None:
                    _send_msg(conn, reply)
                if conn_state["stop_after_send"]:
                    self.shutdown()
                    return
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle_msg(self, msg, conn_state):
        op0 = msg[0]
        if op0 == "hb":
            # one-way liveness frame from the client's side connection
            self._handle_heartbeat(msg[1])
            return None
        if op0 == "hello":
            return self._handle_hello(msg[1], conn_state,
                                      msg[2] if len(msg) > 2 else None)
        if op0 == "req":
            _, wid, seq, op = msg[:4]
            args = tuple(msg[4:])
            # telemetry-aware clients append one trailing context dict
            # (reserved key) — strip it so ops see their exact arity.
            # No op takes a top-level dict with that key as its last
            # positional arg, so the strip is unambiguous; clients only
            # attach it after our hello advertised `telemetry`, so old
            # frames never carry it.
            ctx = None
            if args and isinstance(args[-1], dict) \
                    and _tele.CTX_KEY in args[-1]:
                ctx, args = args[-1], args[:-1]
            with _tele.adopt(ctx):
                return ("reply", seq,
                        self._execute(wid, seq, op, args, conn_state))
        # legacy bare (op, *args) frames: per-connection identity, no
        # dedup — a malformed request must not kill the connection
        if conn_state["ws"] is None:
            self._handle_hello(f"conn-{uuid.uuid4().hex[:8]}", conn_state)
        try:
            return self._exec_op(op0, tuple(msg[1:]), conn_state)
        except (ConnectionError, OSError):
            raise
        except Exception as e:
            return ("err", f"{type(e).__name__}: {e}")

    def _handle_hello(self, wid, conn_state, declared_rank=None):
        with self._lock:
            if self._retired(wid):
                return self._retired_err(wid)
            ws = self._worker_locked(wid)
            conn_state["wid"], conn_state["ws"] = wid, ws
            # a launcher-started worker declares its DMLC rank; first
            # claim wins so a reconnect cannot steal another's slot
            if (declared_rank is not None
                    and wid not in self._ranks
                    and int(declared_rank) not in self._ranks.values()):
                self._ranks[wid] = int(declared_rank)
            # max_seq lets a NEW client incarnation for this worker id
            # resume ABOVE the dedup window instead of colliding with a
            # previous incarnation's seqs (and silently replaying them)
            return ("ok", {"sync_mode": self.sync_mode,
                           "num_workers": self.num_workers,
                           "max_seq": ws.max_seq,
                           "epoch": self._epoch,
                           "size": self._size,
                           "rank": self._ranks.get(wid),
                           # capability flag: this server understands
                           # the optional trailing trace-context dict
                           "telemetry": 1})

    def _execute(self, wid, seq, op, args, conn_state):
        """Run one enveloped request through the idempotency window."""
        with self._lock:
            ws = self._worker_locked(wid)
            conn_state["wid"], conn_state["ws"] = wid, ws
            ent = ws.dedup.get(seq) if op in _DEDUP_OPS else None
            if ent is None and self._retired(wid):
                # EVERY new op from a retired identity — push/pull and
                # the batched wire-v2 frames included — gets the
                # structured EvictedError with the rejoin hint, never a
                # generic failure.  A RETRIED op whose original delivery
                # predates the retirement still gets its cached reply
                # (the `leave` op's own lost-ACK replay stays
                # idempotent).
                return self._retired_err(wid)
            if ws.lease is not None:  # any request is proof of life
                ws.lease = time.monotonic() + self._lease_timeout()
            cached = False
            if op in _DEDUP_OPS:
                if ent is not None:
                    cached = True
                    self.counters["dedup_hits"] += 1
                elif seq <= ws.max_seq:
                    # retried op whose window entry was already trimmed:
                    # re-applying could double-count — refuse loudly
                    self.counters["stale_dups"] += 1
                    return ("err",
                            f"seq {seq} of worker {wid!r} is outside the "
                            f"dedup window (newest seen {ws.max_seq}); "
                            "raise MXTPU_PS_DEDUP_WINDOW",
                            {"kind": "stale_seq"})
                else:
                    ent = {"ev": threading.Event(), "resp": None}
                    ws.dedup[seq] = ent
                    ws.max_seq = seq
                    self._trim_dedup_locked(ws)
        if cached:
            # the original delivery may still be executing (a replayed
            # barrier after reconnect): join its wait, reply with ITS
            # result so the op applies exactly once
            while not ent["ev"].wait(0.5):
                if self._stop.is_set():
                    return ("err", "server shut down before the retried "
                            "op completed", {"kind": "shutdown"})
            return ent["resp"]
        try:
            with _tele.span(f"ps.server.{op}", worker=str(wid), seq=seq):
                resp = self._exec_op(op, args, conn_state)
        except (ConnectionError, OSError):
            raise
        except Exception as e:
            resp = ("err", f"{type(e).__name__}: {e}")
        if isinstance(resp, tuple) and resp and resp[0] == "err":
            info = resp[2] if len(resp) > 2 and isinstance(resp[2], dict) \
                else {}
            _tele.event("ps.server.err", op=op, worker=str(wid),
                        err_kind=str(info.get("kind", "")),
                        msg=str(resp[1]))
        if ent is not None:
            ent["resp"] = resp
            ent["ev"].set()
        return resp

    def _trim_dedup_locked(self, ws: _WorkerState):
        limit = self._dedup_window()
        while len(ws.dedup) > limit:
            seq, ent = next(iter(ws.dedup.items()))
            if not ent["ev"].is_set():
                break  # never trim an op that is still executing
            del ws.dedup[seq]

    def _exec_op(self, op, args, conn_state):
        ws: _WorkerState = conn_state["ws"]
        wid = conn_state["wid"]
        if op == "init":
            key, value = args
            # set-if-absent: EVERY worker sends init (the MXNet contract —
            # all workers call kv.init with the same keys), the first to
            # arrive wins, and a worker's own init returning guarantees
            # the key exists on the server before its push/pull — no
            # init-vs-push race, no rank-0 barrier needed (the reference
            # solves the same race with a Barrier after init)
            with self._lock:
                if key not in self._store:
                    self._store[key] = np.array(value, copy=True)
                if not self.sync_mode:
                    # init counts as this worker's first sight of the key
                    # for the bounded-staleness guard
                    ws.pulled.setdefault(key, self._versions.get(key, 0))
            return ("ok",)
        if op == "push":
            key, value = args
            err = self._handle_push(key, _norm_push_val(value), wid, ws)
            return err if err is not None else ("ok",)
        if op == "push_batch":
            # multi-key frame (comm-plane bucketing): each key merges
            # into its own round exactly as a sequence of single pushes
            # would — one wire frame, one dedup seq, N contributions.
            # The bounded-staleness REFUSAL is checked for every key
            # before anything applies, so a refused frame is refused
            # whole (a partial apply + client retry under a fresh seq
            # would double-count the already-applied keys).
            pairs = [(k, _norm_push_val(v)) for k, v in args[0]]
            if not self.sync_mode:
                with self._lock:
                    for key, _v in pairs:
                        err = self._check_stale_locked(key, wid, ws)
                        if err is not None:
                            return err
            for key, value in pairs:
                err = self._handle_push(key, value, wid, ws)
                if err is not None:
                    return err
            return ("ok",)
        if op == "pull":
            return self._handle_pull(args[0], wid, ws)
        if op == "pull_batch":
            vals = []
            for key in args[0]:
                r = self._handle_pull(key, wid, ws)
                if r[0] != "ok":
                    return r  # first blocked/failed key fails the frame
                vals.append(r[1])
            return ("ok", vals)
        if op == "join":
            with self._lock:
                if self._retired(wid):
                    return self._retired_err(wid)
                return ("ok", self._join_locked(wid, ws))
        if op == "leave":
            with self._lock:
                self._leave_locked(wid)
                return ("ok", {"epoch": self._epoch})
        if op == "membership":
            return ("ok", self.membership_dict())
        if op == "set_optimizer":
            # reference CommandHandle: controller installs the pickled
            # optimizer as the server-side updater
            from .optimizer import optimizer as opt
            optimizer = pickle.loads(args[0])
            with self._lock:
                self._updater = opt.get_updater(optimizer)
                self._updater_blob = args[0]
            return ("ok",)
        if op == "barrier":
            return self._handle_barrier(wid)
        if op == "heartbeat":
            self._handle_heartbeat(wid)
            return ("ok",)
        if op == "stats":
            return ("ok", self.stats_dict())
        if op == "pull_rows":
            key, ids = args
            return self._handle_pull_rows(key, ids, wid, ws)
        if op == "embed_init":
            return self._handle_embed_init(args, wid, ws)
        if op == "embed_set_optimizer":
            name, spec = args
            spec = dict(spec)
            if str(spec.get("kind", "sgd")) not in ("sgd", "adagrad"):
                return ("err", "unsupported sparse optimizer "
                        f"{spec.get('kind')!r} (sgd or adagrad)")
            with self._lock:
                tbl = self._embed.get(name)
                if tbl is None:
                    return ("err",
                            f"embedding table {name!r} not initialized")
                tbl.opt = spec
            return ("ok",)
        if op == "embed_push":
            name, ids, grads = args
            return self._handle_embed_push(name, ids, grads, wid, ws)
        if op == "embed_pull":
            name, ids = args
            return self._handle_embed_pull(name, ids, wid, ws)
        if op == "stop":
            conn_state["stop_after_send"] = True
            return ("ok",)
        return ("err", f"unknown op {op!r}")

    def _apply(self, key, update, accumulate: bool):
        """`ApplyUpdates` (kvstore_dist_server.h:365): server-side
        optimizer when set, plain aggregate otherwise.  ``update`` may
        be a `rsp_wire` tuple: only the named rows are touched (scatter
        -add in async mode, row-copy in sync mode) unless an updater is
        installed, in which case the rows densify into a zero gradient
        — exactly what the worker-side densifying push produced before
        the embedding plane existed."""
        rsp = _rsp_parts(update)
        stored = self._store.get(key)
        if stored is None:  # first push doubles as init
            if rsp is not None:
                raise ValueError(
                    f"row-sparse push of key {key!r} requires init "
                    "first (the row payload has no full shape)")
            self._store[key] = np.array(update, copy=True)
            return
        if rsp is not None:
            ids, data = rsp
            if self._updater is not None:
                dense = np.zeros_like(stored)
                np.add.at(dense, ids, data.astype(stored.dtype))
                update = dense
            elif accumulate:
                np.add.at(stored, ids, data.astype(stored.dtype))
                return
            else:
                stored[ids] = data.astype(stored.dtype)
                return
        if self._updater is not None:
            # host tensors: the server process need not own a card
            from .context import cpu
            from .ndarray import array as _array
            g = _array(update, ctx=cpu())
            w = _array(stored, ctx=cpu())
            self._updater(key, g, w)
            self._store[key] = np.asarray(w.asnumpy())
        elif accumulate:
            stored += update.astype(stored.dtype)  # async: stored += recved
        else:
            # sync copy: CopyFromTo(update_buf->merged, &stored), h:374
            self._store[key] = np.array(update, copy=True)

    # -- async bounded staleness (SSP) ----------------------------------
    def _async_staleness_locked(self, key, ws: _WorkerState) -> int:
        return self._versions.get(key, 0) - ws.pulled.get(key, 0)

    def _check_stale_locked(self, key, wid, ws: _WorkerState):
        """Refusal guard: a push whose own pulled-version is more than
        MXTPU_PS_MAX_STALENESS versions behind the key is provably built
        on stale parameters — refuse it (blocking could never fix it:
        only this worker's own pull moves its pulled-version, and that
        pull is queued behind this very push on its ordered channel)."""
        n = self._max_staleness()
        if n < 0:
            return None
        s = self._async_staleness_locked(key, ws)
        if s <= n:
            return None
        self.counters["stale_push_refusals"] += 1
        return ("err",
                f"async push of key {key!r} by worker {wid!r} is {s} "
                f"versions stale (MXTPU_PS_MAX_STALENESS={n}); pull the "
                "key to refresh, then push again",
                {"kind": "stale_push", "staleness": s, "max": n,
                 "key": key})

    def _block_stale_locked(self, key, deadline: float):
        """MXTPU_PS_STALENESS_MODE=block: wait while applying one more
        push would leave any live member that has seen the key more
        than N versions behind.  The laggard's own pull (on its own
        connection) or its death releases the wait, so the block is
        deadlock-free.  Shared by the dense async push and the
        embedding-table partial push (version keys differ, logic
        doesn't).  Returns a structured error reply or None."""
        n = self._max_staleness()
        if n < 0 or self._staleness_mode() != "block":
            return None
        counted = False
        while not self._stop.is_set():
            ver = self._versions.get(key, 0)
            floor = min(
                (w.pulled[key] for ww, w in self._workers.items()
                 if key in w.pulled and not self._retired(ww)
                 and ww not in self._dead), default=ver)
            if ver + 1 - floor <= n:
                return None
            if not counted:
                self.counters["stale_push_blocks"] += 1
                counted = True
            if time.monotonic() > deadline:
                self.counters["round_timeouts"] += 1
                return ("err",
                        f"async push of key {key!r} blocked on a "
                        f"laggard {ver + 1 - floor - n} versions "
                        "past the staleness bound for "
                        f"MXTPU_PS_ROUND_TIMEOUT={self._round_timeout()}s",
                        {"kind": "round_timeout", "key": key})
            self._lock.wait(0.2)
        return ("err", "server shut down before the blocked "
                "push applied", {"kind": "shutdown"})

    def _async_push_locked(self, key, value, wid, ws: _WorkerState,
                           deadline: float):
        """Apply one async push.  Under MXTPU_PS_STALENESS_MODE=block the
        push first waits while applying it would leave any live member
        that has seen the key more than N versions behind — the laggard's
        own pull (on its own connection) or its death releases the wait,
        so the block is deadlock-free."""
        err = self._block_stale_locked(key, deadline)
        if err is not None:
            return err
        s = self._async_staleness_locked(key, ws)
        self._staleness_hist[s] = self._staleness_hist.get(s, 0) + 1
        ws.async_pushes += 1
        self._apply(key, value, accumulate=True)
        self._versions[key] = self._versions.get(key, 0) + 1
        self._lock.notify_all()
        return None

    def _handle_push(self, key, value: np.ndarray, wid, ws: _WorkerState):
        """Returns None on success or a structured ``("err", ...)`` reply
        (bounded-staleness refusal / block timeout)."""
        if not self.sync_mode:
            # BytePS async: apply immediately, respond immediately —
            # no cross-worker wait (kvstore_dist_server.h:786-792),
            # bounded only by the optional SSP staleness guard
            deadline = time.monotonic() + self._round_timeout()
            with self._lock:
                err = self._check_stale_locked(key, wid, ws)
                if err is None:
                    err = self._async_push_locked(key, value, wid, ws,
                                                  deadline)
            return err
        # sync merge, ps-lite style: the push is acked as soon as it is
        # merged (ZPush never holds the worker's channel hostage) — a
        # blocking push would deadlock two workers pushing keys in
        # different orders, since each worker has one ordered channel.
        # The worker's nth push is round n's contribution; a round
        # applies when every live worker's nth push has landed, strictly
        # in round order, and PULLS wait for the puller's own rounds.
        with self._lock:
            st = self._state.setdefault(key, _KeyState())
            r = ws.pushes.get(key, 0) + 1
            if r <= st.rounds:
                # a fresh identity (new anonymous client) restarts at
                # round 1; merging into an applied round would strand the
                # contribution in a dead buffer and stall every worker —
                # fail loudly instead (reconnecting workers must reuse a
                # stable worker id so their round counts survive; a NEW
                # process joins membership via the `join` op, which
                # fast-forwards its round positions)
                raise RuntimeError(
                    f"push targets round {r} of key {key!r} but round "
                    f"{st.rounds} already applied; reconnecting workers "
                    "must identify themselves (PSClient worker_id=...) "
                    "and new processes must join() first")
            # validate BEFORE counting: a failed merge must leave the
            # round accounting untouched so the worker can retry
            ent = st.pending.get(r)
            ref = ent[0] if ent is not None else self._store.get(key)
            rsp = _rsp_parts(value)
            if rsp is None:
                if ref is not None \
                        and tuple(ref.shape) != tuple(value.shape):
                    raise ValueError(
                        f"push shape {tuple(value.shape)} does not "
                        f"match {tuple(ref.shape)} for key {key!r}")
            else:
                ids, data = rsp
                if ref is None:
                    raise ValueError(
                        f"row-sparse push of key {key!r} requires init "
                        "first (the row payload has no full shape)")
                if tuple(data.shape[1:]) != tuple(ref.shape[1:]) \
                        or data.shape[0] != ids.shape[0]:
                    raise ValueError(
                        f"row-sparse push rows {tuple(data.shape)} do "
                        f"not match key {key!r} of shape "
                        f"{tuple(ref.shape)}")
                if ids.size and (int(ids.min()) < 0
                                 or int(ids.max()) >= ref.shape[0]):
                    raise ValueError(
                        f"row-sparse push row ids out of range for key "
                        f"{key!r} of shape {tuple(ref.shape)}")
            ws.pushes[key] = r
            if ent is None:
                # the round OPENS here: stamp the membership epoch and
                # expected contributor count — a join admitted later must
                # not be awaited by this round, and the stamp proves in
                # stats/tests that no round ever mixes memberships.
                # The 6th slot tracks the touched-row set while every
                # contribution is row-sparse (None = dense round): a
                # pure-rsp round applies as a row write of exactly those
                # rows, so the densified merge buffer never clobbers
                # untouched rows with zeros
                if rsp is None:
                    st.pending[r] = [np.array(value, dtype=np.float64,
                                              copy=True), {wid},
                                     value.dtype, self._epoch,
                                     self._expected(), None]
                else:
                    buf = np.zeros(ref.shape, np.float64)
                    np.add.at(buf, ids, data.astype(np.float64))
                    st.pending[r] = [buf, {wid}, data.dtype,
                                     self._epoch, self._expected(),
                                     set(map(int, ids.tolist()))]
            else:
                if rsp is None:
                    ent[0] += value
                    if len(ent) > 5:
                        ent[5] = None  # a dense contribution densifies
                else:
                    np.add.at(ent[0], ids, data.astype(np.float64))
                    if len(ent) > 5 and ent[5] is not None:
                        ent[5].update(map(int, ids.tolist()))
                ent[1].add(wid)
            self.counters["max_round_contribs"] = max(
                self.counters["max_round_contribs"],
                len(st.pending[r][1]))
            self._advance_rounds_locked(key, st)
        return None

    def _advance_rounds_locked(self, key, st: _KeyState):
        """Apply every completed round in strict order.  A round needs
        the contributor count stamped when it OPENED (its membership
        epoch) — never more, so workers joined later are not awaited —
        capped by the CURRENT expectation, so rounds a departed worker
        would have fed complete at the reduced count.  Merged
        contributions from a worker retired AFTER contributing are kept
        (they were legitimate when merged) but no longer counted."""
        while True:
            nxt = st.pending.get(st.rounds + 1)
            if nxt is None:
                break
            need = max(1, min(nxt[4], self._expected()))
            if len(nxt[1] - self._evicted - self._left) < need:
                break
            touched = nxt[5] if len(nxt) > 5 else None
            if touched is not None and self._updater is None:
                # a pure row-sparse round: write back exactly the rows
                # its contributions named (the dense merge buffer is
                # zero everywhere else and must not overwrite)
                ids = np.fromiter(sorted(touched), dtype=np.int64,
                                  count=len(touched))
                self._apply(key, (_RSP_TAG, ids,
                                  nxt[0][ids].astype(nxt[2])),
                            accumulate=False)
            else:
                self._apply(key, nxt[0].astype(nxt[2]),
                            accumulate=False)
            del st.pending[st.rounds + 1]
            st.rounds += 1
            self.counters["rounds_applied"] += 1
            self._lock.notify_all()

    def _handle_pull(self, key, wid, ws: _WorkerState):
        rt = self._round_timeout()
        start = time.monotonic()
        with self._lock:
            if self.sync_mode:
                # no staleness in sync mode: this worker's pull waits
                # until every round fed by its OWN pushes has applied
                # (reference queues pending pulls in DataHandleDefault
                # until ApplyUpdates; ps-lite orders by timestamp).
                # Waiting on rounds it has NOT pushed into would
                # deadlock: that round may need this very worker's next
                # push, which its blocked channel can't send.
                need = ws.pushes.get(key, 0)
                st = self._state.get(key)
                while (st is not None and st.rounds < need
                       and not self._stop.is_set()):
                    if self._retired(wid):
                        # evicted/drained MID-WAIT: the structured error
                        # with the rejoin hint, never a stale "ok"
                        return self._retired_err(wid)
                    blocked = st.rounds + 1
                    ent = st.pending.get(blocked)
                    contribs = ent[1] if ent is not None else set()
                    dead = sorted(map(str, (self._dead - self._evicted
                                            - self._left) - contribs))
                    if dead:
                        self.counters["dead_worker_errors"] += 1
                        return ("err",
                                f"sync round {blocked} of key {key!r} is "
                                f"blocked by dead worker {dead[0]} "
                                "(lease expired; set MXTPU_PS_EVICT_DEAD"
                                "=1 to continue at reduced membership)",
                                {"kind": "dead_worker",
                                 "worker": dead[0], "key": key,
                                 "round": blocked})
                    if time.monotonic() - start > rt:
                        self.counters["round_timeouts"] += 1
                        return ("err",
                                f"sync round {blocked} of key {key!r} "
                                "did not complete within "
                                f"MXTPU_PS_ROUND_TIMEOUT={rt}s "
                                f"({len(contribs)}/{self._expected()} "
                                "contributions)",
                                {"kind": "round_timeout", "key": key,
                                 "round": blocked})
                    self._lock.wait(0.2)
                if st is not None and st.rounds < need:
                    # released by shutdown, not by a completed round — a
                    # stale value with an "ok" reply would lie
                    return ("err", "server shut down before the sync "
                            "round completed", {"kind": "shutdown"})
            if self._retired(wid):
                return self._retired_err(wid)
            val = self._store.get(key)
            val = None if val is None else val.copy()
            if not self.sync_mode and val is not None:
                # bounded-staleness bookkeeping: this worker is now
                # current on `key`; laggard-blocked pushes re-evaluate
                ver = self._versions.get(key, 0)
                ws.pulled[key] = ver
                ws.last_pull_version = max(ws.last_pull_version, ver)
                ws.pulls += 1
                self._lock.notify_all()
        if val is None:
            # identifiable error instead of a dead connection (init
            # may still be in flight from another worker)
            return ("err", f"key {key!r} not initialized")
        return ("ok", val)

    def _handle_pull_rows(self, key, ids, wid, ws: _WorkerState):
        """Partial pull of a DENSE key: same wait/staleness semantics as
        `pull` (the shared `_handle_pull` does that bookkeeping), but the
        reply carries only the requested rows — the wire cost of
        `KVStore.row_sparse_pull` becomes O(touched rows)."""
        r = self._handle_pull(key, wid, ws)
        if r[0] != "ok":
            return r
        val = r[1]
        ids = np.asarray(ids, np.int64)
        if ids.size and (int(ids.min()) < 0
                         or int(ids.max()) >= val.shape[0]):
            return ("err", f"row ids out of range for key {key!r} of "
                    f"shape {tuple(val.shape)}")
        return ("ok", val[ids])

    # -- sparse embedding tables (embedding_plane.py server side) --------
    def _handle_embed_init(self, args, wid, ws: _WorkerState):
        name, vocab, dim, dtype, init_kind, scale, seed = args
        with self._lock:
            tbl = self._embed.get(name)
            if tbl is None:
                tbl = _EmbedTable(int(vocab), int(dim), dtype,
                                  str(init_kind), float(scale), int(seed))
                self._embed[name] = tbl
            if (tbl.vocab, tbl.dim) != (int(vocab), int(dim)):
                # set-if-absent like `init`: every worker announces the
                # table; the first to arrive wins, mismatches are loud
                return ("err",
                        f"embedding table {name!r} already exists with "
                        f"shape ({tbl.vocab}, {tbl.dim}), not "
                        f"({int(vocab)}, {int(dim)})")
            if not self.sync_mode:
                ekey = _EMBED_PREFIX + name
                ws.pulled.setdefault(ekey, self._versions.get(ekey, 0))
        return ("ok", {"vocab": tbl.vocab, "dim": tbl.dim,
                       "dtype": tbl.dtype.name})

    def _handle_embed_push(self, name, ids, grads, wid,
                           ws: _WorkerState):
        ids = np.asarray(ids, np.int64)
        grads = np.asarray(grads)
        ekey = _EMBED_PREFIX + name
        deadline = time.monotonic() + self._round_timeout()
        with self._lock:
            tbl = self._embed.get(name)
            if tbl is None:
                return ("err",
                        f"embedding table {name!r} not initialized")
            if tuple(grads.shape) != (ids.shape[0], tbl.dim):
                return ("err",
                        f"embed push of {tuple(grads.shape)} grads does "
                        f"not match ({ids.shape[0]}, {tbl.dim}) for "
                        f"table {name!r}")
            if ids.size and (int(ids.min()) < 0
                             or int(ids.max()) >= tbl.vocab):
                return ("err", "embed push row ids out of range for "
                        f"table {name!r} (vocab {tbl.vocab})")
            if not self.sync_mode:
                # SSP default mode: police the pusher's staleness, then
                # apply each row's update immediately with the table's
                # lazy per-row optimizer — one version bump per frame
                err = self._check_stale_locked(ekey, wid, ws)
                if err is None:
                    err = self._block_stale_locked(ekey, deadline)
                if err is not None:
                    return err
                s = self._async_staleness_locked(ekey, ws)
                self._staleness_hist[s] = \
                    self._staleness_hist.get(s, 0) + 1
                ws.async_pushes += 1
                for rid, g in zip(ids.tolist(), grads):
                    tbl.apply_row(int(rid), g)
                self._versions[ekey] = self._versions.get(ekey, 0) + 1
                self._lock.notify_all()
                return ("ok", {"state_rows": tbl.state_rows_alloc,
                               "version": self._versions[ekey]})
            # sync parity baseline: the worker's nth embed push on this
            # table is round n's contribution; the merge accumulator is
            # a {row id: f64 row} dict, so a round costs O(touched)
            r = ws.pushes.get(ekey, 0) + 1
            if r <= tbl.rounds:
                return ("err",
                        f"embed push targets round {r} of table "
                        f"{name!r} but round {tbl.rounds} already "
                        "applied; new processes must join() first")
            ws.pushes[ekey] = r
            ent = tbl.pending.get(r)
            if ent is None:
                ent = [{}, set(), self._epoch, self._expected()]
                tbl.pending[r] = ent
            acc = ent[0]
            for rid, g in zip(ids.tolist(), grads):
                rid = int(rid)
                a = acc.get(rid)
                if a is None:
                    acc[rid] = np.asarray(g, np.float64).copy()
                else:
                    a += g
            ent[1].add(wid)
            self._advance_embed_rounds_locked(name, tbl)
            return ("ok", {"state_rows": tbl.state_rows_alloc,
                           "rounds": tbl.rounds})

    def _advance_embed_rounds_locked(self, name, tbl: _EmbedTable):
        """Sync-round advancement for one embedding table — the same
        stamped-membership rules as `_advance_rounds_locked`, applied
        row-by-row in sorted row order (deterministic application, so
        sync mode stays bitwise-reproducible)."""
        while True:
            nxt = tbl.pending.get(tbl.rounds + 1)
            if nxt is None:
                break
            need = max(1, min(nxt[3], self._expected()))
            if len(nxt[1] - self._evicted - self._left) < need:
                break
            for rid in sorted(nxt[0]):
                tbl.apply_row(rid, nxt[0][rid])
            del tbl.pending[tbl.rounds + 1]
            tbl.rounds += 1
            self.counters["rounds_applied"] += 1
            self._lock.notify_all()

    def _handle_embed_pull(self, name, ids, wid, ws: _WorkerState):
        ids = np.asarray(ids, np.int64)
        ekey = _EMBED_PREFIX + name
        rt = self._round_timeout()
        start = time.monotonic()
        with self._lock:
            tbl = self._embed.get(name)
            if tbl is None:
                return ("err",
                        f"embedding table {name!r} not initialized")
            if ids.size and (int(ids.min()) < 0
                             or int(ids.max()) >= tbl.vocab):
                return ("err", "embed pull row ids out of range for "
                        f"table {name!r} (vocab {tbl.vocab})")
            if self.sync_mode:
                # like `_handle_pull`: wait only for rounds fed by this
                # worker's OWN pushes (waiting on others' would deadlock)
                need = ws.pushes.get(ekey, 0)
                while tbl.rounds < need and not self._stop.is_set():
                    if self._retired(wid):
                        return self._retired_err(wid)
                    blocked = tbl.rounds + 1
                    ent = tbl.pending.get(blocked)
                    contribs = ent[1] if ent is not None else set()
                    dead = sorted(map(str, (self._dead - self._evicted
                                            - self._left) - contribs))
                    if dead:
                        self.counters["dead_worker_errors"] += 1
                        return ("err",
                                f"sync round {blocked} of embedding "
                                f"table {name!r} is blocked by dead "
                                f"worker {dead[0]} (lease expired; set "
                                "MXTPU_PS_EVICT_DEAD=1 to continue at "
                                "reduced membership)",
                                {"kind": "dead_worker",
                                 "worker": dead[0], "round": blocked})
                    if time.monotonic() - start > rt:
                        self.counters["round_timeouts"] += 1
                        return ("err",
                                f"sync round {blocked} of embedding "
                                f"table {name!r} did not complete "
                                "within MXTPU_PS_ROUND_TIMEOUT="
                                f"{rt}s ({len(contribs)}/"
                                f"{self._expected()} contributions)",
                                {"kind": "round_timeout",
                                 "round": blocked})
                    self._lock.wait(0.2)
                if tbl.rounds < need:
                    return ("err", "server shut down before the sync "
                            "round completed", {"kind": "shutdown"})
            if self._retired(wid):
                return self._retired_err(wid)
            out = np.empty((ids.shape[0], tbl.dim), tbl.dtype)
            for i, rid in enumerate(ids.tolist()):
                out[i] = tbl.row(int(rid))
            if not self.sync_mode:
                ver = self._versions.get(ekey, 0)
                ws.pulled[ekey] = ver
                ws.last_pull_version = max(ws.last_pull_version, ver)
                ws.pulls += 1
                self._lock.notify_all()
        return ("ok", out)

    def _handle_barrier(self, wid):
        rt = self._round_timeout()
        start = time.monotonic()
        with self._lock:
            ws = self._worker_locked(wid)
            # a worker admitted at epoch E must not fold into a barrier
            # round opened under an older membership (its arrival could
            # release the old round before a pre-join member reached it
            # — a torn barrier); it parks until that round completes,
            # then opens/joins the next one
            while (self._barrier_arrived
                   and wid not in self._barrier_arrived
                   and self._barrier_epoch < ws.joined_epoch
                   and not self._stop.is_set()):
                if self._retired(wid):
                    return self._retired_err(wid)
                if time.monotonic() - start > rt:
                    self.counters["round_timeouts"] += 1
                    return ("err",
                            f"barrier round {self._barrier_round} "
                            "(opened before this worker joined) did not "
                            "complete within "
                            f"MXTPU_PS_ROUND_TIMEOUT={rt}s",
                            {"kind": "round_timeout",
                             "round": self._barrier_round})
                self._lock.wait(0.2)
            my_round = self._barrier_round
            if not self._barrier_arrived:
                # the barrier round OPENS at its first arrival: stamp
                # the membership epoch + expected count, like sync rounds
                self._barrier_epoch = self._epoch
                self._barrier_expected = self._expected()
            # arrivals keyed by worker identity: a client retrying a
            # barrier after a lost ACK re-registers the SAME identity
            # instead of double-counting and releasing the barrier early
            self._barrier_arrived.add(wid)
            self._check_barrier_locked()
            while (self._barrier_round == my_round
                   and not self._stop.is_set()):
                if self._retired(wid):
                    return self._retired_err(wid)
                dead = sorted(map(str, (self._dead - self._evicted
                                        - self._left)
                                  - self._barrier_arrived))
                if dead:
                    self.counters["dead_worker_errors"] += 1
                    return ("err",
                            f"barrier round {my_round} is blocked by "
                            f"dead worker {dead[0]} (lease expired; set "
                            "MXTPU_PS_EVICT_DEAD=1 to continue at "
                            "reduced membership)",
                            {"kind": "dead_worker", "worker": dead[0],
                             "round": my_round})
                if time.monotonic() - start > rt:
                    self.counters["round_timeouts"] += 1
                    return ("err",
                            f"barrier round {my_round} did not complete "
                            f"within MXTPU_PS_ROUND_TIMEOUT={rt}s "
                            f"({len(self._barrier_arrived)}/"
                            f"{self._expected()} arrivals)",
                            {"kind": "round_timeout", "round": my_round})
                self._lock.wait(0.2)
            if self._barrier_round == my_round:
                return ("err", "server shut down during barrier",
                        {"kind": "shutdown"})
        return ("ok",)

    def _check_barrier_locked(self):
        live = self._barrier_arrived - self._evicted - self._left
        need = self._expected()
        if self._barrier_expected is not None:
            # the count stamped when the round opened, capped by the
            # current membership (a departure mid-barrier releases it at
            # the reduced count; a join mid-barrier is not awaited)
            need = max(1, min(self._barrier_expected, need))
        if live and len(live) >= need:
            self._barrier_arrived.clear()
            self._barrier_expected = None
            self._barrier_round += 1
            self._lock.notify_all()

    # -- introspection ---------------------------------------------------
    def _membership_locked(self) -> Dict[str, Any]:
        return {
            "epoch": self._epoch,
            "size": self._size,
            "ranks": {str(w): r for w, r in self._ranks.items()},
            "left_workers": sorted(map(str, self._left)),
            "evicted_workers": sorted(map(str, self._evicted)),
            "log": list(self._membership_log[-64:]),
        }

    def membership_dict(self) -> Dict[str, Any]:
        """The ``membership`` op payload: the elastic state machine's
        current epoch, size, dense rank table, retirement sets and the
        tail of the transition log."""
        with self._lock:
            return self._membership_locked()

    def stats_dict(self) -> Dict[str, Any]:
        """The `stats` op payload: membership, round progress, staleness
        and the fault counters (dedup hits, evictions, ...)."""
        with self._lock:
            live = [w for w in self._workers
                    if not self._retired(w) and w not in self._dead]
            out = {
                "sync_mode": self.sync_mode,
                "num_workers": self.num_workers,
                "expected_contributors": self._expected(),
                "members": sorted(map(str, self._workers)),
                "live_workers": sorted(map(str, live)),
                "dead_workers": sorted(map(str, self._dead)),
                "evicted_workers": sorted(map(str, self._evicted)),
                "left_workers": sorted(map(str, self._left)),
                "membership_epoch": self._epoch,
                "membership_size": self._size,
                "ranks": {str(w): r for w, r in self._ranks.items()},
                "membership_log": list(self._membership_log[-64:]),
                "keys": len(self._store),
                "pending_rounds": {str(k): sorted(st.pending)
                                   for k, st in self._state.items()
                                   if st.pending},
                "pending_round_epochs": {
                    str(k): {r: p[3] for r, p in st.pending.items()}
                    for k, st in self._state.items() if st.pending},
                "barrier_round": self._barrier_round,
                "embed_tables": {
                    str(n): {"vocab": t.vocab, "dim": t.dim,
                             "dtype": t.dtype.name,
                             "rows_materialized": len(t.rows),
                             "state_rows": len(t.state),
                             "row_updates": t.row_updates,
                             "rounds": t.rounds,
                             "pending_rounds": sorted(t.pending),
                             "optimizer": (dict(t.opt)
                                           if t.opt is not None
                                           else None)}
                    for n, t in self._embed.items()},
                "staleness_hist": dict(self._staleness_hist),
                "worker_versions": {
                    str(w): {"last_pull_version": ws.last_pull_version,
                             "async_pushes": ws.async_pushes,
                             "pulls": ws.pulls}
                    for w, ws in self._workers.items()},
            }
            out.update(self.counters)
        # the one metrics surface rides along, so a `stats` op answers
        # with every counter family + live gauges (snapshotted OUTSIDE
        # the lock: families may read server state themselves)
        out["metrics"] = _prof.metrics_snapshot()
        return out


class PSClient:
    """Worker-side connection (reference `kvstore_dist.h` worker role,
    ps-lite `KVWorker` push/pull) with the van layer's fault handling:
    every request is retried idempotently across reconnects, and a
    background heartbeat keeps this worker's liveness lease fresh."""

    def __init__(self, host: str, port: int,
                 timeout: Optional[float] = None,
                 connect_window: float = 90.0,
                 worker_id: Optional[str] = None,
                 heartbeat: Optional[bool] = None,
                 rank: Optional[int] = None):
        """``timeout=None`` (default) blocks indefinitely on requests —
        a sync-mode pull-after-push legitimately waits for the slowest
        worker to feed the round, like the reference's ps-lite path;
        pass a float only in tests.

        Connection attempts retry inside ``connect_window`` seconds: a
        launcher starts server and workers simultaneously, and the
        server may still be importing when the first worker dials
        (ps-lite's van retries the same way).

        ``worker_id`` is this worker's stable identity (DMLC_RANK under
        the launcher); without one a unique anonymous id is generated —
        retries still dedup, but a NEW client object cannot resume the
        old one's sync round positions.  ``heartbeat=None`` enables the
        liveness thread iff MXTPU_PS_HEARTBEAT_INTERVAL > 0."""
        self.host = host
        self.port = int(port)
        self.worker_id = (worker_id if worker_id is not None
                          else f"anon-{uuid.uuid4().hex[:10]}")
        self._timeout = timeout
        self._lock = threading.Lock()
        self._seq = 0
        self._sock: Optional[socket.socket] = None
        self._closed = False
        self._server_info: Dict[str, Any] = {}
        # set by hello: server advertised it understands the optional
        # trailing trace-context dict (old servers never see one)
        self._telemetry = False
        # elastic membership cache (refreshed by hello/join/membership)
        self._declared_rank = rank
        self.epoch: int = 0
        self.membership_size: int = 0
        self.assigned_rank: Optional[int] = None
        # once this identity is retired (evicted or drained), EVERY
        # subsequent op raises the same structured EvictedError with the
        # rejoin hint — never a generic closed-connection failure
        self._evicted_exc: Optional[EvictedError] = None
        # fault plan captured at construction: tests install a plan,
        # then create the clients it should apply to
        self._plan = fault_injection.active()
        self._rng = random.Random(self.worker_id)  # backoff jitter
        self.counters: Dict[str, int] = {
            "retries": 0, "reconnects": 0, "timeouts": 0,
            "discarded_replies": 0}
        deadline = time.monotonic() + connect_window
        while True:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=10.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(1.0)
        self._sock.settimeout(timeout)
        self._hello()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat is None:
            heartbeat = float(_cfg("MXTPU_PS_HEARTBEAT_INTERVAL")) > 0
        if heartbeat:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True,
                name=f"ps-heartbeat-{self.worker_id}")
            self._hb_thread.start()

    # -- transport -------------------------------------------------------
    def _hello(self):
        """Identify to the server (sync-round positions and the dedup
        window are keyed by worker_id, so they survive a reconnect)."""
        _send_msg(self._sock, ("hello", self.worker_id,
                               self._declared_rank))
        resp = _recv_msg(self._sock)
        if resp is None:
            raise ConnectionError("PS server closed during handshake")
        if resp[0] != "ok":
            info = (resp[2] if len(resp) > 2
                    and isinstance(resp[2], dict) else {})
            if info.get("kind") == "evicted":
                self._closed = True
                self._evicted_exc = EvictedError(
                    resp[1], worker=info.get("worker"))
                raise self._evicted_exc
            raise RuntimeError(f"PS server error: {resp[1:]}")
        self._server_info = resp[1] if len(resp) > 1 else {}
        self._telemetry = bool(self._server_info.get("telemetry")) \
            if isinstance(self._server_info, dict) else False
        self._absorb_membership(self._server_info)
        # resume the seq space above anything the server has seen from
        # this worker id: a fresh client incarnation must not collide
        # with a previous one's dedup entries (an in-flight retry keeps
        # its already-assigned seq — max() cannot move it)
        self._seq = max(self._seq,
                        int(self._server_info.get("max_seq", 0)))

    def _teardown(self):
        """Discard the (possibly mid-frame, hence poisoned) connection —
        it is never reused after an error or timeout."""
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # req ops whose frames carry tensor payload — what the comm plane's
    # wire counters meter (control traffic like barrier/stats excluded)
    _DATA_OPS = frozenset({"init", "push", "pull", "push_batch",
                           "pull_batch", "pull_rows", "embed_pull",
                           "embed_push"})

    def _send_frame(self, msg):
        copies = 1
        if self._plan is not None and msg[0] == "req":
            copies = self._plan.client_send_event()
        for _ in range(copies):
            nbytes = _send_msg(self._sock, msg)
            if msg[0] == "req" and msg[3] in self._DATA_OPS:
                _prof.bump_comm("wire_frames")
                _prof.bump_comm("wire_bytes", nbytes)

    def _recv_frame(self):
        if self._plan is not None:
            self._plan.client_recv_event()
        return _recv_msg(self._sock)

    def _recv_reply(self, seq):
        """Read frames until this request's reply arrives; replies to
        older seqs (a duplicated delivery's second answer, or a reply
        raced by a reconnect) are discarded, never misattributed."""
        while True:
            msg = self._recv_frame()
            if msg is None:
                raise ConnectionError("PS server closed the connection")
            if msg[0] != "reply":
                raise ConnectionError(
                    f"PS protocol desync: unexpected frame {msg[0]!r}")
            if msg[1] == seq:
                return msg[2]
            if msg[1] < seq:
                self.counters["discarded_replies"] += 1
                continue
            raise ConnectionError(
                f"PS protocol desync: reply seq {msg[1]} from the "
                f"future (awaiting {seq})")

    def _absorb_membership(self, info: Dict[str, Any]):
        """Fold a server reply's membership view into the client cache
        (epoch-aware ``rank``/``num_workers`` read these)."""
        if not isinstance(info, dict):
            return
        if "epoch" in info:
            self.epoch = int(info["epoch"])
        elif "membership_epoch" in info:
            self.epoch = int(info["membership_epoch"])
        if "size" in info:
            self.membership_size = int(info["size"])
        elif "membership_size" in info:
            self.membership_size = int(info["membership_size"])
        if "rank" in info and info["rank"] is not None:
            self.assigned_rank = int(info["rank"])
        ranks = info.get("ranks")
        if isinstance(ranks, dict):
            r = ranks.get(str(self.worker_id))
            self.assigned_rank = int(r) if r is not None \
                else self.assigned_rank

    def _call(self, op, *args):
        if self._evicted_exc is not None:
            raise self._evicted_exc
        if self._closed:
            raise ConnectionError("PSClient is closed")
        with self._lock:
            self._seq += 1
            return self._request(self._seq, op, args)

    def _request(self, seq, op, args):
        """Send `(worker_id, seq, op)` and wait for its reply, retrying
        across reconnects under the retry deadline; the server's dedup
        window makes the replay exactly-once."""
        deadline = time.monotonic() + float(_cfg("MXTPU_PS_RETRY_DEADLINE"))
        base = float(_cfg("MXTPU_PS_RETRY_BASE"))
        cap = float(_cfg("MXTPU_PS_RETRY_MAX"))
        attempt = 0
        while True:
            try:
                if self._sock is None:
                    self._reconnect_once()
                frame = ("req", self.worker_id, seq, op) + args
                if self._telemetry:
                    ctx = _tele.wire_context()
                    if ctx is not None:
                        frame = frame + (ctx,)
                t0 = time.perf_counter()
                self._send_frame(frame)
                out = self._interpret(self._recv_reply(seq))
                _tele.event(f"ps.client.{op}", seq=seq,
                            dur_ms=(time.perf_counter() - t0) * 1e3)
                return out
            except EvictedError as e:
                self._evicted_exc = e
                raise
            except (ConnectionError, socket.timeout, TimeoutError,
                    OSError) as e:
                if isinstance(e, (socket.timeout, TimeoutError)):
                    self.counters["timeouts"] += 1
                self._teardown()
                attempt += 1
                self.counters["retries"] += 1
                now = time.monotonic()
                if self._closed or now >= deadline:
                    # terminal transport failure: worth a postmortem —
                    # dump the flight recorder before raising
                    _tele.record_error(
                        e, kind="ps_retry_deadline", op=str(op), seq=seq,
                        attempts=attempt, worker=str(self.worker_id))
                    raise ConnectionError(
                        f"PS request {op!r} (worker {self.worker_id!r} "
                        f"seq {seq}) failed after {attempt} attempts "
                        f"within MXTPU_PS_RETRY_DEADLINE: {e}") from e
                delay = min(base * (2 ** (attempt - 1)), cap)
                delay *= 0.5 + self._rng.random()  # jitter in [0.5, 1.5)
                time.sleep(min(delay, max(0.0, deadline - now)))

    def _reconnect_once(self):
        sock = socket.create_connection((self.host, self.port),
                                        timeout=10.0)
        sock.settimeout(self._timeout)
        self._sock = sock
        self._hello()
        self.counters["reconnects"] += 1

    def _interpret(self, resp):
        if resp[0] == "ok":
            out = resp[1] if len(resp) > 1 else None
            self._absorb_membership(out)
            return out
        msg = resp[1]
        info = resp[2] if len(resp) > 2 and isinstance(resp[2], dict) \
            else {}
        kind = info.get("kind")
        if kind in ("dead_worker", "round_timeout", "evicted",
                    "stale_push"):
            # structured error: record it; the hard failures (a dead
            # peer, a timed-out round, our own eviction) also dump the
            # flight recorder — stale pushes are self-healed by the
            # comm plane (pull + one retry), so they only log
            _tele.record_error(msg, kind=f"ps_{kind}",
                               dump=kind != "stale_push",
                               worker=str(info.get("worker", "")))
        if kind == "dead_worker":
            raise DeadWorkerError(msg, worker=info.get("worker"))
        if kind == "round_timeout":
            raise RoundTimeoutError(msg)
        if kind == "evicted":
            raise EvictedError(msg, worker=info.get("worker"))
        if kind == "stale_push":
            raise StalePushError(msg, staleness=info.get("staleness"),
                                 max_staleness=info.get("max"))
        raise RuntimeError(f"PS server error: {resp[1:]}")

    # -- liveness --------------------------------------------------------
    def _hb_loop(self):
        """Feed the server's lease table on a dedicated connection (the
        data socket may legitimately block for a whole sync round, which
        must not read as death).  Never fault-injected.  Consecutive
        failures back off so a stopped server costs ~nothing."""
        interval = float(_cfg("MXTPU_PS_HEARTBEAT_INTERVAL"))
        if interval <= 0:
            return
        sock = None
        failures = 0
        wait = 0.0  # announce liveness immediately
        while not self._hb_stop.wait(wait):
            try:
                if sock is None:
                    sock = socket.create_connection(
                        (self.host, self.port), timeout=5.0)
                _send_msg(sock, ("hb", self.worker_id))
                failures = 0
                wait = interval
            except (ConnectionError, OSError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
                failures += 1
                wait = min(interval * (2 ** min(failures, 4)), 30.0)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- ops -------------------------------------------------------------
    def init(self, key, value: np.ndarray):
        self._call("init", key, np.asarray(value))

    def push(self, key, value):
        """``value`` may be a dense ndarray or an `rsp_wire` tuple (row
        ids + row block) — row-sparse gradients ride the wire at
        O(touched rows)."""
        self._call("push", key, _norm_push_val(value))

    def pull(self, key) -> np.ndarray:
        return self._call("pull", key)

    def push_batch(self, pairs):
        """Push many ``(key, value)`` pairs as ONE wire frame (one seq,
        one dedup entry — a retried frame re-applies all-or-nothing).
        The comm plane batches small keys into these to collapse the
        per-key round-trip count.  Values may mix dense ndarrays and
        `rsp_wire` tuples."""
        self._call("push_batch",
                   [(k, _norm_push_val(v)) for k, v in pairs])

    def pull_batch(self, keys):
        """Pull many keys as ONE wire frame; returns values in key
        order.  Sync-mode semantics per key are identical to a sequence
        of single pulls (each key waits for the puller's own rounds)."""
        return self._call("pull_batch", list(keys))

    def pull_rows(self, key, row_ids) -> np.ndarray:
        """Pull only the named rows of a dense key as ONE frame (the
        `KVStore.row_sparse_pull` wire path): sync wait semantics match
        `pull`, the reply carries ``len(row_ids)`` rows."""
        return self._call("pull_rows", key,
                          np.asarray(row_ids, np.int64))

    # -- sparse embedding tables (embedding_plane.py) --------------------
    def embed_init(self, name, vocab, dim, dtype="float32",
                   init="normal", scale=0.01, seed=0) -> Dict[str, Any]:
        """Create table ``name`` on this server shard (set-if-absent,
        like `init`): rows materialize lazily from the deterministic
        ``(seed, row id)`` init, so creation costs O(1) whatever the
        vocab."""
        return self._call("embed_init", str(name), int(vocab), int(dim),
                          str(dtype), str(init), float(scale), int(seed))

    def embed_set_optimizer(self, name, spec: Dict[str, Any]):
        """Install the per-row sparse optimizer for table ``name``: a
        plain wire-encodable spec dict — ``{"kind": "sgd"|"adagrad",
        "lr", "wd", "momentum", "eps", "rescale_grad"}``.  Optimizer
        state rows allocate on first touch (O(touched-vocab) memory)."""
        self._call("embed_set_optimizer", str(name), dict(spec))

    def embed_pull(self, name, row_ids) -> np.ndarray:
        """Partial pull: fetch exactly the named rows of table ``name``
        as an ``(n, dim)`` block."""
        return self._call("embed_pull", str(name),
                          np.asarray(row_ids, np.int64))

    def embed_push(self, name, row_ids, grads) -> Dict[str, Any]:
        """Partial push: per-row gradients for the named rows, applied
        server-side with the table's sparse optimizer (async/SSP) or
        merged into the table's sync round.  Exactly-once under retries
        like every state-mutating op.  Returns ``{"state_rows": ...}``
        (+ ``version`` async / ``rounds`` sync)."""
        return self._call("embed_push", str(name),
                          np.asarray(row_ids, np.int64),
                          np.asarray(grads))

    def set_optimizer(self, optimizer):
        self._call("set_optimizer",
                   pickle.dumps(optimizer, pickle.HIGHEST_PROTOCOL))

    def barrier(self):
        self._call("barrier")

    # -- elastic membership ---------------------------------------------
    def join(self) -> Dict[str, Any]:
        """Join the job's membership mid-run (one dedup'd wire op).  The
        server bumps the membership epoch, assigns this worker the next
        free rank, and fast-forwards its sync-round positions past every
        round opened before admission — its first push on each key lands
        in the first round whose stamped membership includes it.
        Returns ``{"epoch", "size", "rank", "sync_mode"}``."""
        return self._call("join")

    def leave(self) -> Dict[str, Any]:
        """Gracefully drain out of membership.  Past contributions stay
        merged; in-flight rounds complete at the reduced count; this
        IDENTITY is retired permanently (rejoin needs a fresh worker_id).
        Heartbeats stop so the retirement is not mistaken for death."""
        out = self._call("leave")
        self._hb_stop.set()
        self._evicted_exc = EvictedError(
            f"worker {self.worker_id!r} left the job (drained); "
            + _REJOIN_HINT, worker=self.worker_id)
        return out

    def membership(self) -> Dict[str, Any]:
        """Fetch the server's current membership view (epoch, size,
        dense rank table, retirement sets, transition log tail) and
        refresh this client's epoch/size/rank cache."""
        return self._call("membership")

    def heartbeat(self):
        """One manual lease renewal (the background thread normally does
        this); also opts this worker into liveness monitoring."""
        self._call("heartbeat")

    def stats(self) -> Dict[str, Any]:
        """Server-side introspection: rounds applied, pending rounds,
        live/dead/evicted workers, dedup hits (`stats` op)."""
        return self._call("stats")

    def stop_server(self):
        self._call("stop")
        self._hb_stop.set()

    def close(self):
        self._closed = True
        self._hb_stop.set()
        self._teardown()

    def kill(self):
        """Test hook: die like SIGKILL — sockets drop, heartbeats stop,
        no farewell.  From the server's view this is indistinguishable
        from a crashed worker process."""
        self.close()
