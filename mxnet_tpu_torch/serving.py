"""Serving plane: dynamic micro-batched inference over captured forwards
(the counterpart of `mxnet_tpu/serving.py`).

Three layers, composable bottom-up:

1. :class:`CompiledModelPool` -- takes a :class:`~mxnet_tpu_torch.
   predictor.Predictor` (or an `export_compiled` blob) and captures its
   inference program as one CUDA graph per (device, rung) of a **ladder
   of padded batch sizes** (``MXTPU_SERVE_BATCH_LADDER``, e.g.
   1/2/4/8/16), all in ``__init__``: the hot path only replays.  Every
   dispatch is padded up to the smallest rung that fits -- pad rows
   replicate the last real row (valid data, no NaN/denormal hazards) and
   are sliced out of the response.  A replay writes the graph's static
   input and output buffers, so `run` fills the static input, replays and
   copies the real rows to the host under the replica's lock: the same
   rows through the same rung give bit-identical outputs whether or not
   pad rows ride along, and no reply aliases a buffer the next replay
   overwrites.  On CPU devices the same plan runs eagerly.

2. :class:`MicroBatchQueue` -- pure batching logic (injectable clock, no
   threads) so flush policy is unit-testable: requests accumulate until
   ``MXTPU_SERVE_MAX_BATCH`` rows are pending or the oldest request has
   waited ``MXTPU_SERVE_MAX_DELAY_MS``, whichever first.  The queue is
   bounded (``MXTPU_SERVE_QUEUE_LIMIT`` rows): submits past the bound
   are **shed** with a structured :class:`ServerOverloadError` instead
   of being queued into unbounded latency.

3. :class:`ModelServer` -- the multi-replica dispatcher: a batcher
   thread drains the queue and round-robins filled batches across one
   dispatch thread per device replica (each sets its device before it
   replays); plus a socket front door speaking the zero-pickle wire-v2
   tagged frames of `ps_wire.py`, byte-compatible with the JAX
   package's, so either package's `ServeClient` talks to either's
   server.  `deploy` captures a new pool while the old one keeps
   serving, then drains and swaps.  The generation lane (``decode=`` and
   the ``generate`` wire op) waits for the port of `generation.py` and
   raises until then.

`profiler.serve_counters()` exposes QPS, p50/p99 latency, batch
occupancy, pad waste and shed count; `telemetry` spans and the flight
recorder follow each request, its trace id carried over the wire.
"""
from __future__ import annotations

import os
import queue as _queue
import socket
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import profiler as _prof
from . import ps_wire
from . import telemetry as _tele
from .base import MXNetError
from .config import get_env
from .context import Context
from .graph_compile import StaticProgram, build_steps

__all__ = ["ServerOverloadError", "ServerDrainingError",
           "DrainTimeoutError", "NoHealthyReplicaError",
           "CompiledModelPool", "MicroBatchQueue",
           "ModelServer", "ServeClient", "parse_ladder", "rung_for"]


class ServerOverloadError(MXNetError):
    """The micro-batching queue is full: the request was shed, not
    queued.  Structured so callers (and the wire front door) can report
    the exact pressure — retry with backoff or route elsewhere; the
    ServeClient deliberately does NOT blind-retry these.  When a router
    fronts the fleet it may attach ``retry_after_ms``, a backoff hint
    derived from the shedding replica's queue depth and p99 — the ONE
    case the client retries, because the hint makes the retry informed
    rather than blind (still bounded by ``MXTPU_SERVE_RETRY_DEADLINE``).
    """

    def __init__(self, requested: int, pending_rows: int, limit: int,
                 retry_after_ms: Optional[float] = None):
        self.requested = int(requested)
        self.pending_rows = int(pending_rows)
        self.limit = int(limit)
        self.retry_after_ms = None if retry_after_ms is None \
            else float(retry_after_ms)
        hint = "" if self.retry_after_ms is None else \
            f" (retry after ~{self.retry_after_ms:.0f}ms)"
        super().__init__(
            f"serving queue full: {pending_rows} rows pending of "
            f"{limit} allowed, shed {requested}-row request{hint}")

    def wire_info(self) -> Dict[str, Any]:
        info: Dict[str, Any] = {"requested": self.requested,
                                "pending_rows": self.pending_rows,
                                "limit": self.limit}
        if self.retry_after_ms is not None:
            info["retry_after_ms"] = float(self.retry_after_ms)
        return info


class ServerDrainingError(MXNetError):
    """The server is draining (rolling deploy / shutdown) or closed:
    new rows are refused while already-queued rows flush.  A router
    bounces these to another replica; a direct client treats them like
    overload minus the retry hint (a drain is bounded by
    MXTPU_SERVE_DRAIN_TIMEOUT; ``closed`` means it never ends)."""

    def __init__(self, requested: int, pending_rows: int,
                 closed: bool = False):
        self.requested = int(requested)
        self.pending_rows = int(pending_rows)
        self.closed = bool(closed)
        state = "closed" if closed else "draining"
        super().__init__(
            f"server {state}: refused {requested}-row request "
            f"({pending_rows} rows still flushing)")


class DrainTimeoutError(MXNetError):
    """A drain did not quiesce within its bound: queued or in-flight
    work remained when MXTPU_SERVE_DRAIN_TIMEOUT expired.  The deploy
    machinery treats this as a failed step (replica readmitted on the
    old version) rather than hot-swapping under live requests."""

    def __init__(self, pending_rows: int, inflight: int, timeout_s: float):
        self.pending_rows = int(pending_rows)
        self.inflight = int(inflight)
        self.timeout_s = float(timeout_s)
        super().__init__(
            f"drain did not quiesce in {timeout_s:.1f}s: "
            f"{pending_rows} rows queued, {inflight} batches in flight")


class NoHealthyReplicaError(MXNetError):
    """Every replica behind the router is dead, tripped or draining —
    the whole-fleet-down signal.  Structured with the fleet census so
    callers and the flight recorder can tell 'all breakers open'
    (cascading failure) from 'all draining' (bad deploy orchestration).
    Defined here (not in the fleet tier) so ServeClient can raise it for
    wire errors of kind "no_healthy_replica" without a circular import.
    """

    def __init__(self, replicas: int, breaker_open: int = 0,
                 draining: int = 0, detail: str = ""):
        self.replicas = int(replicas)
        self.breaker_open = int(breaker_open)
        self.draining = int(draining)
        msg = (f"no healthy replica: {replicas} configured, "
               f"{breaker_open} breaker-open, {draining} draining")
        if detail:
            msg += f" — {detail}"
        super().__init__(msg)

    def wire_info(self) -> Dict[str, Any]:
        return {"replicas": self.replicas,
                "breaker_open": self.breaker_open,
                "draining": self.draining}


def parse_ladder(spec: Optional[str] = None) -> List[int]:
    """Parse a batch-size ladder spec ('1,2,4,8,16') into a sorted,
    deduplicated list of positive rungs."""
    if spec is None:
        spec = get_env("MXTPU_SERVE_BATCH_LADDER")
    try:
        rungs = sorted({int(tok) for tok in str(spec).split(",") if
                        tok.strip()})
    except ValueError:
        raise MXNetError(
            f"MXTPU_SERVE_BATCH_LADDER {spec!r} is not a comma-separated "
            "list of batch sizes") from None
    if not rungs or rungs[0] < 1:
        raise MXNetError(
            f"MXTPU_SERVE_BATCH_LADDER {spec!r} must name at least one "
            "positive batch size")
    return rungs


def rung_for(n: int, ladder: Sequence[int]) -> int:
    """Smallest rung of a sorted ladder that fits ``n`` rows; wider
    dispatches return the top rung (the pool chunks them there)."""
    for rung in ladder:
        if n <= rung:
            return rung
    return ladder[-1]


# ---------------------------------------------------------------------------
# layer 1: the compiled model pool
# ---------------------------------------------------------------------------

class CompiledModelPool:
    """One captured program per (device replica, ladder rung).

    ``source`` is either a bound :class:`Predictor` (its optimized
    inference program and its bound weights) or a path to an
    `export_compiled` blob.  A blob exported with ``dynamic_batch=True``
    captures at the full ladder; a fixed-batch blob collapses the ladder
    to its one baked batch size.

    ``devices`` defaults to every CUDA device (no CUDA device raises
    `MXNetError`); CPU contexts run the same plan eagerly.  ``run(feed,
    replica=...)`` pads each dispatch up to the smallest rung that fits
    and slices pad rows back out; requests wider than the top rung are
    chunked at the top rung.  Every capture happens in ``__init__``
    (``rungs_compiled`` counts them), so the serving hot path never
    captures.
    """

    def __init__(self, source, batch_ladder: Optional[Sequence[int]] = None,
                 devices=None):
        self._devices = _resolve_devices(devices)
        ladder = list(batch_ladder) if batch_ladder is not None \
            else parse_ladder()
        ladder = sorted({int(r) for r in ladder})
        if not ladder or ladder[0] < 1:
            raise MXNetError(f"invalid batch ladder {ladder}")

        # provenance: which artifact this pool serves.  The CRC is of
        # the whole blob file, so stats can verify every replica runs the
        # byte-identical deployment artifact.
        self.source_path: Optional[str] = None
        self.source_crc: Optional[int] = None
        if isinstance(source, (str, bytes)):
            path = str(source)
            model, fixed = self._from_blob(path)
            self.source_path = path
            with open(path, "rb") as f:
                self.source_crc = zlib.crc32(f.read()) & 0xFFFFFFFF
        else:
            model, fixed = self._from_predictor(source)
        if fixed is not None:
            # fixed-batch export: only one dispatch shape exists
            ladder = [fixed]
        names = model.input_names
        self.input_names = list(names)
        self.input_dtypes = dict(zip(names, model.input_dtypes))
        self._trailing = model.trailing
        self._ladder = ladder
        self._rung_counter = {r: f"rung_{r}_dispatches" for r in ladder}

        # eager per-(replica, rung) capture: the hot path only looks up
        plan = build_steps(model.symbol)
        self._exec: List[Dict[int, StaticProgram]] = []
        for dev in self._devices:
            weights = model.weights_on(dev)
            lock = threading.Lock()
            per_rung: Dict[int, StaticProgram] = {}
            for rung in ladder:
                per_rung[rung] = StaticProgram(
                    plan, weights,
                    [(n, (rung,) + self._trailing[n], self.input_dtypes[n])
                     for n in names], dev, lock=lock)
                _prof.bump_serve("rungs_compiled")
            self._exec.append(per_rung)

    # -- sources ---------------------------------------------------------

    @staticmethod
    def _from_predictor(pred):
        model = pred.exported_model()
        for n, shape in zip(model.input_names, model.in_shapes):
            if not shape:
                raise MXNetError(
                    f"input {n!r} is a scalar: serving requires a leading "
                    "batch dimension on every input")
        return model, None

    @staticmethod
    def _from_blob(path: str):
        from .predictor import Predictor

        model, names, _dtypes = Predictor.load_exported(path)
        fixed = None
        for n, shape in zip(names, model.in_shapes):
            if not shape:
                raise MXNetError(
                    f"input {n!r} in {path} is a scalar: serving requires "
                    "a leading batch dimension on every input")
            lead = shape[0]  # None: the symbolic batch dim, any rung
            if lead is not None:
                fixed = int(lead) if fixed is None else fixed
                if int(lead) != fixed:
                    raise MXNetError(
                        f"{path}: inputs disagree on the baked batch size "
                        f"({fixed} vs {lead})")
        return model, fixed

    # -- dispatch --------------------------------------------------------

    @property
    def ladder(self) -> List[int]:
        return list(self._ladder)

    @property
    def num_replicas(self) -> int:
        return len(self._exec)

    @property
    def devices(self) -> List[torch.device]:
        return list(self._devices)

    @property
    def max_rung(self) -> int:
        return self._ladder[-1]

    def rung_for(self, n: int) -> int:
        """Smallest ladder rung that fits ``n`` rows (dispatches wider
        than the top rung are chunked at the top rung by ``run``)."""
        return rung_for(n, self._ladder)

    def run(self, feed: Dict[str, np.ndarray],
            replica: int = 0) -> List[np.ndarray]:
        """Run one padded dispatch: ``feed`` maps every input name to an
        array whose leading dim is the batch; returns output arrays with
        exactly that many rows (pad rows masked out), host copies of
        their own."""
        missing = set(self.input_names) - set(feed)
        if missing:
            raise MXNetError(f"serving feed missing inputs "
                             f"{sorted(missing)}")
        arrays = []
        n = None
        for name in self.input_names:
            arr = np.asarray(feed[name], dtype=self.input_dtypes[name])
            want = self._trailing[name]
            if arr.ndim < 1 or tuple(arr.shape[1:]) != want:
                raise MXNetError(
                    f"serving input {name!r}: shape {arr.shape} does not "
                    f"match (batch,)+{want}")
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise MXNetError(
                    f"serving inputs disagree on batch size: {name!r} has "
                    f"{arr.shape[0]} rows, expected {n}")
            arrays.append(arr)
        if n == 0:
            raise MXNetError("serving dispatch of 0 rows")

        per_rung = self._exec[replica % len(self._exec)]
        top = self._ladder[-1]
        chunks_out: List[List[np.ndarray]] = []
        for start in range(0, n, top):
            rows = min(top, n - start)
            rung = self.rung_for(rows)
            pad = rung - rows
            outs = per_rung[rung]([arr[start:start + rows]
                                   for arr in arrays], rows=rows)
            chunks_out.append(outs)
            _prof.bump_serve_many({"dispatches": 1,
                                   self._rung_counter[rung]: 1,
                                   "rows": rows, "pad_rows": pad})
        if len(chunks_out) == 1:
            return chunks_out[0]
        return [np.concatenate([c[i] for c in chunks_out], axis=0)
                for i in range(len(chunks_out[0]))]


def _resolve_devices(devices) -> List[torch.device]:
    """``devices`` as torch devices: None means every CUDA device (none
    raises); entries may be Contexts, torch devices or device strings."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
            raise MXNetError(
                "CompiledModelPool: no CUDA device; pass devices=[mx.cpu()] "
                "to serve on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        if isinstance(d, Context):
            out.append(d.device)
        else:
            out.append(torch.device(d))
    if not out:
        raise MXNetError("CompiledModelPool needs at least one device")
    return out


# ---------------------------------------------------------------------------
# layer 2: the dynamic micro-batching queue (pure logic)
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("item", "nrows", "t0")

    def __init__(self, item, nrows: int, t0: float):
        self.item = item
        self.nrows = nrows
        self.t0 = t0


class MicroBatchQueue:
    """The flush policy as pure logic — no threads, injectable clock —
    so rung selection, deadline-vs-full ordering and shed behavior are
    testable deterministically.

    Invariants:
    - FIFO: batches pack requests in arrival order, never reorder.
    - A batch flushes when ≥ ``max_batch`` rows are pending
      ("max_batch") or the OLDEST pending request has waited
      ``max_delay_ms`` ("deadline") — full-batch wins when both hold.
    - Bounded: a submit that would push pending rows past
      ``queue_limit`` raises :class:`ServerOverloadError` and changes
      nothing.
    - A single request wider than ``max_batch`` is still accepted (the
      pool chunks it at the top rung) and flushes as its own batch.
    - Draining: after :meth:`begin_drain`, new submits raise
      :class:`ServerDrainingError` while already-queued rows keep
      flushing under the normal deadline/full policy (a drain must
      never strand queued requests past their latency budget).
    """

    def __init__(self, max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.max_batch = int(max_batch if max_batch is not None
                             else get_env("MXTPU_SERVE_MAX_BATCH"))
        delay = max_delay_ms if max_delay_ms is not None \
            else get_env("MXTPU_SERVE_MAX_DELAY_MS")
        self.max_delay_s = float(delay) / 1000.0
        self.queue_limit = int(queue_limit if queue_limit is not None
                               else get_env("MXTPU_SERVE_QUEUE_LIMIT"))
        if self.max_batch < 1 or self.queue_limit < 1:
            raise MXNetError("max_batch and queue_limit must be >= 1")
        self._clock = clock
        self._pending: deque = deque()
        self._rows = 0
        self._draining = False

    @property
    def pending_rows(self) -> int:
        return self._rows

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Refuse new rows; queued rows keep flushing (deadline flushes
        still fire, so drained queues empty within max_delay_ms)."""
        self._draining = True

    def end_drain(self) -> None:
        self._draining = False

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, item, nrows: int, now: Optional[float] = None) -> None:
        nrows = int(nrows)
        if nrows < 1:
            raise MXNetError("cannot queue a 0-row request")
        if self._draining:
            raise ServerDrainingError(nrows, self._rows)
        if self._rows + nrows > self.queue_limit:
            raise ServerOverloadError(nrows, self._rows, self.queue_limit)
        t0 = self._clock() if now is None else now
        self._pending.append(_Entry(item, nrows, t0))
        self._rows += nrows

    def ready(self, now: Optional[float] = None) -> Optional[str]:
        """Flush reason if a batch should flush now, else None.
        Full-batch is checked before deadline: when both hold, the
        flush is attributed to "max_batch" (it would have flushed even
        with an infinite deadline)."""
        if not self._pending:
            return None
        if self._rows >= self.max_batch:
            return "max_batch"
        now = self._clock() if now is None else now
        if now - self._pending[0].t0 >= self.max_delay_s:
            return "deadline"
        return None

    def next_deadline(self) -> Optional[float]:
        """Absolute clock time of the oldest request's deadline (what a
        batcher thread should sleep until), or None if empty."""
        if not self._pending:
            return None
        return self._pending[0].t0 + self.max_delay_s

    def pop_batch(self, now: Optional[float] = None):
        """Pop one FIFO batch of up to ``max_batch`` rows.  Returns
        ``(entries, reason)``; ``([], None)`` when nothing should flush.
        An oversized head entry pops alone."""
        reason = self.ready(now)
        if reason is None:
            return [], None
        batch: List[_Entry] = []
        rows = 0
        while self._pending:
            head = self._pending[0]
            if batch and rows + head.nrows > self.max_batch:
                break
            batch.append(self._pending.popleft())
            rows += head.nrows
            if rows >= self.max_batch:
                break
        self._rows -= rows
        return batch, reason


# ---------------------------------------------------------------------------
# layer 3: the multi-replica dispatcher + socket front door
# ---------------------------------------------------------------------------

class _InferFuture:
    """Response slot a submitted request blocks on."""

    __slots__ = ("_ev", "_outs", "_exc", "t_submit", "trace")

    def __init__(self, t_submit: float,
                 trace: Optional[str] = None):
        self._ev = threading.Event()
        self._outs: Optional[List[np.ndarray]] = None
        self._exc: Optional[BaseException] = None
        self.t_submit = t_submit
        # trace id captured at submit so the dispatcher threads (which
        # have no thread-local context) can stamp reply events with it
        self.trace = trace

    def set_result(self, outs: List[np.ndarray]) -> None:
        self._outs = outs
        self._ev.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        if not self._ev.wait(timeout):
            raise TimeoutError("inference did not complete in time")
        if self._exc is not None:
            raise self._exc
        return self._outs


class ModelServer:
    """The serving runtime: micro-batching queue + batcher thread +
    one dispatch thread per compiled replica (round-robin), with an
    optional wire-v2 socket front door (:meth:`serve`).

    In-process callers use :meth:`infer` (blocking) or :meth:`submit`
    (returns a future); remote callers connect a :class:`ServeClient`.

    The server is hot-swappable: :meth:`deploy` captures a new blob
    while the old pool keeps serving, then drains (bounded by
    ``MXTPU_SERVE_DRAIN_TIMEOUT``) and swaps pools atomically; the
    previous pool is stashed so a rollback deploy is an instant swap,
    no capture.  ``model_version`` names the artifact in the `stats`
    reply so a router can verify what each replica actually serves.

    ``decode`` (the JAX package's generation lane) raises until
    `generation.py` is ported, and so does the ``generate`` wire op.
    """

    def __init__(self, pool: CompiledModelPool,
                 max_batch: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_limit: Optional[int] = None,
                 model_version: Optional[str] = None,
                 decode=None):
        if decode is not None:
            raise MXNetError(
                "ModelServer(decode=...): the generation lane waits for "
                "the port of generation.py")
        self._pool = pool
        self._model_version = model_version
        self._decode = decode
        self._start_time = time.time()
        # hot-swap state: previous (version, pool) kept for instant
        # rollback; _inflight counts batches handed to dispatch threads
        # so wait_drained() knows when the runtime is truly quiet
        self._prev: Optional[Tuple[Optional[str], CompiledModelPool]] = None
        self._inflight = 0
        if max_batch is None:
            max_batch = int(get_env("MXTPU_SERVE_MAX_BATCH"))
        # flushing more rows than the top rung holds would only chunk —
        # clamp so one flush is one dispatch
        max_batch = min(max_batch, pool.max_rung)
        self._queue = MicroBatchQueue(max_batch=max_batch,
                                      max_delay_ms=max_delay_ms,
                                      queue_limit=queue_limit)
        # base tuning, restored exactly when a brownout 'tune' op ends
        self._base_max_batch = int(self._queue.max_batch)
        self._base_max_delay_s = float(self._queue.max_delay_s)
        self._cond = threading.Condition()
        self._running = True
        self._replica_qs: List[_queue.Queue] = [
            _queue.Queue() for _ in range(pool.num_replicas)]
        self._rr = 0
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._batcher_loop,
                             name="mxtpu-serve-batcher", daemon=True)
        t.start()
        self._threads.append(t)
        for i, rq in enumerate(self._replica_qs):
            t = threading.Thread(target=self._dispatch_loop, args=(i, rq),
                                 name=f"mxtpu-serve-replica-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        # front door state
        self._listener: Optional[socket.socket] = None
        self._conn_threads: List[threading.Thread] = []
        # live queue-depth gauge on the one metrics surface (latest
        # server in the process wins the name; close() unregisters)
        _prof.register_gauge("serve_queue_rows",
                             lambda: float(self._queue.pending_rows))

    # -- request path ----------------------------------------------------

    def submit(self, inputs: Dict[str, np.ndarray]) -> _InferFuture:
        """Queue one request (leading dim of every input = its rows).
        Raises :class:`ServerOverloadError` immediately when the queue
        is full — the request is shed, never half-queued."""
        _prof.bump_serve("requests")
        feed = {}
        nrows = None
        for name in self._pool.input_names:
            if name not in inputs:
                _prof.bump_serve("request_errors")
                raise MXNetError(f"request missing input {name!r}")
            arr = np.asarray(inputs[name],
                             dtype=self._pool.input_dtypes[name])
            want = self._pool._trailing[name]
            if arr.ndim < 1 or tuple(arr.shape[1:]) != want:
                _prof.bump_serve("request_errors")
                raise MXNetError(
                    f"request input {name!r}: shape {arr.shape} does not "
                    f"match (rows,)+{want}")
            if nrows is None:
                nrows = arr.shape[0]
            elif arr.shape[0] != nrows:
                _prof.bump_serve("request_errors")
                raise MXNetError(
                    f"request inputs disagree on rows: {name!r} has "
                    f"{arr.shape[0]}, expected {nrows}")
            feed[name] = arr
        if nrows == 0:
            _prof.bump_serve("request_errors")
            raise MXNetError("request with 0 rows")
        fut = _InferFuture(time.monotonic(), trace=_tele.current_trace())
        with self._cond:
            if not self._running:
                # a closed server is permanently draining: structured,
                # so a fronting router bounces the request to a live
                # replica instead of failing it
                raise ServerDrainingError(int(nrows), 0, closed=True)
            try:
                self._queue.submit((feed, fut), nrows)
            except ServerDrainingError:
                _prof.bump_serve("drain_refused")
                raise
            except ServerOverloadError as e:
                _prof.bump_serve("shed")
                _tele.record_error(e, kind="serve_overload",
                                   rows=int(nrows),
                                   pending_rows=e.pending_rows,
                                   limit=e.limit)
                raise
            self._cond.notify()
        _tele.event("serve.enqueue", rows=int(nrows),
                    pending_rows=self._queue.pending_rows,
                    trace_id=fut.trace)
        return fut

    def infer(self, inputs: Dict[str, np.ndarray],
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Blocking submit + wait; returns the per-request output rows."""
        return self.submit(inputs).result(timeout)

    @property
    def decode(self):
        """The attached generation lane (`generation.DecodeService`)
        or None when this server only serves fixed-shape infer."""
        return self._decode

    def generate(self, prompt, max_new_tokens: int,
                 priority: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = None) -> np.ndarray:
        """In-process decode-lane convenience (the JAX package's); the
        lane waits for the port of generation.py, so this raises."""
        if self._decode is None:
            raise MXNetError("this server has no decode lane: the "
                             "generation lane waits for the port of "
                             "generation.py")
        fut = self._decode.submit(prompt, max_new_tokens,
                                  priority=priority,
                                  deadline_ms=deadline_ms)
        return fut.result(timeout)

    # -- drain + hot swap ------------------------------------------------

    @property
    def model_version(self) -> Optional[str]:
        return self._model_version

    @property
    def previous_version(self) -> Optional[str]:
        return self._prev[0] if self._prev is not None else None

    @property
    def draining(self) -> bool:
        return self._queue.draining

    def begin_drain(self) -> None:
        """Refuse new requests (ServerDrainingError) while queued rows
        keep flushing; reversed by :meth:`end_drain`."""
        with self._cond:
            self._queue.begin_drain()
            self._cond.notify_all()
        _prof.bump_serve("drains")
        _tele.event("serve.drain_begin",
                    pending_rows=self._queue.pending_rows)

    def end_drain(self) -> None:
        with self._cond:
            self._queue.end_drain()
            self._cond.notify_all()
        _tele.event("serve.drain_end")

    def wait_drained(self, timeout: Optional[float] = None) -> None:
        """Block until queued rows AND in-flight batches hit zero.
        Raises :class:`DrainTimeoutError` (and dumps the flight
        recorder) if the runtime does not quiesce within ``timeout``
        (default ``MXTPU_SERVE_DRAIN_TIMEOUT``)."""
        if timeout is None:
            timeout = float(get_env("MXTPU_SERVE_DRAIN_TIMEOUT"))
        t_end = time.monotonic() + timeout
        with self._cond:
            while self._queue.pending_rows > 0 or self._inflight > 0:
                left = t_end - time.monotonic()
                if left <= 0:
                    exc = DrainTimeoutError(self._queue.pending_rows,
                                            self._inflight, timeout)
                    _tele.record_error(exc, kind="drain_timeout",
                                       pending_rows=exc.pending_rows,
                                       inflight=exc.inflight,
                                       timeout_s=timeout)
                    raise exc
                self._cond.wait(timeout=min(left, 0.05))

    def deploy(self, source, version: Optional[str] = None,
               batch_ladder: Optional[Sequence[int]] = None,
               drain_timeout: Optional[float] = None) -> None:
        """Hot-swap the served model with zero downtime.

        Order of operations is the whole point: the NEW pool captures
        first, while the old one keeps serving (a capture is
        thread-local, so the dispatch threads' replays go on) -- a
        corrupt or incompatible blob fails here and the deploy aborts
        having touched nothing.  Only then does the server drain
        (bounded) and swap pools atomically.  The previous (version,
        pool) is stashed: deploying it again is an instant swap with no
        capture (the rollback path), and re-deploying the current
        version is a noop that just ends any drain in progress.
        """
        if version is not None and version == self._model_version:
            self.end_drain()
            return
        if (self._prev is not None and version is not None
                and version == self._prev[0]):
            new_pool = self._prev[1]  # instant rollback, no capture
        else:
            new_pool = CompiledModelPool(
                source,
                batch_ladder=(batch_ladder if batch_ladder is not None
                              else self._pool.ladder),
                devices=self._pool.devices)
        if new_pool.num_replicas != len(self._replica_qs):
            raise MXNetError(
                f"deploy: new pool has {new_pool.num_replicas} replicas, "
                f"server runs {len(self._replica_qs)} dispatch threads")
        self.begin_drain()
        try:
            self.wait_drained(drain_timeout)
            with self._cond:
                self._prev = (self._model_version, self._pool)
                self._pool = new_pool
                self._model_version = version
                # a narrower ladder must narrow the flush bound too
                # (and the base tuning a brownout exit restores)
                self._queue.max_batch = min(self._queue.max_batch,
                                            new_pool.max_rung)
                self._base_max_batch = min(self._base_max_batch,
                                           new_pool.max_rung)
        finally:
            self.end_drain()
        _prof.bump_serve("hot_swaps")
        _tele.event("serve.hot_swap", version=str(version),
                    blob_crc=new_pool.source_crc)

    def set_tuning(self, max_delay_ms: Optional[float] = None,
                   max_batch: Optional[int] = None) -> Dict[str, float]:
        """Runtime batching-ladder adjustment (the router's brownout
        lever): widen the micro-batch deadline to trade latency for
        goodput and/or cap the flush size to one ladder rung.  ``None``
        restores that knob's base value exactly — ``set_tuning()`` with
        no arguments is the clean brownout exit.  Returns the tuning
        now in effect."""
        with self._cond:
            self._queue.max_delay_s = (
                self._base_max_delay_s if max_delay_ms is None
                else max(0.0, float(max_delay_ms) / 1000.0))
            self._queue.max_batch = (
                self._base_max_batch if max_batch is None
                else max(1, min(int(max_batch), self._pool.max_rung)))
            # the batcher may be parked on the OLD deadline: wake it
            self._cond.notify_all()
        _prof.bump_serve("tunings")
        _tele.event("serve.tune",
                    max_delay_ms=self._queue.max_delay_s * 1000.0,
                    max_batch=self._queue.max_batch)
        return {"max_delay_ms": self._queue.max_delay_s * 1000.0,
                "max_batch": float(self._queue.max_batch)}

    # -- batcher / dispatch threads --------------------------------------

    def _batcher_loop(self) -> None:
        while True:
            with self._cond:
                while self._running:
                    reason = self._queue.ready()
                    if reason is not None:
                        break
                    deadline = self._queue.next_deadline()
                    wait = None if deadline is None else \
                        max(0.0, deadline - time.monotonic())
                    self._cond.wait(timeout=wait)
                if not self._running:
                    return
                entries, reason = self._queue.pop_batch()
                if entries:
                    self._inflight += 1
                replica = self._rr
                self._rr = (self._rr + 1) % len(self._replica_qs)
            if not entries:
                continue
            _prof.bump_serve_many({"batches": 1, f"flush_{reason}": 1})
            _tele.event("serve.flush", reason=reason,
                        requests=len(entries),
                        rows=sum(e.nrows for e in entries),
                        replica=replica)
            self._replica_qs[replica].put(entries)

    def _dispatch_loop(self, replica: int, rq: _queue.Queue) -> None:
        dev = self._pool.devices[replica]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            entries = rq.get()
            if entries is None:
                return
            feeds = [e.item[0] for e in entries]
            futs = [e.item[1] for e in entries]
            try:
                batch = {
                    name: np.concatenate([f[name] for f in feeds], axis=0)
                    if len(feeds) > 1 else feeds[0][name]
                    for name in self._pool.input_names}
                with _tele.span("serve.dispatch", replica=replica,
                                requests=len(futs)):
                    outs = self._pool.run(batch, replica=replica)
                now = time.monotonic()
                row = 0
                for e, fut in zip(entries, futs):
                    fut.set_result([o[row:row + e.nrows] for o in outs])
                    row += e.nrows
                # counters per flush, not per request: one lock each
                _prof.bump_serve("responses", len(futs))
                _prof.observe_serve_latencies(
                    [now - f.t_submit for f in futs], now)
                for e, fut in zip(entries, futs):
                    _tele.event("serve.reply", rows=e.nrows,
                                replica=replica, trace_id=fut.trace,
                                dur_ms=(now - fut.t_submit) * 1e3)
            except Exception as exc:  # batch poisoned: fail every member
                _prof.bump_serve("request_errors", len(futs))
                _tele.record_error(exc, kind="serve_dispatch",
                                   dump=False, replica=replica,
                                   requests=len(futs))
                for fut in futs:
                    fut.set_exception(exc)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    # -- socket front door -----------------------------------------------

    def serve(self, host: str = "127.0.0.1",
              port: int = 0) -> Tuple[str, int]:
        """Open the wire-v2 front door; returns the bound (host, port).
        One handler thread per connection — concurrent clients still
        coalesce into shared micro-batches through :meth:`submit`."""
        if self._listener is not None:
            raise MXNetError("front door already open")
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        # close() on a listening socket does not wake a blocked accept()
        # on Linux — poll with a short timeout so shutdown is prompt
        srv.settimeout(0.1)
        self._listener = srv
        t = threading.Thread(target=self._accept_loop,
                             name="mxtpu-serve-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return srv.getsockname()[:2]

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        return None if self._listener is None \
            else self._listener.getsockname()[:2]

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 name="mxtpu-serve-conn", daemon=True)
            t.start()
            self._conn_threads.append(t)

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while self._running:
                try:
                    msg = ps_wire.recv_frame(conn)
                except ps_wire.WireError:
                    # protocol desync: the connection is poisoned — drop
                    # it; the client reconnects and replays (PS
                    # discipline).  Don't try to answer on a desynced
                    # stream.
                    _prof.bump_serve("wire_errors")
                    return
                if msg is None:
                    return  # clean close
                try:
                    reply = self._handle_msg(msg)
                except ServerOverloadError as e:
                    reply = ps_wire.err_frame(_req_id(msg), "overload",
                                              e, e.wire_info())
                except ServerDrainingError as e:
                    reply = ps_wire.err_frame(
                        _req_id(msg), "draining", e,
                        {"requested": e.requested,
                         "pending_rows": e.pending_rows,
                         "closed": e.closed})
                except DrainTimeoutError as e:
                    reply = ps_wire.err_frame(
                        _req_id(msg), "drain_timeout", e,
                        {"pending_rows": e.pending_rows,
                         "inflight": e.inflight,
                         "timeout_s": e.timeout_s})
                except MXNetError as e:
                    reply = ("err", _req_id(msg), "bad_request", str(e), {})
                except Exception as e:
                    reply = ("err", _req_id(msg), "internal",
                             f"{type(e).__name__}: {e}", {})
                ps_wire.send_frame(conn, reply)
        except (ConnectionError, OSError):
            pass  # peer vanished mid-reply
        finally:
            conn.close()

    def _handle_msg(self, msg) -> tuple:
        if not isinstance(msg, tuple) or not msg:
            raise MXNetError("front-door message must be a tagged tuple")
        op = msg[0]
        if op == "ping":
            return ("pong",)
        if op == "stats":
            # serve counters stay top-level (compat); the unified
            # surface (every family + gauges) rides under "metrics".
            # Identity fields let a router verify which artifact this
            # process actually serves (version + blob CRC) and how
            # loaded it is RIGHT NOW (per-server queue depth — the
            # process-global gauge is last-server-wins, this is not).
            out = dict(_prof.serve_counters())
            out["metrics"] = _prof.metrics_snapshot()
            out["model_version"] = self._model_version
            out["blob_crc"] = self._pool.source_crc
            out["start_time_unix"] = float(self._start_time)
            out["pid"] = int(os.getpid())
            out["serve_queue_rows"] = int(self._queue.pending_rows)
            out["inflight_batches"] = int(self._inflight)
            out["draining"] = bool(self._queue.draining)
            if self._decode is not None:
                out.update(self._decode.stats())
            return ("stats", out)
        if op == "drain":
            # ('drain', req_id[, timeout_s]) — refuse new rows, flush
            # queued ones, stay draining on success (the deployer sends
            # 'deploy' or 'resume' next); a timed-out drain auto-resumes
            # so a failed deploy step can't wedge the replica refusing
            # traffic forever.
            if len(msg) not in (2, 3):
                raise MXNetError("drain frame must be ('drain', req_id"
                                 "[, timeout_s])")
            timeout = float(msg[2]) if len(msg) == 3 else None
            self.begin_drain()
            try:
                self.wait_drained(timeout)
            except DrainTimeoutError:
                self.end_drain()
                raise
            return ps_wire.ok_frame(msg[1], {"drained": True})
        if op == "resume":
            if len(msg) != 2:
                raise MXNetError("resume frame must be ('resume', req_id)")
            self.end_drain()
            return ps_wire.ok_frame(msg[1], {"draining": False})
        if op == "deploy":
            # ('deploy', req_id, {"path": ..., "version": ...}) — full
            # hot swap: capture, drain, swap (see ModelServer.deploy)
            if len(msg) != 3 or not isinstance(msg[2], dict) \
                    or "path" not in msg[2]:
                raise MXNetError(
                    "deploy frame must be ('deploy', req_id, "
                    "{'path': blob_path, 'version': name})")
            spec = msg[2]
            try:
                self.deploy(str(spec["path"]),
                            version=spec.get("version"),
                            drain_timeout=spec.get("drain_timeout"))
            except DrainTimeoutError:
                raise
            except MXNetError as e:
                return ps_wire.err_frame(msg[1], "deploy_failed", e, {})
            return ps_wire.ok_frame(
                msg[1], {"version": self._model_version,
                         "blob_crc": self._pool.source_crc})
        if op == "tune":
            # ('tune', req_id, {"max_delay_ms": f, "max_batch": n}) —
            # runtime batching adjustment (the brownout lever); keys
            # absent from the spec restore their base values, so
            # ('tune', req_id, {}) is the clean brownout exit
            if len(msg) != 3 or not isinstance(msg[2], dict):
                raise MXNetError(
                    "tune frame must be ('tune', req_id, "
                    "{'max_delay_ms': f, 'max_batch': n})")
            spec = msg[2]
            now = self.set_tuning(
                max_delay_ms=spec.get("max_delay_ms"),
                max_batch=spec.get("max_batch"))
            return ps_wire.ok_frame(msg[1], now)
        if op == "infer":
            # ('infer', req_id, {name: array}[, ctx]) — the optional
            # 4th element is the telemetry trace context; clients that
            # predate it send 3-tuples, which stay valid forever
            if len(msg) not in (3, 4) or not isinstance(msg[2], dict) \
                    or (len(msg) == 4 and not isinstance(msg[3], dict)):
                raise MXNetError(
                    "infer frame must be ('infer', req_id, "
                    "{name: array}[, ctx])")
            req_id, inputs = msg[1], msg[2]
            ctx = msg[3] if len(msg) == 4 else None
            with _tele.adopt(ctx):
                with _tele.span("serve.infer", req_id=str(req_id)):
                    outs = self.infer(inputs)
            return ("ok", req_id, [np.asarray(o) for o in outs])
        if op == "generate":
            # ('generate', req_id, {"prompt": int32 arr,
            #  "max_new_tokens": n}[, ctx]) — the decode lane; ctx may
            # carry priority/deadline_ms admission headers like infer
            if len(msg) not in (3, 4) or not isinstance(msg[2], dict) \
                    or "prompt" not in msg[2] \
                    or (len(msg) == 4 and not isinstance(msg[3], dict)):
                raise MXNetError(
                    "generate frame must be ('generate', req_id, "
                    "{'prompt': arr, 'max_new_tokens': n}[, ctx])")
            if self._decode is None:
                raise MXNetError(
                    "this server has no decode lane (the generation lane "
                    "waits for the port of generation.py)")
            req_id, spec = msg[1], msg[2]
            ctx = msg[3] if len(msg) == 4 else None
            priority = deadline_ms = None
            if isinstance(ctx, dict):
                priority = ctx.get("priority")
                deadline_ms = ctx.get("deadline_ms")
            with _tele.adopt(ctx):
                with _tele.span("serve.generate", req_id=str(req_id)):
                    fut = self._decode.submit(
                        spec["prompt"],
                        int(spec.get("max_new_tokens", 1)),
                        priority=priority, deadline_ms=deadline_ms)
                    tokens = fut.result()
            return ps_wire.ok_frame(
                req_id, {"tokens": np.asarray(tokens, np.int32),
                         "ttft_ms": fut.ttft_ms})
        raise MXNetError(f"unknown front-door op {op!r}")

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        with self._cond:
            if not self._running:
                return
            self._running = False
            self._cond.notify_all()
        _prof.unregister_gauge("serve_queue_rows")
        if self._decode is not None:
            try:
                self._decode.close()
            except Exception:
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for rq in self._replica_qs:
            rq.put(None)
        # shed anything still queued so no caller blocks forever
        entries, _ = self._queue.pop_batch(now=float("inf"))
        while entries:
            for e in entries:
                e.item[1].set_exception(MXNetError("server closed"))
            entries, _ = self._queue.pop_batch(now=float("inf"))
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _req_id(msg) -> Any:
    return msg[1] if isinstance(msg, tuple) and len(msg) > 1 else None


# ---------------------------------------------------------------------------
# the client end of the front door
# ---------------------------------------------------------------------------

class ServeClient:
    """Wire-v2 front-door client.  Connection faults (reset, desync,
    clean close mid-request) are retried with exponential backoff for
    ``MXTPU_SERVE_RETRY_DEADLINE`` seconds, PS-plane style.  Overload
    sheds are NOT blind-retried — :class:`ServerOverloadError` raises
    straight to the caller, which owns the backoff/reroute decision —
    with ONE structured exception: a shed carrying a ``retry_after_ms``
    hint (the fleet router derives it from the shedding replica's queue
    depth and p99) is retried after a jittered sleep of about that
    long, still bounded by the same deadline.  The hint is what makes
    the retry informed; no hint, no retry, contract unchanged."""

    def __init__(self, host: str, port: int,
                 retry_deadline: Optional[float] = None,
                 honor_retry_hint: bool = True,
                 seed: Optional[int] = None,
                 priority: Optional[str] = None,
                 deadline_ms: Optional[float] = None):
        import random

        self._addr = (host, int(port))
        self._deadline = float(
            retry_deadline if retry_deadline is not None
            else get_env("MXTPU_SERVE_RETRY_DEADLINE"))
        self._sock: Optional[socket.socket] = None
        self._next_id = 0
        self._lock = threading.Lock()
        self._honor_retry_hint = bool(honor_retry_hint)
        self._rng = random.Random(seed)  # seedable: chaos tests replay
        # admission-control headers riding the infer-frame ctx dict:
        # the priority class (MXTPU_SERVE_PRIORITY or per-client arg;
        # 'low' is shed first in brownout) and a per-request deadline
        # budget the router refuses immediately when it cannot meet.
        # Both default off: no ctx header is sent for them.
        self._priority = str(
            priority if priority is not None
            else get_env("MXTPU_SERVE_PRIORITY") or "").strip()
        self._deadline_ms = (None if deadline_ms is None
                             else float(deadline_ms))
        # whether the server accepts the optional 4-element infer frame
        # (trace context); flips off after one bad_request fallback, so
        # an old server costs exactly one extra round-trip ever
        self._ctx_ok = True

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=30.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, request: tuple):
        t_end = time.monotonic() + self._deadline
        backoff = 0.05
        while True:
            try:
                sock = self._connect()
                ps_wire.send_frame(sock, request)
                reply = ps_wire.recv_frame(sock)
                if reply is None:
                    raise ConnectionError("front door closed mid-request")
                return reply
            except (ConnectionError, OSError) as e:
                # WireError lands here too: poisoned stream == dead socket
                self._drop()
                if time.monotonic() >= t_end:
                    raise ConnectionError(
                        f"serving front door {self._addr} unreachable "
                        f"after {self._deadline:.1f}s of retries: "
                        f"{e}") from e
                time.sleep(backoff)
                backoff = min(backoff * 2, 1.0)

    def infer(self, inputs: Dict[str, np.ndarray]) -> List[np.ndarray]:
        t_end = time.monotonic() + self._deadline
        while True:
            try:
                return self._infer_once(inputs)
            except ServerOverloadError as e:
                if (e.retry_after_ms is None or not self._honor_retry_hint
                        or time.monotonic() >= t_end):
                    raise
                # jittered sleep around the hint (0.5x–1.5x) so a herd
                # of shed clients doesn't re-arrive in lockstep
                delay = (e.retry_after_ms / 1000.0) \
                    * (0.5 + self._rng.random())
                time.sleep(max(0.0, min(delay,
                                        t_end - time.monotonic())))

    def _infer_once(self, inputs: Dict[str, np.ndarray]) \
            -> List[np.ndarray]:
        ctx = _tele.wire_context() if self._ctx_ok else None
        if self._ctx_ok and (self._priority or
                             self._deadline_ms is not None):
            ctx = dict(ctx) if ctx else {}
            if self._priority:
                ctx["priority"] = self._priority
            if self._deadline_ms is not None:
                ctx["deadline_ms"] = float(self._deadline_ms)
        with self._lock:
            self._next_id += 1
            req_id = self._next_id
            frame = ("infer", req_id, dict(inputs))
            reply = self._roundtrip(frame + (ctx,) if ctx is not None
                                    else frame)
            if (ctx is not None and isinstance(reply, tuple)
                    and len(reply) > 2 and reply[0] == "err"
                    and reply[2] == "bad_request"):
                # server predates the context field: drop it for the
                # life of this client and replay the request once
                self._ctx_ok = False
                reply = self._roundtrip(frame)
        if not isinstance(reply, tuple) or len(reply) < 2 or \
                reply[1] != req_id:
            raise ConnectionError(f"front door reply desync: {reply!r}")
        if reply[0] == "ok":
            return list(reply[2])
        if reply[0] == "err":
            self._raise_err(reply)
        raise ConnectionError(f"unknown front door reply {reply[0]!r}")

    def generate(self, prompt, max_new_tokens: int) -> np.ndarray:
        """Continuous-batched generation through the front door's
        decode lane: sends the ``generate`` wire op and returns the
        generated int32 token array.  Same retry discipline as
        :meth:`infer` — connection faults retry under the deadline,
        a shed retries once on its honest ``retry_after_ms`` hint and
        otherwise raises straight to the caller."""
        t_end = time.monotonic() + self._deadline
        while True:
            try:
                return self._generate_once(prompt, max_new_tokens)
            except ServerOverloadError as e:
                if (e.retry_after_ms is None or not self._honor_retry_hint
                        or time.monotonic() >= t_end):
                    raise
                delay = (e.retry_after_ms / 1000.0) \
                    * (0.5 + self._rng.random())
                time.sleep(max(0.0, min(delay,
                                        t_end - time.monotonic())))

    def _generate_once(self, prompt, max_new_tokens: int) -> np.ndarray:
        ctx = _tele.wire_context() if self._ctx_ok else None
        if self._ctx_ok and (self._priority or
                             self._deadline_ms is not None):
            ctx = dict(ctx) if ctx else {}
            if self._priority:
                ctx["priority"] = self._priority
            if self._deadline_ms is not None:
                ctx["deadline_ms"] = float(self._deadline_ms)
        spec = {"prompt": np.asarray(prompt, np.int32),
                "max_new_tokens": int(max_new_tokens)}
        with self._lock:
            self._next_id += 1
            req_id = self._next_id
            frame = ("generate", req_id, spec)
            reply = self._roundtrip(frame + (ctx,) if ctx is not None
                                    else frame)
        if not isinstance(reply, tuple) or len(reply) < 2 or \
                reply[1] != req_id:
            raise ConnectionError(f"front door reply desync: {reply!r}")
        if reply[0] == "ok":
            return np.asarray(reply[2]["tokens"], np.int32)
        if reply[0] == "err":
            self._raise_err(reply)
        raise ConnectionError(f"unknown front door reply {reply[0]!r}")

    def _raise_err(self, reply: tuple) -> None:
        kind, detail, info = reply[2], reply[3], reply[4]
        if kind == "overload":
            raise ServerOverloadError(
                info.get("requested", 0),
                info.get("pending_rows", 0),
                info.get("limit", 0),
                retry_after_ms=info.get("retry_after_ms"))
        if kind == "draining":
            raise ServerDrainingError(info.get("requested", 0),
                                      info.get("pending_rows", 0))
        if kind == "no_healthy_replica":
            raise NoHealthyReplicaError(
                info.get("replicas", 0),
                breaker_open=info.get("breaker_open", 0),
                draining=info.get("draining", 0),
                detail=str(detail))
        raise MXNetError(f"serving error ({kind}): {detail}")

    def ping(self) -> bool:
        with self._lock:
            return self._roundtrip(("ping",)) == ("pong",)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            reply = self._roundtrip(("stats",))
        if not isinstance(reply, tuple) or reply[0] != "stats":
            raise ConnectionError(f"unexpected stats reply {reply!r}")
        return reply[1]

    def close(self) -> None:
        with self._lock:
            self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
