"""Fleet serving resilience plane: health-checked routing, versioned
hot-swap rollout with instant rollback, replica supervision (the
counterpart of `mxnet_tpu/serving_fleet.py`, the tier above `serving.py`).

One :class:`~mxnet_tpu_torch.serving.ModelServer` is one process: a
crash, a bad model push or one slow replica takes the whole workload
down.  This module is the layer above it that keeps the request path's
semantics: ``MXTPU_SERVE_FLEET=0`` (or connecting a client straight to
one replica) is the single-server plane, and responses through the
router at a fixed ladder rung are bitwise-identical to direct ones.

Four pieces, composable bottom-up:

* :class:`CircuitBreaker` -- per-replica failure gate.  Closed admits
  traffic; ``MXTPU_SERVE_BREAKER_FAILURES`` consecutive failures open
  it (traffic sheds away); after ``MXTPU_SERVE_BREAKER_COOLDOWN_S`` it
  goes half-open and the next *health probe* -- never a user request --
  decides: success closes it, failure re-opens it.

* :class:`Router` -- the front-door process.  Speaks the same `ps_wire`
  tagged frames as the replicas, so a :class:`~mxnet_tpu_torch.serving.
  ServeClient` cannot tell it from a single server.  Per request it
  picks the least-loaded healthy replica (queue depth from the stats
  surface + its own in-flight count, round-robin tiebreak) and forwards
  the frame.  A replica that dies or hangs mid-request counts a breaker
  failure and the request **fails over once** to a healthy replica --
  safe because the serving path is read-only.  When the whole fleet is
  down the client gets a structured :class:`~mxnet_tpu_torch.serving.
  NoHealthyReplicaError`, never a hang.  Replica overload sheds are
  relayed (never resubmitted) with a ``retry_after_ms`` hint derived
  from the shedding replica's queue depth and p99.  ``generate`` (the
  decode lane) routes with the same discipline.

* :class:`ModelRegistry` + rolling deploy -- named versions whose
  artifact is the port's `export_compiled` blob (magic ``MXTCBLB1``,
  verified at register time through the same bounds-checked
  `_BlobReader` path that loads it) or a `generation` decode blob.
  :meth:`Router.deploy` upgrades the fleet one replica at a time with
  zero downtime: stop assigning, let in-flight work finish (bounded by
  ``MXTPU_SERVE_DRAIN_TIMEOUT``), hot-swap the blob (the replica captures
  the NEW pool before draining, so a corrupt blob aborts having served
  every request), and -- before readmission -- check a **canary** request
  against the old version's output on a pinned input.  Any failure rolls
  every upgraded replica back to the previous version (an instant
  stashed-pool swap server-side, no capture) while the rest of the
  fleet keeps answering.

* :class:`ReplicaSupervisor` -- restarts crashed replica processes with
  seeded jittered exponential backoff; too many deaths inside
  ``crash_window_s`` opens a crash-loop breaker (the slot is abandoned
  and :class:`CrashLoopError` hits the flight recorder).

The autoscale plane (`mxnet_tpu_torch.autoscale`) composes on top through
:meth:`ReplicaSupervisor.add_slot` / :meth:`ReplicaSupervisor.retire_slot`
and the router's "warming"/"retired" replica states (a fresh replica
takes no traffic until a health probe promotes it; a retired slot is
never respawned), and drives the router's admission surface --
deadline/priority sheds and the brownout ladder
(:meth:`Router.enter_brownout` / :meth:`Router.exit_brownout`).

Chaos validation rides `fault_injection.FaultPlan`: ``kill_replica_at``
/ ``hang_replica_at`` fire at exact router-dispatch indices and
``corrupt_blob_on_deploy`` bit-flips a deploy's artifact in transit.
`profiler.router_counters()` is the forensic record; every fleet
incident dumps flight-recorder lines.

Replica processes launch via ``python -m mxnet_tpu_torch.serving_fleet
--replica --blob <path> [--gen-blob <path>] [--ctx cpu]`` (see
:func:`spawn_replica_process`): a replica serves on the card (``gpu(0)``)
and raises without one unless ``--ctx cpu`` asks for the CPU.
"""
from __future__ import annotations

import os
import random
import shutil
import socket
import subprocess
import sys
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import fault_injection as _fault
from . import profiler as _prof
from . import ps_wire
from . import telemetry as _tele
from .base import MXNetError
from .config import get_env
from .context import cpu, default_context
from .serving import (CompiledModelPool, DrainTimeoutError, ModelServer,
                      NoHealthyReplicaError)

__all__ = ["fleet_enabled", "CanaryMismatchError", "CrashLoopError",
           "CircuitBreaker", "Replica", "ModelRegistry", "Router",
           "ReplicaSupervisor", "spawn_replica_process"]


def fleet_enabled() -> bool:
    """The fleet kill switch: ``MXTPU_SERVE_FLEET=0`` refuses Router
    construction so deployments fall back to direct client→server
    connections -- the single-server serving plane."""
    return bool(get_env("MXTPU_SERVE_FLEET"))


class CanaryMismatchError(MXNetError):
    """A freshly deployed replica answered the pinned canary input with
    output that is not bitwise-identical to the previous version's.
    The deploy aborts and rolls back — a silently-wrong model never
    takes traffic."""

    def __init__(self, replica: int, version: Optional[str]):
        self.replica = int(replica)
        self.version = version
        super().__init__(
            f"canary mismatch on replica {replica}: version {version!r} "
            "diverges from the serving version on the pinned input — "
            "deploy aborted, rolling back")


class CrashLoopError(MXNetError):
    """A replica slot died too many times inside the crash window; the
    supervisor stops restarting it (the crash-loop breaker)."""

    def __init__(self, slot: int, restarts: int, window_s: float):
        self.slot = int(slot)
        self.restarts = int(restarts)
        self.window_s = float(window_s)
        super().__init__(
            f"replica slot {slot} crash-looping: {restarts} deaths in "
            f"{window_s:.0f}s — supervisor gave up restarting it")


# ---------------------------------------------------------------------------
# the per-replica circuit breaker
# ---------------------------------------------------------------------------

class _SlowReplica(Exception):
    """Internal: a health poll found p99 past the latency-breaker bound."""


class CircuitBreaker:
    """closed → (N consecutive failures) → open → (cooldown) →
    half_open → one probe decides: success closes, failure re-opens.

    ``allow()`` — may USER traffic route here?  True only when closed:
    half-open capacity is spent on health probes, not user requests, so
    a flapping replica never burns a real request to prove itself.
    ``probe_gate()`` — should a health probe run this cycle?  It is
    also where open→half_open happens (on cooldown expiry), keeping the
    whole state machine driven from exactly two call sites.
    """

    def __init__(self, failures: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str, str],
                                                  None]] = None):
        self.failure_limit = int(
            failures if failures is not None
            else get_env("MXTPU_SERVE_BREAKER_FAILURES"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else get_env("MXTPU_SERVE_BREAKER_COOLDOWN_S"))
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at: Optional[float] = None

    @property
    def state(self) -> str:
        return self._state

    def _transition(self, new: str, reason: str) -> None:
        old, self._state = self._state, new
        if new == "open":
            self._opened_at = self._clock()
        if old != new and self._on_transition is not None:
            self._on_transition(old, new, reason)

    def allow(self) -> bool:
        """True iff user traffic may route to this replica."""
        return self._state == "closed"

    def probe_gate(self) -> bool:
        """True iff a health probe should run now; transitions an open
        breaker to half_open once its cooldown has expired."""
        with self._lock:
            if self._state == "open":
                if (self._clock() - self._opened_at) < self.cooldown_s:
                    return False
                self._transition("half_open", "cooldown_expired")
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != "closed":
                self._transition("closed", "recovered")

    def record_failure(self, reason: str = "failure") -> None:
        with self._lock:
            if self._state == "half_open":
                self._transition("open", f"probe_failed:{reason}")
            elif self._state == "closed":
                self._consecutive += 1
                if self._consecutive >= self.failure_limit:
                    self._transition("open", reason)
            # already open: stay open, cooldown keeps its original clock

    def reset(self) -> None:
        """Back to closed (a supervisor just replaced the process)."""
        with self._lock:
            self._consecutive = 0
            if self._state != "closed":
                self._transition("closed", "reset")


# ---------------------------------------------------------------------------
# one replica as the router sees it
# ---------------------------------------------------------------------------

class Replica:
    """Router-side handle: address, breaker, load estimate, identity
    (version/CRC from the stats poll) and a small pooled-socket
    connection cache.  ``roundtrip`` is the only wire path — checkout a
    socket, one frame out, one frame back, check it back in; any fault
    closes the socket (poisoned-stream discipline) and raises."""

    def __init__(self, idx: int, addr: Tuple[str, int],
                 breaker: CircuitBreaker,
                 connect_timeout: float = 5.0):
        self.idx = int(idx)
        self.addr = (addr[0], int(addr[1]))
        self.breaker = breaker
        self.connect_timeout = float(connect_timeout)
        # "active" | "draining" | "warming" (autoscale: must pass a
        # probe before taking traffic) | "retired" (never comes back)
        self.state = "active"
        self.inflight = 0              # router-side requests outstanding
        self.queue_rows = 0            # from the last stats poll
        self.p99_ms = 0.0
        # decode-lane load from the last stats poll (0 when the replica
        # serves no generation lane): queued generate requests, live
        # slot occupancy and the replica's own wait estimate
        self.gen_queue = 0
        self.gen_active = 0
        self.gen_slots = 0
        self.gen_wait_ms = 0.0
        self.version: Optional[str] = None
        self.blob_crc: Optional[int] = None
        self.pid: Optional[int] = None
        self.start_time_unix: Optional[float] = None
        self.generation = 0            # bumped on every set_addr
        self._free: List[socket.socket] = []
        self._lock = threading.Lock()

    def _checkout(self, timeout: float) -> socket.socket:
        with self._lock:
            sock = self._free.pop() if self._free else None
        if sock is None:
            sock = socket.create_connection(self.addr,
                                            timeout=self.connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(timeout)
        return sock

    def roundtrip(self, frame: tuple, timeout: float):
        sock = self._checkout(timeout)
        try:
            ps_wire.send_frame(sock, frame)
            reply = ps_wire.recv_frame(sock)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        if reply is None:
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionError(
                f"replica {self.idx} closed the connection mid-request")
        with self._lock:
            self._free.append(sock)
        return reply

    def close_sockets(self) -> None:
        with self._lock:
            socks, self._free = self._free, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

    def set_addr(self, addr: Tuple[str, int]) -> None:
        """The process behind this slot was replaced (supervisor
        restart): new address, pooled sockets invalid, identity
        unknown until the next stats poll."""
        self.close_sockets()
        self.addr = (addr[0], int(addr[1]))
        self.generation += 1
        self.version = None
        self.blob_crc = None
        self.pid = None
        self.start_time_unix = None
        self.queue_rows = 0
        self.p99_ms = 0.0
        self.gen_queue = 0
        self.gen_active = 0
        self.gen_slots = 0
        self.gen_wait_ms = 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {"idx": self.idx, "addr": f"{self.addr[0]}:{self.addr[1]}",
                "state": self.state, "breaker": self.breaker.state,
                "inflight": int(self.inflight),
                "queue_rows": int(self.queue_rows),
                "p99_ms": float(self.p99_ms),
                "gen_queue": int(self.gen_queue),
                "gen_slots_active": int(self.gen_active),
                "gen_slots": int(self.gen_slots),
                "model_version": self.version,
                "blob_crc": self.blob_crc,
                "pid": self.pid, "generation": int(self.generation)}


# ---------------------------------------------------------------------------
# the versioned model registry
# ---------------------------------------------------------------------------

class ModelRegistry:
    """Named model versions → `export_compiled` blob paths (or decode
    blobs).

    ``register`` verifies the artifact up front through the same
    bounds-checked `_BlobReader` path that will load it at deploy time
    (:meth:`Predictor.load_exported`), so a truncated or bit-rotted
    blob is rejected at publish, not at 2am mid-rollout, and records
    its whole-file CRC so the router can verify what each replica
    actually serves.  ``current``/``previous`` track the fleet's
    deployed version and the instant-rollback target."""

    def __init__(self):
        self._versions: Dict[str, Tuple[str, int]] = {}
        self._current: Optional[str] = None
        self._previous: Optional[str] = None
        self._lock = threading.Lock()

    def register(self, version: str, path: str,
                 verify: bool = True) -> int:
        from .predictor import Predictor

        version = str(version)
        path = str(path)
        if verify:
            from .generation import is_decode_blob, load_decode_blob
            if is_decode_blob(path):
                # generation artifact: verify through the decode-blob
                # loader (magic + CRC + spec + symbol lowering), on the
                # CPU: verification needs no card
                load_decode_blob(path, ctx=cpu())
            else:
                Predictor.load_exported(path)  # CompiledBlobError on rot
        with open(path, "rb") as f:
            crc = zlib.crc32(f.read()) & 0xFFFFFFFF
        with self._lock:
            self._versions[version] = (path, crc)
        _tele.event("registry.register", version=version, path=path,
                    blob_crc=crc)
        return crc

    def resolve(self, version: str) -> Tuple[str, int]:
        with self._lock:
            if version not in self._versions:
                raise MXNetError(
                    f"unknown model version {version!r}; registered: "
                    f"{sorted(self._versions)}")
            return self._versions[version]

    def versions(self) -> List[str]:
        with self._lock:
            return sorted(self._versions)

    @property
    def current(self) -> Optional[str]:
        return self._current

    @property
    def previous(self) -> Optional[str]:
        return self._previous

    def set_current(self, version: Optional[str]) -> None:
        with self._lock:
            if version is not None and version not in self._versions:
                raise MXNetError(f"unknown model version {version!r}")
            if version != self._current:
                self._previous = self._current
                self._current = version


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

class Router:
    """Health-checked, overload-aware front door over N ModelServer
    replicas; see the module docstring for the full contract."""

    def __init__(self, replica_addrs: Sequence[Tuple[str, int]],
                 registry: Optional[ModelRegistry] = None,
                 canary: Optional[Dict[str, np.ndarray]] = None,
                 health_interval: Optional[float] = None,
                 health_timeout: Optional[float] = None,
                 infer_timeout: Optional[float] = None,
                 deploy_timeout: Optional[float] = None,
                 breaker_failures: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None,
                 breaker_p99_ms: Optional[float] = None,
                 seed: int = 0,
                 start_health: bool = True):
        if not fleet_enabled():
            raise MXNetError(
                "MXTPU_SERVE_FLEET=0: the fleet tier is switched off — "
                "connect ServeClients directly to a ModelServer (the "
                "single-server serving plane)")
        if not replica_addrs:
            raise MXNetError("Router needs at least one replica address")
        self._registry = registry
        self._canary = dict(canary) if canary is not None else None
        self._health_interval = float(
            health_interval if health_interval is not None
            else get_env("MXTPU_SERVE_HEALTH_INTERVAL"))
        self._health_timeout = float(
            health_timeout if health_timeout is not None
            else get_env("MXTPU_SERVE_HEALTH_TIMEOUT"))
        self._infer_timeout = float(
            infer_timeout if infer_timeout is not None
            else get_env("MXTPU_SERVE_ROUTER_TIMEOUT"))
        self._deploy_timeout = float(
            deploy_timeout if deploy_timeout is not None
            else get_env("MXTPU_SERVE_DEPLOY_TIMEOUT"))
        self._p99_limit = float(
            breaker_p99_ms if breaker_p99_ms is not None
            else get_env("MXTPU_SERVE_BREAKER_P99_MS"))
        self._lock = threading.Lock()
        self._deploy_lock = threading.Lock()
        self._rr = 0
        self._running = True
        # kept for replicas added later (autoscale scale-up)
        self._breaker_failures = breaker_failures
        self._breaker_cooldown_s = breaker_cooldown_s
        # seeded +/-20% jitter on the health-prober period so parallel
        # control loops (other routers, the autoscaler) never
        # synchronize into a thundering herd against replica stats
        self._jitter_rng = random.Random(int(seed))
        self._brownout = False
        self._replicas: List[Replica] = []
        for i, addr in enumerate(replica_addrs):
            breaker = CircuitBreaker(
                failures=breaker_failures,
                cooldown_s=breaker_cooldown_s,
                on_transition=self._breaker_transition(i))
            self._replicas.append(Replica(i, addr, breaker))
        # front door
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._health_thread: Optional[threading.Thread] = None
        if start_health:
            self.start_health()

    # -- breaker plumbing ------------------------------------------------

    def _breaker_transition(self, idx: int):
        def cb(old: str, new: str, reason: str) -> None:
            _prof.bump_router(f"breaker_{new}")
            _tele.event("router.breaker", replica=idx, frm=old, to=new,
                        reason=reason)
        return cb

    # -- health checking -------------------------------------------------

    def start_health(self) -> None:
        if self._health_thread is not None:
            return
        t = threading.Thread(target=self._health_loop,
                             name="mxtpu-router-health", daemon=True)
        t.start()
        self._health_thread = t

    def _health_loop(self) -> None:
        while self._running:
            self.health_cycle()
            time.sleep(self._health_interval
                       * (0.8 + 0.4 * self._jitter_rng.random()))

    def health_cycle(self) -> None:
        """One probe pass over the fleet (public so tests and the bench
        can drive health deterministically without the thread)."""
        for rep in list(self._replicas):
            if not self._running:
                return
            if rep.state == "retired":
                continue
            if not rep.breaker.probe_gate():
                continue  # open, still cooling down
            self._probe_replica(rep)

    def probe_warming(self) -> int:
        """Probe only the warming replicas (the autoscaler drives this
        each poll so warm-up never waits on the health thread's period);
        returns how many were promoted to active."""
        promoted = 0
        for rep in list(self._replicas):
            if rep.state != "warming" or not rep.breaker.probe_gate():
                continue
            if self._probe_replica(rep) and rep.state == "active":
                promoted += 1
        return promoted

    def _probe_replica(self, rep: Replica) -> bool:
        """Ping + stats-poll one replica, drive its breaker, and
        promote it out of "warming" on the first passed probe (warm-up
        gating: a cold replica never takes traffic before this)."""
        _prof.bump_router("health_probes")
        try:
            pong = rep.roundtrip(("ping",),
                                 timeout=self._health_timeout)
            if pong != ("pong",):
                raise ConnectionError(
                    f"replica {rep.idx} bad ping reply {pong!r}")
            reply = rep.roundtrip(("stats",),
                                  timeout=self._health_timeout)
            if not (isinstance(reply, tuple) and len(reply) == 2
                    and reply[0] == "stats"
                    and isinstance(reply[1], dict)):
                raise ConnectionError(
                    f"replica {rep.idx} bad stats reply")
            st = reply[1]
            rep.queue_rows = int(st.get("serve_queue_rows", 0) or 0)
            rep.p99_ms = float(st.get("p99_ms", 0.0) or 0.0)
            # decode-lane load (absent on infer-only replicas -> 0):
            # the autoscaler folds these into its saturation signals
            rep.gen_queue = int(st.get("gen_queue", 0) or 0)
            rep.gen_active = int(st.get("gen_slots_active", 0) or 0)
            rep.gen_slots = int(st.get("gen_slots", 0) or 0)
            rep.gen_wait_ms = float(st.get("gen_est_wait_ms", 0.0)
                                    or 0.0)
            rep.version = st.get("model_version")
            rep.blob_crc = st.get("blob_crc")
            rep.pid = st.get("pid")
            rep.start_time_unix = st.get("start_time_unix")
            if self._p99_limit and rep.p99_ms > self._p99_limit:
                raise _SlowReplica()
            rep.breaker.record_success()
            if rep.state == "warming":
                with self._lock:
                    if rep.state == "warming":
                        rep.state = "active"
                _prof.bump_autoscale("warmups")
                _tele.event("router.warmup", kind="warmup",
                            replica=rep.idx, version=rep.version)
            return True
        except _SlowReplica:
            _prof.bump_router("health_failures")
            rep.breaker.record_failure("slow_p99")
            return False
        except (ConnectionError, OSError) as e:
            _prof.bump_router("health_failures")
            rep.breaker.record_failure(f"probe:{type(e).__name__}")
            return False

    # -- balancing + failover --------------------------------------------

    def _pick(self, exclude) -> Optional[Replica]:
        """Least-loaded healthy replica (queue depth from the last
        stats poll + the router's own in-flight count), round-robin
        tiebreak; reserves an in-flight slot on the winner."""
        with self._lock:
            n = len(self._replicas)
            best, best_key = None, None
            for off in range(n):
                rep = self._replicas[(self._rr + off) % n]
                if (rep.idx in exclude or rep.state != "active"
                        or not rep.breaker.allow()):
                    continue
                # decode-lane backlog counts as load too (0 on
                # infer-only replicas, so their order is unchanged)
                key = (rep.queue_rows + rep.inflight
                       + rep.gen_queue + rep.gen_active)
                if best is None or key < best_key:
                    best, best_key = rep, key
            if best is None:
                return None
            self._rr = (best.idx + 1) % n
            best.inflight += 1
            return best

    def _census(self) -> Tuple[int, int, int]:
        with self._lock:
            reps = [r for r in self._replicas if r.state != "retired"]
            breaker_open = sum(1 for r in reps
                               if not r.breaker.allow())
            draining = sum(1 for r in reps
                           if r.state == "draining")
            return len(reps), breaker_open, draining

    def _no_healthy(self, detail: str) -> NoHealthyReplicaError:
        total, breaker_open, draining = self._census()
        exc = NoHealthyReplicaError(total, breaker_open=breaker_open,
                                    draining=draining, detail=detail)
        _prof.bump_router("no_healthy_replica")
        _tele.record_error(exc, kind="no_healthy_replica",
                           replicas=total, breaker_open=breaker_open,
                           draining=draining)
        return exc

    def route_infer(self, req_id, inputs: Dict[str, np.ndarray],
                    ctx: Optional[dict] = None) -> tuple:
        """Route one infer; returns the replica's wire reply tuple
        (possibly annotated).  Transport faults fail over ONCE to a
        healthy replica — safe, the serving path is read-only; overload
        sheds are relayed with a ``retry_after_ms`` hint, never
        resubmitted; raises :class:`NoHealthyReplicaError` when no
        replica can take the request."""
        plan = _fault.active()
        if plan is not None:
            plan.router_dispatch_event()
        _prof.bump_router("requests")
        # admission control: refuse work we already know we cannot do
        # well, instead of queueing it to die.  Low-priority requests
        # shed first while the fleet is in declared brownout; a request
        # carrying a deadline budget the estimated queueing delay
        # already exceeds is refused immediately with an honest
        # retry_after_ms.  Requests without a ctx header hit neither
        # branch.
        if isinstance(ctx, dict):
            if self._brownout and ctx.get("priority") == "low":
                return self._admission_shed(
                    req_id, inputs, "priority",
                    "low-priority request shed in brownout")
            deadline_ms = ctx.get("deadline_ms")
            if deadline_ms is not None:
                est = self._estimate_wait_ms()
                if est > float(deadline_ms):
                    return self._admission_shed(
                        req_id, inputs, "deadline",
                        f"estimated wait {est:.0f}ms exceeds the "
                        f"request's {float(deadline_ms):.0f}ms "
                        "deadline budget")
        frame = ("infer", req_id, inputs)
        if ctx is not None:
            frame = frame + (ctx,)
        exclude: set = set()
        attempts = 0
        while attempts < 2:
            rep = self._pick(exclude)
            if rep is None:
                raise self._no_healthy(
                    "while routing an infer" if not attempts
                    else "after a failover attempt")
            attempts += 1
            try:
                reply = rep.roundtrip(frame, timeout=self._infer_timeout)
            except (ConnectionError, OSError) as e:
                # socket.timeout is an OSError: a hung replica lands
                # here too and the request moves on
                rep.breaker.record_failure(f"infer:{type(e).__name__}")
                _prof.bump_router("replica_errors")
                exclude.add(rep.idx)
                if attempts < 2:
                    _prof.bump_router("failovers")
                    _tele.event("router.failover", frm=rep.idx,
                                reason=type(e).__name__)
                continue
            finally:
                with self._lock:
                    rep.inflight = max(0, rep.inflight - 1)
            if (isinstance(reply, tuple) and len(reply) == 5
                    and reply[0] == "err"):
                kind = reply[2]
                if kind == "overload":
                    # relay, never resubmit — but attach the informed-
                    # retry hint: roughly how long this replica needs
                    # to work off its queue at its current p99
                    info = dict(reply[4])
                    pending = float(info.get("pending_rows", 0) or 0)
                    limit = max(1.0, float(info.get("limit", 1) or 1))
                    p99 = rep.p99_ms or float(
                        get_env("MXTPU_SERVE_MAX_DELAY_MS"))
                    info["retry_after_ms"] = float(
                        min(1000.0, max(1.0, pending * p99 / limit)))
                    _prof.bump_router("sheds_relayed")
                    return ("err", reply[1], "overload", reply[3], info)
                if kind == "draining":
                    # the replica started draining under us (deploy
                    # race): bounce to another one, no breaker blame —
                    # unless it is CLOSED, which is death by another
                    # name and should trip the breaker like death
                    if (reply[4] or {}).get("closed"):
                        rep.breaker.record_failure("closed")
                    _prof.bump_router("drain_bounces")
                    exclude.add(rep.idx)
                    continue
                _prof.bump_router("replica_errors")
                return reply
            rep.breaker.record_success()
            _prof.bump_router("responses")
            return reply
        raise self._no_healthy("both routing attempts failed")

    def infer(self, inputs: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """In-process convenience: route and unwrap (tests/bench)."""
        reply = self.route_infer("router-local", dict(inputs))
        if reply[0] == "ok":
            return [np.asarray(o) for o in reply[2]]
        self._raise_reply_err("infer", reply)

    def _raise_reply_err(self, what: str, reply: tuple) -> None:
        kind, detail, info = reply[2], reply[3], reply[4]
        if kind == "overload":
            from .serving import ServerOverloadError
            raise ServerOverloadError(
                info.get("requested", 0), info.get("pending_rows", 0),
                info.get("limit", 0),
                retry_after_ms=info.get("retry_after_ms"))
        raise MXNetError(f"fleet {what} failed ({kind}): {detail}")

    def route_generate(self, req_id, spec: Dict[str, Any],
                       ctx: Optional[dict] = None) -> tuple:
        """Route one ``generate`` request with the same breaker /
        failover / admission discipline as :meth:`route_infer`.
        Failover is safe for the same reason: decode is read-only
        against the served model, so replaying the request on another
        replica is idempotent.  Deadline admission uses the replicas'
        own decode-lane wait estimates (``gen_est_wait_ms`` from the
        stats poll) — the slot arena, not the micro-batch queue, is
        what a generation request waits on."""
        plan = _fault.active()
        if plan is not None:
            plan.router_dispatch_event()
        _prof.bump_router("requests")
        if isinstance(ctx, dict):
            if self._brownout and ctx.get("priority") == "low":
                return self._admission_shed(
                    req_id, {}, "priority",
                    "low-priority generate shed in brownout")
            deadline_ms = ctx.get("deadline_ms")
            if deadline_ms is not None:
                est = self._estimate_gen_wait_ms()
                if est > float(deadline_ms):
                    return self._admission_shed(
                        req_id, {}, "deadline",
                        f"estimated decode wait {est:.0f}ms exceeds "
                        f"the request's {float(deadline_ms):.0f}ms "
                        "deadline budget")
        frame = ("generate", req_id, spec)
        if ctx is not None:
            frame = frame + (ctx,)
        exclude: set = set()
        attempts = 0
        while attempts < 2:
            rep = self._pick(exclude)
            if rep is None:
                raise self._no_healthy(
                    "while routing a generate" if not attempts
                    else "after a failover attempt")
            attempts += 1
            try:
                reply = rep.roundtrip(frame, timeout=self._infer_timeout)
            except (ConnectionError, OSError) as e:
                rep.breaker.record_failure(f"generate:{type(e).__name__}")
                _prof.bump_router("replica_errors")
                exclude.add(rep.idx)
                if attempts < 2:
                    _prof.bump_router("failovers")
                    _tele.event("router.failover", frm=rep.idx,
                                reason=type(e).__name__)
                continue
            finally:
                with self._lock:
                    rep.inflight = max(0, rep.inflight - 1)
            if (isinstance(reply, tuple) and len(reply) == 5
                    and reply[0] == "err"):
                kind = reply[2]
                if kind == "overload":
                    # relay, never resubmit; the decode lane already
                    # attaches its honest retry_after_ms — only fill
                    # one in if the replica predates the hint
                    info = dict(reply[4])
                    if info.get("retry_after_ms") is None:
                        info["retry_after_ms"] = float(min(
                            10_000.0,
                            max(1.0, rep.gen_wait_ms
                                or self._estimate_gen_wait_ms())))
                    _prof.bump_router("sheds_relayed")
                    return ("err", reply[1], "overload", reply[3], info)
                if kind == "draining":
                    if (reply[4] or {}).get("closed"):
                        rep.breaker.record_failure("closed")
                    _prof.bump_router("drain_bounces")
                    exclude.add(rep.idx)
                    continue
                _prof.bump_router("replica_errors")
                return reply
            rep.breaker.record_success()
            _prof.bump_router("responses")
            return reply
        raise self._no_healthy("both routing attempts failed")

    def generate(self, prompt, max_new_tokens: int) -> np.ndarray:
        """In-process convenience: route one generate and unwrap."""
        reply = self.route_generate(
            "router-local",
            {"prompt": np.asarray(prompt, np.int32),
             "max_new_tokens": int(max_new_tokens)})
        if reply[0] == "ok":
            return np.asarray(reply[2]["tokens"], np.int32)
        self._raise_reply_err("generate", reply)

    def _estimate_gen_wait_ms(self) -> float:
        """Decode-lane analog of :meth:`_estimate_wait_ms`: the best
        routable replica's own slot-arena wait estimate (from its last
        stats poll), falling back to the infer estimate when no
        replica reports a decode lane."""
        best = None
        with self._lock:
            for rep in self._replicas:
                if rep.state != "active" or not rep.breaker.allow():
                    continue
                if rep.gen_slots <= 0:
                    continue
                if best is None or rep.gen_wait_ms < best:
                    best = rep.gen_wait_ms
        return best if best is not None else self._estimate_wait_ms()

    # -- admission control + brownout (autoscale plane) ------------------

    def _estimate_wait_ms(self) -> float:
        """Rough estimate of the queueing delay a new request faces:
        the least-loaded routable replica's backlog worked off one max
        batch per p99, plus one service time.  Deliberately coarse —
        it only has to be honest enough for deadline admission and the
        retry_after_ms hint."""
        base_delay = float(get_env("MXTPU_SERVE_MAX_DELAY_MS"))
        max_batch = max(1, int(get_env("MXTPU_SERVE_MAX_BATCH")))
        best = None
        with self._lock:
            for rep in self._replicas:
                if rep.state != "active" or not rep.breaker.allow():
                    continue
                p99 = rep.p99_ms or base_delay
                est = p99 * (1.0 + (rep.queue_rows + rep.inflight)
                             / max_batch)
                if best is None or est < best:
                    best = est
        return best if best is not None else base_delay

    def _admission_shed(self, req_id, inputs: Dict[str, np.ndarray],
                        why: str, detail: str) -> tuple:
        """Refuse a request at admission with the same overload wire
        shape a replica shed produces, so every existing client handles
        it (never retried blindly; retried once on the honest hint)."""
        rows = 0
        for v in inputs.values():
            try:
                rows = int(np.asarray(v).shape[0])
            except Exception:
                rows = 1
            break
        with self._lock:
            pending = sum(r.queue_rows + r.inflight
                          for r in self._replicas
                          if r.state == "active")
        est = self._estimate_wait_ms()
        info = {"requested": rows, "pending_rows": int(pending),
                "limit": int(get_env("MXTPU_SERVE_QUEUE_LIMIT")),
                "retry_after_ms": float(min(1000.0, max(1.0, est))),
                "reason": why, "brownout": bool(self._brownout)}
        _prof.bump_autoscale(f"{why}_sheds")
        _tele.event("router.admission_shed", kind=f"{why}_shed",
                    req_id=str(req_id), rows=rows, detail=detail)
        return ("err", req_id, "overload", detail, info)

    @property
    def brownout(self) -> bool:
        return self._brownout

    def enter_brownout(self, delay_factor: Optional[float] = None,
                       rung_cap: Optional[int] = None) -> bool:
        """Declare degraded mode (fleet at max and still saturated):
        widen every replica's micro-batch deadline by the brownout
        factor (batches run full — latency traded for goodput) and
        optionally cap its flush size to one ladder rung.  Idempotent;
        returns True on the enter transition."""
        with self._lock:
            if self._brownout:
                return False
            self._brownout = True
        factor = float(
            delay_factor if delay_factor is not None
            else get_env("MXTPU_SERVE_BROWNOUT_DELAY_FACTOR"))
        cap = int(rung_cap if rung_cap is not None
                  else get_env("MXTPU_SERVE_BROWNOUT_RUNG_CAP"))
        spec: Dict[str, Any] = {
            "max_delay_ms": float(get_env("MXTPU_SERVE_MAX_DELAY_MS"))
            * max(1.0, factor)}
        if cap > 0:
            spec["max_batch"] = cap
        self._broadcast_tune(spec, "brownout")
        _prof.bump_autoscale("brownout_enters")
        _tele.event("router.brownout", kind="brownout_enter", **spec)
        return True

    def exit_brownout(self) -> bool:
        """Clean recovery: restore every replica's base batching ladder
        exactly.  Idempotent; returns True on the exit transition."""
        with self._lock:
            if not self._brownout:
                return False
            self._brownout = False
        self._broadcast_tune({}, "recover")  # {} = restore base tuning
        _prof.bump_autoscale("brownout_exits")
        _tele.event("router.brownout", kind="brownout_exit")
        return True

    def _broadcast_tune(self, spec: Dict[str, Any], label: str) -> None:
        """Best-effort tune broadcast: a dead replica is skipped (the
        supervisor's replacement starts at base tuning anyway — it
        picks the brownout ladder up on the next transition)."""
        for rep in self.replicas:
            if rep.state == "retired":
                continue
            try:
                rep.roundtrip(("tune", f"{label}:{rep.idx}", dict(spec)),
                              timeout=self._health_timeout)
            except (ConnectionError, OSError):
                pass

    # -- fleet resizing (autoscale plane) --------------------------------

    def add_replica(self, addr: Tuple[str, int]) -> int:
        """Append a fresh replica slot in the non-routable "warming"
        state: it takes no traffic until a health probe passes and
        :meth:`_probe_replica` promotes it (no cold replica ever takes
        traffic)."""
        with self._lock:
            idx = len(self._replicas)
            breaker = CircuitBreaker(
                failures=self._breaker_failures,
                cooldown_s=self._breaker_cooldown_s,
                on_transition=self._breaker_transition(idx))
            rep = Replica(idx, addr, breaker)
            rep.state = "warming"
            self._replicas.append(rep)
        _tele.event("router.replica_added", replica=idx,
                    addr=f"{addr[0]}:{addr[1]}")
        return idx

    def quiesce_replica(self, idx: int) -> None:
        """Stop assigning new traffic to a replica ahead of retirement
        (the scale-down drain); in-flight work finishes normally."""
        with self._lock:
            rep = self._replicas[int(idx)]
            if rep.state == "active":
                rep.state = "draining"

    def retire_replica(self, idx: int) -> None:
        """Permanently remove a slot from the fleet: never picked,
        never probed, never readmitted (indices stay stable so the
        supervisor's slot mapping is untouched)."""
        rep = self._replicas[int(idx)]
        with self._lock:
            rep.state = "retired"
        rep.close_sockets()
        _tele.event("router.replica_retired", replica=rep.idx)

    # -- rolling deploy + rollback ---------------------------------------

    def deploy(self, version: str,
               check_canary: Optional[bool] = None,
               drain_timeout: Optional[float] = None) -> None:
        """Zero-downtime rolling hot swap of the whole fleet to a
        registered version; any failure rolls every upgraded replica
        back to the previous version.  See the module docstring."""
        if self._registry is None:
            raise MXNetError("Router.deploy needs a ModelRegistry")
        with self._deploy_lock:
            path, crc = self._registry.resolve(version)
            plan = _fault.active()
            if plan is not None and plan.deploy_event():
                path = self._corrupt_blob_copy(path)
            check = (self._canary is not None if check_canary is None
                     else bool(check_canary))
            expected = None
            if check and self._canary is not None:
                expected = self._canary_baseline()
            prev_version = self._registry.current
            _tele.event("router.deploy_begin", version=version,
                        prev=prev_version, blob_crc=crc,
                        canary=bool(expected))
            upgraded: List[Replica] = []
            rep: Optional[Replica] = None
            try:
                for rep in list(self._replicas):
                    if rep.state in ("retired", "warming"):
                        # not part of serving capacity: a retired slot
                        # never comes back, a warming one respawns at
                        # the registry's current version anyway
                        continue
                    if not rep.breaker.allow():
                        # dead/tripped replica: skip, don't abort the
                        # fleet — its breaker sheds traffic and the
                        # supervisor replaces it (the replacement's
                        # version resyncs through set_replica_addr)
                        _prof.bump_router("deploy_skips")
                        _tele.event("router.deploy_skip",
                                    replica=rep.idx,
                                    breaker=rep.breaker.state)
                        continue
                    try:
                        self._deploy_one(rep, path, version,
                                         expected=expected,
                                         drain_timeout=drain_timeout)
                    except (ConnectionError, OSError) as exc:
                        # the replica died UNDER the deploy (e.g. a
                        # chaos SIGKILL mid-rolling-deploy): trip its
                        # breaker and keep rolling — replica death is
                        # the supervisor's problem, not a bad artifact
                        rep.breaker.record_failure(
                            f"deploy:{type(exc).__name__}")
                        _prof.bump_router("deploy_skips")
                        _tele.event("router.deploy_skip",
                                    replica=rep.idx,
                                    error=type(exc).__name__)
                        continue
                    upgraded.append(rep)
                if not upgraded:
                    raise self._no_healthy(
                        f"no replica accepted the deploy of {version!r}")
            except Exception as exc:
                _prof.bump_router("deploy_failures")
                _tele.event("router.deploy_failed", version=version,
                            error=f"{type(exc).__name__}: {exc}",
                            upgraded=len(upgraded))
                # the failing replica may have swapped before its
                # canary failed: roll it back along with the already-
                # upgraded ones (a not-yet-swapped replica just noops)
                to_roll = list(upgraded)
                if rep is not None and rep not in to_roll:
                    to_roll.append(rep)
                self._rollback_replicas(to_roll, prev_version,
                                        drain_timeout)
                raise
            self._registry.set_current(version)
            _prof.bump_router("deploys")
            _tele.event("router.deploy_done", version=version,
                        blob_crc=crc)

    def rollback(self) -> str:
        """Instant fleet-wide return to the previous registry version
        (stashed-pool swap server-side, no capture, no canary)."""
        if self._registry is None:
            raise MXNetError("Router.rollback needs a ModelRegistry")
        prev = self._registry.previous
        if prev is None:
            raise MXNetError("no previous version to roll back to")
        self.deploy(prev, check_canary=False)
        _prof.bump_router("rollbacks")
        return prev

    def _rollback_replicas(self, reps: Sequence[Replica],
                           prev_version: Optional[str],
                           drain_timeout: Optional[float]) -> None:
        if prev_version is None or not reps:
            return
        prev_path, _ = self._registry.resolve(prev_version)
        for rep in reps:
            try:
                self._deploy_one(rep, prev_path, prev_version,
                                 expected=None,
                                 drain_timeout=drain_timeout)
            except Exception as exc:  # keep rolling the rest back
                _tele.record_error(exc, kind="rollback_failed",
                                   replica=rep.idx,
                                   version=str(prev_version))
        _prof.bump_router("rollbacks")

    def _deploy_one(self, rep: Replica, path: str,
                    version: Optional[str],
                    expected: Optional[List[np.ndarray]],
                    drain_timeout: Optional[float]) -> None:
        """Drain + hot-swap + canary-check one replica.  The replica is
        readmitted on exit unless the canary said it now serves a wrong
        model — then it stays out of rotation until rolled back."""
        timeout = float(drain_timeout if drain_timeout is not None
                        else get_env("MXTPU_SERVE_DRAIN_TIMEOUT"))
        with self._lock:
            rep.state = "draining"
        _prof.bump_router("drains")
        _tele.event("router.drain", replica=rep.idx, version=version)
        readmit = True
        try:
            # router-side quiesce: no new picks land on it; wait out
            # requests this router already has in flight there
            t_end = time.monotonic() + timeout
            while rep.inflight > 0:
                if time.monotonic() >= t_end:
                    exc = DrainTimeoutError(0, rep.inflight, timeout)
                    _tele.record_error(exc, kind="drain_timeout",
                                       replica=rep.idx,
                                       inflight=rep.inflight)
                    raise exc
                time.sleep(0.005)
            # replica-side drain: flush its own queue (other routers/
            # direct clients may feed it); bounded server-side too
            reply = rep.roundtrip(
                ("drain", f"deploy:{version}", timeout),
                timeout=timeout + self._health_timeout + 1.0)
            if reply[0] == "err":
                if reply[2] == "drain_timeout":
                    info = reply[4]
                    exc = DrainTimeoutError(
                        info.get("pending_rows", 0),
                        info.get("inflight", 0), timeout)
                    _tele.record_error(exc, kind="drain_timeout",
                                       replica=rep.idx)
                    raise exc
                raise MXNetError(f"drain failed on replica {rep.idx} "
                                 f"({reply[2]}): {reply[3]}")
            # hot swap: the replica captures the new pool BEFORE its
            # own drain+swap, so a corrupt blob fails right here with
            # the old version still loaded
            reply = rep.roundtrip(
                ("deploy", f"deploy:{version}",
                 {"path": str(path), "version": version}),
                timeout=self._deploy_timeout)
            if reply[0] == "err":
                raise MXNetError(
                    f"deploy failed on replica {rep.idx} "
                    f"({reply[2]}): {reply[3]}")
            payload = reply[2] or {}
            # canary: the new pool must reproduce the old version's
            # output bitwise on the pinned input before readmission
            if expected is not None:
                creply = rep.roundtrip(
                    ("infer", f"canary:{version}", dict(self._canary)),
                    timeout=self._infer_timeout)
                if creply[0] != "ok":
                    raise MXNetError(
                        f"canary infer failed on replica {rep.idx}: "
                        f"{creply[2:]!r}")
                got = [np.asarray(o) for o in creply[2]]
                same = (len(got) == len(expected) and all(
                    g.shape == e.shape and g.dtype == e.dtype
                    and g.tobytes() == e.tobytes()
                    for g, e in zip(got, expected)))
                if not same:
                    _prof.bump_router("canary_mismatches")
                    exc = CanaryMismatchError(rep.idx, version)
                    _tele.record_error(exc, kind="canary_mismatch",
                                       replica=rep.idx,
                                       version=str(version))
                    readmit = False  # wrong model: stay out until
                    raise exc        # the rollback re-deploys it
                _prof.bump_router("canary_passes")
            rep.version = payload.get("version", version)
            rep.blob_crc = payload.get("blob_crc")
            _prof.bump_router("hot_swaps")
            _tele.event("router.hot_swap", replica=rep.idx,
                        version=version, blob_crc=rep.blob_crc)
        finally:
            if readmit:
                with self._lock:
                    rep.state = "active"

    def _canary_baseline(self) -> List[np.ndarray]:
        """The CURRENT fleet's answer to the pinned canary input — the
        reference every upgraded replica must reproduce bitwise."""
        reply = self.route_infer("canary:baseline", dict(self._canary))
        if reply[0] != "ok":
            raise MXNetError(
                f"canary baseline failed on the serving version: "
                f"{reply[2:]!r}")
        return [np.asarray(o) for o in reply[2]]

    @staticmethod
    def _corrupt_blob_copy(path: str) -> str:
        """Chaos hook: ship a bit-flipped COPY of the blob (the
        registry's artifact is never touched), so the replica-side CRC
        footer / canary rejects the deploy."""
        dst = str(path) + ".chaos-corrupt"
        shutil.copyfile(path, dst)
        size = os.path.getsize(dst)
        with open(dst, "r+b") as f:
            k = size // 2
            f.seek(k)
            b = f.read(1)
            f.seek(k)
            f.write(bytes((b[0] ^ 0xFF,)))
        _tele.event("router.blob_corrupted", path=dst)
        return dst

    # -- supervisor hook -------------------------------------------------

    def set_replica_addr(self, idx: int, addr: Tuple[str, int]) -> None:
        """A supervisor replaced the process behind slot ``idx``: point
        the slot at the new address with a clean slate (breaker closed,
        active, identity unknown until the next stats poll).  An index
        one past the fleet appends a fresh WARMING slot (the autoscale
        scale-up path); a respawned warming replica stays warming (it
        must still pass a probe before taking traffic); a retired slot
        never re-enters the fleet."""
        idx = int(idx)
        if idx == len(self._replicas):
            self.add_replica(addr)
            return
        rep = self._replicas[idx]
        if rep.state == "retired":
            return
        warming = rep.state == "warming"
        with self._lock:
            rep.set_addr(addr)
            rep.state = "warming" if warming else "active"
        rep.breaker.reset()
        _tele.event("router.replica_replaced", replica=rep.idx,
                    addr=f"{addr[0]}:{addr[1]}",
                    generation=rep.generation)

    # -- observability ---------------------------------------------------

    @property
    def replicas(self) -> List[Replica]:
        return list(self._replicas)

    def fleet_stats(self) -> Dict[str, Any]:
        with self._lock:
            reps = [r.snapshot() for r in self._replicas]
        return {"replicas": reps,
                "router": _prof.router_counters(),
                "autoscale": _prof.autoscale_counters(),
                "brownout": bool(self._brownout),
                "current_version": (self._registry.current
                                    if self._registry else None),
                "previous_version": (self._registry.previous
                                     if self._registry else None)}

    # -- front door (same framing as ModelServer.serve) ------------------

    def serve(self, host: str = "127.0.0.1",
              port: int = 0) -> Tuple[str, int]:
        if self._listener is not None:
            raise MXNetError("router front door already open")
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(64)
        srv.settimeout(0.1)
        self._listener = srv
        t = threading.Thread(target=self._accept_loop,
                             name="mxtpu-router-accept", daemon=True)
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
                return
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 name="mxtpu-router-conn", daemon=True)
            t.start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while self._running:
                try:
                    msg = ps_wire.recv_frame(conn)
                except ps_wire.WireError:
                    return  # poisoned stream: drop, client replays
                if msg is None:
                    return
                reply = self._handle_msg(msg)
                ps_wire.send_frame(conn, reply)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _handle_msg(self, msg) -> tuple:
        req_id = msg[1] if isinstance(msg, tuple) and len(msg) > 1 \
            else None
        if not isinstance(msg, tuple) or not msg:
            return ps_wire.err_frame(
                req_id, "bad_request",
                "front-door message must be a tagged tuple")
        op = msg[0]
        try:
            if op == "ping":
                return ("pong",)
            if op == "stats":
                return ("stats", self.fleet_stats())
            if op == "infer":
                if len(msg) not in (3, 4) or not isinstance(msg[2], dict):
                    return ps_wire.err_frame(
                        req_id, "bad_request",
                        "infer frame must be ('infer', req_id, "
                        "{name: array}[, ctx])")
                ctx = msg[3] if len(msg) == 4 else None
                with _tele.adopt(ctx):
                    return self.route_infer(msg[1], msg[2], ctx)
            if op == "generate":
                if len(msg) not in (3, 4) or not isinstance(msg[2], dict):
                    return ps_wire.err_frame(
                        req_id, "bad_request",
                        "generate frame must be ('generate', req_id, "
                        "{'prompt': arr, 'max_new_tokens': n}[, ctx])")
                ctx = msg[3] if len(msg) == 4 else None
                with _tele.adopt(ctx):
                    return self.route_generate(msg[1], msg[2], ctx)
            if op == "deploy":
                if len(msg) != 3 or not isinstance(msg[2], dict) \
                        or "version" not in msg[2]:
                    return ps_wire.err_frame(
                        req_id, "bad_request",
                        "router deploy frame must be ('deploy', "
                        "req_id, {'version': name})")
                spec = msg[2]
                self.deploy(str(spec["version"]),
                            check_canary=spec.get("check_canary"),
                            drain_timeout=spec.get("drain_timeout"))
                return ps_wire.ok_frame(
                    req_id, {"version": self._registry.current})
            if op == "rollback":
                version = self.rollback()
                return ps_wire.ok_frame(req_id, {"version": version})
            return ps_wire.err_frame(req_id, "bad_request",
                                     f"unknown router op {op!r}")
        except NoHealthyReplicaError as e:
            return ps_wire.err_frame(req_id, "no_healthy_replica", e,
                                     e.wire_info())
        except CanaryMismatchError as e:
            return ps_wire.err_frame(req_id, "canary_mismatch", e,
                                     {"replica": e.replica,
                                      "version": str(e.version)})
        except DrainTimeoutError as e:
            return ps_wire.err_frame(req_id, "drain_timeout", e,
                                     {"pending_rows": e.pending_rows,
                                      "inflight": e.inflight,
                                      "timeout_s": e.timeout_s})
        except MXNetError as e:
            kind = "deploy_failed" if op in ("deploy", "rollback") \
                else "bad_request"
            return ps_wire.err_frame(req_id, kind, e, {})
        except Exception as e:
            return ps_wire.err_frame(req_id, "internal",
                                     f"{type(e).__name__}: {e}", {})

    # -- lifecycle -------------------------------------------------------

    def close(self) -> None:
        self._running = False
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=2.0)
        for rep in self._replicas:
            rep.close_sockets()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# the replica supervisor
# ---------------------------------------------------------------------------

class ReplicaSupervisor:
    """Keeps N replica slots populated with live processes.

    ``spawn(slot) -> (proc, (host, port))`` is caller-supplied (tests
    pass fakes; production passes :func:`spawn_replica_process`); the
    only contract on ``proc`` is ``poll()`` (None = alive).  A dead
    slot restarts after seeded jittered exponential backoff —
    ``min(max, base * 2^k) * (0.5 + U[0,1))`` where ``k`` counts recent
    deaths — and the router is repointed at the new address.  Too many
    deaths inside ``crash_window_s`` open the crash-loop breaker: the
    slot is abandoned, :class:`CrashLoopError` hits the flight
    recorder, and the fleet runs degraded rather than thrashing.
    ``clock``/``sleep`` are injectable so chaos tests replay exactly.
    """

    def __init__(self, spawn: Callable[[int], Tuple[Any,
                                                    Tuple[str, int]]],
                 slots: int, router: Optional[Router] = None,
                 backoff_base_s: float = 0.2,
                 backoff_max_s: float = 5.0,
                 crash_window_s: float = 30.0, crash_limit: int = 5,
                 seed: int = 0, poll_interval_s: float = 0.1,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self._spawn = spawn
        self._slots = int(slots)
        self._router = router
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._crash_window_s = float(crash_window_s)
        self._crash_limit = int(crash_limit)
        self._poll_interval_s = float(poll_interval_s)
        self._clock = clock
        self._sleep = sleep
        self._rng = random.Random(int(seed))
        self._procs: List[Any] = [None] * self._slots
        self._addrs: List[Optional[Tuple[str, int]]] = \
            [None] * self._slots
        self._deaths: List[List[float]] = [[] for _ in
                                           range(self._slots)]
        self._crash_looped = [False] * self._slots
        self._retired = [False] * self._slots
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    @property
    def procs(self) -> List[Any]:
        return list(self._procs)

    @property
    def addresses(self) -> List[Optional[Tuple[str, int]]]:
        return list(self._addrs)

    @property
    def crash_looped(self) -> List[bool]:
        return list(self._crash_looped)

    @property
    def retired(self) -> List[bool]:
        return list(self._retired)

    def start(self, monitor: bool = True) -> None:
        for slot in range(self._slots):
            if self._procs[slot] is None:
                self._spawn_slot(slot)
        self._running = True
        if monitor:
            t = threading.Thread(target=self._monitor_loop,
                                 name="mxtpu-supervisor", daemon=True)
            t.start()
            self._thread = t

    def _spawn_slot(self, slot: int) -> None:
        proc, addr = self._spawn(slot)
        self._procs[slot] = proc
        self._addrs[slot] = (addr[0], int(addr[1]))
        if self._router is not None:
            self._router.set_replica_addr(slot, self._addrs[slot])

    def add_slot(self) -> int:
        """Grow the fleet by one supervised slot (the autoscale
        scale-up path): spawns the process and points the router's
        matching slot at it — appended in "warming" state, so it takes
        no traffic until a health probe passes.  Returns the slot."""
        with self._lock:
            slot = self._slots
            self._slots += 1
            self._procs.append(None)
            self._addrs.append(None)
            self._deaths.append([])
            self._crash_looped.append(False)
            self._retired.append(False)
        self._spawn_slot(slot)
        _tele.event("supervisor.add_slot", slot=slot)
        return slot

    def retire_slot(self, slot: int, kill: bool = True) -> None:
        """Permanently retire a slot (the autoscale scale-down path):
        the supervisor NEVER respawns it, whatever its process does
        afterwards — a retired replica stays retired."""
        slot = int(slot)
        with self._lock:
            self._retired[slot] = True
        proc = self._procs[slot]
        if kill and proc is not None:
            try:
                if proc.poll() is None:
                    proc.kill()
            except Exception:
                pass
        _tele.event("supervisor.retire_slot", slot=slot)

    def _monitor_loop(self) -> None:
        while self._running:
            self.check_once()
            self._sleep(self._poll_interval_s)

    def check_once(self) -> None:
        """One scan: restart (or crash-loop-abandon) every dead slot.
        Public so tests drive supervision deterministically."""
        for slot in range(self._slots):
            proc = self._procs[slot]
            if proc is None or self._crash_looped[slot] \
                    or self._retired[slot]:
                continue
            if proc.poll() is None:
                continue
            self._handle_death(slot, proc)

    def _handle_death(self, slot: int, proc) -> None:
        if self._retired[slot]:
            return  # retired between the poll and here: stays retired
        now = self._clock()
        deaths = self._deaths[slot]
        deaths.append(now)
        while deaths and now - deaths[0] > self._crash_window_s:
            deaths.pop(0)
        code = getattr(proc, "returncode", None)
        if len(deaths) >= self._crash_limit:
            self._crash_looped[slot] = True
            exc = CrashLoopError(slot, len(deaths),
                                 self._crash_window_s)
            _prof.bump_router("crash_loop_opens")
            _tele.record_error(exc, kind="crash_loop", slot=slot,
                               restarts=len(deaths),
                               window_s=self._crash_window_s,
                               exit_code=code)
            return
        k = len(deaths) - 1  # recent-window deaths drive the exponent
        delay = min(self._backoff_max_s,
                    self._backoff_base_s * (2.0 ** k)) \
            * (0.5 + self._rng.random())
        _tele.event("supervisor.restart", slot=slot, exit_code=code,
                    backoff_s=round(delay, 4), recent_deaths=len(deaths))
        self._sleep(delay)
        if not self._running and self._thread is not None:
            return  # shut down while backing off
        self._spawn_slot(slot)
        _prof.bump_router("replica_restarts")

    def stop(self, kill: bool = True) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if kill:
            for proc in self._procs:
                if proc is None:
                    continue
                try:
                    if proc.poll() is None:
                        proc.kill()
                except Exception:
                    pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# replica process entry point
# ---------------------------------------------------------------------------

def _drain_pipe(pipe) -> None:
    """Keep reading a child's merged stdout so it never blocks on a
    full pipe after the READY line (its logs still flow somewhere)."""
    try:
        for _ in pipe:
            pass
    except (OSError, ValueError):
        pass


def spawn_replica_process(blob_path: str, host: str = "127.0.0.1",
                          port: int = 0,
                          version: Optional[str] = None,
                          ready_timeout: float = 120.0,
                          env: Optional[Dict[str, str]] = None,
                          gen_blob: Optional[str] = None,
                          ctx: Optional[str] = None):
    """Launch one replica as a real OS process serving ``blob_path``
    and block until it prints its ``REPLICA-READY host port`` line.
    Returns ``(proc, (host, port))`` -- the shape
    :class:`ReplicaSupervisor`'s ``spawn`` contract wants, e.g.
    ``spawn=lambda slot: spawn_replica_process(blob, version="v1")``.
    ``gen_blob`` attaches a decode lane (a `generation` decode blob)
    beside the infer ladder.  The replica serves on the card unless
    ``ctx="cpu"``; the ladder and the decode arena come from the
    ``MXTPU_SERVE_*`` / ``MXTPU_GEN_*`` knobs of ``env``.
    """
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.serving_fleet",
           "--replica", "--blob", str(blob_path), "--host", host,
           "--port", str(port)]
    if version is not None:
        cmd += ["--version", str(version)]
    if gen_blob is not None:
        cmd += ["--gen-blob", str(gen_blob)]
    if ctx is not None:
        cmd += ["--ctx", str(ctx)]
    full_env = dict(os.environ)
    # the replica imports this very package, wherever the caller runs
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    full_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in full_env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if env:
        full_env.update(env)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=full_env)
    t_end = time.monotonic() + float(ready_timeout)
    addr = None
    tail: List[str] = []
    while time.monotonic() < t_end:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise MXNetError(
                    f"replica died during startup "
                    f"(exit {proc.returncode}): {''.join(tail[-5:])}")
            time.sleep(0.05)
            continue
        if line.startswith("REPLICA-READY "):
            _, h, p = line.split()
            addr = (h, int(p))
            break
        tail.append(line)
    if addr is None:
        proc.kill()
        raise MXNetError(
            f"replica did not report ready within {ready_timeout:.0f}s")
    threading.Thread(target=_drain_pipe, args=(proc.stdout,),
                     daemon=True).start()
    return proc, addr


def _replica_main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving_fleet",
        description="run one serving replica over an export_compiled "
                    "blob (the process the Router load-balances)")
    p.add_argument("--replica", action="store_true",
                   help="required guard: this entry point only runs "
                        "replicas")
    p.add_argument("--blob", required=True,
                   help="export_compiled blob to serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--version", default=None,
                   help="model version name reported in stats")
    p.add_argument("--gen-blob", default=None,
                   help="optional generation decode blob: attaches "
                        "a continuous-batching decode lane answering "
                        "the 'generate' op beside the infer ladder")
    p.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu",
                   help="device the replica serves on: the card "
                        "(gpu(0), the default; raises without one) or "
                        "the CPU")
    args = p.parse_args(argv)
    if not args.replica:
        p.error("pass --replica (this entry point only runs replicas)")
    ctx = cpu() if args.ctx == "cpu" else default_context("replica")
    pool = CompiledModelPool(args.blob, devices=[ctx])
    decode = None
    if args.gen_blob:
        from .generation import (DecodeEngine, DecodeService,
                                 load_decode_blob)
        decode = DecodeService(DecodeEngine(load_decode_blob(
            args.gen_blob, ctx=ctx)))
    server = ModelServer(pool, model_version=args.version,
                         decode=decode)
    host, port = server.serve(args.host, args.port)
    print(f"REPLICA-READY {host} {port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(_replica_main())
