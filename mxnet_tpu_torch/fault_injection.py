"""Deterministic fault injection (the counterpart of
`mxnet_tpu/fault_injection.py`, copied whole: pure Python, the same
classes, spec syntax, counters and ``summary()`` keys).

A :class:`FaultPlan` is a seeded, counted schedule of faults that fire
at exact 1-based event indices (or through a seeded Bernoulli draw,
``drop_prob``), so the same plan driven by the same single-threaded
sequence replays the same interleaving every run.  Its event families
and their consumers in this package:

* **serving-fleet events** -- ``kill_replica_at`` / ``hang_replica_at``
  fire hooks at exact router-dispatch indices
  (:meth:`FaultPlan.router_dispatch_event`, consulted by
  `serving_fleet.Router` before each forwarded request) and
  ``corrupt_blob_on_deploy`` marks which deploys ship a bit-flipped
  artifact (:meth:`FaultPlan.deploy_event`);
* **autoscale events** -- ``traffic_spike_at`` fires ``on_traffic_spike``
  at exact autoscaler poll indices (:meth:`FaultPlan.
  autoscale_poll_event`) and ``kill_replica_during_scale`` fires
  ``on_kill_replica_during_scale`` at exact scale-action indices
  (:meth:`FaultPlan.scale_event`, after the fresh replica is spawned and
  before its warm-up completes), consulted by `autoscale.Autoscaler`;
* **parameter-server transport events** (drop, duplicate, delay,
  timeout, kill server, membership joins, drains and kill-rejoins:
  :meth:`FaultPlan.client_send_event` / :meth:`client_recv_event`),
  consulted by `ps_server.PSClient` around each data frame; a client
  takes the plan :func:`active` at its construction (an installed plan,
  else ``MXTPU_PS_FAULT_PLAN``);
* **training-driver events** (``preempt_at``, ``kill_worker_at``:
  :meth:`driver_step_event`), consumed by `train_driver.
  TrainingSupervisor` at each step boundary, and **mesh-device events**
  (``kill_device_at``, ``hang_device_at``: :meth:`mesh_step_event`),
  consumed by `parallel.elastic_mesh`'s probe before each sharded step:
  the mesh's last rank really exits or stops there;
* **poisoned steps** (``poison_step_at``: :meth:`poison_step_event`),
  the port's own: the unified training step (dense or sharded) consults
  the plan once per step and runs a poisoned one eagerly with NaN
  gradients, so ``MXTPU_ANOMALY_GUARD`` must skip it.  The JAX package's
  tests poison a batch with NaN inputs instead, which a model that looks
  its inputs up (BERT's token and position ids) never propagates.  Its
  count, ``poisoned_steps``, stays out of ``summary()``, which keeps the
  JAX package's keys.

:class:`FilePlan` is the same idea for the durable-checkpoint writer
(`serialization.atomic_write`): ``kill_before_rename`` raises
:class:`InjectedCrash` after the temporary file is written and synced
but before ``os.replace`` (the temporary file stays behind, as after a
real SIGKILL); ``fail_fsync`` makes the fsync raise ``OSError``;
``truncate_on_write`` / ``flip_on_write`` corrupt the committed file.
Install with :func:`install_file` / :func:`clear_file`, or across
process boundaries with ``MXTPU_CKPT_FAULT_PLAN="kill_before_rename=3"``
(same spec syntax).
"""
from __future__ import annotations

import os
import random
import socket
import threading
import time

# module-top, not call-time: file_active() runs on checkpoint side
# threads, where a function-level package import can deadlock on the
# import lock
from . import config
from typing import Callable, Dict, Optional, Sequence

__all__ = ["FaultPlan", "InjectedFault", "install", "clear", "active",
           "FilePlan", "InjectedCrash", "install_file", "clear_file",
           "file_active"]


class InjectedFault(ConnectionError):
    """A plan-scheduled connection drop (subclasses ConnectionError so
    a client's normal retry path handles it with no special casing)."""


class InjectedCrash(RuntimeError):
    """Simulated process death inside a checkpoint write.  NOT an
    ``MXNetError``: recovery code must never catch-and-continue past it —
    tests let it unwind the save exactly like a SIGKILL would."""


def _parse_val(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def _spec_kwargs(spec: str) -> Dict[str, object]:
    """Parse the ``"name=3,other=1+2"`` wire format shared by
    MXTPU_PS_FAULT_PLAN and MXTPU_CKPT_FAULT_PLAN."""
    kwargs: Dict[str, object] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        name = name.strip()
        if "+" in val:
            kwargs[name] = tuple(_parse_val(v) for v in val.split("+"))
        else:
            kwargs[name] = _parse_val(val.strip())
    return kwargs


class FaultPlan:
    """Seeded, deterministic schedule of transport faults.

    Parameters name the message index (1-based, per direction) a fault
    fires at: ``*_every=k`` fires at every kth message, ``*_at=(i, ...)``
    at exact indices, ``*_after=n`` once at index n.  ``drop_prob`` adds
    seeded random drops on both directions for chaos-style runs that are
    still replayable from the seed.
    """

    def __init__(self, seed: int = 0,
                 drop_send_after: Optional[int] = None,
                 drop_send_every: Optional[int] = None,
                 drop_recv_after: Optional[int] = None,
                 drop_recv_every: Optional[int] = None,
                 duplicate_every: Optional[int] = None,
                 duplicate_at: Sequence[int] = (),
                 delay_every: Optional[int] = None,
                 delay_at: Sequence[int] = (),
                 delay_s: float = 0.02,
                 timeout_at: Sequence[int] = (),
                 kill_server_at: Optional[int] = None,
                 on_kill: Optional[Callable[[], None]] = None,
                 join_at: Sequence[int] = (),
                 on_join: Optional[Callable[[], None]] = None,
                 drain_at: Sequence[int] = (),
                 on_drain: Optional[Callable[[], None]] = None,
                 kill_rejoin_at: Sequence[int] = (),
                 on_kill_rejoin: Optional[Callable[[], None]] = None,
                 kill_replica_at: Sequence[int] = (),
                 on_kill_replica: Optional[Callable[[int], None]] = None,
                 hang_replica_at: Sequence[int] = (),
                 on_hang_replica: Optional[Callable[[int], None]] = None,
                 corrupt_blob_on_deploy=None,
                 preempt_at: Sequence[int] = (),
                 on_preempt: Optional[Callable[[int], None]] = None,
                 kill_worker_at: Sequence[int] = (),
                 on_kill_worker: Optional[Callable[[int], None]] = None,
                 kill_device_at: Sequence[int] = (),
                 on_kill_device: Optional[Callable[[int], None]] = None,
                 hang_device_at: Sequence[int] = (),
                 on_hang_device: Optional[Callable[[int], None]] = None,
                 poison_step_at: Sequence[int] = (),
                 traffic_spike_at: Sequence[int] = (),
                 on_traffic_spike: Optional[Callable[[int], None]] = None,
                 kill_replica_during_scale: Sequence[int] = (),
                 on_kill_replica_during_scale:
                     Optional[Callable[[int], None]] = None,
                 drop_prob: float = 0.0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.drop_send_after = drop_send_after
        self.drop_send_every = drop_send_every
        self.drop_recv_after = drop_recv_after
        self.drop_recv_every = drop_recv_every
        self.duplicate_every = duplicate_every
        self.duplicate_at = frozenset(duplicate_at)
        self.delay_every = delay_every
        self.delay_at = frozenset(delay_at)
        self.delay_s = float(delay_s)
        self.timeout_at = frozenset(timeout_at)
        self.kill_server_at = kill_server_at
        self.on_kill = on_kill
        # elastic membership events (hooks run OUTSIDE the plan lock,
        # like on_kill — they talk to the server themselves)
        self.join_at = _as_indices(join_at)
        self.on_join = on_join
        self.drain_at = _as_indices(drain_at)
        self.on_drain = on_drain
        self.kill_rejoin_at = _as_indices(kill_rejoin_at)
        self.on_kill_rejoin = on_kill_rejoin
        # serving-fleet chaos events: fired by the Router at
        # exact 1-based router-dispatch / deploy indices, so a replica
        # SIGKILL mid-rolling-deploy replays at the same request every
        # run.  Hooks take the firing index (which replica to kill is
        # the test's business) and run OUTSIDE the plan lock.
        self.kill_replica_at = _as_indices(kill_replica_at)
        self.on_kill_replica = on_kill_replica
        self.hang_replica_at = _as_indices(hang_replica_at)
        self.on_hang_replica = on_hang_replica
        self.corrupt_blob_on_deploy = _as_indices(corrupt_blob_on_deploy)
        # training-driver chaos events: fired by the
        # TrainingSupervisor at exact 1-based step-boundary indices, so
        # "preempted at step 3" / "worker SIGKILLed at step 5" replay
        # identically every run.  Hooks take the firing index and run
        # OUTSIDE the plan lock (they deliver signals / kill processes
        # themselves; absent a hook the driver's defaults apply).
        self.preempt_at = _as_indices(preempt_at)
        self.on_preempt = on_preempt
        self.poison_step_at = _as_indices(poison_step_at)
        self.train_steps = 0
        self.poisoned_steps = 0
        self.kill_worker_at = _as_indices(kill_worker_at)
        self.on_kill_worker = on_kill_worker
        # elastic-mesh chaos events: fired by the mesh health
        # probe at exact 1-based SPMD step indices BEFORE the dispatch,
        # so "device lost at step 3" replays identically every run and
        # the failed attempt never mutates params/optimizer state.
        # Hooks take the firing index and run OUTSIDE the plan lock;
        # absent a hook the probe applies its defaults (kill = immediate
        # MeshDegradedError, hang = sentinel thread parked forever, the
        # watchdog timeout detects it).
        self.kill_device_at = _as_indices(kill_device_at)
        self.on_kill_device = on_kill_device
        self.hang_device_at = _as_indices(hang_device_at)
        self.on_hang_device = on_hang_device
        # autoscale chaos events: ``traffic_spike_at`` fires
        # at exact 1-based autoscaler poll indices (the spike hook
        # ramps offered load itself); ``kill_replica_during_scale``
        # fires at exact 1-based scale-action indices, DURING the
        # action — after the fresh replica process is spawned, before
        # its warm-up completes (the SIGKILL-mid-scale-up window).
        # Hooks take the firing index and run OUTSIDE the plan lock.
        self.traffic_spike_at = _as_indices(traffic_spike_at)
        self.on_traffic_spike = on_traffic_spike
        self.kill_replica_during_scale = _as_indices(
            kill_replica_during_scale)
        self.on_kill_replica_during_scale = on_kill_replica_during_scale
        self.drop_prob = float(drop_prob)
        self.sends = 0
        self.recvs = 0
        self.router_dispatches = 0
        self.deploys = 0
        self.driver_steps = 0
        self.mesh_steps = 0
        self.autoscale_polls = 0
        self.scale_actions = 0
        # what actually fired, for assertions and failure logs
        self.injected: Dict[str, int] = {
            "send_drops": 0, "recv_drops": 0, "duplicates": 0,
            "delays": 0, "timeouts": 0, "server_kills": 0,
            "joins": 0, "drains": 0, "kill_rejoins": 0,
            "replica_kills": 0, "replica_hangs": 0,
            "blob_corruptions": 0, "preempts": 0, "worker_kills": 0,
            "device_kills": 0, "device_hangs": 0,
            "traffic_spikes": 0, "scale_kills": 0}

    # -- client-side hooks (called by PSClient around each data frame) ---
    def client_send_event(self) -> int:
        """Consulted before a request frame goes out.  Returns the number
        of copies to send (2 = duplicate delivery); raises InjectedFault
        to model a dropped connection; may run the kill-server hook."""
        with self._lock:
            self.sends += 1
            n = self.sends
            kill = (self.kill_server_at is not None
                    and n == self.kill_server_at)
            drop = (self.drop_send_after == n
                    or (self.drop_send_every
                        and n % self.drop_send_every == 0)
                    or (self.drop_prob
                        and self._rng.random() < self.drop_prob))
            dup = (n in self.duplicate_at
                   or (self.duplicate_every
                       and n % self.duplicate_every == 0))
        if kill:
            self.injected["server_kills"] += 1
            if self.on_kill is not None:
                self.on_kill()
        if n in self.join_at:
            self.injected["joins"] += 1
            if self.on_join is not None:
                self.on_join()
        if n in self.drain_at:
            self.injected["drains"] += 1
            if self.on_drain is not None:
                self.on_drain()
        if n in self.kill_rejoin_at:
            self.injected["kill_rejoins"] += 1
            if self.on_kill_rejoin is not None:
                self.on_kill_rejoin()
        if drop:
            self.injected["send_drops"] += 1
            raise InjectedFault(f"injected connection drop before send #{n}")
        if dup:
            self.injected["duplicates"] += 1
            return 2
        return 1

    def client_recv_event(self) -> None:
        """Consulted before a reply frame is read.  A drop here models a
        reply lost AFTER the server applied the op — the retry must hit
        the server's dedup window, not re-apply."""
        with self._lock:
            self.recvs += 1
            n = self.recvs
            drop = (self.drop_recv_after == n
                    or (self.drop_recv_every
                        and n % self.drop_recv_every == 0)
                    or (self.drop_prob
                        and self._rng.random() < self.drop_prob))
            delay = (n in self.delay_at
                     or (self.delay_every and n % self.delay_every == 0))
            tmo = n in self.timeout_at
        if delay:
            self.injected["delays"] += 1
            time.sleep(self.delay_s)
        if tmo:
            self.injected["timeouts"] += 1
            raise socket.timeout(f"injected recv timeout at recv #{n}")
        if drop:
            self.injected["recv_drops"] += 1
            raise InjectedFault(f"injected reply loss before recv #{n}")

    # -- router-side hooks (called by serving_fleet.Router) --------------
    def router_dispatch_event(self) -> int:
        """Consulted by the Router before each forwarded infer.  Fires
        the replica-kill / replica-hang hooks when the 1-based dispatch
        index matches the plan; hooks run outside the lock (they
        SIGKILL or SIGSTOP replica processes themselves).  Returns the
        dispatch index."""
        with self._lock:
            self.router_dispatches += 1
            n = self.router_dispatches
        if n in self.kill_replica_at:
            self.injected["replica_kills"] += 1
            if self.on_kill_replica is not None:
                self.on_kill_replica(n)
        if n in self.hang_replica_at:
            self.injected["replica_hangs"] += 1
            if self.on_hang_replica is not None:
                self.on_hang_replica(n)
        return n

    def deploy_event(self) -> bool:
        """Consulted once per Router.deploy.  True means THIS deploy's
        blob must be corrupted in transit (the router copies the blob
        and flips a byte before shipping it, so the replica-side CRC
        footer / canary rejects it — the bad-deploy chaos case)."""
        with self._lock:
            self.deploys += 1
            n = self.deploys
            corrupt = n in self.corrupt_blob_on_deploy
        if corrupt:
            self.injected["blob_corruptions"] += 1
        return corrupt

    # -- driver-side hooks (called by train_driver at step boundaries) ---
    def driver_step_event(self) -> int:
        """Consulted by the training driver once per completed step.
        Fires the preempt / kill-worker hooks when the 1-based step
        index matches the plan; hooks run outside the lock (they
        deliver SIGTERM / SIGKILL themselves).  Returns the index."""
        with self._lock:
            self.driver_steps += 1
            n = self.driver_steps
        if n in self.preempt_at:
            self.injected["preempts"] += 1
            if self.on_preempt is not None:
                self.on_preempt(n)
        if n in self.kill_worker_at:
            self.injected["worker_kills"] += 1
            if self.on_kill_worker is not None:
                self.on_kill_worker(n)
        return n

    def poison_step_event(self) -> bool:
        """Consulted by the unified training step once per step, before
        it runs: True when the 1-based step index is one to poison."""
        with self._lock:
            self.train_steps += 1
            hit = self.train_steps in self.poison_step_at
            self.poisoned_steps += int(hit)
        return hit

    # -- mesh-side hooks (called by the elastic-mesh health probe) -------
    def mesh_step_event(self) -> int:
        """Consulted by the mesh health probe once per SPMD step, BEFORE
        the one-program dispatch (so an injected loss never half-applies
        a step).  Fires the device-kill / device-hang hooks when the
        1-based step index matches the plan; hooks run outside the lock.
        Returns the index — the probe applies its defaults (immediate
        degradation / parked sentinel thread) when the hooks are None."""
        with self._lock:
            self.mesh_steps += 1
            n = self.mesh_steps
        if n in self.kill_device_at:
            self.injected["device_kills"] += 1
            if self.on_kill_device is not None:
                self.on_kill_device(n)
        if n in self.hang_device_at:
            self.injected["device_hangs"] += 1
            if self.on_hang_device is not None:
                self.on_hang_device(n)
        return n

    # -- autoscaler hooks (called by autoscale.Autoscaler) ---------------
    def autoscale_poll_event(self) -> int:
        """Consulted by the Autoscaler once per control-loop poll.
        Fires the traffic-spike hook when the 1-based poll index matches
        the plan (the hook ramps offered load itself); runs outside the
        lock.  Returns the poll index."""
        with self._lock:
            self.autoscale_polls += 1
            n = self.autoscale_polls
        if n in self.traffic_spike_at:
            self.injected["traffic_spikes"] += 1
            if self.on_traffic_spike is not None:
                self.on_traffic_spike(n)
        return n

    def scale_event(self) -> int:
        """Consulted by the Autoscaler once per scale action (up or
        down), after a scale-up has spawned the fresh replica process
        but before its warm-up completes — so the kill hook lands in
        the SIGKILL-mid-scale-up window every run.  Hooks run outside
        the lock (they kill the process themselves).  Returns the
        1-based scale-action index."""
        with self._lock:
            self.scale_actions += 1
            n = self.scale_actions
        if n in self.kill_replica_during_scale:
            self.injected["scale_kills"] += 1
            if self.on_kill_replica_during_scale is not None:
                self.on_kill_replica_during_scale(n)
        return n

    def summary(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.injected)
            out["sends"] = self.sends
            out["recvs"] = self.recvs
            out["router_dispatches"] = self.router_dispatches
            out["deploys"] = self.deploys
            out["driver_steps"] = self.driver_steps
            out["mesh_steps"] = self.mesh_steps
            out["autoscale_polls"] = self.autoscale_polls
            out["scale_actions"] = self.scale_actions
            return out

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse ``"seed=7,duplicate_every=3,drop_recv_every=5"`` (the
        MXTPU_PS_FAULT_PLAN wire format; list-valued params take
        ``name=3+7+11``)."""
        return cls(**_spec_kwargs(spec))


def _as_indices(v) -> frozenset:
    """Normalize an index spec (None | int | iterable of int) to the set
    of 1-based write indices a file fault fires at."""
    if v is None:
        return frozenset()
    if isinstance(v, int):
        return frozenset((v,))
    return frozenset(int(x) for x in v)


class FilePlan:
    """Seeded, deterministic schedule of checkpoint-write faults.

    Every fault names the 1-based index of the :func:`~mxnet_tpu_torch.
    serialization.atomic_write` call it fires at (int or ``a+b+c``
    tuple).  ``truncate_at``/``flip_at`` give the byte offset the
    post-commit corruption applies at; omitted, the offset is derived
    deterministically from ``seed`` and the file size.
    """

    def __init__(self, seed: int = 0,
                 kill_before_rename=None,
                 fail_fsync=None,
                 truncate_on_write=None, truncate_at: Optional[int] = None,
                 flip_on_write=None, flip_at: Optional[int] = None):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.kill_before_rename = _as_indices(kill_before_rename)
        self.fail_fsync = _as_indices(fail_fsync)
        self.truncate_on_write = _as_indices(truncate_on_write)
        self.truncate_at = truncate_at
        self.flip_on_write = _as_indices(flip_on_write)
        self.flip_at = flip_at
        self.writes = 0
        self.injected: Dict[str, int] = {
            "kills": 0, "fsync_fails": 0, "truncates": 0, "flips": 0}

    # -- hooks called by serialization.atomic_write ----------------------
    def write_begin(self, fname: str) -> int:
        """A new atomic write is starting; returns its 1-based index."""
        with self._lock:
            self.writes += 1
            return self.writes

    def on_fsync(self, n: int) -> None:
        if n in self.fail_fsync:
            self.injected["fsync_fails"] += 1
            raise OSError(f"injected fsync failure on checkpoint write #{n}")

    def on_pre_rename(self, n: int) -> None:
        """Between tmp-write and os.replace: the SIGKILL window.  The tmp
        file stays behind (as after a real death); the destination is
        untouched."""
        if n in self.kill_before_rename:
            self.injected["kills"] += 1
            raise InjectedCrash(
                f"injected crash between tmp-write and rename on "
                f"checkpoint write #{n}")

    def on_committed(self, n: int, fname: str) -> None:
        """After a successful commit: torn-write / bit-rot corruption of
        the now-visible file (what a legacy in-place writer's crash, or
        later media decay, leaves on disk)."""
        if n in self.truncate_on_write:
            size = os.path.getsize(fname)
            k = self.truncate_at
            if k is None:
                k = self._rng.randrange(max(1, size))
            with open(fname, "r+b") as f:
                f.truncate(min(int(k), size))
            self.injected["truncates"] += 1
        if n in self.flip_on_write:
            size = os.path.getsize(fname)
            k = self.flip_at
            if k is None:
                k = self._rng.randrange(max(1, size))
            k = min(int(k), size - 1)
            with open(fname, "r+b") as f:
                f.seek(k)
                b = f.read(1)
                f.seek(k)
                f.write(bytes((b[0] ^ 0xFF,)))
            self.injected["flips"] += 1

    def summary(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.injected)
            out["writes"] = self.writes
            return out

    @classmethod
    def from_spec(cls, spec: str) -> "FilePlan":
        """Parse the MXTPU_CKPT_FAULT_PLAN wire format, e.g.
        ``"kill_before_rename=3"`` or ``"truncate_on_write=2,
        truncate_at=100"``."""
        return cls(**_spec_kwargs(spec))


_ACTIVE: Optional[FaultPlan] = None
_ENV_PLANS: Dict[str, FaultPlan] = {}


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Make `plan` the active plan for PSClients created from now on."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    """The plan new PSClients should capture: the installed one, else a
    per-spec cached parse of MXTPU_PS_FAULT_PLAN, else None."""
    if _ACTIVE is not None:
        return _ACTIVE
    spec = config.get_env("MXTPU_PS_FAULT_PLAN")
    if not spec:
        return None
    plan = _ENV_PLANS.get(spec)
    if plan is None:
        plan = _ENV_PLANS.setdefault(spec, FaultPlan.from_spec(spec))
    return plan


_FILE_ACTIVE: Optional[FilePlan] = None
_FILE_ENV_PLANS: Dict[str, FilePlan] = {}


def install_file(plan: Optional[FilePlan]) -> Optional[FilePlan]:
    """Make `plan` the active file plan consulted by every
    serialization.atomic_write from now on."""
    global _FILE_ACTIVE
    _FILE_ACTIVE = plan
    return plan


def clear_file() -> None:
    install_file(None)


def file_active() -> Optional[FilePlan]:
    """The FilePlan atomic_write should consult: the installed one, else
    a per-spec cached parse of MXTPU_CKPT_FAULT_PLAN, else None."""
    if _FILE_ACTIVE is not None:
        return _FILE_ACTIVE
    spec = config.get_env("MXTPU_CKPT_FAULT_PLAN")
    if not spec:
        return None
    plan = _FILE_ENV_PLANS.get(spec)
    if plan is None:
        plan = _FILE_ENV_PLANS.setdefault(spec, FilePlan.from_spec(spec))
    return plan
