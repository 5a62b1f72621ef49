"""Elastic-mesh health plane: survive the loss of a rank inside the
sharded SPMD step (the counterpart of `mxnet_tpu/parallel/elastic_mesh.py`).

A mesh here is a grid of `torch.distributed` ranks, one process each
(`mesh.py`), so a lost mesh member is a rank whose process died or
stopped answering, and the mesh shrinks over the survivors.

* **Bounded detection** -- before every sharded step each member arrives
  at the probe (a key of the group's c10d store), then runs the sentinel,
  a one-element sum over the mesh's dp line on a process group of its own
  (never the step's), on a watchdog thread bounded by
  ``MXTPU_MESH_STEP_TIMEOUT_S``.  A sentinel that fails or misses the
  bound runs the census: a roll call over the probe's arrival keys with
  its own bound.  A member that never arrived is ``lost``; a structured
  `MeshDegradedError` names it, with a ``mesh_degraded`` flight-recorder
  event.  A census that finds everyone gives the sentinel one extension
  before an unattributed ``mesh_wedged``.  The probe runs before the step
  mutates anything, so the failed attempt applies nothing and the same
  batch retries on the survivors.
* **Real injection** -- `FaultPlan.kill_device_at` / ``hang_device_at``
  fire at exact 1-based SPMD steps (:meth:`FaultPlan.mesh_step_event`).
  The victim is the mesh's last rank (n-1), as in the JAX package: it
  waits for the others to arrive at the probe (so they have finished the
  previous step), then a kill ends its process with `KILLED_EXIT_CODE`
  and a hang stops it (``SIGSTOP``).  The survivors see a real loss.  A
  mesh of one has no survivor to see it, so there the loss surfaces at
  once as the JAX package's does.
* **Recovery policy** -- `train_driver.TrainingSupervisor.
  on_mesh_degraded` applies ``MXTPU_MESH_ON_LOSS``: ``shrink`` recovers
  the lost ZeRO-1 shard (the buddy copy under
  ``MXTPU_SPMD_SHARD_REDUNDANCY``, else the ``latest_valid()``
  checkpoint), bans the lost ranks and rebuilds the step over the n'
  survivors; ``preempt`` takes the bounded-checkpoint exit-75 path.

The census's reason: a lost rank whose process is gone (or a zombie) on
this host was ``device_killed``; one that is alive but silent, or on
another host, ``device_hang``.

Rank 0 holds the group's store, so losing it loses the roll call and the
group: the victim of an injected loss is never rank 0 unless the mesh is
rank 0 alone.  A probe thread that a dead peer left inside a collective
cannot be cancelled: the old groups are abandoned, never destroyed, and
the survivors' mesh forms fresh sub-groups.

``MXTPU_MESH_ELASTIC=0`` is the kill switch: no probe, the fault plan
never consulted, the step as before.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, List, Optional

import torch

from .. import config
from ..base import MXNetError

__all__ = ["elastic_enabled", "step_timeout_s", "on_loss_policy",
           "shard_redundancy_enabled", "MeshDegradedError",
           "MeshHealthMonitor", "monitor_for", "shrink_count",
           "note_shrunk", "ban_device", "banned_ids", "reset_state",
           "KILLED_EXIT_CODE", "CENSUS_TIMEOUT_S"]

#: the exit code of a rank that `FaultPlan.kill_device_at` killed
KILLED_EXIT_CODE = 86
#: the census's bound on every member's answer, as the JAX package's
#: per-device roll call
CENSUS_TIMEOUT_S = 2.0
#: how long an injected victim waits for the others to reach the probe
_VICTIM_WAIT_S = 120.0


def elastic_enabled() -> bool:
    """``MXTPU_MESH_ELASTIC`` (default on; 0 is the kill switch)."""
    return bool(config.get_env("MXTPU_MESH_ELASTIC"))


def step_timeout_s() -> float:
    """The watchdog bound on the per-step sentinel."""
    return float(config.get_env("MXTPU_MESH_STEP_TIMEOUT_S"))


def on_loss_policy() -> str:
    """``shrink`` (rebuild over the survivors, continue) or ``preempt``
    (bounded checkpoint, exit 75).  Unknown values mean shrink."""
    v = str(config.get_env("MXTPU_MESH_ON_LOSS")).strip().lower()
    return "preempt" if v == "preempt" else "shrink"


def shard_redundancy_enabled() -> bool:
    """``MXTPU_SPMD_SHARD_REDUNDANCY`` (default off): each rank keeps its
    ring successor's ZeRO-1 state shard, 1/N -> 2/N."""
    return bool(config.get_env("MXTPU_SPMD_SHARD_REDUNDANCY"))


class MeshDegradedError(MXNetError):
    """A mesh member died or stopped answering inside the SPMD step window.

    Raised by the probe before the step mutates anything.  ``census`` maps
    every mesh position to ``"ok"``/``"lost"``; ``lost`` is the sorted
    list of lost positions (empty when the census could not attribute the
    wedge: only the preempt policy can handle that); ``lost_device_ids``
    are their ranks in the group, which survive a rebuild."""

    def __init__(self, lost: List[int], mesh_size: int, reason: str,
                 census: Optional[Dict[int, str]] = None,
                 step: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 lost_device_ids: Optional[List[int]] = None):
        self.lost = sorted(int(r) for r in lost)
        self.mesh_size = int(mesh_size)
        self.reason = str(reason)
        self.census = dict(census or {})
        self.step = step
        self.timeout_s = timeout_s
        self.lost_device_ids = [int(i) for i in (lost_device_ids or [])]
        who = (",".join(str(r) for r in self.lost)
               if self.lost else "unattributed")
        super().__init__(
            f"mesh degraded ({reason}) at step {step}: lost device "
            f"rank(s) [{who}] of {mesh_size} "
            f"(timeout {timeout_s}s, census {self.census})")


# the process's record of shrinks (the degraded_steps counter) and of the
# banned ranks, which `spmd_step.resolve_mesh` never adopts again; a mesh
# heals only by a process restart
_STATE: Dict[str, object] = {"shrinks": 0, "banned": set()}


def note_shrunk() -> None:
    """Record one completed supervisor-driven shrink."""
    _STATE["shrinks"] += 1


def shrink_count() -> int:
    return _STATE["shrinks"]


def ban_device(device_id: int) -> None:
    """Exclude a rank of the group from every later mesh resolution."""
    _STATE["banned"].add(int(device_id))


def banned_ids() -> frozenset:
    return frozenset(_STATE["banned"])


def reset_state() -> None:
    """Forget the shrinks and bans (a fresh process's view)."""
    _STATE["shrinks"] = 0
    _STATE["banned"] = set()


_STORES: Dict[str, object] = {}


def _store(fresh: bool = False):
    """A client of the group's c10d store of its own (a connection that a
    call blocked on a lost rank elsewhere cannot hold up), or None without
    a group.  ``fresh`` makes a new one; otherwise the roll call's client,
    made once."""
    import torch.distributed as tdist
    if not (tdist.is_available() and tdist.is_initialized()):
        return None
    if not fresh and "roll" in _STORES:
        return _STORES["roll"]
    from torch.distributed.distributed_c10d import _get_default_store
    client = _get_default_store().clone()
    if not fresh:
        _STORES["roll"] = client
    return client


def _process_state(pid: int) -> Optional[str]:
    """The state letter of a process of this host (``Z`` zombie, ``T``
    stopped, ...), or None when it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return None


class MeshHealthMonitor:
    """The probe of one mesh: arrival keys, the sentinel on a watchdog
    thread, the census.  One per set of ranks (:func:`monitor_for`);
    every member probes the same number of times, so the probe index
    names the same step on each."""

    def __init__(self, mesh):
        from .mesh import device_ids
        self._mesh = mesh
        self.n = int(mesh.size)
        self._ids = tuple(device_ids(mesh))
        self._key = "mxtpu_mesh/" + "-".join(str(i) for i in self._ids)
        self._probes = 0
        self._group = None
        self._lock = threading.Lock()
        self._registered = False

    @property
    def position(self) -> int:
        """This rank's position in the mesh."""
        from . import distributed as _dist
        return self._ids.index(_dist.rank()) if self.n > 1 else 0

    # -- the roll call -----------------------------------------------------
    def _register(self, store) -> None:
        """Publish this member's host and pid once, for the census's
        reason."""
        if self._registered or store is None:
            return
        import socket
        store.set(f"{self._key}/pid/{self.position}",
                  f"{socket.gethostname()} {os.getpid()}")
        self._registered = True

    def _arrive(self, store, probe: int) -> None:
        if store is not None:
            store.set(f"{self._key}/{probe}/{self.position}", "1")

    def _arrived(self, store, probe: int, pos: int) -> bool:
        return bool(store.check([f"{self._key}/{probe}/{pos}"]))

    def _wait_others(self, store, probe: int) -> None:
        """An injected victim waits, bounded, until every other member has
        arrived at this probe (so they finished the previous step)."""
        deadline = time.monotonic() + _VICTIM_WAIT_S
        others = [p for p in range(self.n) if p != self.position]
        while time.monotonic() < deadline:
            if all(self._arrived(store, probe, p) for p in others):
                return
            time.sleep(0.01)

    def _census(self, store, probe: int,
                timeout_s: float = CENSUS_TIMEOUT_S) -> Dict[int, str]:
        """Each member that arrived at this probe within the bound is
        ``ok``; the others are ``lost``."""
        if store is None:
            return {0: "ok"}
        deadline = time.monotonic() + timeout_s
        pending = set(range(self.n))
        while pending:
            pending = {p for p in pending
                       if not self._arrived(store, probe, p)}
            if not pending or time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        return {p: ("lost" if p in pending else "ok") for p in range(self.n)}

    def _loss_reason(self, store, lost: List[int]) -> str:
        """``device_killed`` when a lost member's process on this host is
        gone or a zombie, else ``device_hang``."""
        import socket
        host = socket.gethostname()
        for p in lost:
            key = f"{self._key}/pid/{p}"
            try:
                if not store.check([key]):
                    continue
                h, pid = store.get(key).decode().split()
            except Exception:  # noqa: BLE001 -- the store's own error
                continue
            if h == host and _process_state(int(pid)) in (None, "Z", "X"):
                return "device_killed"
        return "device_hang"

    def _degrade(self, lost: List[int], reason: str,
                 census: Optional[Dict[int, str]] = None,
                 step: Optional[int] = None,
                 timeout: Optional[float] = None):
        from .. import profiler as _prof
        from .. import telemetry as _tele
        if census is None:
            census = {r: ("lost" if r in set(lost) else "ok")
                      for r in range(self.n)}
        _prof.bump_mesh("device_losses", max(1, len(lost)))
        exc = MeshDegradedError(
            lost, self.n, reason, census=census, step=step,
            timeout_s=timeout,
            lost_device_ids=[self._ids[r] for r in lost
                             if r < len(self._ids)])
        _tele.record_error(exc, kind="mesh_degraded", dump=False,
                           lost=list(exc.lost), mesh_size=self.n,
                           reason=reason, step=step, timeout_s=timeout,
                           census={str(k): v for k, v in census.items()})
        raise exc

    # -- the sentinel --------------------------------------------------------
    def _sentinel(self) -> None:
        """The one-element sum over the dp line, on a gloo group of its own
        (formed at the first probe by the members alone, over a store
        client of its own, never the step's group)."""
        import datetime
        import torch.distributed as tdist
        from . import distributed as _dist
        if self.n == 1:
            return
        if self._group is None:
            store = tdist.PrefixStore(f"{self._key}/sentinel", _store(True))
            self._group = tdist.ProcessGroupGloo(
                store, self.position, self.n,
                datetime.timedelta(seconds=_dist.DEFAULT_TIMEOUT_S))
        token = torch.ones(1)
        self._group.allreduce([token]).wait()
        if float(token.item()) != float(self.n):
            raise MXNetError(f"sentinel summed {float(token.item())} over "
                             f"{self.n} members")

    def check(self) -> None:
        """One pre-step health check: consult the fault plan's mesh
        events, arrive, then run the bounded sentinel.  Raises
        `MeshDegradedError` on a lost member (after the watchdog window
        for a stopped one, at once for a dead one) or an unattributed
        wedge."""
        from .. import fault_injection as _fi
        kill = hang = False
        step_idx = None
        plan = _fi.active()
        if plan is not None:
            step_idx = plan.mesh_step_event()
            kill = plan.on_kill_device is None and \
                step_idx in plan.kill_device_at
            hang = plan.on_hang_device is None and \
                step_idx in plan.hang_device_at
        timeout = step_timeout_s()
        if timeout <= 0 and not (kill or hang):
            return
        bound = timeout if timeout > 0 else 5.0
        victim = self.n - 1
        if (kill or hang) and self.n == 1:
            # no survivor to see it: the loss surfaces here
            self._degrade([victim], "device_killed" if kill
                          else "device_hang", step=step_idx, timeout=bound)
        with self._lock:
            self._probes += 1
            probe = self._probes
            store = _store()
            self._register(store)
            if (kill or hang) and self.position == victim:
                self._wait_others(store, probe)
                if kill:
                    os._exit(KILLED_EXIT_CODE)
                os.kill(os.getpid(), signal.SIGSTOP)
                os._exit(KILLED_EXIT_CODE)   # continued: still lost
            self._arrive(store, probe)
            done = threading.Event()
            errs: List[BaseException] = []

            def _probe():
                try:
                    self._sentinel()
                except Exception as exc:  # noqa: BLE001
                    errs.append(exc)
                done.set()

            th = threading.Thread(target=_probe, daemon=True,
                                  name="mxtpu-mesh-probe")
            th.start()
            if not done.wait(bound):
                census = self._census(store, probe)
                lost = [r for r, v in census.items() if v == "lost"]
                if lost:
                    self._degrade(lost, self._loss_reason(store, lost),
                                  census=census, step=step_idx,
                                  timeout=bound)
                # every member answered: a slow probe (the first group's
                # formation, host contention), not a lost one; extend the
                # watchdog once
                if not done.wait(bound):
                    self._degrade([], "mesh_wedged", census=census,
                                  step=step_idx, timeout=2 * bound)
            if errs:
                census = self._census(store, probe)
                lost = [r for r, v in census.items() if v == "lost"]
                reason = self._loss_reason(store, lost) if lost else \
                    f"sentinel_failed: {errs[0]}"
                self._degrade(lost, reason, census=census, step=step_idx,
                              timeout=bound)


_MONITORS: Dict[tuple, MeshHealthMonitor] = {}


def monitor_for(mesh) -> MeshHealthMonitor:
    """The cached health monitor of this set of ranks."""
    from .mesh import device_ids
    key = tuple(device_ids(mesh))
    mon = _MONITORS.get(key)
    if mon is None:
        mon = _MONITORS.setdefault(key, MeshHealthMonitor(mesh))
    return mon
