"""Self-scaling serving fleet: the autoscaler control loop and the
admission plane over `serving_fleet` (the counterpart of
`mxnet_tpu/autoscale.py`, host logic copied as it is).

A fixed fleet can only answer a traffic spike by shedding, and a quiet
fleet burns replicas it does not need.  The :class:`Autoscaler` closes
the loop on the metrics surface -- the per-replica queue depth and p99
the router's health prober already polls -- and resizes the fleet
through the existing machinery:

* **scale-up before the shed limit** -- mean queued rows per active
  replica at/above ``MXTPU_SERVE_SCALE_UP_QUEUE_ROWS`` (set well below
  ``MXTPU_SERVE_QUEUE_LIMIT``), or worst p99 at/above
  ``MXTPU_SERVE_SCALE_UP_P99_MS``, spawns one replica via
  :meth:`~mxnet_tpu_torch.serving_fleet.ReplicaSupervisor.add_slot`.  The
  fresh replica captures its ladder in its own process and sits in the
  router's "warming" state -- it takes ZERO traffic until a health probe
  passes; a replica that never passes within
  ``MXTPU_SERVE_WARMUP_TIMEOUT_S`` is retired, never admitted.
* **scale-down only after sustained idle** -- the fleet must stay at or
  below ``MXTPU_SERVE_SCALE_DOWN_QUEUE_ROWS`` (a separate, lower
  watermark) for ``MXTPU_SERVE_SCALE_IDLE_S`` before ONE replica is
  quiesced (drained of in-flight work) and retired; a retired slot is
  never respawned.
* **hysteresis everywhere** -- ``MXTPU_SERVE_SCALE_COOLDOWN_S`` spaces
  any two scale actions; ``MXTPU_SERVE_MIN_REPLICAS`` /
  ``MXTPU_SERVE_MAX_REPLICAS`` bound the fleet.
* **bounded brownout instead of thrashing** -- at max fleet and still
  saturated, the router enters declared degraded mode: low-priority
  requests shed first, deadline-overrun requests refused immediately,
  and every replica's micro-batch deadline is widened
  (`Router.enter_brownout`).  Recovery restores the base ladder exactly.

The polling interval is seeded-jittered +/-20 % (Python's ``random``, so
both packages draw the same intervals for one seed).  Chaos hooks ride
`fault_injection.FaultPlan`: ``traffic_spike_at`` fires at exact 1-based
poll indices, ``kill_replica_during_scale`` at exact scale-action
indices, inside the spawn-to-warm-up window.

Kill switch: ``MXTPU_SERVE_AUTOSCALE=0`` refuses Autoscaler
construction -- the fleet stays the size it was built with.  Forensics:
`profiler.autoscale_counters()` and the flight-recorder kinds
``scale_up`` / ``scale_down`` / ``brownout_enter`` / ``brownout_exit`` /
``warmup``.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Optional

from . import fault_injection as _fault
from . import profiler as _prof
from . import telemetry as _tele
from .base import MXNetError
from .config import get_env
from .serving_fleet import ReplicaSupervisor, Router

__all__ = ["autoscale_enabled", "Autoscaler"]


def autoscale_enabled() -> bool:
    """The autoscale kill switch: ``MXTPU_SERVE_AUTOSCALE=0`` refuses
    Autoscaler construction, freezing the fleet at its built size."""
    return bool(get_env("MXTPU_SERVE_AUTOSCALE"))


class Autoscaler:
    """Threshold/hysteresis/cooldown control loop resizing a
    :class:`~mxnet_tpu_torch.serving_fleet.Router` +
    :class:`~mxnet_tpu_torch.serving_fleet.ReplicaSupervisor` fleet; see the
    module docstring for the full contract.

    Every decision happens in :meth:`poll_once` (public, fake-clock
    testable: inject ``clock``/``sleep`` and drive it by hand).
    :meth:`start` runs it on a seeded-jittered interval thread.
    Invariant relied on throughout: router replica index == supervisor
    slot (both lists grow in lockstep through ``add_slot``).
    """

    def __init__(self, router: Router, supervisor: ReplicaSupervisor,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 up_queue_rows: Optional[int] = None,
                 up_p99_ms: Optional[float] = None,
                 down_queue_rows: Optional[int] = None,
                 idle_window_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 warmup_timeout_s: Optional[float] = None,
                 drain_wait_s: float = 2.0,
                 seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if not autoscale_enabled():
            raise MXNetError(
                "MXTPU_SERVE_AUTOSCALE=0: the autoscaler is switched "
                "off — the fleet keeps the fixed size it was built "
                "with")
        self._router = router
        self._sup = supervisor
        self.min_replicas = max(1, int(
            min_replicas if min_replicas is not None
            else get_env("MXTPU_SERVE_MIN_REPLICAS")))
        self.max_replicas = max(self.min_replicas, int(
            max_replicas if max_replicas is not None
            else get_env("MXTPU_SERVE_MAX_REPLICAS")))
        self.up_queue_rows = int(
            up_queue_rows if up_queue_rows is not None
            else get_env("MXTPU_SERVE_SCALE_UP_QUEUE_ROWS"))
        self.up_p99_ms = float(
            up_p99_ms if up_p99_ms is not None
            else get_env("MXTPU_SERVE_SCALE_UP_P99_MS"))
        self.down_queue_rows = int(
            down_queue_rows if down_queue_rows is not None
            else get_env("MXTPU_SERVE_SCALE_DOWN_QUEUE_ROWS"))
        self.idle_window_s = float(
            idle_window_s if idle_window_s is not None
            else get_env("MXTPU_SERVE_SCALE_IDLE_S"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else get_env("MXTPU_SERVE_SCALE_COOLDOWN_S"))
        self.interval_s = float(
            interval_s if interval_s is not None
            else get_env("MXTPU_SERVE_SCALE_INTERVAL_S"))
        self.warmup_timeout_s = float(
            warmup_timeout_s if warmup_timeout_s is not None
            else get_env("MXTPU_SERVE_WARMUP_TIMEOUT_S"))
        self._drain_wait_s = float(drain_wait_s)
        if self.down_queue_rows >= self.up_queue_rows:
            raise MXNetError(
                f"autoscaler hysteresis inverted: down watermark "
                f"{self.down_queue_rows} must be below the up "
                f"threshold {self.up_queue_rows}")
        self._clock = clock
        self._sleep = sleep
        self._rng = random.Random(int(seed))
        self._lock = threading.Lock()
        self._last_action_t: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._warming_since: Dict[int, float] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- census ----------------------------------------------------------

    def _census(self):
        active, warming = [], []
        for rep in self._router.replicas:
            if rep.state == "active":
                active.append(rep)
            elif rep.state == "warming":
                warming.append(rep)
        return active, warming

    def _pressure(self, active) -> Dict[str, float]:
        """The control signals, from the router's last stats polls:
        mean queued rows per active replica (router-side in-flight
        included — between polls it is the freshest load signal) and
        the worst per-replica p99.  Decode-slot saturation counts too:
        a generation request queued behind a full slot arena is load
        exactly like a queued infer row (``gen_queue`` folds into the
        queue signal; infer-only fleets report 0 and are unchanged),
        and mean arena occupancy rides along for observability."""
        if not active:
            return {"queue_rows": float("inf"), "p99_ms": float("inf"),
                    "gen_occupancy": 0.0}
        rows = sum(r.queue_rows + r.inflight
                   + getattr(r, "gen_queue", 0) for r in active)
        occ = [r.gen_active / r.gen_slots for r in active
               if getattr(r, "gen_slots", 0) > 0]
        return {"queue_rows": rows / len(active),
                "p99_ms": max(r.p99_ms for r in active),
                "gen_occupancy": (sum(occ) / len(occ)) if occ else 0.0}

    def _saturated(self, p: Dict[str, float]) -> bool:
        return (p["queue_rows"] >= self.up_queue_rows
                or (self.up_p99_ms > 0.0
                    and p["p99_ms"] >= self.up_p99_ms))

    def _idle(self, p: Dict[str, float]) -> bool:
        return (p["queue_rows"] <= self.down_queue_rows
                and not (self.up_p99_ms > 0.0
                         and p["p99_ms"] >= self.up_p99_ms))

    def _cooling(self, now: float) -> bool:
        return (self._last_action_t is not None
                and now - self._last_action_t < self.cooldown_s)

    # -- the control loop ------------------------------------------------

    def poll_once(self) -> str:
        """One control-loop decision; returns what it did ("hold",
        "cooldown", "scale_up", "scale_down", "brownout_enter",
        "brownout_exit", "warmup_wait").  Public so tests drive the
        whole state machine with a fake clock."""
        now = self._clock()
        plan = _fault.active()
        if plan is not None:
            plan.autoscale_poll_event()
        _prof.bump_autoscale("polls")
        self._manage_warmups(now)
        active, warming = self._census()
        p = self._pressure(active)
        fleet = len(active) + len(warming)
        at_max = fleet >= self.max_replicas
        saturated = self._saturated(p)
        # brownout transitions are declared on pressure, not cooldown:
        # degraded mode is an honest admission statement, not a scale
        # action to be rate-limited
        if at_max and saturated and not self._router.brownout:
            self._router.enter_brownout()  # emits kind=brownout_enter
            return "brownout_enter"
        if self._router.brownout and self._idle(p):
            self._router.exit_brownout()   # emits kind=brownout_exit
            return "brownout_exit"
        if saturated:
            self._idle_since = None
            if at_max:
                return "hold"  # brownout already declared above
            if self._cooling(now):
                _prof.bump_autoscale("cooldown_holds")
                return "cooldown"
            if warming:
                # capacity is already on the way: let it warm before
                # deciding the spike needs even more
                return "warmup_wait"
            self._scale_up(now, p)
            return "scale_up"
        if self._idle(p):
            if self._idle_since is None:
                self._idle_since = now
            if len(active) <= self.min_replicas or warming:
                return "hold"
            if now - self._idle_since < self.idle_window_s:
                return "hold"
            if self._cooling(now):
                _prof.bump_autoscale("cooldown_holds")
                return "cooldown"
            self._scale_down(now, active)
            return "scale_down"
        # between the watermarks: hysteresis dead band
        self._idle_since = None
        return "hold"

    def _manage_warmups(self, now: float) -> None:
        """Probe warming replicas (so warm-up never waits on the health
        thread) and retire any that outstayed the warm-up timeout —
        they never took traffic, so retirement is invisible."""
        _, warming = self._census()
        for rep in warming:
            self._warming_since.setdefault(rep.idx, now)
        self._router.probe_warming()
        for rep in warming:
            if rep.state != "warming":
                self._warming_since.pop(rep.idx, None)
                continue
            start = self._warming_since.get(rep.idx, now)
            if now - start >= self.warmup_timeout_s:
                self._warming_since.pop(rep.idx, None)
                self._sup.retire_slot(rep.idx)
                self._router.retire_replica(rep.idx)
                _prof.bump_autoscale("warmup_failures")
                _tele.record_error(
                    f"replica {rep.idx} failed warm-up within "
                    f"{self.warmup_timeout_s:.0f}s — retired without "
                    "ever taking traffic", kind="warmup_failure",
                    replica=rep.idx)
        for idx in list(self._warming_since):
            if idx >= len(self._router.replicas) \
                    or self._router.replicas[idx].state != "warming":
                self._warming_since.pop(idx, None)

    def _scale_up(self, now: float, p: Dict[str, float]) -> None:
        slot = self._sup.add_slot()
        self._warming_since[slot] = now
        self._last_action_t = now
        _prof.bump_autoscale("scale_ups")
        _tele.event("autoscale.scale_up", kind="scale_up", slot=slot,
                    queue_rows=round(p["queue_rows"], 2),
                    p99_ms=round(p["p99_ms"], 2))
        # the chaos window: the fresh replica process exists, warm-up
        # has not completed — a kill hook firing here is SIGKILL
        # mid-scale-up, and the supervisor + warm-up gate must absorb it
        plan = _fault.active()
        if plan is not None:
            plan.scale_event()

    def _scale_down(self, now: float, active) -> None:
        victim = max(active, key=lambda r: r.idx)
        self._router.quiesce_replica(victim.idx)
        t_end = now + self._drain_wait_s
        while victim.inflight > 0 and self._clock() < t_end:
            self._sleep(0.01)
        self._sup.retire_slot(victim.idx)
        self._router.retire_replica(victim.idx)
        self._last_action_t = self._clock()
        self._idle_since = None
        _prof.bump_autoscale("scale_downs")
        _tele.event("autoscale.scale_down", kind="scale_down",
                    slot=victim.idx)
        plan = _fault.active()
        if plan is not None:
            plan.scale_event()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._running = True
        t = threading.Thread(target=self._loop,
                             name="mxtpu-autoscaler", daemon=True)
        t.start()
        self._thread = t

    def _loop(self) -> None:
        while self._running:
            try:
                self.poll_once()
            except Exception as e:  # a flaky poll must not kill the loop
                _tele.record_error(e, kind="autoscale_poll_error")
            # seeded +/-20% jitter: never herd against stats endpoints
            self._sleep(self.interval_s
                        * (0.8 + 0.4 * self._rng.random()))

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- observability ---------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        active, warming = self._census()
        return {"active": len(active), "warming": len(warming),
                "min": self.min_replicas, "max": self.max_replicas,
                "brownout": self._router.brownout,
                "idle_since": self._idle_since,
                "last_action_t": self._last_action_t,
                "counters": _prof.autoscale_counters()}
