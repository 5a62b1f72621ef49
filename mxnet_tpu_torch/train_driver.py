"""Preemption-safe training supervisor (the counterpart of
`mxnet_tpu/train_driver.py`): the process-level robustness plane for long
training jobs.

The reference framework leaves job-level fault handling to external
schedulers (the dmlc tracker restarts dead roles; `ps-lite` heartbeats
detect them).  On shared clusters the dominant failure is *preemption*:
the scheduler SIGTERMs the job with a short grace window, and anything
not checkpointed is lost.  This module owns that story end to end:

* **Preemption safety** — `TrainingSupervisor.install_signal_handlers`
  turns SIGTERM (and optionally SIGINT, ``MXTPU_DRIVER_SIGINT``) into a
  *stop request* honored at the next step boundary: the training loop
  (`BaseModule.fit`) writes one bounded final checkpoint — mid-epoch,
  with the batch cursor recorded so the resume is bitwise — through
  `checkpoint.CheckpointManager` (commit-or-nothing: the MANIFEST is
  the commit point; ``MXTPU_PREEMPT_CKPT_TIMEOUT_S`` bounds the write),
  emits a structured ``preempted`` telemetry event and raises
  `TrainingPreempted`, which `main_guard()` converts into the distinct
  exit status `PREEMPTED_EXIT_CODE` (75, ``EX_TEMPFAIL``) so the outer
  scheduler can tell a clean preempt from a crash.  The handler CHAINS
  with telemetry's flight-recorder SIGTERM handler instead of
  clobbering it — one SIGTERM produces both the forensic dump and the
  checkpoint.

* **Worker supervision** — the same object can own a fleet of worker
  subprocesses (`spawn_workers` / `check_once` / `start`), mirroring
  the serving tier's `ReplicaSupervisor` discipline: crashed workers
  respawn under a FRESH identity (the spawn callable receives an
  attempt counter; a respawned worker rejoins through the elastic
  membership plane) after seeded jittered exponential backoff, deaths
  inside ``MXTPU_DRIVER_CRASH_WINDOW_S`` count toward the
  ``MXTPU_DRIVER_CRASH_LIMIT`` crash-loop breaker
  (`serving_fleet.CrashLoopError`), and a worker that exits with
  `PREEMPTED_EXIT_CODE` is recorded as cleanly preempted, never
  respawned.  An attached `parallel.failure.HeartbeatMonitor` feeds
  silent-death detection into the same path.

* **Numerical anomaly guard** — `AnomalyGuard` is the host-side half
  of ``MXTPU_ANOMALY_GUARD`` (the device-side finite check lives
  inside the unified step, dense or sharded, and *skips* the optimizer
  update of a non-finite step without an extra host sync): it counts
  consecutive skipped steps and raises `GradientAnomalyError` after
  ``MXTPU_ANOMALY_LIMIT``, with every skip recorded into the flight
  recorder as a ``grad_anomaly`` event.

* **Mesh loss** -- `TrainingSupervisor.on_mesh_degraded` applies
  ``MXTPU_MESH_ON_LOSS`` when the SPMD probe of `parallel.elastic_mesh`
  raised `MeshDegradedError` (a rank died or stopped answering): shrink
  over the survivors and retry the batch, or preempt.

``MXTPU_DRIVER=0`` is the kill switch: `activate()` refuses, signal
handlers never install, `current()` returns None and every existing
code path runs exactly as before.
"""
from __future__ import annotations

import json
import random
import signal
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

from .base import MXNetError
from .config import get_env

__all__ = ["PREEMPTED_EXIT_CODE", "driver_enabled", "current",
           "TrainingPreempted", "GradientAnomalyError", "AnomalyGuard",
           "TrainingSupervisor", "dump_counters"]

#: Exit status of a process that stopped for a preemption signal after
#: committing (or at least bounding) its final checkpoint — distinct
#: from 0 (done) and from crash codes so the outer scheduler can tell
#: "resume me" from "debug me".  75 is sysexits.h EX_TEMPFAIL.
PREEMPTED_EXIT_CODE = 75


def driver_enabled() -> bool:
    """MXTPU_DRIVER gate (default on; 0 is the kill switch)."""
    return bool(get_env("MXTPU_DRIVER"))


# the ambient supervisor `BaseModule.fit` consults; one per process
_CURRENT: Dict[str, Any] = {"sup": None}


def current() -> Optional["TrainingSupervisor"]:
    """The activated supervisor, or None (driver off / none attached)."""
    return _CURRENT["sup"]


def __getattr__(name):
    # re-export the serving tier's crash-loop breaker without paying
    # the serving_fleet import at module load
    if name == "CrashLoopError":
        from .serving_fleet import CrashLoopError
        return CrashLoopError
    raise AttributeError(name)


class TrainingPreempted(MXNetError):
    """Raised out of the training loop at the step boundary a
    preemption stop request was honored at; `main_guard()` maps it to
    `PREEMPTED_EXIT_CODE`."""

    def __init__(self, reason: str, epoch: Optional[int] = None,
                 batch: Optional[int] = None, committed: bool = False):
        self.reason = reason
        self.epoch = epoch
        self.batch = batch
        self.committed = bool(committed)
        where = f"epoch {epoch}" + ("" if batch is None
                                    else f" batch {batch}")
        super().__init__(
            f"training preempted ({reason}) at {where}; final checkpoint "
            f"{'committed' if committed else 'NOT committed'}")


class GradientAnomalyError(MXNetError):
    """MXTPU_ANOMALY_LIMIT consecutive steps produced a non-finite loss
    or gradient norm — the model is poisoned, not glitching; stopping
    beats silently skipping forever."""

    def __init__(self, skips: int, limit: int, epoch: Optional[int] = None,
                 batch: Optional[int] = None,
                 grad_norm: Optional[float] = None):
        self.skips = int(skips)
        self.limit = int(limit)
        self.epoch = epoch
        self.batch = batch
        self.grad_norm = grad_norm
        super().__init__(
            f"{skips} consecutive non-finite training steps (limit "
            f"{limit}) at epoch {epoch} batch {batch}; last grad norm "
            f"{grad_norm}")


def _take_step_verdict(module):
    """Consume the (ok, grad_norm) verdict the guarded fused/SPMD step
    left on the module's live step object.  Returns (None, None) when no
    guarded step ran this iteration (classic path).  Verdicts are
    consumed exactly once so a stale one from a path the module fell
    away from can never be re-read."""
    for attr in ("_spmd_train_step", "_fused_train_step"):
        st = getattr(module, attr, None)
        if st is None:
            continue
        ok = getattr(st, "last_step_ok", None)
        if ok is None:
            continue
        st.last_step_ok = None
        gn = getattr(st, "last_grad_norm", None)
        st.last_grad_norm = None
        if ok is True:  # guard off for this step: nothing to sync
            return True, None
        return bool(ok), gn
    return None, None


class AnomalyGuard:
    """Host-side escalation for the device-side anomaly guard: counts
    consecutive skipped (non-finite) steps, records each into the
    flight recorder, raises `GradientAnomalyError` past the limit."""

    def __init__(self, limit: Optional[int] = None, logger=None):
        self.limit = int(get_env("MXTPU_ANOMALY_LIMIT")
                         if limit is None else limit)
        self.logger = logger
        self.consecutive = 0
        self.total_skipped = 0

    @staticmethod
    def maybe(logger=None) -> Optional["AnomalyGuard"]:
        """An AnomalyGuard when MXTPU_ANOMALY_GUARD is on, else None."""
        from .unified_step import anomaly_guard_enabled
        return AnomalyGuard(logger=logger) if anomaly_guard_enabled() \
            else None

    def after_step(self, module, epoch: Optional[int] = None,
                   nbatch: Optional[int] = None) -> bool:
        """Called by fit after every training step.  True = step was
        applied; False = the device guard skipped it (params/optimizer
        untouched).  Raises `GradientAnomalyError` at the limit."""
        from . import profiler as _prof
        from . import telemetry as _tele
        ok, gnorm = _take_step_verdict(module)
        if ok is None or ok:
            self.consecutive = 0
            return True
        self.consecutive += 1
        self.total_skipped += 1
        _prof.bump_driver("anomaly_skipped_steps")
        gn = None if gnorm is None else float(gnorm)
        _tele.record_error(
            "non-finite loss/grad: optimizer update skipped",
            kind="grad_anomaly", dump=False, epoch=epoch, batch=nbatch,
            grad_norm=gn, consecutive=self.consecutive)
        if self.logger is not None:
            self.logger.warning(
                "anomaly guard: non-finite step skipped at epoch %s "
                "batch %s (%d consecutive, limit %d, grad_norm=%s)",
                epoch, nbatch, self.consecutive, self.limit, gn)
        if self.consecutive >= self.limit:
            _prof.bump_driver("anomaly_trips")
            exc = GradientAnomalyError(self.consecutive, self.limit,
                                       epoch=epoch, batch=nbatch,
                                       grad_norm=gn)
            _tele.record_error(exc, kind="grad_anomaly_limit")
            raise exc
        return False


class _Worker:
    """One supervised worker slot."""

    def __init__(self, slot: int):
        self.slot = slot
        self.proc = None
        self.attempt = 0
        self.deaths: List[float] = []
        self.finished = False       # exited 0
        self.preempted = False      # exited PREEMPTED_EXIT_CODE
        self.abandoned = False      # died during drain: never respawned
        self.exit_code: Optional[int] = None

    @property
    def live(self) -> bool:
        return self.proc is not None and not self.finished \
            and not self.preempted and not self.abandoned


class TrainingSupervisor:
    """Owns a training job end to end: preemption signals, the
    step-boundary stop protocol, and (optionally) a fleet of worker
    subprocesses with crash-loop-guarded respawn.

    The in-process half is consulted by `BaseModule.fit` through the
    ambient `current()` supervisor (`activate()` installs it; a
    no-op with MXTPU_DRIVER=0).  The parent half follows the serving
    tier's ReplicaSupervisor discipline: ``spawn(slot, attempt)``
    returns a Popen-like object; `check_once()` is public so tests
    drive detection deterministically; `clock`/`sleep` are injectable.
    """

    def __init__(self, spawn: Optional[Callable[[int, int], Any]] = None,
                 ckpt_timeout_s: Optional[float] = None,
                 backoff_base_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 crash_window_s: Optional[float] = None,
                 crash_limit: Optional[int] = None,
                 poll_interval_s: float = 0.2, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 logger=None):
        import logging
        self.logger = logger or logging.getLogger(__name__)
        self.ckpt_timeout_s = float(
            get_env("MXTPU_PREEMPT_CKPT_TIMEOUT_S")
            if ckpt_timeout_s is None else ckpt_timeout_s)
        self._backoff_base_s = float(
            get_env("MXTPU_DRIVER_BACKOFF_BASE_S")
            if backoff_base_s is None else backoff_base_s)
        self._backoff_max_s = float(
            get_env("MXTPU_DRIVER_BACKOFF_MAX_S")
            if backoff_max_s is None else backoff_max_s)
        self._crash_window_s = float(
            get_env("MXTPU_DRIVER_CRASH_WINDOW_S")
            if crash_window_s is None else crash_window_s)
        self._crash_limit = int(
            get_env("MXTPU_DRIVER_CRASH_LIMIT")
            if crash_limit is None else crash_limit)
        self._poll_interval_s = float(poll_interval_s)
        self._spawn = spawn
        self._clock = clock
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._stop_reason: Optional[str] = None
        self._workers: Dict[int, _Worker] = {}
        self._draining = False
        self._monitor_thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self.crash_loop: Optional[BaseException] = None
        self._prev_handlers: Dict[int, Any] = {}
        self._hb_monitor = None
        self._hb_rank_of: Callable[[int], int] = lambda slot: slot

    # -- lifecycle ------------------------------------------------------
    def activate(self) -> "TrainingSupervisor":
        """Install as the process-ambient supervisor `fit` consults.
        A no-op (returns self, `current()` stays None) with
        MXTPU_DRIVER=0 so the kill switch restores every path."""
        if driver_enabled():
            _CURRENT["sup"] = self
        return self

    def deactivate(self) -> None:
        if _CURRENT["sup"] is self:
            _CURRENT["sup"] = None

    def __enter__(self) -> "TrainingSupervisor":
        self.activate()
        self.install_signal_handlers()
        return self

    def __exit__(self, *exc) -> None:
        self.restore_signal_handlers()
        self.deactivate()
        self.stop_workers(kill=True)
        return None

    # -- preemption: signals and the step-boundary stop protocol --------
    def install_signal_handlers(self) -> bool:
        """Route SIGTERM (and SIGINT with MXTPU_DRIVER_SIGINT=1) into a
        step-boundary stop request.  Chains with telemetry's
        flight-recorder handler: if one was installed it still runs (as
        a dump-only link) on the same signal.  False when the driver is
        off or we are not in the main thread (signal module rule)."""
        if not driver_enabled():
            return False
        sigs = [signal.SIGTERM]
        if get_env("MXTPU_DRIVER_SIGINT"):
            sigs.append(signal.SIGINT)
        try:
            for sig in sigs:
                prev = signal.getsignal(sig)

                def _on_signal(signum, frame, _prev=prev):
                    self.request_stop(f"signal {signum}", signum=signum)
                    if callable(_prev) and getattr(
                            _prev, "_mxtpu_flight_recorder", False):
                        try:  # telemetry's handler: dump-only when
                            _prev(signum, frame)  # invoked as a link
                        except Exception:
                            pass

                # telemetry's install_crash_handlers respects this
                # marker and will not clobber us on a later re-install
                _on_signal._mxtpu_sigterm_chain = True
                signal.signal(sig, _on_signal)
                self._prev_handlers[sig] = prev
        except ValueError:  # not the main thread
            return False
        return True

    def restore_signal_handlers(self) -> None:
        for sig, prev in list(self._prev_handlers.items()):
            try:
                # mxtpu-lint: disable=signal-chain -- this IS the chain
                # restore: re-installing the handlers saved at install time
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers.clear()

    def request_stop(self, reason: str = "preempt",
                     signum: Optional[int] = None) -> None:
        """Ask the training loop to stop at the next step boundary."""
        from . import profiler as _prof
        from . import telemetry as _tele
        first = not self._stop.is_set()
        self._stop_reason = self._stop_reason or reason
        self._stop.set()
        if first:
            _prof.bump_driver("preempt_signals")
            _tele.event("driver.preempt_requested", reason=reason,
                        signum=signum)

    def stop_requested(self) -> bool:
        return self._stop.is_set()

    def on_step_end(self, module=None, ckpt_mgr=None,
                    epoch: Optional[int] = None,
                    nbatch: Optional[int] = None) -> None:
        """Step-boundary hook `fit` calls after every completed step
        (``nbatch`` = batches done this epoch).  Fires fault-plan driver
        events, then honors a pending stop request by writing the
        bounded final checkpoint and raising `TrainingPreempted`."""
        from . import fault_injection as _fi
        plan = _fi.active()
        if plan is not None:
            n = plan.driver_step_event()
            if plan.on_preempt is None and n in plan.preempt_at:
                self.request_stop(f"fault_plan preempt_at step {n}")
            if plan.on_kill_worker is None and n in plan.kill_worker_at:
                self.kill_one_worker(reason=f"fault_plan step {n}")
        if self._stop.is_set():
            self.finalize_preemption(module, ckpt_mgr, epoch=epoch,
                                     nbatch=nbatch)

    def on_mesh_degraded(self, exc, module=None, ckpt_mgr=None,
                         epoch: Optional[int] = None,
                         nbatch: Optional[int] = None,
                         train_data=None) -> None:
        """Mesh loss policy (`parallel.elastic_mesh`): `fit` calls this
        when the SPMD probe raised `MeshDegradedError` ahead of a step.
        ``MXTPU_MESH_ON_LOSS=preempt``, or a loss the census could not
        attribute, takes the bounded-checkpoint exit-75 path (with the
        buddy copies merged first where they cover the loss, so the
        checkpoint holds the live state; without them it writes nothing
        and the last valid checkpoint stays the resume point).  ``shrink``
        recovers the lost ZeRO-1 shard (the buddy copy, else the
        ``latest_valid()`` checkpoint), releases the step, bans the lost
        ranks, sets ``MXTPU_SPMD`` to the n' survivors, routes the lost
        ranks through the heartbeat's forgiveness path, and returns: `fit`
        then retries the same batch on the survivors' mesh."""
        from . import config as _cfg
        from . import profiler as _prof
        from . import telemetry as _tele
        from .parallel import elastic_mesh as _em
        lost = list(exc.lost)
        n_prime = int(exc.mesh_size) - len(lost)
        hb = self._hb_monitor
        if hb is not None:
            # a lost rank rides the silent-worker machinery: its lease
            # expires now, the next sweep reports it once
            for r in lost:
                try:
                    hb.report_device_loss(self._hb_rank_of(r))
                except Exception:  # noqa: BLE001
                    pass
        sst = getattr(module, "_spmd_train_step", None)
        if _em.on_loss_policy() == "preempt" or not lost or n_prime < 1:
            self.request_stop(
                f"mesh degraded ({exc.reason}): lost "
                f"{lost or 'unattributed'} of {exc.mesh_size}")
            saveable = module
            if sst is not None:
                # the flat shards live on the lost ranks too: merge what
                # survives, never gather over the broken mesh
                if not lost or sst.recover_lost(lost) is False:
                    sst.invalidate()
                    saveable = None
                sst.release()
                module._spmd_train_step = None
            self.finalize_preemption(saveable, ckpt_mgr, epoch=epoch,
                                     nbatch=nbatch)  # raises
        t0 = time.perf_counter()
        mode = "none-needed"
        if sst is not None:
            mode = sst.recover_lost(lost)
            if mode is False:
                # the flat shards are incomplete: never export them over
                # the per-parameter states
                sst.invalidate()
            sst.release()
            module._spmd_train_step = None
        if mode == "buddy":
            _prof.bump_mesh("buddy_recoveries")
        elif mode is False:
            ck = ckpt_mgr.latest_valid() if ckpt_mgr is not None else None
            if ck is None:
                self.logger.error(
                    "mesh shrink: the lost shard has no buddy copy "
                    "(MXTPU_SPMD_SHARD_REDUNDANCY off?) and no valid "
                    "checkpoint exists; preempting instead")
                self.request_stop(f"mesh degraded, unrecoverable: {exc}")
                self.finalize_preemption(None, ckpt_mgr, epoch=epoch,
                                         nbatch=nbatch)  # raises
            ckpt_mgr.restore(ck, module=module)
            _prof.bump_mesh("disk_recoveries")
        for did in exc.lost_device_ids:
            _em.ban_device(did)
        _cfg.set_env("MXTPU_SPMD", str(n_prime))
        _em.note_shrunk()
        if hb is not None:
            for r in lost:
                hb.forget(self._hb_rank_of(r))
        if train_data is not None and hasattr(train_data, "repartition"):
            # re-anchor this worker's slice only when the partition
            # changed: repartition() rewinds, and mid-epoch that would
            # replay batches (a mesh shrink keeps the worker count)
            kv = getattr(module, "_kvstore", None)
            nw = int(getattr(kv, "num_workers", 1) or 1)
            rk = int(getattr(kv, "rank", 0) or 0)
            cur = (int(getattr(train_data, "num_parts", 1) or 1),
                   int(getattr(train_data, "part_index", 0) or 0))
            if cur != (nw, rk):
                try:
                    train_data.repartition(nw, rk)
                except Exception as e:  # noqa: BLE001
                    _tele.record_error(e, kind="mesh_reshard_iter",
                                       dump=False)
        dt_ms = (time.perf_counter() - t0) * 1e3
        _prof.bump_mesh("reshards")
        _prof.bump_mesh("reshard_ms", dt_ms)
        _tele.event("mesh_shrunk", n_from=int(exc.mesh_size),
                    n_to=n_prime, lost=lost, recovery=str(mode),
                    reshard_ms=round(dt_ms, 3), reason=exc.reason,
                    epoch=epoch, batch=nbatch)
        self.logger.warning(
            "mesh degraded (%s): lost rank(s) %s of %d; recovered via %s, "
            "training continues at n'=%d (%.0f ms reshard)",
            exc.reason, lost, exc.mesh_size, mode, n_prime, dt_ms)

    def on_epoch_end(self, module=None, ckpt_mgr=None,
                     epoch: Optional[int] = None,
                     saved: bool = False) -> None:
        """Epoch-boundary hook: honors a pending stop without writing a
        second checkpoint when the per-epoch save just committed."""
        if not self._stop.is_set():
            return
        if saved:
            self._emit_preempted(epoch=epoch, nbatch=None, committed=True)
            raise TrainingPreempted(self._stop_reason or "preempt",
                                    epoch=epoch, committed=True)
        self.finalize_preemption(module, ckpt_mgr, epoch=epoch,
                                 nbatch=None)

    def finalize_preemption(self, module, ckpt_mgr,
                            epoch: Optional[int] = None,
                            nbatch: Optional[int] = None) -> None:
        """Write the bounded final checkpoint (mid-epoch: the manifest
        records the batch cursor and ``extra.preempted`` so the resume
        redoes the SAME epoch from that batch, bitwise) and raise
        `TrainingPreempted`.  The write runs under
        MXTPU_PREEMPT_CKPT_TIMEOUT_S: past the bound the process moves
        on — the MANIFEST commit point guarantees an abandoned write is
        invisible to `latest_valid()` (commit-or-nothing)."""
        from . import profiler as _prof
        from . import telemetry as _tele
        committed = False
        if module is not None and ckpt_mgr is not None:
            box: Dict[str, Any] = {}

            def _save():
                try:
                    box["ck"] = ckpt_mgr.save_module(
                        module, step=epoch, epoch=epoch, batch=nbatch,
                        extra={"preempted": True,
                               "reason": self._stop_reason or "preempt"})
                except Exception as exc:  # noqa: BLE001
                    box["err"] = exc

            th = threading.Thread(target=_save, daemon=True,
                                  name="mxtpu-preempt-ckpt")
            th.start()
            th.join(self.ckpt_timeout_s)
            if th.is_alive():
                _prof.bump_driver("preempt_ckpt_timeouts")
                self.logger.warning(
                    "preemption checkpoint exceeded %.1fs bound; "
                    "abandoning (previous checkpoint stays the resume "
                    "point)", self.ckpt_timeout_s)
            elif "err" in box:
                _prof.bump_driver("preempt_ckpt_errors")
                _tele.record_error(box["err"], kind="preempt_ckpt")
            else:
                committed = True
                _prof.bump_driver("preempt_ckpt_commits")
        self._emit_preempted(epoch=epoch, nbatch=nbatch,
                             committed=committed)
        raise TrainingPreempted(self._stop_reason or "preempt",
                                epoch=epoch, batch=nbatch,
                                committed=committed)

    def _emit_preempted(self, epoch, nbatch, committed: bool) -> None:
        from . import profiler as _prof
        from . import telemetry as _tele
        _prof.bump_driver("preempts")
        _tele.event("preempted", reason=self._stop_reason or "preempt",
                    epoch=epoch, batch=nbatch, committed=committed,
                    exit_code=PREEMPTED_EXIT_CODE)

    @contextmanager
    def main_guard(self, exit: bool = True):
        """Wrap a training entry point: `TrainingPreempted` becomes the
        distinct `PREEMPTED_EXIT_CODE` (crashes propagate untouched)."""
        try:
            yield self
        except TrainingPreempted as e:
            self.logger.info("clean preemption exit: %s", e)
            dump_counters()
            if exit:
                sys.exit(PREEMPTED_EXIT_CODE)

    # -- worker supervision ---------------------------------------------
    def spawn_workers(self, n: int) -> List[int]:
        """Spawn worker slots 0..n-1 through the ``spawn(slot, attempt)``
        callable.  Returns the slots spawned."""
        assert self._spawn is not None, "no spawn callable configured"
        slots = []
        with self._lock:
            for slot in range(n):
                w = self._workers.setdefault(slot, _Worker(slot))
                if w.proc is None:
                    w.proc = self._spawn(slot, w.attempt)
                    slots.append(slot)
        from . import profiler as _prof
        _prof.set_driver("workers", len(self._workers))
        return slots

    def kill_one_worker(self, slot: Optional[int] = None,
                        reason: str = "requested") -> Optional[int]:
        """Kill one live worker (lowest live slot by default) — the
        fault-plan `kill_worker_at` hook and chaos tests use this to
        simulate a crash; the monitor then respawns it."""
        from . import telemetry as _tele
        with self._lock:
            live = sorted(s for s, w in self._workers.items() if w.live)
            if not live:
                return None
            slot = live[0] if slot is None else slot
            w = self._workers.get(slot)
            if w is None or not w.live:
                return None
            proc = w.proc
        _tele.event("driver.kill_worker", slot=slot, reason=reason)
        try:
            proc.kill()
        except OSError:
            pass
        return slot

    def check_once(self) -> List[int]:
        """One supervision pass: reap exited workers, classify their
        exits (0 done, `PREEMPTED_EXIT_CODE` clean preempt, else crash),
        respawn crashed ones after jittered backoff.  Raises
        `CrashLoopError` when a slot trips the breaker.  Returns the
        slots respawned.  Public so tests drive it deterministically."""
        respawned = []
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if not w.live:
                continue
            code = w.proc.poll()
            if code is None:
                continue
            w.exit_code = code
            if code == 0:
                w.finished = True
                continue
            if code == PREEMPTED_EXIT_CODE:
                w.preempted = True
                from . import profiler as _prof
                _prof.bump_driver("worker_preempts")
                continue
            if self._draining:
                # the death is OUR stop_workers signal landing — a
                # respawn here would resurrect a fleet being shut down
                w.abandoned = True
                continue
            self._handle_death(w, code)
            respawned.append(w.slot)
        return respawned

    def _handle_death(self, w: _Worker, code: int) -> None:
        from . import profiler as _prof
        from . import telemetry as _tele
        now = self._clock()
        w.deaths.append(now)
        w.deaths = [t for t in w.deaths
                    if now - t <= self._crash_window_s]
        if len(w.deaths) >= self._crash_limit:
            from .serving_fleet import CrashLoopError
            exc = CrashLoopError(w.slot, len(w.deaths),
                                 self._crash_window_s)
            _prof.bump_driver("crash_loop_opens")
            _tele.record_error(exc, kind="crash_loop", slot=w.slot)
            raise exc
        k = len(w.deaths) - 1
        delay = min(self._backoff_max_s,
                    self._backoff_base_s * (2.0 ** k)) \
            * (0.5 + self._rng.random())
        w.attempt += 1
        _prof.bump_driver("worker_restarts")
        _tele.event("driver.worker_restart", slot=w.slot, exit_code=code,
                    attempt=w.attempt, backoff_s=round(delay, 3),
                    recent_deaths=len(w.deaths))
        self.logger.warning(
            "worker slot %d died (exit %s): respawning as attempt %d "
            "after %.2fs backoff (%d deaths in %.0fs window)",
            w.slot, code, w.attempt, delay, len(w.deaths),
            self._crash_window_s)
        self._sleep(delay)
        if self._hb_monitor is not None:
            # retire the dead identity so the fresh one gets a clean
            # startup grace instead of an instant dead verdict
            self._hb_monitor.forget(self._hb_rank_of(w.slot))
        w.proc = self._spawn(w.slot, w.attempt)

    def attach_heartbeat(self, monitor,
                         rank_of: Optional[Callable[[int], int]] = None
                         ) -> None:
        """Feed a `parallel.failure.HeartbeatMonitor` into supervision:
        a rank gone silent gets its process killed (detected as a crash
        by the next `check_once`, hence respawned under a fresh
        identity).  ``rank_of(slot)`` maps slots to heartbeat ranks
        (identity by default)."""
        self._hb_monitor = monitor
        if rank_of is not None:
            self._hb_rank_of = rank_of
        slot_of = {self._hb_rank_of(s): s for s in self._workers} or None

        def _on_dead(ranks):
            from . import profiler as _prof
            from . import telemetry as _tele
            for r in ranks:
                slot = (slot_of or {}).get(r, r)
                _prof.bump_driver("heartbeat_deaths")
                _tele.event("driver.heartbeat_dead", rank=r, slot=slot)
                self.kill_one_worker(slot, reason=f"heartbeat rank {r}")

        monitor.on_failure(_on_dead)

    def start(self) -> "TrainingSupervisor":
        """Run supervision on a daemon thread until every worker is done
        (or a crash loop opens / a stop request drains the fleet)."""
        if self._monitor_thread is None:
            self._done.clear()
            self._monitor_thread = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="mxtpu-train-supervisor")
            self._monitor_thread.start()
        return self

    def _monitor_loop(self) -> None:
        from . import telemetry as _tele
        while not self._done.is_set():
            if self._stop.is_set():
                self.stop_workers()
                break
            try:
                self.check_once()
            except MXNetError as exc:  # CrashLoopError
                self.crash_loop = exc
                self.stop_workers(kill=True)
                break
            except Exception as exc:  # noqa: BLE001
                _tele.record_error(exc, kind="supervisor_loop")
                break
            with self._lock:
                if all(not w.live for w in self._workers.values()):
                    break
            self._sleep(self._poll_interval_s)
        self._done.set()

    def stop_workers(self, kill: bool = False,
                     grace_s: Optional[float] = None) -> None:
        """Forward the stop to the fleet: SIGTERM every live worker (so
        each runs its own preemption checkpoint), wait out the grace
        (checkpoint bound + margin), then SIGKILL stragglers.  With
        ``kill=True`` skip straight to SIGKILL."""
        self._draining = True
        with self._lock:
            procs = [w.proc for w in self._workers.values() if w.live]
        if not procs:
            return
        if not kill:
            for p in procs:
                try:
                    p.terminate()
                except OSError:
                    pass
            deadline = self._clock() + (self.ckpt_timeout_s + 10.0
                                        if grace_s is None else grace_s)
            while self._clock() < deadline:
                if all(p.poll() is not None for p in procs):
                    return
                self._sleep(0.1)
        for p in procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass

    def wait(self, timeout: Optional[float] = None) -> Dict[int, Any]:
        """Join the monitor thread; re-raise a crash-loop breaker; else
        return {slot: exit_code}."""
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout)
        if self.crash_loop is not None:
            raise self.crash_loop
        with self._lock:
            return {s: w.exit_code for s, w in self._workers.items()}

    def exit_code(self) -> int:
        """Aggregate status for a supervising parent: crash loop → 1,
        any clean preempt (local or worker) → `PREEMPTED_EXIT_CODE`,
        else 0/first nonzero worker code."""
        if self.crash_loop is not None:
            return 1
        with self._lock:
            if self._stop.is_set() or any(
                    w.preempted for w in self._workers.values()):
                return PREEMPTED_EXIT_CODE
            for w in self._workers.values():
                if w.exit_code not in (0, None):
                    return int(w.exit_code)
        return 0


def dump_counters(file=None) -> str:
    """Print the driver + elastic-mesh counter families in the
    grep-able forensic format (``DRIVER-COUNTERS {...}`` /
    ``MESH-COUNTERS {...}``, the markers `ci.sh` forensics greps)."""
    from . import profiler as _prof
    out = file or sys.stderr
    line = "DRIVER-COUNTERS " + json.dumps(_prof.driver_counters(),
                                           sort_keys=True)
    print(line, file=out, flush=True)
    mline = "MESH-COUNTERS " + json.dumps(_prof.mesh_counters(),
                                          sort_keys=True)
    print(mline, file=out, flush=True)
    return line
