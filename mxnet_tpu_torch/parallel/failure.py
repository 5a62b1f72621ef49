"""Dead-node detection for multi-process training (the counterpart of
`mxnet_tpu/parallel/failure.py`, plain Python over TCP).

The reference's failure story is ps-lite's heartbeat mechanism (workers and
servers ping the scheduler; `PS_HEARTBEAT_TIMEOUT` marks silent nodes dead)
plus `DMLC_PS_VAN_TIMEOUT`-bounded barriers.  In the symmetric-SPMD runtime
there is no scheduler process, so the coordinator (process 0) runs a tiny
TCP heartbeat monitor and every process runs a client thread.  A stale
heartbeat marks the rank dead and fires the registered callbacks — the
signal checkpoint/resume (`serialization.py` + `callback.do_checkpoint`)
needs to restart from the last epoch, which is exactly the reference's
recovery story (no live migration there either).
"""
from __future__ import annotations

import os
import socket
import threading
import time

from .. import config
from typing import Callable, Dict, List, Optional

__all__ = ["HeartbeatMonitor", "HeartbeatClient", "start_failure_detector"]


class HeartbeatMonitor:
    """Coordinator-side monitor: workers ping ``rank`` over TCP; ranks
    silent for longer than `timeout` are reported dead (mirrors ps-lite's
    scheduler-side `PS_HEARTBEAT_TIMEOUT` sweep)."""

    def __init__(self, port: int = 0, timeout: float = 10.0,
                 expected: Optional[int] = None,
                 startup_grace: Optional[float] = None):
        self.timeout = timeout
        self.expected = expected
        # ranks expected but never heard from count as dead once the
        # startup grace (default 3x timeout) has passed
        self.startup_grace = (3.0 * timeout if startup_grace is None
                              else startup_grace)
        self._start = time.monotonic()
        self._last_seen: Dict[int, float] = {}
        # per-rank grace deadlines: a forgotten (respawn-replaced) rank
        # gets a fresh startup grace instead of inheriting the global
        # one, which has usually long expired by the time it restarts
        self._grace_until: Dict[int, float] = {}
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[List[int]], None]] = []
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(64)
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._sweep_thread = threading.Thread(target=self._sweep_loop,
                                              daemon=True)
        self._reported: set = set()
        self._accept_thread.start()
        self._sweep_thread.start()

    def on_failure(self, callback: Callable[[List[int]], None]) -> None:
        """Register a callback fired with the list of newly-dead ranks."""
        self._callbacks.append(callback)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                # accepted sockets inherit blocking mode; bound the recv so
                # a connect-and-stall client can't wedge the accept loop
                conn.settimeout(1.0)
                data = conn.recv(64).decode("ascii", "ignore").strip()
                if data:
                    with self._lock:
                        self._last_seen[int(data)] = time.monotonic()
            except (ValueError, OSError):
                pass
            finally:
                conn.close()

    def _sweep_loop(self) -> None:
        while not self._stop.is_set():
            self.sweep_once()
            time.sleep(min(0.2, self.timeout / 4))

    def sweep_once(self) -> List[int]:
        """One sweep: report every NEWLY-dead rank to the callbacks and
        return them.  A rank that recovered (pinged again after being
        reported) is forgiven, so a later death fires the callbacks
        again instead of being swallowed by the one-shot ``_reported``
        set.  Public so tests and supervisors can drive detection
        deterministically."""
        dead = self.dead_ranks()
        with self._lock:
            recovered = self._reported.difference(dead)
            self._reported.difference_update(recovered)
            fresh = [r for r in dead if r not in self._reported]
            self._reported.update(fresh)
        if fresh:
            for cb in self._callbacks:
                try:
                    cb(fresh)
                except Exception:  # a broken callback must not
                    import logging  # disable future detection
                    logging.getLogger(__name__).exception(
                        "failure callback raised")
        return fresh

    def alive_ranks(self) -> List[int]:
        now = time.monotonic()
        with self._lock:
            return sorted(r for r, t in self._last_seen.items()
                          if now - t <= self.timeout)

    def dead_ranks(self) -> List[int]:
        """Ranks gone silent — pinged once then stopped, or expected at
        startup and never heard from within the grace period (per-rank:
        a rank ``forget()`` replaced gets a fresh grace window)."""
        now = time.monotonic()
        with self._lock:
            dead = {r for r, t in self._last_seen.items()
                    if now - t > self.timeout}
            if self.expected:
                default_grace = self._start + self.startup_grace
                for r in range(self.expected):
                    if r in self._last_seen:
                        continue
                    if now > self._grace_until.get(r, default_grace):
                        dead.add(r)
            return sorted(dead)

    def report_device_loss(self, rank: int) -> None:
        """A mesh-device loss detected by the elastic-mesh sentinel
        probe (`parallel.elastic_mesh`) rides the SAME machinery as a
        silent worker: expire the rank's lease immediately, so the next
        sweep reports it to the failure callbacks exactly once, and the
        supervisor's post-shrink `forget()` grants any replacement a
        fresh startup grace — the recovered-rank forgiveness path,
        shared between worker deaths and device deaths."""
        with self._lock:
            self._last_seen[rank] = float("-inf")

    def forget(self, rank: int) -> None:
        """Clear all state for a rank about to be replaced (supervisor
        respawn under a fresh identity): drop its stale last-seen time,
        clear its reported-dead latch, and grant the replacement a fresh
        startup grace so it is not re-declared dead before its first
        ping arrives."""
        now = time.monotonic()
        with self._lock:
            self._last_seen.pop(rank, None)
            self._grace_until[rank] = now + self.startup_grace
            self._reported.discard(rank)

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        self._sweep_thread.join(timeout=2.0)


class HeartbeatClient:
    """Per-process client thread pinging the monitor every `interval`
    seconds (mirrors ps-lite's `PS_HEARTBEAT_INTERVAL` node-side loop)."""

    def __init__(self, address: str, port: int, rank: int,
                 interval: float = 1.0):
        self.address = address
        self.port = port
        self.rank = rank
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _ping_once(self) -> bool:
        try:
            with socket.create_connection((self.address, self.port),
                                          timeout=2.0) as conn:
                conn.sendall(f"{self.rank}\n".encode("ascii"))
            return True
        except OSError:
            return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._ping_once()
            self._stop.wait(self.interval)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=3.0)


def start_failure_detector(timeout: float = 10.0, interval: float = 1.0):
    """Wire up the detector for the current cluster.

    Process 0 starts a `HeartbeatMonitor` (port from
    ``MXTPU_HEARTBEAT_PORT``, default 9099); every process starts a
    `HeartbeatClient` pinging it.  Returns ``(monitor_or_None, client)``.
    Single-process runs get a monitor + self-client so the wiring is
    exercised everywhere.
    """
    from . import distributed as _dist
    rank = _dist.rank()
    port = int(config.get_env("MXTPU_HEARTBEAT_PORT", 9099))
    # mxtpu-lint: disable=raw-env-read -- DMLC_* is the launcher's wire
    # protocol, set per-process by tracker/ssh launchers, not a user knob
    host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    monitor = None
    if rank == 0:
        monitor = HeartbeatMonitor(port=port, timeout=timeout,
                                   expected=_dist.size())
        host, port = "127.0.0.1", monitor.port
    client = HeartbeatClient(host, port, rank, interval=interval)
    return monitor, client
