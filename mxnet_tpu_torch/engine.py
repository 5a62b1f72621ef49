"""The dependency engine's host side (the counterpart of
`mxnet_tpu/engine.py`; reference `include/mxnet/engine.h`,
`src/engine/threaded_engine.cc`).

Device work is ordered by CUDA streams, so what the engine keeps is the
reference's host surface: `push`/`push_sync` of closures onto a small
thread pool, ordered per variable (a writer waits for every earlier push
on its variables), `wait_for_var`, `wait_for_all` (every pending push,
then the current CUDA stream), and ``MXNET_ENGINE_TYPE=NaiveEngine``,
under which every push completes before it returns.  `bulk` and
`set_bulk_size` are kept for the API; a CUDA graph already batches the
launches they would group.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import torch

from .config import get_env

__all__ = ["Engine", "get_engine", "set_bulk_size", "bulk"]


class _Var:
    """An engine variable: the tail of its pushes (reference
    `ThreadedVar`)."""
    __slots__ = ("_last", "version")

    def __init__(self):
        self._last: Optional[Future] = None
        self.version = 0


class Engine:
    """Host closures on a thread pool, ordered by the variables they
    read and write."""

    def __init__(self, kind: Optional[str] = None):
        self.kind = kind or get_env("MXNET_ENGINE_TYPE")
        workers = max(int(get_env("MXNET_CPU_WORKER_NTHREADS", 4)), 1)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._sync = self.kind == "NaiveEngine"
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    def new_variable(self) -> _Var:
        return _Var()

    def push(self, fn: Callable, const_vars: Sequence[_Var] = (),
             mutable_vars: Sequence[_Var] = (), priority=0) -> Future:
        """Run ``fn`` after every earlier push on its variables (reference
        `PushAsync`); its mutable variables' versions advance after it.
        Returns its future."""
        def run():
            for d in deps:
                d.result()
            try:
                return fn()
            finally:
                for v in mutable_vars:
                    v.version += 1

        # taking the tails and publishing the new one is one step, or two
        # pushes on one variable could both wait on the old tail
        with self._lock:
            deps = [v._last for v in list(const_vars) + list(mutable_vars)
                    if v._last is not None]
            fut = self._pool.submit(run)
            for v in mutable_vars:
                v._last = fut
            self._pending.append(fut)
            # drop finished pushes, but keep the latest failed one so that
            # `wait_for_all` raises its error (the reference keeps one)
            live, last_failed = [], None
            for f in self._pending:
                if not f.done():
                    live.append(f)
                elif f.exception() is not None:
                    last_failed = f
            if last_failed is not None:
                live.append(last_failed)
            self._pending = live
        if self._sync:
            fut.result()
        return fut

    push_async = push

    def push_sync(self, fn: Callable, const_vars=(), mutable_vars=()):
        """`push` and wait: ``fn``'s result."""
        return self.push(fn, const_vars, mutable_vars).result()

    def wait_for_var(self, var: _Var):
        if var._last is not None:
            var._last.result()

    def wait_for_all(self):
        """Every pending push (a failed one raises), then the work queued
        on the current CUDA stream."""
        with self._lock:
            pending, self._pending = list(self._pending), []
        for f in pending:
            f.result()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()

    def notify_shutdown(self):
        self._pool.shutdown(wait=False)


_ENGINE: Optional[Engine] = None
_ENGINE_LOCK = threading.Lock()


def get_engine() -> Engine:
    """The process's engine, made at first use."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = Engine()
        return _ENGINE


_bulk_size = 15


def set_bulk_size(size: int) -> int:
    """Set the bulk size; returns the previous one."""
    global _bulk_size
    old, _bulk_size = _bulk_size, size
    return old


class bulk:  # noqa: N801  (the reference's name)
    """``with engine.bulk(n):`` sets the bulk size for its body."""

    def __init__(self, size: int):
        self.size = size

    def __enter__(self):
        self._old = set_bulk_size(self.size)
        return self

    def __exit__(self, *exc):
        set_bulk_size(self._old)
