"""Double-buffered device feed (the counterpart of
`mxnet_tpu/parallel/feed.py`): overlap the host-to-device copy with the
training step (reference `src/io/iter_prefetcher.h` keeps N batches
staged; here the stage is device memory).

`PrefetchingIter` (io.py) already overlaps batch PREP (decode/augment)
with training on a background thread; this adds the second stage the
reference's prefetcher chain has: the staged batch is also placed
(`SPMDTrainer.place_inputs`) off the training thread, on a side CUDA
stream of its own, so the step finds its inputs already resident.  The
consumer's stream waits for the copy's event before it reads them.

    feed = DeviceFeed(train_iter, trainer, depth=2)
    for xd, yd in feed:
        loss = trainer.step(xd, yd)   # inputs already on device
"""
from __future__ import annotations

import queue as _queue
import threading
import weakref

import torch

__all__ = ["DeviceFeed"]

_END = ("end", None)


class DeviceFeed:
    """Iterate (device_data, device_label) pairs, `depth` batches ahead.

    ``data_iter`` yields reference-style DataBatch objects (`.data[0]`,
    `.label[0]`) or plain (x, y) tuples.  Each epoch ends with a normal
    StopIteration; `reset()` (or iterating again) starts the next epoch
    — the underlying iter is reset too, matching DataIter semantics.
    Exceptions in the feeder thread re-raise at the consuming `next()`
    (the engine's exception-marshalling contract).  The pairs are the
    trainer's placed inputs (`sharding.ShardedTensor`)."""

    def __init__(self, data_iter, trainer, depth: int = 2):
        self._iter = data_iter
        self._trainer = trainer
        self._depth = max(1, int(depth))
        self._queue: _queue.Queue = _queue.Queue(maxsize=self._depth)
        self._thread = None
        self._started = False
        self._stop = threading.Event()
        # an abandoned feed (consumer breaks mid-epoch and drops the
        # reference) must release its thread and staged device batches;
        # the worker holds only this Event + queue, so finalize can fire
        self._arm_finalizer()

    def _arm_finalizer(self):
        self._finalizer = weakref.finalize(self, self._stop.set)

    @staticmethod
    def _split(batch):
        if isinstance(batch, tuple) and len(batch) == 2:
            return batch
        return batch.data[0], batch.label[0]

    @staticmethod
    def _worker(data_iter, trainer, stop, q):
        # staticmethod on purpose: the thread must NOT hold a reference
        # to the DeviceFeed, or the GC finalizer that stops an abandoned
        # feed could never fire
        def put(item):
            # bounded puts so a stopped/abandoned feed releases its
            # thread (and the device batches it holds) promptly
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        stream = None
        try:
            while not stop.is_set():
                try:
                    batch = next(data_iter)
                except StopIteration:
                    break
                x, y = DeviceFeed._split(batch)
                # the copy happens here, on the feeder thread and its own
                # stream: the training thread's placement is a no-op
                dev = trainer.mesh.device
                if dev.type == "cuda":
                    if stream is None:
                        stream = torch.cuda.Stream(dev)
                    with torch.cuda.stream(stream):
                        xd, yd = trainer.place_inputs(x, y)
                        ready = torch.cuda.Event()
                        ready.record(stream)
                else:
                    xd, yd = trainer.place_inputs(x, y)
                    ready = None
                if not put(("data", (xd, yd, ready))):
                    return
        except Exception as e:  # marshal to the consumer
            put(("err", e))
            return
        put(_END)

    def close(self):
        """Stop the feeder thread and drop staged device batches."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._queue = _queue.Queue(maxsize=self._depth)
        self._started = False

    def reset(self):
        self.close()
        if hasattr(self._iter, "reset"):
            self._iter.reset()
        self._stop = threading.Event()
        self._finalizer.detach()
        self._arm_finalizer()
        self._thread = threading.Thread(
            target=DeviceFeed._worker,
            args=(self._iter, self._trainer, self._stop, self._queue),
            daemon=True)
        self._thread.start()
        self._started = True

    def __iter__(self):
        return self

    def __next__(self):
        if not self._started:
            self.reset()
        kind, payload = self._queue.get()
        if kind == "err":
            self._started = False
            raise payload
        if kind == "end":
            self._started = False
            raise StopIteration
        xd, yd, ready = payload
        if ready is not None:
            cur = torch.cuda.current_stream(xd.local.device)
            cur.wait_event(ready)
            for t in (xd.local, yd.local):
                t.record_stream(cur)
        return xd, yd

    next = __next__
