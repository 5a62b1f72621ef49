"""DataLoader (the counterpart of `mxnet_tpu/gluon/data/dataloader.py`;
reference `python/mxnet/gluon/data/dataloader.py`).

As in the JAX package, ``num_workers > 0`` reads and batches samples on a
pool of threads (the reference forks processes that hand batches over in
shared memory) with at most ``prefetch`` batches (2 per worker by
default) in flight ahead of the consumer, in the sampler's order.  Batches
are host NDArrays; ``pin_memory`` pins them (page-locked, where a CUDA
device exists), so that the copy to the card can run asynchronously.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...context import cpu
from ...ndarray.ndarray import NDArray, array
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Samples stacked into a batch (reference
    `dataloader.py:default_batchify_fn`): NDArrays into one float32
    NDArray, tuples field by field, numbers into an array of their dtype
    (float64 as float32)."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d.data for d in data]).to(torch.float32))
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i)) for i in zip(*data)]
    out = np.asarray(data)
    return array(out, ctx=cpu(),
                 dtype=out.dtype if out.dtype != np.float64 else np.float32)


def _pinned(batch):
    if isinstance(batch, NDArray):
        return NDArray(batch.data.pin_memory())
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pinned(b) for b in batch)
    return batch


class DataLoader:
    """Batches of a dataset (reference `dataloader.py:DataLoader`)."""

    def __init__(self, dataset: Dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None, thread_pool=True):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._pin = pin_memory and torch.cuda.is_available()

    def __len__(self):
        return len(self._batch_sampler)

    def _fetch(self, batch):
        out = self._batchify_fn([self._dataset[i] for i in batch])
        return _pinned(out) if self._pin else out

    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._fetch(batch)
            return
        yield from self._threaded_iter()

    def _threaded_iter(self):
        """Batches fetched on the pool, handed over in order through a
        queue of at most ``prefetch`` futures; a consumer that stops early
        stops the submitting thread and cancels what has not started."""
        pool = ThreadPoolExecutor(max_workers=self._num_workers)
        futures = queue.Queue(maxsize=max(self._prefetch, 1))
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    futures.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def submit():
            try:
                for batch in self._batch_sampler:
                    if not put(pool.submit(self._fetch, batch)):
                        return
                put(None)
            except Exception as e:  # handed to the consumer, which raises
                put(e)

        thread = threading.Thread(target=submit, daemon=True)
        thread.start()
        try:
            while True:
                item = futures.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item.result()
        finally:
            stop.set()
            thread.join()
            pool.shutdown(wait=True, cancel_futures=True)
