"""Datasets (the counterpart of `mxnet_tpu/gluon/data/dataset.py`;
reference `python/mxnet/gluon/data/dataset.py`)."""
from __future__ import annotations

import numpy as np

from ...context import cpu
from ...ndarray.ndarray import NDArray, array

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset"]


class Dataset:
    """``__getitem__`` and ``__len__`` (reference `dataset.py:Dataset`)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        """``fn`` over each sample (over its fields when it is a tuple),
        when it is read (``lazy``) or all at once."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` over the first field of each sample only (the image of an
        (image, label) pair)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A dataset over a list or any indexable sequence."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Equal-length arrays zipped into samples (reference
    `dataset.py:ArrayDataset`).  A sample of a multi-dimensional numpy
    array is read as a host NDArray (float32, as `nd.array` makes it); a
    one-dimensional NDArray is kept as numpy, so its items are numbers
    (labels)."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least one array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    f"All arrays must have the same length; array[0] has "
                    f"length {self._length} while array[{i}] has "
                    f"{len(data)}.")
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    @staticmethod
    def _sample(data, idx):
        item = data[idx]
        if isinstance(item, np.ndarray) and getattr(data, "ndim", 1) > 1:
            return array(item, ctx=cpu())
        return item

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._sample(self._data[0], idx)
        return tuple(self._sample(data, idx) for data in self._data)

    def __len__(self):
        return self._length
