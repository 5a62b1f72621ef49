"""Data descriptors and iterators (the counterparts of `DataDesc`,
`DataBatch`, `DataIter`, `NDArrayIter` and `LibSVMIter` in
`mxnet_tpu/io.py`; reference `python/mxnet/io/io.py`).

`NDArrayIter` batches in-memory arrays with ``shuffle`` (numpy's global
stream, as the reference's) and the ``pad``, ``discard`` and
``roll_over`` ends of an epoch (and ``keep``, which serves the short
tail), over a single array, a list or a dict.  Numpy sources stay on the
host as CPU NDArrays and an NDArray stays where it is: the batch is
copied into the bound inputs on the card by the module that consumes it.
A CSR source is batched by row slices that keep its storage; a batch
that joins two slices (``pad``, ``roll_over``) and a shuffle densify, as
in the JAX package.  `LibSVMIter` streams a LIBSVM file as CSR batches.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .base import MXNetError, numpy_dtype
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    """One mini-batch: lists of data and label arrays."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [l.shape for l in self.label] if self.label else None
        return (f"{type(self).__name__}: data shapes: {data_shapes} "
                f"label shapes: {label_shapes}")


class DataIter:
    """Base iterator (reference `io.py:DataIter`)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _host(v) -> NDArray:
    """A numpy-like source as a CPU NDArray (float64 narrows to float32,
    as the reference's ``_init_data`` does)."""
    v = np.asarray(v)
    if v.dtype == np.float64:
        v = v.astype(np.float32)
    return NDArray(torch.from_numpy(np.ascontiguousarray(v)))


def _init_data(data, allow_empty, default_name):
    """``[(name, NDArray)]`` sorted by name, from one array, a list (named
    ``_i_<default_name>`` when there are several) or a dict."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError(
            "Input must be NDArray, numpy.ndarray, a list of them or dict "
            "with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = NDArray(v)
        else:
            out[k] = _host(v)
    return list(sorted(out.items()))


def _take(arr: NDArray, idx) -> NDArray:
    return NDArray(arr.data[torch.as_tensor(idx, device=arr.data.device)])


class NDArrayIter(DataIter):
    """Iterator over in-memory arrays (reference `io.py:NDArrayIter`)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        if last_batch_handle not in ("pad", "discard", "roll_over", "keep"):
            raise MXNetError(f"NDArrayIter: last_batch_handle "
                             f"{last_batch_handle!r} is not one of pad, "
                             "discard, roll_over, keep")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_source = len(self.data)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.num_data = self.idx.shape[0]
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         numpy_dtype(v.dtype)) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]),
                         numpy_dtype(v.dtype)) for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        # roll_over keeps the tail for the next epoch (reference io.py:560)
        if (self.last_batch_handle == "roll_over"
                and self.num_data - self.batch_size < self.cursor
                < self.num_data):
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if data[0].shape[0] != self.batch_size:
            if self.last_batch_handle == "keep":
                return DataBatch(data=data, label=label, pad=0, index=None)
            # roll_over: a short tail is kept for the next epoch
            self._cache_data = data
            self._cache_label = label
            raise StopIteration
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    @staticmethod
    def _getdata(data_source, start=None, end=None):
        assert start is not None or end is not None
        if start is None:
            start = 0
        if end is None:
            end = data_source[0][1].shape[0] if data_source else 0
        return [x[1][start:end] for x in data_source]

    @staticmethod
    def _concat(first_data, second_data):
        return [NDArray(torch.cat((fd.data, sd.data)))
                for fd, sd in zip(first_data, second_data)]

    def _batchify(self, data_source, cache):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if (self.last_batch_handle == "roll_over"
                and -self.batch_size < self.cursor < 0):
            # the cached tail of the last epoch, then this epoch's head
            assert cache is not None, "next epoch should have cached data"
            second = self._getdata(data_source,
                                   end=self.cursor + self.batch_size)
            return self._concat(cache, second)
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            pad = self.batch_size - self.num_data + self.cursor
            first = self._getdata(data_source, self.cursor, self.num_data)
            second = self._getdata(data_source, 0, pad)
            return self._concat(first, second)
        if self.last_batch_handle == "discard" \
                and self.cursor + self.batch_size > self.num_data:
            raise StopIteration
        end = min(self.cursor + self.batch_size, self.num_data)
        return self._getdata(data_source, self.cursor, end)

    def getdata(self):
        data = self._batchify(self.data, self._cache_data)
        if (self.last_batch_handle == "roll_over"
                and -self.batch_size < self.cursor < 0):
            self._cache_data = None
        return data

    def getlabel(self):
        label = self._batchify(self.label, self._cache_label)
        if (self.last_batch_handle == "roll_over"
                and -self.batch_size < self.cursor < 0):
            self._cache_label = None
        return label

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0

    def _shuffle_data(self):
        np.random.shuffle(self.idx)
        self.data = [(k, _take(v, self.idx)) for k, v in self.data]
        self.label = [(k, _take(v, self.idx)) for k, v in self.label]


class LibSVMIter(DataIter):
    """A LIBSVM file (``label index:value ...`` lines) as CSR data batches
    of ``batch_size`` rows (reference `src/io/iter_libsvm.cc`; the JAX
    package's `io.LibSVMIter`).  The file is read once into its CSR
    components and never densified.  ``num_parts``/``part_index`` keep
    every ``num_parts``-th row from ``part_index``; ``round_batch`` fills
    the last batch from the start of the file (else it is dropped).
    ``label_libsvm`` and ``label_shape`` are accepted and unused, as in
    the JAX package: the labels are each line's first field."""

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 label_libsvm=None, label_shape=None, round_batch=True,
                 num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        if int(num_parts) > 1 and not 0 <= int(part_index) < int(num_parts):
            raise MXNetError(f"part_index {part_index} out of range for "
                             f"{num_parts} parts")
        self._data_shape = tuple(data_shape)
        self._ncol = int(np.prod(self._data_shape))
        values, indices, indptr, labels = [], [], [0], []
        row = 0
        with open(data_libsvm) as fin:
            for line in fin:
                parts = line.split()
                if not parts:
                    continue
                keep = (num_parts <= 1
                        or row % int(num_parts) == int(part_index))
                row += 1
                if not keep:
                    continue
                labels.append(float(parts[0]))
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    indices.append(int(k))
                    values.append(float(v))
                indptr.append(len(values))
        self._values = np.asarray(values, np.float32)
        self._indices = np.asarray(indices, np.int32)
        self._indptr = np.asarray(indptr, np.int64)
        self._n = len(labels)
        self._labels = np.asarray(labels, np.float32)
        self._cursor = -batch_size
        self.round_batch = round_batch
        self._source = data_libsvm
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)

    def repartition(self, num_parts, part_index):
        """Read this worker's new shard of the same file and rewind."""
        self.__init__(self._source, self._data_shape,
                      batch_size=self.batch_size,
                      round_batch=self.round_batch,
                      num_parts=num_parts, part_index=part_index)

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("label", (self.batch_size,))]

    def reset(self):
        self._cursor = -self.batch_size

    def next(self):
        from .ndarray.sparse import CSRNDArray
        self._cursor += self.batch_size
        if self._cursor >= self._n:
            raise StopIteration
        end = self._cursor + self.batch_size
        if end > self._n:
            if not self.round_batch:
                raise StopIteration
            idx = np.concatenate([np.arange(self._cursor, self._n),
                                  np.arange(end - self._n)])
        else:
            idx = np.arange(self._cursor, end)
        lo, hi = self._indptr[idx], self._indptr[idx + 1]
        counts = hi - lo
        gather = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)]) \
            if len(idx) else np.zeros(0, np.int64)
        bindptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        data = CSRNDArray(torch.from_numpy(self._values[gather]),
                          torch.from_numpy(self._indices[gather]),
                          torch.from_numpy(bindptr),
                          (len(idx), self._ncol))
        label = NDArray(torch.from_numpy(self._labels[idx]))
        return DataBatch(data=[data], label=[label],
                         pad=max(0, end - self._n), index=None)
