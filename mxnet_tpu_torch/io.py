"""Data descriptors and iterators (the counterpart of `mxnet_tpu/io.py`;
reference `python/mxnet/io/io.py` and the C++ iterators of `src/io/`).

`NDArrayIter` batches in-memory arrays with ``shuffle`` (numpy's global
stream, as the reference's) and the ``pad``, ``discard`` and
``roll_over`` ends of an epoch (and ``keep``, which serves the short
tail), over a single array, a list or a dict.  Numpy sources stay on the
host as CPU NDArrays and an NDArray stays where it is: the batch is
copied into the bound inputs on the card by the module that consumes it.
A CSR source is batched by row slices that keep its storage; a batch
that joins two slices (``pad``, ``roll_over``) and a shuffle densify, as
in the JAX package.  ``num_parts``/``part_index`` keep every
``num_parts``-th row from ``part_index`` (the reference's round-robin
shard), and `NDArrayIter.repartition` reshards at an epoch boundary.
`LibSVMIter` streams a LIBSVM file as CSR batches; `MNISTIter` and
`CSVIter` read their files into an `NDArrayIter`.

The image pipelines stage batches to their device as MXNet's C++ loader
does: `NativeImageRecordIter` decodes a batch of JPEGs with the native
library straight into a pinned uint8 NHWC buffer, and `image.ImageIter`
writes its augmented uint8 images into one; the buffer is copied to the
card on a staging stream (``non_blocking``), cast, mirrored, normalized
and transposed there (`ops.image_ops.batch_normalize_mirror`), and the
consumer's stream waits on that work's event (`_Stager`).  A pinned
buffer is rewritten only after its last copy has finished, so a batch
never changes after it was handed over.  `ImageRecordIter` picks the
native iterator when the library decodes JPEG, else `image.ImageIter`;
`PrefetchingIter` runs an iterator's fetches ahead on the `engine`.
"""
from __future__ import annotations

import logging
import os
import struct
from collections import deque, namedtuple

import numpy as np
import torch

from .base import MXNetError, numpy_dtype
from .config import get_env
from .context import default_context
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "MNISTIter",
           "NativeImageRecordIter", "CSVIter", "LibSVMIter",
           "ImageRecordIter", "PrefetchingIter", "ResizeIter", "MXDataIter"]


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


def _partition(seq, num_parts, part_index):
    """Worker ``part_index``'s round-robin shard of ``seq`` (the reference
    iterators' ``num_parts``/``part_index``)."""
    num_parts, part_index = int(num_parts), int(part_index)
    if num_parts <= 1:
        return seq
    if not 0 <= part_index < num_parts:
        raise MXNetError(
            f"part_index {part_index} out of range for {num_parts} parts"
            + (" — after an elastic downscale this worker's old rank no "
               "longer exists; call repartition(num_parts, part_index) "
               "with its NEW (kv.num_workers, kv.rank) at the epoch "
               "boundary instead of reusing the stale shard"
               if part_index >= num_parts else ""))
    return seq[part_index::num_parts]


class NDArrayIter(DataIter):
    """Iterator over in-memory arrays (reference `io.py:NDArrayIter`)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", num_parts=1, part_index=0):
        super().__init__(batch_size)
        # the whole sources stay, so that `repartition` can reshard
        self._full_data = _init_data(data, allow_empty=False,
                                     default_name=data_name)
        self._full_label = _init_data(label, allow_empty=True,
                                      default_name=label_name)
        if last_batch_handle not in ("pad", "discard", "roll_over", "keep"):
            raise MXNetError(f"NDArrayIter: last_batch_handle "
                             f"{last_batch_handle!r} is not one of pad, "
                             "discard, roll_over, keep")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_source = len(self._full_data)
        self._apply_partition(num_parts, part_index)
        self.reset()

    def _apply_partition(self, num_parts, part_index):
        """This worker's shard of the whole sources, and the batch
        bookkeeping rewound."""
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        if self.num_parts > 1:
            sel = _partition(np.arange(self._full_data[0][1].shape[0]),
                             self.num_parts, self.part_index)
            self.data = [(k, _take(v, sel)) for k, v in self._full_data]
            self.label = [(k, _take(v, sel)) for k, v in self._full_label]
        else:
            self.data = list(self._full_data)
            self.label = list(self._full_label)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.num_data = self.idx.shape[0]
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def repartition(self, num_parts, part_index):
        """Reshard for a new worker set (``kv.num_workers``, ``kv.rank``)
        and rewind to the shard's start; call it at an epoch boundary."""
        self._apply_partition(num_parts, part_index)
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


class MNISTIter(NDArrayIter):
    """MNIST's idx files (gzipped or not) as an `NDArrayIter` of
    (N, 1, 28, 28) images in [0, 1], or (N, 784) with ``flat``
    (reference `src/io/iter_mnist.cc`); the synthetic set of
    `gluon.data.vision` when ``image`` does not exist.  The last short
    batch is dropped."""

    def __init__(self, image=None, label=None, batch_size=128, shuffle=True,
                 flat=False, seed=0, silent=False, **kwargs):
        if image and os.path.exists(image):
            img, lbl = _read_mnist(image, label)
            data = img.astype(np.float32) / 255.0
            data = data.reshape(len(data), -1) if flat \
                else data[:, None, :, :]
        else:
            from .gluon.data.vision.datasets import synthetic_mnist_arrays
            data, lbl = synthetic_mnist_arrays()
            if flat:
                data = data.reshape(len(data), -1)
        super().__init__(data, lbl.astype(np.float32), batch_size, shuffle,
                         last_batch_handle="discard",
                         num_parts=kwargs.get("num_parts", 1),
                         part_index=kwargs.get("part_index", 0))


def _read_mnist(img_path, lbl_path):
    import gzip
    opener = gzip.open if str(img_path).endswith(".gz") else open
    with opener(lbl_path, "rb") as fin:
        struct.unpack(">II", fin.read(8))
        lbl = np.frombuffer(fin.read(), dtype=np.uint8)
    with opener(img_path, "rb") as fin:
        struct.unpack(">IIII", fin.read(16))
        img = np.frombuffer(fin.read(), dtype=np.uint8)
    return img.reshape(len(lbl), 28, 28), lbl


class CSVIter(NDArrayIter):
    """Rows of a CSV file, each reshaped to ``data_shape``, with labels
    from ``label_csv`` (reference `src/io/iter_csv.cc`); without
    ``round_batch`` the short last batch is served as it is."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        super().__init__(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "keep",
            num_parts=kwargs.get("num_parts", 1),
            part_index=kwargs.get("part_index", 0))


# ---------------------------------------------------------------------------
# staging image batches to their device
# ---------------------------------------------------------------------------

class _Slot:
    """One staging slot: host buffers for a batch's uint8 pixels, mirror
    flags and labels (pinned for a CUDA device), and the event after the
    last copy out of them."""

    def __init__(self, n, hwc, label_width, pinned):
        def host(shape, dtype):
            return torch.zeros(shape, dtype=dtype, pin_memory=pinned)
        self.tensors = (host((n,) + tuple(hwc), torch.uint8),
                        host((n,), torch.bool),
                        host((n, label_width), torch.float32))
        self.data, self.flip, self.label = (t.numpy() for t in self.tensors)
        self.copied = None
        self.started = None


class _Stager:
    """Host uint8 batches to ``device``: on a CUDA device a ring of
    ``slots`` pinned buffers, each copied on the stager's stream with
    ``non_blocking`` and rewritten only after that copy has finished;
    the device step (`batch_normalize_mirror`) runs on the same stream and
    the batch carries the event after it, which `_hand_over` makes the
    consumer's stream wait on.  On the CPU each batch gets buffers of its
    own and no event."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self._ring = [None] * max(2, int(slots))
        self._k = 0
        self._stream = torch.cuda.Stream(device) if self.cuda else None
        #: (start, end) events of the latest copies, for `h2d_ms`
        self._copies = deque(maxlen=64)
        self._consts = {}
        self.bytes_per_batch = 0

    def const(self, values) -> torch.Tensor:
        """``values`` (a float32 numpy array) as a device tensor, copied
        once."""
        key = values.tobytes()
        if key not in self._consts:
            self._consts[key] = torch.from_numpy(values.copy()).to(
                self.device)
        return self._consts[key]

    def slot(self, n, hwc, label_width) -> _Slot:
        """The next slot with room for ``n`` images of shape ``hwc``, its
        last copy finished (the host waits for it here)."""
        if not self.cuda:
            return _Slot(n, hwc, label_width, pinned=False)
        i = self._k % len(self._ring)
        self._k += 1
        slot = self._ring[i]
        if slot is None or slot.data.shape != (n,) + tuple(hwc) or \
                slot.label.shape[1] != label_width:
            slot = self._ring[i] = _Slot(n, hwc, label_width, pinned=True)
        elif slot.copied is not None:
            slot.copied.synchronize()
        return slot

    def run(self, slot: _Slot, fn):
        """``fn(pixels, flags, labels)`` on the slot's device copies;
        returns its results and the event after them (None on the CPU)."""
        if not self.cuda:
            return fn(*(torch.from_numpy(a) for a in
                        (slot.data, slot.flip, slot.label))), None
        self.bytes_per_batch = sum(t.numel() * t.element_size()
                                   for t in slot.tensors)
        with torch.cuda.stream(self._stream):
            slot.started = torch.cuda.Event(enable_timing=True)
            slot.copied = torch.cuda.Event(enable_timing=True)
            slot.started.record()
            dev = [t.to(self.device, non_blocking=True)
                   for t in slot.tensors]
            slot.copied.record()
            self._copies.append((slot.started, slot.copied))
            out = fn(*dev)
            ready = torch.cuda.Event()
            ready.record()
        return out, ready

    def h2d_ms(self):
        """The milliseconds of the latest copies that have finished."""
        return [a.elapsed_time(b) for a, b in list(self._copies)
                if b.query()]


def _hand_over(batch: DataBatch) -> DataBatch:
    """Make the calling thread's stream wait for a staged batch's device
    work, and keep its tensors' memory until that stream is done with
    them."""
    ready = batch.__dict__.pop("_ready", None)
    if ready is not None:
        stream = torch.cuda.current_stream(batch.data[0].data.device)
        stream.wait_event(ready)
        for arr in list(batch.data) + list(batch.label or []):
            arr.data.record_stream(stream)
    return batch


def _staged_batch(stager: _Stager, slot: _Slot, pad: int, mean, std,
                  label_width: int, layout: str = "NCHW",
                  zero_pad: bool = False) -> DataBatch:
    """The batch of a filled slot on the stager's device: pixels cast,
    mirrored where flagged, normalized (``mean``/``std`` float32 arrays of
    (C,) or (1,)) and in ``layout``.  The last ``pad`` rows are padding,
    and with ``zero_pad`` they are zeros after the step (`image.ImageIter`
    pads so; the native iterator pads before it)."""
    from .ops.image_ops import batch_normalize_mirror
    mean_t, std_t = stager.const(mean), stager.const(std)

    def step(pixels, flags, labels):
        y = batch_normalize_mirror(pixels, flags, mean_t, std_t, layout)
        if zero_pad and pad:
            y[y.shape[0] - pad:] = 0
        return y, (labels[:, 0] if label_width == 1 else labels)

    (data, label), ready = stager.run(slot, step)
    batch = DataBatch(data=[NDArray(data)], label=[NDArray(label)], pad=pad)
    if ready is not None:
        batch._ready = ready
    return batch


def _staged_next(it):
    """An iterator's next batch, not yet handed over when it stages."""
    return it._staged_next() if hasattr(it, "_staged_next") else it.next()


def ImageRecordIter(path_imgrec=None, data_shape=(3, 224, 224),
                    batch_size=128, shuffle=False, **kwargs):
    """The RecordIO image pipeline (reference `iter_image_recordio_2.cc`,
    registered as ImageRecordIter), wrapped in `PrefetchingIter`.

    With only the standard options (``rand_mirror``, ``mean``/``std``,
    ``preprocess_threads`` ...), records packed at ``data_shape``, and a
    native library that decodes JPEG, `NativeImageRecordIter` serves;
    otherwise `image.ImageIter` does, with the same batches where both
    apply (the JAX package's choice)."""
    from . import io_native
    native_keys = {"rand_mirror", "mean", "std", "preprocess_threads",
                   "label_width", "data_name", "label_name", "round_batch",
                   "seed", "seed_aug", "num_parts", "part_index",
                   "fast_decode"}
    if path_imgrec and io_native.decode_available() and \
            set(kwargs) <= native_keys and \
            _packed_at_shape(path_imgrec, data_shape):
        return PrefetchingIter(NativeImageRecordIter(
            path_imgrec, data_shape=data_shape, batch_size=batch_size,
            shuffle=shuffle, **kwargs))
    from .image import ImageIter
    kwargs.pop("preprocess_threads", None)
    kwargs.pop("round_batch", None)
    return PrefetchingIter(ImageIter(batch_size=batch_size,
                                     data_shape=data_shape,
                                     path_imgrec=path_imgrec,
                                     shuffle=shuffle, **kwargs))


def _packed_at_shape(path_imgrec, data_shape) -> bool:
    """Whether the first record's JPEG is ``data_shape``'s (H, W): where
    the native decode-to-shape and the Python augmenters agree."""
    from . import io_native
    from .recordio import MXRecordIO, unpack
    try:
        rec = MXRecordIO(path_imgrec, "r")
        try:
            raw = rec.read()
        finally:
            rec.close()
    except (OSError, struct.error):
        return False
    if raw is None:
        return False
    dims = io_native.jpeg_dimensions(unpack(raw)[1])
    return dims is not None and dims == tuple(data_shape[1:])


class PrefetchingIter(DataIter):
    """Keeps ``prefetch_depth`` fetches of an iterator in flight on the
    `engine` (reference `io.py:PrefetchingIter`, `iter_prefetcher.h`).

    Each fetch is a push with one mutable variable, so fetches run in
    order; under ``MXNET_ENGINE_TYPE=NaiveEngine`` each completes as it is
    pushed.  ``prefetch_depth`` defaults to ``MXTPU_PREFETCH_DEPTH``.  A
    staged batch is handed over to the stream of the thread that calls
    `next`."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=None, engine=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter == 1, "only one iter supported currently"
        self.iters = iters
        if prefetch_depth is None:
            prefetch_depth = int(get_env("MXTPU_PREFETCH_DEPTH"))
        self.prefetch_depth = max(1, int(prefetch_depth))
        if engine is None:
            from .engine import get_engine
            engine = get_engine()
        self._engine = engine
        self._var = engine.new_variable()
        self._futures = deque()
        self._started = False
        self._exhausted = False

    @property
    def provide_data(self):
        return self.iters[0].provide_data

    @property
    def provide_label(self):
        return self.iters[0].provide_label

    def _fetch_one(self):
        # tagged, not raised: under NaiveEngine the push resolves inline
        try:
            return ("data", _staged_next(self.iters[0]))
        except StopIteration:
            return ("end", None)
        except Exception as e:  # noqa: BLE001  (raised again by `next`)
            return ("err", e)

    def _schedule(self):
        self._futures.append(
            self._engine.push(self._fetch_one, mutable_vars=[self._var]))

    def _drain(self):
        while self._futures:
            self._futures.popleft().result()

    def reset(self):
        self._drain()  # fetches in flight still use the inner iterator
        self.iters[0].reset()
        self._exhausted = False
        for _ in range(self.prefetch_depth):
            self._schedule()
        self._started = True

    def next(self):
        if not self._started:
            self.reset()
        while self._futures:
            kind, payload = self._futures.popleft().result()
            if kind == "data":
                if not self._exhausted:
                    self._schedule()
                return _hand_over(payload)
            if kind == "err":
                self._started = False
                self._drain()
                raise payload
            # the end: every fetch still queued is past it too
            self._exhausted = True
            self._drain()
        self._started = False
        raise StopIteration


class ResizeIter(DataIter):
    """``size`` batches an epoch from ``data_iter``, which restarts when
    it runs out (reference `io.py:ResizeIter`)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class MXDataIter(DataIter):
    """The base of the natively backed iterators (reference
    `io.py:MXDataIter`): ``isinstance(it, MXDataIter)`` tells them
    apart."""

    def debug_skip_load(self):
        """From now on serve the first batch again and again, so that a
        benchmark times the step without the loading (reference
        `MXDataIter.debug_skip_load`)."""
        self._debug_skip_load = True
        self._debug_first_batch = None
        staged = getattr(self, "_staged_next", self.next)

        def skip_staged():
            if self._debug_first_batch is None:
                self._debug_first_batch = staged()
            return self._debug_first_batch

        self._staged_next = skip_staged
        self.next = lambda: _hand_over(skip_staged())
        logging.info("Set debug_skip_load to be true, will simply return "
                     "first batch")


class NativeImageRecordIter(MXDataIter):
    """A RecordIO file of JPEGs decoded by the native library's thread
    pool (the counterpart of the JAX package's iterator and of the
    reference's `ImageRecordIOParser2`).

    Each batch decodes to ``data_shape`` straight into a pinned uint8
    NHWC staging buffer, and the device step casts, mirrors
    (``rand_mirror``), normalizes and transposes it on the card
    (`_Stager`): 1 byte a pixel crosses the bus instead of 4.  Shuffle
    and mirror draws come from numpy streams seeded by ``seed`` and
    ``seed_aug`` (the JAX package's, so both give the same batches).
    Batches land on the current context of the construction."""

    def __init__(self, path_imgrec, data_shape=(3, 224, 224),
                 batch_size=128, shuffle=False, rand_mirror=False,
                 mean=None, std=None, preprocess_threads=0, label_width=1,
                 data_name="data", label_name="softmax_label",
                 round_batch=True, seed=0, seed_aug=None, num_parts=1,
                 part_index=0, fast_decode=None, output_layout="NCHW",
                 **kwargs):
        super().__init__(batch_size)
        if kwargs:
            raise MXNetError(
                f"NativeImageRecordIter does not support {sorted(kwargs)}; "
                "use ImageRecordIter/ImageIter for these options")
        from . import io_native
        from .recordio import MXIndexedRecordIO, scan_record_offsets
        if not io_native.decode_available():
            raise MXNetError("native JPEG decoder unavailable")
        self._ion = io_native
        self._round_batch = round_batch
        self.data_shape = tuple(data_shape)
        self._shuffle = shuffle
        self._mirror = rand_mirror
        if not preprocess_threads:
            preprocess_threads = int(get_env("MXNET_CPU_WORKER_NTHREADS", 0))
        self._threads = preprocess_threads
        self._fast_decode = fast_decode
        self.label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        if mean is True:
            mean = np.array([123.68, 116.28, 103.53], np.float32)
        if std is True:
            std = np.array([58.395, 57.12, 57.375], np.float32)
        self._mean = (np.zeros((1,), np.float32) if mean is None
                      else np.asarray(mean, np.float32).reshape(-1))
        self._std = (np.ones((1,), np.float32) if std is None
                     else np.asarray(std, np.float32).reshape(-1))
        if output_layout not in ("NCHW", "NHWC"):
            raise MXNetError(f"unsupported output_layout {output_layout!r}")
        self._layout = output_layout
        self._seed_aug = seed_aug
        self._aug_rng = None
        self.ctx = default_context("NativeImageRecordIter")
        self._stager = _Stager(self.ctx.device,
                               int(get_env("MXTPU_PREFETCH_DEPTH")) + 1)
        idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
        self._rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
        if not self._rec.keys:
            for k, offset in enumerate(scan_record_offsets(path_imgrec)):
                self._rec.idx[k] = offset
                self._rec.keys.append(k)
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._keys = list(_partition(list(self._rec.keys), num_parts,
                                     part_index))
        self._rng = np.random.RandomState(seed)
        self._cursor = 0
        self.reset()

    def repartition(self, num_parts, part_index):
        """Reshard the record keys for a new worker set and rewind; the
        file, the decode pool and the random streams are kept."""
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._keys = list(_partition(list(self._rec.keys), num_parts,
                                     part_index))
        self.reset()

    @property
    def provide_data(self):
        c, h, w = self.data_shape
        if self._layout == "NHWC":
            return [DataDesc(self._data_name, (self.batch_size, h, w, c),
                             layout="NHWC")]
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self._cursor = 0
        if self._seed_aug is not None:
            self._aug_rng = np.random.RandomState(self._seed_aug)
        if self._shuffle:
            self._rng.shuffle(self._keys)

    def _staged_next(self) -> DataBatch:
        from .recordio import unpack
        if self._cursor >= len(self._keys):
            raise StopIteration
        c, h, w = self.data_shape
        keys = self._keys[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        bufs, labels = [], []
        for k in keys:
            header, buf = unpack(self._rec.read_idx(k))
            bufs.append(buf)
            labels.append(np.asarray(header.label, np.float32).reshape(-1)
                          [:self.label_width])
        n_out = self.batch_size if self._round_batch else len(keys)
        slot = self._stager.slot(n_out, (h, w, c), self.label_width)
        slot.data[len(bufs):] = 0
        slot.label[len(bufs):] = 0
        slot.label[:len(bufs)] = np.stack(labels)
        _, ok = self._ion.decode_jpeg_batch(bufs, h, w, c, self._threads,
                                            fast=self._fast_decode,
                                            out=slot.data[:len(bufs)])
        if not ok.all():
            bad = [keys[i] for i in np.nonzero(~ok)[0]]
            raise IOError(f"JPEG decode failed for record ids {bad}: "
                          "corrupt records")
        if self._mirror:
            rng = self._aug_rng if self._aug_rng is not None else self._rng
            slot.flip[:] = rng.rand(n_out) < 0.5
        else:
            slot.flip[:] = False
        return _staged_batch(self._stager, slot, n_out - len(keys),
                             self._mean, self._std, self.label_width,
                             self._layout)

    def next(self):
        return _hand_over(self._staged_next())

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self
