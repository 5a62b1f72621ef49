"""Data descriptors (the counterparts of `DataDesc` and `DataBatch` in
`mxnet_tpu/io.py`; reference `python/mxnet/io/io.py`).  The iterators
(`NDArrayIter` and the rest) come with ``Module.fit``."""
from __future__ import annotations

from collections import namedtuple

import numpy as np

__all__ = ["DataDesc", "DataBatch"]


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
