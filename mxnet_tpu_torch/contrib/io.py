"""Contrib data iterators (the counterpart of `mxnet_tpu/contrib/io.py`;
reference ``python/mxnet/contrib/io.py``): adapt a gluon ``DataLoader`` to the
``DataIter`` interface so gluon pipelines feed symbolic Modules."""
import numpy as np

from ..io import DataBatch, DataDesc, DataIter

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """Iterate a ``gluon.data.DataLoader`` as a classic DataIter
    (reference `contrib/io.py:25-95`): peeks one batch for
    provide_data/provide_label, casts to ``dtype``."""

    def __init__(self, loader, data_name='data',
                 label_name='softmax_label', dtype='float32'):
        data, label = next(iter(loader))
        super().__init__(batch_size=data.shape[0])
        self._loader = loader
        self.dtype = dtype
        self.provide_data = [DataDesc(data_name, tuple(data.shape),
                                      np.dtype(dtype))]
        self.provide_label = [DataDesc(label_name, tuple(label.shape),
                                       np.dtype(dtype))]
        self._iter = iter(self._loader)
        self._current_batch = None

    def reset(self):
        self._iter = iter(self._loader)

    def iter_next(self):
        try:
            self._current_batch = next(self._iter)
        except StopIteration:
            self._current_batch = None
        return self._current_batch is not None

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data, label = self._current_batch
        return DataBatch(data=[self.getdata()], label=[self.getlabel()],
                         pad=self.getpad(), index=self.getindex(),
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def getdata(self):
        return self._current_batch[0].astype(self.dtype)

    def getlabel(self):
        return self._current_batch[1].astype(self.dtype)

    def getpad(self):
        return 0

    def getindex(self):
        return None
