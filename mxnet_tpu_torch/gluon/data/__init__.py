"""Gluon data API (the counterpart of `mxnet_tpu/gluon/data`; reference
`python/mxnet/gluon/data/`): datasets, samplers, the `DataLoader` and the
vision datasets and transforms.  Samples and batches live on the host;
a training loop moves each batch to the card (`NDArray.as_in_context`,
`gluon.utils.split_and_load`).  `RecordFileDataset` waits for
`recordio.py`."""
from .dataset import ArrayDataset, Dataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader, default_batchify_fn
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "default_batchify_fn", "vision"]
