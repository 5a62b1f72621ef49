"""gluon.contrib.data (the counterpart of `mxnet_tpu/gluon/contrib/data/`;
reference `python/mxnet/gluon/contrib/data/`)."""
from .sampler import IntervalSampler

__all__ = ["IntervalSampler"]
