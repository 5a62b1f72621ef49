"""gluon.contrib (the counterpart of `mxnet_tpu/gluon/contrib/`; reference
`python/mxnet/gluon/contrib/`): experimental
layers and cells — Concurrent containers, SparseEmbedding, SyncBatchNorm,
VariationalDropoutCell, Conv2D RNN/LSTM/GRU cells."""
from . import data
from . import nn
from . import rnn

__all__ = ["data", "nn", "rnn"]
