"""Legacy symbolic RNN API (the counterpart of `mxnet_tpu/rnn/`): cells
build Symbol graphs for `Predictor` and `Module`."""
from .rnn_cell import BaseRNNCell, LSTMCell, RNNParams, SequentialRNNCell

__all__ = ["BaseRNNCell", "LSTMCell", "SequentialRNNCell", "RNNParams"]
