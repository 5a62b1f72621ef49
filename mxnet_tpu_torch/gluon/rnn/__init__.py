"""Recurrent cells and layers (the counterpart of `mxnet_tpu/gluon/rnn`;
reference `python/mxnet/gluon/rnn/`)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, LSTMCell, RecurrentCell,
                       ResidualCell, RNNCell, SequentialRNNCell,
                       ZoneoutCell, _ModifierCell)
from .rnn_layer import GRU, LSTM, RNN

# public in the reference (the base of the Zoneout and Residual wrappers)
ModifierCell = _ModifierCell


class HybridSequentialRNNCell(SequentialRNNCell, HybridRecurrentCell):
    """The reference's `HybridSequentialRNNCell`.  Its step calls each
    child in turn, as `SequentialRNNCell`'s does, and as in the JAX
    package ``hybridize()`` leaves it so: the stack itself is never one
    captured call."""

    def hybridize(self, active=True, **kwargs):
        pass


__all__ = ["RNN", "LSTM", "GRU", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "HybridRecurrentCell", "RecurrentCell",
           "HybridSequentialRNNCell", "ModifierCell"]
