"""Legacy symbolic RNN API (the counterpart of `mxnet_tpu/rnn/`): cells
build Symbol graphs for `Predictor`, `Module` and `BucketingModule`;
`rnn` saves and loads their checkpoints and `io` feeds them bucketed
sentences."""
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams,
                       SequentialRNNCell, ZoneoutCell)
from .rnn import (do_rnn_checkpoint, load_rnn_checkpoint, rnn_unroll,
                  save_rnn_checkpoint)
from .io import BucketSentenceIter, encode_sentences

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell", "RNNParams",
           "rnn_unroll", "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint", "BucketSentenceIter", "encode_sentences"]
