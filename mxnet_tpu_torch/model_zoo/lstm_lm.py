"""MXNet's PTB LSTM language model (the reference's
``example/rnn/bucketing/lstm_bucketing.py``) as a symbol graph.

`lstm_lm` takes the package it builds with (its ``sym`` and ``rnn``), so
the same code builds the same graph, and the same JSON, with `mxnet_tpu`
and with `mxnet_tpu_torch`.  It is that example's ``sym_gen(seq_len)``:

1. ``Embedding(data, input_dim=vocab, output_dim=num_embed, name="embed")``;
2. a `rnn.SequentialRNNCell` of ``num_layers`` `rnn.LSTMCell` (prefixes
   ``lstm_l0_``, ``lstm_l1_``, ...) unrolled over ``seq_len`` steps with
   ``merge_outputs=True`` and zero begin states derived from the input;
3. ``Reshape(shape=(-1, num_hidden))``;
4. ``FullyConnected(num_hidden=vocab, name="pred")``;

served with ``softmax(pred, axis=-1)`` as the head: the value the
example's ``SoftmaxOutput`` gives at inference, with no label input.

`PTB_LSTM` holds the example's defaults (``--num-layers 2 --num-hidden 200
--num-embed 200``) and PTB's 10,000-word vocabulary.  The data is (batch,
seq_len) token ids as floats; the output is (batch·seq_len, vocab)
probabilities.  Every step of a layer shares that layer's
``lstm_l<i>_{i2h,h2h}_{weight,bias}``, so one `.params` blob serves every
bucket (one `Predictor` per ``seq_len``, as `BucketingModule` binds one
executor per bucket).  Weights come from `random_params`.
"""
from __future__ import annotations

__all__ = ["PTB_LSTM", "lstm_lm"]

PTB_LSTM = dict(num_layers=2, num_hidden=200, num_embed=200, vocab=10000)


def lstm_lm(mx, seq_len: int, num_layers: int = 2, num_hidden: int = 200,
            num_embed: int = 200, vocab: int = 10000):
    """The bucket graph for ``seq_len``, built with package ``mx``."""
    embed = mx.sym.Embedding(mx.sym.var("data"), input_dim=vocab,
                             output_dim=num_embed, name="embed")
    stack = mx.rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(mx.rnn.LSTMCell(num_hidden=num_hidden,
                                  prefix=f"lstm_l{i}_"))
    outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
    pred = mx.sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = mx.sym.FullyConnected(pred, num_hidden=vocab, name="pred")
    return mx.sym.softmax(pred, axis=-1, name="softmax")
