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

`foreach_lm` is the same model with its time loop written as one
``sym.contrib.foreach`` scan over the cells (the reference's canonical use
of ``foreach``), with the same parameter names, so the weights it trains
serve on `lstm_lm`.  `lstm_step` is one step of the stack as a function of
``F`` (``sym`` or ``nd``), and `greedy_decoder` the greedy decode as a
``sym.contrib.while_loop`` over it.
"""
from __future__ import annotations

__all__ = ["PTB_LSTM", "lstm_lm", "foreach_lm", "lstm_step",
           "greedy_decoder", "lm_weight_names"]

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


def foreach_lm(mx, seq_len: int, batch: int, num_layers: int = 2,
               num_hidden: int = 200, num_embed: int = 200,
               vocab: int = 10000):
    """The LM's logits ``pred`` (batch·seq_len, vocab), rows in (batch,
    step) order as `lstm_lm`'s, with the time loop as
    ``sym.contrib.foreach(body, embed_TNC, [h0, c0, h1, c1, ...])``: the
    body steps every `rnn.LSTMCell` of the stack; the begin states are
    zeros of (batch, num_hidden).  Callers add the head."""
    sym = mx.sym
    embed = sym.Embedding(sym.var("data"), input_dim=vocab,
                          output_dim=num_embed, name="embed")
    steps = sym.transpose(embed, axes=(1, 0, 2))
    cells = [mx.rnn.LSTMCell(num_hidden=num_hidden, prefix=f"lstm_l{i}_")
             for i in range(num_layers)]
    init = [sym.zeros(shape=(batch, num_hidden), name=f"lstm_begin{k}")
            for k in range(2 * num_layers)]

    def body(item, states):
        h, new = item, []
        for i, cell in enumerate(cells):
            h, st = cell(h, states[2 * i:2 * i + 2])
            new.extend(st)
        return h, new

    outs, _ = sym.contrib.foreach(body, steps, init, name="lstm_scan")
    outs = sym.transpose(outs, axes=(1, 0, 2))
    pred = sym.Reshape(outs, shape=(-1, num_hidden))
    return sym.FullyConnected(pred, num_hidden=vocab, name="pred")


def lm_weight_names(num_layers: int = 2):
    """The LM's parameter names: the embedding, each layer's i2h and h2h
    weights and biases, the decoder."""
    names = ["embed_weight"]
    for i in range(num_layers):
        names += [f"lstm_l{i}_{k}" for k in
                  ("i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias")]
    return names + ["pred_weight", "pred_bias"]


def lstm_step(F, tok, states, w, num_layers, num_hidden, num_embed, vocab):
    """One greedy step of the LM with ``F`` (``sym`` or ``nd``): embed
    ``tok`` (batch,), step every cell as `rnn.LSTMCell` does, the decoder
    FC and its argmax.  ``w`` maps `lm_weight_names` to variables or
    arrays.  Returns ``(next token, new states)``."""
    x = F.Embedding(tok, w["embed_weight"], input_dim=vocab,
                    output_dim=num_embed)
    new = []
    for i in range(num_layers):
        p = f"lstm_l{i}_"
        h, c = states[2 * i], states[2 * i + 1]
        gates = F.FullyConnected(x, w[p + "i2h_weight"], w[p + "i2h_bias"],
                                 num_hidden=4 * num_hidden) + \
            F.FullyConnected(h, w[p + "h2h_weight"], w[p + "h2h_bias"],
                             num_hidden=4 * num_hidden)
        g = F.SliceChannel(gates, num_outputs=4)
        next_c = F.Activation(g[1], act_type="sigmoid") * c + \
            F.Activation(g[0], act_type="sigmoid") * \
            F.Activation(g[2], act_type="tanh")
        x = F.Activation(g[3], act_type="sigmoid") * \
            F.Activation(next_c, act_type="tanh")
        new += [x, next_c]
    logits = F.FullyConnected(x, w["pred_weight"], w["pred_bias"],
                              num_hidden=vocab)
    return F.argmax(logits, axis=1), new


def greedy_decoder(mx, max_iterations: int, num_layers: int = 2,
                   num_hidden: int = 200, num_embed: int = 200,
                   vocab: int = 10000):
    """Greedy decoding as ``sym.contrib.while_loop``: the loop variables
    are the token (``tok``, batch), the step count (``i``, (1,)) and the
    cells' states (``s0``, ``s1``, ... of (batch, num_hidden)); the
    condition is ``i < n_steps`` with ``n_steps`` a data input of (1,).
    Outputs: the tokens (max_iterations, batch), zero past ``n_steps``,
    then the final loop variables."""
    sym = mx.sym
    w = {n: sym.var(n) for n in lm_weight_names(num_layers)}
    n_steps = sym.var("n_steps")
    loop = [sym.var("tok"), sym.var("i")] + \
        [sym.var(f"s{k}") for k in range(2 * num_layers)]

    def cond(tok, i, *states):
        return i < n_steps

    def func(tok, i, *states):
        nxt, new = lstm_step(sym, tok, list(states), w, num_layers,
                             num_hidden, num_embed, vocab)
        return nxt, [nxt, i + 1.0] + new

    toks, final = sym.contrib.while_loop(cond, func, loop,
                                         max_iterations=max_iterations,
                                         name="decode")
    return sym.Group([toks] + final)
