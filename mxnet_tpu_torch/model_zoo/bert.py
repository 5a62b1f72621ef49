"""BERT as an MXNet symbol graph: the encoder, and the encoder under
BERT's masked-LM head for pretraining.

`bert_encoder` and `bert_mlm` take the ``sym`` module they build with, so
the same code builds the same graph (and the same JSON) with
`mxnet_tpu.sym` and with `mxnet_tpu_torch.sym`.

`BERT_BASE` holds BERT-base's published widths (google-research/bert,
``uncased_L-12_H-768_A-12/bert_config.json``): hidden 768, 12 layers, 12
heads of 64, intermediate 3072 with erf-GELU, vocab 30522, 512 positions,
LayerNorm eps 1e-12.

The encoder takes ``data`` (B, L) token ids and ``positions`` (1, L)
position ids, both as floats, and returns the last hidden state
(B, L, hidden); there is no pooler and no token-type embedding (a single
segment).  Attention comes in two spellings:

* ``"batch_dot"`` (the default): heads split with reshape/transpose into
  (B·H, L, d) as GluonNLP's BERT did, and
  ``batch_dot(softmax(_mul_scalar(batch_dot(q, k, transpose_b=True))), v)``,
  the idiom `graph_opt`'s ``pallas_select`` pass rewrites onto the
  flash-attention kernel at inference;
* ``"fused"``: the `_fused_attention` op itself on [B, H, L, d] (from
  ``reshape(0, 0, H, d)`` + ``transpose(0, 2, 1, 3)``), for training, whose
  pass list swaps nothing in.  Its gradient is the attention backward
  kernels'.

Dropout nodes stand where BERT applies dropout (``hidden_dropout_prob``),
identity at inference.  Neither spelling drops attention probabilities:
the flash-attention kernels, in either package, have no dropout on them,
and a node there would hide the idiom from the pass.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

__all__ = ["BERT_BASE", "bert_encoder", "bert_mlm", "random_params"]

BERT_BASE = dict(num_layers=12, hidden=768, heads=12, ffn=3072, vocab=30522,
                 max_len=512, eps=1e-12)


def bert_encoder(sym, num_layers: int, hidden: int, heads: int, ffn: int,
                 vocab: int, max_len: int, eps: float = 1e-12,
                 dropout: float = 0.1, attention: str = "batch_dot",
                 dtype: str = "float32"):
    """The encoder graph, built with ``sym`` (either package's)."""
    return _encoder(sym, num_layers, hidden, heads, ffn, vocab, max_len, eps,
                    dropout, attention, dtype)[0]


def _encoder(sym, num_layers, hidden, heads, ffn, vocab, max_len, eps,
             dropout, attention, dtype):
    """The encoder's output and its word-embedding table variable.  A
    ``dtype`` other than float32 (``"bfloat16"``, ``"float16"``) makes
    both embedding tables and their outputs that dtype, and so every
    weight after them (`Symbol.infer_type`)."""
    if attention not in ("batch_dot", "fused"):
        raise ValueError(f"attention must be 'batch_dot' or 'fused', got "
                         f"{attention!r}")
    d = hidden // heads
    typed = {} if dtype == "float32" else {"dtype": dtype}
    word_weight = sym.var("word_embed_weight", **typed)
    x = sym.broadcast_add(
        sym.Embedding(sym.var("data"), word_weight, input_dim=vocab,
                      output_dim=hidden, name="word_embed", **typed),
        sym.Embedding(sym.var("positions"),
                      sym.var("position_embed_weight",
                              shape=(max_len, hidden), **typed),
                      input_dim=max_len, output_dim=hidden,
                      name="position_embed", **typed),
        name="embed_add")
    x = sym.LayerNorm(x, eps=eps, name="embed_ln")
    x = sym.Dropout(x, p=dropout, name="embed_drop")
    for i in range(num_layers):
        p = f"layer{i}_"

        def split_heads(t, n):
            # (B, L, hidden) -> (B, L, H, d) -> (B, H, L, d) [-> (B*H, L, d)]
            t = sym.reshape(t, shape=(0, 0, heads, d), name=p + n + "_split")
            t = sym.transpose(t, axes=(0, 2, 1, 3), name=p + n + "_heads")
            if attention == "fused":
                return t
            return sym.reshape(t, shape=(-3, 0, 0), name=p + n + "_merge")

        q, k, v = (split_heads(sym.FullyConnected(
            x, num_hidden=hidden, flatten=False, name=p + n), n)
            for n in ("query", "key", "value"))
        if attention == "fused":
            o = sym._fused_attention(q, k, v, scale=d ** -0.5,
                                     name=p + "attention")
        else:
            s = sym.batch_dot(q, k, transpose_b=True, name=p + "score")
            s = sym._mul_scalar(s, scalar=d ** -0.5, name=p + "scale")
            a = sym.softmax(s, axis=-1, name=p + "softmax")
            o = sym.batch_dot(a, v, name=p + "context")
            # (B*H, L, d) -> (B, H, L, d)
            o = sym.reshape(o, shape=(-4, -1, heads, 0, 0),
                            name=p + "ctx_split")
        # (B, H, L, d) -> (B, L, H, d) -> (B, L, hidden)
        o = sym.transpose(o, axes=(0, 2, 1, 3), name=p + "ctx_heads")
        o = sym.reshape(o, shape=(0, 0, -1), name=p + "ctx_merge")
        o = sym.FullyConnected(o, num_hidden=hidden, flatten=False,
                               name=p + "attn_out")
        o = sym.Dropout(o, p=dropout, name=p + "attn_drop")
        x = sym.LayerNorm(sym.broadcast_add(x, o, name=p + "attn_res"),
                          eps=eps, name=p + "ln1")
        h = sym.FullyConnected(x, num_hidden=ffn, flatten=False,
                               name=p + "ffn1")
        h = sym.LeakyReLU(h, act_type="gelu", name=p + "gelu")
        h = sym.FullyConnected(h, num_hidden=hidden, flatten=False,
                               name=p + "ffn2")
        h = sym.Dropout(h, p=dropout, name=p + "ffn_drop")
        x = sym.LayerNorm(sym.broadcast_add(x, h, name=p + "ffn_res"),
                          eps=eps, name=p + "ln2")
    return x, word_weight


def bert_mlm(sym, num_layers: int, hidden: int, heads: int, ffn: int,
             vocab: int, max_len: int, eps: float = 1e-12,
             dropout: float = 0.1, attention: str = "fused",
             dtype: str = "float32"):
    """BERT's masked-LM pretraining graph, built with ``sym``: the encoder
    (attention ``"fused"`` by default), then BERT's MLM head — dense +
    GELU + LayerNorm, and a decoder onto the vocabulary whose weight is
    the word-embedding table (tied) with a bias of its own — and
    `SoftmaxOutput` over (B·L, vocab).

    The label ``mlm_label`` (B, L) holds the token id at the masked
    positions and -1 elsewhere (``use_ignore``, ``ignore_label=-1``,
    ``normalization='valid'``): the loss and its gradient average over the
    masked positions only, as BERT's and HuggingFace ``BertForMaskedLM``'s
    full-sequence loss do.  The output is the (B·L, vocab) probabilities;
    its gradient is SoftmaxOutput's defined one.  ``dtype`` as
    `bert_encoder`'s: ``"bfloat16"`` is the mixed-precision graph whose
    weights an optimizer with ``multi_precision`` keeps float32 master
    copies of."""
    x, word_weight = _encoder(sym, num_layers, hidden, heads, ffn, vocab,
                              max_len, eps, dropout, attention, dtype)
    h = sym.FullyConnected(x, num_hidden=hidden, flatten=False,
                           name="mlm_transform")
    h = sym.LeakyReLU(h, act_type="gelu", name="mlm_gelu")
    h = sym.LayerNorm(h, eps=eps, name="mlm_ln")
    logits = sym.FullyConnected(h, word_weight, num_hidden=vocab,
                                flatten=False, name="mlm_decoder")
    logits = sym.reshape(logits, shape=(-1, vocab), name="mlm_flat")
    label = sym.reshape(sym.var("mlm_label"), shape=(-1,),
                        name="mlm_label_flat")
    return sym.SoftmaxOutput(logits, label, use_ignore=True,
                             ignore_label=-1, normalization="valid",
                             name="mlm")


def random_params(shapes: Mapping[str, Sequence[int]],
                  seed: int) -> Dict[str, np.ndarray]:
    """float32 weights from ``numpy.random.RandomState(seed)``, drawn in
    the order of ``shapes``: LayerNorm gammas near 1, betas and biases
    near 0, matrices with variance 1/fan-in."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        if name.endswith("_gamma"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith(("_beta", "_bias")):
            a = 0.1 * rng.randn(*shape)
        else:
            a = rng.randn(*shape) / np.sqrt(shape[-1])
        out[name] = a.astype(np.float32)
    return out
