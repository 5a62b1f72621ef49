"""A BERT encoder as an MXNet symbol graph.

`bert_encoder` takes the ``sym`` module it builds with, so the same code
builds the same graph (and the same JSON) with `mxnet_tpu.sym` and with
`mxnet_tpu_torch.sym`.

`BERT_BASE` holds BERT-base's published widths (google-research/bert,
``uncased_L-12_H-768_A-12/bert_config.json``): hidden 768, 12 layers, 12
heads of 64, intermediate 3072 with erf-GELU, vocab 30522, 512 positions,
LayerNorm eps 1e-12.

The graph takes ``data`` (B, L) token ids and ``positions`` (1, L)
position ids, both as floats, and returns the last hidden state
(B, L, hidden); there is no pooler and no token-type embedding (a single
segment).  Each layer splits heads with reshape/transpose into
(B·H, L, d) as GluonNLP's BERT did and computes attention as
``batch_dot(softmax(_mul_scalar(batch_dot(q, k, transpose_b=True))), v)``,
the idiom `graph_opt`'s ``pallas_select`` pass rewrites onto the
flash-attention kernel.  Dropout nodes (identity at inference) stand where
BERT applies dropout, except on the attention probabilities, where a node
would hide the idiom from the pass.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

__all__ = ["BERT_BASE", "bert_encoder", "random_params"]

BERT_BASE = dict(num_layers=12, hidden=768, heads=12, ffn=3072, vocab=30522,
                 max_len=512, eps=1e-12)


def bert_encoder(sym, num_layers: int, hidden: int, heads: int, ffn: int,
                 vocab: int, max_len: int, eps: float = 1e-12,
                 dropout: float = 0.1):
    """The encoder graph, built with ``sym`` (either package's)."""
    d = hidden // heads
    x = sym.broadcast_add(
        sym.Embedding(sym.var("data"), input_dim=vocab, output_dim=hidden,
                      name="word_embed"),
        sym.Embedding(sym.var("positions"),
                      sym.var("position_embed_weight",
                              shape=(max_len, hidden)),
                      input_dim=max_len, output_dim=hidden,
                      name="position_embed"),
        name="embed_add")
    x = sym.LayerNorm(x, eps=eps, name="embed_ln")
    x = sym.Dropout(x, p=dropout, name="embed_drop")
    for i in range(num_layers):
        p = f"layer{i}_"

        def split_heads(t, n):
            # (B, L, hidden) -> (B, L, H, d) -> (B, H, L, d) -> (B*H, L, d)
            t = sym.reshape(t, shape=(0, 0, heads, d), name=p + n + "_split")
            t = sym.transpose(t, axes=(0, 2, 1, 3), name=p + n + "_heads")
            return sym.reshape(t, shape=(-3, 0, 0), name=p + n + "_merge")

        q, k, v = (split_heads(sym.FullyConnected(
            x, num_hidden=hidden, flatten=False, name=p + n), n)
            for n in ("query", "key", "value"))
        s = sym.batch_dot(q, k, transpose_b=True, name=p + "score")
        s = sym._mul_scalar(s, scalar=d ** -0.5, name=p + "scale")
        a = sym.softmax(s, axis=-1, name=p + "softmax")
        o = sym.batch_dot(a, v, name=p + "context")
        # (B*H, L, d) -> (B, H, L, d) -> (B, L, H, d) -> (B, L, hidden)
        o = sym.reshape(o, shape=(-4, -1, heads, 0, 0), name=p + "ctx_split")
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
    return x


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
