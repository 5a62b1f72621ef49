"""The long-context causal LM of `example/long_context/train_ring_lm.py`,
trained with ring-attention sequence parallelism: its parameter dict
(``emb``, ``pos``, ``wqkv``, ``wo``, ``wff``, ``wout``), its forward and
loss, and its Adam step.

The forward runs as one `shard_map` body over the ``sp`` axis: each rank
embeds its block of the sequence (positions sliced by its sp index),
projects q, k and v, runs `parallel.ring_attention_shard` (K1 on every
hop, K2/K3 in the backward), and scores its positions; the loss is the
``psum`` of the ranks' shares.  The task is the example's synthetic
needle retrieval: every position predicts the token at position 0,
position 0 itself unscored.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..parallel import collectives as C
from ..parallel.mesh import SP, Mesh
from ..parallel.ring_attention import ring_attention_shard
from ..parallel.sharding import PartitionSpec as P

__all__ = ["RING_LM_NAMES", "ring_lm_numpy_params", "ring_lm_loss",
           "ring_lm_adam", "needle_batch"]

RING_LM_NAMES = ("emb", "pos", "wqkv", "wo", "wff", "wout")


def ring_lm_numpy_params(seed: int, vocab: int, dim: int,
                         seq_len: int) -> Dict[str, np.ndarray]:
    """Random weights from ``seed`` at the example's scales (N(0, 1/dim)
    entries), as numpy (`serialization.tree_from_numpy` carries them)."""
    rs = np.random.RandomState(seed)
    s = dim ** -0.5
    shapes = {"emb": (vocab, dim), "pos": (seq_len, dim),
              "wqkv": (dim, 3 * dim), "wo": (dim, dim), "wff": (dim, dim),
              "wout": (dim, vocab)}
    return {n: (rs.randn(*shapes[n]) * s).astype(np.float32)
            for n in RING_LM_NAMES}


def needle_batch(rs: np.random.RandomState, batch: int, seq_len: int,
                 vocab: int):
    """(tokens, targets): random tokens; every target is the row's first
    token (the needle)."""
    t = rs.randint(0, vocab, (batch, seq_len))
    return t, np.ascontiguousarray(np.broadcast_to(t[:, :1], t.shape))


def _ln(x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def ring_lm_loss(params, tokens, targets, mesh: Mesh, heads: int,
                 axis: str = SP, use_flash: Optional[bool] = None):
    """(loss, logits): the mean negative log-likelihood of positions
    1..L-1 and the [B, L, vocab] logits, both global on every rank, for
    global ``tokens`` and ``targets`` [B, L] (int64) with L split over
    ``axis`` of ``mesh``.  Differentiable in ``params``."""
    b, seq_len = tokens.shape
    dim = params["emb"].shape[1]
    hd = dim // heads

    def body(p, tok, tgt):
        n, r = C.axis_size(axis), C.axis_index(axis)
        ll = tok.shape[1]
        x = p["emb"][tok] + p["pos"][r * ll:(r + 1) * ll][None]
        q, k, v = (_ln(x) @ p["wqkv"]).split(dim, dim=-1)

        def split_heads(t):
            return t.reshape(b, ll, heads, hd).transpose(1, 2).contiguous()

        o = ring_attention_shard(split_heads(q), split_heads(k),
                                 split_heads(v), axis_name=axis,
                                 causal=True, use_flash=use_flash)
        o = o.transpose(1, 2).reshape(b, ll, dim)
        x = x + o @ p["wo"]
        x = x + torch.relu(_ln(x) @ p["wff"])
        logits = _ln(x) @ p["wout"]
        nll = -torch.log_softmax(logits, -1).gather(
            -1, tgt[..., None])[..., 0]
        scored = (torch.arange(ll, device=tok.device) + r * ll) >= 1
        part = (nll * scored).sum() / (b * (seq_len - 1))
        return C.psum(part, axis), logits

    spec = P(None, axis)
    return C.shard_map(body, mesh=mesh, in_specs=(P(), spec, spec),
                       out_specs=(P(), P(None, axis, None)))(
        params, tokens, targets)


def ring_lm_adam(params, grads, state, t: int, lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """The example's Adam step in place: ``state`` is ``(m, v)``, dicts
    like ``params`` (zeros at first), ``t`` the 1-based step."""
    m, v = state
    with torch.no_grad():
        for n, p in params.items():
            g = grads[n]
            m[n].mul_(b1).add_((1 - b1) * g)
            v[n].mul_(b2).add_((1 - b2) * g * g)
            mh = m[n] / (1 - b1 ** t)
            vh = v[n] / (1 - b2 ** t)
            p.sub_(lr * mh / (torch.sqrt(vh) + eps))
    return params, state
