"""Ring attention: exact attention over a sequence split across ranks
(the counterpart of `mxnet_tpu/parallel/ring_attention.py`).

* `ring_attention_shard` is a rank's body: its query block stays, the
  K/V blocks rotate around the ``sp`` axis by ``ppermute`` (one
  ``batch_isend_irecv`` a hop), and each hop's (output, row logsumexp)
  is merged into the running result by `_merge_norm` in fp32.  Each
  hop's block is the port's K1, ``hopper_kernels.flash_attention_with_
  lse`` (its plain version on a CPU tensor); its backward is K2/K3, and
  because the merge reads the logsumexp, the hops' lse cotangent is
  nonzero.  ``MXTPU_RING_FLASH=0`` (or ``use_flash=False``) takes the
  plain `_block_attn` path, the consistency oracle.
* In a causal ring a hop's K/V block is either fully visible (its
  source precedes this rank), the diagonal (causal inside) or fully
  masked.  The JAX package dispatches on the traced source index; here
  the rank is known on the host, so a masked hop launches nothing and
  adds weight 0 (the merge leaves the result exactly as it was).  A rank
  at sp index r launches K1 r + 1 times a call (n without ``causal``).
* `ring_attention` wraps the body in `shard_map`: global q, k, v in,
  the global output on every rank.
* `ulysses_attention` trades the sequence split for a head split by
  ``all_to_all``, runs `local_attention` and trades back; like the JAX
  package's, it computes with einsum and softmax (no kernel).

Layouts are (batch, heads, seq, head_dim), the sequence split over sp.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import config
from . import collectives as C
from .mesh import SP, Mesh
from .sharding import PartitionSpec as P

__all__ = ["ring_attention", "ring_attention_shard", "ulysses_attention",
           "local_attention"]

_NEG_INF = -1e30


def _block_attn(q, k, v, bias, scale):
    """One q-block x k-block attention with running-softmax stats:
    (unnormalized out, row max, row denominator), all fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p, v.float())
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two partial softmax accumulators (the flash recurrence)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2


def _merge_norm(o1, lse1, o2, lse2):
    """Merge two normalized partial attentions by their row logsumexp, in
    fp32 (the ring keeps the accumulator at full precision and casts
    once at the end)."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    wsum = torch.clamp(w1 + w2, min=1e-30)
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) \
        / wsum[..., None]
    return o, m + torch.log(wsum)


def _use_flash_blocks() -> bool:
    return config.get_env("MXTPU_RING_FLASH", "1") != "0"


def ring_attention_shard(q, k, v, *, axis_name: str = SP,
                         causal: bool = False, scale: Optional[float] = None,
                         use_flash: Optional[bool] = None):
    """A rank's ring attention: q, k, v [batch, heads, local_seq,
    head_dim] are its sequence block along ``axis_name`` of the current
    mesh (call inside `shard_map` or ``mesh_scope``)."""
    n = C.axis_size(axis_name)
    my_idx = C.axis_index(axis_name)
    lq, d = q.shape[-2], q.shape[-1]
    scale = float(scale) if scale is not None else d ** -0.5
    if use_flash is None:
        use_flash = _use_flash_blocks()
    perm = [(i, (i + 1) % n) for i in range(n)]

    if use_flash:
        from ..ops import hopper_kernels as hk

        def flash_block(kc, vc, src):
            """(o, lse) of one hop, or None for a fully masked one."""
            if causal and src > my_idx:
                return None
            return hk.flash_attention_with_lse(
                q, kc, vc, causal=causal and src == my_idx, scale=scale)

        o, lse = flash_block(k, v, my_idx)
        o = o.float()
        kc, vc = k, v
        for i in range(n - 1):
            kc = C.ppermute(kc, axis_name, perm)
            vc = C.ppermute(vc, axis_name, perm)
            hop = flash_block(kc, vc, (my_idx - i - 1) % n)
            if hop is not None:
                o, lse = _merge_norm(o, lse, *hop)
        return o.to(q.dtype)

    def bias_for(src_idx, lk):
        if not causal:
            return None
        rows = my_idx * lq + torch.arange(lq, device=q.device)
        cols = src_idx * lk + torch.arange(lk, device=q.device)
        keep = rows[:, None] >= cols[None, :]
        return torch.where(keep, 0.0, _NEG_INF)[None, None]

    o, m, l = _block_attn(q, k, v, bias_for(my_idx, k.shape[-2]), scale)
    kc, vc = k, v
    for i in range(n - 1):
        kc = C.ppermute(kc, axis_name, perm)
        vc = C.ppermute(vc, axis_name, perm)
        src = (my_idx - i - 1) % n
        o2, m2, l2 = _block_attn(q, kc, vc, bias_for(src, kc.shape[-2]),
                                 scale)
        o, m, l = _merge(o, m, l, o2, m2, l2)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def local_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """One device's attention (the oracle the ring must match)."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else d ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        keep = torch.ones((lq, lk), dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def ring_attention(q, k, v, mesh: Mesh, *, axis_name: str = SP,
                   causal: bool = False, scale: Optional[float] = None):
    """Exact attention of global q, k, v [B, H, L, D] with L split over
    ``axis_name`` of ``mesh``; the global output on every rank."""
    spec = P(None, None, axis_name, None)
    fn = functools.partial(ring_attention_shard, axis_name=axis_name,
                           causal=causal, scale=scale)
    return C.shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=spec)(q, k, v)


def ulysses_attention(q, k, v, mesh: Mesh, *, axis_name: str = SP,
                      causal: bool = False, scale: Optional[float] = None):
    """All-to-all sequence parallelism (Ulysses): the sequence split is
    traded for a head split, full attention runs locally, and the split
    is traded back.  The axis size must divide the head count."""
    spec = P(None, None, axis_name, None)

    def body(ql, kl, vl):
        def a2a(x, split_axis, concat_axis):
            return C.all_to_all(x, axis_name, split_axis, concat_axis)
        oh = local_attention(a2a(ql, 1, 2), a2a(kl, 1, 2), a2a(vl, 1, 2),
                             causal=causal, scale=scale)
        return a2a(oh, 2, 1)

    return C.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                       out_specs=spec)(q, k, v)
