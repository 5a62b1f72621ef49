"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis
(the counterpart of `mxnet_tpu/parallel/moe.py`).

GShard/Switch-style token-choice MoE with static capacity
(``C = ceil(T/E * capacity_factor)``): the router, dispatch and combine
are dense einsums.  Given a mesh with ep > 1, the expert weights and the
dispatched token slots split over ep: each rank computes its E/ep
experts' slots, and the slots of every expert are exchanged back over ep
(the counterpart of the all-to-alls GSPMD inserts around the expert
einsums; the tokens here are the same on every rank, so the exchange is
a gather over ep).  `init_moe` draws from an explicit
``torch.Generator`` in place of the JAX key.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import collectives as C
from .mesh import EP, Mesh
from .sharding import NamedSharding, PartitionSpec as P

__all__ = ["MoEParams", "init_moe", "moe_ffn", "expert_sharding"]


class MoEParams(NamedTuple):
    router: torch.Tensor   # (d, E)
    w_in: torch.Tensor     # (E, d, h)
    w_out: torch.Tensor    # (E, h, d)


def expert_sharding(mesh: Mesh):
    """The shardings of (router, w_in, w_out): the expert axis on ep."""
    return (NamedSharding(mesh, P()), NamedSharding(mesh, P(EP)),
            NamedSharding(mesh, P(EP)))


def init_moe(generator, d_model: int, d_hidden: int, n_experts: int,
             mesh: Optional[Mesh] = None,
             dtype=torch.float32) -> MoEParams:
    """Random MoE weights from ``generator`` (a ``torch.Generator`` or an
    int seed), on ``mesh``'s device when one is given."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))

    def normal(*shape):
        return torch.randn(*shape, generator=generator)

    scale_in = (2.0 / d_model) ** 0.5
    scale_out = (2.0 / d_hidden) ** 0.5
    p = MoEParams(router=normal(d_model, n_experts) * 0.02,
                  w_in=normal(n_experts, d_model, d_hidden) * scale_in,
                  w_out=normal(n_experts, d_hidden, d_model) * scale_out)
    dev = mesh.device if mesh is not None else None
    return MoEParams(*(a.to(device=dev, dtype=dtype) for a in p))


def _experts(expert_in, w_in, w_out):
    # jax.nn.gelu's default: the tanh approximation
    h = F.gelu(torch.einsum("ecd,edh->ech", expert_in, w_in),
               approximate="tanh")
    return torch.einsum("ech,ehd->ecd", h, w_out)


def moe_ffn(params: MoEParams, x, capacity_factor: float = 1.25,
            mesh: Optional[Mesh] = None):
    """Top-1 (Switch) token-choice MoE feed-forward on x (T, d).  Returns
    (y, aux): y (T, d) and {aux_loss, dropped_frac}; ``aux_loss`` is the
    Switch load-balancing loss.  Tokens past an expert's capacity come
    back as zeros (the residual carries them)."""
    t, d = x.shape
    e = params.router.shape[1]
    cap = int(-(-t * capacity_factor // e))

    gates = torch.softmax(x.float() @ params.router.float(), -1)
    expert_idx = gates.argmax(-1)
    gate = torch.gather(gates, 1, expert_idx[:, None])[:, 0]

    assign = F.one_hot(expert_idx, e).to(torch.int32)           # (T, E)
    pos = ((torch.cumsum(assign, 0) - 1) * assign).amax(-1)      # (T,)
    keep = pos < cap
    dropped_frac = 1.0 - keep.float().mean()

    dispatch = (F.one_hot(expert_idx, e).to(x.dtype)[:, :, None]
                * F.one_hot(torch.where(keep, pos, torch.full_like(pos, cap)),
                            cap + 1).to(x.dtype)[:, None, :cap])
    combine = dispatch * gate[:, None, None].to(x.dtype)

    expert_in = torch.einsum("tec,td->ecd", dispatch, x)
    if mesh is not None and mesh.axis_size(EP) > 1:
        spec = P(EP)
        expert_out = C.shard_map(_experts, mesh=mesh,
                                 in_specs=(spec, spec, spec),
                                 out_specs=spec)(
            expert_in, params.w_in, params.w_out)
    else:
        expert_out = _experts(expert_in, params.w_in, params.w_out)
    y = torch.einsum("tec,ecd->td", combine, expert_out)

    me = gates.mean(0)
    ce = assign.float().mean(0)
    aux_loss = e * torch.sum(me * ce)
    return y, {"aux_loss": aux_loss, "dropped_frac": dropped_frac}
