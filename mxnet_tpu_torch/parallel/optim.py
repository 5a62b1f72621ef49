"""Pure optimizer rules for the SPMD step (the counterpart of
`mxnet_tpu/parallel/optim.py`).

`pure_rule(opt)` turns a configured optimizer into ``(init_fn,
update_fn)``: ``update_fn(w, g, state, t, lr, wd) -> (new_w, new_state)``
is a function of tensors with the step counter ``t`` a tensor, so Adam's
bias correction needs no host value.  The arithmetic is the port's update
ops' (`ops/optimizer_ops.py`), written out so it runs on any block of a
weight (a ZeRO-1 or tensor-parallel shard).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..base import MXNetError
from .. import optimizer as opt_mod

__all__ = ["pure_rule"]


def _rescale(opt, grad):
    g = grad * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = g.clamp(-opt.clip_gradient, opt.clip_gradient)
    return g


def _common(opt, grad, wd, weight):
    return _rescale(opt, grad) + wd * weight


def pure_rule(opt) -> Tuple[Callable, Callable]:
    """``(init_fn(name, weight) -> state, update_fn(w, g, state, t, lr,
    wd) -> (new_w, new_state))`` for SGD, NAG, Signum, Adam, AdaGrad and
    RMSProp; lr and wd arrive per call so schedules and per-parameter
    multipliers stay on the host."""
    if isinstance(opt, opt_mod.NAG):
        def init(name, w):
            return {"mom": torch.zeros_like(w)} if opt.momentum else {}

        def update(w, g, state, t, lr, wd):
            g = _common(opt, g, wd, w)
            if not opt.momentum:
                return w - lr * g, state
            mom = state["mom"] * opt.momentum + g
            return w - lr * (g + opt.momentum * mom), {"mom": mom}
        return init, update

    if isinstance(opt, opt_mod.Signum):
        def init(name, w):
            return {"mom": torch.zeros_like(w)} if opt.momentum else {}

        def update(w, g, state, t, lr, wd):
            g = _rescale(opt, g)
            if opt.momentum:
                mom = (opt.momentum * state["mom"]
                       - (1 - opt.momentum) * (g + wd * w))
                w = (1 - lr * opt.wd_lh) * w + lr * torch.sign(mom)
                return w, {"mom": mom}
            return w - lr * (torch.sign(g) + wd * w), state
        return init, update

    if isinstance(opt, opt_mod.SGD):  # after NAG and Signum (subclasses)
        def init(name, w):
            return {"mom": torch.zeros_like(w)} if opt.momentum else {}

        def update(w, g, state, t, lr, wd):
            g = _common(opt, g, wd, w)
            if not opt.momentum:
                return w - lr * g, state
            mom = state["mom"] * opt.momentum - lr * g
            return w + mom, {"mom": mom}
        return init, update

    if isinstance(opt, opt_mod.Adam):
        def init(name, w):
            return {"mean": torch.zeros_like(w), "var": torch.zeros_like(w)}

        def update(w, g, state, t, lr, wd):
            g = _common(opt, g, wd, w)
            t = torch.as_tensor(t, dtype=torch.float32, device=w.device)
            mean = opt.beta1 * state["mean"] + (1 - opt.beta1) * g
            var = opt.beta2 * state["var"] + (1 - opt.beta2) * g * g
            lr_t = lr * torch.sqrt(1 - opt.beta2 ** t) / (1 - opt.beta1 ** t)
            w = w - lr_t * mean / (torch.sqrt(var) + opt.epsilon)
            return w, {"mean": mean, "var": var}
        return init, update

    if isinstance(opt, opt_mod.AdaGrad):
        def init(name, w):
            return {"hist": torch.zeros_like(w)}

        def update(w, g, state, t, lr, wd):
            g = _rescale(opt, g)
            hist = state["hist"] + g * g
            w = w - lr * (g / torch.sqrt(hist + opt.float_stable_eps)
                          + wd * w)
            return w, {"hist": hist}
        return init, update

    if isinstance(opt, opt_mod.RMSProp):
        def init(name, w):
            s = {"n": torch.zeros_like(w)}
            if opt.centered:
                s["g"] = torch.zeros_like(w)
                s["delta"] = torch.zeros_like(w)
            return s

        def update(w, g, state, t, lr, wd):
            g = _common(opt, g, wd, w)
            n = (1 - opt.gamma1) * g * g + opt.gamma1 * state["n"]
            if not opt.centered:
                return w - lr * g / torch.sqrt(n + opt.epsilon), {"n": n}
            gm = (1 - opt.gamma1) * g + opt.gamma1 * state["g"]
            delta = (opt.gamma2 * state["delta"]
                     - lr * g / torch.sqrt(n - gm * gm + opt.epsilon))
            return w + delta, {"n": n, "g": gm, "delta": delta}
        return init, update

    raise MXNetError(
        f"no pure update rule for {type(opt).__name__}; the parallel "
        "trainer supports SGD/NAG/Signum/Adam/AdaGrad/RMSProp — use "
        "gluon.Trainer for others")
