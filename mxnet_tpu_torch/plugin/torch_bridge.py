"""PyTorch interop (the counterpart of `mxnet_tpu/plugin/torch_bridge.py`;
reference `plugin/torch/torch_module.cc` + `torch_criterion-inl.h`, which
wrapped (Lua)Torch modules and criterions as framework operators).

An NDArray here holds a torch tensor, so nothing crosses: a torch module
runs on the NDArray's own tensor, on its device (the same storage, the
same ``data_ptr``), and the autograd tape records an `autograd.Function`
whose backward is `torch.autograd.grad` of the module's outputs, as in
the JAX package.  Torch module parameters are mirrored as Gluon
`Parameter`s so `Trainer` and the KVStore update them like any other
block; the torch module is the source of the forward math only.
"""
from __future__ import annotations

import torch

from ..autograd import Function
from ..gluon.block import Block
from ..gluon.loss import Loss
from ..ndarray.ndarray import NDArray

__all__ = ["ndarray_to_torch", "torch_to_ndarray", "TorchBlock",
           "TorchLoss"]


def ndarray_to_torch(arr):
    """NDArray -> its torch.Tensor (no copy: the same storage)."""
    return arr.data


def torch_to_ndarray(tensor, ctx=None):
    """torch.Tensor -> NDArray on ``ctx`` (the tensor's own device when
    ``ctx`` is None; a copy only when the devices differ)."""
    t = tensor.detach()
    if ctx is not None and t.device != ctx.device:
        t = t.to(ctx.device)
    return NDArray(t, ctx)


class _TorchFunction(Function):
    """Differentiable call into torch.

    ``runner(*tensors)`` receives the inputs' own tensors (detached,
    floating ones requiring gradients), positioned as ``inputs + params``,
    and returns a tensor or tuple of tensors.
    """

    def __init__(self, runner):
        super().__init__()
        self._runner = runner
        self._tin = None
        self._tout = None

    def forward(self, *inputs):
        self._tin = [x.data.detach().requires_grad_(
            x.data.is_floating_point()) for x in inputs]
        with torch.enable_grad():
            out = self._runner(*self._tin)
        self._tout = [out] if torch.is_tensor(out) else list(out)
        ctx = inputs[0].context
        outs = [NDArray(t.detach(), ctx) for t in self._tout]
        return outs[0] if len(outs) == 1 else outs

    def backward(self, *out_grads):
        # the tape may hand scalar cotangents as shape-(1,)
        cts = [g.data.reshape(t.shape).to(t.dtype)
               for g, t in zip(out_grads, self._tout)]
        diff = [t for t in self._tin if t.requires_grad]
        grads = iter(torch.autograd.grad(
            self._tout, diff, cts, allow_unused=True, retain_graph=False))
        out = []
        for t in self._tin:
            g = next(grads) if t.requires_grad else None
            out.append(NDArray(g) if g is not None else
                       NDArray(torch.zeros_like(t.detach())))
        return out


class TorchBlock(Block):
    """Wrap a `torch.nn.Module` as a Gluon block (reference
    `plugin/torch/torch_module.cc` TorchModule op).

    Torch parameters are mirrored into `self.params` at construction;
    every forward runs the module functionally on the current Gluon
    parameter values, so optimizer updates made by `Trainer` take effect.
    The module follows its input to the input's device (its buffers with
    it).
    """

    def __init__(self, module, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if not isinstance(module, torch.nn.Module):
            raise TypeError("TorchBlock wraps a torch.nn.Module")
        self._module = module
        self._mirrored = []
        from ..initializer import Constant
        with self.name_scope():
            for tname, tparam in self._module.named_parameters():
                gname = tname.replace(".", "_")
                p = self.params.get(gname, shape=tuple(tparam.shape),
                                    init=Constant(tparam.detach().cpu()
                                                  .numpy()))
                self._mirrored.append((tname, p))

    def forward(self, *inputs):
        module = self._module
        device = inputs[0].data.device
        if any(b.device != device for b in module.buffers()):
            module.to(device)
        names = [t for t, _ in self._mirrored]

        def runner(*tensors):
            n_in = len(tensors) - len(names)
            data, weights = tensors[:n_in], tensors[n_in:]
            # functional call so the mirrored weights carry the gradient
            return torch.func.functional_call(
                module, dict(zip(names, weights)), data)

        ctx = inputs[0].context
        params = [p.data(ctx) for _, p in self._mirrored]
        return _TorchFunction(runner)(*inputs, *params)


class TorchLoss(Loss):
    """Wrap a torch criterion (e.g. ``torch.nn.CrossEntropyLoss``) as a
    Gluon loss (reference `plugin/torch/torch_criterion-inl.h`)."""

    def __init__(self, criterion, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._criterion = criterion

    def forward(self, pred, label):
        crit = self._criterion

        def runner(tp, tl):
            lab = tl
            if isinstance(crit, (torch.nn.CrossEntropyLoss,
                                 torch.nn.NLLLoss)):
                lab = tl.long()
            return crit(tp, lab)

        return _TorchFunction(runner)(pred, label)
