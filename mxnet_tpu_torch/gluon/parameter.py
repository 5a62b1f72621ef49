"""Gluon Parameter, Constant and ParameterDict (the counterpart of
`mxnet_tpu/gluon/parameter.py`; reference `python/mxnet/gluon/parameter.py`).

A parameter holds one NDArray per context it was initialized on, and
beside each a gradient buffer per ``grad_req``.  Its shape may stay
unknown (a 0 in it) until the first forward (deferred initialization).
Initial values are drawn on the host from `mx.random`'s CPU stream and
then copied to each context, so one seed gives the same weights on the
CPU and on the card.  ``set_data`` and `ParameterDict.load` write into
the existing storage, which a captured forward reads.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from .. import initializer as init_mod
from ..base import MXNetError, dtype_np, torch_dtype
from ..context import Context, cpu, current_context, default_context
from ..ndarray.ndarray import NDArray, zeros

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """The parameter's shape is not known yet (reference
    `parameter.py:36`)."""


def _contexts(ctx) -> List[Context]:
    if ctx is None:
        return [default_context("Parameter.initialize")]
    if isinstance(ctx, Context):
        return [ctx]
    return list(ctx)


class Parameter:
    """A weight of a Block (reference `parameter.py:43`)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        self.shape = tuple(shape) if shape is not None else None
        self._tdtype = torch_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._data: Optional[List[NDArray]] = None
        self._ctx_list: Optional[List[Context]] = None
        self._deferred_init = None

    @property
    def dtype(self):
        """The numpy dtype of the values (`base.dtype_np`)."""
        return dtype_np(self._tdtype)

    @dtype.setter
    def dtype(self, dtype):
        self._tdtype = torch_dtype(dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        self._grad_req = req
        if self._data is not None:
            self._init_grad()

    def _shape_known(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Reference `Parameter.initialize`: values now, or at the first
        forward when the shape is not known yet."""
        default_init = default_init or init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        self._ctx_list = _contexts(ctx)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, default_init)
                return
            raise MXNetError(
                f"cannot initialize parameter {self.name}: shape unknown; "
                "run a forward pass first or set shape")
        self._finish_init(init, default_init)

    def _finish_init(self, init, default_init):
        explicit = init or self.init
        host = zeros(self.shape, ctx=cpu(), dtype="float32")
        if explicit is not None:
            desc = init_mod.InitDesc(self.name, {"__init__": explicit})
            init_mod.create(default_init)(desc, host)
        else:
            init_mod.create(default_init)(self.name, host)
        self._data = [NDArray(host.data.to(c.device, self._tdtype,
                                           copy=True), c)
                      for c in self._ctx_list]
        self._deferred_init = None
        self._init_grad()

    def _init_grad(self):
        from ..autograd import mark_variables
        for d in self._data:
            if self._grad_req == "null":
                mark_variables([d], [None], "null")
            else:
                d.attach_grad(self._grad_req)

    def _finish_deferred_init(self, shape):
        self.shape = tuple(shape)
        if self._deferred_init is None:
            raise DeferredInitializationError(self.name)
        init, default_init = self._deferred_init
        self._finish_init(init, default_init)

    def _check_and_get(self, ctx=None) -> NDArray:
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} not initialized yet (deferred)")
            raise MXNetError(
                f"parameter {self.name} has not been initialized; call "
                ".initialize() first")
        if ctx is None:
            if len(self._data) == 1:
                return self._data[0]
            # the replica of the current context, else the first
            try:
                ctx = current_context()
            except MXNetError:
                return self._data[0]
            return next((d for d in self._data if d.context == ctx),
                        self._data[0])
        for d in self._data:
            if d.context == ctx:
                return d
        if len(self._data) == 1:
            return self._data[0]
        raise MXNetError(f"parameter {self.name} was not initialized on "
                         f"context {ctx}")

    def data(self, ctx=None) -> NDArray:
        return self._check_and_get(ctx)

    def grad(self, ctx=None) -> NDArray:
        d = self._check_and_get(ctx)
        if d.grad is None:
            raise MXNetError(f"parameter {self.name} has grad_req='null'")
        return d.grad

    def list_data(self) -> List[NDArray]:
        self._check_and_get()
        return list(self._data)

    def list_grad(self) -> List[NDArray]:
        self._check_and_get()
        return [d.grad for d in self._data]

    def list_ctx(self) -> List[Context]:
        if self._data is None and self._ctx_list is None:
            raise MXNetError(f"parameter {self.name} not initialized")
        return list(self._ctx_list)

    def set_data(self, data):
        """Write ``data`` into every replica, in place."""
        if self._data is None:
            raise MXNetError(f"parameter {self.name} not initialized")
        src = data.data if isinstance(data, NDArray) else \
            torch.as_tensor(np.asarray(data))
        for d in self._data:
            d._set_data(src.detach().to(d.data.device, d._tdtype))

    def zero_grad(self):
        if self._data is None:
            return
        with torch.no_grad():
            for d in self._data:
                if d.grad is not None:
                    d.grad.data.zero_()

    def reset_ctx(self, ctx):
        ctx = _contexts(ctx)
        if self._data is not None:
            value = self._data[0].data.detach()
            self._ctx_list = ctx
            self._data = [NDArray(value.to(c.device, copy=True), c)
                          for c in ctx]
            self._init_grad()
        else:
            self._ctx_list = ctx

    def cast(self, dtype):
        self._tdtype = torch_dtype(dtype)
        if self._data is not None:
            self._data = [NDArray(d.data.detach().to(self._tdtype), d.context)
                          for d in self._data]
            self._init_grad()

    def var(self):
        """The Symbol variable of this parameter."""
        from ..symbol import var
        return var(self.name, shape=self.shape,
                   dtype=str(self._tdtype).replace("torch.", ""))

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")


class Constant(Parameter):
    """A parameter that is not differentiated (reference `Constant`)."""

    def __init__(self, name, value):
        if not isinstance(value, np.ndarray):
            value = np.asarray(value, dtype=np.float32)
        self.value = value

        class _CInit(init_mod.Initializer):
            def _init_weight(self_, _name, arr):
                self_._write(arr, torch.as_tensor(value))

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_CInit())


class ParameterDict:
    """A prefix-scoped, ordered dict of Parameters (reference
    `parameter.py:632`)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` if it
        does not exist (reference `parameter.py:get`)."""
        name = self._prefix + name
        if name in self._params:
            param = self._params[name]
            for k, v in kwargs.items():
                if v is not None and getattr(param, k, None) is None:
                    setattr(param, k, v)
            return param
        if self._shared is not None and name in self._shared:
            self._params[name] = self._shared[name]
            return self._shared[name]
        param = Parameter(name, **kwargs)
        self._params[name] = param
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = Constant(name, value)
        return self._params[name]

    def update(self, other):
        for k, v in other.items():
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(init=None, ctx=ctx,
                         default_init=init or init_mod.Uniform(),
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        from ..serialization import save_ndarrays
        arg_dict = {}
        for p in self.values():
            name = p.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = p.data()
        save_ndarrays(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..serialization import load_ndarrays, strip_arg_aux
        loaded, _ = strip_arg_aux(load_ndarrays(filename))
        loaded = {(k if k.startswith(restore_prefix)
                   else restore_prefix + k): v for k, v in loaded.items()}
        load_into(self._params, loaded, ctx, allow_missing, ignore_extra)

    def __repr__(self):
        body = "\n".join(f"  {p!r}" for p in self.values())
        return f"ParameterDict '{self._prefix}' (\n{body}\n)"


def load_into(params, loaded, ctx, allow_missing, ignore_extra):
    """Set each of ``params`` {name: Parameter} from ``loaded`` {name:
    NDArray}, initializing (on ``ctx``) the ones not yet initialized."""
    for name, p in params.items():
        if name not in loaded:
            if not allow_missing:
                raise MXNetError(f"parameter {name} missing in file")
            continue
        arr = loaded[name]
        if p._data is None:
            p.shape = tuple(arr.shape)
            p.initialize(ctx=ctx if ctx is not None else p._ctx_list)
        p.set_data(arr)
    if not ignore_extra:
        extra = set(loaded) - set(params)
        if extra:
            raise MXNetError(f"file has extra parameters: {sorted(extra)}")
