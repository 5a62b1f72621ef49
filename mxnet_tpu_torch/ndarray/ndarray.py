"""NDArray: MXNet's array handle over a `torch.Tensor` (the counterpart of
`mxnet_tpu/ndarray/ndarray.py`).

``data`` is the tensor itself.  Arithmetic and comparison operators run
the registered ``broadcast_*`` and ``_*_scalar`` ops through
`register.invoke`, so `autograd.record` sees them as it sees any op.
Basic slicing and ``reshape`` give views, as in MXNet: a write through a
view lands in its base.  A write into an array (``x[:] = ...``, ``+=``,
an op's ``out=``) goes into its tensor in place, so an array's storage
stays where it is (a captured CUDA graph reads parameters at their
addresses); under `autograd.record` a write whose value carries a graph
rebinds the handle to it instead.

Gradients: `attach_grad` makes the array a variable of `autograd` (its
tensor a leaf that requires grad, its gradient buffer ``grad`` beside
it); ``_fresh_grad`` is set by a backward that wrote the gradient and
cleared by `gluon.Trainer`'s update.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from ..base import torch_dtype
from ..context import Context, default_context

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "waitall"]

#: the live variables (`attach_grad`, `autograd.mark_variables`): what a
#: backward may write gradients into
VARIABLES: "weakref.WeakValueDictionary[int, NDArray]" = \
    weakref.WeakValueDictionary()


def _grad_mode():
    from .. import autograd
    return autograd.grad_mode()


def _invoke(op_name, *args, **kwargs):
    from .register import invoke  # register imports this module
    return invoke(op_name, *args, **kwargs)


class NDArray:
    """An array on one device."""

    __slots__ = ("data", "_grad", "_grad_req", "_fresh_grad", "_version",
                 "__weakref__")

    def __init__(self, data: torch.Tensor):
        self.data = data
        self._grad: Optional[NDArray] = None
        self._grad_req = "null"
        self._fresh_grad = False
        self._version = 0

    # -- properties ---------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def ndim(self) -> int:
        return self.data.dim()

    @property
    def size(self) -> int:
        return self.data.numel()

    @property
    def context(self) -> Context:
        return Context.of(self.data.device)

    @property
    def ctx(self) -> Context:
        return self.context

    @property
    def version(self) -> int:
        """The count of writes into this array (reference engine var
        version)."""
        return self._version

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return _invoke("transpose", self)

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    # -- writes -------------------------------------------------------------
    def _set_data(self, value: torch.Tensor) -> None:
        """Write ``value`` into this array: in place when shape, dtype and
        device match, else (or when ``value`` carries a graph being
        recorded) by rebinding the handle."""
        if value is self.data:
            return
        self._version += 1
        d = self.data
        recorded = value.requires_grad and torch.is_grad_enabled()
        if (not recorded and value.shape == d.shape
                and value.dtype == d.dtype and value.device == d.device):
            with torch.no_grad():
                d.copy_(value)
            return
        if self._grad_req != "null" and not recorded:
            value = value.detach().requires_grad_(True)
        self.data = value

    # -- sync and host copies -----------------------------------------------
    def wait_to_read(self):
        if self.data.is_cuda:
            torch.cuda.synchronize(self.data.device)

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """A host copy (bfloat16 widens to float32, which numpy lacks)."""
        t = self.data.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return f"<NDArray {self.shape} {self.dtype} @{self.context}>"

    # -- conversions --------------------------------------------------------
    def astype(self, dtype, copy=True) -> "NDArray":
        dtype = torch_dtype(dtype)
        if not copy and dtype == self.dtype:
            return self
        return _invoke("cast", self, dtype=str(dtype).replace("torch.", ""))

    def copy(self) -> "NDArray":
        with _grad_mode():
            return NDArray(self.data.clone())

    def copyto(self, other) -> "NDArray":
        """Copy into an NDArray (in place) or onto a context (reference
        `CopyFromTo`)."""
        if isinstance(other, NDArray):
            other._set_data(self.data.detach().to(other.data.device))
            return other
        if isinstance(other, Context):
            return NDArray(self.data.detach().to(other.device, copy=True))
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        with _grad_mode():
            return NDArray(self.data.to(ctx.device))

    as_in_ctx = as_in_context

    def reshape(self, *shape, **kwargs) -> "NDArray":
        """A view of another shape, with MXNet's codes (0 copies a dim, -1
        infers one, -2, -3 and -4 as in `Reshape`)."""
        from ..ops.matrix import infer_reshape
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        shape = infer_reshape(self.shape, shape)
        with _grad_mode():
            return NDArray(self.data.reshape(shape))

    def reshape_like(self, other) -> "NDArray":
        return self.reshape(other.shape)

    def expand_dims(self, axis) -> "NDArray":
        return _invoke("expand_dims", self, axis=axis)

    def flatten(self) -> "NDArray":
        return _invoke("Flatten", self)

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Make this array a variable to differentiate (reference
        `Imperative::MarkVariables`), with a zeroed gradient buffer.
        ``stype`` is accepted and the buffer stays dense, as in the JAX
        package."""
        from .. import autograd
        autograd.mark_variables(self, NDArray(torch.zeros_like(
            self.data, memory_format=torch.contiguous_format)), grad_req)

    def detach(self) -> "NDArray":
        return NDArray(self.data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True,
                 create_graph=False):
        from .. import autograd
        autograd.backward(self, out_grad, retain_graph=retain_graph,
                          train_mode=train_mode, create_graph=create_graph)

    # -- indexing -----------------------------------------------------------
    @staticmethod
    def _key(key):
        if isinstance(key, NDArray):
            return key.data.to(torch.int64)
        if isinstance(key, tuple):
            return tuple(k.data.to(torch.int64) if isinstance(k, NDArray)
                         else k for k in key)
        return key

    def __getitem__(self, key) -> "NDArray":
        with _grad_mode():
            return NDArray(self.data[self._key(key)])

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value.data
        elif not isinstance(value, (int, float, bool, torch.Tensor)):
            value = torch.as_tensor(np.asarray(value), dtype=self.dtype,
                                    device=self.data.device)
        with torch.no_grad():
            self.data[self._key(key)] = value
        self._version += 1

    def slice(self, begin, end, step=None) -> "NDArray":
        return _invoke("slice", self, begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end) -> "NDArray":
        return _invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip") -> "NDArray":
        return _invoke("take", self, indices, axis=axis, mode=mode)

    def squeeze(self, axis=None) -> "NDArray":
        return _invoke("squeeze", self, axis=axis)

    def to_dlpack_for_read(self):
        """The tensor itself, a DLPack exporter (``__dlpack__``) sharing
        this array's storage."""
        return self.data

    def to_dlpack_for_write(self):
        return self.data

    # -- arithmetic ---------------------------------------------------------
    # the scalar op for a scalar on the left (s <op> x)
    _REVERSE_SCALAR = {
        "_minus_scalar": "_rminus_scalar",
        "_div_scalar": "_rdiv_scalar",
        "_power_scalar": "_rpower_scalar",
        "_greater_scalar": "_lesser_scalar",
        "_greater_equal_scalar": "_lesser_equal_scalar",
        "_lesser_scalar": "_greater_scalar",
        "_lesser_equal_scalar": "_greater_equal_scalar",
        "_mod_scalar": "_rmod_scalar",
    }

    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            return _invoke(op, other, self) if reverse \
                else _invoke(op, self, other)
        if isinstance(other, (int, float, bool, np.number)):
            if reverse:
                scalar_op = self._REVERSE_SCALAR.get(scalar_op, scalar_op)
            return _invoke(scalar_op, self, scalar=float(other))
        if isinstance(other, (np.ndarray, list, tuple)):
            return self._binop(array(other, ctx=self.context), op,
                               scalar_op, reverse)
        return NotImplemented

    def __add__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar", True)
    def __sub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar", True)
    def __mul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar", True)
    def __truediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar", True)
    def __mod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar")
    def __rmod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar", True)
    def __pow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar", True)
    def __eq__(self, o): return self._binop(o, "broadcast_equal", "_equal_scalar")
    def __ne__(self, o): return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")
    def __gt__(self, o): return self._binop(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __neg__(self):
        return _invoke("negative", self)

    def __abs__(self):
        return _invoke("abs", self)

    def __hash__(self):
        return id(self)

    def _inplace(self, other, op, scalar_op):
        res = self._binop(other, op, scalar_op)
        self._set_data(res.data.to(self.dtype))
        return self

    def __iadd__(self, o): return self._inplace(o, "broadcast_add", "_plus_scalar")
    def __isub__(self, o): return self._inplace(o, "broadcast_sub", "_minus_scalar")
    def __imul__(self, o): return self._inplace(o, "broadcast_mul", "_mul_scalar")
    def __itruediv__(self, o): return self._inplace(o, "broadcast_div", "_div_scalar")

    # -- fluent reductions and math -----------------------------------------
    def sum(self, axis=None, keepdims=False):
        return _invoke("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return _invoke("mean", self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return _invoke("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _invoke("min", self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _invoke("argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _invoke("argmin", self, axis=axis, keepdims=keepdims)

    def abs(self):
        return _invoke("abs", self)

    def clip(self, a_min, a_max):
        return _invoke("clip", self, a_min=a_min, a_max=a_max)

    def dot(self, other):
        return _invoke("dot", self, other)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def square(self):
        return _invoke("square", self)

    def sqrt(self):
        return _invoke("sqrt", self)

    def exp(self):
        return _invoke("exp", self)

    def log(self):
        return _invoke("log", self)

    def relu(self):
        return _invoke("relu", self)

    def sigmoid(self):
        return _invoke("sigmoid", self)

    def softmax(self, axis=-1):
        return _invoke("softmax", self, axis=axis)

    def transpose(self, axes=None):
        return _invoke("transpose", self, axes=axes)

    def zeros_like(self):
        return _invoke("zeros_like", self)

    def tostype(self, stype: str):
        """This array in storage ``stype`` (`sparse.cast_storage`)."""
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    def ones_like(self):
        return _invoke("ones_like", self)


def _device(ctx: Optional[Context], what: str) -> torch.device:
    return (ctx or default_context(what)).device


def array(source, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray from an NDArray, tensor or array-like on ``ctx`` (the
    card when none is given); like MXNet, a non-array source defaults to
    float32.  A sparse NDArray or a scipy.sparse source keeps its storage
    (`sparse.array`)."""
    if getattr(source, "stype", "default") != "default" or \
            type(source).__module__.startswith("scipy.sparse"):
        from . import sparse
        return sparse.array(source, ctx=ctx, dtype=dtype)
    if isinstance(source, NDArray):
        t = source.data.detach()
    elif isinstance(source, torch.Tensor):
        t = source.detach()
    else:
        t = torch.tensor(np.asarray(source))
        if dtype is None:
            dtype = torch.float32
    t = t.to(device=_device(ctx, "nd.array"),
             dtype=torch_dtype(dtype) if dtype is not None else None)
    return NDArray(t)


def zeros(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """Zeros on ``ctx`` (the card when none is given)."""
    return NDArray(torch.zeros(tuple(shape), device=_device(ctx, "nd.zeros"),
                               dtype=torch_dtype(dtype or "float32")))


def ones(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    return NDArray(torch.ones(tuple(shape), device=_device(ctx, "nd.ones"),
                              dtype=torch_dtype(dtype or "float32")))


def full(shape, val, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    return NDArray(torch.full(tuple(shape), float(val),
                              device=_device(ctx, "nd.full"),
                              dtype=torch_dtype(dtype or "float32")))


def empty(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    return zeros(shape, ctx, dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0.0, start
    t = torch.arange(float(start), float(stop), float(step),
                     device=_device(ctx, "nd.arange"),
                     dtype=torch_dtype(dtype or "float32"))
    return NDArray(t.repeat_interleave(repeat) if repeat > 1 else t)


def waitall():
    """Wait for every device's queued work (reference `nd.waitall`)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


#: ops attached as methods, ``x.topk(k=2)`` for ``nd.topk(x, k=2)`` (the
#: JAX package's `FLUENT_OP_METHODS`, reference `ndarray.py`'s fluent
#: surface); a method the class defines wins
FLUENT_OP_METHODS = (
    "arccos", "arccosh", "arcsin", "arcsinh", "arctan", "arctanh",
    "argmax_channel", "argsort", "broadcast_axes", "broadcast_like",
    "broadcast_to", "cbrt", "ceil", "cos", "cosh", "degrees",
    "depth_to_space", "diag", "exp", "expm1", "fix", "flip", "floor",
    "log", "log10", "log1p", "log2", "log_softmax", "nanprod", "nansum",
    "one_hot", "pad", "pick", "prod", "radians", "rcbrt", "reciprocal",
    "relu", "repeat", "rint", "round", "rsqrt", "shape_array", "sigmoid",
    "sign", "sin", "sinh", "size_array", "slice_like", "softmax",
    "softmin", "sort", "space_to_depth", "split", "split_v2", "swapaxes",
    "tan", "tanh", "tile", "topk", "trunc",
)


def _fluent(op_name):
    def method(self, *args, **kwargs):
        return _invoke(op_name, self, *args, **kwargs)
    method.__name__ = op_name
    method.__qualname__ = f"NDArray.{op_name}"
    method.__doc__ = f"``nd.{op_name}(self, ...)``."
    return method


def _fluent_split_v2(self, indices_or_sections, axis=0, squeeze_axis=False):
    """``nd.split_v2(self, ...)``."""
    from . import split_v2
    return split_v2(self, indices_or_sections, axis=axis,
                    squeeze_axis=squeeze_axis)


for _n in FLUENT_OP_METHODS:
    if not hasattr(NDArray, _n):
        setattr(NDArray, _n, _fluent_split_v2 if _n == "split_v2"
                else _fluent(_n))
