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

from ..base import MXNetError, dtype_np, torch_dtype
from ..context import Context, default_context

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat_nd", "waitall"]

#: the live arrays that carry a deferred error not yet raised by `waitall`
POISONED: "weakref.WeakValueDictionary[int, NDArray]" = \
    weakref.WeakValueDictionary()

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
    """An array on one device, in one context.

    ``ctx`` is the `Context` the array belongs to; when none is given it
    is the context of the tensor's device.  Several contexts may share a
    device (``cpu(0)`` and ``cpu(1)`` both live on the host), and the
    array keeps the one it was made in, as MXNet's does.

    A deferred error (a sampler given invalid parameters) rides on the
    array and on every array computed from it, and is raised where the
    values are read on the host (`asnumpy`, `wait_to_read`, `waitall`).
    """

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_fresh_grad",
                 "_version", "_deferred_error", "_pending", "__weakref__")

    def __init__(self, data: torch.Tensor, ctx: Optional[Context] = None):
        self._data = data
        self._ctx = ctx
        self._grad: Optional[NDArray] = None
        self._grad_req = "null"
        self._fresh_grad = False
        self._version = 0
        self._deferred_error: Optional[Exception] = None
        # an in-flight pull of the comm plane (`comm_plane.PendingPull`):
        # its result is this array's next value, written at the next
        # read or write, so an overlapped kvstore pull behaves as the
        # synchronous one at every sync point
        self._pending = None

    # -- the tensor ---------------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """The tensor (after landing an in-flight pull)."""
        if self._pending is not None:
            self._resolve_pending()
        return self._data

    @data.setter
    def data(self, value: torch.Tensor) -> None:
        if self._pending is not None:
            # a write replaces the pull's value, after it lands
            self._resolve_pending()
        self._data = value

    def _resolve_pending(self):
        """Land an in-flight comm-plane pull: its value is written under
        this handle, or its failure raised and kept as a deferred error.
        The handle is cleared first, so the write's own reads see none."""
        pend, self._pending = self._pending, None
        if pend is None:
            return
        try:
            new_data = pend.result()
        except Exception as e:
            self._poison(e)
            raise MXNetError(
                f"deferred async failure surfaced at sync point: {e}"
            ) from e
        self._set_data(new_data)

    # -- properties ---------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        """The numpy dtype of the values (`base.dtype_np`)."""
        return dtype_np(self._tdtype)

    @property
    def _tdtype(self) -> torch.dtype:
        """The torch dtype of the values."""
        return self.data.dtype

    @property
    def ndim(self) -> int:
        return self.data.dim()

    @property
    def size(self) -> int:
        return self.data.numel()

    @property
    def context(self) -> Context:
        ctx = self._ctx
        if ctx is None or ctx.device != self.data.device:
            return Context.of(self.data.device)
        return ctx

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
        self._data = value

    # -- deferred errors ----------------------------------------------------
    def _poison(self, error: Optional[Exception]) -> "NDArray":
        """Set (or, with None, clear) this array's deferred error."""
        self._deferred_error = error
        if error is not None:
            POISONED[id(self)] = self
        else:
            POISONED.pop(id(self), None)
        return self

    def _carry_poison(self, out: "NDArray") -> "NDArray":
        """``out``, derived from this array (a view, copy or detach),
        with this array's deferred error."""
        if self._deferred_error is not None:
            out._poison(self._deferred_error)
        return out

    def _check_deferred(self):
        e = self._deferred_error
        if e is not None:
            POISONED.pop(id(self), None)
            raise MXNetError(
                f"deferred async failure surfaced at sync point: {e}"
            ) from e

    # -- sync and host copies -----------------------------------------------
    def wait_to_read(self):
        self._check_deferred()
        if self.data.is_cuda:
            torch.cuda.synchronize(self.data.device)

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """A host copy (bfloat16 widens to float32, which numpy lacks)."""
        self._check_deferred()
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
        if not copy and dtype == self._tdtype:
            return self
        return _invoke("cast", self, dtype=str(dtype).replace("torch.", ""))

    def copy(self) -> "NDArray":
        with _grad_mode():
            return self._carry_poison(NDArray(self.data.clone(),
                                              self.context))

    def copyto(self, other) -> "NDArray":
        """Copy into an NDArray (in place) or onto a context (reference
        `CopyFromTo`)."""
        if isinstance(other, NDArray):
            other._set_data(self.data.detach().to(other.data.device))
            return other._poison(self._deferred_error)
        if isinstance(other, Context):
            return self._carry_poison(NDArray(
                self.data.detach().to(other.device, copy=True), other))
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, ctx: Context) -> "NDArray":
        """This array in context ``ctx``: itself when it is there, else a
        new array on ``ctx`` (a copy also where the two contexts share a
        device, as MXNet's `CopyFromTo` gives)."""
        if ctx == self.context:
            return self
        with _grad_mode():
            return self._carry_poison(NDArray(
                self.data.to(ctx.device, copy=True), ctx))

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
            return self._carry_poison(NDArray(self.data.reshape(shape),
                                              self.context))

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
            self.data, memory_format=torch.contiguous_format),
            self.context), grad_req)

    def detach(self) -> "NDArray":
        return self._carry_poison(NDArray(self.data.detach(), self.context))

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
        key, flips = _positive_key(self._key(key), self.shape)
        with _grad_mode():
            t = self.data[key]
            if flips:
                t = torch.flip(t, flips)
            return self._carry_poison(NDArray(t, self.context))

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value.data
        elif not isinstance(value, (int, float, bool, torch.Tensor)):
            value = torch.as_tensor(np.asarray(value), dtype=self._tdtype,
                                    device=self.data.device)
        key, flips = _positive_key(self._key(key), self.shape)
        with torch.no_grad():
            if flips:
                # the reversed axes, written through the same elements
                # in increasing order with the value flipped to match
                view = self.data[key]
                value = torch.as_tensor(value, dtype=view.dtype,
                                        device=view.device)
                view.copy_(torch.flip(value.broadcast_to(view.shape),
                                      flips))
            else:
                self.data[key] = value
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
        self._set_data(res.data.to(self._tdtype))
        return self._poison(res._deferred_error)

    def __iadd__(self, o): return self._inplace(o, "broadcast_add", "_plus_scalar")
    def __isub__(self, o): return self._inplace(o, "broadcast_sub", "_minus_scalar")
    def __imul__(self, o): return self._inplace(o, "broadcast_mul", "_mul_scalar")
    def __itruediv__(self, o): return self._inplace(o, "broadcast_div", "_div_scalar")
    def __imod__(self, o): return self._inplace(o, "broadcast_mod", "_mod_scalar")

    # the py2-era spellings MXNet still exposes
    __div__ = __truediv__
    __rdiv__ = __rtruediv__
    __idiv__ = __itruediv__

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


def _positive_key(key, shape):
    """``key`` with every slice of negative step made positive over the
    same elements, and the axes of the result to flip back; torch takes
    no negative step.  A whole-array ``[:]`` of a 0-d array is ``[...]``.
    Keys with tensor or list parts pass unchanged."""
    if not shape and isinstance(key, slice) and key == slice(None):
        return Ellipsis, []
    parts = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in parts):
        return key, []
    if any(not isinstance(k, (slice, int, np.integer, type(None),
                              type(Ellipsis))) for k in parts):
        return key, []
    n_axes = sum(1 for k in parts if k is not None and k is not Ellipsis)
    out, flips, ax, out_ax = [], [], 0, 0
    for k in parts:
        if k is Ellipsis:
            skip = len(shape) - n_axes
            ax += skip
            out_ax += skip
            out.append(k)
        elif k is None:
            out_ax += 1
            out.append(k)
        elif isinstance(k, slice):
            if k.step is not None and k.step < 0:
                start, stop, step = k.indices(shape[ax])
                count = len(range(start, stop, step))
                first = start + step * (count - 1) if count else 0
                k = slice(first, first + (-step) * count if count else 0,
                          -step)
                flips.append(out_ax)
            out.append(k)
            ax += 1
            out_ax += 1
        else:
            out.append(k)
            ax += 1
    return tuple(out), flips


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
    ctx = ctx or default_context("nd.array")
    t = t.to(device=ctx.device,
             dtype=torch_dtype(dtype) if dtype is not None else None)
    return NDArray(t, ctx)


def _device(ctx: Optional[Context], what: str) -> torch.device:
    return (ctx or default_context(what)).device


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx: Optional[Context] = None, dtype=None,
          stype=None) -> NDArray:
    """Zeros on ``ctx`` (the card when none is given); a sparse
    ``stype`` gives `sparse.zeros`."""
    if stype not in (None, "default"):
        from . import sparse
        return sparse.zeros(stype, shape, ctx, dtype)
    ctx = ctx or default_context("nd.zeros")
    return NDArray(torch.zeros(_shape(shape), device=ctx.device,
                               dtype=torch_dtype(dtype or "float32")), ctx)


def ones(shape, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    ctx = ctx or default_context("nd.ones")
    return NDArray(torch.ones(_shape(shape), device=ctx.device,
                              dtype=torch_dtype(dtype or "float32")), ctx)


def full(shape, val, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    ctx = ctx or default_context("nd.full")
    return NDArray(torch.full(_shape(shape), float(val), device=ctx.device,
                              dtype=torch_dtype(dtype or "float32")), ctx)


def empty(shape, ctx: Optional[Context] = None, dtype=None,
          stype=None) -> NDArray:
    return zeros(shape, ctx, dtype, stype=stype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0.0, start
    ctx = ctx or default_context("nd.arange")
    t = torch.arange(float(start), float(stop), float(step),
                     device=ctx.device,
                     dtype=torch_dtype(dtype or "float32"))
    return NDArray(t.repeat_interleave(repeat) if repeat > 1 else t, ctx)


def concat_nd(arrays, axis=0) -> NDArray:
    """``Concat`` of a list of NDArrays along ``axis``."""
    from .register import invoke
    return invoke("Concat", *arrays, dim=axis, num_args=len(arrays))


def waitall():
    """Wait for every device's queued work (reference `nd.waitall`), and
    raise a deferred error that a live array still carries (MXNet's
    `WaitForAll` rethrows, once)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    pending = list(POISONED.values())
    POISONED.clear()
    if pending:
        e = pending[0]._deferred_error
        raise MXNetError(
            f"deferred async failure surfaced at sync point: {e}") from e


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
