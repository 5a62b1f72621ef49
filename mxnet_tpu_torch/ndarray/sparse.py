"""Sparse NDArrays: CSR and row-sparse storage (the counterpart of
`mxnet_tpu/ndarray/sparse.py`; reference `python/mxnet/ndarray/sparse.py`,
`cast_storage-inl.h`, `dot-inl.h`).

Each sparse array keeps its component buffers as torch tensors on its
device: ``data`` values, int32 ``indices`` and, for CSR, an int32
``indptr``.  ``.data`` is the dense tensor (what an op that takes no
sparse input sees, as the reference's FComputeFallback densifies), so
every dense op accepts a sparse array.  The sparse work itself
(`cast_storage`, `retain`, `dot`) runs as gathers and segment sums:
the JAX package leaves them to XLA outside any Pallas kernel, and here
they are PyTorch's.  `dot` sums each output row (or column, for the
transposed product) as one segment of a sorted run (`torch.segment_reduce`),
so on the card its result does not depend on the order atomics land in,
and the same call twice gives the same bits.

Under `autograd.record`, a cast of a recorded dense array keeps that
array as its dense value (the cast's gradient is the identity, as the
reference's), and `dot` of such a CSR array runs the dense product.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context
from .ndarray import NDArray, _device

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "cast_storage", "retain", "dot",
           "zeros_like_rsp", "array", "empty", "zeros"]

# (op, repr(scalar), dtype) -> does the op map zero to zero
_ZERO_PRESERVING: dict = {}


def __getattr__(name):
    """Names not defined here are the `nd` op surface, whose ops densify a
    sparse input (the reference's `mx.nd.sparse` wrappers with the
    FComputeFallback storage path)."""
    if name.startswith("_"):
        raise AttributeError(name)
    from .. import ndarray as _nd
    fn = getattr(_nd, name, None)
    if fn is None:
        raise AttributeError(f"module 'mxnet_tpu_torch.ndarray.sparse' has "
                             f"no attribute {name!r}")
    return fn


def _i32(t) -> torch.Tensor:
    # int32 aux arrays, as the JAX package keeps them (its documented
    # deviation from the reference's int64); `.params` widens to int64
    return torch.as_tensor(t).to(torch.int32)


class BaseSparseNDArray(NDArray):
    """What both storage types share.  ``data`` is the dense value."""

    __slots__ = ("_sp_data", "_sp_indices", "_sp_shape", "_dense_src",
                 "_cache")

    def _init_common(self, shape):
        self._grad = None
        self._grad_req = "null"
        self._fresh_grad = False
        self._version = 0
        self._ctx = None
        self._deferred_error = None
        self._sp_shape = tuple(int(d) for d in shape)
        self._dense_src = None
        self._cache = {}

    @property
    def data(self) -> torch.Tensor:
        if self._dense_src is not None:
            return self._dense_src
        return self.todense_data()

    @data.setter
    def data(self, value):
        self._set_data(value)

    @property
    def shape(self):
        return self._sp_shape

    @property
    def _tdtype(self) -> torch.dtype:
        return self._sp_data.dtype

    @property
    def ndim(self) -> int:
        return len(self._sp_shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._sp_shape, dtype=np.int64))

    @property
    def context(self) -> Context:
        ctx = self._ctx
        if ctx is None or ctx.device != self._sp_data.device:
            return Context.of(self._sp_data.device)
        return ctx

    @property
    def sp_data(self) -> NDArray:
        return NDArray(self._sp_data, self.context)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._sp_indices, self.context)

    def todense_data(self) -> torch.Tensor:
        raise NotImplementedError

    def asnumpy(self) -> np.ndarray:
        self._check_deferred()
        return NDArray(self.data).asnumpy()

    def tostype(self, stype: str):
        return self if stype == self.stype else cast_storage(self, stype)

    def todense(self) -> NDArray:
        return self._carry_poison(NDArray(self.data, self.context))

    def __getitem__(self, key):
        """An element or a dense slice: a view of the dense value, which
        a later write into this array refreshes (`_adopt`)."""
        views = self._cache.get("views")
        if views is None:
            views = self._cache["views"] = self.todense_data()
        return NDArray(views, self.context)[key]

    def wait_to_read(self):
        self._check_deferred()
        if self._sp_data.is_cuda:
            torch.cuda.synchronize(self._sp_data.device)

    wait_to_write = wait_to_read

    def __setitem__(self, key, value):
        """Whole-array assignment only (``x[:] = dense, sparse or a
        scalar``), which re-derives the compressed form in place, as the
        reference's."""
        if not (isinstance(key, slice) and key.start is None
                and key.stop is None and key.step is None):
            raise MXNetError(f"{self.stype} NDArray only supports "
                             "whole-array assignment (x[:] = value)")
        if isinstance(value, NDArray):
            dense = value.data
        elif isinstance(value, (int, float, bool, np.number)):
            dense = torch.full(self._sp_shape, float(value),
                               dtype=self._tdtype,
                               device=self._sp_data.device)
        else:
            dense = torch.as_tensor(np.asarray(value))
        self._set_data(dense)

    def _set_data(self, value: torch.Tensor) -> None:
        """A dense write into a sparse array (``out=``, ``copyto``)
        re-derives its compressed form."""
        value = torch.as_tensor(value)
        if tuple(value.shape) != self._sp_shape:
            raise MXNetError(f"cannot write shape {tuple(value.shape)} into "
                             f"a {self.stype} array of shape "
                             f"{self._sp_shape}")
        value = value.detach().to(device=self._sp_data.device,
                                  dtype=self._tdtype)
        self._version += 1
        views = self._cache.get("views")
        self._adopt(_compress(value, self.stype))
        if views is not None:
            with torch.no_grad():
                views.copy_(value)
            self._cache["views"] = views

    def _adopt(self, other: "BaseSparseNDArray") -> None:
        raise NotImplementedError

    def reshape(self, *shape, **kwargs):
        raise MXNetError(f"{self.stype} NDArray does not support reshape")

    def _inplace(self, other, op, scalar_op):
        # augmented assignment rebinds to the result, as the reference's
        # sparse ``x += y`` does
        return self._binop(other, op, scalar_op)

    def _binop(self, other, op, scalar_op, reverse=False):
        """A scalar op that maps zero to zero acts on the stored values
        and keeps the storage (reference storage-type inference of
        `elemwise_binary_scalar_op.h`); anything else densifies."""
        if isinstance(other, (int, float, bool, np.number)):
            from ..ops import registry as _reg
            name = scalar_op
            if reverse:
                name = self._REVERSE_SCALAR.get(scalar_op, scalar_op)
            key = (name, repr(float(other)), str(self._tdtype))
            keeps = _ZERO_PRESERVING.get(key)
            if keeps is None:
                zero = torch.zeros((1,), dtype=self._tdtype)
                at0 = _reg.apply_op(name, [zero], {"scalar": float(other)})
                keeps = _ZERO_PRESERVING[key] = float(at0[0][0]) == 0.0
            if keeps:
                from .register import invoke
                vals = invoke(name, NDArray(self._sp_data),
                              scalar=float(other))
                return self._with_values(vals.data)
        return super()._binop(other, op, scalar_op, reverse)

    def _with_values(self, values: torch.Tensor):
        raise NotImplementedError

    def check_format(self, full_check=True):
        raise NotImplementedError

    def __reduce__(self):
        state = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                     else v) for k, v in self._components().items()}
        return (_rebuild, (type(self).__name__, state,
                           str(self._sp_data.device)))

    def _components(self):
        raise NotImplementedError


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix (reference `sparse.py:CSRNDArray`)."""

    __slots__ = ("_sp_indptr",)

    def __init__(self, data: torch.Tensor, indices: torch.Tensor,
                 indptr: torch.Tensor, shape: Tuple[int, int]):
        self._init_common(shape)
        self._sp_data = data                    # [nnz]
        dev = data.device
        self._sp_indices = _i32(indices).to(dev)    # [nnz] column ids
        self._sp_indptr = _i32(indptr).to(dev)      # [rows + 1]

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._sp_indptr, self.context)

    @property
    def nnz(self) -> int:
        return int(self._sp_data.shape[0])

    def _components(self):
        return {"data": self._sp_data, "indices": self._sp_indices,
                "indptr": self._sp_indptr, "shape": self._sp_shape}

    def _adopt(self, other):
        self._sp_data = other._sp_data
        self._sp_indices = other._sp_indices
        self._sp_indptr = other._sp_indptr
        self._dense_src = None
        self._cache = {}

    def _with_values(self, values):
        return CSRNDArray(values, self._sp_indices, self._sp_indptr,
                          self._sp_shape)

    def _row_counts(self) -> torch.Tensor:
        """Stored entries of each row (int64), cached."""
        c = self._cache.get("rows")
        if c is None:
            c = self._cache["rows"] = torch.diff(self._sp_indptr.long())
        return c

    def _row_ids(self) -> torch.Tensor:
        """The row of each stored entry (int64), cached."""
        r = self._cache.get("row_ids")
        if r is None:
            n = self._sp_shape[0]
            r = self._cache["row_ids"] = torch.repeat_interleave(
                torch.arange(n, device=self._sp_data.device),
                self._row_counts(), output_size=self.nnz)
        return r

    def _by_column(self):
        """``(order, counts)``: the entries sorted by column, stable in row
        order, and the stored entries of each column (int64), cached.  The
        transposed product sums each column's run in that order."""
        c = self._cache.get("cols")
        if c is None:
            cols = self._sp_indices.long()
            order = torch.sort(cols, stable=True).indices
            counts = torch.bincount(cols, minlength=self._sp_shape[1])
            c = self._cache["cols"] = (order, counts)
        return c

    def check_format(self, full_check=True):
        """The aux arrays' invariants (reference `check_format`,
        `sparse_format_check.cc`); raises MXNetError."""
        nrows, ncols = self._sp_shape
        indptr = self._sp_indptr.cpu().numpy().astype(np.int64)
        indices = self._sp_indices.cpu().numpy().astype(np.int64)
        if indptr.shape != (nrows + 1,):
            raise MXNetError(f"csr check_format: indptr length "
                             f"{indptr.shape[0]} != rows+1 ({nrows + 1})")
        if indptr[0] != 0:
            raise MXNetError("csr check_format: indptr must start at 0")
        if (np.diff(indptr) < 0).any() or (indptr < 0).any():
            raise MXNetError("csr check_format: indptr must be "
                             "non-negative and non-decreasing")
        if indptr[-1] != indices.shape[0]:
            raise MXNetError(f"csr check_format: indptr end "
                             f"{int(indptr[-1])} != nnz {indices.shape[0]}")
        if not full_check or not indices.size:
            return
        if (indices < 0).any() or (indices >= ncols).any():
            raise MXNetError("csr check_format: column indices out of "
                             f"range [0, {ncols})")
        rows = np.repeat(np.arange(nrows), np.diff(indptr))
        same_row = rows[1:] == rows[:-1]
        if (np.diff(indices)[same_row] <= 0).any():
            raise MXNetError("csr check_format: column indices must be "
                             "strictly ascending per row")

    def __getitem__(self, key):
        """Row slices keep the CSR storage (reference
        `CSRNDArray.__getitem__`); an int gives the (1, N) row."""
        n_rows = self._sp_shape[0]
        if isinstance(key, (int, np.integer)):
            idx = int(key) + (n_rows if int(key) < 0 else 0)
            if not 0 <= idx < n_rows:
                raise IndexError(f"index {key} out of bounds for {n_rows} "
                                 "rows")
            key = slice(idx, idx + 1)
        if isinstance(key, slice) and key.step in (None, 1):
            start, stop, _ = key.indices(n_rows)
            stop = max(stop, start)
            ptr = self._sp_indptr
            lo, hi = int(ptr[start]), int(ptr[stop])
            return CSRNDArray(self._sp_data[lo:hi], self._sp_indices[lo:hi],
                              ptr[start:stop + 1] - ptr[start],
                              (stop - start, self._sp_shape[1]))
        return super().__getitem__(key)

    def todense_data(self) -> torch.Tensor:
        out = torch.zeros(self._sp_shape, dtype=self._tdtype,
                          device=self._sp_data.device)
        if self.nnz:
            out = out.index_put((self._row_ids(), self._sp_indices.long()),
                                self._sp_data, accumulate=True)
        return out

    def copy(self):
        return CSRNDArray(self._sp_data.clone(), self._sp_indices.clone(),
                          self._sp_indptr.clone(), self._sp_shape)

    def __repr__(self):
        return (f"\n<CSRNDArray {self._sp_shape[0]}x{self._sp_shape[1]} "
                f"nnz={self.nnz} @{self.context}>")


class RowSparseNDArray(BaseSparseNDArray):
    """A tensor with a subset of its rows stored (reference
    `sparse.py:RowSparseNDArray`: the gradient format of Embedding and the
    unit of KVStore's ``row_sparse_pull``)."""

    __slots__ = ()

    def __init__(self, data: torch.Tensor, indices: torch.Tensor,
                 shape: Tuple[int, ...]):
        self._init_common(shape)
        self._sp_data = data                        # [rows kept, ...]
        self._sp_indices = _i32(indices).to(data.device)    # [rows kept]

    @property
    def stype(self):
        return "row_sparse"

    def _components(self):
        return {"data": self._sp_data, "indices": self._sp_indices,
                "shape": self._sp_shape}

    def _adopt(self, other):
        self._sp_data = other._sp_data
        self._sp_indices = other._sp_indices
        self._dense_src = None
        self._cache = {}

    def _with_values(self, values):
        return RowSparseNDArray(values, self._sp_indices, self._sp_shape)

    def todense_data(self) -> torch.Tensor:
        out = torch.zeros(self._sp_shape, dtype=self._tdtype,
                          device=self._sp_data.device)
        if self._sp_indices.numel():
            out = out.index_put((self._sp_indices.long(),), self._sp_data,
                                accumulate=True)
        return out

    def copy(self):
        return RowSparseNDArray(self._sp_data.clone(),
                                self._sp_indices.clone(), self._sp_shape)

    def retain(self, row_ids) -> "RowSparseNDArray":
        return retain(self, row_ids)

    def check_format(self, full_check=True):
        indices = self._sp_indices.cpu().numpy().astype(np.int64)
        if indices.shape[0] != self._sp_data.shape[0]:
            raise MXNetError("row_sparse check_format: indices and data "
                             "disagree on the number of stored rows")
        if not full_check or not indices.size:
            return
        nrows = self._sp_shape[0]
        if (indices < 0).any() or (indices >= nrows).any():
            raise MXNetError("row_sparse check_format: row indices out of "
                             f"range [0, {nrows})")
        if (np.diff(indices) <= 0).any():
            raise MXNetError("row_sparse check_format: row indices must be "
                             "strictly ascending")

    def __repr__(self):
        return (f"\n<RowSparseNDArray {self._sp_shape} "
                f"rows={self._sp_indices.shape[0]} @{self.context}>")


def _rebuild(kind, state, device):
    """Unpickle a sparse array onto the device it was pickled from."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in state.items() if k != "shape"}
    if kind == "CSRNDArray":
        return CSRNDArray(t["data"], t["indices"], t["indptr"],
                          state["shape"])
    return RowSparseNDArray(t["data"], t["indices"], state["shape"])


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def _is_shape_tuple(arg):
    """A TUPLE of ints is a shape; a list of ints stays data (the
    reference tells them apart by tuple-ness)."""
    return (isinstance(arg, tuple) and len(arg) > 0
            and all(isinstance(d, (int, np.integer)) for d in arg))


def _is_scipy_sparse(obj):
    try:
        import scipy.sparse as spsp
    except ImportError:
        return False
    return spsp.issparse(obj)


def _host(x, dtype=None) -> np.ndarray:
    if isinstance(x, NDArray):
        x = x.asnumpy()
    return np.asarray(x, dtype=dtype)


def _values(data, like, want):
    """The stored values: ``want`` if given, else the source's dtype for
    an array source and float32 for a list."""
    if want is not None:
        return data.astype(want)
    if not isinstance(like, (NDArray, np.ndarray)):
        return data.astype(np.float32)
    return data


def _dense_source(arg1, want):
    if isinstance(arg1, NDArray):
        t = arg1.data.detach()
        return t if want is None else t.to(torch_dtype(want))
    if isinstance(arg1, torch.Tensor):
        return arg1.detach()
    dtype = want or (arg1.dtype if isinstance(arg1, np.ndarray)
                     else np.float32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arg1,
                                                            dtype=dtype)))


def _np_dtype(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None) -> CSRNDArray:
    """Every reference creation form (`python/mxnet/ndarray/sparse.py`
    `csr_matrix`): ``(data, indices, indptr)`` with the shape inferred
    when omitted, COO ``(data, (row, col))``, a shape tuple (all zero), a
    scipy.sparse matrix (canonicalized), a sparse or dense NDArray, or a
    dense array-like.  The array lands on ``ctx`` (the card when none is
    given; a source NDArray keeps its device)."""
    want = _np_dtype(dtype)
    if _is_shape_tuple(arg1):
        if shape is not None and tuple(shape) != tuple(arg1):
            raise ValueError(f"shape {shape} does not match the requested "
                             f"shape {tuple(arg1)}")
        return zeros("csr", tuple(int(d) for d in arg1), ctx,
                     want or np.float32)
    if isinstance(arg1, CSRNDArray):
        if shape is not None and tuple(shape) != arg1.shape:
            raise ValueError(f"shape {shape} does not match the source "
                             f"shape {arg1.shape}")
        dev = ctx.device if ctx is not None else arg1._sp_data.device
        vals = arg1._sp_data.to(dev)
        if want is not None:
            vals = vals.to(torch_dtype(want))
        return CSRNDArray(vals, arg1._sp_indices.to(dev),
                          arg1._sp_indptr.to(dev), arg1.shape)
    if _is_scipy_sparse(arg1):
        if shape is not None and tuple(shape) != arg1.shape:
            raise ValueError(f"shape {shape} does not match the source "
                             f"shape {arg1.shape}")
        sp = arg1.tocsr()
        if sp is arg1:
            sp = sp.copy()           # never canonicalize the caller's matrix
        sp.sum_duplicates()
        sp.sort_indices()
        data = sp.data if want is None else sp.data.astype(want)
        return _csr_from_host(data, sp.indices, sp.indptr, sp.shape, ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _values(_host(data), data, want)
        indices = _host(indices, np.int64)
        indptr = _host(indptr, np.int64)
        if shape is None:
            if indices.size == 0:
                raise ValueError("cannot infer the csr shape without column "
                                 "indices; pass shape=")
            shape = (len(indptr) - 1, int(indices.max()) + 1)
        return _csr_from_host(data, indices, indptr, tuple(shape), ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and isinstance(arg1[1], (tuple, list)) and len(arg1[1]) == 2:
        # COO: (data, (row, col)), duplicates summed (scipy's canonical
        # form)
        import scipy.sparse as spsp
        data, (row, col) = arg1
        sp = spsp.coo_matrix((_host(data), (_host(row), _host(col))),
                             shape=shape).tocsr()
        return csr_matrix(sp, shape=shape, ctx=ctx, dtype=dtype)
    dense = _dense_source(arg1, want)
    if dense.dim() != 2:
        raise MXNetError("csr_matrix requires 2-D input")
    if shape is not None and tuple(shape) != tuple(dense.shape):
        raise ValueError(f"shape {shape} does not match the dense input "
                         f"shape {tuple(dense.shape)}")
    if ctx is not None or not isinstance(arg1, NDArray):
        dense = dense.to(_device(ctx, "sparse.csr_matrix"))
    return _compress(dense, "csr")


def _csr_from_host(data, indices, indptr, shape, ctx) -> CSRNDArray:
    dev = _device(ctx, "sparse.csr_matrix")
    return CSRNDArray(torch.from_numpy(np.ascontiguousarray(data)).to(dev),
                      torch.from_numpy(np.asarray(indices, np.int64)).to(dev),
                      torch.from_numpy(np.asarray(indptr, np.int64)).to(dev),
                      shape)


def row_sparse_array(arg1, shape=None, ctx=None,
                     dtype=None) -> RowSparseNDArray:
    """Every reference creation form (`row_sparse_array`): ``(data,
    indices)`` with the shape inferred when omitted, a shape tuple (all
    zero), a row-sparse NDArray, or a dense array-like."""
    want = _np_dtype(dtype)
    if _is_shape_tuple(arg1):
        if shape is not None and tuple(shape) != tuple(arg1):
            raise ValueError(f"shape {shape} does not match the requested "
                             f"shape {tuple(arg1)}")
        return zeros("row_sparse", tuple(int(d) for d in arg1), ctx,
                     want or np.float32)
    if isinstance(arg1, RowSparseNDArray):
        if shape is not None and tuple(shape) != arg1.shape:
            raise ValueError(f"shape {shape} does not match the source "
                             f"shape {arg1.shape}")
        dev = ctx.device if ctx is not None else arg1._sp_data.device
        vals = arg1._sp_data.to(dev)
        if want is not None:
            vals = vals.to(torch_dtype(want))
        return RowSparseNDArray(vals, arg1._sp_indices.to(dev), arg1.shape)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        data = _values(_host(data), data, want)
        indices = _host(indices, np.int64)
        if shape is None:
            if indices.size == 0:
                raise ValueError("cannot infer the row_sparse shape without "
                                 "row indices; pass shape=")
            shape = (int(indices.max()) + 1,) + tuple(data.shape[1:])
        dev = _device(ctx, "sparse.row_sparse_array")
        return RowSparseNDArray(
            torch.from_numpy(np.ascontiguousarray(data)).to(dev),
            torch.from_numpy(indices).to(dev), tuple(shape))
    dense = _dense_source(arg1, want)
    if shape is not None and tuple(shape) != tuple(dense.shape):
        raise ValueError(f"shape {shape} does not match the dense input "
                         f"shape {tuple(dense.shape)}")
    if ctx is not None or not isinstance(arg1, NDArray):
        dense = dense.to(_device(ctx, "sparse.row_sparse_array"))
    return _compress(dense, "row_sparse")


def array(source_array, ctx=None, dtype=None):
    """Reference `mx.nd.sparse.array`: a sparse NDArray from a scipy CSR
    matrix or another sparse NDArray."""
    if _is_scipy_sparse(source_array):
        fmt = source_array.getformat()
        if fmt != "csr":
            raise ValueError("only scipy csr matrices are supported (got "
                             f"format {fmt!r}); convert with .tocsr()")
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    if isinstance(source_array, CSRNDArray):
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    if isinstance(source_array, RowSparseNDArray):
        return row_sparse_array(source_array, ctx=ctx, dtype=dtype)
    raise ValueError("sparse.array expects a scipy.sparse csr matrix or a "
                     "sparse NDArray; use csr_matrix/row_sparse_array for "
                     "dense sources")


def empty(stype, shape, ctx=None, dtype=None):
    """An all-zero sparse array (sparse storage has no uninitialized
    form)."""
    return zeros(stype, shape, ctx, dtype)


def zeros_like_rsp(shape, ctx=None, dtype=np.float32) -> RowSparseNDArray:
    dev = _device(ctx, "sparse.zeros")
    return RowSparseNDArray(
        torch.zeros((0,) + tuple(shape[1:]), dtype=torch_dtype(dtype),
                    device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev), tuple(shape))


def zeros(stype, shape, ctx=None, dtype=None):
    dtype = dtype if dtype is not None else np.float32
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if stype == "row_sparse":
        return zeros_like_rsp(shape, ctx, dtype)
    if stype == "csr":
        if len(shape) != 2:
            raise MXNetError(f"csr storage requires a 2-D shape, got {shape}")
        dev = _device(ctx, "sparse.zeros")
        return CSRNDArray(
            torch.zeros((0,), dtype=torch_dtype(dtype), device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev),
            torch.zeros((shape[0] + 1,), dtype=torch.int32, device=dev),
            shape)
    if stype in (None, "default"):
        from .ndarray import zeros as dzeros
        return dzeros(shape, ctx, dtype)
    raise ValueError(f"unknown storage type {stype!r}: expected 'default', "
                     "'row_sparse' or 'csr'")


# ---------------------------------------------------------------------------
# ops: cast_storage, retain, dot
# ---------------------------------------------------------------------------

def _compress(dense: torch.Tensor, stype: str) -> BaseSparseNDArray:
    """The compressed form of a dense tensor on its device: CSR keeps the
    nonzero entries in row-major order, row-sparse the rows with any
    nonzero."""
    if stype == "csr":
        if dense.dim() != 2:
            raise MXNetError("csr storage requires 2-D input")
        rows, cols = torch.nonzero(dense, as_tuple=True)
        counts = torch.bincount(rows, minlength=dense.shape[0])
        indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                             device=dense.device)
        torch.cumsum(counts, 0, out=indptr[1:])
        return CSRNDArray(dense[rows, cols], cols, indptr,
                          tuple(dense.shape))
    if stype == "row_sparse":
        flat = dense.reshape(dense.shape[0], -1) if dense.dim() else dense
        keep = torch.nonzero((flat != 0).any(dim=1)).squeeze(1)
        return RowSparseNDArray(dense[keep], keep, tuple(dense.shape))
    raise MXNetError(f"unknown storage type {stype!r}")


def cast_storage(arr, stype: str):
    """Reference `cast_storage`: dense, csr and row_sparse into one
    another.  The values are the identity, so under `autograd.record` the
    result of a recorded array keeps it as its dense value and gradients
    flow through."""
    if stype == getattr(arr, "stype", "default"):
        return arr
    if not isinstance(arr, NDArray):
        arr = NDArray(torch.as_tensor(np.asarray(arr)))
    dense = arr.data
    if stype == "default":
        return NDArray(dense)
    if stype not in ("csr", "row_sparse"):
        raise MXNetError(f"unknown storage type {stype!r}")
    out = _compress(dense.detach(), stype)
    if dense.requires_grad and torch.is_grad_enabled():
        out._dense_src = dense
    return out


def retain(rsp: RowSparseNDArray, row_ids) -> RowSparseNDArray:
    """Keep only the requested rows (reference `sparse_retain`, the
    KVStore ``row_sparse_pull`` primitive): one row per requested id, zero
    where the array stores none."""
    if isinstance(row_ids, NDArray):
        ids = row_ids.data
    else:
        ids = torch.as_tensor(np.asarray(row_ids))
    ids = ids.to(device=rsp._sp_data.device).long().reshape(-1)
    if not rsp._sp_indices.numel():
        return RowSparseNDArray(rsp._sp_data.new_zeros(
            (ids.numel(),) + rsp._sp_data.shape[1:]), ids, rsp._sp_shape)
    stored, order = torch.sort(rsp._sp_indices.long())
    at = torch.searchsorted(stored, ids).clamp_max(stored.numel() - 1)
    hit = stored[at] == ids
    rows = rsp._sp_data[order[at]]
    mask = hit.reshape((-1,) + (1,) * (rsp._sp_data.dim() - 1))
    return RowSparseNDArray(torch.where(mask, rows, torch.zeros_like(rows)),
                            ids, rsp._sp_shape)


def dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    """Sparse dot (reference `dot-inl.h`): CSR × dense, CSRᵀ × dense and
    dense × CSR(ᵀ), else the dense ``dot``.  ``forward_stype`` asks for
    the output's storage type; the values are the same either way."""
    res = _dot_impl(lhs, rhs, transpose_a, transpose_b)
    if forward_stype not in (None, "default") \
            and getattr(res, "stype", "default") != forward_stype:
        if isinstance(res, BaseSparseNDArray):
            res = cast_storage(res, forward_stype)
        else:
            res = _full_storage_cast(res, forward_stype)
    return res


def _full_storage_cast(res: NDArray, stype: str):
    """A dense result in sparse storage with every entry stored, on the
    device and without a host round trip (the JAX package's choice for
    ``forward_stype``: the values are what the caller needs)."""
    t = res.data
    m, dev = t.shape[0], t.device
    if stype == "row_sparse":
        out = RowSparseNDArray(t.detach(), torch.arange(m, device=dev),
                               tuple(t.shape))
    else:
        n = t.shape[1]
        out = CSRNDArray(t.detach().reshape(-1),
                         torch.arange(n, device=dev).repeat(m),
                         torch.arange(m + 1, device=dev) * n, tuple(t.shape))
    if t.requires_grad and torch.is_grad_enabled():
        out._dense_src = t
    return out


def _segment_sum(values: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Sum consecutive runs of ``values`` (one per entry of ``counts``),
    each run in order: the same bits on every call."""
    if values.shape[0] == 0:
        return values.new_zeros((counts.shape[0],) + values.shape[1:])
    return torch.segment_reduce(values, "sum", lengths=counts, axis=0)


def _dot_impl(lhs, rhs, transpose_a=False, transpose_b=False):
    dense_rhs = isinstance(rhs, NDArray) and \
        not isinstance(rhs, BaseSparseNDArray)
    if isinstance(lhs, CSRNDArray) and dense_rhs:
        from .. import autograd
        with autograd.grad_mode():
            if lhs._dense_src is not None:
                # a recorded CSR operand: the dense product, so that both
                # operands' gradients are dense and flow into the cast
                left = lhs._dense_src.t() if transpose_a else lhs._dense_src
                right = rhs.data.t() if transpose_b else rhs.data
                return NDArray(left @ right)
            d = rhs.data.t() if transpose_b else rhs.data
            vals = lhs._sp_data.reshape((-1,) + (1,) * (d.dim() - 1))
            if transpose_a:
                # out[c] = Σ data·d[row] over column c's entries, in row
                # order
                order, counts = lhs._by_column()
                rows = lhs._row_ids()[order]
                contrib = vals[order] * d.index_select(0, rows)
                return NDArray(_segment_sum(contrib, counts))
            contrib = vals * d.index_select(0, lhs._sp_indices.long())
            return NDArray(_segment_sum(contrib, lhs._row_counts()))
    if isinstance(lhs, NDArray) and not isinstance(lhs, BaseSparseNDArray) \
            and isinstance(rhs, CSRNDArray):
        return _dot_impl(rhs, lhs.T if not transpose_a else lhs,
                         transpose_a=not transpose_b).T
    from .register import invoke
    return invoke("dot", lhs, rhs, transpose_a=transpose_a,
                  transpose_b=transpose_b)
