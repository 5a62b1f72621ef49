"""Foundation: the error type, the missing-attr sentinel, the attr string
codecs and the `.params` dtype table.

The counterpart of `mxnet_tpu/base.py` (errors, attr codecs) and the dtype
enum of `mxnet_tpu/util.py`, kept as this package's own copy so that the
port never imports the JAX package.  Dtypes are torch dtypes here; the
integer codes are MXNet's mshadow `type_flag` values, so a `.params` blob
means the same thing in both packages.
"""
from __future__ import annotations

import ast
from typing import Any

import numpy as np
import torch

__all__ = ["MXNetError", "NotImplementedForSymbol", "InternalNamespace",
           "_Null", "str_to_attr", "DTYPE_TO_ID", "ID_TO_DTYPE",
           "numpy_dtype", "torch_dtype", "dtype_np", "dtype_name"]


class MXNetError(RuntimeError):
    """Default error type raised by the framework (reference
    `python/mxnet/base.py:74`)."""


class NotImplementedForSymbol(MXNetError):
    """An NDArray-only feature used on a Symbol (reference
    `python/mxnet/base.py:90`)."""

    def __init__(self, function, alias=None, *args):
        super().__init__()
        self.function = getattr(function, "__name__", str(function))
        self.alias = alias

    def __str__(self):
        msg = f"Function {self.function} is not implemented for Symbol."
        if self.alias:
            msg += f" Please use {self.alias} instead."
        return msg


class InternalNamespace:
    """``nd._internal`` / ``sym._internal``: the reference's
    underscore-prefixed op surface (``nd._internal._square_sum``), read
    from the namespace whose ``globals()`` it is given, where the
    functions live."""

    def __init__(self, namespace, module_name):
        self._namespace = namespace
        self._module_name = module_name

    def __getattr__(self, name):
        fn = self._namespace.get(name)
        if fn is None:
            raise AttributeError(f"module '{self._module_name}._internal' "
                                 f"has no attribute {name!r}")
        return fn


class _NullType:
    """Placeholder for a missing op attr: distinguishes "not passed" from
    None (reference `python/mxnet/base.py:52`)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "_Null"

    def __bool__(self):
        return False


_Null = _NullType()


_KEYWORDS = {"None": None, "True": True, "False": False}


def str_to_attr(value: str) -> Any:
    """Parse an attr string back to a python value: tuples, numbers, bools,
    None, or the raw string."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    if s in _KEYWORDS:
        return _KEYWORDS[s]
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


# mshadow type_flag values; 7 (bool) and 100 (bfloat16) are the JAX
# package's extensions, kept so blobs written there load here
DTYPE_TO_ID = {
    torch.float32: 0,
    torch.float64: 1,
    torch.float16: 2,
    torch.uint8: 3,
    torch.int32: 4,
    torch.int8: 5,
    torch.int64: 6,
    torch.bool: 7,
    torch.bfloat16: 100,
}
ID_TO_DTYPE = {v: k for k, v in DTYPE_TO_ID.items()}

_NUMPY_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.uint8: "uint8",
                torch.int32: "int32", torch.int8: "int8",
                torch.int64: "int64", torch.bool: "bool"}


def numpy_dtype(dtype):
    """The numpy dtype holding a torch (or numpy) dtype's values exactly
    (bfloat16, which numpy lacks, widens to float32)."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NUMPY_NAMES.get(dtype, "float32"))
    return np.dtype(dtype)


_DTYPE_NP = {t: np.dtype(n) for t, n in _NUMPY_NAMES.items()}


def dtype_np(dtype: torch.dtype):
    """An array's dtype as MXNet reports it: the numpy dtype of a torch
    dtype.  bfloat16, which numpy lacks, stays ``torch.bfloat16``, so
    ``astype(x.dtype)`` and ``zeros(shape, dtype=x.dtype)`` keep it."""
    return _DTYPE_NP.get(dtype, dtype)


def dtype_name(dtype) -> str:
    """The name of a torch dtype, numpy dtype or dtype name
    (``"float32"``, ``"bfloat16"``)."""
    return str(torch_dtype(dtype)).replace("torch.", "")


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    for t, n in _NUMPY_NAMES.items():
        if n == name:
            return t
    raise MXNetError(f"dtype {dtype!r} has no torch counterpart here")
