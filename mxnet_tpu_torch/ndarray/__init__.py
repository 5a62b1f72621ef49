"""`mx.nd`: NDArray creation plus one eager function per registered op."""
from .. import ops as _ops  # noqa: F401  (registers the ops)
from .ndarray import (NDArray, arange, array, empty, full, ones, waitall,
                      zeros)
from .register import invoke, make_nd_functions

make_nd_functions(globals())

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "waitall", "invoke"]
